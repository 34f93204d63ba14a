"""A z-scored gene-expression matrix with planted patient subgroups.

The gene-expression part of the measured program's
``data/synthetic.py::tcga_like``, made on the device in a few large calls:
each of ``n_clusters`` subgroups has a mean profile of ``signal`` times a
normal draw per gene; a patient's row is its subgroup's profile plus unit
normal noise; every gene is then z-scored over the patients (population
standard deviation, plus 1e-6). The same seed gives the same matrix on the
same kind of device.
"""

from __future__ import annotations

import torch


def make(params: dict, seed: int, device) -> torch.Tensor:
    n, genes = int(params["n_patients"]), int(params["n_genes"])
    k, signal = int(params.get("n_clusters", 3)), float(params.get("signal", 1.5))
    gen = torch.Generator(device=device).manual_seed(seed)
    labels = torch.randint(0, k, (n,), generator=gen, device=device)
    centers = torch.randn((k, genes), generator=gen, device=device) * signal
    ge = centers[labels] + torch.randn((n, genes), generator=gen, device=device)
    mu = ge.mean(0, keepdim=True)
    sd = ge.std(0, correction=0, keepdim=True)
    return ((ge - mu) / (sd + 1e-6)).contiguous()

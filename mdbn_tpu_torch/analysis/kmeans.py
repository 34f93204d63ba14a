"""k-means (Lloyd's algorithm) on the device, in PyTorch.

Port of ``mdbn_tpu/analysis/kmeans_jax.py``: the distances to the centers are
one [N, K] product per iteration (the matmul identity, no N x K x D
broadcast), with k-means++ seeding. ``kmeans_cluster_device`` runs its
``n_init`` restarts as one batched computation (a leading restart dimension
on the centers, as the reference's ``vmap`` over seed keys) and keeps the one
of least inertia. The products are plain large products that the reference
computes outside any Pallas kernel, so they are ``torch.matmul`` here. Every
draw comes from a ``torch.Generator`` on the data's device: deterministic
given the seed, but not the reference's draws (``jax.random``), so a fit
from the same seed need not start from the same centers; ``init_centers``
starts it from given ones.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.state import default_device


def _sq_dists(x: torch.Tensor, x2: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """||x - c||^2 for all pairs by ``||x||^2 - 2 x.c + ||c||^2``: ``x`` [N, D]
    (or [R, N, D]), ``x2`` its [N, 1] row norms, ``centers`` [..., K, D];
    returns [..., N, K]."""
    return (x2 - 2.0 * x @ centers.transpose(-1, -2)
            + (centers * centers).sum(-1).unsqueeze(-2))


def _plus_plus_init(x: torch.Tensor, k: int, n_init: int,
                    generator: torch.Generator) -> torch.Tensor:
    """k-means++ seeding of ``n_init`` restarts at once: [n_init, k, D], on
    the rows ``x`` [N, D] that every restart shares, or [n_init, N, D], a row
    set a restart. The first center is a uniform row, each next one a row
    drawn with probability proportional to its squared distance to the
    nearest center so far (plus 1e-12, as the reference's log-weights)."""
    xs = x.expand(n_init, *x.shape) if x.dim() == 2 else x
    n, d = xs.shape[1:]
    x2 = (xs * xs).sum(-1, keepdim=True)
    rows = torch.arange(n_init, device=x.device)
    first = torch.randint(n, (n_init,), generator=generator, device=x.device)
    centers = torch.zeros((n_init, k, d), dtype=x.dtype, device=x.device)
    centers[:, 0] = xs[rows, first]
    d2 = _sq_dists(xs, x2, centers[:, :1])[..., 0]  # [R, N]
    for i in range(1, k):
        idx = torch.multinomial(d2.clamp_min(0.0) + 1e-12, 1, generator=generator)[:, 0]
        centers[:, i] = xs[rows, idx]
        d2 = torch.minimum(d2, _sq_dists(xs, x2, centers[:, i:i + 1])[..., 0])
    return centers


def _lloyd(x: torch.Tensor, centers: torch.Tensor, n_iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_iters`` Lloyd steps from ``centers`` [..., K, D] on the rows of
    ``x`` ([N, D], or [R, N, D] with one row set a restart); an empty cluster
    keeps its center. Returns (labels [..., N], centers, inertia [...])."""
    k = centers.shape[-2]
    x2 = (x * x).sum(-1, keepdim=True)
    for _ in range(n_iters):
        labels = _sq_dists(x, x2, centers).argmin(-1)
        onehot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # [..., N, K]
        counts = onehot.sum(-2).unsqueeze(-1)  # [..., K, 1]
        sums = onehot.transpose(-1, -2) @ x  # [..., K, D]
        centers = torch.where(counts > 0, sums / counts.clamp_min(1.0), centers)
    d2 = _sq_dists(x, x2, centers)
    return d2.argmin(-1), centers, d2.min(-1).values.sum(-1)


def kmeans_fit(x, k: int, n_iters: int = 50, generator: Optional[torch.Generator] = None,
               init_centers=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One k-means fit of the rows of ``x`` [N, D] (float32, on its device):
    k-means++ seeding from ``generator`` (default: seeded 0 on ``x``'s
    device), or ``init_centers`` [k, D] when given, then ``n_iters`` Lloyd
    steps. Returns (labels [N], centers [k, D], inertia)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if init_centers is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        centers = _plus_plus_init(x, k, 1, generator)[0]
    else:
        centers = torch.as_tensor(init_centers, dtype=torch.float32, device=x.device)
    return _lloyd(x, centers, n_iters)


def kmeans_cluster_device(codes, n_clusters: int, seed: int = 0, n_init: int = 10,
                          n_iters: int = 50, device: Optional[torch.device | str] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The best of ``n_init`` k-means++ restarts by inertia, all restarts in
    one batched computation on ``device`` (default: the CUDA card). Returns
    (labels [N], centers [K, D]) as numpy arrays."""
    device = torch.device(device) if device is not None else default_device()
    x = torch.as_tensor(np.asarray(codes, np.float32), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    labels, centers, inertia = _lloyd(x, _plus_plus_init(x, n_clusters, n_init, gen),
                                      n_iters)
    best = int(inertia.argmin())
    return labels[best].cpu().numpy(), centers[best].cpu().numpy()

"""Binary 784-pixel rows with digit-like structure (binarized MNIST's shape).

A copy of the measured program's ``data/synthetic.py::mnist_like`` at
``binarize="threshold"``: random thick strokes make each of
``n_prototypes`` templates, each row is a template's noisy copy, thresholded,
then ``noise`` of its pixels flipped. The same seed gives the same rows.
"""

from __future__ import annotations

import numpy as np
import torch


def make(params: dict, seed: int, device) -> torch.Tensor:
    n_samples = int(params["n_samples"])
    n_features = int(params.get("n_features", 784))
    n_prototypes = int(params.get("n_prototypes", 10))
    noise = float(params.get("noise", 0.08))
    rng = np.random.default_rng(seed)
    side = int(round(n_features ** 0.5))
    protos = np.zeros((n_prototypes, side, side), np.float32)
    lo, hi = min(2, side - 1), max(side - 4, min(2, side - 1) + 1)
    for p in range(n_prototypes):
        for _ in range(3):
            if rng.random() < 0.5:
                r = rng.integers(lo, hi)
                protos[p, r: r + 2, rng.integers(0, max(1, side // 2)):] = 1.0
            else:
                col = rng.integers(lo, hi)
                protos[p, rng.integers(0, max(1, side // 2)):, col: col + 2] = 1.0
    protos = protos.reshape(n_prototypes, side * side)[:, :n_features]
    labels = rng.integers(0, n_prototypes, n_samples)
    probs = np.clip(protos[labels] * (1 - 2 * noise) + noise, 0.0, 1.0)
    data = (probs > 0.5).astype(np.float32)
    flip = rng.random(data.shape) < noise
    data = np.where(flip, 1.0 - data, data).astype(np.float32)
    return torch.from_numpy(data).to(device)

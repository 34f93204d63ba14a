"""Deterministic synthetic data generators (a copy of mdbn_tpu/data/synthetic.py,
so both packages produce bit-identical arrays from one seed).

There is no network in this environment, so the graded configs run on
synthetic stand-ins shaped like their real datasets:

- ``mnist_like``: 784-dim binary vectors with digit-like low-dimensional
  structure (random prototype templates + pixel noise, thresholded), matching
  "binarized MNIST subset, batch 20" (BASELINE.json config 1).
- ``tcga_like``: three modality matrices — z-scored Gaussian-ish gene
  expression, beta-distributed->z-scored methylation, sparse miRNA — with
  *planted* patient-cluster structure so k-means recovery is assertable
  (BASELINE.json configs 2, 4, 5).

The real MNIST/TCGA loaders are ``data/loaders.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def mnist_like(
    n_samples: int = 2000,
    n_features: int = 784,
    n_prototypes: int = 10,
    noise: float = 0.08,
    seed: int = 0,
    binarize: str = "threshold",  # "threshold" | "sample"
    return_labels: bool = False,
):
    """Binary [n_samples, 784]-ish data with prototype structure an RBM can learn."""
    rng = np.random.default_rng(seed)
    side = int(round(n_features**0.5))
    protos = np.zeros((n_prototypes, side, side), np.float32)
    lo, hi = min(2, side - 1), max(side - 4, min(2, side - 1) + 1)
    for p in range(n_prototypes):
        # a few random thick strokes per prototype — loosely digit-like structure
        for _ in range(3):
            if rng.random() < 0.5:
                r = rng.integers(lo, hi)
                protos[p, r : r + 2, rng.integers(0, max(1, side // 2)) :] = 1.0
            else:
                col = rng.integers(lo, hi)
                protos[p, rng.integers(0, max(1, side // 2)) :, col : col + 2] = 1.0
    protos = protos.reshape(n_prototypes, side * side)[:, :n_features]
    labels = rng.integers(0, n_prototypes, n_samples)
    probs = np.clip(protos[labels] * (1 - 2 * noise) + noise, 0.0, 1.0)
    if binarize == "sample":
        data = (rng.random(probs.shape) < probs).astype(np.float32)
    else:
        data = (probs > 0.5).astype(np.float32)
        flip = rng.random(data.shape) < noise
        data = np.where(flip, 1.0 - data, data).astype(np.float32)
    if return_labels:
        return data, labels.astype(np.int32)
    return data


def bars_and_stripes(n_samples: int = 512, side: int = 4, seed: int = 0) -> np.ndarray:
    """Classic tiny RBM benchmark distribution (SURVEY.md §4.3)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_samples, side * side), np.float32)
    for i in range(n_samples):
        img = np.zeros((side, side), np.float32)
        mask = rng.random(side) < 0.5
        if rng.random() < 0.5:
            img[mask, :] = 1.0  # stripes (rows)
        else:
            img[:, mask] = 1.0  # bars (columns)
        out[i] = img.ravel()
    return out


def zscore(x: np.ndarray, axis: int = 0, eps: float = 1e-6) -> np.ndarray:
    mu = x.mean(axis=axis, keepdims=True)
    sd = x.std(axis=axis, keepdims=True)
    return ((x - mu) / (sd + eps)).astype(np.float32)


def tcga_like(
    n_patients: int = 400,
    n_clusters: int = 3,
    dims: Dict[str, int] | None = None,
    seed: int = 0,
    signal: float = 1.5,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """3-modality multi-omics stand-in with planted cluster structure.

    Returns ({"ge", "meth", "mirna"}, true_labels). All modalities come out
    z-scored per feature (the reference z-scores continuous features,
    BASELINE.json config 2).
    """
    dims = dims or {"ge": 2000, "meth": 1500, "mirna": 500}
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_clusters, n_patients)
    modalities: Dict[str, np.ndarray] = {}

    # gene expression: cluster-mean Gaussians
    centers = rng.standard_normal((n_clusters, dims["ge"])) * signal
    ge = centers[labels] + rng.standard_normal((n_patients, dims["ge"]))
    modalities["ge"] = zscore(ge.astype(np.float32))

    # methylation: beta-distributed around cluster-specific means, then z-scored
    alpha = 1.0 + 4.0 * rng.random((n_clusters, dims["meth"]))
    beta = 1.0 + 4.0 * rng.random((n_clusters, dims["meth"]))
    meth = rng.beta(alpha[labels], beta[labels]).astype(np.float32)
    modalities["meth"] = zscore(meth)

    # miRNA: sparse nonnegative counts-ish with cluster-scaled rates
    rates = rng.gamma(2.0, 1.0, (n_clusters, dims["mirna"])) * (
        1.0 + signal * rng.random((n_clusters, dims["mirna"]))
    )
    mirna = rng.poisson(rates[labels]).astype(np.float32)
    mirna *= (rng.random(mirna.shape) < 0.3)  # sparsity
    modalities["mirna"] = zscore(np.log1p(mirna))

    return modalities, labels

"""Downstream analysis: latent feature extraction and k-means patient
clustering, on the device.

Port of ``mdbn_tpu/analysis/cluster.py`` without scikit-learn: k-means is
``analysis.kmeans``'s device k-means (best of ``n_init`` k-means++ restarts),
the silhouette is computed in PyTorch from pairwise distances on the device,
and the adjusted Rand index in numpy from the contingency table. Two
divergences are kept by decision: scikit-learn's Lloyd with its own k-means++
draws is not reproduced, so a fixed-k partition agrees with the reference's
by ARI, not label for label; and above 10,000 rows the silhouette's
subsample comes from a ``torch.Generator``, not scikit-learn's
``RandomState``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.state import default_device
from .kmeans import kmeans_cluster_device

SILHOUETTE_MAX_ROWS = 10_000  # the silhouette's subsample above this many rows
_CHUNK_ROWS = 2048  # rows of the [rows, N] distance block formed at once


def extract_latent(model, data) -> np.ndarray:
    """Joint latent codes for all samples, on the host. ``model`` is any
    object with the reference-shaped ``transform`` (RBM/DBN/MDBN)."""
    return model.transform(data).float().cpu().numpy()


def kmeans_cluster(codes, n_clusters: int, seed: int = 0, n_init: int = 10,
                   device: Optional[torch.device | str] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster latent codes on ``device`` (default: the CUDA card); returns
    (labels, centers)."""
    return kmeans_cluster_device(codes, n_clusters, seed=seed, n_init=n_init, device=device)


def cluster_patients(model, modalities, n_clusters: int, seed: int = 0) -> np.ndarray:
    """End-to-end: MDBN joint codes -> k-means patient subgroups, on the
    model's device."""
    labels, _ = kmeans_cluster(extract_latent(model, modalities), n_clusters, seed=seed,
                               device=model.device)
    return labels


def _comb2(n: int) -> int:
    return n * (n - 1) // 2


def adjusted_rand_index(a, b) -> float:
    """Adjusted Rand index of two labelings, from their contingency table in
    exact integers (the pair-confusion form scikit-learn's
    ``adjusted_rand_score`` uses)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"labelings must be 1-D and of one length, got {a.shape} and {b.shape}")
    n = len(a)
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max(initial=-1) + 1, bi.max(initial=-1) + 1), np.int64)
    np.add.at(table, (ai, bi), 1)
    squares = int((table.astype(object) ** 2).sum())
    rows = [int(r) for r in table.sum(1)]
    cols = [int(c) for c in table.sum(0)]
    tp = squares - n
    fp = sum(int(x) * c for row in table for x, c in zip(row, cols)) - squares
    fn = sum(int(x) * r for col in table.T for x, r in zip(col, rows)) - squares
    tn = n * n - fp - fn - squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def silhouette_score(codes, labels, device: Optional[torch.device | str] = None,
                     sample_size: Optional[int] = None, seed: int = 0) -> float:
    """Mean silhouette coefficient over the rows (Euclidean distances, in
    float64 on ``device``): s = (b - a) / max(a, b), a the mean distance to
    the rest of the row's cluster, b the least mean distance to another
    cluster, 0 for a row alone in its cluster. With ``sample_size`` below the
    row count, over that many rows drawn without replacement from a
    generator seeded ``seed``."""
    device = torch.device(device) if device is not None else default_device()
    x = torch.as_tensor(np.asarray(codes), device=device).double()
    lab = torch.as_tensor(np.unique(np.asarray(labels), return_inverse=True)[1].ravel(),
                          device=device)
    if sample_size is not None and sample_size < len(x):
        gen = torch.Generator(device=device).manual_seed(seed)
        keep = torch.randperm(len(x), generator=gen, device=device)[:sample_size]
        x, lab = x[keep], lab[keep]
        lab = torch.unique(lab, return_inverse=True)[1]
    n, k = len(x), int(lab.max()) + 1
    if not 2 <= k <= n - 1:
        raise ValueError(f"the silhouette needs 2 <= clusters <= rows - 1, got {k} "
                         f"clusters of {n} rows")
    onehot = torch.nn.functional.one_hot(lab, k).double()  # [N, K]
    sizes = onehot.sum(0)
    sums = torch.cat([torch.cdist(x[lo:lo + _CHUNK_ROWS], x,
                                  compute_mode="donot_use_mm_for_euclid_dist") @ onehot
                      for lo in range(0, n, _CHUNK_ROWS)])  # [N, K]
    own = sizes[lab]
    a = sums.gather(1, lab[:, None])[:, 0] / (own - 1).clamp_min(1.0)
    other = sums / sizes
    other.scatter_(1, lab[:, None], float("inf"))
    b = other.min(1).values
    s = torch.where(own > 1, (b - a) / torch.maximum(a, b), torch.zeros_like(a))
    return float(torch.nan_to_num(s).mean())


def select_n_clusters(codes, k_min: int = 2, k_max: int = 8, seed: int = 0,
                      device: Optional[torch.device | str] = None
                      ) -> Tuple[int, Dict[int, float], np.ndarray]:
    """Pick the cluster count by silhouette score over ``[k_min, k_max]``:
    returns ``(best_k, {k: score}, labels_of_best_k)``. Above
    ``SILHOUETTE_MAX_ROWS`` rows the score is taken on a subsample of that
    many rows, which gives the same k selection on large cohorts."""
    n = len(codes)
    k_max = min(k_max, n - 1)
    if k_max < k_min:
        raise ValueError(f"cohort of {n} samples is too small for "
                         f"k_min={k_min} (need more than k_min samples)")
    sample_size = min(n, SILHOUETTE_MAX_ROWS)
    scores: Dict[int, float] = {}
    fits: Dict[int, np.ndarray] = {}
    for k in range(k_min, k_max + 1):
        labels, _ = kmeans_cluster(codes, k, seed=seed, device=device)
        if len(np.unique(labels)) < 2:
            continue
        scores[k] = silhouette_score(codes, labels, device=device,
                                     sample_size=sample_size, seed=seed)
        fits[k] = labels
    if not scores:
        raise ValueError("no k in range produced >= 2 distinct clusters")
    best = max(scores, key=scores.get)
    return best, scores, fits[best]

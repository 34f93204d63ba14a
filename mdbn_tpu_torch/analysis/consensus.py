"""Consensus clustering (Monti et al. 2003, Machine Learning 52) on the device.

Port of ``mdbn_tpu/analysis/consensus.py``: cluster many row subsamples,
count how often each patient pair lands in the same cluster when both are
drawn, and read the final assignment and the cluster-count evidence off the
consensus matrix

    M[i, j] = (# resamples where i, j co-clustered) /
              (# resamples where i, j co-sampled).

A clean k shows a near-binary M; ambiguity shows as mass in the middle,
measured by PAC (proportion of ambiguous clustering, Senbabaoglu et al.
2014): the fraction of pairs with M in (u1, u2).

On the device: the R resamples' k-means fits run as one batched computation
(``analysis.kmeans``, one k-means++ seeding each, a leading resample
dimension), and each resample's pair indicators are added into the [N, N]
co-cluster and co-sample counts in turn, so no R x N x N tensor is formed.
The draws come from a ``torch.Generator`` seeded ``seed`` on the device, not
the reference's ``jax.random`` keys. The final cut is average-linkage
hierarchical clustering of 1 - M on the host (scipy), as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.state import default_device
from .kmeans import _lloyd, _plus_plus_init


def accumulate(n: int, idx: torch.Tensor, labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Co-cluster and co-sample counts [n, n] (float32) of R resamples: row
    ``r`` of ``idx`` [R, m] holds the rows resample r drew (distinct), the
    same row of ``labels`` [R, m] their clusters."""
    C = torch.zeros((n, n), dtype=torch.float32, device=idx.device)
    S = torch.zeros_like(C)
    ones = torch.ones((idx.shape[1], idx.shape[1]), dtype=torch.float32, device=idx.device)
    for ix, lab in zip(idx, labels):
        rows, cols = ix[:, None], ix[None, :]
        C[rows, cols] += (lab[:, None] == lab[None, :]).float()
        S[rows, cols] += ones
    return C, S


def _resample_labels(x: torch.Tensor, k: int, m: int, n_resamples: int, n_iters: int,
                     generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx [R, m], labels [R, m]): each resample's rows, drawn without
    replacement, and its k-means labels."""
    n = x.shape[0]
    idx = torch.stack([torch.randperm(n, generator=generator, device=x.device)[:m]
                       for _ in range(n_resamples)])
    xs = x[idx]  # [R, m, D]
    labels, _, _ = _lloyd(xs, _plus_plus_init(xs, k, n_resamples, generator), n_iters)
    return idx, labels


def consensus_matrix(codes, n_clusters: int, n_resamples: int = 100,
                     subsample: float = 0.8, seed: int = 0, n_iters: int = 50,
                     device: Optional[torch.device | str] = None) -> np.ndarray:
    """Monti consensus matrix M [N, N] for one k (see module docstring), on
    ``device`` (default: the CUDA card)."""
    device = torch.device(device) if device is not None else default_device()
    x = torch.as_tensor(np.asarray(codes, np.float32), device=device)
    n = x.shape[0]
    m = int(round(subsample * n))
    if not (n_clusters < m <= n):
        raise ValueError(f"subsample of {m} rows (from {n}) must exceed "
                         f"n_clusters={n_clusters}")
    gen = torch.Generator(device=device).manual_seed(seed)
    idx, labels = _resample_labels(x, int(n_clusters), m, int(n_resamples), int(n_iters), gen)
    C, S = accumulate(n, idx, labels)
    M = (C / S.clamp_min(1.0)).cpu().numpy()
    np.fill_diagonal(M, 1.0)
    return M


def pac_score(M: np.ndarray, u1: float = 0.1, u2: float = 0.9) -> float:
    """Proportion of ambiguous clustering: fraction of off-diagonal pairs
    with consensus strictly inside (u1, u2). Lower = cleaner clustering."""
    off = ~np.eye(M.shape[0], dtype=bool)
    v = M[off]
    return float(np.mean((v > u1) & (v < u2)))


def _cut_consensus(M: np.ndarray, n_clusters: int) -> np.ndarray:
    """Average-linkage hierarchical cut of the consensus dissimilarity
    (Monti's final assignment), on the host."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    D = 1.0 - M
    D = 0.5 * (D + D.T)
    np.fill_diagonal(D, 0.0)
    Z = linkage(squareform(D, checks=False), method="average")
    return fcluster(Z, t=n_clusters, criterion="maxclust") - 1


def consensus_cluster(codes, n_clusters: int, n_resamples: int = 100,
                      subsample: float = 0.8, seed: int = 0, n_iters: int = 50,
                      device: Optional[torch.device | str] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Consensus clustering at a fixed k. Returns (labels [N], M [N, N])."""
    M = consensus_matrix(codes, n_clusters, n_resamples, subsample, seed, n_iters, device)
    return _cut_consensus(M, n_clusters), M


def select_n_clusters_consensus(
    codes, k_min: int = 2, k_max: int = 8, n_resamples: int = 100,
    subsample: float = 0.8, seed: int = 0, n_iters: int = 50,
    pac_tol: float = 0.01, device: Optional[torch.device | str] = None,
) -> Tuple[int, Dict[int, float], np.ndarray]:
    """Pick the cluster count by PAC over ``[k_min, k_max]``: the largest k
    whose PAC is within ``pac_tol`` of the minimum. Merging whole true
    clusters is also perfectly stable, so PAC is ~0 for every k up to the
    true one, while splitting a true cluster makes it jump: the largest
    near-minimal k is the finest stable structure. Returns ``(best_k,
    {k: pac}, labels_of_best_k)``, as ``cluster.select_n_clusters``."""
    n = np.shape(codes)[0]
    k_max = min(k_max, n - 1)
    if k_max < k_min:
        raise ValueError(f"cohort of {n} samples is too small for "
                         f"k_min={k_min}")
    scores: Dict[int, float] = {}
    for k in range(k_min, k_max + 1):
        M = consensus_matrix(codes, k, n_resamples, subsample, seed, n_iters, device)
        scores[k] = pac_score(M)
    floor = min(scores.values()) + pac_tol
    best = max(k for k, s in scores.items() if s <= floor)
    # the winner's matrix again (deterministic in the seed) rather than
    # holding every k's [N, N] matrix through the sweep
    M_best = consensus_matrix(codes, best, n_resamples, subsample, seed, n_iters, device)
    return best, scores, _cut_consensus(M_best, best)

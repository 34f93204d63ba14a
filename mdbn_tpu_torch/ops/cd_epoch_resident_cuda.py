"""The training run of one RBM with W resident in shared memory: CUDA kernel.

``cd_train_resident_run`` wraps the hand-written kernel
``csrc/cd_train_resident.cu``, which computes what ``csrc/cd_train.cu``
computes (``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel`` in
single-device mode, with its estimator modes: parallel tempering, the
enhanced gradient, learned variance and the pseudo-likelihood monitor, in a
variant of the kernel of their own), in one launch of thread-block clusters
that keep their tiles of W and its velocity in shared memory for the whole
run. It has the signature of ``ops.cd_epoch_cuda.cd_train_run``, the same
inject layout and Philox keying (swap draws included), so one seed draws the
same numbers on both kernels; its plain version is
``ops.cd_epoch_cuda.cd_train_run_plain``, the same function. ``grid`` counts
clusters here.

The tiling depends on (V, H) alone: V is cut into at most 15 strips of a
multiple of 4 rows, H into at most 8 column tiles of a multiple of 32
columns, one block each; a cluster of those blocks holds one or more strips.
Whether the tiles fit the card (``resident_tiles``) is decided from the
config, the opt-in shared memory of a block and the number of clusters the
card holds at once; ``ops.cd_epoch_cuda.select_kernel`` admits a run to the
kernel when they fit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, pt_betas
from . import cd_epoch_cuda as K

# Launches of the resident CUDA kernel in this process (incremented only where
# the kernel is launched).
cd_train_resident_launches = 0

MAX_STRIPS, MAX_RANKS = 15, 8  # csrc/cd_train_resident.cu: kMaxStrips, kMaxRanks
THREADS, ROWS_PER_THREAD = 512, 4  # kRThreads, kRT
MAX_SPLIT, MAX_VSPLIT = 4, 2  # kMaxSplit, kMaxVSplit
# An NVIDIA H100 80GB HBM3: the opt-in shared memory of a block
# (cudaDevAttrMaxSharedMemoryPerBlockOptin) and, by cluster size, the clusters
# of one-block-per-SM blocks the card holds at once
# (cudaOccupancyMaxActiveClusters), as measured on the card by
# scripts/torch_kernel_ab.py --sweep. A run on a card takes that card's own.
H100_SMEM_PER_BLOCK = 232448
H100_MAX_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def has_modes(cfg: RBMConfig) -> bool:
    """Whether ``cfg`` runs an estimator mode (the kernel's kModes variant)."""
    return (cfg.pt_temps > 1 or cfg.gradient != "plain" or cfg.learn_variance
            or cfg.error_metric == "pseudo")


def resident_library(cfg: RBMConfig) -> str:
    """The library of the kernel's variant that runs ``cfg`` (``_build.KERNELS``):
    the plain estimator, the modes without a tempering ladder, or with one."""
    if cfg.pt_temps > 1:
        return "cd_train_resident_ladder"
    return "cd_train_resident_modes" if has_modes(cfg) else "cd_train_resident"


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiling(n_visible: int, n_hidden: int) -> Tuple[int, int, int, int]:
    """(rows of a strip, columns of a tile, strips, ranks) of a V x H run:
    the kernel's ``tiling``."""
    tv = (_cdiv(n_visible, MAX_STRIPS) + 3) // 4 * 4
    th = (_cdiv(n_hidden, MAX_RANKS) + 31) // 32 * 32
    return tv, th, _cdiv(n_visible, tv), _cdiv(n_hidden, th)


def split_for(units: int, slots: int, quads: int, most: int) -> int:
    """The kernel's ``split_for``: the fewest chunks, at most ``most``, of a
    product's summed dimension (``quads`` groups of 4) that make the longest
    of ``slots`` workers' walks over ``units`` work units shortest."""
    best, cost = 1, _cdiv(units, slots) * quads
    for s in range(2, most + 1):
        c = _cdiv(units * s, slots) * _cdiv(quads, s)
        if c < cost:
            best, cost = s, c
    return best


def smem_bytes(cfg: RBMConfig, strips_per_cluster: int) -> int:
    """Shared memory bytes of a block that holds ``strips_per_cluster``
    strips: the kernel's ``layout(...).total``. Per strip: its W and vW tiles
    (rows padded by 4 elements), b and vb, the batch's rows and the next
    batch's, vs of the CR chain rows (CR = M*B under tempering, else B), and
    the visible partials by parity (the plain variant: two row sets of B
    under PCD; the modes: the most rows a visible phase holds, a Gibbs
    step's CR + the monitor's B or the product phase's ladder + learned
    variance's 2B); under learned variance z, vz, s, sigma and CR scaled rows;
    under the enhanced gradient the pending gb, mu and two parities of the
    ranks' shares. Per block: c, vc, h0p, h0s and the draws [B, th], hmean
    and the chain [CR, th], the products' chunk sums and the reduction
    slots; under the enhanced gradient lam, the pending gc and mean h0p and
    the units' shares; under tempering the totals [CR, NT], c.h, the swap
    flags and the rank's share of each strip's monitor; under the pseudo
    monitor two parities of the ranks' shares."""
    tv, th, _, _ = tiling(cfg.n_visible, cfg.n_hidden)
    B, sz = cfg.batch_size, 2 if cfg.param_dtype == "bfloat16" else 4
    pt, lv = cfg.pt_temps > 1, cfg.learn_variance
    enh, pseudo = cfg.gradient == "enhanced", cfg.error_metric == "pseudo"
    modes = has_modes(cfg)
    CR = B * cfg.pt_temps if pt else B
    NT = (1 if cfg.visible == "gaussian" else cfg.pt_temps) if pt else 0
    nseg = 2 if cfg.persistent else 1
    recon = cfg.persistent and not pseudo
    qrows = (max(CR + (B if recon else 0), (CR if pt else 0) + (2 * B if lv else 0))
             if modes else nseg * B)
    vseg = 2 if modes else nseg
    nrt = _cdiv(B, ROWS_PER_THREAD)
    hsplit = split_for(_cdiv(th, 64) * nrt, THREADS // 32, tv // 4, MAX_SPLIT)
    vsplit = split_for(_cdiv(tv, 64) * nrt, THREADS // 32, th // 4, MAX_VSPLIT)
    a = _align16
    strip = (2 * a(tv * (th + 4) * sz) + 2 * a(tv * sz) + 2 * a(B * tv * sz)
             + a(CR * tv * 4) + 2 * qrows * tv * 4)
    if lv:
        strip += 2 * a(tv * sz) + 2 * a(tv * 4) + a(CR * tv * 4)
    if enh:
        strip += 4 * a(tv * 4)
    block = (2 * a(th * sz) + 3 * a(B * th * 4) + 2 * a(CR * th * 4)
             + a(max(hsplit * B * th, vsplit * vseg * B * tv) * 4) + a(THREADS // 32 * 4))
    if enh:
        block += 3 * a(th * 4) + a(_cdiv(tv, 4) * th * 4) + a(_cdiv(th, 64) * tv * 4)
    if pt:
        block += a(CR * NT * 4) + a(CR * 4) + a(2 * CR * 4)
    if pseudo:
        block += a(2 * B * 4)
    if pt:
        block += a(strips_per_cluster * 4)
    return strip * strips_per_cluster + block


@dataclass(frozen=True)
class ResidentTiles:
    """How a run lies on the card: W cut into ``strips`` strips of ``rows``
    rows and ``ranks`` column tiles of ``cols`` columns; ``clusters`` clusters
    of ``ranks`` blocks, each holding ``strips_per_cluster`` strips in
    ``smem_bytes`` of shared memory; ``fits`` when that is within a block's
    shared memory and the clusters fit the card at once."""

    rows: int
    cols: int
    strips: int
    ranks: int
    clusters: int
    strips_per_cluster: int
    smem_bytes: int
    fits: bool


def resident_tiles(cfg: RBMConfig, smem_per_block: int = H100_SMEM_PER_BLOCK,
                   max_clusters: Optional[int] = None, clusters: int = 0) -> ResidentTiles:
    """The tiling of ``cfg`` and whether it fits a card whose blocks opt in to
    ``smem_per_block`` bytes of shared memory and which holds ``max_clusters``
    clusters of this tiling's size at once (None: an H100's,
    ``H100_MAX_CLUSTERS``). ``clusters`` = 0 takes as many clusters as fit,
    balanced over the strips; a given count that is larger than the card
    holds or than there are strips, or too small for its strips to fit a
    block, raises ValueError."""
    tv, th, strips, ranks = tiling(cfg.n_visible, cfg.n_hidden)
    if max_clusters is None:
        max_clusters = H100_MAX_CLUSTERS[ranks]
    if clusters > 0:
        if clusters > min(max_clusters, strips):
            raise ValueError(f"{clusters} clusters: the card holds {max_clusters} clusters of "
                             f"{ranks} blocks at once, and the run has {strips} strips")
        per = -(-strips // clusters)
        need = smem_bytes(cfg, per)
        if need > smem_per_block:
            raise ValueError(f"{clusters} clusters are too few for {strips} strips: {per} "
                             f"strips a block take {need} bytes of shared memory, a block "
                             f"has {smem_per_block}")
        return ResidentTiles(tv, th, strips, ranks, clusters, per, need, True)
    per = -(-strips // max(max_clusters, 1))
    use = -(-strips // per)
    need = smem_bytes(cfg, per)
    return ResidentTiles(tv, th, strips, ranks, use, per, need,
                         max_clusters > 0 and need <= smem_per_block)


def resident_admits(cfg: RBMConfig, limits: Optional[Tuple[int, int]] = None) -> bool:
    """Whether the resident kernel takes ``cfg`` on a card with ``limits``
    (``device_limits``; None: an H100's)."""
    smem, maxc = limits if limits is not None else (H100_SMEM_PER_BLOCK, None)
    return resident_tiles(cfg, smem, maxc).fits


def device_limits(cfg: RBMConfig, device: torch.device,
                  library: Optional[str] = None) -> Tuple[int, int]:
    """(opt-in shared memory of a block, clusters of ``cfg``'s tiling that
    the card holds at once), asked of ``device`` through ``library`` (None:
    ``resident_library(cfg)``); builds the kernels at first use."""
    import ctypes

    from .._build import load_library

    lib = load_library(library or resident_library(cfg), cfg.param_dtype).lib
    out = (ctypes.c_int * 2)()
    index = device.index if device.index is not None else torch.cuda.current_device()
    rc = lib.cd_train_resident_limits(cfg.n_visible, cfg.n_hidden, index, out)
    if rc != 0:
        raise RuntimeError(f"cd_train_resident limits: cudaError {rc} "
                           f"({lib.cd_train_resident_error_string(rc).decode()})")
    return int(out[0]), int(out[1])


def resident_trace_phases(cfg: RBMConfig) -> List[str]:
    """The kernel's steps of one update, in the order a trace stamps their
    starts: per hidden phase (from the data, then one per Gibbs step) its
    products, its barrier of the blocks that share a column tile across
    clusters and its sums; per visible phase its products, its cluster
    barrier and its sums (a tempering ladder's sums split over the ranks,
    then a cluster barrier and the exchange of the samples:
    ``:exchange:cluster_barrier``, ``:exchange:copy``; a ladder's hidden
    sums split over the clusters, then a barrier of the tile's blocks and
    the exchange through device memory: ``:exchange:tile_barrier``,
    ``:exchange:copy``); under tempering or
    learned variance the modes' product phase (the ladder's h W^T, W h0p and
    W hmean) with its cluster barrier; under tempering the flag barrier of
    every block before the swap rounds; the update. So an update of CD-k
    holds k + 1 ``:tile_barrier`` steps and k ``:cluster_barrier`` steps;
    tempering adds k + 1 of each,
    learned variance one ``:cluster_barrier``, the enhanced gradient and the
    pseudo monitor none."""
    pt = cfg.pt_temps > 1
    steps = ("products", "tile_barrier", "sums")
    vsteps = ("products", "cluster_barrier", "sums")
    names = [f"hidden_from_data:{s}" for s in steps]
    for t in range(cfg.k):
        names += [f"visible_{t}:{s}" for s in vsteps]
        names += [f"visible_{t}:exchange:{s}" for s in ("cluster_barrier", "copy")] if pt else []
        names += [f"hidden_{t}:{s}" for s in steps]
        names += [f"hidden_{t}:exchange:{s}" for s in ("tile_barrier", "copy")] if pt else []
    if pt or cfg.learn_variance:
        names += [f"products:{s}" for s in vsteps]
    if pt:
        names += ["swap:tile_barrier", "swap:rounds"]
    return names + ["update_and_monitor"]


def resident_trace_len(cfg: RBMConfig) -> int:
    """Clock stamps per update in a trace: one per phase, and the end."""
    return len(resident_trace_phases(cfg)) + 1


def cd_train_resident_run(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                          chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                          start_epoch: int = 0,
                          uniforms: Optional[Dict[str, torch.Tensor]] = None,
                          generator: Optional[torch.Generator] = None, grid: int = 0,
                          trace: Optional[torch.Tensor] = None,
                          ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The run on the resident CUDA kernel; one launch on the current stream.
    Takes CUDA tensors only (``ops.cd_epoch_cuda.cd_train_run_plain`` is its
    plain version). ``grid`` is the number of clusters (0: as many as the
    card holds, balanced over the strips); the result does not depend on it.
    ``trace``, an int64 CUDA tensor [E, nb, resident_trace_len(cfg)],
    receives the device clock (ns) at the start of each phase of each update
    as block 0 sees it.
    Raises ValueError for a config or input the kernel does not take (a
    cluster count too small for the tiles included) and RuntimeError when
    the launch fails."""
    global cd_train_resident_launches
    if data.device.type != "cuda":
        raise ValueError(f"cd_train_resident_run takes CUDA tensors, got {data.device}; "
                         "cd_epoch_cuda.cd_train_run_plain is its plain version")
    x = K.kernel_inputs(cfg, params, velocity, chain, data, order, uniforms, generator)
    device = data.device
    B, V, H, M = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.pt_temps
    K.check_trace(trace, (x.n_epochs, x.nb, resident_trace_len(cfg)), device)
    tiles = resident_tiles(cfg, *device_limits(cfg, device), clusters=grid)
    if not tiles.fits:
        raise ValueError(f"a {V}x{H} run at batch {B} does not fit the card's shared memory "
                         f"({tiles.smem_bytes} bytes a block); csrc/cd_train.cu takes it")

    from .._build import load_library  # builds the kernels at first use

    lib = load_library(resident_library(cfg), cfg.param_dtype).lib
    errs = torch.empty(x.n_epochs, dtype=torch.float32, device=device)
    betas = pt_betas(cfg, device) if M > 1 else None
    # the hidden partials, the monitor's strip sums, the barrier counters
    # (zero) and the modes' shares
    scratch = torch.zeros(int(lib.cd_train_resident_scratch_floats(V, H, B, M, x.flags)),
                          dtype=torch.float32, device=device)
    p, v, u, ptr = x.params, x.velocity, x.draws, K.ptr
    rc = lib.cd_train_resident_run(
        ptr(x.data), ptr(x.order), ptr(u["h0"]), ptr(u["h"]), ptr(u["v"]), ptr(u["swap"]),
        ptr(betas), ptr(p.W), ptr(p.b), ptr(p.c), ptr(v.W), ptr(v.b), ptr(v.c), ptr(p.z),
        ptr(v.z), ptr(x.chain), ptr(errs), ptr(scratch), ptr(trace),
        V, H, B, M, x.nb, x.n_epochs, cfg.k, start_epoch, cfg.momentum_switch_epoch, x.flags,
        cfg.lr, cfg.lr if cfg.lr_variance is None else cfg.lr_variance, *K.schedule_args(cfg),
        x.seed, x.device_index, tiles.clusters, x.stream)
    if rc != 0:
        raise RuntimeError(f"cd_train_resident kernel launch failed: cudaError {rc} "
                           f"({lib.cd_train_resident_error_string(rc).decode()})")
    cd_train_resident_launches += 1
    return p, v, x.chain, errs

"""The W-blocked training run of one wide RBM: CUDA kernel and plain version.

Port of ``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel_wb``, the kernel
the TPU trains its widest models through (28000x400 float32, 40000x1000
bfloat16). ``cd_train_wide_run`` wraps the hand-written kernel
``csrc/cd_train_wide.cu`` (one cooperative launch per run, one block an SM),
in which every x W product is a sum over fixed strips of W's rows;
``wide_launch_plan`` gives the shared memory its launch takes and what it
stages there; ``cd_train_wide_run_plain`` is the same function in plain
PyTorch. Both have
the signature of ``ops.cd_epoch_cuda.cd_train_run`` / ``cd_train_run_plain``
and the same inject layout and Philox keying, so one seed gives both kernels
the same draws.

The function is ``cd_train_run_plain``'s within the kernel's scope
(``ops.cd_epoch_cuda.wide_unsupported``: mean-field negative phase, mse or
xent monitor, plain gradient, no tempering, no learned variance), with one
difference: the negative-phase visibles round through the storage dtype
before they enter the hidden units and the gradient, because the TPU kernel
keeps its factors in a scratch at storage dtype. The monitor compares the
data with the unrounded mean. At float32 storage the two are the same
function.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams
from . import cd_epoch_cuda as K

# Launches of the W-blocked CUDA kernel in this process (incremented only
# where the kernel is launched).
cd_train_wide_launches = 0


def check_wide_supports(cfg: RBMConfig) -> None:
    reason = K.wide_unsupported(cfg)
    if reason is not None:
        raise ValueError(reason)


def wide_trace_phases(cfg: RBMConfig) -> List[str]:
    """The W-blocked kernel's phases of one update, in the order a trace
    stamps their starts: each x W product is a pass over W's strips and a
    reduction of the strips' partial sums."""
    names = ["xw_from_data", "hidden_from_data"]
    for t in range(cfg.k):
        names += [f"visible_{t}", f"xw_{t}", f"hidden_{t}"]
    return names + ["update_and_monitor"]


def wide_trace_len(cfg: RBMConfig) -> int:
    """Clock stamps per update in a trace: one per phase, and the end."""
    return len(wide_trace_phases(cfg)) + 1


# csrc/cd_wide_phases.cuh's shared-memory layout, in floats unless named
_X_FLOATS = 64 * 256 + 8 * 64 * 64  # x W: kRowGroup x kXCols of x, per-warp row sums
_V_PASS = 64  # h W^T: rows of h a pass holds (kWarps * kVTR)
_H_ALIGN = 8  # staged h rows padded to a multiple of this
_U_STRIP = 2 * 3 * 16  # update: floats of a row of two strips' v0, vs and v0 - vs
_U_MAX_STRIP_ROWS = 256  # update: strip rows staged at once when h is not staged
_WARPS = 8


def _ring_floats(param_dtype: str) -> Tuple[int, int]:
    """(floats of h W^T's ring of three W tiles, hidden units of a tile):
    64 rows of 512 bytes each, padded by 16 bytes."""
    width = 2 if param_dtype == "bfloat16" else 4
    vk = 512 // width
    return 3 * 64 * (vk + 16 // width) * width // 4, vk


@dataclass(frozen=True)
class WidePlan:
    """How a launch of ``csrc/cd_train_wide.cu`` uses a block's shared
    memory (``cd_wide_phases.cuh::wide_plan``, which this mirrors)."""

    smem_bytes: int  # dynamic shared memory of a block: the largest phase's
    vis_rows: int  # h W^T: rows of h a pass stages
    vis_window: int  # h W^T: hidden units of h staged at once (H: whole rows, once a pass)
    hstride: int  # h W^T: row stride of the staged h, floats
    h_staged: bool  # update: h0p and hmean staged once per phase (else read from the L2)
    strip_rows: int  # update: rows of a strip's v0 and vs staged at once
    w_tiles: int  # update: the next strip's W (1), and vW (2), streamed to shared memory
    ok: bool  # False when a phase does not fit the limit

    def as_tuple(self) -> Tuple[int, ...]:
        return (self.smem_bytes, self.vis_rows, self.vis_window, self.hstride,
                int(self.h_staged), self.strip_rows, self.w_tiles, int(self.ok))


def wide_launch_plan(cfg: RBMConfig, smem_limit: Optional[int] = None) -> WidePlan:
    """The launch plan of a run of ``cfg`` on a card whose blocks may opt in
    to ``smem_limit`` bytes of shared memory (None: an H100's, 232,448). An
    h W^T pass holds the Gibbs step's B rows and, under PCD, the data chain's
    (2B); h is staged in whole rows once a pass where one fits beside W's
    ring, else by windows of whole W tiles. The update stages h0p and hmean
    [2, B, H] once per phase where they fit beside a strip's rows (else reads
    them from the L2), then, where they fit too, two strips' rows of W, and
    of its velocity when a momentum of the run is not 0 (the next strip's
    stream in while this one is updated). Nothing here refuses a shape."""
    from .cd_epoch_resident_cuda import H100_SMEM_PER_BLOCK

    limit = H100_SMEM_PER_BLOCK if smem_limit is None else smem_limit
    H, B = cfg.n_hidden, cfg.batch_size
    lim = limit // 4
    width = 2 if cfg.param_dtype == "bfloat16" else 4
    ring, vk = _ring_floats(cfg.param_dtype)
    ok = True
    vis_total = 2 * B if cfg.persistent else B
    hs, avail = -(-H // _H_ALIGN) * _H_ALIGN, lim - ring
    if avail >= hs:
        window, hstride, vis_rows = H, hs, min(vis_total, _V_PASS, avail // hs)
    else:
        vis_rows = min(vis_total, _V_PASS, avail // vk)
        window = avail // vis_rows // vk * vk if vis_rows > 0 else 0
        hstride, ok = window, vis_rows >= 1
    need = max(_X_FLOATS, ring + vis_rows * hstride)
    h2, strip = 2 * B * (-(-H // 4) * 4), _U_STRIP * B  # rows padded to 4 columns
    h_staged = h2 + strip <= lim
    strip_rows = B if h_staged else min(B, _U_MAX_STRIP_ROWS)
    upd = h2 + strip if h_staged else _U_STRIP * strip_rows
    vel = cfg.momentum != 0 or bool(cfg.initial_momentum)
    n_tiles = 2 if vel else 1
    tiles = 2 * n_tiles * (-(-16 * H * width // 16) * 16 // 4)  # two strips' rows each
    w_tiles = n_tiles if upd + tiles <= lim else 0
    upd += tiles if w_tiles else 0
    need = max(need, upd, _WARPS)
    return WidePlan(smem_bytes=need * 4, vis_rows=vis_rows, vis_window=window,
                    hstride=hstride, h_staged=h_staged, strip_rows=strip_rows,
                    w_tiles=w_tiles, ok=ok and need <= lim)


def cd_train_wide_run_plain(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                            chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                            start_epoch: int = 0,
                            uniforms: Optional[Dict[str, torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None,
                            ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the W-blocked run (see module doc)."""
    check_wide_supports(cfg)
    return K.run_plain(cfg, params, velocity, chain, data, order, start_epoch, uniforms,
                       generator, wide=True)


def cd_train_wide_run(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                      chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                      start_epoch: int = 0,
                      uniforms: Optional[Dict[str, torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None, grid: int = 0,
                      trace: Optional[torch.Tensor] = None,
                      ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The run on the W-blocked CUDA kernel; one launch on the current
    stream. Takes CUDA tensors only. ``grid`` is the cooperative grid (0:
    one block per SM, the most the kernel runs at once); the result does not
    depend on it. The launch takes ``wide_launch_plan(cfg)``'s shared memory
    (with the card's own limit). ``trace``, an int64
    CUDA tensor [E, nb, wide_trace_len(cfg)], receives the device clock (ns)
    at the start of each phase of each update as block 0 sees it.
    Raises ValueError for a config outside the kernel's scope or an input it
    does not take, and RuntimeError when the launch fails."""
    global cd_train_wide_launches
    if data.device.type != "cuda":
        raise ValueError(f"cd_train_wide_run takes CUDA tensors, got {data.device}; "
                         "cd_train_wide_run_plain is its plain version")
    check_wide_supports(cfg)
    x = K.kernel_inputs(cfg, params, velocity, chain, data, order, uniforms, generator)
    device = data.device
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    K.check_trace(trace, (x.n_epochs, x.nb, wide_trace_len(cfg)), device)

    from .._build import load_library  # builds the kernels at first use

    lib = load_library("cd_train_wide", cfg.param_dtype).lib
    errs = torch.empty(x.n_epochs, dtype=torch.float32, device=device)
    # the strips' partial sums take ceil(V / 512) * B * H floats of it (8 MB at 40000x1000)
    scratch = torch.empty(int(lib.cd_train_wide_scratch_floats(V, H, B)),
                          dtype=torch.float32, device=device)
    p, v, u, ptr = x.params, x.velocity, x.draws, K.ptr
    rc = lib.cd_train_wide_run(
        ptr(x.data), ptr(x.order), ptr(u["h0"]), ptr(u["h"]), ptr(p.W), ptr(p.b), ptr(p.c),
        ptr(v.W), ptr(v.b), ptr(v.c), ptr(x.chain), ptr(errs), ptr(scratch), ptr(trace),
        V, H, B, x.nb, x.n_epochs, cfg.k, start_epoch, cfg.momentum_switch_epoch, x.flags,
        cfg.lr, *K.schedule_args(cfg), x.seed, x.device_index, grid, x.stream)
    if rc != 0:
        raise RuntimeError(f"cd_train_wide kernel launch failed: cudaError {rc} "
                           f"({lib.cd_train_wide_error_string(rc).decode()})")
    cd_train_wide_launches += 1
    return p, v, x.chain, errs

"""The training run of one wide RBM under the estimator modes: CUDA kernel.

``cd_train_wide_modes_run`` wraps the hand-written kernel
``csrc/cd_train_wide_modes.cu``, which computes what ``csrc/cd_train.cu``'s
mode variant computes (``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel``
under parallel tempering, the enhanced gradient or learned variance, at the
widths the TPU trains through its ``hbm_state`` mode) in one cooperative
launch whose products split over fixed strips of W's rows, as the W-blocked
kernel's do. It has the signature of ``ops.cd_epoch_cuda.cd_train_run``, the
same inject layout and Philox keying, so one seed draws the same numbers on
both kernels; its plain version is ``ops.cd_epoch_cuda.cd_train_run_plain``,
the same function. Its scope is ``ops.cd_epoch_cuda.wide_modes_unsupported``;
``ops.cd_epoch_cuda.select_kernel`` admits a run to it from
``WIDE_MODES_MIN_VISIBLE`` columns on.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, pt_betas
from . import cd_epoch_cuda as K

# Launches of the CUDA kernel in this process (incremented only where the
# kernel is launched).
cd_train_wide_modes_launches = 0


def wide_modes_trace_phases(cfg: RBMConfig) -> List[str]:
    """The kernel's phases of one update, in the order a trace stamps their
    starts: each x W product is a pass over W's strips and a reduction of
    the strips' partial sums; then the h W^T product phase (tempering's
    log p*(h) terms, learned variance's A terms), the two swap rounds and
    the update. The enhanced gradient's hidden-bias sums ride in the next
    update's ``xw_from_data``. Each phase ends at a grid barrier."""
    names = ["xw_from_data", "hidden_from_data"]
    for t in range(cfg.k):
        names += [f"visible_{t}", f"xw_{t}", f"hidden_{t}"]
    pt = cfg.pt_temps > 1
    names += ["products"] if pt or cfg.learn_variance else []
    names += ["swap_even", "swap_odd"] if pt else []
    return names + ["update_and_monitor"]


def wide_modes_trace_len(cfg: RBMConfig) -> int:
    """Clock stamps per update in a trace: one per phase, and the end."""
    return len(wide_modes_trace_phases(cfg)) + 1


def cd_train_wide_modes_run(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                            chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                            start_epoch: int = 0,
                            uniforms: Optional[Dict[str, torch.Tensor]] = None,
                            generator: Optional[torch.Generator] = None, grid: int = 0,
                            trace: Optional[torch.Tensor] = None,
                            ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The run on the strip-split CUDA kernel of the estimator modes; one
    launch on the current stream. Takes CUDA tensors only
    (``ops.cd_epoch_cuda.cd_train_run_plain`` is its plain version). ``grid``
    is the cooperative grid (0: one block per SM); the result does not
    depend on it. ``trace``, an int64 CUDA tensor [E, nb,
    wide_modes_trace_len(cfg)], receives the device clock (ns) at the start
    of each phase of each update as block 0 sees it.
    Raises ValueError for a config outside the kernel's scope or an input it
    does not take (both before anything is built), and RuntimeError when the
    launch fails."""
    global cd_train_wide_modes_launches
    if data.device.type != "cuda":
        raise ValueError(f"cd_train_wide_modes_run takes CUDA tensors, got {data.device}; "
                         "cd_epoch_cuda.cd_train_run_plain is its plain version")
    reason = K.wide_modes_unsupported(cfg)
    if reason is not None:
        raise ValueError(reason)
    x = K.kernel_inputs(cfg, params, velocity, chain, data, order, uniforms, generator)
    device = data.device
    B, V, H, M = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.pt_temps
    K.check_trace(trace, (x.n_epochs, x.nb, wide_modes_trace_len(cfg)), device)
    betas = pt_betas(cfg, device) if M > 1 else None

    from .._build import load_library  # builds the kernels at first use

    lib = load_library("cd_train_wide_modes", cfg.param_dtype).lib
    errs = torch.empty(x.n_epochs, dtype=torch.float32, device=device)
    scratch = torch.empty(int(lib.cd_train_wide_modes_scratch_floats(V, H, B, M, x.flags)),
                          dtype=torch.float32, device=device)
    p, v, u, ptr = x.params, x.velocity, x.draws, K.ptr
    rc = lib.cd_train_wide_modes_run(
        ptr(x.data), ptr(x.order), ptr(u["h0"]), ptr(u["h"]), ptr(u["v"]), ptr(u["swap"]),
        ptr(betas), ptr(p.W), ptr(p.b), ptr(p.c), ptr(v.W), ptr(v.b), ptr(v.c), ptr(p.z),
        ptr(v.z), ptr(x.chain), ptr(errs), ptr(scratch), ptr(trace),
        V, H, B, M, x.nb, x.n_epochs, cfg.k, start_epoch, cfg.momentum_switch_epoch, x.flags,
        cfg.lr, cfg.lr if cfg.lr_variance is None else cfg.lr_variance, *K.schedule_args(cfg),
        x.seed, x.device_index, grid, x.stream)
    if rc != 0:  # the launch's cudaGetLastError
        raise RuntimeError(f"cd_train_wide_modes kernel launch failed: cudaError {rc} "
                           f"({lib.cd_train_wide_modes_error_string(rc).decode()})")
    cd_train_wide_modes_launches += 1
    return p, v, x.chain, errs

"""The W-blocked training run of one wide RBM: CUDA kernel and plain version.

Port of ``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel_wb``, the kernel
the TPU trains its widest models through (28000x400 float32, 40000x1000
bfloat16). ``cd_train_wide_run`` wraps the hand-written kernel
``csrc/cd_train_wide.cu`` (one cooperative launch per run), in which every
product with W is a sum over fixed strips of W's rows;
``cd_train_wide_run_plain`` is the same function in plain PyTorch. Both have
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
    two blocks per SM); the result does not depend on it. ``trace``, an int64
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

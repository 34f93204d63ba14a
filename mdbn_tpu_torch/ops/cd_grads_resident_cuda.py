"""One CD-k / PCD step's statistics on the W-resident cluster design: CUDA kernel.

``cd_grads_resident_step`` wraps the step variant of the resident kernel
(``csrc/cd_train_resident.cu`` built with ``-DMDBN_RESIDENT_STEP=1``, one
library per estimator-mode variant: ``step_library``), the per-step kernel
of the data-parallel path for a run whose tiles fit thread-block clusters
(``ops.cd_epoch_cuda.select_dp_kernel`` gives "cd_grads_resident"). It
computes what ``ops.cd_grads_cuda.cd_grads_step`` computes, with its
arguments, inject layouts, Philox keying and flat statistics buffer
(``flat_size`` / ``flat_views``), in every estimator mode and at both storage
dtypes; its plain version is ``ops.cd_grads_cuda.cd_grads_step_plain``, the
same function, which CPU tensors take. ``grid`` counts clusters here (0: as
many as the card holds, balanced over the strips); the result does not
depend on it.

The kernel keeps its barrier counters and the monitor's strip sums in a
scratch buffer that it leaves zero after each launch, so a captured epoch
(``parallel.dp``) reuses one scratch for every step; a wrapper call makes
its own.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams
from .cd_epoch_cuda import check_trace, kernel_flags, ptr
from .cd_epoch_resident_cuda import (device_limits, resident_library, resident_tiles,
                                     resident_trace_len)
from .cd_grads_cuda import (_check_pseudo, _device_index, cd_grads_step_plain, flat_views,
                            step_inputs, step_outputs)

# Launches of the CUDA kernel in this process (incremented only where the
# kernel is launched; a captured epoch counts its steps at each replay).
cd_grads_resident_launches = 0


def step_library(cfg: RBMConfig) -> str:
    """The library of the step variant that runs ``cfg`` (``_build.KERNELS``):
    the plain estimator, the modes without a tempering ladder, or with one."""
    return resident_library(cfg).replace("cd_train_resident", "cd_grads_resident")


def step_limits(cfg: RBMConfig, device: torch.device) -> Tuple[int, int]:
    """``device_limits`` asked of the step variant's library: (opt-in shared
    memory of a block, clusters of ``cfg``'s tiling the card holds at once).
    Sets the variant's kernels up for launch, so a launch after it makes no
    request of the device (as one captured in a CUDA graph must not)."""
    return device_limits(cfg, device, library=step_library(cfg))


def step_scratch(cfg: RBMConfig, device: torch.device) -> torch.Tensor:
    """A zeroed scratch buffer for the steps of ``cfg`` (each launch leaves it
    zero; steps on one stream may share it)."""
    from .._build import load_library  # builds the kernels at first use

    lib = load_library(step_library(cfg), cfg.param_dtype).lib
    n = lib.cd_train_resident_scratch_floats(cfg.n_visible, cfg.n_hidden, cfg.batch_size,
                                             cfg.pt_temps, kernel_flags(cfg))
    return torch.zeros(int(n), dtype=torch.float32, device=device)


def step_launcher(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor, chain: torch.Tensor,
                  *, seed: Optional[int] = None,
                  uniforms: Optional[Dict[str, torch.Tensor]] = None,
                  mask: Optional[torch.Tensor] = None, norm: Optional[float] = None,
                  out: Optional[torch.Tensor] = None, grid: int = 0,
                  pseudo_bit: Optional[int] = None, tab: Optional[torch.Tensor] = None,
                  chain_out: Optional[torch.Tensor] = None,
                  scratch: Optional[torch.Tensor] = None,
                  trace: Optional[torch.Tensor] = None,
                  ) -> Tuple[Callable[[], None], RBMParams, torch.Tensor, torch.Tensor]:
    """``ops.cd_grads_cuda.step_launcher`` for this kernel: returns (launch,
    grads, new_chain, err); ``launch()`` launches once on the current stream
    of this call and counts nothing. Under CD the chain passes through:
    ``new_chain`` is ``chain``. ``scratch``: ``step_scratch`` to share (else
    a new one); ``trace``, an int64 CUDA tensor [1, 1,
    ``ops.cd_epoch_resident_cuda.resident_trace_len(cfg)``], receives the
    device clock at the start of each phase (the update's stamp marks the
    statistics). Raises ValueError for a config or input the kernel does
    not take (tiles that do not fit the card included)."""
    _check_pseudo(cfg, pseudo_bit if tab is None else 0)
    device = v0.device
    B, V, H, k, M = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k, cfg.pt_temps
    tiles = resident_tiles(cfg, *step_limits(cfg, device), clusters=grid)
    if not tiles.fits:
        raise ValueError(f"a {V}x{H} step at batch {B} does not fit the card's shared memory "
                         f"({tiles.smem_bytes} bytes a block); csrc/cd_grads.cu takes it")
    v0, W, b, c, z, chain, mask, u, flags, betas, tab = step_inputs(
        cfg, params, v0, chain, uniforms, mask, seed, tab)
    check_trace(trace, (1, 1, resident_trace_len(cfg)), device)

    from .._build import load_library  # builds the kernels at first use

    lib = load_library(step_library(cfg), cfg.param_dtype).lib
    out, new_chain = step_outputs(cfg, device, out, chain_out if cfg.persistent else chain)
    if scratch is None:
        scratch = step_scratch(cfg, device)
    args = (ptr(v0), ptr(tab), ptr(mask), ptr(u["h0"]), ptr(u["h"]), ptr(u["v"]), ptr(u["swap"]),
            ptr(betas), ptr(W), ptr(b), ptr(c), ptr(z), ptr(chain), ptr(out), ptr(new_chain),
            ptr(scratch), ptr(trace), V, H, B, M, k, flags,
            pseudo_bit if pseudo_bit is not None else -1,
            1.0 / float(norm if norm is not None else B),
            cfg.sparsity_target if cfg.sparsity_target is not None else 0.0,
            cfg.sparsity_cost, (seed or 0) % 2 ** 64, _device_index(device), tiles.clusters,
            torch.cuda.current_stream(device).cuda_stream)
    keep = (v0, W, b, c, z, chain, mask, u, betas, tab, out, new_chain, scratch, trace)

    def launch(keep=keep) -> None:  # keep: the buffers the pointers point into
        rc = lib.cd_grads_resident_step(*args)
        if rc != 0:
            raise RuntimeError(f"cd_grads_resident kernel launch failed: cudaError {rc} "
                               f"({lib.cd_train_resident_error_string(rc).decode()})")

    grads, _, err = flat_views(cfg, out)
    return launch, grads, new_chain, err


def cd_grads_resident_step(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor,
                           chain: torch.Tensor, *, seed: Optional[int] = None,
                           uniforms: Optional[Dict[str, torch.Tensor]] = None,
                           mask: Optional[torch.Tensor] = None, norm: Optional[float] = None,
                           out: Optional[torch.Tensor] = None, grid: int = 0,
                           pseudo_bit: Optional[int] = None,
                           ) -> Tuple[RBMParams, torch.Tensor, torch.Tensor]:
    """The step on the resident kernel's step variant (see module doc); one
    launch on the current stream. CPU tensors take ``cd_grads_step_plain``.
    Raises ValueError for a config or input the kernel does not take and
    RuntimeError when the launch fails."""
    global cd_grads_resident_launches
    if v0.device.type == "cpu":
        return cd_grads_step_plain(cfg, params, v0, chain, seed=seed, uniforms=uniforms,
                                   mask=mask, norm=norm, out=out, pseudo_bit=pseudo_bit)
    if v0.device.type != "cuda":
        raise ValueError(f"cd_grads_resident_step takes CPU or CUDA tensors, got {v0.device}")
    launch, grads, new_chain, err = step_launcher(
        cfg, params, v0, chain, seed=seed, uniforms=uniforms, mask=mask, norm=norm, out=out,
        grid=grid, pseudo_bit=pseudo_bit)
    launch()
    cd_grads_resident_launches += 1
    return grads, new_chain, err

"""A whole E-epoch CD-k/PCD training run of one RBM: CUDA kernel and plain version.

Port of the single-device modes of
``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel``, with its estimator
modes (parallel tempering, the enhanced gradient, learned variance, the
pseudo-likelihood monitor) and both storage dtypes (float32 and bfloat16
parameters, velocities, chain and data; update arithmetic in fp32, rounded
once). ``cd_train_run`` wraps the hand-written kernel ``csrc/cd_train.cu``
(one cooperative launch per run); ``cd_train_run_plain`` is the same function
in plain PyTorch, built from ``core.rbm_math``'s ``cd_step_stats`` /
``pt_step_stats`` and ``apply_update``. The TPU kernel's wide-state modes
(``hbm_state``, ``chunk_update``, ``stream_vel``, H padding) compute the same
function under a VMEM budget; this kernel keeps all state in device memory
at any width, so they have no counterpart of their own. A run whose tiles
of W fit the shared memory of the card goes to the resident kernel of
``ops.cd_epoch_resident_cuda`` instead, under any estimator mode; a wide run
that does not fit it to the W-blocked kernel of ``ops.cd_epoch_wide_cuda``
(plain estimator) or the strip-split kernel of
``ops.cd_epoch_wide_modes_cuda`` (tempering, the enhanced gradient, learned
variance); ``cd_train.cu`` keeps the rest (``select_kernel``;
``kernel_run`` gives the wrapper of each). They take

- ``params`` / ``velocity`` (``RBMParams``, with ``z`` under learned
  variance) and the PCD ``chain`` [CR, H], CR = B, or M*B rung-major under
  tempering (``core.state.chain_rows``);
- ``data`` [n, V]: minibatch ``j`` is rows ``[j*B, (j+1)*B)``;
- ``order`` [E, nb] int: the minibatch each update trains on
  (``batch_order``);
- ``uniforms`` (optional): the inject layout of ``draw_uniform_blocks`` —
  h0 [E, nb, B, H], h [E, nb, k, CR, H], v (Bernoulli) or noise (Gaussian)
  [E, nb, k, CR, V] when visibles are sampled, and under tempering swap
  [E, nb, 2, (M-1)*B] (round, then rung-major) — indexed by the update's
  position (e, i), not by the minibatch it trains on;
- ``generator``: the source of the run's randomness when ``uniforms`` is None,

and return ``(params, velocity, chain, errs[E])`` as new tensors. The chain
changes only in PCD mode, as in the TPU kernel.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import (RBMParams, apply_update, cd_step_stats, hidden_mean, noise_scale,
                             pseudo_likelihood, pt_betas, pt_hidden_mean, pt_log_accept,
                             pt_visible_mean, pt_visible_sample, torch_dtype, _pt_swap_round,
                             visible_mean)
from ..core.state import chain_rows
from .cd_step import draw_pt_uniforms, draw_uniforms, step_stats

# Launches of the CUDA kernel in this process (incremented only where the
# kernel is launched).
cd_train_launches = 0

_F_GAUSSIAN, _F_SAMPLE_V, _F_PERSISTENT, _F_BF16 = 1, 2, 4, 8
_F_XENT, _F_INJECT, _F_CLIP, _F_SPARSITY, _F_MOM_SCHEDULE = 16, 32, 64, 128, 256
_F_TEMPERING, _F_ENHANCED, _F_LEARN_VAR, _F_PSEUDO = 512, 1024, 2048, 4096


def wide_unsupported(cfg: RBMConfig) -> Optional[str]:
    """Why the W-blocked kernel (``csrc/cd_train_wide.cu``) does not take
    ``cfg`` (None when it does). Its scope is that of the TPU's W-blocked
    kernel (``needs_w_chunking``) without that kernel's layout limits on V
    and the batch size."""
    outside = [name for name, on in (
        ("sampled visibles", cfg.resolved_sample_visible),
        ("the pseudo-likelihood monitor", cfg.error_metric not in ("mse", "xent")),
        ("the enhanced gradient", cfg.gradient != "plain"),
        ("tempering", cfg.pt_temps > 1),
        ("learned variance", cfg.learn_variance)) if on]
    if outside:
        return ("the W-blocked kernel runs a mean-field negative phase with an mse or xent "
                f"monitor and the plain gradient; it does not take {', '.join(outside)}")
    return None


def wide_modes_unsupported(cfg: RBMConfig) -> Optional[str]:
    """Why the strip-split kernel of the estimator modes
    (``csrc/cd_train_wide_modes.cu``) does not take ``cfg`` (None when it
    does): it runs tempering, the enhanced gradient and learned variance, in
    any combination, at either storage dtype."""
    if cfg.pt_temps <= 1 and cfg.gradient == "plain" and not cfg.learn_variance:
        return ("the plain estimator belongs to csrc/cd_train_wide.cu and "
                "csrc/cd_train_resident.cu; the strip-split kernel of the estimator modes "
                "runs tempering, the enhanced gradient or learned variance")
    if cfg.error_metric == "pseudo":
        return ("the pseudo-likelihood monitor (it flips one bit of a binary visible, and no "
                "wide row uses it) runs on csrc/cd_train_resident.cu where the tiles fit, "
                "else on csrc/cd_train.cu")
    if cfg.batch_size > WIDE_MODES_MAX_BATCH:
        return (f"the strip-split kernel of the estimator modes stages a strip of the whole "
                f"batch in shared memory: batch_size > {WIDE_MODES_MAX_BATCH} stays on "
                "csrc/cd_train.cu")
    return None


WIDE_MODES_MAX_BATCH = 256  # csrc/cd_wide_modes_phases.cuh: kMaxBatch


# The visible width from which a run inside the W-blocked kernel's scope whose
# tiles do not fit the resident kernel takes the W-blocked kernel instead of
# cd_train.cu. cd_train.cu gives a hidden phase's unit all V rows of its W
# columns, so its time per update grows with V from a low floor;
# cd_train_wide.cu splits every x W product over strips of V and starts from a
# higher floor (3 + 3k grid barriers per update, about 60 us at any width).
# Timed on an H100 (scripts/torch_wide_crossover.py: H 400 and 1000, batch 20
# and 64, float32 and bf16, in turns): the resident kernel is ahead of the
# W-blocked kernel wherever its tiles fit (up to V 4096 at bf16), and the
# W-blocked kernel ahead of cd_train.cu at every measured width from this one.
WIDE_MIN_VISIBLE = 2000


# The visible width from which a run of the estimator modes that
# csrc/cd_train_wide_modes.cu takes (wide_modes_unsupported) goes to it
# instead of csrc/cd_train.cu. Timed on an H100 at H 400, batch 20
# (scripts/torch_wide_crossover.py --modes), the strip-split kernel is ahead
# from V 3000 under 3-rung tempering at bf16, from 4096 under the enhanced
# gradient and from 5000 under learned variance (at 4096 it is 1% behind),
# by 2.0-2.4x at 20000: the smallest measured width from which it wins in
# every mode.
WIDE_MODES_MIN_VISIBLE = 5000


def select_kernel(cfg: RBMConfig, limits: Optional[Tuple[int, int]] = None) -> str:
    """The kernel a run of ``cfg`` takes, at any k: "cd_train_resident" when
    its tiles of W and the velocity (and, under an estimator mode, the
    mode's buffers: a tempering ladder's M*B chain rows among them) fit the
    shared memory of a card with ``limits``
    (``ops.cd_epoch_resident_cuda.device_limits``; None: an H100's), under
    the plain estimator or any estimator mode; else "cd_train_wide" when the
    config lies in the W-blocked kernel's scope and is at least
    ``WIDE_MIN_VISIBLE`` wide; "cd_train_wide_modes" when it lies in the
    scope of the strip-split kernel of the estimator modes and is at least
    ``WIDE_MODES_MIN_VISIBLE`` wide; else "cd_train". Decided from the
    config and those two numbers. Timed on an H100 (scripts/torch_kernel_ab.py
    --sweep: V 64-4095, H 100-8192, batches 4-64, f32 and bf16), the resident
    kernel is ahead of cd_train.cu wherever its tiles fit, by 1.1x to 2.4x,
    and (scripts/torch_wide_crossover.py) of the W-blocked kernel, so there
    is no width cut-off for it; under the estimator modes the same holds
    against cd_train.cu and the strip-split kernel (--sweep --modes and
    torch_wide_crossover.py --modes)."""
    from .cd_epoch_resident_cuda import resident_admits

    if resident_admits(cfg, limits):
        return "cd_train_resident"
    if wide_unsupported(cfg) is None and cfg.n_visible >= WIDE_MIN_VISIBLE:
        return "cd_train_wide"
    if wide_modes_unsupported(cfg) is None and cfg.n_visible >= WIDE_MODES_MIN_VISIBLE:
        return "cd_train_wide_modes"
    return "cd_train"


def kernel_run(kernel: str) -> Callable:
    """The wrapper that launches ``kernel`` (a name ``select_kernel`` gives),
    with the signature of ``cd_train_run``."""
    if kernel == "cd_train_resident":
        from .cd_epoch_resident_cuda import cd_train_resident_run

        return cd_train_resident_run
    if kernel == "cd_train_wide_modes":
        from .cd_epoch_wide_modes_cuda import cd_train_wide_modes_run

        return cd_train_wide_modes_run
    if kernel not in ("cd_train", "cd_train_wide"):
        raise ValueError(f"no kernel {kernel!r}")
    return functools.partial(cd_train_run, wide=kernel == "cd_train_wide")


# The visible width from which a data-parallel run inside the W-blocked
# kernel's scope takes the W-blocked DP kernels (csrc/cd_grads_wide.cu: a step
# whose x W products split over strips of V, an all-gather of the factors, an
# update that forms gW from them) instead of csrc/cd_grads.cu (a step whose
# products walk all of V in one unit, an all-reduce of the whole gradient, an
# elementwise update). Measured by step plus update on one NCCL rank
# (scripts/torch_wide_crossover.py --dp).
WIDE_DP_MIN_VISIBLE = 4096


def select_dp_kernel(cfg: RBMConfig, ndev: int = 1,
                     limits: Optional[Tuple[int, int]] = None) -> str:
    """The kernels a data-parallel run of ``cfg`` over ``ndev`` ranks takes:
    "cd_grads_wide" when the config lies in the W-blocked kernel's scope and
    is at least ``WIDE_DP_MIN_VISIBLE`` wide; else "cd_grads_resident" (the
    resident kernel's step variant, csrc/cd_train_resident.cu) when the
    tiles of a rank's step (``batch_size`` = the rank's rows,
    ``parallel.dp.local_batch``) fit a card with ``limits``
    (``ops.cd_epoch_resident_cuda.device_limits``; None: an H100's), under
    any estimator mode; else "cd_grads" (csrc/cd_grads.cu). Decided from the
    config, the rank count and those two numbers."""
    from .cd_epoch_resident_cuda import resident_admits

    if wide_unsupported(cfg) is None and cfg.n_visible >= WIDE_DP_MIN_VISIBLE:
        return "cd_grads_wide"
    local = cfg.replace(batch_size=-(-cfg.batch_size // ndev))
    return "cd_grads_resident" if resident_admits(local, limits) else "cd_grads"


def trace_phases(cfg: RBMConfig) -> List[str]:
    """The kernel's phases of one update, in the order a trace stamps their
    starts: the hidden phase from the data, a visible and a hidden phase per
    Gibbs step, the product phase (tempering's log p*(h) inputs, learned
    variance's z statistic), the two swap rounds (tempering), the update, and
    the enhanced gradient's bias phase."""
    pt = cfg.pt_temps > 1
    names = ["hidden_from_data"]
    for t in range(cfg.k):
        names += [f"visible_{t}", f"hidden_{t}"]
    names += (["products"] if pt or cfg.learn_variance else [])
    names += (["swap_even", "swap_odd"] if pt else []) + ["update_and_monitor"]
    return names + (["enhanced_bias"] if cfg.gradient == "enhanced" else [])


def trace_len(cfg: RBMConfig) -> int:
    """Clock stamps per update in a kernel trace: one per phase, and the end."""
    return len(trace_phases(cfg)) + 1


def batch_order(cfg: RBMConfig, nb: int, n_epochs: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """[E, nb] int32 minibatch order on the CPU: a fresh permutation of the nb
    minibatches per epoch from ``generator`` when ``cfg.shuffle``, else in
    order. (The TPU kernel shuffles super-batches of its unroll factor U; the
    port shuffles single minibatches, and ``perm[s]*U + u`` expands a TPU
    table into this layout.)"""
    if not cfg.shuffle:
        return torch.arange(nb, dtype=torch.int32).repeat(n_epochs, 1)
    return torch.stack([torch.randperm(nb, generator=generator)
                        for _ in range(n_epochs)]).to(torch.int32)


def draw_uniform_blocks(cfg: RBMConfig, generator: torch.Generator, n_epochs: int,
                        nb: int, device=None) -> Dict[str, torch.Tensor]:
    """Every random draw of a run, in the inject layout (see module doc)."""
    B, V, H, k, CR = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k, chain_rows(cfg)
    device = generator.device if device is None else device
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    u = {"h0": torch.rand((n_epochs, nb, B, H), **kw),
         "h": torch.rand((n_epochs, nb, k, CR, H), **kw)}
    if cfg.resolved_sample_visible:
        if cfg.visible == "bernoulli":
            u["v"] = torch.rand((n_epochs, nb, k, CR, V), **kw)
        else:
            u["noise"] = torch.randn((n_epochs, nb, k, CR, V), **kw)
    if cfg.pt_temps > 1:
        u["swap"] = torch.rand((n_epochs, nb, 2, (cfg.pt_temps - 1) * B), **kw)
    return u


def _step_uniforms(cfg: RBMConfig, uniforms: Dict[str, torch.Tensor], e: int, i: int
                   ) -> Dict[str, torch.Tensor]:
    """Update (e, i)'s draws as views in the layout of the core's step
    function (``draw_pt_uniforms``' [k, M, B, ·] and [2, M-1, B] under
    tempering)."""
    u = {name: x[e, i] for name, x in uniforms.items()}
    if cfg.pt_temps <= 1:
        return u
    M, B = cfg.pt_temps, cfg.batch_size
    return {name: (x if name == "h0" else x.reshape(2, M - 1, B) if name == "swap"
                   else x.reshape(cfg.k, M, B, -1)) for name, x in u.items()}


def _step_fn(cfg: RBMConfig, wide: bool, storage: torch.dtype) -> Callable:
    """(params, v0, chain, u) -> (grads, chain, err) of one update: the core's
    step, with the W-blocked kernel's factor rounding when ``wide``."""
    if not wide:
        return lambda params, v0, chain, u: step_stats(cfg, params, v0, chain, u)
    return lambda params, v0, chain, u: cd_step_stats(
        params, v0, chain if cfg.persistent else None, u, cfg, factor_dtype=storage)


def harden_uniform_blocks(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                          chain: torch.Tensor, data: torch.Tensor,
                          uniforms: Dict[str, torch.Tensor], n_epochs: int,
                          eps: float = 1e-4, start_epoch: int = 0, swap_eps: float = 1e-5,
                          wide: bool = False) -> Dict[str, torch.Tensor]:
    """Move every Bernoulli draw that lies within ``eps`` of its threshold
    away from it, keeping each ``u < p`` outcome, so the run's trajectory is
    unchanged but no draw sits on a knife edge where the kernel's and the
    plain version's fp32 probabilities (which differ in summation order)
    could sample differently. Replays the run in order with the plain math
    (that of the W-blocked kernel when ``wide``).
    Port of ``mdbn_tpu/ops/cd_epoch_pallas.py::harden_uniform_blocks``,
    extended to tempering (which the JAX version refuses): the rung draws are
    nudged like the others, and each swap draw whose log lies within
    ``swap_eps`` times (1 + the magnitude of the ratio's terms) of its log
    acceptance ratio moves that far away from it, keeping its outcome where
    a uniform below 1 can (else it becomes an accept)."""
    if cfg.shuffle:
        raise ValueError("hardening replays the minibatches in order (shuffle=False)")
    B, V = cfg.batch_size, cfg.n_visible
    nb = data.shape[0] // B
    batches = data[: nb * B].reshape(nb, B, V).float()
    hard = {name: u.clone() for name, u in uniforms.items()}
    storage = chain.dtype
    step = _step_fn(cfg, wide, storage)
    chain = chain.float()

    def nudge(dst: torch.Tensor, p: torch.Tensor) -> None:
        d = dst - p
        moved = torch.clamp(torch.where(d < 0, p - eps, p + eps), 0.0, 1.0)
        dst.copy_(torch.where(d.abs() < eps, moved, dst))

    for e in range(n_epochs):
        for i in range(nb):
            v0 = batches[i]
            u = _step_uniforms(cfg, hard, e, i)  # views: nudges land in ``hard``
            hm = hidden_mean(params, v0, cfg)
            nudge(u["h0"], hm)
            if cfg.pt_temps > 1:
                _harden_ladder(cfg, params, chain, u, nudge, swap_eps)
            else:
                _harden_chain(cfg, params, chain if cfg.persistent
                              else (u["h0"] < hm).float(), u, nudge,
                              storage if wide else None)
            grads, new_chain, _ = step(params, v0, chain, u)
            if cfg.persistent:
                chain = new_chain
            params, velocity = apply_update(params, velocity, grads, cfg,
                                            epoch=start_epoch + e)
    return hard


def _harden_chain(cfg: RBMConfig, params: RBMParams, h: torch.Tensor,
                  u: Dict[str, torch.Tensor], nudge: Callable,
                  factor_dtype: Optional[torch.dtype]) -> None:
    for t in range(cfg.k):
        vmean = visible_mean(params, h, cfg)
        if cfg.resolved_sample_visible and cfg.visible == "bernoulli":
            nudge(u["v"][t], vmean)
            vs = (u["v"][t] < vmean).float()
        elif cfg.resolved_sample_visible:
            noise = u["noise"][t]
            vs = vmean + (noise if params.z is None else noise * noise_scale(params))
        else:
            vs = vmean
        if factor_dtype is not None:
            vs = vs.to(factor_dtype).float()
        hm = hidden_mean(params, vs, cfg)
        nudge(u["h"][t], hm)
        h = (u["h"][t] < hm).float()


def _harden_ladder(cfg: RBMConfig, params: RBMParams, chain: torch.Tensor,
                   u: Dict[str, torch.Tensor], nudge: Callable, swap_eps: float) -> None:
    M, B = cfg.pt_temps, cfg.batch_size
    betas = pt_betas(cfg, chain.device)
    bM = betas[:, None, None]
    h = chain.reshape(M, B, -1)
    for t in range(cfg.k):
        vmean = pt_visible_mean(params, h, bM, cfg)
        if cfg.resolved_sample_visible and cfg.visible == "bernoulli":
            nudge(u["v"][t], vmean)
        hm = pt_hidden_mean(params, pt_visible_sample(params, vmean, u, t, bM, cfg), bM, cfg)
        nudge(u["h"][t], hm)
        h = (u["h"][t] < hm).float()
    used = torch.zeros((2, M - 1, 1), dtype=torch.bool, device=chain.device)
    used[0, 0::2] = used[1, 1::2] = True  # the pairs each round proposes
    for p in (0, 1):
        log_a, scale = pt_log_accept(params, h, betas, cfg)
        margin = swap_eps * (1.0 + scale)
        us = u["swap"][p]
        log_u = torch.log(torch.clamp(us, min=1e-38))
        near = ((log_u - log_a).abs() < margin) & used[p]
        reject_at = torch.exp(log_a + margin)
        moved = torch.where((log_u < log_a) | (reject_at >= 1.0),
                            torch.exp(log_a - margin), reject_at)
        us.copy_(torch.where(near, moved, us))
        h = _pt_swap_round(params, h, betas, us, p, cfg)


def _draw_seed(generator: Optional[torch.Generator]) -> int:
    """The seed of one run: one draw from ``generator``."""
    if generator is None:
        raise ValueError("a run without injected uniforms needs a generator")
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


def run_plain(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
              chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
              start_epoch: int, uniforms: Optional[Dict[str, torch.Tensor]],
              generator: Optional[torch.Generator], wide: bool,
              ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The run in plain PyTorch, with the W-blocked kernel's factor rounding
    when ``wide``. Data and chain widen to fp32 as they are read (the kernels
    do the same); the chain rounds back into its storage dtype (0 and 1 are
    exact in bf16)."""
    B, V = cfg.batch_size, cfg.n_visible
    nb = data.shape[0] // B
    batches = data[: nb * B].reshape(nb, B, V)
    dgen = (None if uniforms is not None else
            torch.Generator(device=data.device).manual_seed(_draw_seed(generator)))
    draw = draw_pt_uniforms if cfg.pt_temps > 1 else draw_uniforms
    step = _step_fn(cfg, wide, chain.dtype)
    errs = []
    for e, row in enumerate(order.tolist()):
        epoch = start_epoch + e
        epoch_errs = []
        for i, j in enumerate(row):
            v0 = batches[j].float()
            u = (_step_uniforms(cfg, uniforms, e, i) if uniforms is not None
                 else draw(cfg, B, dgen, data.device))
            grads, new_chain, err = step(params, v0, chain.float(), u)
            if cfg.error_metric == "pseudo":
                err = pseudo_likelihood(params, v0, (epoch * nb + i) % V, cfg)
            params, velocity = apply_update(params, velocity, grads, cfg, epoch=epoch)
            if cfg.persistent:
                chain = new_chain.to(chain.dtype)
            epoch_errs.append(err)
        errs.append(torch.stack(epoch_errs).mean())
    return params, velocity, chain, torch.stack(errs)


def cd_train_run_plain(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                       chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                       start_epoch: int = 0,
                       uniforms: Optional[Dict[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None,
                       ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the run (see module doc)."""
    return run_plain(cfg, params, velocity, chain, data, order, start_epoch, uniforms,
                     generator, wide=False)


def _on_device(t: torch.Tensor, name: str, shape, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (the config's param_dtype for state and "
                         f"data, float32 for draws), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.contiguous()


def kernel_flags(cfg: RBMConfig) -> int:
    """The kernel's mode bits for ``cfg`` (inject excluded)."""
    return ((_F_GAUSSIAN if cfg.visible == "gaussian" else 0)
            | (_F_SAMPLE_V if cfg.resolved_sample_visible else 0)
            | (_F_PERSISTENT if cfg.persistent else 0)
            | (_F_BF16 if cfg.compute_dtype == "bfloat16" else 0)
            | (_F_XENT if cfg.error_metric == "xent" else 0)
            | (_F_CLIP if cfg.grad_clip is not None else 0)
            | (_F_SPARSITY if cfg.sparsity_target is not None and cfg.sparsity_cost else 0)
            | (_F_MOM_SCHEDULE if cfg.initial_momentum is not None else 0)
            | (_F_TEMPERING if cfg.pt_temps > 1 else 0)
            | (_F_ENHANCED if cfg.gradient == "enhanced" else 0)
            | (_F_LEARN_VAR if cfg.learn_variance else 0)
            | (_F_PSEUDO if cfg.error_metric == "pseudo" else 0))


@dataclass
class KernelInputs:
    """One run's inputs as a kernel takes them: checked, contiguous, on the
    device. The state tensors are fresh copies (the kernels update in place);
    a tensor the config does not use is None."""

    data: torch.Tensor
    order: torch.Tensor
    params: RBMParams
    velocity: RBMParams
    chain: torch.Tensor
    draws: Dict[str, Optional[torch.Tensor]]  # h0, h, v, swap (inject mode)
    flags: int
    seed: int
    nb: int
    n_epochs: int
    device_index: int
    stream: int


def kernel_inputs(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                  chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                  uniforms: Optional[Dict[str, torch.Tensor]],
                  generator: Optional[torch.Generator]) -> KernelInputs:
    """Check a run's inputs against ``cfg`` and lay them out for a kernel.
    Raises ValueError for what the kernels do not take."""
    device = data.device
    sdt = torch_dtype(cfg.param_dtype)
    B, V, H, k, CR = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k, chain_rows(cfg)
    M = cfg.pt_temps
    nb = data.shape[0] // B
    if nb == 0 or data.dim() != 2 or data.shape[1] != V:
        raise ValueError(f"data must be [n >= {B}, {V}], got {tuple(data.shape)}")
    if order.dim() != 2 or order.shape[1] != nb or order.shape[0] < 1:
        raise ValueError(f"order must be [E, {nb}], got {tuple(order.shape)}")
    if int(order.min()) < 0 or int(order.max()) >= nb:
        raise ValueError(f"order holds minibatch indices outside [0, {nb})")
    n_epochs = order.shape[0]
    if cfg.learn_variance and (params.z is None or velocity.z is None):
        raise ValueError("learn_variance=True needs z in params and velocity")
    shapes = {"W": (V, H), "b": (V,), "c": (H,), "z": (V,)}
    names = ("W", "b", "c", "z") if cfg.learn_variance else ("W", "b", "c")

    def state(part: RBMParams, prefix: str) -> RBMParams:
        return RBMParams(**{n: _on_device(getattr(part, n), prefix + n, shapes[n], device,
                                          sdt).clone() for n in names})

    flags = kernel_flags(cfg)
    draws: Dict[str, Optional[torch.Tensor]] = dict(h0=None, h=None, v=None, swap=None)
    seed = 0
    if uniforms is not None:
        flags |= _F_INJECT
        f32 = torch.float32
        draws["h0"] = _on_device(uniforms["h0"], "uniforms['h0']", (n_epochs, nb, B, H),
                                 device, f32)
        draws["h"] = _on_device(uniforms["h"], "uniforms['h']", (n_epochs, nb, k, CR, H),
                                device, f32)
        if cfg.resolved_sample_visible:
            kv = "v" if cfg.visible == "bernoulli" else "noise"
            draws["v"] = _on_device(uniforms[kv], f"uniforms['{kv}']",
                                    (n_epochs, nb, k, CR, V), device, f32)
        if M > 1:
            draws["swap"] = _on_device(uniforms["swap"], "uniforms['swap']",
                                       (n_epochs, nb, 2, (M - 1) * B), device, f32)
    else:
        seed = _draw_seed(generator)
    return KernelInputs(
        data=_on_device(data[: nb * B], "data", (nb * B, V), device, sdt),
        order=_to_device(order.to(torch.int32), device),
        params=state(params, ""), velocity=state(velocity, "v"),
        chain=_on_device(chain, "chain", (CR, H), device, sdt).clone(),
        draws=draws, flags=flags, seed=seed, nb=nb, n_epochs=n_epochs,
        device_index=device.index if device.index is not None else torch.cuda.current_device(),
        stream=torch.cuda.current_stream(device).cuda_stream)


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, contiguous. A CPU tensor goes through pinned memory
    without blocking: a copy from pageable memory would wait for the kernels
    already queued on the stream, so the host could not queue the next launch
    while the card runs the last one."""
    if t.device.type == "cpu" and device.type == "cuda":
        return t.contiguous().pin_memory().to(device, non_blocking=True)
    return t.to(device).contiguous()


def check_trace(trace: Optional[torch.Tensor], shape, device: torch.device) -> None:
    if trace is not None and (trace.device != device or trace.dtype != torch.int64
                              or tuple(trace.shape) != tuple(shape)
                              or not trace.is_contiguous()):
        raise ValueError(f"trace must be a contiguous int64 tensor {list(shape)} on {device}")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def schedule_args(cfg: RBMConfig) -> Tuple[float, float, float, float, float, float]:
    """momentum, initial_momentum, l2, grad_clip, sparsity_target and
    sparsity_cost as the kernels take them (0 where the config has None; the
    mode bits say which apply)."""
    return (cfg.momentum, cfg.initial_momentum if cfg.initial_momentum is not None else 0.0,
            cfg.l2, cfg.grad_clip if cfg.grad_clip is not None else 0.0,
            cfg.sparsity_target if cfg.sparsity_target is not None else 0.0,
            cfg.sparsity_cost)


def cd_train_run(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                 chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                 start_epoch: int = 0,
                 uniforms: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None, grid: int = 0,
                 trace: Optional[torch.Tensor] = None, wide: bool = False,
                 ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The run on a CUDA kernel (see module doc); one launch on the current
    stream. CPU tensors take ``cd_train_run_plain``. ``grid`` is the
    cooperative grid (0: the kernel's default); the result does not depend on
    it, which the tests check by launching several grids.
    ``wide``: False runs ``csrc/cd_train.cu``; True runs the W-blocked
    ``csrc/cd_train_wide.cu`` (``ops.cd_epoch_wide_cuda.cd_train_wide_run``)
    at any size and raises for a config outside its scope. The kernel a run
    of ``cfg`` should take is ``kernel_run(select_kernel(cfg, limits))``.
    ``trace``, an int64 CUDA tensor [E, nb, trace_len(cfg)] (W-blocked:
    ``wide_trace_len``), receives the device clock (ns) at the start of each
    phase of each update as block 0 sees it.
    Raises ValueError for a config or input the kernel does not take and
    RuntimeError when the launch fails."""
    global cd_train_launches
    if data.device.type == "cpu":
        if wide:
            from .cd_epoch_wide_cuda import cd_train_wide_run_plain

            return cd_train_wide_run_plain(cfg, params, velocity, chain, data, order,
                                           start_epoch, uniforms, generator)
        return cd_train_run_plain(cfg, params, velocity, chain, data, order,
                                  start_epoch, uniforms, generator)
    if data.device.type != "cuda":
        raise ValueError(f"cd_train_run takes CPU or CUDA tensors, got {data.device}")
    if wide:
        from .cd_epoch_wide_cuda import cd_train_wide_run

        return cd_train_wide_run(cfg, params, velocity, chain, data, order, start_epoch,
                                 uniforms, generator, grid, trace)
    x = kernel_inputs(cfg, params, velocity, chain, data, order, uniforms, generator)
    device = data.device
    B, V, H, M = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.pt_temps
    check_trace(trace, (x.n_epochs, x.nb, trace_len(cfg)), device)
    betas = pt_betas(cfg, device) if M > 1 else None

    from .._build import load_library  # builds the kernels at first use

    lib = load_library("cd_train", cfg.param_dtype).lib
    errs = torch.empty(x.n_epochs, dtype=torch.float32, device=device)
    scratch = torch.empty(int(lib.cd_train_scratch_floats(V, H, B, M, x.flags)),
                          dtype=torch.float32, device=device)
    p, v, u = x.params, x.velocity, x.draws
    rc = lib.cd_train_run(
        ptr(x.data), ptr(x.order), ptr(u["h0"]), ptr(u["h"]), ptr(u["v"]), ptr(u["swap"]),
        ptr(betas), ptr(p.W), ptr(p.b), ptr(p.c), ptr(v.W), ptr(v.b), ptr(v.c), ptr(p.z),
        ptr(v.z), ptr(x.chain), ptr(errs), ptr(scratch), ptr(trace),
        V, H, B, M, x.nb, x.n_epochs, cfg.k, start_epoch, cfg.momentum_switch_epoch, x.flags,
        cfg.lr, cfg.lr if cfg.lr_variance is None else cfg.lr_variance, *schedule_args(cfg),
        x.seed, x.device_index, grid, x.stream)
    if rc != 0:
        raise RuntimeError(f"cd_train kernel launch failed: cudaError {rc} "
                           f"({lib.cd_train_error_string(rc).decode()})")
    cd_train_launches += 1
    return p, v, x.chain, errs

"""A whole E-epoch CD-k/PCD training run of one RBM: CUDA kernel and plain version.

Port of the single-device const-block mode of
``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel``, with its estimator
modes: parallel tempering, the enhanced gradient, learned variance and the
pseudo-likelihood monitor. ``cd_train_run`` wraps the hand-written kernel
``csrc/cd_train.cu`` (one cooperative launch per run); ``cd_train_run_plain``
is the same function in plain PyTorch, built from ``core.rbm_math``'s
``cd_step_stats`` / ``pt_step_stats`` and ``apply_update``. Both take

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

from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import (RBMParams, apply_update, hidden_mean, pseudo_likelihood,
                             pt_betas, pt_hidden_mean, pt_log_accept, pt_visible_mean,
                             pt_visible_sample, _pt_swap_round, visible_mean)
from ..core.state import chain_rows
from .cd_step import draw_pt_uniforms, draw_uniforms, step_stats

# Launches of the CUDA kernel in this process (incremented only where the
# kernel is launched).
cd_train_launches = 0

_F_GAUSSIAN, _F_SAMPLE_V, _F_PERSISTENT, _F_BF16 = 1, 2, 4, 8
_F_XENT, _F_INJECT, _F_CLIP, _F_SPARSITY, _F_MOM_SCHEDULE = 16, 32, 64, 128, 256
_F_TEMPERING, _F_ENHANCED, _F_LEARN_VAR, _F_PSEUDO = 512, 1024, 2048, 4096


def kernel_unsupported(cfg: RBMConfig) -> Optional[str]:
    """Why the CUDA kernel does not take ``cfg`` (None when it does)."""
    if cfg.param_dtype != "float32":
        return ("param_dtype='bfloat16' storage is not in the CUDA kernel yet: "
                "ROADMAP.md Queue 2, K2 (bf16 storage)")
    if cfg.k > 255:
        return "k > 255 does not fit the kernel's Philox counter layout"
    return None


def check_kernel_supports(cfg: RBMConfig) -> None:
    reason = kernel_unsupported(cfg)
    if reason is not None:
        raise ValueError(reason)


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


def harden_uniform_blocks(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                          chain: torch.Tensor, data: torch.Tensor,
                          uniforms: Dict[str, torch.Tensor], n_epochs: int,
                          eps: float = 1e-4, start_epoch: int = 0, swap_eps: float = 1e-5
                          ) -> Dict[str, torch.Tensor]:
    """Move every Bernoulli draw that lies within ``eps`` of its threshold
    away from it, keeping each ``u < p`` outcome, so the run's trajectory is
    unchanged but no draw sits on a knife edge where the kernel's and the
    plain version's fp32 probabilities (which differ in summation order)
    could sample differently. Replays the run in order with the plain math.
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
                              else (u["h0"] < hm).float(), u, nudge)
            grads, new_chain, _ = step_stats(cfg, params, v0, chain, u)
            if cfg.persistent:
                chain = new_chain
            params, velocity = apply_update(params, velocity, grads, cfg,
                                            epoch=start_epoch + e)
    return hard


def _harden_chain(cfg: RBMConfig, params: RBMParams, h: torch.Tensor,
                  u: Dict[str, torch.Tensor], nudge: Callable) -> None:
    for t in range(cfg.k):
        vmean = visible_mean(params, h, cfg)
        if cfg.resolved_sample_visible and cfg.visible == "bernoulli":
            nudge(u["v"][t], vmean)
            vs = (u["v"][t] < vmean).float()
        elif cfg.resolved_sample_visible:
            noise = u["noise"][t]
            vs = vmean + (noise if params.z is None else noise * torch.exp(0.5 * params.z))
        else:
            vs = vmean
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


def cd_train_run_plain(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                       chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                       start_epoch: int = 0,
                       uniforms: Optional[Dict[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None,
                       ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the run (see module doc). It also serves
    the config the kernel does not take: bf16 storage."""
    B, V = cfg.batch_size, cfg.n_visible
    nb = data.shape[0] // B
    batches = data[: nb * B].reshape(nb, B, V)
    dgen = (None if uniforms is not None else
            torch.Generator(device=data.device).manual_seed(_draw_seed(generator)))
    draw = draw_pt_uniforms if cfg.pt_temps > 1 else draw_uniforms
    errs = []
    for e, row in enumerate(order.tolist()):
        epoch = start_epoch + e
        epoch_errs = []
        for i, j in enumerate(row):
            v0 = batches[j]
            u = (_step_uniforms(cfg, uniforms, e, i) if uniforms is not None
                 else draw(cfg, B, dgen, data.device))
            grads, new_chain, err = step_stats(cfg, params, v0, chain, u)
            if cfg.error_metric == "pseudo":
                err = pseudo_likelihood(params, v0, (epoch * nb + i) % V, cfg)
            params, velocity = apply_update(params, velocity, grads, cfg, epoch=epoch)
            if cfg.persistent:
                chain = new_chain.to(chain.dtype)
            epoch_errs.append(err)
        errs.append(torch.stack(epoch_errs).mean())
    return params, velocity, chain, torch.stack(errs)


def _f32_cuda(t: torch.Tensor, name: str, shape, device: torch.device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
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


def cd_train_run(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                 chain: torch.Tensor, data: torch.Tensor, order: torch.Tensor,
                 start_epoch: int = 0,
                 uniforms: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None, grid: int = 0,
                 trace: Optional[torch.Tensor] = None,
                 ) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """The run on the CUDA kernel (see module doc); one launch on the current
    stream. CPU tensors take ``cd_train_run_plain``. ``grid`` is the
    cooperative grid (0: one block per SM); the result does not depend on it,
    which the tests check by launching several grids.
    ``trace``, an int64 CUDA tensor [E, nb, trace_len(cfg)], receives the
    device clock (ns) at the start of each phase of each update (see
    ``trace_len``) as block 0 sees it.
    Raises ValueError for a config or input the kernel does not take and
    RuntimeError when the launch fails."""
    global cd_train_launches
    if data.device.type == "cpu":
        return cd_train_run_plain(cfg, params, velocity, chain, data, order,
                                  start_epoch, uniforms, generator)
    if data.device.type != "cuda":
        raise ValueError(f"cd_train_run takes CPU or CUDA tensors, got {data.device}")
    check_kernel_supports(cfg)
    device = data.device
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
    data = _f32_cuda(data[: nb * B], "data", (nb * B, V), device)
    W = _f32_cuda(params.W, "W", (V, H), device).clone()
    b = _f32_cuda(params.b, "b", (V,), device).clone()
    c = _f32_cuda(params.c, "c", (H,), device).clone()
    vW = _f32_cuda(velocity.W, "vW", (V, H), device).clone()
    vb = _f32_cuda(velocity.b, "vb", (V,), device).clone()
    vc = _f32_cuda(velocity.c, "vc", (H,), device).clone()
    z = vz = betas = None
    if cfg.learn_variance:
        if params.z is None or velocity.z is None:
            raise ValueError("learn_variance=True needs z in params and velocity")
        z = _f32_cuda(params.z, "z", (V,), device).clone()
        vz = _f32_cuda(velocity.z, "vz", (V,), device).clone()
    chain = _f32_cuda(chain, "chain", (CR, H), device).clone()
    order_d = order.to(device=device, dtype=torch.int32).contiguous()
    n_stamps = trace_len(cfg)
    if trace is not None and (trace.device != device or trace.dtype != torch.int64
                              or tuple(trace.shape) != (n_epochs, nb, n_stamps)
                              or not trace.is_contiguous()):
        raise ValueError(f"trace must be a contiguous int64 tensor [{n_epochs}, {nb}, "
                         f"{n_stamps}] on {device}")
    if M > 1:
        betas = pt_betas(cfg, device)

    flags = kernel_flags(cfg)
    u_h0 = u_h = u_v = u_swap = None
    seed = 0
    if uniforms is not None:
        flags |= _F_INJECT
        u_h0 = _f32_cuda(uniforms["h0"], "uniforms['h0']", (n_epochs, nb, B, H), device)
        u_h = _f32_cuda(uniforms["h"], "uniforms['h']", (n_epochs, nb, k, CR, H), device)
        if cfg.resolved_sample_visible:
            kv = "v" if cfg.visible == "bernoulli" else "noise"
            u_v = _f32_cuda(uniforms[kv], f"uniforms['{kv}']", (n_epochs, nb, k, CR, V), device)
        if M > 1:
            u_swap = _f32_cuda(uniforms["swap"], "uniforms['swap']",
                               (n_epochs, nb, 2, (M - 1) * B), device)
    else:
        seed = _draw_seed(generator)

    from .._build import load_library  # builds the kernel at first use

    lib = load_library().lib
    errs = torch.empty(n_epochs, dtype=torch.float32, device=device)
    scratch = torch.empty(int(lib.cd_train_scratch_floats(V, H, B, M, flags)),
                          dtype=torch.float32, device=device)

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    rc = lib.cd_train_run(
        ptr(data), ptr(order_d), ptr(u_h0), ptr(u_h), ptr(u_v), ptr(u_swap), ptr(betas),
        ptr(W), ptr(b), ptr(c), ptr(vW), ptr(vb), ptr(vc), ptr(z), ptr(vz), ptr(chain),
        ptr(errs), ptr(scratch), ptr(trace),
        V, H, B, M, nb, n_epochs, k, start_epoch, cfg.momentum_switch_epoch, flags,
        cfg.lr, cfg.lr if cfg.lr_variance is None else cfg.lr_variance, cfg.momentum,
        cfg.initial_momentum if cfg.initial_momentum is not None else 0.0,
        cfg.l2, cfg.grad_clip if cfg.grad_clip is not None else 0.0,
        cfg.sparsity_target if cfg.sparsity_target is not None else 0.0,
        cfg.sparsity_cost, seed, device.index if device.index is not None
        else torch.cuda.current_device(), grid,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cd_train kernel launch failed: cudaError {rc} "
                           f"({lib.cd_train_error_string(rc).decode()})")
    cd_train_launches += 1
    return RBMParams(W=W, b=b, c=c, z=z), RBMParams(W=vW, b=vb, c=vc, z=vz), chain, errs

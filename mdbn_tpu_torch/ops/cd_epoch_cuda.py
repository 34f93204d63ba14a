"""A whole E-epoch CD-k/PCD training run of one RBM: CUDA kernel and plain version.

Port of the single-device const-block mode of
``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel``. ``cd_train_run``
wraps the hand-written kernel ``csrc/cd_train.cu`` (one cooperative launch
per run); ``cd_train_run_plain`` is the same function in plain PyTorch,
built from ``core.rbm_math.cd_step_stats`` and ``apply_update``. Both take

- ``params`` / ``velocity`` (``RBMParams``) and the PCD ``chain`` [B, H];
- ``data`` [n, V]: minibatch ``j`` is rows ``[j*B, (j+1)*B)``;
- ``order`` [E, nb] int: the minibatch each update trains on
  (``batch_order``);
- ``uniforms`` (optional): the inject layout of ``draw_uniform_blocks`` —
  h0 [E, nb, B, H], h [E, nb, k, B, H], and v (Bernoulli) or noise
  (Gaussian) [E, nb, k, B, V] when visibles are sampled — indexed by the
  update's position (e, i), not by the minibatch it trains on;
- ``generator``: the source of the run's randomness when ``uniforms`` is None,

and return ``(params, velocity, chain, errs[E])`` as new tensors. The chain
changes only in PCD mode, as in the TPU kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import (RBMParams, apply_update, cd_step_stats, hidden_mean,
                             pseudo_likelihood, visible_mean)
from .cd_step import draw_uniforms

# Launches of the CUDA kernel in this process (incremented only where the
# kernel is launched).
cd_train_launches = 0

_F_GAUSSIAN, _F_SAMPLE_V, _F_PERSISTENT, _F_BF16 = 1, 2, 4, 8
_F_XENT, _F_INJECT, _F_CLIP, _F_SPARSITY, _F_MOM_SCHEDULE = 16, 32, 64, 128, 256


def kernel_unsupported(cfg: RBMConfig) -> Optional[str]:
    """Why the CUDA kernel does not take ``cfg`` (None when it does)."""
    variants = "ROADMAP.md Queue 2, K3 (estimator variants of the train kernel)"
    if cfg.pt_temps > 1:
        return f"pt_temps > 1 (parallel tempering) is not ported yet: {variants}"
    if cfg.gradient == "enhanced":
        return f"gradient='enhanced' is not in the CUDA kernel yet: {variants}"
    if cfg.learn_variance:
        return f"learn_variance=True is not in the CUDA kernel yet: {variants}"
    if cfg.error_metric == "pseudo":
        return f"error_metric='pseudo' is not in the CUDA kernel yet: {variants}"
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
    B, V, H, k = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k
    device = generator.device if device is None else device
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    u = {"h0": torch.rand((n_epochs, nb, B, H), **kw),
         "h": torch.rand((n_epochs, nb, k, B, H), **kw)}
    if cfg.resolved_sample_visible:
        if cfg.visible == "bernoulli":
            u["v"] = torch.rand((n_epochs, nb, k, B, V), **kw)
        else:
            u["noise"] = torch.randn((n_epochs, nb, k, B, V), **kw)
    return u


def _update_uniforms(uniforms: Dict[str, torch.Tensor], e: int, i: int):
    return {name: u[e, i] for name, u in uniforms.items()}


def harden_uniform_blocks(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                          chain: torch.Tensor, data: torch.Tensor,
                          uniforms: Dict[str, torch.Tensor], n_epochs: int,
                          eps: float = 1e-4, start_epoch: int = 0
                          ) -> Dict[str, torch.Tensor]:
    """Move every Bernoulli draw that lies within ``eps`` of its threshold
    away from it, keeping each ``u < p`` outcome, so the run's trajectory is
    unchanged but no draw sits on a knife edge where the kernel's and the
    plain version's fp32 probabilities (which differ in summation order)
    could sample differently. Replays the run in order with the plain math.
    Port of ``mdbn_tpu/ops/cd_epoch_pallas.py::harden_uniform_blocks``."""
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

    sample_v = cfg.resolved_sample_visible and cfg.visible == "bernoulli"
    for e in range(n_epochs):
        for i in range(nb):
            v0 = batches[i]
            hm = hidden_mean(params, v0, cfg)
            nudge(hard["h0"][e, i], hm)
            h = chain if cfg.persistent else (hard["h0"][e, i] < hm).float()
            for t in range(cfg.k):
                vmean = visible_mean(params, h, cfg)
                if sample_v:
                    nudge(hard["v"][e, i, t], vmean)
                    vs = (hard["v"][e, i, t] < vmean).float()
                elif cfg.resolved_sample_visible:
                    vs = vmean + hard["noise"][e, i, t]
                else:
                    vs = vmean
                hm = hidden_mean(params, vs, cfg)
                nudge(hard["h"][e, i, t], hm)
                h = (hard["h"][e, i, t] < hm).float()
            grads, new_chain, _ = cd_step_stats(
                params, v0, chain if cfg.persistent else None,
                _update_uniforms(hard, e, i), cfg)
            if cfg.persistent:
                chain = new_chain
            params, velocity = apply_update(params, velocity, grads, cfg,
                                            epoch=start_epoch + e)
    return hard


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
    the configs the kernel does not take: enhanced gradient, learned variance,
    the pseudo-likelihood monitor and bf16 storage."""
    B, V = cfg.batch_size, cfg.n_visible
    nb = data.shape[0] // B
    batches = data[: nb * B].reshape(nb, B, V)
    dgen = (None if uniforms is not None else
            torch.Generator(device=data.device).manual_seed(_draw_seed(generator)))
    errs = []
    for e, row in enumerate(order.tolist()):
        epoch = start_epoch + e
        epoch_errs = []
        for i, j in enumerate(row):
            v0 = batches[j]
            u = (_update_uniforms(uniforms, e, i) if uniforms is not None
                 else draw_uniforms(cfg, B, dgen, data.device))
            grads, new_chain, err = cd_step_stats(
                params, v0, chain if cfg.persistent else None, u, cfg)
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
    ``trace``, an int64 CUDA tensor [E, nb, 3 + 2k], receives the device
    clock (ns) at the start of each phase of each update — the hidden phase
    from the data, then per Gibbs step the visible and the hidden phase, then
    the update phase, then its end — as block 0 sees it.
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
    B, V, H, k = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k
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
    chain = _f32_cuda(chain, "chain", (B, H), device).clone()
    order_d = order.to(device=device, dtype=torch.int32).contiguous()
    if trace is not None and (trace.device != device or trace.dtype != torch.int64
                              or tuple(trace.shape) != (n_epochs, nb, 3 + 2 * k)
                              or not trace.is_contiguous()):
        raise ValueError(f"trace must be a contiguous int64 tensor [{n_epochs}, {nb}, "
                         f"{3 + 2 * k}] on {device}")

    flags = ((_F_GAUSSIAN if cfg.visible == "gaussian" else 0)
             | (_F_SAMPLE_V if cfg.resolved_sample_visible else 0)
             | (_F_PERSISTENT if cfg.persistent else 0)
             | (_F_BF16 if cfg.compute_dtype == "bfloat16" else 0)
             | (_F_XENT if cfg.error_metric == "xent" else 0)
             | (_F_CLIP if cfg.grad_clip is not None else 0)
             | (_F_SPARSITY if cfg.sparsity_target is not None and cfg.sparsity_cost else 0)
             | (_F_MOM_SCHEDULE if cfg.initial_momentum is not None else 0))
    u_h0 = u_h = u_v = None
    seed = 0
    if uniforms is not None:
        flags |= _F_INJECT
        u_h0 = _f32_cuda(uniforms["h0"], "uniforms['h0']", (n_epochs, nb, B, H), device)
        u_h = _f32_cuda(uniforms["h"], "uniforms['h']", (n_epochs, nb, k, B, H), device)
        if cfg.resolved_sample_visible:
            kv = "v" if cfg.visible == "bernoulli" else "noise"
            u_v = _f32_cuda(uniforms[kv], f"uniforms['{kv}']", (n_epochs, nb, k, B, V), device)
    else:
        seed = _draw_seed(generator)

    from .._build import load_library  # builds the kernel at first use

    lib = load_library().lib
    errs = torch.empty(n_epochs, dtype=torch.float32, device=device)
    scratch = torch.empty(int(lib.cd_train_scratch_floats(V, H, B)),
                          dtype=torch.float32, device=device)

    def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
        return None if t is None else t.data_ptr()

    rc = lib.cd_train_run(
        ptr(data), ptr(order_d), ptr(u_h0), ptr(u_h), ptr(u_v),
        ptr(W), ptr(b), ptr(c), ptr(vW), ptr(vb), ptr(vc), ptr(chain),
        ptr(errs), ptr(scratch), ptr(trace),
        V, H, B, nb, n_epochs, k, start_epoch, cfg.momentum_switch_epoch, flags,
        cfg.lr, cfg.momentum,
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
    return RBMParams(W=W, b=b, c=c), RBMParams(W=vW, b=vb, c=vc), chain, errs

"""One CD-k / PCD step's statistics, with no update: CUDA kernel and plain version.

Port of ``mdbn_tpu/ops/cd_epoch_pallas.py::make_pallas_grads_fn`` and the
kernel it builds, ``_cd_grads_kernel``: the per-shard step of the
data-parallel path (``parallel.dp``), which all-reduces the statistics
outside the kernel and then applies the update. ``cd_grads_step`` wraps the
hand-written kernel ``csrc/cd_grads.cu`` (one cooperative launch per step);
``cd_grads_step_plain`` is the same function in plain PyTorch, the core's
masked ``cd_step_stats``. Both take

- ``cfg``: the shard's config (``batch_size`` = the rows of ``v0``);
- ``params`` (``RBMParams``, float32), ``v0`` [B, V] and the PCD ``chain``
  [B, H], all float32;
- ``seed``: the step's sampling seed when ``uniforms`` is None (the kernel
  keys Philox with it, the plain version a ``torch.Generator``, so the two
  draw different numbers from one seed);
- ``uniforms``: the step's draws in the ``ops.cd_step.draw_uniforms`` layout
  (h0 [B, H], h [k, B, H], v or noise [k, B, V] when visibles are sampled);
- ``mask`` ([B, 1] of 0/1) and ``norm``: pad rows enter no statistic and sums
  divide by ``norm`` instead of B,

and return ``(RBMParams grads, new_chain, err)``. The chain changes only in
PCD mode, as in the TPU kernel. With ``out`` (a float32 buffer of
``flat_size`` elements) the statistics are written into it, in the layout the
data-parallel path all-reduces, and the returned tensors are views of it.

The update after that all-reduce is the file's second kernel:
``cd_update`` wraps ``csrc/cd_grads.cu``'s ``cd_update_kernel``, and
``cd_update_plain`` is the same function on the core's ``apply_update``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, apply_update, cd_step_stats, resolve_momentum
from .cd_epoch_cuda import _F_CLIP, _F_INJECT, _on_device, kernel_flags, ptr
from .cd_step import draw_uniforms

# Launches of each CUDA kernel in this process (incremented only where the
# kernel is launched).
cd_grads_launches = 0
cd_update_launches = 0

_F_MASK = 8192  # a row mask is given (csrc/cd_grads.cu's kMasked)


def grads_unsupported(cfg: RBMConfig) -> Optional[str]:
    """Why the per-step kernel does not take ``cfg`` (None when it does): it
    returns plain CD/PCD statistics of fixed-variance f32 state for an
    all-reduce outside the kernel, as the TPU kernel does."""
    if cfg.gradient == "enhanced":
        return ("gradient='enhanced' is not computed by the per-step grads kernel: the "
                "recombination is nonlinear in the batch means, so the mean of per-shard "
                "enhanced gradients is not the global-batch one")
    if cfg.pt_temps > 1:
        return "pt_temps > 1 is not computed by the per-step grads kernel (no tempering ladder)"
    if cfg.learn_variance:
        return ("learn_variance=True is not computed by the per-step grads kernel "
                "(fixed-variance state)")
    if cfg.param_dtype != "float32":
        return "the per-step grads kernel takes param_dtype='float32' only (its state is f32)"
    if cfg.error_metric not in ("mse", "xent"):
        return f"the per-step grads kernel monitors mse or xent, not {cfg.error_metric!r}"
    if cfg.k > 255:
        return "k > 255 does not fit the kernel's Philox counter layout"
    return None


def check_grads_supports(cfg: RBMConfig) -> None:
    reason = grads_unsupported(cfg)
    if reason is not None:
        raise ValueError(reason)


def flat_size(cfg: RBMConfig) -> int:
    """Elements of the flat statistics buffer: gW, gb, gc (gz under learned
    variance), err."""
    V, H = cfg.n_visible, cfg.n_hidden
    return V * H + V + H + (V if cfg.learn_variance else 0) + 1


def flat_views(cfg: RBMConfig, flat: torch.Tensor) -> Tuple[RBMParams, torch.Tensor]:
    """(grads, err) as views of a flat buffer of ``flat_size(cfg)`` elements."""
    V, H = cfg.n_visible, cfg.n_hidden
    nW = V * H
    z = flat[nW + V + H:nW + 2 * V + H] if cfg.learn_variance else None
    return (RBMParams(W=flat[:nW].view(V, H), b=flat[nW:nW + V], c=flat[nW + V:nW + V + H], z=z),
            flat[-1])


def pack(grads: RBMParams, err: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Writes (grads, err) into the flat buffer ``out``; returns it."""
    parts = [t.reshape(-1) for t in (grads.W, grads.b, grads.c, grads.z) if t is not None]
    return torch.cat(parts + [err.reshape(1)], out=out)


def cd_grads_step_plain(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor,
                        chain: torch.Tensor, *, seed: Optional[int] = None,
                        uniforms: Optional[Dict[str, torch.Tensor]] = None,
                        mask: Optional[torch.Tensor] = None, norm: Optional[float] = None,
                        out: Optional[torch.Tensor] = None,
                        ) -> Tuple[RBMParams, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the step (see module doc)."""
    check_grads_supports(cfg)
    if uniforms is None:
        if seed is None:
            raise ValueError("a step without injected uniforms needs a seed")
        gen = torch.Generator(device=v0.device).manual_seed(seed)
        uniforms = draw_uniforms(cfg, v0.shape[0], gen)
    grads, h, err = cd_step_stats(params, v0, chain if cfg.persistent else None, uniforms,
                                  cfg, row_mask=mask, norm=norm)
    new_chain = h if cfg.persistent else chain
    if out is not None:
        grads, err = flat_views(cfg, pack(grads, err, out))
    return grads, new_chain, err


def cd_grads_step(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor, chain: torch.Tensor,
                  *, seed: Optional[int] = None,
                  uniforms: Optional[Dict[str, torch.Tensor]] = None,
                  mask: Optional[torch.Tensor] = None, norm: Optional[float] = None,
                  out: Optional[torch.Tensor] = None, grid: int = 0,
                  ) -> Tuple[RBMParams, torch.Tensor, torch.Tensor]:
    """The step on the CUDA kernel (see module doc); one launch on the current
    stream. CPU tensors take ``cd_grads_step_plain``. ``grid`` is the
    cooperative grid (0: one block per SM); the result does not depend on it.
    Raises ValueError for a config or input the kernel does not take and
    RuntimeError when the launch fails."""
    global cd_grads_launches
    if v0.device.type == "cpu":
        return cd_grads_step_plain(cfg, params, v0, chain, seed=seed, uniforms=uniforms,
                                   mask=mask, norm=norm, out=out)
    if v0.device.type != "cuda":
        raise ValueError(f"cd_grads_step takes CPU or CUDA tensors, got {v0.device}")
    check_grads_supports(cfg)
    device, f32 = v0.device, torch.float32
    B, V, H, k = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k
    v0 = _on_device(v0, "v0", (B, V), device, f32)
    W = _on_device(params.W, "W", (V, H), device, f32)
    b = _on_device(params.b, "b", (V,), device, f32)
    c = _on_device(params.c, "c", (H,), device, f32)
    chain = _on_device(chain, "chain", (B, H), device, f32)
    flags = kernel_flags(cfg)
    u_h0 = u_h = u_v = None
    if uniforms is not None:
        flags |= _F_INJECT
        u_h0 = _on_device(uniforms["h0"], "uniforms['h0']", (B, H), device, f32)
        u_h = _on_device(uniforms["h"], "uniforms['h']", (k, B, H), device, f32)
        if cfg.resolved_sample_visible:
            kv = "v" if cfg.visible == "bernoulli" else "noise"
            u_v = _on_device(uniforms[kv], f"uniforms['{kv}']", (k, B, V), device, f32)
    elif seed is None:
        raise ValueError("a step without injected uniforms needs a seed")
    if mask is not None:
        flags |= _F_MASK
        mask = _on_device(mask, "mask", (B, 1), device, f32)

    from .._build import load_library  # builds the kernels at first use

    lib = load_library("cd_grads", "float32").lib
    if out is None:
        out = torch.empty(flat_size(cfg), dtype=f32, device=device)
    elif not out.is_contiguous():
        raise ValueError("out must be contiguous")
    grads, err = flat_views(cfg, _on_device(out, "out", (flat_size(cfg),), device, f32))
    new_chain = torch.empty((B, H), dtype=f32, device=device)
    scratch = torch.empty(int(lib.cd_grads_scratch_floats(V, H, B)), dtype=f32, device=device)
    rc = lib.cd_grads_step(
        ptr(v0), ptr(mask), ptr(u_h0), ptr(u_h), ptr(u_v), ptr(W), ptr(b), ptr(c), ptr(chain),
        ptr(grads.W), ptr(grads.b), ptr(grads.c), ptr(new_chain), ptr(err), ptr(scratch), V, H,
        B, k, flags,
        1.0 / float(norm if norm is not None else B),
        cfg.sparsity_target if cfg.sparsity_target is not None else 0.0, cfg.sparsity_cost,
        (seed or 0) % 2 ** 64,
        device.index if device.index is not None else torch.cuda.current_device(), grid,
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cd_grads kernel launch failed: cudaError {rc} "
                           f"({lib.cd_grads_error_string(rc).decode()})")
    cd_grads_launches += 1
    return grads, new_chain, err


def cd_update_plain(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                    sums: torch.Tensor, scale: float, epoch: int,
                    ) -> Tuple[RBMParams, RBMParams, torch.Tensor]:
    """The plain version of the update after the all-reduce: the statistics
    are ``sums * scale`` (``scale`` = 1 / ranks; ``sums`` in the
    ``flat_views`` layout), then the core's ``apply_update`` at ``epoch``'s
    momentum. Returns new (params, velocity, err)."""
    grads, err = flat_views(cfg, sums * scale)
    params, velocity = apply_update(params, velocity, grads, cfg, epoch=epoch)
    return params, velocity, err


def cd_update(cfg: RBMConfig, params: RBMParams, velocity: RBMParams, sums: torch.Tensor,
              scale: float, epoch: int) -> Tuple[RBMParams, RBMParams, torch.Tensor]:
    """The update on the CUDA kernel, one launch on the current stream: W, b,
    c and their velocities change IN PLACE (the data-parallel path holds its
    own copies) and are returned with the step's error. The same bits as
    ``cd_update_plain``, which CPU tensors take. Raises ValueError for a
    config or input the kernel does not take and RuntimeError when the launch
    fails."""
    global cd_update_launches
    if sums.device.type == "cpu":
        return cd_update_plain(cfg, params, velocity, sums, scale, epoch)
    if sums.device.type != "cuda":
        raise ValueError(f"cd_update takes CPU or CUDA tensors, got {sums.device}")
    check_grads_supports(cfg)
    device, f32 = sums.device, torch.float32
    V, H = cfg.n_visible, cfg.n_hidden
    state = []
    for part, p in (("params", params), ("velocity", velocity)):
        for name, shape in (("W", (V, H)), ("b", (V,)), ("c", (H,))):
            t = getattr(p, name)
            if not t.is_contiguous():
                raise ValueError(f"{part}.{name} must be contiguous (updated in place)")
            state.append(_on_device(t, f"{part}.{name}", shape, device, f32))
    sums = _on_device(sums, "sums", (flat_size(cfg),), device, f32)

    from .._build import load_library  # builds the kernels at first use

    lib = load_library("cd_grads", "float32").lib
    err = torch.empty(1, dtype=f32, device=device)
    rc = lib.cd_update_step(
        ptr(sums), *[ptr(t) for t in state], ptr(err), V, H, kernel_flags(cfg) & _F_CLIP,
        scale, cfg.lr, resolve_momentum(cfg, epoch), cfg.l2,
        cfg.grad_clip if cfg.grad_clip is not None else 0.0,
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cd_update kernel launch failed: cudaError {rc} "
                           f"({lib.cd_grads_error_string(rc).decode()})")
    cd_update_launches += 1
    return params, velocity, err[0]

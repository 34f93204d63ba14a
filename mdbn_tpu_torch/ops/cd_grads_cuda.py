"""One CD-k / PCD step's statistics, with no update: CUDA kernel and plain version.

Port of ``mdbn_tpu/ops/cd_epoch_pallas.py::make_pallas_grads_fn`` and the
kernel it builds, ``_cd_grads_kernel``, and of the step of the TPU's DP
mega-kernel in every estimator mode (parallel tempering, learned variance,
the enhanced gradient, the pseudo-likelihood monitor) and at both storage
dtypes: the per-shard step of the data-parallel path (``parallel.dp``),
which all-reduces the statistics outside the kernel and then applies the
update. ``cd_grads_step`` wraps the hand-written kernel ``csrc/cd_grads.cu``
(one cooperative launch per step; a run whose tiles fit thread-block
clusters takes ``ops.cd_grads_resident_cuda.cd_grads_resident_step``, the
resident kernel's step variant, instead: ``ops.cd_epoch_cuda.select_dp_kernel``);
``cd_grads_step_plain`` is the same
function in plain PyTorch, the core's masked ``cd_step_stats`` /
``pt_step_stats`` in their ``split`` form. Both take

- ``cfg``: the shard's config (``batch_size`` = the rows of ``v0``);
- ``params`` (``RBMParams``, with ``z`` under learned variance), ``v0`` [B, V]
  and the chain [B, H] (tempering: [M*B, H], rung-major), all at the config's
  ``param_dtype``;
- ``seed``: the step's sampling seed when ``uniforms`` is None (the kernel
  keys Philox with it, the plain version a ``torch.Generator``, so the two
  draw different numbers from one seed);
- ``uniforms``: the step's draws in the ``ops.cd_step.draw_uniforms`` layout
  (``draw_pt_uniforms`` under tempering);
- ``mask`` ([B, 1] of 0/1) and ``norm``: pad rows enter no statistic and sums
  divide by ``norm`` instead of B;
- ``pseudo_bit``: the visible unit the pseudo-likelihood monitor flips
  (required under ``error_metric="pseudo"``),

and return ``(RBMParams grads, new_chain, err)``. The chain changes only in
PCD mode, as in the TPU kernel. The statistics are those a data-parallel
exchange can sum (``core.rbm_math.split_grads``): under learned variance
``grads.z`` is the raw z statistic, and under the enhanced gradient the
grads are the plain ones and the sums behind mu, lambda and the data-phase h
mean lie in the flat buffer. With ``out`` (a float32 buffer of
``flat_size`` elements) the statistics are written into it, in the layout the
data-parallel path all-reduces (``flat_views``), and the returned tensors
are views of it.

The update after that all-reduce is the file's second kernel:
``cd_update`` wraps ``csrc/cd_grads.cu``'s ``cd_update_kernel`` (after
``cd_enhance_kernel`` under the enhanced gradient), and ``cd_update_plain``
is the same function on the core's ``finish_grads`` and ``apply_update``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import (EnhancedSums, RBMParams, apply_update, cd_step_stats,
                             finish_grads, pseudo_likelihood, pt_betas, pt_step_stats,
                             resolve_momentum, torch_dtype)
from .cd_epoch_cuda import _F_INJECT, _on_device, kernel_flags, ptr
from .cd_step import draw_pt_uniforms, draw_uniforms

# Launches of each CUDA kernel in this process (incremented only where the
# kernel is launched; an update under the enhanced gradient launches its
# matvec pass and the update, and counts once).
cd_grads_launches = 0
cd_update_launches = 0

_F_MASK = 8192  # a row mask is given (csrc/cd_grads.cu's kMasked)


def flat_size(cfg: RBMConfig) -> int:
    """Elements of the flat statistics buffer: gW, gb, gc, then gz under
    learned variance or mu [V], lam [H], h0 [H] under the enhanced gradient,
    then err."""
    V, H = cfg.n_visible, cfg.n_hidden
    extra = V if cfg.learn_variance else V + 2 * H if cfg.gradient == "enhanced" else 0
    return V * H + V + H + extra + 1


def flat_views(cfg: RBMConfig, flat: torch.Tensor
               ) -> Tuple[RBMParams, Optional[EnhancedSums], torch.Tensor]:
    """(grads, enhanced sums or None, err) as views of a flat buffer of
    ``flat_size(cfg)`` elements."""
    V, H = cfg.n_visible, cfg.n_hidden
    x = V * H + V + H
    z = flat[x:x + V] if cfg.learn_variance else None
    sums = None
    if cfg.gradient == "enhanced":
        sums = EnhancedSums(mu=flat[x:x + V], lam=flat[x + V:x + V + H],
                            h0=flat[x + V + H:x + V + 2 * H])
    grads = RBMParams(W=flat[:V * H].view(V, H), b=flat[V * H:V * H + V],
                      c=flat[V * H + V:x], z=z)
    return grads, sums, flat[-1]


def pack(grads: RBMParams, sums: Optional[EnhancedSums], err: torch.Tensor,
         out: torch.Tensor) -> torch.Tensor:
    """Writes (grads, sums, err) into the flat buffer ``out``; returns it."""
    parts = [t for t in (grads.W, grads.b, grads.c, grads.z) if t is not None]
    if sums is not None:
        parts += [sums.mu, sums.lam, sums.h0]
    return torch.cat([t.reshape(-1).float() for t in parts] + [err.reshape(1).float()],
                     out=out)


def harden_step(cfg: RBMConfig, params: RBMParams, chain: torch.Tensor, v0: torch.Tensor,
                uniforms: Dict[str, torch.Tensor], wide: bool = False
                ) -> Dict[str, torch.Tensor]:
    """One step's draws (the ``draw_uniforms`` / ``draw_pt_uniforms`` layout)
    moved off their thresholds against the plain version's probabilities
    (``ops.cd_epoch_cuda.harden_uniform_blocks`` of a one-update run; with
    ``wide``, the W-blocked kernels' factor rounding), so a kernel and its
    plain version, whose fp32 sums run in other orders, draw the same
    samples; a test and measurement aid."""
    from ..core.rbm_math import zero_velocity
    from .cd_epoch_cuda import harden_uniform_blocks

    CR = chain.shape[0]
    block = {k: (x if k == "h0" else x.reshape(2, -1) if k == "swap"
                 else x.reshape(cfg.k, CR, -1))[None, None] for k, x in uniforms.items()}
    hard = harden_uniform_blocks(cfg, params, zero_velocity(params), chain, v0, block, 1,
                                 wide=wide)
    return {k: hard[k][0, 0].reshape(x.shape) for k, x in uniforms.items()}


def _check_pseudo(cfg: RBMConfig, pseudo_bit: Optional[int]) -> None:
    if cfg.error_metric == "pseudo" and pseudo_bit is None:
        raise ValueError("error_metric='pseudo' needs the step's pseudo_bit")


def cd_grads_step_plain(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor,
                        chain: torch.Tensor, *, seed: Optional[int] = None,
                        uniforms: Optional[Dict[str, torch.Tensor]] = None,
                        mask: Optional[torch.Tensor] = None, norm: Optional[float] = None,
                        out: Optional[torch.Tensor] = None, pseudo_bit: Optional[int] = None,
                        ) -> Tuple[RBMParams, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the step (see module doc). Data and
    chain widen to f32 as they are read, as in the kernel; the chain written
    back rounds into its storage dtype."""
    _check_pseudo(cfg, pseudo_bit)
    B, M = v0.shape[0], cfg.pt_temps
    if uniforms is None:
        if seed is None:
            raise ValueError("a step without injected uniforms needs a seed")
        gen = torch.Generator(device=v0.device).manual_seed(seed)
        uniforms = (draw_pt_uniforms if M > 1 else draw_uniforms)(cfg, B, gen)
    x, h = v0.float(), chain.float()
    if M > 1:
        grads, sums, h, err = pt_step_stats(params, x, h.reshape(M, B, -1), uniforms, cfg,
                                            row_mask=mask, norm=norm, split=True)
        h = h.reshape(M * B, -1)
    else:
        grads, sums, h, err = cd_step_stats(params, x, h if cfg.persistent else None,
                                            uniforms, cfg, row_mask=mask, norm=norm, split=True)
    if cfg.error_metric == "pseudo":
        err = pseudo_likelihood(params, x, pseudo_bit, cfg, row_mask=mask, norm=norm)
    new_chain = h.to(chain.dtype) if cfg.persistent else chain
    if out is not None:
        grads, _, err = flat_views(cfg, pack(grads, sums, err, out))
    return grads, new_chain, err


def _draw(uniforms: Dict[str, torch.Tensor], name: str, shape, device) -> torch.Tensor:
    """An injected draw as the kernel reads it, flattened to ``shape``."""
    u = uniforms[name]
    n = 1
    for d in shape:
        n *= d
    if u.numel() != n:
        raise ValueError(f"uniforms['{name}'] has shape {tuple(u.shape)}, expected {n} "
                         f"elements ({tuple(shape)})")
    return _on_device(u.reshape(shape), f"uniforms['{name}']", shape, device, torch.float32)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def step_inputs(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor, chain: torch.Tensor,
                uniforms: Optional[Dict[str, torch.Tensor]], mask: Optional[torch.Tensor],
                seed: Optional[int], tab: Optional[torch.Tensor]):
    """A step's CUDA inputs checked (device, dtype, shape) for the step
    kernels of both routes: (v0, W, b, c, z, chain, mask, draws {h0, h, v,
    swap}, flags, betas). With ``tab`` (a CUDA int64 tensor of 3: the
    minibatch, seed and pseudo bit the kernel reads at entry) ``v0`` holds
    the minibatches [n, B, V] it indexes. Raises ValueError for a config or
    input the kernels do not take."""
    device, f32, sdt = v0.device, torch.float32, torch_dtype(cfg.param_dtype)
    B, V, H, k, M = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k, cfg.pt_temps
    CR = B * M
    if tab is not None:
        tab = _on_device(tab, "tab", (3,), device, torch.int64)
        v0 = _on_device(v0, "v0", (v0.shape[0], B, V), device, sdt)
    else:
        v0 = _on_device(v0, "v0", (B, V), device, sdt)
    W = _on_device(params.W, "W", (V, H), device, sdt)
    b = _on_device(params.b, "b", (V,), device, sdt)
    c = _on_device(params.c, "c", (H,), device, sdt)
    z = None
    if cfg.learn_variance:
        if params.z is None:
            raise ValueError("learn_variance=True needs z in params")
        z = _on_device(params.z, "z", (V,), device, sdt)
    chain = _on_device(chain, "chain", (CR, H), device, sdt)
    flags = kernel_flags(cfg)
    u = dict.fromkeys(("h0", "h", "v", "swap"))
    if uniforms is not None:
        flags |= _F_INJECT
        u["h0"] = _draw(uniforms, "h0", (B, H), device)
        u["h"] = _draw(uniforms, "h", (k, CR, H), device)
        if cfg.resolved_sample_visible:
            u["v"] = _draw(uniforms, "v" if cfg.visible == "bernoulli" else "noise",
                           (k, CR, V), device)
        if M > 1:
            u["swap"] = _draw(uniforms, "swap", (2, (M - 1) * B), device)
    elif seed is None and tab is None:
        raise ValueError("a step without injected uniforms needs a seed")
    if mask is not None:
        flags |= _F_MASK
        mask = _on_device(mask, "mask", (B, 1), device, f32)
    betas = pt_betas(cfg, device) if M > 1 else None
    return v0, W, b, c, z, chain, mask, u, flags, betas, tab


def step_outputs(cfg: RBMConfig, device: torch.device, out: Optional[torch.Tensor],
                 chain_out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, chain_out): the flat buffer and the chain out, checked, or new."""
    sdt, CR, H = torch_dtype(cfg.param_dtype), cfg.batch_size * cfg.pt_temps, cfg.n_hidden
    if out is None:
        out = torch.empty(flat_size(cfg), dtype=torch.float32, device=device)
    elif not out.is_contiguous():
        raise ValueError("out must be contiguous")
    out = _on_device(out, "out", (flat_size(cfg),), device, torch.float32)
    if chain_out is None:
        chain_out = torch.empty((CR, H), dtype=sdt, device=device)
    elif not chain_out.is_contiguous():
        raise ValueError("chain_out must be contiguous")
    return out, _on_device(chain_out, "chain_out", (CR, H), device, sdt)


def prepare(cfg: RBMConfig, device: torch.device) -> None:
    """Asks ``device`` what the step and update kernels' launches need (the
    SM count, each step variant's co-resident blocks), ahead of them: a
    launch captured in a CUDA graph must ask nothing. Builds the kernels at
    first use."""
    from .._build import load_library

    lib = load_library("cd_grads", cfg.param_dtype).lib
    rc = lib.cd_grads_prepare(_device_index(device))
    if rc != 0:
        raise RuntimeError(f"cd_grads prepare: cudaError {rc} "
                           f"({lib.cd_grads_error_string(rc).decode()})")


def step_scratch(cfg: RBMConfig, device: torch.device) -> torch.Tensor:
    """A scratch buffer for the steps of ``cfg`` (``step_launcher``'s)."""
    from .._build import load_library

    lib = load_library("cd_grads", cfg.param_dtype).lib
    n = lib.cd_grads_scratch_floats(cfg.n_visible, cfg.n_hidden, cfg.batch_size, cfg.pt_temps,
                                    kernel_flags(cfg))
    return torch.empty(int(n), dtype=torch.float32, device=device)


def step_launcher(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor, chain: torch.Tensor,
                  *, seed: Optional[int] = None,
                  uniforms: Optional[Dict[str, torch.Tensor]] = None,
                  mask: Optional[torch.Tensor] = None, norm: Optional[float] = None,
                  out: Optional[torch.Tensor] = None, grid: int = 0,
                  pseudo_bit: Optional[int] = None, tab: Optional[torch.Tensor] = None,
                  chain_out: Optional[torch.Tensor] = None,
                  scratch: Optional[torch.Tensor] = None,
                  ) -> Tuple[Callable[[], None], RBMParams, torch.Tensor, torch.Tensor]:
    """Checks a step's CUDA inputs and allocates its outputs: returns
    (launch, grads, new_chain, err), where ``launch()`` launches the kernel
    once into those outputs on the current stream of this call, raises
    RuntimeError when the launch fails, and counts nothing (``cd_grads_step``
    counts; chip_smoke.py times ``launch`` alone). ``tab``: see
    ``step_inputs`` (a captured epoch's step; ``seed`` and ``pseudo_bit`` are
    then read from it). ``chain_out``: the buffer of the chain out (else a
    new one); ``scratch``: ``step_scratch``'s buffer, which steps launched
    one after the other on a stream may share (else a new one). Raises
    ValueError for a config or input the kernel does not take."""
    _check_pseudo(cfg, pseudo_bit if tab is None else 0)
    device, f32 = v0.device, torch.float32
    B, V, H, k, M = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k, cfg.pt_temps
    v0, W, b, c, z, chain, mask, u, flags, betas, tab = step_inputs(
        cfg, params, v0, chain, uniforms, mask, seed, tab)

    from .._build import load_library  # builds the kernels at first use

    lib = load_library("cd_grads", cfg.param_dtype).lib
    out, new_chain = step_outputs(cfg, device, out, chain_out)
    n = int(lib.cd_grads_scratch_floats(V, H, B, M, flags))
    if scratch is None:
        scratch = torch.empty(n, dtype=f32, device=device)
    scratch = _on_device(scratch, "scratch", (n,), device, f32)
    args = (ptr(v0), ptr(tab), ptr(mask), ptr(u["h0"]), ptr(u["h"]), ptr(u["v"]), ptr(u["swap"]),
            ptr(betas), ptr(W), ptr(b), ptr(c), ptr(z), ptr(chain), ptr(out), ptr(new_chain),
            ptr(scratch), V, H, B, M, k, flags, pseudo_bit if pseudo_bit is not None else -1,
            1.0 / float(norm if norm is not None else B),
            cfg.sparsity_target if cfg.sparsity_target is not None else 0.0,
            cfg.sparsity_cost, (seed or 0) % 2 ** 64, _device_index(device), grid,
            torch.cuda.current_stream(device).cuda_stream)
    keep = (v0, W, b, c, z, chain, mask, u, betas, tab, out, new_chain, scratch)

    def launch(keep=keep) -> None:  # keep: the buffers the pointers point into
        rc = lib.cd_grads_step(*args)
        if rc != 0:
            raise RuntimeError(f"cd_grads kernel launch failed: cudaError {rc} "
                               f"({lib.cd_grads_error_string(rc).decode()})")

    grads, _, err = flat_views(cfg, out)
    return launch, grads, new_chain, err


def cd_grads_step(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor, chain: torch.Tensor,
                  *, seed: Optional[int] = None,
                  uniforms: Optional[Dict[str, torch.Tensor]] = None,
                  mask: Optional[torch.Tensor] = None, norm: Optional[float] = None,
                  out: Optional[torch.Tensor] = None, grid: int = 0,
                  pseudo_bit: Optional[int] = None,
                  ) -> Tuple[RBMParams, torch.Tensor, torch.Tensor]:
    """The step on the CUDA kernel (see module doc); one launch on the current
    stream. CPU tensors take ``cd_grads_step_plain``. ``grid`` is the
    cooperative grid (0: one block per SM); the result does not depend on it.
    Raises ValueError for a config or input the kernel does not take and
    RuntimeError when the launch fails."""
    global cd_grads_launches
    if v0.device.type == "cpu":
        return cd_grads_step_plain(cfg, params, v0, chain, seed=seed, uniforms=uniforms,
                                   mask=mask, norm=norm, out=out, pseudo_bit=pseudo_bit)
    if v0.device.type != "cuda":
        raise ValueError(f"cd_grads_step takes CPU or CUDA tensors, got {v0.device}")
    launch, grads, new_chain, err = step_launcher(
        cfg, params, v0, chain, seed=seed, uniforms=uniforms, mask=mask, norm=norm, out=out,
        grid=grid, pseudo_bit=pseudo_bit)
    launch()
    cd_grads_launches += 1
    return grads, new_chain, err


def cd_update_plain(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                    sums: torch.Tensor, scale: float, epoch: int,
                    ) -> Tuple[RBMParams, RBMParams, torch.Tensor]:
    """The plain version of the update after the all-reduce: the statistics
    are ``sums * scale`` (``scale`` = 1 / ranks; ``sums`` in the
    ``flat_views`` layout), finished by the core's ``finish_grads``, then
    its ``apply_update`` at ``epoch``'s momentum. Returns new (params,
    velocity, err)."""
    grads, esums, err = flat_views(cfg, sums * scale)
    grads = finish_grads(params, grads, esums, cfg)
    params, velocity = apply_update(params, velocity, grads, cfg, epoch=epoch)
    return params, velocity, err


def enhance_shares(cfg: RBMConfig, device: torch.device) -> torch.Tensor:
    """The enhanced gradient's matvec shares of an update of ``cfg``
    (``cd_enhance_kernel``'s output, ``update_launcher``'s ``shares``)."""
    from .._build import load_library

    lib = load_library("cd_grads", cfg.param_dtype).lib
    n = lib.cd_enhance_scratch_floats(cfg.n_visible, cfg.n_hidden)
    return torch.empty(int(n), dtype=torch.float32, device=device)


def update_launcher(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                    sums: torch.Tensor, scale: float, epoch: int,
                    momentum: Optional[torch.Tensor] = None,
                    err: Optional[torch.Tensor] = None,
                    shares: Optional[torch.Tensor] = None,
                    ) -> Tuple[Callable[[], None], torch.Tensor]:
    """Checks an update's CUDA inputs: returns (launch, err), where
    ``launch()`` runs the update once on the current stream of this call (W,
    b, c, z and their velocities in place; under the enhanced gradient after
    its matvec pass), raises RuntimeError when a launch fails, and counts
    nothing. ``momentum``: a CUDA float32 tensor of 1 that the kernel reads
    in place of ``epoch``'s momentum (a captured epoch's); ``err``: a CUDA
    float32 tensor of 1 to write the step's error into (else a new one);
    ``shares``: the enhanced gradient's matvec shares (``enhance_shares``),
    which updates launched one after the other on a stream may share (else
    a new one). Raises ValueError for a config or input the kernel does not
    take."""
    device, f32, sdt = sums.device, torch.float32, torch_dtype(cfg.param_dtype)
    V, H = cfg.n_visible, cfg.n_hidden
    names = (("W", (V, H)), ("b", (V,)), ("c", (H,))) + ((("z", (V,)),) if cfg.learn_variance
                                                          else ())
    state = {}
    for part, p in (("params", params), ("velocity", velocity)):
        for name, shape in names:
            t = getattr(p, name)
            if t is None:
                raise ValueError(f"learn_variance=True needs {part}.z")
            if not t.is_contiguous():
                raise ValueError(f"{part}.{name} must be contiguous (updated in place)")
            state[part, name] = _on_device(t, f"{part}.{name}", shape, device, sdt)
    sums = _on_device(sums, "sums", (flat_size(cfg),), device, f32)

    from .._build import load_library  # builds the kernels at first use

    lib = load_library("cd_grads", cfg.param_dtype).lib
    err = (torch.empty(1, dtype=f32, device=device) if err is None
           else _on_device(err, "err", (1,), device, f32))
    if momentum is not None:
        momentum = _on_device(momentum, "momentum", (1,), device, f32)
    if cfg.gradient != "enhanced":
        shares = None
    elif shares is None:
        shares = enhance_shares(cfg, device)
    else:
        shares = _on_device(shares, "shares", (int(lib.cd_enhance_scratch_floats(V, H)),),
                            device, f32)
    args = (ptr(sums), *[ptr(state.get((part, n))) for part in ("params", "velocity")
                         for n in ("W", "b", "c", "z")],
            ptr(err), ptr(shares), ptr(momentum), V, H, kernel_flags(cfg), scale, cfg.lr,
            cfg.lr if cfg.lr_variance is None else cfg.lr_variance,
            resolve_momentum(cfg, epoch), cfg.l2,
            cfg.grad_clip if cfg.grad_clip is not None else 0.0,
            cfg.sparsity_target if cfg.sparsity_target is not None else 0.0, cfg.sparsity_cost,
            _device_index(device), torch.cuda.current_stream(device).cuda_stream)

    def launch(keep=(sums, shares, momentum, err, state)) -> None:  # what the pointers point into
        rc = lib.cd_update_step(*args)
        if rc != 0:
            raise RuntimeError(f"cd_update kernel launch failed: cudaError {rc} "
                               f"({lib.cd_grads_error_string(rc).decode()})")

    return launch, err[0]


def cd_update(cfg: RBMConfig, params: RBMParams, velocity: RBMParams, sums: torch.Tensor,
              scale: float, epoch: int) -> Tuple[RBMParams, RBMParams, torch.Tensor]:
    """The update on the CUDA kernels, launched on the current stream: W, b,
    c (and z) and their velocities change IN PLACE (the data-parallel path
    holds its own copies) and are returned with the step's error. The same
    bits as ``cd_update_plain``, which CPU tensors take, except where the
    enhanced gradient's matvecs sum in another order. Raises ValueError for a
    config or input the kernel does not take and RuntimeError when the launch
    fails."""
    global cd_update_launches
    if sums.device.type == "cpu":
        return cd_update_plain(cfg, params, velocity, sums, scale, epoch)
    if sums.device.type != "cuda":
        raise ValueError(f"cd_update takes CPU or CUDA tensors, got {sums.device}")
    launch, err = update_launcher(cfg, params, velocity, sums, scale, epoch)
    launch()
    cd_update_launches += 1
    return params, velocity, err

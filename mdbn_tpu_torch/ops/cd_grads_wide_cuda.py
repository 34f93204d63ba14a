"""The W-blocked kernel's data-parallel mode: CUDA kernels and plain versions.

Port of ``mdbn_tpu/ops/cd_epoch_pallas.py::_cd_train_kernel_wb`` with
``ndev > 1``, the kernel the TPU's data-parallel path trains its widest
models through: each shard computes its factors, the factors are gathered
around a ring, and every shard forms the global gradient from the gathered
factors in source order. Here that is two launches per update with an
all-gather between them (``parallel.dp``):

- the step, ``cd_wide_step`` (``csrc/cd_grads_wide.cu``'s
  ``cd_wide_step_kernel``, one cooperative launch; every x W product is a sum
  over fixed strips of W's rows, as in ``csrc/cd_train_wide.cu``), or its
  plain version ``cd_wide_step_plain``: one rank's shard of ``B`` rows, the
  first ``n_valid`` real and the rest pad rows, into the rank's slot of the
  gather buffer (``slot_layout``): the negative-phase visibles ``vs`` [B, V]
  rounded through the storage dtype, the h-matrix [2, B, H] float32 =
  [h0p ; -hmean] on the real rows (0 on pad rows), and the monitor's masked
  sum over ``norm`` (mse: also over V; xent: negated);
- the update, ``cd_wide_update`` (``cd_wide_update_kernel``,
  ``csrc/cd_wide_update.cuh``: a stream over tiles of W through a ring of
  cp.async stages, gW's tile on ``mma.sync`` at bf16 compute or
  register-blocked FFMA at f32, the update on the sums in registers; its use
  of shared memory is ``update_plan``) or its plain version
  ``cd_wide_update_plain``: on every rank, the same gathered slots in rank
  order and the global minibatch's v0 (every rank holds the data, so v0 does
  not cross the wire) give gW = (v0^T h0p - vs^T hmean) / B, gb, gc with its
  sparsity term, then clip, L2 and momentum (``core.rbm_math.apply_update``'s
  rule), rounded once into the storage dtype; the monitor is the mean of the
  slots'.

A captured epoch (``parallel.dp.EpochSteps``) builds the launchers once
(``step_launcher`` / ``update_launcher`` with ``tab``: the step reads its
minibatch and seed, the update its minibatch, from a device row; the update
reads the momentum from device memory, so the config picks its velocity
variant, ``velocity_variant``) after ``prepare``.

Scope: that of ``ops.cd_epoch_wide_cuda`` (``ops.cd_epoch_cuda.wide_unsupported``:
mean-field negative phase, mse or xent monitor, plain gradient, no tempering,
no learned variance). The slot layout is bytes, so the step's factors cross
the wire at their own widths: at 20000x400 bf16 over 4 ranks (5 rows each)
a slot is 216,016 bytes, where ``csrc/cd_grads.cu``'s route all-reduces
32 MB of f32 statistics.

The kernel wrappers take CUDA tensors only and never fall back to the plain
versions; ``parallel.dp`` picks the kernels or the plain versions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import (RBMParams, apply_update, hidden_mean, recon_error,
                             resolve_momentum, split_grads, torch_dtype, visible_mean)
from .cd_epoch_cuda import _F_INJECT, _on_device, check_trace, kernel_flags, ptr
from .cd_epoch_wide_cuda import check_wide_supports
from .cd_step import draw_uniforms

# Launches of each CUDA kernel in this process (incremented only where the
# kernel is launched).
cd_wide_step_launches = 0
cd_wide_update_launches = 0


class SlotLayout(NamedTuple):
    """Byte offsets of one rank's slot: vs [B, V] at the storage dtype, the
    h-matrix [2, B, H] float32, err float32; each part 16-byte aligned."""

    vs: int
    h: int
    err: int
    size: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def slot_layout(cfg: RBMConfig) -> SlotLayout:
    """The slot of a shard of ``cfg.batch_size`` rows (csrc/cd_grads_wide.cu's
    slot_layout)."""
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    width = torch_dtype(cfg.param_dtype).itemsize
    h = _align16(B * V * width)
    err = h + _align16(2 * B * H * 4)
    return SlotLayout(vs=0, h=h, err=err, size=err + 16)


def wide_factor_size(cfg: RBMConfig) -> int:
    """Bytes of one rank's slot of the gather buffer, for the shard's config
    (``batch_size`` = the rank's rows): what each rank sends per update."""
    return slot_layout(cfg).size


def slot_views(cfg: RBMConfig, slot: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(vs [B, V] at the storage dtype, h-matrix [2, B, H] float32, err [1]
    float32) as views of a uint8 slot of ``wide_factor_size(cfg)`` bytes."""
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    lay = slot_layout(cfg)
    sdt = torch_dtype(cfg.param_dtype)
    vs = slot[lay.vs:lay.vs + B * V * sdt.itemsize].view(sdt).view(B, V)
    hmat = slot[lay.h:lay.h + 2 * B * H * 4].view(torch.float32).view(2, B, H)
    return vs, hmat, slot[lay.err:lay.err + 4].view(torch.float32)


def gathered_views(cfg: RBMConfig, gathered: torch.Tensor, ndev: int
                   ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``slot_views`` of each rank's slot of the gather buffer, in rank
    order; ``cfg`` is the shard's config."""
    n = wide_factor_size(cfg)
    return [slot_views(cfg, gathered[d * n:(d + 1) * n]) for d in range(ndev)]


# stamps of the update's trace (csrc/cd_wide_update.cuh), block 0's: entry, Y
# staged and the ring started, then ns summed over its tiles waiting for the
# ring (the tile pipeline), in the sums and in the update of W and b; the
# tiles done, the exit (after the bias sums of c where block 0 takes part),
# and the tiles it walked
UPDATE_TRACE = ("entry", "y_staged", "ring_wait_ns", "sums_ns", "update_ns", "tiles_done",
                "exit", "tiles")
_UPDATE_TQ, _UPDATE_MAX_STAGES = 16, 4
_UPDATE_BAR = 48  # the mbarriers of a resident plan: Y's and each stage's
_RESERVED_PER_BLOCK = 1024  # shared memory the card keeps for each block
H100_SMEM_PER_SM = 233472  # an H100 SM's shared memory, bytes


class UpdatePlan(NamedTuple):
    """How the update uses a block's shared memory (csrc/cd_wide_update.cuh's
    update_plan): a block's threads (256, or 128 with two blocks an SM), the
    ring's stages (0: none), whether Y = [h0p; -hmean] is staged once a block
    with X and W (and vW) through the ring (``resident``), K = 2B padded (to
    16 at bf16 compute), the K rows staged at once, the bytes, and whether
    any of it fits."""

    threads: int
    stages: int
    resident: bool
    kp: int
    kc: int
    smem_bytes: int
    ok: bool

    def as_tuple(self) -> Tuple[int, ...]:
        return (self.threads, self.stages, int(self.resident), self.kp, self.kc,
                self.smem_bytes, int(self.ok))


def velocity_variant(cfg: RBMConfig) -> bool:
    """Whether the update reads the old velocity: a momentum of the run is
    not 0 (at m = 0 the variant gives the other's values)."""
    return cfg.momentum != 0 or bool(cfg.initial_momentum)


def update_plan(cfg: RBMConfig, smem_limit: Optional[int] = None, aligned: bool = True,
                smem_per_sm: int = H100_SMEM_PER_SM) -> UpdatePlan:
    """The update's plan for the global config ``cfg`` (R = batch_size rows)
    on a card whose blocks may opt in to ``smem_limit`` bytes (None: an
    H100's, 232,448) of an SM's ``smem_per_sm``: two blocks of 128 threads an
    SM where each holds Y, staged once a block, beside a ring of 4, 3 or 2
    stages of X's tile rows and W's (and vW's) tile in half the SM's shared
    memory (less the 1 KB kept a block); else one block of 256 threads with
    the same; where neither fits, or a row of X (V values) or of W (H
    values) is not whole 16-byte pieces, or the pointers are not 16-byte
    aligned (``aligned``), K in chunks staged tile by tile, the most that
    fit."""
    from .cd_epoch_resident_cuda import H100_SMEM_PER_BLOCK

    limit = H100_SMEM_PER_BLOCK if smem_limit is None else smem_limit
    V, H, R = cfg.n_visible, cfg.n_hidden, cfg.batch_size
    s = torch_dtype(cfg.param_dtype).itemsize
    bf = cfg.compute_dtype == "bfloat16"
    up = lambda n, m: -(-n // m) * m
    k2 = 2 * R
    kp = up(k2, 16) if bf else k2
    yrow = up(H, 32) * 2 if bf else up(H, 4) * 4
    x = up(k2 * _UPDATE_TQ * s, 16)
    w = up(_UPDATE_TQ * H * s, 16) * (2 if velocity_variant(cfg) else 1)
    if aligned and V * s % 16 == 0 and H * s % 16 == 0:
        half = min(limit, smem_per_sm // 2 - _RESERVED_PER_BLOCK)
        for threads, room in ((128, half), (256, limit)):
            for st in range(_UPDATE_MAX_STAGES, 1, -1):
                need = _UPDATE_BAR + kp * yrow + st * (x + w)
                if need <= room:
                    return UpdatePlan(threads, st, True, kp, kp, need, True)
    unit = 16 if bf else 2
    kc = min(kp, limit // (yrow + _UPDATE_TQ * s) // unit * unit)
    if kc < unit:
        return UpdatePlan(256, 0, False, kp, 0, 0, False)
    return UpdatePlan(256, 0, False, kp, kc, kc * (yrow + _UPDATE_TQ * s), True)


def _valid(B: int, n_valid: Optional[int]) -> int:
    nv = B if n_valid is None else int(n_valid)
    if not 0 <= nv <= B:
        raise ValueError(f"n_valid must lie in [0, {B}], got {n_valid}")
    return nv


def _slot_out(cfg: RBMConfig, out: Optional[torch.Tensor], device) -> torch.Tensor:
    n = wide_factor_size(cfg)
    if out is None:  # zeros: the parts' alignment padding is never written
        return torch.zeros(n, dtype=torch.uint8, device=device)
    if out.dtype != torch.uint8 or tuple(out.shape) != (n,) or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous uint8 tensor of {n} bytes "
                         "(wide_factor_size)")
    if out.device != device:
        raise ValueError(f"out is on {out.device}, expected {device}")
    return out


def cd_wide_step_plain(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor,
                       chain: torch.Tensor, *, seed: Optional[int] = None,
                       uniforms: Optional[Dict[str, torch.Tensor]] = None,
                       n_valid: Optional[int] = None, norm: Optional[float] = None,
                       out: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the step (see module doc): ``cfg`` is the
    shard's config, ``v0`` and ``chain`` [B, ·] at its storage dtype, ``norm``
    the divisor of the monitor's sum (default B). Returns (slot, new_chain);
    the chain changes only under PCD."""
    check_wide_supports(cfg)
    B, sdt = v0.shape[0], torch_dtype(cfg.param_dtype)
    nv = _valid(B, n_valid)
    if uniforms is None:
        if seed is None:
            raise ValueError("a step without injected uniforms needs a seed")
        uniforms = draw_uniforms(cfg, B, torch.Generator(device=v0.device).manual_seed(seed))
    out = _slot_out(cfg, out, v0.device)
    valid = (torch.arange(B, device=v0.device) < nv)[:, None]
    x = v0.float()
    h0p = hidden_mean(params, x, cfg)
    h0s = (uniforms["h0"] < h0p).float()
    h = chain.float() if cfg.persistent else h0s
    for t in range(cfg.k):
        vm = visible_mean(params, h, cfg)
        if t == 0:
            v1mean = vm
        vs = vm.to(sdt)
        hmean = hidden_mean(params, vs.float(), cfg)
        h = (uniforms["h"][t] < hmean).float()
    if cfg.persistent:  # the monitor reconstructs the data chain
        v1mean = visible_mean(params, h0s, cfg)
    err = recon_error(x, v1mean, cfg.error_metric, valid.float(),
                      float(norm if norm is not None else B))
    vs_out, hmat, err_out = slot_views(cfg, out)
    vs_out.copy_(vs)
    hmat.copy_(torch.where(valid, torch.stack([h0p, -hmean]), 0.0))
    err_out.copy_(err.reshape(1))
    return out, (h.to(chain.dtype) if cfg.persistent else chain)


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _library(cfg: RBMConfig):
    from .._build import load_library  # builds the kernels at first use

    return load_library("cd_grads_wide", cfg.param_dtype).lib


def prepare(cfg: RBMConfig, ndev: int, device: torch.device) -> None:
    """Sets up the step's and the update's launches of a run of the global
    config ``cfg`` over ``ndev`` ranks on ``device`` ahead of them (a launch
    captured in a CUDA graph must ask the device nothing). Builds the
    kernels at first use."""
    lib = _library(cfg)
    rc = lib.cd_wide_prepare(cfg.n_visible, cfg.n_hidden, _shard_cfg(cfg, ndev).batch_size,
                             cfg.batch_size, kernel_flags(cfg), int(velocity_variant(cfg)),
                             _device_index(device))
    if rc != 0:
        raise RuntimeError(f"cd_grads_wide prepare: cudaError {rc} "
                           f"({lib.cd_grads_wide_error_string(rc).decode()})")


def step_scratch(cfg: RBMConfig, device: torch.device) -> torch.Tensor:
    """A scratch buffer for the steps of the shard's config ``cfg``."""
    n = _library(cfg).cd_wide_scratch_floats(cfg.n_visible, cfg.n_hidden, cfg.batch_size)
    return torch.empty(int(n), dtype=torch.float32, device=device)


def step_launcher(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor, chain: torch.Tensor,
                  *, seed: Optional[int] = None,
                  uniforms: Optional[Dict[str, torch.Tensor]] = None,
                  n_valid: Optional[int] = None, norm: Optional[float] = None,
                  out: Optional[torch.Tensor] = None, grid: int = 0,
                  tab: Optional[torch.Tensor] = None,
                  chain_out: Optional[torch.Tensor] = None,
                  scratch: Optional[torch.Tensor] = None,
                  ) -> Tuple[Callable[[], None], torch.Tensor, torch.Tensor]:
    """Checks a step's CUDA inputs and allocates its outputs: returns
    (launch, slot, new_chain), where ``launch()`` launches the kernel once
    into those outputs on the current stream, raises RuntimeError when the
    launch fails, and counts nothing. ``tab``: a CUDA int64 tensor of 3 (a
    row of ``parallel.dp.epoch_tables``) the kernel reads its minibatch and
    seed from at each launch, ``v0`` then the shards [n, B, V] it indexes;
    ``chain_out``: the PCD chain's buffer out (else a new one); ``scratch``:
    a buffer of ``step_scratch`` that steps launched one after the other may
    share (else a new one). Raises ValueError for a config or input the
    kernel does not take."""
    check_wide_supports(cfg)
    device, sdt = v0.device, torch_dtype(cfg.param_dtype)
    B, V, H, k = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k
    nv = _valid(B, n_valid)
    if tab is not None:
        tab = _on_device(tab, "tab", (3,), device, torch.int64)
        v0 = _on_device(v0, "v0", (v0.shape[0], B, V), device, sdt)
    else:
        v0 = _on_device(v0, "v0", (B, V), device, sdt)
    W = _on_device(params.W, "W", (V, H), device, sdt)
    b = _on_device(params.b, "b", (V,), device, sdt)
    c = _on_device(params.c, "c", (H,), device, sdt)
    chain = _on_device(chain, "chain", (B, H), device, sdt)
    flags = kernel_flags(cfg)
    u_h0 = u_h = None
    if uniforms is not None:
        flags |= _F_INJECT
        f32 = torch.float32
        u_h0 = _on_device(uniforms["h0"].reshape(B, H), "uniforms['h0']", (B, H), device, f32)
        u_h = _on_device(uniforms["h"].reshape(k, B, H), "uniforms['h']", (k, B, H), device, f32)
    elif seed is None and tab is None:
        raise ValueError("a step without injected uniforms needs a seed")
    out = _slot_out(cfg, out, device)
    lib = _library(cfg)
    if int(lib.cd_wide_slot_bytes(V, H, B)) != out.numel():
        raise RuntimeError("csrc/cd_grads_wide.cu's slot layout differs from slot_layout")
    if not cfg.persistent:
        new_chain = chain
    elif chain_out is None:
        new_chain = torch.empty((B, H), dtype=sdt, device=device)
    else:
        new_chain = _on_device(chain_out, "chain_out", (B, H), device, sdt)
    if scratch is None:
        scratch = step_scratch(cfg, device)
    else:
        scratch = _on_device(scratch, "scratch", (int(lib.cd_wide_scratch_floats(V, H, B)),),
                             device, torch.float32)
    args = (ptr(v0), ptr(tab), ptr(u_h0), ptr(u_h), ptr(W), ptr(b), ptr(c), ptr(chain),
            ptr(new_chain), ptr(out), ptr(scratch), V, H, B, k, flags, nv,
            1.0 / float(norm if norm is not None else B), (seed or 0) % 2 ** 64,
            _device_index(device), grid, torch.cuda.current_stream(device).cuda_stream)
    keep = (v0, tab, W, b, c, chain, u_h0, u_h, out, new_chain, scratch)

    def launch(keep=keep) -> None:  # keep: the buffers the pointers point into
        rc = lib.cd_wide_step(*args)
        if rc != 0:
            raise RuntimeError(f"cd_wide_step kernel launch failed: cudaError {rc} "
                               f"({lib.cd_grads_wide_error_string(rc).decode()})")

    return launch, out, new_chain


def cd_wide_step(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor, chain: torch.Tensor,
                 *, seed: Optional[int] = None,
                 uniforms: Optional[Dict[str, torch.Tensor]] = None,
                 n_valid: Optional[int] = None, norm: Optional[float] = None,
                 out: Optional[torch.Tensor] = None, grid: int = 0,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step on the CUDA kernel (see module doc); one launch on the
    current stream. Takes CUDA tensors only (``cd_wide_step_plain`` is its
    plain version). ``grid`` is the cooperative grid (0: one block per SM);
    the result does not depend on it. Returns (slot, new_chain). Raises
    ValueError for a config or input the kernel does not take and
    RuntimeError when the launch fails."""
    global cd_wide_step_launches
    if v0.device.type != "cuda":
        raise ValueError(f"cd_wide_step takes CUDA tensors, got {v0.device}; "
                         "cd_wide_step_plain is its plain version")
    launch, out, new_chain = step_launcher(cfg, params, v0, chain, seed=seed, uniforms=uniforms,
                                           n_valid=n_valid, norm=norm, out=out, grid=grid)
    launch()
    cd_wide_step_launches += 1
    return out, new_chain


def _shard_cfg(cfg: RBMConfig, ndev: int) -> RBMConfig:
    return cfg.replace(batch_size=-(-cfg.batch_size // ndev))


def cd_wide_update_plain(cfg: RBMConfig, params: RBMParams, velocity: RBMParams,
                         v0: torch.Tensor, gathered: torch.Tensor, ndev: int, scale: float,
                         epoch: int) -> Tuple[RBMParams, RBMParams, torch.Tensor]:
    """The plain version of the update (see module doc): ``cfg`` is the global
    config, ``v0`` the global minibatch [B, V], ``gathered`` the ndev slots
    of shards of ceil(B / ndev) rows in rank order, ``scale`` = 1 / ndev.
    Returns new (params, velocity, err); the inputs are unchanged."""
    check_wide_supports(cfg)
    B = cfg.batch_size
    views = gathered_views(_shard_cfg(cfg, ndev), gathered, ndev)
    vs = torch.cat([v[0] for v in views])[:B].float()
    hp = torch.cat([v[1][0] for v in views])[:B]
    hm = -torch.cat([v[1][1] for v in views])[:B]
    grads, _ = split_grads(params, v0[:B].float(), hp, vs, hm, cfg)
    params, velocity = apply_update(params, velocity, grads, cfg, epoch=epoch)
    err = views[0][2]
    for v in views[1:]:
        err = err + v[2]
    return params, velocity, (err * scale)[0]


def update_launcher(cfg: RBMConfig, params: RBMParams, velocity: RBMParams, v0: torch.Tensor,
                    gathered: torch.Tensor, ndev: int, scale: float, epoch: int, grid: int = 0,
                    *, tab: Optional[torch.Tensor] = None,
                    momentum: Optional[torch.Tensor] = None,
                    err: Optional[torch.Tensor] = None,
                    trace: Optional[torch.Tensor] = None,
                    ) -> Tuple[Callable[[], None], torch.Tensor]:
    """Checks an update's CUDA inputs: returns (launch, err), where
    ``launch()`` runs the update once on the current stream (W, b, c and
    their velocities in place), raises RuntimeError when the launch fails,
    and counts nothing. ``tab``: a CUDA int64 tensor of 3 whose first entry
    picks the minibatch of ``v0`` [n, rows >= B, V] at each launch (else
    ``v0`` is the global minibatch); ``momentum``: a CUDA float32 tensor of 1
    read in place of ``epoch``'s momentum; ``err``: a CUDA float32 tensor of
    1 for the monitor (else a new one); ``trace``: an int64 CUDA tensor of
    ``len(UPDATE_TRACE)`` for block 0's stamps. The config picks the
    velocity variant (``velocity_variant``). Raises ValueError for a config
    or input the kernel does not take."""
    check_wide_supports(cfg)
    device, sdt, f32 = gathered.device, torch_dtype(cfg.param_dtype), torch.float32
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    local = _shard_cfg(cfg, ndev)
    n = wide_factor_size(local)
    state = {}
    for part, p in (("params", params), ("velocity", velocity)):
        for name, shape in (("W", (V, H)), ("b", (V,)), ("c", (H,))):
            t = getattr(p, name)
            if not t.is_contiguous():
                raise ValueError(f"{part}.{name} must be contiguous (updated in place)")
            state[part, name] = _on_device(t, f"{part}.{name}", shape, device, sdt)
    if tab is not None:
        tab = _on_device(tab, "tab", (3,), device, torch.int64)
        if v0.dim() != 3 or v0.shape[1] < B or v0.shape[2] != V:
            raise ValueError(f"with tab, v0 must be the minibatches [n, >= {B}, {V}], got "
                             f"{tuple(v0.shape)}")
        v0 = _on_device(v0, "v0", tuple(v0.shape), device, sdt)
    else:
        if v0.dim() != 2 or v0.shape[0] < B:
            raise ValueError(f"v0 must be the global minibatch [{B}, {V}], got "
                             f"{tuple(v0.shape)}")
        v0 = _on_device(v0[:B], "v0", (B, V), device, sdt)
    gathered = _on_device(gathered, "gathered", (ndev * n,), device, torch.uint8)
    lib = _library(cfg)
    if int(lib.cd_wide_slot_bytes(V, H, local.batch_size)) != n:
        raise RuntimeError("csrc/cd_grads_wide.cu's slot layout differs from slot_layout")
    err = (torch.empty(1, dtype=f32, device=device) if err is None
           else _on_device(err, "err", (1,), device, f32))
    if momentum is not None:
        momentum = _on_device(momentum, "momentum", (1,), device, f32)
    check_trace(trace, (len(UPDATE_TRACE),), device)
    p, vel = (lambda k: state["params", k]), (lambda k: state["velocity", k])
    args = (ptr(v0), ptr(tab), v0.shape[1] * V if tab is not None else 0, ptr(gathered),
            ptr(p("W")), ptr(p("b")), ptr(p("c")), ptr(vel("W")), ptr(vel("b")), ptr(vel("c")),
            ptr(err), ptr(momentum), ptr(trace), V, H, B, local.batch_size, ndev,
            kernel_flags(cfg), int(velocity_variant(cfg)), scale, cfg.lr,
            resolve_momentum(cfg, epoch), cfg.l2,
            cfg.grad_clip if cfg.grad_clip is not None else 0.0,
            cfg.sparsity_target if cfg.sparsity_target is not None else 0.0, cfg.sparsity_cost,
            _device_index(device), grid, torch.cuda.current_stream(device).cuda_stream)

    def launch(keep=(v0, tab, gathered, err, momentum, trace, state)) -> None:
        rc = lib.cd_wide_update(*args)  # keep: what the pointers point into
        if rc != 0:
            raise RuntimeError(f"cd_wide_update kernel launch failed: cudaError {rc} "
                               f"({lib.cd_grads_wide_error_string(rc).decode()})")

    return launch, err[0]


def cd_wide_update(cfg: RBMConfig, params: RBMParams, velocity: RBMParams, v0: torch.Tensor,
                   gathered: torch.Tensor, ndev: int, scale: float, epoch: int, grid: int = 0,
                   ) -> Tuple[RBMParams, RBMParams, torch.Tensor]:
    """The update on the CUDA kernel, launched on the current stream: W, b, c
    and their velocities change IN PLACE (the data-parallel path holds its
    own copies) and are returned with the update's error. Takes CUDA tensors
    only (``cd_wide_update_plain`` is its plain version); ``grid`` (0: one
    block per SM) does not change the result. Raises ValueError for a config
    or input the kernel does not take and RuntimeError when the launch
    fails."""
    global cd_wide_update_launches
    if gathered.device.type != "cuda":
        raise ValueError(f"cd_wide_update takes CUDA tensors, got {gathered.device}; "
                         "cd_wide_update_plain is its plain version")
    launch, err = update_launcher(cfg, params, velocity, v0, gathered, ndev, scale, epoch, grid)
    launch()
    cd_wide_update_launches += 1
    return params, velocity, err

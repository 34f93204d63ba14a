"""Tensor-parallel CD training over a dp x tp mesh: one process per rank.

Port of the reference's dp x tp path (``mdbn_tpu/parallel/mesh.py::make_mesh_2d``
with ``mdbn_tpu/train/trainer.py::_state_shardings``), where GSPMD runs the
single-device XLA program on sharded state: W, its velocity, c and the PCD
chain split over the hidden units, b and z replicated, the minibatch's rows
split over dp. There is no Pallas kernel on that path (the reference sends
any tp mesh to its XLA engine, ``trainer.py:171-174``), so this is the eager
PyTorch engine (``ops.cd_epoch_cuda.cd_train_run_plain``) with the
collectives put where GSPMD puts them.

Rank (i, j) of the grid (``parallel.mesh.make_mesh_2d``) holds

- rows ``[i * lb, (i + 1) * lb)`` of every global minibatch of B rows,
  ``lb = ceil(B / dp)``, the tail rows of the last dp row padded and masked
  (``row_mask`` and ``norm = B / dp``, as ``parallel/dp.py::local_batch``);
- hidden units ``tp_columns(H, tp, j)`` (a balanced split: H need not divide):
  its columns of W and of W's velocity, its entries of c and its velocity,
  and the chain's (rows x columns; a tempering ladder its rows' rungs x
  columns);
- b and z and their velocities, replicated.

A step runs the core's functions (``core.rbm_math``) with the handle
``TPGroup``: each sum over hidden units (the partial ``h W^T`` of the
visible means, the softplus sum of the free energy, ``h.c`` and ``h W^T`` of
tempering's log p*(h), learned variance's ``W h`` terms, the enhanced
gradient's ``gW_e lam``) is all-reduced over the tp row. Every value decided
from such a sum (a visible sample, a swap, the monitor) is then the same bits
on every rank of the row. The row statistics (``split_grads``' form: gW's
columns, gb, gc, z's statistic, the enhanced gradient's sums, the monitor)
go into one flat buffer (``ops.cd_grads_cuda.flat_size`` of the rank's
shard), all-reduced (SUM) over the dp column and scaled by 1 / dp; then the
update, elementwise on the rank's shard (``finish_grads``, ``apply_update``).

Draws: every rank holds the replicated generator and draws each step's
global uniforms exactly as the single-device eager engine does
(``batch_order``, one seed, then ``draw_uniforms`` / ``draw_pt_uniforms`` at
the global [., B, H] and [., B, V] shapes), keeping its rows and columns;
injected uniforms (``ops.cd_epoch_cuda.draw_uniform_blocks``' layout) are
sliced the same way. A dp x tp run is therefore the single-device eager run
up to the order of the sums.

``train_rbm_tp`` returns the whole state on every rank, gathered through the
host under gloo (``_gather_state``), so transforms, the DBN/MDBN stacking,
checkpoints and the metrics file work unchanged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import RBMConfig
from ..core.rbm_math import (RBMParams, apply_update, cd_step_stats, finish_grads,
                             pseudo_likelihood, pt_step_stats)
from ..core.state import TrainState
from ..ops.cd_epoch_cuda import _draw_seed, _step_uniforms, batch_order
from ..ops.cd_grads_cuda import flat_size, flat_views, pack
from ..ops.cd_step import draw_pt_uniforms, draw_uniforms
from .dp import local_batch, world_scale
from .mesh import Mesh


class CollectiveTimer:
    """Host seconds spent in a run's collectives, and their count, by kind
    ("tp": the sums over hidden units, "dp": the statistics, "gather": the
    state at the end); a measurement aid. Each collective is bracketed by a
    device synchronisation, so the device work queued before it is not
    counted as its time."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}

    @contextlib.contextmanager
    def of(self, kind: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[kind] = self.seconds.get(kind, 0.0) + time.perf_counter() - t0
            self.calls[kind] = self.calls.get(kind, 0) + 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _timed(timer: Optional[CollectiveTimer], kind: str):
    return contextlib.nullcontext() if timer is None else timer.of(kind)


class TPGroup:
    """The tensor-parallel handle of ``core.rbm_math``: ``sum(x)`` all-reduces
    a partial sum over this rank's hidden units across the tp row (in place;
    every rank of the row gets the same bits)."""

    def __init__(self, group, timer: Optional[CollectiveTimer] = None):
        self.group, self.timer = group, timer

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        with _timed(self.timer, "tp"):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


def tp_columns(n_hidden: int, tp: int, j: int) -> slice:
    """The hidden units of tp coordinate ``j``: a balanced split of
    ``n_hidden`` over ``tp`` (widths differ by at most one)."""
    return slice(j * n_hidden // tp, (j + 1) * n_hidden // tp)


def _row_axis(name: str) -> int:
    """The batch-row axis of one step's draw ``name`` (the ``draw_uniforms``
    / ``draw_pt_uniforms`` layouts)."""
    return -1 if name == "swap" else -2


def _rows(x: torch.Tensor, axis: int, lo: int, n_valid: int, lb: int) -> torch.Tensor:
    """Rows [lo, lo + n_valid) of ``x`` along ``axis``, zero rows padding
    them to ``lb``."""
    part = x.narrow(axis, min(lo, x.shape[axis]), n_valid)
    if n_valid == lb:
        return part
    shape = list(part.shape)
    shape[axis] = lb - n_valid
    return torch.cat([part, part.new_zeros(shape)], dim=axis)


class _Shard:
    """Rank (i, j)'s rows and columns of a run of ``cfg`` over ``mesh``."""

    def __init__(self, cfg: RBMConfig, mesh: Mesh):
        B, H = cfg.batch_size, cfg.n_hidden
        if H < mesh.tp:
            raise ValueError(f"n_hidden={H} is narrower than the mesh's tp width {mesh.tp}")
        self.lb, self.norm, self.uneven = local_batch(cfg, mesh.dp)
        self.lo = mesh.dp_rank * self.lb
        self.n_valid = max(0, min(self.lb, B - self.lo))
        self.cols = tp_columns(H, mesh.tp, mesh.tp_rank)
        self.width = self.cols.stop - self.cols.start
        self.wmax = -(-H // mesh.tp)  # the widest shard, for the gather
        self.local = cfg.replace(batch_size=self.lb, n_hidden=self.width)

    def rows(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        return _rows(x, axis, self.lo, self.n_valid, self.lb)

    def draws(self, u: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step's global draws cut to this rank: its rows of each, and its
        columns of the hidden draws."""
        out = {}
        for name, x in u.items():
            x = self.rows(x, _row_axis(name))
            out[name] = x[..., self.cols] if name in ("h0", "h") else x
        return out

    def params(self, p: RBMParams) -> RBMParams:
        return RBMParams(W=p.W[:, self.cols].contiguous(), b=p.b,
                         c=p.c[self.cols].contiguous(), z=p.z)

    def chain(self, cfg: RBMConfig, chain: torch.Tensor) -> torch.Tensor:
        """The rank's chain [M * lb, width] (rung-major) from the global one
        [M * B, H]."""
        M, B = max(cfg.pt_temps, 1), cfg.batch_size
        ch = self.rows(chain.reshape(M, B, -1), 1)[..., self.cols]
        return ch.reshape(M * self.lb, self.width).contiguous()


def _gather_state(cfg: RBMConfig, mesh: Mesh, shard: _Shard, params: RBMParams,
                  velocity: RBMParams, chain: Optional[torch.Tensor],
                  timer: Optional[CollectiveTimer]) -> Tuple[RBMParams, RBMParams,
                                                             Optional[torch.Tensor]]:
    """The whole state from every rank's shard, on every rank: one all-gather
    of each rank's flat float32 buffer (0/1 and bf16 values are exact in
    it), through the host under gloo (which has no all-gather of CUDA
    tensors). W, c and their velocities come from dp row 0; the chain from
    every rank, pad rows dropped. Raises when the dp replicas of a shard, or
    the replicated b and z, do not hold the same bits on every rank."""
    V, B, H = cfg.n_visible, cfg.batch_size, cfg.n_hidden
    M, lb, wmax = max(cfg.pt_temps, 1), shard.lb, shard.wmax
    dev = params.W.device

    def padded(t: torch.Tensor) -> torch.Tensor:  # [..., width] -> [..., wmax], flat
        t = t.float()
        if shard.width < wmax:
            t = torch.cat([t, t.new_zeros(t.shape[:-1] + (wmax - shard.width,))], dim=-1)
        return t.reshape(-1)

    cols = [padded(params.W), padded(velocity.W), padded(params.c), padded(velocity.c)]
    repl = [t.float().reshape(-1) for t in (params.b, velocity.b, params.z, velocity.z)
            if t is not None]
    parts = cols + repl + ([padded(chain.reshape(M, lb, shard.width))]
                           if chain is not None else [])
    mine = torch.cat(parts)
    if mesh.backend == "gloo":
        mine = mine.cpu()
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    with _timed(timer, "gather"):
        dist.all_gather(every, mine)
    sizes = [p.numel() for p in parts]

    def split(x: torch.Tensor) -> List[torch.Tensor]:
        return list(x.split(sizes))

    pieces = [split(x) for x in every]  # [rank][part]
    n_cols, n_repl = len(cols), len(repl)
    for r, pr in enumerate(pieces):
        j = r % mesh.tp
        for a, b in zip(pr[:n_cols], pieces[j][:n_cols]):
            if not torch.equal(a, b):
                raise RuntimeError(f"rank {r}'s shard of W or c differs from rank {j}'s, "
                                   "its dp replica: the tensor-parallel run drifted")
        for a, b in zip(pr[n_cols:n_cols + n_repl], pieces[0][n_cols:n_cols + n_repl]):
            if not torch.equal(a, b):
                raise RuntimeError(f"rank {r}'s b or z differs from rank 0's: the "
                                   "tensor-parallel run drifted")
    widths = [tp_columns(H, mesh.tp, j) for j in range(mesh.tp)]

    def whole(k: int, lead) -> torch.Tensor:  # part k of dp row 0, columns joined
        return torch.cat([pieces[j][k].view(*lead, wmax)[..., :s.stop - s.start]
                          for j, s in enumerate(widths)], dim=-1)

    W, vW = (whole(k, (V,)).to(device=dev, dtype=t.dtype)
             for k, t in ((0, params.W), (1, velocity.W)))
    c, vc = (whole(k, ()).to(device=dev, dtype=t.dtype)
             for k, t in ((2, params.c), (3, velocity.c)))
    new_params = RBMParams(W=W, b=params.b, c=c, z=params.z)
    new_velocity = RBMParams(W=vW, b=velocity.b, c=vc, z=velocity.z)
    new_chain = None
    if chain is not None:
        k = n_cols + n_repl
        rows = [torch.cat([pieces[i * mesh.tp + j][k].view(M, lb, wmax)[..., :s.stop - s.start]
                           for j, s in enumerate(widths)], dim=-1) for i in range(mesh.dp)]
        new_chain = (torch.cat(rows, dim=1)[:, :B].reshape(M * B, H)
                     .to(device=dev, dtype=chain.dtype))
    return new_params, new_velocity, new_chain


def train_rbm_tp(state: TrainState, data, cfg: RBMConfig, mesh: Mesh, n_epochs: int,
                 uniforms: Optional[Dict[str, torch.Tensor]] = None,
                 timer: Optional[CollectiveTimer] = None) -> Tuple[TrainState, torch.Tensor]:
    """Run ``n_epochs`` epochs of CD-k/PCD (or PT-PCD) over the dp x tp
    ``mesh`` (see module doc); every rank calls it with the same state and
    data. Returns (state, per-epoch errors [n_epochs]), the same on every
    rank: the state whole, gathered from the shards. ``uniforms``: the run's
    global draws in the inject layout of
    ``ops.cd_epoch_cuda.draw_uniform_blocks`` (what ``train_rbm`` takes on
    one device), for exact comparisons; by default the draws come from the
    state's generator as on one device. ``timer``: a ``CollectiveTimer`` that
    adds up the time of the call's collectives by kind."""
    B, V = cfg.batch_size, cfg.n_visible
    nb = data.shape[0] // B
    if nb == 0:
        raise ValueError(f"dataset has {data.shape[0]} samples — fewer than one global "
                         f"minibatch (batch_size={B})")
    dev, dtype = state.device, state.params.W.dtype
    shard = _Shard(cfg, mesh)
    local, lb, norm = shard.local, shard.lb, shard.norm
    tp = TPGroup(mesh.tp_group, timer)
    data = torch.as_tensor(data).to(device=dev, dtype=dtype)
    my = shard.rows(data[: nb * B].reshape(nb, B, V), 1)  # [nb, lb, V]
    mask = None
    if shard.uneven:  # the rank's valid rows (pad rows sit on the last dp row)
        mask = (torch.arange(lb, device=dev) < shard.n_valid).float()[:, None]
    persistent, pt = cfg.persistent, cfg.pt_temps > 1
    M = max(cfg.pt_temps, 1)
    chain = shard.chain(cfg, state.chain_h) if persistent else None
    params, velocity = shard.params(state.params), shard.params(state.velocity)
    order = batch_order(cfg, nb, n_epochs, state.generator).tolist()
    dgen = (None if uniforms is not None else
            torch.Generator(device=dev).manual_seed(_draw_seed(state.generator)))
    if uniforms is not None:
        uniforms = {name: torch.as_tensor(u).to(device=dev, dtype=torch.float32)
                    for name, u in uniforms.items()}
    draw = draw_pt_uniforms if pt else draw_uniforms
    flat = torch.empty(flat_size(local), dtype=torch.float32, device=dev)
    scale = world_scale(mesh.dp)
    pseudo = cfg.error_metric == "pseudo"
    errs = []
    for e in range(n_epochs):
        epoch = state.epoch + e
        step_errs = []
        for i, j in enumerate(order[e]):
            u = (_step_uniforms(cfg, uniforms, e, i) if uniforms is not None
                 else draw(cfg, B, dgen, dev))
            u = shard.draws(u)
            x = my[j].float()
            h = None if chain is None else chain.float()
            if pt:
                grads, sums, h, err = pt_step_stats(params, x, h.reshape(M, lb, -1), u, local,
                                                    row_mask=mask, norm=norm, split=True, tp=tp)
                h = h.reshape(M * lb, -1)
            else:
                grads, sums, h, err = cd_step_stats(params, x, h, u, local, row_mask=mask,
                                                    norm=norm, split=True, tp=tp)
            if pseudo:
                err = pseudo_likelihood(params, x, (epoch * nb + i) % V, local,
                                        row_mask=mask, norm=norm, tp=tp)
            pack(grads, sums, err, flat)
            if mesh.dp > 1:
                with _timed(timer, "dp"):
                    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.dp_group)
            grads, sums, err = flat_views(local, flat * scale)
            grads = finish_grads(params, grads, sums, local, tp=tp)
            params, velocity = apply_update(params, velocity, grads, local, epoch=epoch)
            if persistent:
                chain = h.to(chain.dtype)
            step_errs.append(err)
        errs.append(torch.stack(step_errs).mean())
    params, velocity, chain = _gather_state(cfg, mesh, shard, params, velocity, chain, timer)
    return (TrainState(params, velocity, state.chain_h if chain is None else chain,
                       state.generator, state.epoch + n_epochs), torch.stack(errs))

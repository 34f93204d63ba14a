"""Data-parallel CD training over torch.distributed: one process per rank.

Port of ``mdbn_tpu/parallel/dp.py::train_rbm_shard_map`` and of the TPU's DP
mega-kernel (``mdbn_tpu/ops/cd_epoch_pallas.py``, ``ndev > 1``) in every
estimator mode and at both storage dtypes. Every rank holds the replicated
parameters, velocities and generator and the whole dataset; the global
minibatch (``cfg.batch_size`` rows) is split across the ranks, rank r taking
rows ``[r * local_b, (r + 1) * local_b)``, ``local_b = ceil(B / ndev)``, with
zero pad rows on the tail ranks when B does not divide. Per step each rank
computes its shard's statistics into one flat buffer
(``ops.cd_grads_cuda.flat_size``: gW, gb, gc, learned variance's raw z
statistic or the enhanced gradient's mean sums, err), by the kernel
(``ops.cd_grads_cuda.cd_grads_step``, ``pallas_step=True``) or by its plain
version (``cd_grads_step_plain``); every entry is a masked sum scaled by
``ndev / B``, so one all-reduce (SUM) of the buffer, scaled by 1 / the world
size, gives every rank the global-batch statistics, even when B does not
divide. Every rank then finishes and applies the same update to the same
sums: the update kernel (``ops.cd_grads_cuda.cd_update``) under
``pallas_step``, its plain version (``cd_update_plain``: the core's
``finish_grads`` and ``apply_update``) otherwise. The step kernel is the
resident kernel's step variant (``ops.cd_grads_resident_cuda``, route
"cd_grads_resident") where a rank's tiles fit thread-block clusters, else
``csrc/cd_grads.cu`` (route "cd_grads"): ``ops.cd_epoch_cuda.select_dp_kernel``
decides from the config, the rank count and the card's limits.

On every route a seeded run on the kernels builds one epoch's launchers
once a call (``EpochSteps``: ``nb`` x step kernel, the collective, update
kernels); what changes from step to step or epoch to epoch reaches the
kernels through device memory (``epoch_tables``: each step's minibatch,
seed and pseudo bit, the epoch's momentum; the PCD chain in two buffers by
the step's parity, ``chain_parity``; each step's error into a buffer of
``nb``). Over NCCL the epoch is captured once as a CUDA graph and replayed
every epoch (a capture that fails raises); over gloo, which routes CUDA
tensors through the host, or with ``capture=False``, the same launches run
one at a time. Injected runs and the plain versions run the eager loop of
wrapper calls. Under tempering each rank
carries its rows' whole ladders, so the sweeps and the swap rounds stay on
the rank and only rung 0's statistics cross; the pseudo-likelihood monitor
is a masked per-shard sum on the single-device bit schedule. Collectives run
between the launches (``torch.distributed``), as the TPU's in-kernel remote
copies map to NCCL on Hopper: step kernel, all-reduce, update kernel are the
port of the TPU's DP mega-kernel, one update at a time.

A run inside the W-blocked kernel's scope that is at least
``ops.cd_epoch_cuda.WIDE_DP_MIN_VISIBLE`` wide takes the other route
(``ops.cd_epoch_cuda.select_dp_kernel``, from the config alone), the port of
the W-blocked kernel's DP mode: each rank's step
(``ops.cd_grads_wide_cuda.cd_wide_step``, or ``cd_wide_step_plain``) writes
its factors (the negative-phase visibles at storage dtype, the masked
h-matrix, the monitor) into its slot of a gather buffer, one all-gather
fills every slot (through the host under gloo), and every rank runs the
update (``cd_wide_update``, or ``cd_wide_update_plain``) on the same bytes,
reading v0 from the global minibatch it holds. ``pallas_step`` chooses only
between the kernels and their plain versions, so the CPU runs the same
exchange on the plain versions; its captured epoch gathers the slots with
``all_gather_into_tensor`` inside the graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import RBMConfig
from ..core.rbm_math import resolve_momentum
from ..core.state import TrainState
from ..ops import cd_grads_cuda as G
from ..ops import cd_grads_resident_cuda as R
from ..ops import cd_grads_wide_cuda as GW
from ..ops.cd_epoch_cuda import batch_order, select_dp_kernel
from ..ops.cd_epoch_resident_cuda import device_limits
from ..ops.cd_grads_cuda import (cd_grads_step, cd_grads_step_plain, cd_update,
                                 cd_update_plain, flat_size)
from ..ops.cd_grads_resident_cuda import cd_grads_resident_step
from ..ops.cd_grads_wide_cuda import (cd_wide_step, cd_wide_step_plain, cd_wide_update,
                                      cd_wide_update_plain, wide_factor_size)
from .mesh import Mesh

_M64 = (1 << 64) - 1


def fold_in(seed: int, rank: int) -> int:
    """A rank's own 64-bit seed from the replicated step seed (splitmix64 of
    the pair; the counterpart of ``jax.random.fold_in(key, rank)``)."""
    z = (seed + (rank + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def local_batch(cfg: RBMConfig, ndev: int) -> Tuple[int, float, bool]:
    """(local_b, norm, uneven): the rows each rank takes, the divisor of its
    sums (B / ndev) and whether the tail ranks carry pad rows."""
    B = cfg.batch_size
    local_b = -(-B // ndev)
    return local_b, B / ndev, local_b * ndev != B


def _shard_chain(cfg: RBMConfig, chain: torch.Tensor, rank: int, ndev: int,
                 local_b: int) -> torch.Tensor:
    """This rank's rows of the global chain: PCD [local_b, H]; a tempering
    ladder goes particle-major, the rank's [M, local_b, H] flattened."""
    B, M, H = cfg.batch_size, max(cfg.pt_temps, 1), chain.shape[1]
    pad = local_b * ndev - B
    ch = torch.nn.functional.pad(chain.reshape(M, B, H), (0, 0, 0, pad))
    return ch[:, rank * local_b:(rank + 1) * local_b].reshape(M * local_b, H).contiguous()


def _gather_chain(cfg: RBMConfig, local: torch.Tensor, mesh: Mesh,
                  local_b: int) -> torch.Tensor:
    """The global chain from every rank's rows, in rank order, pad rows
    dropped; a tempering ladder comes back rung-major [M * B, H]. Gloo has no
    all_gather of CUDA tensors, so under gloo the rows go through the CPU."""
    B, M, H = cfg.batch_size, max(cfg.pt_temps, 1), local.shape[1]
    src = (local.cpu() if mesh.backend == "gloo" else local).float()  # 0/1: exact in f32
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    ch = torch.stack([p.reshape(M, local_b, H) for p in parts], dim=1)  # [M, ndev, lb, H]
    ch = ch.reshape(M, mesh.size * local_b, H)[:, :B]
    return ch.reshape(M * B, H).to(local.device)


def gather_factors(gathered: torch.Tensor, mine: torch.Tensor, mesh: Mesh) -> None:
    """Fills the gather buffer (uint8, every rank's slot in rank order) from
    each rank's slot ``mine``, which is this rank's part of it. Gloo has no
    all-gather of CUDA tensors, so under gloo the bytes go through the CPU."""
    if mesh.backend != "gloo":
        dist.all_gather_into_tensor(gathered, mine)
        return
    host = torch.empty(gathered.shape, dtype=gathered.dtype)
    dist.all_gather(list(host.chunk(mesh.size)), mine.to("cpu", copy=True))
    gathered.copy_(host)


def epoch_tables(cfg: RBMConfig, order: List[List[int]], seeds: List[List[int]], rank: int,
                 start_epoch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A captured run's device tables, on the CPU: (tab [E, nb, 3] int64,
    momentum [E] float32). Step i of epoch e trains on minibatch
    ``order[e][i]`` under seed ``fold_in(seeds[e][i], rank)`` (its 64 bits
    as an int64) and the pseudo-likelihood monitor flips bit ``(epoch * nb
    + i) % V``, epoch = start_epoch + e; the epoch's momentum is
    ``resolve_momentum(cfg, epoch)``: what the eager loop passes step by
    step."""
    V, rows, mom = cfg.n_visible, [], []
    for e, steps in enumerate(order):
        epoch, nb = start_epoch + e, len(steps)
        for i, j in enumerate(steps):
            seed = fold_in(seeds[e][i], rank)
            rows.append((j, seed - (1 << 64) if seed >= 1 << 63 else seed, (epoch * nb + i) % V))
        mom.append(resolve_momentum(cfg, epoch))
    E = len(order)
    return (torch.tensor(rows, dtype=torch.int64).reshape(E, -1, 3),
            torch.tensor(mom, dtype=torch.float32))


def chain_parity(nb: int) -> Tuple[List[Tuple[int, int]], bool]:
    """(slots, copy_back) of a captured epoch's chain buffers: step i reads
    buffer ``slots[i][0]`` and writes ``slots[i][1]`` (i % 2 and (i + 1) %
    2); after an odd ``nb`` the chain lies in buffer 1, and ``copy_back``
    says the graph ends by copying it into buffer 0, where every epoch
    starts."""
    return [(i % 2, (i + 1) % 2) for i in range(nb)], nb % 2 == 1


class EpochSteps:
    """One epoch of a rank's data-parallel steps on the kernels of ``route``,
    their launchers built once: per step the step kernel (its minibatch of
    ``my`` [nb, B, V], seed and pseudo bit from row i of ``tab``), the
    collective over the process group and the update kernels (the momentum
    from ``mom``, the step's error into ``errs[i]``), updating ``params`` and
    ``velocity`` in place; ``chain`` (the rank's chain rows) is buffer 0 of
    the chain (``chain_parity``); the steps share one scratch buffer. On the
    flat-buffer routes ("cd_grads_resident", "cd_grads") the collective is
    the all-reduce of the flat buffer; on "cd_grads_wide" the all-gather of
    the rank's slot into one gather buffer (``gather_factors``), the update
    reading its global minibatch of ``batches`` [nb, rows, V] from the same
    row. With ``capture`` (NCCL) the epoch is captured once as a CUDA graph,
    the kernels set up and the collective warmed up on the capture stream
    first, and ``run`` replays it; a capture that fails raises. Without,
    ``run`` launches the same kernels one at a time on the current stream
    (gloo routes CUDA tensors through the host, which a graph cannot hold)."""

    def __init__(self, route: str, cfg: RBMConfig, local_cfg: RBMConfig, params, velocity,
                 my: torch.Tensor, chain: torch.Tensor, mask: Optional[torch.Tensor],
                 norm: float, scale: float, capture: bool, mesh: Optional[Mesh] = None,
                 batches: Optional[torch.Tensor] = None):
        dev, nb = my.device, my.shape[0]
        self.route, self.nb, self.persistent, self.mesh = route, nb, cfg.persistent, mesh
        self.tab = torch.zeros((nb, 3), dtype=torch.int64, device=dev)
        self.mom = torch.zeros(1, dtype=torch.float32, device=dev)
        self.errs = torch.zeros(nb, dtype=torch.float32, device=dev)
        self.chains = [chain, torch.empty_like(chain)]
        slots, self.copy_back = chain_parity(nb)
        wide = route == "cd_grads_wide"
        if wide:
            ndev, rank = mesh.size, mesh.rank
            GW.prepare(cfg, ndev, dev)  # the kernels set up: no request in a capture
            n = GW.wide_factor_size(local_cfg)
            self.gathered = torch.zeros(ndev * n, dtype=torch.uint8, device=dev)
            self.mine = self.gathered[rank * n:(rank + 1) * n]
            lb = local_cfg.batch_size
            kw = dict(scratch=GW.step_scratch(local_cfg, dev), out=self.mine,
                      n_valid=min(lb, max(0, cfg.batch_size - rank * lb)))
            make_step = GW.step_launcher
        elif route == "cd_grads_resident":
            R.step_limits(local_cfg, dev)  # the step kernels set up: no request in a capture
            kw = dict(scratch=R.step_scratch(local_cfg, dev), mask=mask, out=None)
            make_step = R.step_launcher
        elif route == "cd_grads":
            G.prepare(local_cfg, dev)
            kw = dict(scratch=G.step_scratch(local_cfg, dev), mask=mask, out=None)
            make_step = G.step_launcher
        else:
            raise ValueError(f"no epoch of kernel launchers on the {route!r} route")
        if not wide:
            G.prepare(cfg, dev)
            self.flat = kw["out"] = torch.empty(flat_size(cfg), dtype=torch.float32, device=dev)
            if cfg.error_metric == "pseudo":
                kw["pseudo_bit"] = 0
        stream = torch.cuda.Stream(dev) if capture else torch.cuda.current_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):  # the launchers launch on this stream
            self.steps = [make_step(local_cfg, params, my, self.chains[src], norm=norm,
                                    tab=self.tab[i], chain_out=self.chains[dst], **kw)[0]
                          for i, (src, dst) in enumerate(slots)]
            if wide:
                self.updates = [GW.update_launcher(cfg, params, velocity, batches, self.gathered,
                                                   mesh.size, scale, 0, tab=self.tab[i],
                                                   momentum=self.mom, err=self.errs[i:i + 1])[0]
                                for i in range(nb)]
            else:
                shares = G.enhance_shares(cfg, dev) if cfg.gradient == "enhanced" else None
                self.updates = [G.update_launcher(cfg, params, velocity, self.flat, scale, 0,
                                                  momentum=self.mom, err=self.errs[i:i + 1],
                                                  shares=shares)[0]
                                for i in range(nb)]
            self.graph = None
            if capture:
                self._collective()  # the collective's warm-up
                stream.synchronize()
                self.graph = torch.cuda.CUDAGraph()
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self._launch()
                finally:
                    self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)

    def _collective(self) -> None:
        if self.route == "cd_grads_wide":
            gather_factors(self.gathered, self.mine, self.mesh)
        else:
            dist.all_reduce(self.flat, op=dist.ReduceOp.SUM)

    def _launch(self, count: bool = False) -> None:
        """The epoch's launches on the current stream (``count``: each adds
        one to its kernel's count as it launches)."""
        for step, update in zip(self.steps, self.updates):
            step()
            if count:
                _count(self.route, 1)
            self._collective()
            update()
            if count:
                _count(self.route, 1, update=True)
        if self.persistent and self.copy_back:
            self.chains[0].copy_(self.chains[1])

    @property
    def chain(self) -> torch.Tensor:
        """The rank's chain rows after the last epoch."""
        return self.chains[0]

    def run(self, tab: torch.Tensor, mom: torch.Tensor) -> torch.Tensor:
        """One epoch: the table rows ``tab`` [nb, 3] and momentum ``mom`` [1]
        (device tensors) copied in, then the graph replayed (it launches each
        kernel nb times, counted here) or the launches made one at a time, on
        the current stream; returns the epoch's mean error (a device
        scalar)."""
        self.tab.copy_(tab)
        self.mom.copy_(mom)
        if self.graph is None:
            self._launch(count=True)
        else:
            self.graph.replay()
            _count(self.route, self.nb)
            _count(self.route, self.nb, update=True)
        return self.errs.mean()


def _count(route: str, n: int, update: bool = False) -> None:
    """Adds n launches to the step kernel's count of ``route``, or to its
    update kernel's."""
    if route == "cd_grads_wide":
        if update:
            GW.cd_wide_update_launches += n
        else:
            GW.cd_wide_step_launches += n
    elif update:
        G.cd_update_launches += n
    elif route == "cd_grads_resident":
        R.cd_grads_resident_launches += n
    else:
        G.cd_grads_launches += n


def world_scale(ndev: int) -> float:
    """1 / ndev rounded to float32: the factor of the all-reduced sums."""
    return float(torch.tensor(1.0 / ndev, dtype=torch.float32))


def train_rbm_shard_map(state: TrainState, data: torch.Tensor, cfg: RBMConfig, mesh: Mesh,
                        n_epochs: int, pallas_step: bool = False,
                        uniforms: Optional[Dict[str, torch.Tensor]] = None,
                        capture: bool = True) -> Tuple[TrainState, torch.Tensor]:
    """Run ``n_epochs`` epochs of CD-k/PCD (or PT-PCD) data-parallel over
    ``mesh``; every rank calls it with the same state and data. Returns
    (state, per-epoch errors [n_epochs]), the same on every rank; the state's
    chain is the global one, gathered in rank order. Data, chain and
    parameters stay at the config's storage dtype.

    The replicated generator in ``state`` gives every rank the same batch
    order and step seeds (drawn up front for the whole call: the order as
    ``ops.cd_epoch_cuda.batch_order`` draws it, then one seed per step when
    ``uniforms`` is None), and each rank samples from its own stream,
    ``fold_in(step seed, rank)``. The pseudo-likelihood monitor flips bit
    ``(epoch * nb + step) % V``, as the single-device run does. ``uniforms``:
    per-step, per-rank draws {name: [n_epochs, nb, ndev, ...]}, each step's
    [...] in the layout of ``ops.cd_step.draw_uniforms`` (``draw_pt_uniforms``
    under tempering) at ``local_b`` rows, for exact tests. ``capture``: a
    seeded run on the kernels over NCCL runs as a captured epoch
    (``EpochSteps``), replayed every epoch; False launches the same kernels
    one at a time."""
    B, V = cfg.batch_size, cfg.n_visible
    nb = data.shape[0] // B
    if nb == 0:
        raise ValueError(f"dataset has {data.shape[0]} samples — fewer than one global "
                         f"minibatch (batch_size={B})")
    ndev, rank, dev = mesh.size, mesh.rank, state.device
    local_b, norm, uneven = local_batch(cfg, ndev)
    local_cfg = cfg.replace(batch_size=local_b)
    pad = local_b * ndev - B
    data = torch.as_tensor(data).to(device=dev, dtype=state.params.W.dtype)
    batches = torch.nn.functional.pad(data[: nb * B].reshape(nb, B, V), (0, 0, 0, pad))
    my = batches[:, rank * local_b:(rank + 1) * local_b].contiguous()  # [nb, lb, V]
    mask = None
    if uneven:  # valid rows: rank * local_b + i < B (pad rows sit on the tail ranks)
        mask = ((rank * local_b + torch.arange(local_b, device=dev)) < B).float()[:, None]
    persistent = cfg.persistent  # tempering requires it
    # the rank's chain rows; under CD the kernel's chain argument (it passes through)
    chain = (_shard_chain(cfg, state.chain_h, rank, ndev, local_b) if persistent
             else torch.zeros((local_b, cfg.n_hidden), device=dev, dtype=state.chain_h.dtype))
    order = batch_order(cfg, nb, n_epochs, state.generator).tolist()
    seeds = (None if uniforms is not None else
             torch.randint(0, 2 ** 62, (n_epochs, nb), generator=state.generator).tolist())
    if uniforms is not None:
        uniforms = {name: torch.as_tensor(u)[:, :, rank].to(device=dev, dtype=torch.float32)
                    for name, u in uniforms.items()}
    # this call's own parameters and velocities: the update kernels write in place
    params, velocity = state.params.map(torch.clone), state.velocity.map(torch.clone)
    scale = world_scale(ndev)
    on_card = pallas_step and dev.type == "cuda"
    route = select_dp_kernel(cfg, ndev, (device_limits(local_cfg, dev, R.step_library(local_cfg))
                                         if on_card else None))
    epoch_steps = None
    if on_card and uniforms is None:
        epoch_steps = EpochSteps(route, cfg, local_cfg, params, velocity, my, chain, mask, norm,
                                 scale, capture and mesh.backend == "nccl", mesh, batches)
    elif route == "cd_grads_wide":  # the W-blocked kernel's DP mode
        slot_bytes = wide_factor_size(local_cfg)
        gathered = torch.zeros(ndev * slot_bytes, dtype=torch.uint8, device=dev)
        mine = gathered[rank * slot_bytes:(rank + 1) * slot_bytes]
        n_valid = min(local_b, max(0, B - rank * local_b))
        wide_step = cd_wide_step if pallas_step else cd_wide_step_plain
        wide_update = cd_wide_update if pallas_step else cd_wide_update_plain

        def exchange(params, velocity, chain, j, u, seed, epoch, i):
            _, new_chain = wide_step(local_cfg, params, my[j], chain, seed=seed, uniforms=u,
                                     n_valid=n_valid, norm=norm, out=mine)
            gather_factors(gathered, mine, mesh)
            return (*wide_update(cfg, params, velocity, batches[j, :B], gathered, ndev, scale,
                                 epoch), new_chain)
    else:
        flat = torch.empty(flat_size(cfg), dtype=torch.float32, device=dev)
        kernel_step = cd_grads_resident_step if route == "cd_grads_resident" else cd_grads_step
        step = kernel_step if pallas_step else cd_grads_step_plain
        update = cd_update if pallas_step else cd_update_plain
        pseudo = cfg.error_metric == "pseudo"

        def exchange(params, velocity, chain, j, u, seed, epoch, i):
            _, new_chain, _ = step(local_cfg, params, my[j], chain, seed=seed, uniforms=u,
                                   mask=mask, norm=norm, out=flat,
                                   pseudo_bit=(epoch * nb + i) % V if pseudo else None)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            return (*update(cfg, params, velocity, flat, scale, epoch), new_chain)
    errs: List[torch.Tensor] = []
    if epoch_steps is not None:
        tab, mom = (t.to(dev) for t in epoch_tables(cfg, order, seeds, rank, state.epoch))
        errs = [epoch_steps.run(tab[e], mom[e:e + 1]) for e in range(n_epochs)]
        chain = epoch_steps.chain
    else:
        for e in range(n_epochs):
            epoch = state.epoch + e
            step_errs = []
            for i, j in enumerate(order[e]):
                u = None if uniforms is None else {name: x[e, i] for name, x in uniforms.items()}
                seed = None if seeds is None else fold_in(seeds[e][i], rank)
                params, velocity, err, chain = exchange(params, velocity, chain, j, u, seed,
                                                        epoch, i)
                step_errs.append(err)
            errs.append(torch.stack(step_errs).mean())
    new_chain = (_gather_chain(cfg, chain, mesh, local_b).to(state.chain_h.dtype)
                 if persistent else state.chain_h)
    return (TrainState(params, velocity, new_chain, state.generator, state.epoch + n_epochs),
            torch.stack(errs))


# -- the phase-2 trainers under a mesh -------------------------------------------
#
# The reference places a fine-tuning epoch on its mesh by GSPMD
# (``mdbn_tpu/parallel/dp.py::dp_put_finetune``): the minibatch's row dim
# sharded over the mesh's first axis, the parameters replicated (over tp too),
# the same math as one device. Here each rank takes its rows of every
# minibatch by its dp coordinate (``finetune_rows``), computes its rows' sums
# of the gradients or statistics, and one all-reduce over its dp column
# (``all_reduce_sums``) gives every rank the whole minibatch's sums before the
# same update; the tp replicas of a dp row hold the same rows and sums. The
# trainers (``train/finetune.py``, ``autoencoder.py``, ``labeled.py``,
# ``updown.py``) call these.


def finetune_rows(mesh: Optional[Mesh], rows: int) -> slice:
    """This rank's rows of a fine-tuning minibatch of ``rows`` rows, by its dp
    coordinate. As in the reference, when the mesh's dp width does not divide
    ``rows`` a 1-D mesh splits the minibatch over its first g ranks, g the
    largest divisor of ``rows`` not above the mesh's size (the ranks past g
    hold no rows; they still take part in every all-reduce, with zero sums),
    and a dp x tp mesh raises."""
    if mesh is None or mesh.dp == 1:
        return slice(0, rows)
    if rows % mesh.dp and mesh.tp > 1:
        raise ValueError(f"fine-tuning batch rows ({rows}) not divisible by the mesh's dp "
                         f"width ({mesh.dp}); pick a batch_size divisible by the mesh or a "
                         "1-D mesh (which degrades to a compatible subset of its ranks)")
    g = max(d for d in range(1, min(rows, mesh.dp) + 1) if rows % d == 0)
    per = rows // g
    if mesh.dp_rank >= g:
        return slice(rows, rows)
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def all_reduce_sums(tensors: List[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of this rank's dp column (over the
    whole mesh when it is 1-D), through one all-reduce of a flat float32
    buffer; the tensors as they are without a dp width of more than one."""
    if mesh is None or mesh.dp == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.dp_group)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].view(t.shape).to(t.dtype))
        lo += t.numel()
    return out

"""The device meshes: one process per rank, joined by torch.distributed.

Port of ``mdbn_tpu/parallel/mesh.py``: ``make_mesh`` (a 1-D data-parallel
mesh) and ``make_mesh_2d`` (a dp x tp grid: minibatch rows over dp, the
hidden units of W over tp). On the TPU a mesh is a set of devices driven by
one program; here it is a process group with one rank per process, and its
collectives are torch.distributed's (NCCL between cards, gloo on the CPU or
between ranks that share a card). A 2-D mesh lays its ranks out row-major,
as the reference's ``reshape(dp, tp)``: rank r sits at (r // tp, r % tp), so
a tp group is a run of adjacent ranks; each rank holds a process group for
its tp row and one for its dp column. ``interpret_safe_ndev`` (a
TPU-interpreter workaround) has no counterpart, and neither has the mesh's
axis names: a process group has no named axis.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclass(frozen=True)
class Mesh:
    """A mesh as one rank sees it: a 1-D data-parallel mesh (the default
    process group; ``tp`` 1), or a dp x tp grid (``make_mesh_2d``) whose
    ``dp_group`` holds this rank's dp column and ``tp_group`` its tp row.
    ``dp_group`` None is the default group."""

    rank: int
    size: int
    device: torch.device  # this rank's device
    backend: str  # "nccl" or "gloo"
    tp: int = 1  # the grid's tp width (1: a 1-D mesh)
    dp_group: Any = field(default=None, compare=False, repr=False)
    tp_group: Any = field(default=None, compare=False, repr=False)

    @property
    def dp(self) -> int:
        """The grid's dp width: the ranks a minibatch's rows split over."""
        return self.size // self.tp

    @property
    def dp_rank(self) -> int:
        """This rank's coordinate along dp (its row of the grid)."""
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        """This rank's coordinate along tp (its column of the grid)."""
        return self.rank % self.tp


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
              device: Optional[torch.device | str] = None) -> Mesh:
    """This rank's view of a data-parallel mesh of ``n_devices`` ranks.

    Joins the default process group when one exists, or starts it from the
    ``torchrun`` environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); a
    mesh of one rank outside ``torchrun`` starts a group of its own on a free
    localhost port. The rank's device is card ``LOCAL_RANK`` modulo the card
    count; without a card it raises, unless ``device`` asks for the CPU
    ("cpu"). ``backend`` defaults to "gloo" on the CPU
    and "nccl" when every rank has a card of its own; ranks that share one
    card must ask for "gloo" (NCCL refuses two ranks on one device)."""
    if dist.is_initialized():
        size = dist.get_world_size()
    elif all(name in os.environ for name in TORCHRUN_ENV):
        size = int(os.environ["WORLD_SIZE"])
    elif n_devices in (None, 1):
        size = 1
    else:
        raise RuntimeError(
            f"a data-parallel mesh of {n_devices} ranks needs one process per rank: "
            f"launch with `torchrun --nproc-per-node {n_devices} ...`, or call "
            "torch.distributed.init_process_group in each rank first")
    if n_devices is not None and n_devices != size:
        raise ValueError(f"asked for a mesh of {n_devices} ranks, the process group has {size}")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    cards = 0 if on_cpu else torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not on_cpu and cards == 0:
        raise RuntimeError("no CUDA device found; a mesh's ranks run on the card unless "
                           "asked for the CPU: pass device=\"cpu\" (or --device cpu to the CLI)")
    if backend is None:
        if on_cpu:
            backend = "gloo"
        elif cards >= size:
            backend = "nccl"
        else:
            raise ValueError(f"{size} ranks share {cards} card(s): NCCL refuses two ranks on "
                             "one device; pass backend='gloo'")
    if backend == "nccl" and cards < size:
        raise ValueError(f"backend 'nccl' needs a card per rank: {size} ranks, {cards} "
                         "card(s); ranks that share a card take backend='gloo'")
    if not dist.is_initialized():
        if size == 1 and not all(name in os.environ for name in TORCHRUN_ENV):
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    rank=0, world_size=1)
        else:
            dist.init_process_group(backend, init_method="env://")
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, asked for {backend!r}")
    rank = dist.get_rank()
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cpu") if on_cpu else torch.device("cuda", local % cards)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    return Mesh(rank=rank, size=size, device=dev, backend=backend)


def make_mesh_2d(dp: int, tp: int, backend: Optional[str] = None,
                 device: Optional[torch.device | str] = None) -> Mesh:
    """This rank's view of a dp x tp mesh of ``dp * tp`` ranks (the
    reference's batch data-parallel x tensor-parallel grid, W sharded over
    the hidden units for very wide layers). The world is joined or started
    as by ``make_mesh(dp * tp, backend, device)``, whose rules pick the
    backend and the device. Every rank then creates one process group for
    each tp row (ranks ``i * tp .. i * tp + tp - 1``) and one for each dp
    column (ranks ``j, j + tp, ...``), all in the same order, and keeps its
    own two. ``tp == 1`` gives ``make_mesh(dp)`` itself."""
    if dp < 1 or tp < 1:
        raise ValueError(f"a dp x tp mesh needs dp, tp >= 1, got {dp} x {tp}")
    world = make_mesh(dp * tp, backend=backend, device=device)
    if tp == 1:
        return world
    rows = [dist.new_group([i * tp + j for j in range(tp)]) for i in range(dp)]
    cols = [dist.new_group([i * tp + j for i in range(dp)]) for j in range(tp)]
    return Mesh(rank=world.rank, size=world.size, device=world.device, backend=world.backend,
                tp=tp, dp_group=cols[world.rank % tp], tp_group=rows[world.rank // tp])

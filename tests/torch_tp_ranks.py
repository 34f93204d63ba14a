"""The rank side of tests/test_torch_tp.py: one process per rank of a gloo
world on the CPU. Imports no JAX. ``fork_world``, started by
torch.multiprocessing.spawn, imports torch and the port once and forks the
world's ranks from there (a rank's start is what costs, not its cases); the
world runs every case of its mesh shapes and each rank writes
``<out>/rank<r>.pt`` for the parent to hold against the single-device run
and the JAX replay."""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def _state(st) -> dict:
    return {"params": st.params.as_dict(), "velocity": st.velocity.as_dict(),
            "chain": st.chain_h}


def _train(cfg, data, mesh, uniforms=None, each_epoch=False) -> dict:
    """``train_rbm`` over ``mesh`` on the CPU (the injected ``uniforms`` in
    the single-device inject layout); with ``each_epoch`` one call an epoch,
    keeping the state after each."""
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.train.trainer import train_rbm

    st = init_train_state(cfg, device="cpu")
    calls = ([(e, e + 1) for e in range(cfg.epochs)] if each_epoch else [(0, cfg.epochs)])
    states, errs, metrics = [], [], None
    for lo, hi in calls:
        u = None if uniforms is None else {k: x[lo:hi] for k, x in uniforms.items()}
        st, metrics = train_rbm(data, cfg.replace(epochs=hi - lo), state=st, mesh=mesh,
                                uniforms=u)
        states.append(_state(st))
        errs += metrics.errors
    return {**states[-1], "errs": torch.tensor(errs), "states": states, "epoch": st.epoch,
            "engine": metrics.engine, "kernel": metrics.kernel}


def _api(cfg, data, mesh, out: str, rank: int) -> dict:
    """RBM.train and DBN.train with the mesh, per epoch (checkpoints every
    epoch, a callback) with a metrics file; rank 0 alone writes."""
    from mdbn_tpu_torch import DBN, RBM
    from mdbn_tpu_torch.config import DBNConfig, TrainRuntimeConfig

    rt = TrainRuntimeConfig(metrics_path=os.path.join(out, f"metrics{rank}.jsonl"),
                            checkpoint_dir=os.path.join(out, f"ck{rank}"),
                            checkpoint_every_epochs=1)
    seen = []
    rbm = RBM(cfg, device="cpu").train(data, mesh=mesh, runtime=rt,
                                       epoch_callback=lambda ep, err, st: seen.append(ep))
    dbn = DBN(DBNConfig(layer_sizes=[12, 6], epochs=2, batch_size=cfg.batch_size, lr=0.1),
              device="cpu").train(data, mesh=mesh)
    return {"engine": rbm.metrics.engine, "kernel": rbm.metrics.kernel, "W": rbm.params.W,
            "history": rbm.history, "callbacks": seen,
            "dbn": [layer.params.W for layer in dbn.layers],
            "dbn_engines": [layer.metrics.engine for layer in dbn.layers],
            "dbn_codes": dbn.transform(data)}


def run_world(rank: int, world: int, port: int, out: str, jobs: dict) -> None:
    """Runs ``jobs`` {name: (kind, args)} in this rank of a gloo world of
    ``world`` ranks: "train" (``_train`` on the 2-D mesh of args["mesh"]),
    "timed" (the same through ``train_rbm_tp`` with a ``CollectiveTimer``),
    "one_d" (the same config on make_mesh_2d(world, 1) and on
    make_mesh(world)), "api" (``_api``), "finetune" (the phase-2 trainers
    args["names"] of tests/torch_dp_ranks.py on the mesh, and the refusal of
    rows the dp width does not divide); writes ``<out>/rank<r>.pt``."""
    from torch_dp_ranks import finetune_runs

    from mdbn_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        meshes, res = {}, {}

        def mesh_of(shape):
            if shape not in meshes:
                meshes[shape] = make_mesh_2d(*shape, backend="gloo", device="cpu")
            return meshes[shape]

        for name, (kind, args) in jobs.items():
            if kind == "train":
                mesh = mesh_of(args["mesh"])
                res[name] = _train(args["cfg"], args["data"], mesh, args.get("uniforms"),
                                   args.get("each_epoch", False))
                res[name]["mesh"] = (mesh.rank, mesh.size, mesh.dp, mesh.tp, mesh.dp_rank,
                                     mesh.tp_rank, str(mesh.device), mesh.backend)
            elif kind == "one_d":
                flat = make_mesh_2d(world, 1, backend="gloo", device="cpu")
                res[name] = {"is_1d": flat.tp == 1 and flat == make_mesh(world, "gloo", "cpu"),
                             "2d": _train(args["cfg"], args["data"], flat),
                             "1d": _train(args["cfg"], args["data"],
                                          make_mesh(world, backend="gloo", device="cpu"))}
            elif kind == "timed":  # the "train" job's run, its collectives timed
                from mdbn_tpu_torch.core.state import init_train_state
                from mdbn_tpu_torch.parallel.tp import CollectiveTimer, train_rbm_tp

                cfg, timer = args["cfg"], CollectiveTimer(torch.device("cpu"))
                st, errs = train_rbm_tp(init_train_state(cfg, device="cpu"),
                                        torch.as_tensor(args["data"]), cfg,
                                        mesh_of(args["mesh"]), cfg.epochs,
                                        uniforms=args["uniforms"], timer=timer)
                res[name] = {**_state(st), "errs": errs, "calls": timer.calls,
                             "seconds": timer.seconds}
            elif kind == "api":
                res[name] = _api(args["cfg"], args["data"], mesh_of(args["mesh"]), out, rank)
            elif kind == "finetune":
                mesh = mesh_of(args["mesh"])
                refusal = None
                try:
                    finetune_runs(mesh, args["odd_batch"], args["names"])
                except ValueError as e:
                    refusal = str(e)
                res[name] = {"runs": finetune_runs(mesh, args["batch"], args["names"]),
                             "refusal": refusal}
            else:
                raise ValueError(kind)
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def fork_world(_, world: int, port: int, out: str, jobs: dict) -> None:
    """Imports what the ranks run, then forks the ``world`` ranks of
    ``run_world`` (they share the imports; the parent starts this process
    with one BLAS and OpenMP thread, so it forks with one thread), writes
    their pids to ``<out>/pids`` and waits for them; a rank that fails
    raises here."""
    import torch.multiprocessing as mp

    import mdbn_tpu_torch.models.dbn  # noqa: F401
    import mdbn_tpu_torch.train.trainer  # noqa: F401
    import torch_dp_ranks  # noqa: F401

    ctx = mp.start_processes(run_world, args=(world, port, out, jobs), nprocs=world,
                             join=False, start_method="fork")
    with open(os.path.join(out, "pids"), "w") as f:
        f.write(" ".join(str(p.pid) for p in ctx.processes))
    while not ctx.join(timeout=1.0):
        pass

"""The rank side of tests/test_torch_dp.py: one process per rank of a gloo
group on the CPU, started by torch.multiprocessing.spawn. Imports no JAX, so
a rank starts in about a second; each writes what it computed to
``<out>/rank<r>.pt`` for the parent to hold against the JAX replay."""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def run_rank(rank: int, world: int, port: int, out: str, cfg, data, uniforms,
             n_epochs: int, pallas_steps, api: bool, each_epoch: bool = False,
             wide_dp_min_visible=None) -> None:
    """Trains ``cfg`` on ``data`` over the group, once per flag of
    ``pallas_steps`` (``train_rbm_shard_map``, the injected per-rank
    ``uniforms``); with ``each_epoch``, one call per epoch, keeping the state
    after each (for a comparison one update at a time: one minibatch per
    epoch); with ``api``, also ``RBM.train`` with a mesh, per epoch
    (checkpoints every epoch, a callback), with a metrics file: rank 0 alone
    writes the files. ``wide_dp_min_visible``, when given, replaces
    ``ops.cd_epoch_cuda.WIDE_DP_MIN_VISIBLE`` in this process (the W-blocked
    DP route at test widths)."""
    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.config import TrainRuntimeConfig
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    if wide_dp_min_visible is not None:
        from mdbn_tpu_torch.ops import cd_epoch_cuda

        cd_epoch_cuda.WIDE_DP_MIN_VISIBLE = wide_dp_min_visible
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(world, backend="gloo")
        res = {"mesh": (mesh.rank, mesh.size, str(mesh.device), mesh.backend)}
        for pallas_step in pallas_steps:
            st, states = init_train_state(cfg, device="cpu"), []
            calls = [(e, e + 1) for e in range(n_epochs)] if each_epoch else [(0, n_epochs)]
            errs = []
            for lo, hi in calls:
                st, err = train_rbm_shard_map(
                    st, torch.as_tensor(data), cfg, mesh, hi - lo, pallas_step=pallas_step,
                    uniforms={k: u[lo:hi] for k, u in uniforms.items()})
                errs.append(err)
                states.append({"params": st.params.as_dict(), "velocity": st.velocity.as_dict(),
                               "chain": st.chain_h})
            res[pallas_step] = {**states[-1], "errs": torch.cat(errs), "epoch": st.epoch,
                                "states": states}
        if api:
            rt = TrainRuntimeConfig(metrics_path=os.path.join(out, f"metrics{rank}.jsonl"),
                                    checkpoint_dir=os.path.join(out, f"ck{rank}"),
                                    checkpoint_every_epochs=1)
            seen = []
            rbm = RBM(cfg.replace(epochs=n_epochs), device="cpu").train(
                data, mesh=mesh, runtime=rt, epoch_callback=lambda ep, err, st: seen.append(ep))
            res["api"] = {"engine": rbm.metrics.engine, "kernel": rbm.metrics.kernel,
                          "W": rbm.params.W,
                          "history": rbm.history, "callbacks": seen}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()

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
        mesh = make_mesh(world, backend="gloo", device="cpu")
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


def finetune_runs(mesh, batch_size: int, names=None) -> dict:
    """Every phase-2 trainer (``mdbn_tpu_torch/train/{finetune,autoencoder,
    labeled,updown}.py``) on fixed weights and data made from a seed, each
    with its own seeded generator, under ``mesh`` (None: one device); only
    those in ``names`` when given. Each rank of a mesh takes its rows of
    every minibatch and draws the whole minibatch's values, so the results
    must equal the single-device run's."""
    import numpy as np

    from mdbn_tpu_torch.config import DBNConfig, RBMConfig
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.train import autoencoder, finetune, labeled, updown

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731

    def params(V, H):
        return RBMParams(W=f32(rng.normal(0, 0.5, (V, H))), b=f32(rng.normal(0, 0.3, V)),
                         c=f32(rng.normal(0, 0.3, H)))

    def stack(sizes, visible):
        cfg = DBNConfig(layer_sizes=list(sizes[1:]), visible=visible, batch_size=batch_size)
        return [(params(v, h), cfg.rbm_config(l, v))
                for l, (v, h) in enumerate(zip(sizes, sizes[1:]))]

    n = 3 * batch_size
    layers = stack((12, 8, 6), "bernoulli")
    x = (rng.random((n, 12)) < 0.4).astype(np.float32)
    y = rng.integers(0, 3, n)
    y_semi = np.where(rng.random(n) < 0.5, -1, y)
    towers = {"ge": stack((12, 8, 6), "gaussian"), "meth": stack((10, 5), "gaussian")}
    joint = (params(11, 7), RBMConfig(n_visible=11, n_hidden=7, batch_size=batch_size))
    mods = {"ge": rng.normal(size=(n, 12)).astype(np.float32),
            "meth": rng.normal(size=(n, 10)).astype(np.float32)}
    kw = dict(epochs=2, batch_size=batch_size, mesh=mesh)
    p97, p108 = params(9, 7), params(10, 8)  # drawn whatever runs, so the seeds stay put
    runs = {
        "classifier": lambda: finetune.finetune_stack(layers, x, y, 3, seed=1, **kw),
        "autoencoder": lambda: autoencoder.finetune_autoencoder_stack(layers, x, **kw),
        "label_top": lambda: labeled.fit_label_top(layers, x, y_semi, 3, n_hidden=9, k=2,
                                                   momentum=0.5, seed=2, **kw),
        "updown": lambda: updown.finetune_updown_stack(layers, x, lr=0.05, seed=3, **kw),
        "updown_labeled": lambda: updown.finetune_updown_labeled(layers, p97, x, y_semi, 3,
                                                                 lr=0.05, seed=4, **kw),
        "classifier_mdbn": lambda: finetune.finetune_mdbn(towers, joint, mods, y, 3, seed=5,
                                                          **kw),
        "autoencoder_mdbn": lambda: autoencoder.finetune_autoencoder_mdbn(towers, joint, mods,
                                                                          **kw),
        "updown_mdbn": lambda: updown.finetune_updown_mdbn(towers, joint, mods, lr=0.05, seed=6,
                                                           **kw),
        "updown_mdbn_labeled": lambda: updown.finetune_updown_mdbn_labeled(
            towers, joint, p108, mods, y_semi, 3, lr=0.05, seed=7, **kw),
    }
    return {name: _flat(run()) for name, run in runs.items() if names is None or name in names}


def _flat(obj) -> list:
    """The tensors and floats of a trainer's result, in a fixed order."""
    from mdbn_tpu_torch.core.rbm_math import RBMParams

    if isinstance(obj, RBMParams):
        return list(obj.as_dict().values())
    if isinstance(obj, dict):
        return [x for k in obj for x in _flat(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [x for o in obj for x in _flat(o)]
    return [obj]


def run_finetune_rank(rank: int, world: int, port: int, out: str, batch_sizes) -> None:
    """``finetune_runs`` at each of ``batch_sizes`` on a mesh of ``world``
    gloo ranks; writes ``<out>/finetune<r>.pt``."""
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(world, backend="gloo", device="cpu")
        torch.save({b: finetune_runs(mesh, b) for b in batch_sizes},
                   os.path.join(out, f"finetune{rank}.pt"))
    finally:
        dist.destroy_process_group()

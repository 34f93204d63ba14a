"""Tensor-parallel training of mdbn_tpu_torch over dp x tp meshes, against the
port's single-device eager run and the JAX package.

Two gloo worlds on the CPU, one process a rank (torch.multiprocessing.spawn;
the rank side is tests/torch_tp_ranks.py), each started once for all the
cases of its mesh shapes, each with a time limit of its own:

- 8 ranks: the reference's two tests (tests/test_distributed.py:122-151), a
  Gaussian 256x128 RBM on a 2x4 mesh and a Bernoulli one on 1x8, each
  against the single-device eager run at rtol 1e-4 / atol 1e-5 on W and the
  errors (the draws are the same; only the order of the sums differs);
- 4 ranks, a 2x2 mesh: each estimator mode on injected draws against the
  JAX package's single-device host replay on the global batch at DP_TOL
  (bf16 storage one update at a time, to one bf16 ulp); H not divisible by
  tp with B not divisible by dp; make_mesh_2d(4, 1) against make_mesh(4);
  RBM.train and DBN.train with the mesh; the phase-2 trainers against their
  single-device run, and their refusal of rows dp does not divide.

On every case the ranks end with the same whole state, and inside a run the
dp replicas of each shard and the replicated b and z hold the same bits
(``parallel/tp.py::_gather_state`` raises otherwise).

CPU only.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from test_torch_dp import DP_TOL, both, close, draws
from test_torch_dp_modes import bf16, jax_step_bf16, within_bf16_ulp

from mdbn_tpu.core import rbm_math as J
from mdbn_tpu_torch.config import RBMConfig
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.data.synthetic import mnist_like
from mdbn_tpu_torch.parallel.mesh import Mesh, _free_port
from mdbn_tpu_torch.parallel.tp import tp_columns
from mdbn_tpu_torch.train.trainer import resolve_dp_engine, train_rbm

REF_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_distributed.py:140-151
FT_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_torch_finetune.py:42
# the phase-2 trainers run on the 2x2 mesh: one all-reduce of autograd's
# gradients a step, of CD statistics, and up-down's two
FT_NAMES = ("classifier", "label_top", "updown")
WORLD_LIMIT_S = 120.0
SMALL = dict(n_visible=32, n_hidden=16, lr=0.1)

# the reference's two tests: (config, data, mesh)
REF_CASES = {
    "gaussian-2x4": (dict(n_visible=256, n_hidden=128, visible="gaussian", lr=0.005, k=1,
                          epochs=3, batch_size=16, seed=0, engine="xla"),
                     lambda: np.random.default_rng(5).standard_normal((160, 256))
                     .astype(np.float32), (2, 4)),
    "bernoulli-1x8": (dict(n_visible=256, n_hidden=128, lr=0.1, epochs=2, batch_size=16, seed=0,
                           engine="xla"),
                      lambda: (np.random.default_rng(6).random((128, 256)) < 0.4)
                      .astype(np.float32), (1, 8)),
}

# each estimator mode on a 2x2 mesh: (config fields, epochs, minibatches an
# epoch); "bf16" is held one update at a time
MODE_CASES = {
    "cd": (dict(SMALL, batch_size=20, momentum=0.5, l2=1e-3), 2, 2),
    "pcd-k2-momentum": (dict(SMALL, batch_size=20, persistent=True, k=2, momentum=0.5), 2, 2),
    "pt3": (dict(SMALL, batch_size=20, persistent=True, pt_temps=3, pt_beta_min=0.3,
                 momentum=0.5), 2, 2),
    "lv": (dict(SMALL, batch_size=20, visible="gaussian", learn_variance=True, lr=0.01,
                momentum=0.5, lr_variance=0.005), 2, 2),
    "enhanced": (dict(SMALL, batch_size=20, gradient="enhanced", persistent=True, k=2,
                      sparsity_target=0.1, sparsity_cost=0.5, momentum=0.5), 2, 2),
    "pseudo": (dict(SMALL, batch_size=20, error_metric="pseudo", momentum=0.5, l2=1e-3), 2, 2),
    "bf16": (dict(SMALL, batch_size=20, visible="gaussian", lr=0.01, momentum=0.5,
                  param_dtype="bfloat16", compute_dtype="bfloat16"), 3, 1),
    # H 15 over tp 2 (8 + 7 units), B 5 over dp 2 (3 rows + 2 with one pad row)
    "uneven-pcd": (dict(SMALL, n_hidden=15, batch_size=5, persistent=True, k=2, momentum=0.5),
                   2, 2),
    "uneven-pt3": (dict(SMALL, n_hidden=15, batch_size=5, persistent=True, pt_temps=3,
                        pt_beta_min=0.3), 2, 2),
}
UNEVEN = ("uneven-pcd", "uneven-pt3")


def mode_inputs(name):
    """(config fields, data, per-step global draws [E][nb] in the draws()
    layout) of a mode case, from numpy seeds."""
    kw, E, nb = MODE_CASES[name]
    jc, _ = both(**kw)
    B = jc.batch_size
    rng = np.random.default_rng(17)
    if jc.visible == "bernoulli":
        data = mnist_like(nb * B, n_features=jc.n_visible, seed=3)
    else:
        data = rng.standard_normal((nb * B, jc.n_visible)).astype(np.float32)
    steps = [[draws(jc, B, rng, pt=jc.pt_temps > 1) for _ in range(nb)] for _ in range(E)]
    return dict(kw, epochs=E), data, steps


def inject_layout(cfg, steps):
    """Per-step draws as train_rbm's inject layout
    (ops.cd_epoch_cuda.draw_uniform_blocks)."""
    M, B = cfg.pt_temps, cfg.batch_size
    out = {}
    for k in steps[0][0]:
        x = np.stack([np.stack([s[k] for s in ep]) for ep in steps])
        if M > 1 and k == "swap":
            x = x.reshape(*x.shape[:2], 2, (M - 1) * B)
        elif M > 1 and k != "h0":
            x = x.reshape(*x.shape[:3], M * B, x.shape[-1])
        out[k] = torch.as_tensor(x)
    return out


def jax_replay(kw, data, steps):
    """The JAX package's single-device host replay on the global batch (the
    recipe of tests/test_torch_dp_modes.py::jax_global_replay, with the
    tempering ladder), from the port's initial state."""
    jc, tc = both(**kw)
    B, V, H, M = jc.batch_size, jc.n_visible, jc.n_hidden, max(jc.pt_temps, 1)
    nb = len(steps[0])
    batches = data[: nb * B].reshape(nb, B, V)
    st = init_train_state(tc, device="cpu")
    params = J.RBMParams(**{k: jnp.asarray(x.numpy()) for k, x in st.params.as_dict().items()})
    vel = J.zero_velocity(params)
    chain = jnp.zeros((M, B, H), jnp.float32)
    errs = []
    for e, ep in enumerate(steps):
        step_errs = []
        for i, u in enumerate(ep):
            v0 = jnp.asarray(batches[i])
            u = {k: jnp.asarray(x) for k, x in u.items()}
            if M > 1:
                grads, ch, err = J.pt_step_stats(params, v0, chain, u, jc)
            else:
                grads, ch, err = J.cd_step_stats(params, v0, chain[0] if jc.persistent else None,
                                                 u, jc)
                ch = ch[None]
            if jc.persistent:
                chain = ch
            if jc.error_metric == "pseudo":
                err = J.pseudo_likelihood(params, v0, (e * nb + i) % V, jc)
            params, vel = J.apply_update(params, vel, grads, jc, epoch=e)
            step_errs.append(float(err))
        errs.append(np.mean(step_errs))
    return params, vel, np.asarray(chain).reshape(M * B, H), np.asarray(errs, np.float32)


def spawn_world(tmp_path, world, jobs):
    """Runs ``jobs`` in a gloo world of ``world`` ranks, one process each
    (forked by one spawned process, tests/torch_tp_ranks.py::fork_world);
    fails, and stops them all, past WORLD_LIMIT_S."""
    from torch_tp_ranks import fork_world

    # the spawned process starts no BLAS or OpenMP thread pool, so it forks
    # the ranks with one thread
    one = {name: "1" for name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
    saved = {name: os.environ.get(name) for name in one}
    os.environ.update(one)
    try:
        ctx = mp.spawn(fork_world, args=(world, _free_port(), str(tmp_path), jobs), nprocs=1,
                       join=False)
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name)
            else:
                os.environ[name] = value
    deadline = time.monotonic() + WORLD_LIMIT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            pids = tmp_path / "pids"
            for pid in (pids.read_text().split() if pids.exists() else []):
                try:
                    os.kill(int(pid), 9)
                except ProcessLookupError:
                    pass
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {world} ranks did not finish in {WORLD_LIMIT_S} s")
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    jobs = {name: ("train", {"cfg": RBMConfig(**kw), "data": make(), "mesh": shape})
            for name, (kw, make, shape) in REF_CASES.items()}
    return spawn_world(tmp_path_factory.mktemp("world8"), 8, jobs)


API_CFG = dict(n_visible=32, n_hidden=16, batch_size=10, lr=0.1, momentum=0.5, epochs=2)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    jobs = {}
    for name in MODE_CASES:
        kw, data, steps = mode_inputs(name)
        cfg = RBMConfig(**kw)
        jobs[name] = ("train", {"cfg": cfg, "data": data, "mesh": (2, 2),
                                "uniforms": inject_layout(cfg, steps),
                                "each_epoch": name == "bf16"})
    jobs["timed"] = ("timed", dict(jobs["cd"][1]))
    pcd = RBMConfig(**dict(SMALL, batch_size=6, persistent=True, k=2, epochs=2, momentum=0.5))
    jobs["one_d"] = ("one_d", {"cfg": pcd, "data": mnist_like(18, n_features=32, seed=1)})
    jobs["api"] = ("api", {"cfg": RBMConfig(**API_CFG), "mesh": (2, 2),
                           "data": mnist_like(40, n_features=32, seed=2)})
    jobs["finetune"] = ("finetune", {"mesh": (2, 2), "batch": 4, "odd_batch": 5,
                                     "names": FT_NAMES})
    out = tmp_path_factory.mktemp("world4")
    return out, spawn_world(out, 4, jobs)


def same_bits(results, name):
    """Every rank ends a case with the same whole state, errors and engine."""
    r0 = results[0][name]
    for r in results[1:]:
        for part in ("params", "velocity"):
            for k, x in r0[part].items():
                assert torch.equal(r[name][part][k], x), (name, part, k)
        assert torch.equal(r[name]["chain"], r0["chain"]), name
        assert torch.equal(r[name]["errs"], r0["errs"]), name
        assert (r[name]["engine"], r[name]["kernel"]) == ("eager_tp", None)


@pytest.mark.parametrize("name", list(REF_CASES))
def test_reference_tp_meshes_match_single_device(world8, name):
    """tests/test_distributed.py:122-151 on the port: a dp x tp run is the
    single-device eager run of the same config, up to the order of sums."""
    kw, make, (dp, tp) = REF_CASES[name]
    cfg = RBMConfig(**kw)
    single, metrics = train_rbm(make(), cfg, device="cpu")
    assert metrics.engine == "eager"
    same_bits(world8, name)
    got = world8[0][name]
    close(got["params"]["W"], single.params.W, REF_TOL)
    close(got["errs"], metrics.errors, REF_TOL)
    assert got["epoch"] == cfg.epochs
    assert [r[name]["mesh"] for r in world8] == [
        (r, 8, dp, tp, r // tp, r % tp, "cpu", "gloo") for r in range(8)]


@pytest.mark.parametrize("name", list(MODE_CASES))
def test_tp_modes_match_jax_replay(world4, name):
    """Each mode on a 2x2 mesh, injected draws, against the JAX package's
    single-device replay on the global batch: at DP_TOL (the chain exactly),
    bf16 storage one update at a time to one bf16 ulp."""
    _, got = world4
    kw, data, steps = mode_inputs(name)
    jc, tc = both(**kw)
    same_bits(got, name)
    r0 = got[0][name]
    assert r0["epoch"] == jc.epochs
    if name == "bf16":
        prev = {part: getattr(init_train_state(tc, device="cpu"), part).as_dict()
                for part in ("params", "velocity")}
        for e, st in enumerate(r0["states"]):
            u = {k: x[None] for k, x in steps[e][0].items()}
            pj, vj = jax_step_bf16(jc, prev, bf16(data), u, 1, e)
            for k in ("W", "b", "c"):
                assert st["params"][k].dtype == torch.bfloat16
                within_bf16_ulp(st["velocity"][k].float(), getattr(vj, k).astype(jnp.float32))
                within_bf16_ulp(st["params"][k].float(), getattr(pj, k).astype(jnp.float32),
                                st["velocity"][k].float(), getattr(vj, k).astype(jnp.float32))
            prev = st
        return
    params, vel, chain, errs = jax_replay(kw, data, steps)
    for k in ("W", "b", "c", "z"):
        if getattr(params, k) is None:
            assert k not in r0["params"]
            continue
        close(r0["params"][k], getattr(params, k), DP_TOL)
        close(r0["velocity"][k], getattr(vel, k), DP_TOL)
    close(r0["errs"], errs, DP_TOL)
    if jc.persistent:
        close(r0["chain"], chain, dict(rtol=0, atol=0))
    if name in UNEVEN:  # the shapes that exercise the pad rows and the unequal shards
        assert jc.batch_size % 2 and jc.n_hidden % 2


def test_collective_timer(world4):
    """The collectives of a CD-1 run on 2x2, 2 epochs of 2 minibatches, by
    kind: one tp all-reduce a step (the negative phase's visible means), one
    dp all-reduce a step, one gather at the end; timing them changes no bit."""
    _, got = world4
    for r in got:
        timed, plain = r["timed"], r["cd"]
        assert timed["calls"] == {"tp": 4, "dp": 4, "gather": 1}
        assert sorted(timed["seconds"]) == ["dp", "gather", "tp"]
        assert all(t >= 0 for t in timed["seconds"].values())
        for part in ("params", "velocity"):
            for k, x in plain[part].items():
                assert torch.equal(timed[part][k], x), (part, k)
        assert torch.equal(timed["errs"], plain["errs"])


def test_tp1_mesh_is_the_1d_route(world4):
    """make_mesh_2d(n, 1) is make_mesh(n): the 1-D data-parallel route and its
    bits."""
    _, got = world4
    for r in got:
        one = r["one_d"]
        assert one["is_1d"]
        assert one["2d"]["engine"] == one["1d"]["engine"] == "eager_dp"
        for part in ("params", "velocity"):
            for k, x in one["1d"][part].items():
                assert torch.equal(one["2d"][part][k], x), (part, k)
        assert torch.equal(one["2d"]["chain"], one["1d"]["chain"])
        assert torch.equal(one["2d"]["errs"], one["1d"]["errs"])


def test_api_on_a_tp_mesh(world4):
    """RBM.train and DBN.train with a 2x2 mesh: engine eager_tp and no kernel
    on every rank, the same weights everywhere, equal to the single-device
    run; rank 0 alone writes the metrics and the checkpoints."""
    from mdbn_tpu_torch import DBN, RBM
    from mdbn_tpu_torch.config import DBNConfig

    out, got = world4
    data = mnist_like(40, n_features=32, seed=2)
    cfg = RBMConfig(**API_CFG)
    # per-epoch calls, as the ranks' callback and checkpoints make them (each
    # call draws its own seed)
    rbm = RBM(cfg, device="cpu").train(data, epoch_callback=lambda ep, err, st: None)
    dbn = DBN(DBNConfig(layer_sizes=[12, 6], epochs=2, batch_size=10, lr=0.1),
              device="cpu").train(data)
    for g in got:
        a = g["api"]
        assert (a["engine"], a["kernel"]) == ("eager_tp", None)
        assert a["dbn_engines"] == ["eager_tp", "eager_tp"]
        assert a["callbacks"] == [0, 1]  # per-epoch mode
        assert torch.equal(a["W"], got[0]["api"]["W"])
        close(a["W"], rbm.params.W, REF_TOL)
        close(a["history"], rbm.history, REF_TOL)
        for w, layer in zip(a["dbn"], dbn.layers):
            close(w, layer.params.W, REF_TOL)
        close(a["dbn_codes"], dbn.transform(data), REF_TOL)
    recs = [json.loads(line) for line in open(out / "metrics0.jsonl")]
    assert [(x["engine"], x["kernel"]) for x in recs] == [("eager_tp", None)] * 2
    assert sorted(os.listdir(out / "ck0")) == ["epoch00001.pt", "epoch00002.pt"]
    for r in range(1, 4):
        assert not os.path.exists(out / f"metrics{r}.jsonl")
        assert not os.path.exists(out / f"ck{r}") or not os.listdir(out / f"ck{r}")


def test_finetune_on_a_2x2_mesh(world4):
    """The phase-2 trainers on a 2x2 mesh take rows by the dp coordinate and
    sum over the dp column: equal to the single-device run on every rank (the
    tp replicas would double the gradient if they summed too); rows that dp
    does not divide raise, as the reference's multi-axis meshes do."""
    from torch_dp_ranks import finetune_runs

    _, got = world4
    want = finetune_runs(None, 4, FT_NAMES)
    for r, g in enumerate(got):
        ft = g["finetune"]
        assert ft["refusal"] is not None and "not divisible" in ft["refusal"]
        assert list(ft["runs"]) == list(want)
        for name in want:
            assert len(ft["runs"][name]) == len(want[name]), name
            for a, b in zip(ft["runs"][name], want[name]):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           err_msg=f"{name} rank {r}", **FT_TOL)


@pytest.mark.parametrize("engine", ["auto", "xla", "pallas"])
def test_tp_engine_selection(engine):
    """A tp mesh takes eager_tp on the CPU and on CUDA under auto and xla;
    pallas raises, as the reference's does (trainer.py:280-283), before any
    collective runs; a dp x 1 mesh keeps the 1-D engines."""
    cfg = RBMConfig(**SMALL, batch_size=4, epochs=1, engine=engine)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    if engine == "pallas":
        for dev in (cpu, cuda):
            with pytest.raises(ValueError, match="dp meshes only"):
                resolve_dp_engine(cfg, dev, tp=2)
        with pytest.raises(ValueError, match="dp meshes only"):
            train_rbm(mnist_like(8, n_features=32, seed=0), cfg, device="cpu",
                      mesh=Mesh(0, 4, cpu, "gloo", tp=2))
        assert resolve_dp_engine(cfg, cuda, tp=1) == "cuda_dp"
        return
    assert resolve_dp_engine(cfg, cpu, tp=2) == resolve_dp_engine(cfg, cuda, tp=4) == "eager_tp"
    assert resolve_dp_engine(cfg, cpu, tp=1) == "eager_dp"


def test_mesh_coordinates_and_columns():
    """Row-major coordinates (rank r at (r // tp, r % tp)) and the balanced
    column split, widths one apart, covering every hidden unit once."""
    mesh = [Mesh(r, 6, torch.device("cpu"), "gloo", tp=3) for r in range(6)]
    assert [(m.dp, m.tp, m.dp_rank, m.tp_rank) for m in mesh] == [
        (2, 3, r // 3, r % 3) for r in range(6)]
    flat = Mesh(2, 4, torch.device("cpu"), "gloo")
    assert (flat.dp, flat.tp, flat.dp_rank, flat.tp_rank) == (4, 1, 2, 0)
    for H, tp in ((16, 2), (15, 2), (400, 4), (500, 3), (7, 7)):
        cols = [tp_columns(H, tp, j) for j in range(tp)]
        widths = [c.stop - c.start for c in cols]
        assert cols[0].start == 0 and cols[-1].stop == H and max(widths) - min(widths) <= 1
        assert all(a.stop == b.start for a, b in zip(cols, cols[1:]))


def test_make_mesh_2d_refusals(monkeypatch):
    from mdbn_tpu_torch.parallel.mesh import make_mesh_2d

    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        make_mesh_2d(2, 2, device="cpu")
    with pytest.raises(ValueError, match="dp, tp >= 1"):
        make_mesh_2d(2, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh_2d(1, 1)

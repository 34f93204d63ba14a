"""The data-parallel training path of mdbn_tpu_torch against the JAX package.

- The port core's masked statistics (``row_mask``, ``norm``) against the JAX
  core at rtol=atol=2e-5 (tests/test_parity_core.py:20: float32 on both
  sides, sums in another order).
- ``cd_grads_step_plain`` (the plain version of ``csrc/cd_grads.cu``'s step
  kernel) against the interpret-mode ``_cd_grads_kernel`` on injected draws
  at rtol 1e-5 / atol 1e-6 (tests/test_pallas_dp.py:450-456), and
  ``cd_update_plain`` (the plain version of its update kernel) against the
  JAX core's ``apply_update``.
- The port's data-parallel run over 2 and 3 gloo ranks (one process each,
  torch.multiprocessing.spawn; the rank side is tests/torch_dp_ranks.py)
  against a replay on the JAX core: per-shard masked statistics with the same
  numpy draws, their mean, then ``apply_update``, at rtol 2e-4 / atol 2e-6
  (the all-reduce sums in another order than the replay's mean, norm = B /
  ndev is not an integer, and the training dynamics carry the differences
  over the steps, as in tests/test_pallas_dp.py).
- A mesh of one rank against the single-device run, and the refusals.

CPU only, seconds each.
"""

import json
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import mdbn_tpu.config as jconfig
from mdbn_tpu.core import rbm_math as J
from mdbn_tpu_torch import RBM
from mdbn_tpu_torch.config import RBMConfig
from mdbn_tpu_torch.convert import convert_config
from mdbn_tpu_torch.core import rbm_math as T
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.data.synthetic import mnist_like
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops import cd_grads_cuda as G
from mdbn_tpu_torch.ops.cd_grads_cuda import cd_grads_step, cd_grads_step_plain
from mdbn_tpu_torch.parallel import dp
from mdbn_tpu_torch.parallel.mesh import Mesh, make_mesh
from mdbn_tpu_torch.train.trainer import resolve_dp_engine, train_rbm

CORE_TOL = dict(rtol=2e-5, atol=2e-5)
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
DP_TOL = dict(rtol=2e-4, atol=2e-6)
CPU, CUDA = torch.device("cpu"), torch.device("cuda")  # CUDA: a device object only


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def both(**kw):
    """(the JAX config, the port's) of the same fields."""
    jc = jconfig.RBMConfig(**kw)
    return jc, convert_config(jc)


def draws(cfg, rows, rng, pt=False):
    """One step's draws in the draw_uniforms (or draw_pt_uniforms) layout."""
    lead = (cfg.k, cfg.pt_temps) if pt else (cfg.k,)
    u = {"h0": rng.random((rows, cfg.n_hidden), np.float32),
         "v": rng.random(lead + (rows, cfg.n_visible), np.float32),
         "h": rng.random(lead + (rows, cfg.n_hidden), np.float32)}
    if cfg.visible == "gaussian" and cfg.resolved_sample_visible:
        u["noise"] = rng.standard_normal(lead + (rows, cfg.n_visible)).astype(np.float32)
    if pt:
        u["swap"] = rng.random((2, cfg.pt_temps - 1, rows), np.float32)
    return u


def params_np(cfg, rng):
    p = {"W": (rng.standard_normal((cfg.n_visible, cfg.n_hidden)) * 0.1).astype(np.float32),
         "b": (rng.standard_normal(cfg.n_visible) * 0.1).astype(np.float32),
         "c": (rng.standard_normal(cfg.n_hidden) * 0.1).astype(np.float32)}
    if cfg.learn_variance:
        p["z"] = (rng.standard_normal(cfg.n_visible) * 0.2).astype(np.float32)
    return p


def visible_data(cfg, rows, rng):
    if cfg.visible == "bernoulli":
        return (rng.random((rows, cfg.n_visible)) < 0.4).astype(np.float32)
    return rng.standard_normal((rows, cfg.n_visible)).astype(np.float32)


def th(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


MASK = np.array([[1.0], [1.0], [1.0], [1.0], [0.0]], np.float32)  # the last row is padding
SMALL = dict(n_visible=32, n_hidden=16, batch_size=5, lr=0.1)
CORE_CASES = {
    "cd1": dict(SMALL),
    "gaussian-sampled-k2": dict(SMALL, visible="gaussian", k=2, sample_visible=True),
    "pcd-k2-sparsity": dict(SMALL, k=2, persistent=True, sparsity_target=0.1,
                            sparsity_cost=0.5),
    "xent": dict(SMALL, error_metric="xent"),
    "lv-meanfield-pcd": dict(SMALL, visible="gaussian", learn_variance=True,
                             sample_visible=False, persistent=True),
    "enhanced": dict(SMALL, gradient="enhanced", k=2),
    "pt3": dict(SMALL, persistent=True, pt_temps=3, pt_beta_min=0.3),
    "pt3-gaussian-lv": dict(SMALL, visible="gaussian", learn_variance=True, persistent=True,
                            pt_temps=3, pt_beta_min=0.4, sample_visible=True),
}


@pytest.mark.parametrize("name", list(CORE_CASES))
def test_masked_stats_match_jax_core(name):
    jc, tc = both(**CORE_CASES[name])
    rng = np.random.default_rng(3)
    p, v0 = params_np(jc, rng), visible_data(jc, 5, rng)
    pt = jc.pt_temps > 1
    u = draws(jc, 5, rng, pt=pt)
    M = max(jc.pt_temps, 1)
    chain = (rng.random((M, 5, jc.n_hidden)) < 0.5).astype(np.float32)
    norm = 2.5
    if pt:
        gj, cj, ej = J.pt_step_stats(J.RBMParams(**p), v0, chain, u, jc,
                                     row_mask=MASK, norm=norm)
        gt, ct, et = T.pt_step_stats(T.RBMParams(**th(p)), torch.as_tensor(v0),
                                     torch.as_tensor(chain), th(u), tc,
                                     row_mask=torch.as_tensor(MASK), norm=norm)
    else:
        ch = chain[0] if jc.persistent else None
        gj, cj, ej = J.cd_step_stats(J.RBMParams(**p), v0, ch, u, jc, row_mask=MASK, norm=norm)
        gt, ct, et = T.cd_step_stats(T.RBMParams(**th(p)), torch.as_tensor(v0),
                                     None if ch is None else torch.as_tensor(ch), th(u), tc,
                                     row_mask=torch.as_tensor(MASK), norm=norm)
    for n in ("W", "b", "c", "z"):
        if getattr(gj, n) is None:
            assert getattr(gt, n) is None
        else:
            close(getattr(gt, n), getattr(gj, n), CORE_TOL)
    close(ct, cj, CORE_TOL)
    close(et, ej, CORE_TOL)


@pytest.mark.parametrize("metric", ["mse", "xent"])
@pytest.mark.parametrize("masked", [False, True])
def test_recon_error_matches_jax_core(metric, masked):
    rng = np.random.default_rng(4)
    v0 = (rng.random((5, 12)) < 0.5).astype(np.float32)
    v1 = rng.random((5, 12)).astype(np.float32)
    mask, norm = (MASK, 2.5) if masked else (None, None)
    close(T.recon_error(torch.as_tensor(v0), torch.as_tensor(v1), metric,
                        None if mask is None else torch.as_tensor(mask), norm),
          J.recon_error(v0, v1, metric, mask, norm), CORE_TOL)


GRADS_CASES = {
    "bernoulli-cd1-masked": (dict(SMALL), True),
    "gaussian-sampled": (dict(SMALL, visible="gaussian", sample_visible=True, k=2), False),
    "pcd-k2-sparsity": (dict(SMALL, k=2, persistent=True, sparsity_target=0.1,
                             sparsity_cost=0.5), True),
    "xent": (dict(SMALL, error_metric="xent"), True),
}


@pytest.mark.parametrize("name", list(GRADS_CASES))
def test_plain_grads_match_interpret_kernel(name):
    """cd_grads_step_plain (and the wrapper, which takes it for CPU tensors)
    against the interpret-mode _cd_grads_kernel on the same draws."""
    from mdbn_tpu.ops.cd_epoch_pallas import make_pallas_grads_fn

    kw, masked = GRADS_CASES[name]
    jc, tc = both(**kw)
    rng = np.random.default_rng(5)
    p, v0, u = params_np(jc, rng), visible_data(jc, 5, rng), draws(jc, 5, rng)
    chain = (rng.random((5, jc.n_hidden)) < 0.5).astype(np.float32)
    norm = 2.5 if masked else None
    fn = make_pallas_grads_fn(jc, interpret=True, inject=True, norm=norm, with_mask=masked)
    gj, cj, ej = fn(jnp.zeros(2, jnp.int32), jnp.asarray(v0), J.RBMParams(**p),
                    jnp.asarray(chain), uniforms={k: jnp.asarray(x) for k, x in u.items()},
                    mask=jnp.asarray(MASK) if masked else None)
    mask = torch.as_tensor(MASK) if masked else None
    for step in (cd_grads_step_plain, cd_grads_step):
        gt, ct, et = step(tc, T.RBMParams(**th(p)), torch.as_tensor(v0), torch.as_tensor(chain),
                          uniforms=th(u), mask=mask, norm=norm)
        for n in ("W", "b", "c"):
            close(getattr(gt, n), getattr(gj, n), KERNEL_TOL)
        close(ct, cj, KERNEL_TOL)
        close(et, ej, KERNEL_TOL)


def test_grads_step_writes_the_flat_buffer():
    """With out=, the step's statistics land in one flat buffer (gW, gb, gc,
    err: the all-reduce's layout) and the returned tensors are its views."""
    _, tc = both(**GRADS_CASES["pcd-k2-sparsity"][0])
    rng = np.random.default_rng(6)
    p, v0, u = params_np(tc, rng), visible_data(tc, 5, rng), draws(tc, 5, rng)
    chain = torch.as_tensor((rng.random((5, tc.n_hidden)) < 0.5).astype(np.float32))
    args = (tc, T.RBMParams(**th(p)), torch.as_tensor(v0), chain)
    kw = dict(uniforms=th(u), mask=torch.as_tensor(MASK), norm=2.5)
    g, c, e = cd_grads_step(*args, **kw)
    flat = torch.full((G.flat_size(tc),), float("nan"))
    gf, cf, ef = cd_grads_step(*args, **kw, out=flat)
    assert flat.numel() == 32 * 16 + 32 + 16 + 1
    torch.testing.assert_close(flat, torch.cat([g.W.reshape(-1), g.b, g.c, e.reshape(1)]),
                               rtol=0, atol=0)
    assert gf.W.data_ptr() == flat.data_ptr() and ef.data_ptr() == flat[-1:].data_ptr()
    assert torch.equal(cf, c)


UPDATE_CASES = {
    "c1-like": dict(SMALL),
    "momentum-schedule-l2": dict(SMALL, momentum=0.9, initial_momentum=0.5,
                                 momentum_switch_epoch=1, l2=1e-2),
    "clip-l2": dict(SMALL, momentum=0.5, l2=1e-3, grad_clip=0.05),
}


@pytest.mark.parametrize("name", list(UPDATE_CASES))
def test_update_plain_matches_jax_apply_update(name):
    """cd_update_plain (the plain version of the update kernel) on summed
    statistics of 3 ranks against the JAX core's apply_update on their mean,
    at epochs 0 and 1 (either side of a momentum switch), at rtol 1e-5 /
    atol 1e-6: the port scales the sums by float32(1/3) where JAX divides by
    3, one rounding apart; the wrapper takes the plain version on the CPU."""
    jc, tc = both(**UPDATE_CASES[name])
    rng = np.random.default_rng(8)
    p, vel = params_np(jc, rng), params_np(jc, rng)
    sums = rng.standard_normal(G.flat_size(tc)).astype(np.float32)
    V, H = jc.n_visible, jc.n_hidden
    g = J.RBMParams(W=sums[:V * H].reshape(V, H) / 3, b=sums[V * H:V * H + V] / 3,
                    c=sums[V * H + V:-1] / 3)
    scale = dp.world_scale(3)
    for epoch in (0, 1):
        pj, vj = J.apply_update(J.RBMParams(**p), J.RBMParams(**vel), g, jc, epoch=epoch)
        for update in (G.cd_update_plain, G.cd_update):
            pt, vt, et = update(tc, T.RBMParams(**th(p)), T.RBMParams(**th(vel)),
                                torch.as_tensor(sums), scale, epoch)
            for n in ("W", "b", "c"):
                close(getattr(pt, n), getattr(pj, n), KERNEL_TOL)
                close(getattr(vt, n), getattr(vj, n), KERNEL_TOL)
            close(et, sums[-1] / 3, KERNEL_TOL)


# every estimator mode and bf16 storage: the DP kernels take them all
MODES = {"pt3": dict(persistent=True, pt_temps=3),
         "learn_variance": dict(visible="gaussian", learn_variance=True),
         "pt3-learn_variance": dict(visible="gaussian", learn_variance=True, persistent=True,
                                    pt_temps=3),
         "enhanced": dict(gradient="enhanced"),
         "pseudo": dict(error_metric="pseudo"),
         "bf16": dict(param_dtype="bfloat16", compute_dtype="bfloat16")}


@pytest.mark.parametrize("mode", list(MODES) + ["Philox"])
def test_grads_kernel_refusals(mode):
    """The DP kernels take every mode (their plain version runs a step of
    each here) and any k: past the 255 Gibbs steps the Philox counter once
    held, the plain step runs, and the kernel's wrapper hands CPU tensors to
    it."""
    base = RBMConfig(**SMALL)
    if mode == "Philox":
        cfg = base.replace(k=300)
        st = init_train_state(base, device="cpu")
        v0 = torch.as_tensor(mnist_like(5, n_features=32, seed=0))
        g, chain, err = cd_grads_step_plain(cfg, st.params, v0, st.chain_h, seed=1)
        assert bool(torch.isfinite(g.W).all()) and bool(torch.isfinite(err))
        g2, chain2, err2 = cd_grads_step(cfg, st.params, v0, st.chain_h, seed=1)
        assert torch.equal(g2.W, g.W) and torch.equal(chain2, chain) and torch.equal(err2, err)
        with pytest.raises(ValueError, match="needs a seed"):
            cd_grads_step_plain(base, st.params, torch.zeros((5, 32)), st.chain_h)
        return
    cfg = base.replace(**MODES[mode])
    st = init_train_state(cfg, device="cpu")
    v0 = torch.as_tensor(mnist_like(5, n_features=32, seed=0)).to(st.params.W.dtype)
    bit = 3 if cfg.error_metric == "pseudo" else None
    flat = torch.zeros(G.flat_size(cfg))
    g, chain, err = cd_grads_step_plain(cfg, st.params, v0, st.chain_h, seed=1, out=flat,
                                        pseudo_bit=bit)
    assert chain.shape == st.chain_h.shape and chain.dtype == st.chain_h.dtype
    assert bool(torch.isfinite(flat).all()) and float(err) == float(flat[-1])
    assert (g.z is not None) == cfg.learn_variance
    if cfg.error_metric == "pseudo":
        with pytest.raises(ValueError, match="pseudo_bit"):
            cd_grads_step_plain(cfg, st.params, v0, st.chain_h, seed=1)


@pytest.mark.parametrize("mode", ["plain"] + list(MODES))
def test_dp_engine_selection_and_refusals(mode):
    """Under a mesh on CUDA, auto and pallas run the DP kernels in every
    mode; xla (and the CPU) the eager path, which takes every mode too;
    pallas on the CPU raises; any k takes the same engine as k 1."""
    base = RBMConfig(**SMALL).replace(**MODES.get(mode, {}))
    assert resolve_dp_engine(base, CPU) == "eager_dp"
    for engine in ("auto", "pallas"):
        assert resolve_dp_engine(base.replace(engine=engine), CUDA) == "cuda_dp"
        assert resolve_dp_engine(base.replace(engine=engine, k=300), CUDA) == "cuda_dp"
    assert resolve_dp_engine(base.replace(engine="xla"), CUDA) == "eager_dp"
    assert resolve_dp_engine(base.replace(engine="xla", k=256), CUDA) == "eager_dp"
    with pytest.raises(ValueError, match="engine='pallas'"):
        resolve_dp_engine(base.replace(engine="pallas"), CPU)
    if mode == "plain":
        with pytest.raises(ValueError, match="engine='pallas'"):
            RBM(base.replace(engine="pallas", epochs=1), device="cpu").train(
                mnist_like(10, n_features=32, seed=0), mesh=Mesh(0, 2, CPU, "gloo"))


def test_mesh_needs_a_process_per_rank(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 3"):
        make_mesh(3)
    with pytest.raises(ValueError, match="backend"):
        make_mesh(1, backend="mpi")
    assert dp.local_batch(RBMConfig(n_visible=4, n_hidden=2, batch_size=20), 3) == (
        7, 20 / 3, True)
    assert dp.local_batch(RBMConfig(n_visible=4, n_hidden=2, batch_size=20), 4) == (5, 5.0, False)
    seeds = {dp.fold_in(s, r) for s in (0, 1, 2 ** 62) for r in range(4)}
    assert len(seeds) == 12 and all(0 <= s < 2 ** 64 for s in seeds)


def test_default_device_is_the_card(monkeypatch):
    from mdbn_tpu_torch.core.state import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: default_device(), lambda: RBM(RBMConfig(n_visible=8, n_hidden=4)),
                 lambda: init_train_state(RBMConfig(n_visible=8, n_hidden=4))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()


@pytest.fixture
def one_rank():
    import torch.distributed as dist

    mesh = make_mesh(1, backend="gloo", device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_mesh_equals_single_device(one_rank):
    """train_rbm_shard_map on a mesh of one rank is the single-device plain run
    on the same draws; train_rbm with that mesh takes the single-device path."""
    assert (one_rank.rank, one_rank.size, one_rank.device.type) == (0, 1, "cpu")
    cfg = RBMConfig(n_visible=32, n_hidden=16, batch_size=6, k=2, persistent=True,
                    momentum=0.5, lr=0.1, shuffle=True, epochs=2)
    data = torch.as_tensor(mnist_like(18, n_features=32, seed=1))
    u = K.draw_uniform_blocks(cfg, torch.Generator().manual_seed(2), 2, 3)
    st0 = init_train_state(cfg, device="cpu")
    st, errs = dp.train_rbm_shard_map(st0, data, cfg, one_rank, 2,
                                      uniforms={k: x[:, :, None] for k, x in u.items()})
    st1 = init_train_state(cfg, device="cpu")
    order = K.batch_order(cfg, 3, 2, st1.generator)
    p, v, chain, errs1 = K.cd_train_run_plain(cfg, st1.params, st1.velocity, st1.chain_h,
                                              data, order, 0, u)
    for a, b in ((st.params.W, p.W), (st.params.b, p.b), (st.params.c, p.c),
                 (st.velocity.W, v.W), (st.chain_h, chain), (errs, errs1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert st.epoch == 2
    state, metrics = train_rbm(data, cfg, mesh=one_rank, device="cpu")
    assert metrics.engine == "eager"


# ---------------------------------------------------------------------------
# ranks in processes of their own, held against the JAX-core replay

def jax_replay(kw, data, uniforms, ndev, n_epochs):
    """The DP run rebuilt on the JAX core: each shard's masked statistics on
    its draws, their mean over the shards, then apply_update; from the port's
    initial state (its W comes from a seeded torch.Generator)."""
    jc, tc = both(**kw)
    B, V, H = jc.batch_size, jc.n_visible, jc.n_hidden
    lb = -(-B // ndev)
    norm, local = B / ndev, jc.replace(batch_size=lb)
    nb = data.shape[0] // B
    batches = np.pad(data[: nb * B].reshape(nb, B, V), ((0, 0), (0, lb * ndev - B), (0, 0)))
    st = init_train_state(tc, device="cpu")
    params = J.RBMParams(**{k: jnp.asarray(x.numpy()) for k, x in st.params.as_dict().items()})
    vel = J.zero_velocity(params)
    M = max(jc.pt_temps, 1)
    chains = [jnp.zeros((M, lb, H), jnp.float32) for _ in range(ndev)]
    errs = []
    for e in range(n_epochs):
        step_errs = []
        for i in range(nb):
            gs, es = [], []
            for d in range(ndev):
                v0 = jnp.asarray(batches[i, d * lb:(d + 1) * lb])
                mask = None
                if lb * ndev != B:
                    mask = jnp.asarray((np.arange(d * lb, (d + 1) * lb) < B)
                                       .astype(np.float32))[:, None]
                u = {k: jnp.asarray(x[e, i, d]) for k, x in uniforms.items()}
                if M > 1:
                    g, chains[d], err = J.pt_step_stats(params, v0, chains[d], u, local,
                                                        row_mask=mask, norm=norm)
                else:
                    g, ch, err = J.cd_step_stats(params, v0, chains[d][0] if jc.persistent
                                                 else None, u, local, row_mask=mask, norm=norm)
                    if jc.persistent:
                        chains[d] = ch[None]
                gs.append(g)
                es.append(float(err))
            grads = J.RBMParams(*[None if getattr(gs[0], n) is None else
                                  sum(getattr(g, n) for g in gs) / ndev
                                  for n in ("W", "b", "c", "z")])
            params, vel = J.apply_update(params, vel, grads, jc, epoch=e)
            step_errs.append(np.mean(es))
        errs.append(np.mean(step_errs))
    chain = np.concatenate([np.asarray(c) for c in chains], axis=1)[:, :B].reshape(M * B, H)
    return params, vel, chain, np.asarray(errs, np.float32)


def spawn_ranks(tmp_path, ndev, tc, data, uniforms, n_epochs, pallas_steps, api=False,
                limit_s=120.0, each_epoch=False, wide_dp_min_visible=None):
    """Runs the ranks, one process each; fails (and stops them) past limit_s."""
    from torch_dp_ranks import run_rank

    from mdbn_tpu_torch.parallel.mesh import _free_port

    ctx = mp.spawn(run_rank, args=(ndev, _free_port(), str(tmp_path), tc, data, uniforms,
                                   n_epochs, pallas_steps, api, each_epoch,
                                   wide_dp_min_visible), nprocs=ndev, join=False)
    deadline = time.monotonic() + limit_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {limit_s} s")
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(ndev)]


DP_CASES = {
    # 2 ranks, batch 5: local_b 3, one pad row; the kernel path (its plain
    # version on the CPU) and the core path, and RBM.train with the mesh
    "cd-2ranks": (dict(n_visible=32, n_hidden=16, batch_size=5, lr=0.1, momentum=0.5,
                       l2=1e-3), 2, 15, (True, False), True),
    # 3 ranks, batch 20: local_b 7, one pad row (c1's split over 3 ranks)
    "pcd-k2-3ranks": (dict(n_visible=48, n_hidden=16, batch_size=20, lr=0.1, k=2,
                           persistent=True, sparsity_target=0.1, sparsity_cost=0.5), 3, 40,
                      (True,), False),
    # tempering on the core: each rank carries its rows' whole ladders
    "pt3-2ranks": (dict(n_visible=32, n_hidden=16, batch_size=5, lr=0.05, persistent=True,
                        pt_temps=3, pt_beta_min=0.3, momentum=0.5), 2, 15, (False,), False),
}


@pytest.mark.parametrize("name", list(DP_CASES))
def test_dp_ranks_match_jax_replay(name, tmp_path):
    kw, ndev, n, pallas_steps, api = DP_CASES[name]
    jc, tc = both(**kw)
    lb, E = -(-jc.batch_size // ndev), 2
    rng = np.random.default_rng(7)
    data = mnist_like(n, n_features=jc.n_visible, seed=3)
    nb = n // jc.batch_size
    steps = [[[draws(jc, lb, rng, pt=jc.pt_temps > 1) for _ in range(ndev)]
              for _ in range(nb)] for _ in range(E)]
    uniforms = {k: np.stack([np.stack([np.stack([d[k] for d in s]) for s in ep])
                             for ep in steps]) for k in steps[0][0][0]}
    got = spawn_ranks(tmp_path, ndev, tc, data, uniforms, E, pallas_steps, api)
    params, vel, chain, errs = jax_replay(kw, data, uniforms, ndev, E)
    for flag in pallas_steps:
        r0 = got[0][flag]
        for r in got[1:]:  # every rank holds the same bits
            for part in ("params", "velocity"):
                for k, x in r0[part].items():
                    assert torch.equal(r[flag][part][k], x), (flag, part, k)
            assert torch.equal(r[flag]["chain"], r0["chain"])
            assert torch.equal(r[flag]["errs"], r0["errs"])
        for k in ("W", "b", "c"):
            close(r0["params"][k], getattr(params, k), DP_TOL)
            close(r0["velocity"][k], getattr(vel, k), DP_TOL)
        close(r0["errs"], errs, DP_TOL)
        assert r0["epoch"] == E
        if jc.persistent:
            close(r0["chain"], chain, dict(rtol=0, atol=0))
    assert [g["mesh"] for g in got] == [(r, ndev, "cpu", "gloo") for r in range(ndev)]
    if api:
        for g in got:
            assert g["api"]["engine"] == "eager_dp"
            assert torch.equal(g["api"]["W"], got[0]["api"]["W"])
            assert g["api"]["callbacks"] == list(range(E))  # per-epoch mode
        recs = [json.loads(line) for line in open(tmp_path / "metrics0.jsonl")]
        assert [x["engine"] for x in recs] == ["eager_dp"] * E
        assert sorted(os.listdir(tmp_path / "ck0")) == ["epoch00001.pt", "epoch00002.pt"]
        for r in range(1, ndev):  # rank 0 alone writes
            assert not os.path.exists(tmp_path / f"metrics{r}.jsonl")
            assert not os.path.exists(tmp_path / f"ck{r}") or not os.listdir(tmp_path / f"ck{r}")
        assert np.all(np.isfinite(got[0]["api"]["history"]))


def test_runtime_data_parallel_has_no_effect():
    """As in the JAX package, the mesh decides: runtime.data_parallel neither
    raises nor changes the run; neither does debug_nans on a sound run."""
    from mdbn_tpu_torch.config import TrainRuntimeConfig

    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=1)
    data = mnist_like(20, n_features=16, seed=0)
    a, _ = train_rbm(data, cfg, device="cpu")
    b, _ = train_rbm(data, cfg, device="cpu", runtime=TrainRuntimeConfig(data_parallel=True))
    assert torch.equal(a.params.W, b.params.W)
    c, _ = train_rbm(data, cfg, device="cpu", runtime=TrainRuntimeConfig(debug_nans=True))
    assert torch.equal(a.params.W, c.params.W)


def test_cli_dp_under_torchrun(tmp_path):
    """`torchrun --nproc-per-node 2 -m mdbn_tpu_torch.run --dp 2 --device cpu`:
    both ranks train over gloo, rank 0 alone writes the model and the metrics."""
    import subprocess
    import sys

    from mdbn_tpu_torch.config import save_config

    cfg_path = str(tmp_path / "exp.json")
    save_config({"model": RBMConfig(n_visible=32, n_hidden=8, epochs=2, batch_size=5),
                 "data": {"kind": "mnist_like", "n_samples": 40, "n_features": 32, "seed": 2}},
                cfg_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "mdbn_tpu_torch.run", "--config", cfg_path, "--dp", "2", "--device", "cpu",
         "--metrics", str(tmp_path / "m.jsonl"), "--save", str(tmp_path / "model")],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [r["engine"] for r in recs] == ["eager_dp"] * 2  # one writer: two epochs
    assert recs[-1]["recon_error"] < recs[0]["recon_error"]
    assert os.path.exists(tmp_path / "model.config.json")

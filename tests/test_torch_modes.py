"""The estimator modes of the port against the JAX package: parallel
tempering in the core, and the whole training run under tempering, the
enhanced gradient, learned variance and the pseudo-likelihood monitor.

Core: ``pt_betas``, ``tempered_log_p_h``, ``_pt_swap_round`` and
``pt_step_stats`` against ``mdbn_tpu.core.rbm_math`` and ``mdbn_tpu/oracle.py``
at rtol=atol=2e-5 (tests/test_parity_core.py:20): float32 on every side,
summed in other orders.

Run: ``ops.cd_epoch_cuda.cd_train_run_plain`` (what the CUDA wrapper runs on
CPU tensors) against ``make_pallas_train_fn(cfg, E, interpret=True,
inject=True)``, the Pallas kernel in the TPU interpreter, as
tests/test_pallas_pt.py runs it, at rtol=2e-4, atol=2e-6 (its tolerance).
Data, initial states and draws are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mdbn_tpu.oracle as oracle
from mdbn_tpu.config import RBMConfig
from mdbn_tpu.core import rbm_math as J
from mdbn_tpu.core.rbm_math import RBMParams
from mdbn_tpu.core.state import TrainState
from mdbn_tpu.ops.cd_epoch_pallas import make_pallas_train_fn
from mdbn_tpu.ops.transform import transform as j_transform
from mdbn_tpu_torch.checkpoint import restore_state, save_state
from mdbn_tpu_torch.convert import (convert_config, rbm_from_numpy, state_from_numpy,
                                    state_to_numpy)
from mdbn_tpu_torch.core import rbm_math as T
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops.cd_step import cd_train_step, draw_pt_uniforms
from mdbn_tpu_torch.train.trainer import train_rbm

CORE_TOL = dict(rtol=2e-5, atol=2e-5)
RUN_TOL = dict(rtol=2e-4, atol=2e-6)
E = 2


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or CORE_TOL))


# ---- parallel tempering in the core ------------------------------------------


def pt_case(cfg, batch=5, seed=0):
    """Parameters (non-zero biases, z under learned variance), data, a
    random ladder [M, B, H] and oracle-layout PT draws."""
    rng = np.random.default_rng(seed)
    p = oracle.init_params(cfg, rng)
    p["W"] = (rng.standard_normal(p["W"].shape) * 0.3).astype(np.float32)
    p["b"] = rng.standard_normal(cfg.n_visible).astype(np.float32) * 0.3
    p["c"] = rng.standard_normal(cfg.n_hidden).astype(np.float32) * 0.3
    if cfg.learn_variance:
        p["z"] = rng.standard_normal(cfg.n_visible).astype(np.float32) * 0.3
    if cfg.visible == "bernoulli":
        v0 = (rng.random((batch, cfg.n_visible)) < 0.4).astype(np.float32)
    else:
        v0 = rng.standard_normal((batch, cfg.n_visible)).astype(np.float32)
    chains = (rng.random((cfg.pt_temps, batch, cfg.n_hidden)) < 0.5).astype(np.float32)
    return p, v0, chains, oracle.draw_pt_uniforms(cfg, batch, rng)


def jx(p):
    return J.RBMParams(**{k: jnp.asarray(v) for k, v in p.items()})


def th(p):
    return T.RBMParams(**{k: torch.as_tensor(v) for k, v in p.items()})


def tt(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


PT_CORE = {
    "bernoulli-k1": RBMConfig(n_visible=13, n_hidden=9, persistent=True, pt_temps=4,
                              pt_beta_min=0.25),
    "bernoulli-k2-meanfield": RBMConfig(n_visible=13, n_hidden=9, persistent=True, k=2,
                                        pt_temps=3, pt_beta_min=0.3, sample_visible=False),
    "gaussian-sampled": RBMConfig(n_visible=13, n_hidden=9, visible="gaussian",
                                  persistent=True, pt_temps=3, pt_beta_min=0.3,
                                  sample_visible=True),
    "gaussian-lv": RBMConfig(n_visible=13, n_hidden=9, visible="gaussian", persistent=True,
                             pt_temps=4, pt_beta_min=0.2, learn_variance=True, k=2),
    "gaussian-lv-meanfield": RBMConfig(n_visible=13, n_hidden=9, visible="gaussian",
                                       persistent=True, pt_temps=3, learn_variance=True,
                                       sample_visible=False),
    "enhanced-sparsity-xent": RBMConfig(n_visible=13, n_hidden=9, persistent=True,
                                        pt_temps=5, pt_beta_min=0.2, gradient="enhanced",
                                        sparsity_target=0.1, sparsity_cost=0.5,
                                        error_metric="xent"),
}


@pytest.mark.parametrize("M,beta_min", [(2, 0.0), (3, 0.3), (4, 0.25), (5, 0.2), (7, 0.05)])
def test_pt_betas(M, beta_min):
    cfg = RBMConfig(n_visible=4, n_hidden=2, persistent=True, pt_temps=M, pt_beta_min=beta_min)
    got = T.pt_betas(convert_config(cfg))
    assert got.dtype == torch.float32 and float(got[0]) == 1.0
    close(got, J.pt_betas(cfg))
    close(got, np.linspace(1.0, beta_min, M).astype(np.float32))


@pytest.mark.parametrize("visible,lv", [("bernoulli", False), ("gaussian", False),
                                        ("gaussian", True)])
def test_tempered_log_p_h(visible, lv):
    cfg = RBMConfig(n_visible=13, n_hidden=9, visible=visible, learn_variance=lv,
                    persistent=True, pt_temps=4, pt_beta_min=0.2)
    p, _, chains, _ = pt_case(cfg)
    betas = np.linspace(1.0, 0.2, 4).astype(np.float32)[:, None]
    got = T.tempered_log_p_h(th(p), torch.as_tensor(chains), torch.as_tensor(betas),
                             convert_config(cfg))
    close(got, J.tempered_log_p_h(jx(p), jnp.asarray(chains), jnp.asarray(betas), cfg))
    close(got, oracle.tempered_log_p_h(p, chains, betas, visible))


@pytest.mark.parametrize("parity", [0, 1])
def test_pt_swap_round(parity):
    """Cold ladder, half the draws near 0: accepts and rejects both occur."""
    cfg = RBMConfig(n_visible=13, n_hidden=9, persistent=True, pt_temps=5, pt_beta_min=0.1)
    p, _, chains, u = pt_case(cfg, seed=3)
    swap = u["swap"][parity] ** 4
    tcfg = convert_config(cfg)
    betas = T.pt_betas(tcfg)
    got = T._pt_swap_round(th(p), torch.as_tensor(chains), betas, torch.as_tensor(swap),
                           parity, tcfg)
    want = J._pt_swap_round(jx(p), jnp.asarray(chains), J.pt_betas(cfg), jnp.asarray(swap),
                            parity, cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    moved = (got.numpy() != chains).any(axis=2)
    assert moved.any() and not moved.all()


@pytest.mark.parametrize("name", list(PT_CORE))
def test_pt_step_stats(name):
    cfg = PT_CORE[name]
    p, v0, chains, u = pt_case(cfg)
    tcfg = convert_config(cfg)
    gt, ct, et = T.pt_step_stats(th(p), torch.as_tensor(v0), torch.as_tensor(chains), tt(u),
                                 tcfg)
    gj, cj, ej = J.pt_step_stats(jx(p), jnp.asarray(v0), jnp.asarray(chains),
                                 {k: jnp.asarray(v) for k, v in u.items()}, cfg)
    go, co, eo = oracle.pt_step_stats(p, v0, chains, u, cfg)
    for name in ("W", "b", "c", "z"):
        if getattr(gj, name) is None:
            assert getattr(gt, name) is None
            continue
        close(getattr(gt, name), getattr(gj, name))
        close(getattr(gt, name), go[name])
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(ct.numpy(), co)
    close(et, ej)
    close(et, eo)


def test_pt_train_step_and_draw_layout():
    """cd_train_step dispatches a ladder to pt_step_stats on
    draw_pt_uniforms' draws, keeping the [M*B, H] chain."""
    cfg = convert_config(PT_CORE["bernoulli-k1"])
    st = init_train_state(cfg, device="cpu")
    assert st.chain_h.shape == (cfg.pt_temps * cfg.batch_size, cfg.n_hidden)
    v0 = torch.as_tensor((np.random.default_rng(1).random((cfg.batch_size, 13)) < 0.4)
                         .astype(np.float32))
    p, _, chain, _ = cd_train_step(st.params, st.velocity, st.chain_h, v0,
                                   torch.Generator().manual_seed(2), cfg)
    u = draw_pt_uniforms(cfg, cfg.batch_size, torch.Generator().manual_seed(2))
    assert u["swap"].shape == (2, 3, cfg.batch_size) and u["h"].shape == (1, 4, 20, 9)
    g, chains, _ = T.pt_step_stats(st.params, v0, st.chain_h.reshape(4, 20, 9), u, cfg)
    torch.testing.assert_close(chain, chains.reshape(80, 9), rtol=0, atol=0)
    torch.testing.assert_close(p.W, T.apply_update(st.params, st.velocity, g, cfg)[0].W,
                               rtol=0, atol=0)


# ---- the whole run: the port's plain version against the Pallas kernel -------


# One interpret compile each (most of a case's time). The ladders are warm
# (beta_min 0.2-0.5) so that swaps are both accepted and rejected.
RUNS = {
    "pt-bernoulli-k2-momentum": RBMConfig(n_visible=24, n_hidden=12, batch_size=4, k=2,
                                          lr=0.1, momentum=0.5, l2=1e-4, persistent=True,
                                          pt_temps=4, pt_beta_min=0.2),
    "pt-gaussian-sampled": RBMConfig(n_visible=16, n_hidden=8, batch_size=4,
                                     visible="gaussian", lr=0.005, persistent=True,
                                     pt_temps=3, pt_beta_min=0.3, sample_visible=True,
                                     grad_clip=1.0),
    "pt-learn-variance": RBMConfig(n_visible=16, n_hidden=8, batch_size=4, visible="gaussian",
                                   lr=0.005, k=2, persistent=True, pt_temps=3,
                                   pt_beta_min=0.3, learn_variance=True, momentum=0.5,
                                   grad_clip=1.0),
    "enhanced-sparsity": RBMConfig(n_visible=16, n_hidden=8, batch_size=4, lr=0.1,
                                   gradient="enhanced", momentum=0.5, sparsity_target=0.1,
                                   sparsity_cost=0.5),
    "learn-variance-meanfield": RBMConfig(n_visible=16, n_hidden=8, batch_size=4,
                                          visible="gaussian", lr=0.005, learn_variance=True,
                                          sample_visible=False, lr_variance=0.002,
                                          persistent=True, momentum=0.5),
    "pseudo-pt-enhanced": RBMConfig(n_visible=24, n_hidden=12, batch_size=4, lr=0.1,
                                    error_metric="pseudo", gradient="enhanced",
                                    persistent=True, pt_temps=3, pt_beta_min=0.5),
    "pseudo-cd": RBMConfig(n_visible=16, n_hidden=8, batch_size=4, lr=0.1,
                           error_metric="pseudo"),
}


def run_draws(cfg, nb, seed=7):
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    CR = B * cfg.pt_temps
    rng = np.random.default_rng(seed)
    u = {"h0": rng.random((E, nb, B, H), np.float32),
         "h": rng.random((E, nb, cfg.k, CR, H), np.float32)}
    if cfg.resolved_sample_visible:
        if cfg.visible == "bernoulli":
            u["v"] = rng.random((E, nb, cfg.k, CR, V), np.float32)
        else:
            u["noise"] = rng.standard_normal((E, nb, cfg.k, CR, V)).astype(np.float32)
    if cfg.pt_temps > 1:
        u["swap"] = rng.random((E, nb, 2, (cfg.pt_temps - 1) * B), np.float32)
    return u


def run_inputs(cfg, nb, seed=3):
    """Data and a JAX TrainState made with numpy: W ~ 0.05 N(0, 1), non-zero
    biases, z and chain, zero velocity."""
    rng = np.random.default_rng(seed)
    V, H, B = cfg.n_visible, cfg.n_hidden, cfg.batch_size
    n = nb * B
    if cfg.visible == "bernoulli":
        data = (rng.random((n, V)) < 0.3).astype(np.float32)
    else:
        data = rng.standard_normal((n, V)).astype(np.float32)

    def f32(x):
        return jnp.asarray(np.asarray(x, np.float32))

    z = f32(rng.standard_normal(V) * 0.2) if cfg.learn_variance else None
    params = RBMParams(W=f32(rng.standard_normal((V, H)) * 0.05),
                       b=f32(rng.standard_normal(V) * 0.1),
                       c=f32(rng.standard_normal(H) * 0.1), z=z)
    zeros = RBMParams(W=f32(np.zeros((V, H))), b=f32(np.zeros(V)), c=f32(np.zeros(H)),
                      z=f32(np.zeros(V)) if cfg.learn_variance else None)
    chain = f32(rng.random((B * cfg.pt_temps, H)) < 0.5)
    return data, TrainState(params=params, velocity=zeros, chain_h=chain,
                            key=jnp.asarray(np.zeros(2, np.uint32)),
                            epoch=jnp.asarray(np.int32(0)))


def to_port(st):
    return state_from_numpy({"params": {k: np.asarray(v) for k, v in st.params._asdict().items()
                                        if v is not None},
                             "velocity": {k: np.asarray(v)
                                          for k, v in st.velocity._asdict().items()
                                          if v is not None},
                             "chain_h": np.asarray(st.chain_h), "epoch": 0}, device="cpu")


def jax_run(cfg, data, st, u):
    fn = make_pallas_train_fn(cfg, E, interpret=True, inject=True)
    return fn(st, jnp.asarray(data), {k: jnp.asarray(v) for k, v in u.items()})


def check_run(cfg, jst, jerrs, params, velocity, chain, errs):
    names = ("W", "b", "c", "z") if cfg.learn_variance else ("W", "b", "c")
    for name in names:
        close(getattr(params, name), getattr(jst.params, name), **RUN_TOL)
        close(getattr(velocity, name), getattr(jst.velocity, name), **RUN_TOL)
    np.testing.assert_array_equal(chain.numpy(), np.asarray(jst.chain_h))
    close(errs, jerrs, **RUN_TOL)


@pytest.mark.parametrize("name", list(RUNS))
def test_plain_run_matches_pallas_kernel(name):
    cfg, nb = RUNS[name], 4
    data, st = run_inputs(cfg, nb)
    u = run_draws(cfg, nb)
    jst, jerrs = jax_run(cfg, data, st, u)
    tcfg, tst = convert_config(cfg), to_port(st)
    got = K.cd_train_run_plain(tcfg, tst.params, tst.velocity, tst.chain_h,
                               torch.as_tensor(data), K.batch_order(tcfg, nb, E, None), 0,
                               tt(u))
    check_run(cfg, jst, jerrs, *got)
    if cfg.pt_temps > 1:  # the ladder really swapped: never accepting gives another chain
        no_swap = dict(u, swap=np.ones_like(u["swap"]))
        other = K.cd_train_run_plain(tcfg, tst.params, tst.velocity, tst.chain_h,
                                     torch.as_tensor(data), K.batch_order(tcfg, nb, E, None),
                                     0, tt(no_swap))
        assert not torch.equal(other[2], got[2])


def test_ladder_trains_through_the_api_like_the_kernel():
    """The slice end to end on the CPU: train_rbm (the eager engine RBM.train
    runs here) with PT + learned variance and injected draws, against the
    Pallas kernel; then the codes of RBM.transform against the JAX
    transform of the same parameters."""
    cfg, nb = RUNS["pt-learn-variance"], 4
    data, st = run_inputs(cfg, nb)
    u = run_draws(cfg, nb)
    jst, jerrs = jax_run(cfg, data, st, u)
    tcfg = convert_config(cfg).replace(epochs=E)
    state, metrics = train_rbm(data, tcfg, state=to_port(st), uniforms=u)
    assert metrics.engine == "eager" and state.epoch == E
    check_run(cfg, jst, jerrs, state.params, state.velocity, state.chain_h,
              torch.as_tensor(metrics.errors))
    rbm = rbm_from_numpy(tcfg, {k: v.numpy() for k, v in state.params.as_dict().items()},
                         device="cpu")
    assert rbm.state.chain_h.shape == (cfg.pt_temps * cfg.batch_size, cfg.n_hidden)
    close(rbm.transform(data), j_transform(jst.params, jnp.asarray(data), cfg), rtol=0,
          atol=1e-5)


def test_wrapper_on_cpu_tensors_runs_the_modes_plainly():
    cfg = convert_config(RUNS["pt-bernoulli-k2-momentum"])
    st = init_train_state(cfg, device="cpu")
    data = torch.as_tensor((np.random.default_rng(0).random((16, 24)) < 0.3)
                           .astype(np.float32))
    order = K.batch_order(cfg, 4, E, None)
    before = K.cd_train_launches
    a = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                       torch.Generator().manual_seed(1))
    b = K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                             torch.Generator().manual_seed(1))
    assert K.cd_train_launches == before
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)
    assert K.trace_len(cfg) == 3 + 2 * 2 + 1 + 2
    assert K.trace_len(convert_config(RUNS["enhanced-sparsity"])) == 3 + 2 + 1


@pytest.mark.parametrize("name", ["pt-bernoulli-k2-momentum", "pt-learn-variance"])
def test_harden_ladder_keeps_the_trajectory(name):
    """Hardened ladder draws (a wide eps so that many move) give the same run
    as the raw ones: every Bernoulli and swap outcome is kept."""
    cfg, nb = convert_config(RUNS[name]), 4
    data, st = run_inputs(RUNS[name], nb)
    tst = to_port(st)
    data = torch.as_tensor(data)
    u = K.draw_uniform_blocks(cfg, torch.Generator().manual_seed(4), E, nb)
    assert u["swap"].shape == (E, nb, 2, (cfg.pt_temps - 1) * cfg.batch_size)
    hard = K.harden_uniform_blocks(cfg, tst.params, tst.velocity, tst.chain_h, data, u, E,
                                   eps=0.02, swap_eps=1e-3)
    assert set(hard) == set(u) and not torch.equal(hard["h"], u["h"])
    order = K.batch_order(cfg, nb, E, None)
    raw = K.cd_train_run_plain(cfg, tst.params, tst.velocity, tst.chain_h, data, order, 0, u)
    got = K.cd_train_run_plain(cfg, tst.params, tst.velocity, tst.chain_h, data, order, 0,
                               hard)
    torch.testing.assert_close(got[2], raw[2], rtol=0, atol=0)
    torch.testing.assert_close(got[0].W, raw[0].W, rtol=0, atol=0)


def test_ladder_and_variance_round_trip(tmp_path):
    """A PT + learned-variance state — the [M*B, H] ladder, z and vz —
    through convert.py both ways and through a checkpoint."""
    cfg, nb = RUNS["pt-learn-variance"], 4
    _, st = run_inputs(cfg, nb)
    tst = to_port(st)
    assert tst.chain_h.shape == (12, 8) and tst.params.z is not None
    assert tst.velocity.z is not None
    tree = state_to_numpy(tst)
    for part in ("params", "velocity"):
        for k, v in getattr(st, part)._asdict().items():
            np.testing.assert_array_equal(tree[part][k], np.asarray(v))
    np.testing.assert_array_equal(tree["chain_h"], np.asarray(st.chain_h))
    save_state(tst, str(tmp_path / "s.pt"))
    back = restore_state(str(tmp_path / "s.pt"), "cpu")
    for part in ("params", "velocity"):
        for k, v in getattr(tst, part).as_dict().items():
            torch.testing.assert_close(getattr(getattr(back, part), k), v, rtol=0, atol=0)
    torch.testing.assert_close(back.chain_h, tst.chain_h, rtol=0, atol=0)

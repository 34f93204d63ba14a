"""mdbn_tpu_torch/oracle.py, the port's copy of the NumPy oracle, against
mdbn_tpu/oracle.py bit for bit (``assert_array_equal``) on numpy seeds:
every function and class, with the oracle's own draws and with injected
uniforms, in every estimator mode (tempering, the enhanced gradient, learned
variance, the pseudo-likelihood monitor) and at bf16 storage. The port's
copy takes the port's configs, the reference's the JAX package's, made from
the same fields. CPU only, NumPy only.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_array_equal

import mdbn_tpu.config as jconfig
import mdbn_tpu.oracle as R
import mdbn_tpu_torch.config as tconfig
import mdbn_tpu_torch.oracle as T

SMALL = dict(n_visible=24, n_hidden=10, batch_size=5, lr=0.1, epochs=3)
CASES = {
    "cd1": dict(SMALL),
    "xent-shuffle-glorot": dict(SMALL, error_metric="xent", shuffle=True,
                                init="uniform_glorot4"),
    "pcd-k2-sparsity-schedule": dict(SMALL, persistent=True, k=2, sparsity_target=0.1,
                                     sparsity_cost=0.5, momentum=0.9, initial_momentum=0.5,
                                     momentum_switch_epoch=1, l2=1e-3, grad_clip=0.05),
    "gaussian-sampled-k2": dict(SMALL, visible="gaussian", sample_visible=True, k=2, lr=0.01),
    "lv-meanfield-pcd": dict(SMALL, visible="gaussian", learn_variance=True, persistent=True,
                             lr=0.01, lr_variance=0.005, momentum=0.5),
    "lv-sampled": dict(SMALL, visible="gaussian", learn_variance=True, sample_visible=True,
                       lr=0.01),
    "enhanced": dict(SMALL, gradient="enhanced", k=2, sparsity_target=0.1, sparsity_cost=0.5),
    "pt3": dict(SMALL, persistent=True, pt_temps=3, pt_beta_min=0.3, momentum=0.5),
    "pt3-gaussian-lv": dict(SMALL, visible="gaussian", learn_variance=True, persistent=True,
                            pt_temps=3, pt_beta_min=0.4, sample_visible=True, lr=0.01),
    "pt3-enhanced": dict(SMALL, persistent=True, pt_temps=3, pt_beta_min=0.3,
                         gradient="enhanced"),
    "pseudo": dict(SMALL, error_metric="pseudo", momentum=0.5),
    "bf16": dict(SMALL, param_dtype="bfloat16", compute_dtype="bfloat16"),
}


def both(**kw):
    """(the reference's config, the port's) of the same fields."""
    return jconfig.RBMConfig(**kw), tconfig.RBMConfig(**kw)


def data_for(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    if cfg.visible == "bernoulli":
        return (rng.random((rows, cfg.n_visible)) < 0.4).astype(np.float32)
    return rng.standard_normal((rows, cfg.n_visible)).astype(np.float32)


def equal_dicts(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert_array_equal(a[k], b[k], err_msg=k)


def equal_rbms(a, b):
    equal_dicts(a.params, b.params)
    equal_dicts(a.velocity, b.velocity)
    assert a.history == b.history
    assert (a.chain_h is None) == (b.chain_h is None)
    if a.chain_h is not None:
        assert_array_equal(a.chain_h, b.chain_h)
    assert (a._step_count, a._epoch) == (b._step_count, b._epoch)


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_rbm_trains_to_the_same_bits(name):
    """OracleRBM.train on its own draws (the seed's generator), then
    transform and reconstruct."""
    rc, tc = both(**CASES[name])
    data = data_for(rc, 23, 1)  # 4 minibatches and 3 rows left over
    ro, to = R.OracleRBM(rc).train(data), T.OracleRBM(tc).train(data)
    equal_rbms(ro, to)
    assert_array_equal(ro.transform(data), to.transform(data))
    assert_array_equal(ro.reconstruct(data), to.reconstruct(data))
    assert ro.rng.random() == to.rng.random()  # the generator consumed alike


@pytest.mark.parametrize("name", list(CASES))
def test_oracle_steps_on_injected_uniforms(name):
    """train_step fed the same uniforms, and the step functions themselves:
    cd_step_stats / pt_step_stats, draw_uniforms / draw_pt_uniforms."""
    rc, tc = both(**CASES[name])
    ro, to = R.OracleRBM(rc), T.OracleRBM(tc)
    rng = np.random.default_rng(2)
    draw_r = R.draw_pt_uniforms if rc.pt_temps > 1 else R.draw_uniforms
    draw_t = T.draw_pt_uniforms if rc.pt_temps > 1 else T.draw_uniforms
    for step in range(4):
        v0 = data_for(rc, 5, 10 + step)
        seed = 100 + step
        u = draw_r(rc, 5, np.random.default_rng(seed))
        equal_dicts(u, draw_t(tc, 5, np.random.default_rng(seed)))
        if step == 2:
            ro._epoch = to._epoch = 1  # past a momentum switch
        assert ro.train_step(v0, u) == to.train_step(v0, u)
    equal_rbms(ro, to)
    v0, u = data_for(rc, 5, 30), draw_r(rc, 5, rng)
    p = {k: x.astype(np.float32) for k, x in ro.params.items()}
    if rc.pt_temps > 1:
        chains = (rng.random((rc.pt_temps, 5, rc.n_hidden)) < 0.5).astype(np.float32)
        gr, hr, er = R.pt_step_stats(p, v0, chains, u, rc)
        gt, ht, et = T.pt_step_stats(p, v0, chains, u, tc)
    else:
        chain = (rng.random((5, rc.n_hidden)) < 0.5).astype(np.float32)
        gr, hr, er, vr = R.cd_step_stats(p, v0, chain, u, rc)
        gt, ht, et, vt = T.cd_step_stats(p, v0, chain, u, tc)
        assert_array_equal(vr, vt)
    equal_dicts(gr, gt)
    assert_array_equal(hr, ht)
    assert er == et


def test_oracle_functions():
    """The free functions on random inputs: sigmoid, the conditionals, the
    free energy, the monitors, log p*(h), the enhanced gradient, the
    momentum schedule, the in-place update, init and zero velocity."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 9)).astype(np.float32) * 30
    assert_array_equal(R.sigmoid(x), T.sigmoid(x))
    for visible, lv in (("bernoulli", False), ("gaussian", False), ("gaussian", True)):
        rc, tc = both(n_visible=9, n_hidden=7, visible=visible, learn_variance=lv,
                      momentum=0.9, initial_momentum=0.5, momentum_switch_epoch=2, l2=1e-2,
                      grad_clip=0.1, lr_variance=0.003 if lv else None)
        p = R.init_params(rc, np.random.default_rng(4))
        equal_dicts(p, T.init_params(tc, np.random.default_rng(4)))
        p = {k: (v + rng.standard_normal(v.shape) * 0.2).astype(np.float32) for k, v in p.items()}
        equal_dicts(R.zero_velocity(p), T.zero_velocity(p))
        v = data_for(rc, 6, 5)
        h = (rng.random((6, 7)) < 0.5).astype(np.float32)
        assert_array_equal(R.hidden_mean(p, v), T.hidden_mean(p, v))
        assert_array_equal(R.visible_mean(p, h, visible), T.visible_mean(p, h, visible))
        assert_array_equal(R.free_energy(p, v, visible), T.free_energy(p, v, visible))
        hs = (rng.random((3, 6, 7)) < 0.5).astype(np.float32)
        beta = np.array([1.0, 0.7, 0.4], np.float32)[:, None]
        assert_array_equal(R.tempered_log_p_h(p, hs, beta, visible),
                           T.tempered_log_p_h(p, hs, beta, visible))
        if visible == "bernoulli":
            for bit in (0, 4, 8):
                assert R.pseudo_likelihood(p, v, bit, visible) == T.pseudo_likelihood(
                    p, v, bit, visible)
        for metric in ("mse", "xent"):
            m = R.sigmoid(x[:, :9])
            assert R.recon_error(v, m, metric) == T.recon_error(v, m, metric)
        g = {k: rng.standard_normal(a.shape).astype(np.float32) for k, a in p.items()}
        mu, lam = rng.random(9).astype(np.float32), rng.random(7).astype(np.float32)
        equal_dicts(R.enhance_grads(g, mu, lam), T.enhance_grads(g, mu, lam))
        for epoch in (0, 1, 2, 5):
            assert R.resolve_momentum(rc, epoch) == T.resolve_momentum(tc, epoch)
            pr, vr = {k: a.copy() for k, a in p.items()}, R.zero_velocity(p)
            pt, vt = {k: a.copy() for k, a in p.items()}, T.zero_velocity(p)
            for _ in range(2):
                R.apply_update(pr, vr, g, rc, epoch=epoch)
                T.apply_update(pt, vt, g, tc, epoch=epoch)
            equal_dicts(pr, pt)
            equal_dicts(vr, vt)


def test_oracle_dbn_and_mdbn():
    """OracleDBN over oracle_dbn_configs, and OracleMDBN with two towers and
    a joint RBM: training, then the codes."""
    kw = dict(layer_sizes=[12, 6], epochs=2, batch_size=5, lr=0.1, seed=3)
    rd, td = jconfig.DBNConfig(**kw), tconfig.DBNConfig(**kw)
    rcfgs, tcfgs = R.oracle_dbn_configs(rd, 20), T.oracle_dbn_configs(td, 20)
    assert [dataclasses.asdict(c) for c in rcfgs] == [dataclasses.asdict(c) for c in tcfgs]
    data = data_for(rcfgs[0], 25, 6)
    rdbn, tdbn = R.OracleDBN(rcfgs).train(data), T.OracleDBN(tcfgs).train(data)
    for a, b in zip(rdbn.layers, tdbn.layers):
        equal_rbms(a, b)
    assert_array_equal(rdbn.transform(data), tdbn.transform(data))

    rng = np.random.default_rng(7)
    mods = {"ge": rng.standard_normal((25, 14)).astype(np.float32),
            "meth": rng.standard_normal((25, 9)).astype(np.float32)}
    tower = dict(layer_sizes=[8, 4], visible="gaussian", epochs=2, batch_size=5, lr=0.01)
    joint = dict(n_visible=1, n_hidden=5, epochs=3, batch_size=5, lr=0.05, seed=9)
    rm = R.OracleMDBN({m: R.oracle_dbn_configs(jconfig.DBNConfig(**tower), x.shape[1])
                       for m, x in mods.items()}, jconfig.RBMConfig(**joint)).train(mods)
    tm = T.OracleMDBN({m: T.oracle_dbn_configs(tconfig.DBNConfig(**tower), x.shape[1])
                       for m, x in mods.items()}, tconfig.RBMConfig(**joint)).train(mods)
    for m in mods:
        for a, b in zip(rm.towers[m].layers, tm.towers[m].layers):
            equal_rbms(a, b)
    equal_rbms(rm.joint, tm.joint)
    assert tm.joint.cfg.n_visible == 8 and tm.joint.cfg.visible == "bernoulli"
    assert_array_equal(rm.transform(mods), tm.transform(mods))
    with pytest.raises(ValueError, match="fewer than one minibatch"):
        T.OracleRBM(tconfig.RBMConfig(n_visible=4, n_hidden=2, batch_size=8)).train(
            np.zeros((5, 4), np.float32))


def test_port_modules_import_no_jax():
    """The oracle and the tensor-parallel path import neither JAX nor the JAX
    package."""
    code = ("import sys, mdbn_tpu_torch.oracle, mdbn_tpu_torch.parallel.tp, "
            "mdbn_tpu_torch.parallel.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'mdbn_tpu' or m.startswith('mdbn_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

"""The port's sampling (mdbn_tpu_torch/ops/sample.py) and the model methods
built on it against the JAX package, with the JAX functions' own draws.

Every chain here is fed the uniforms (or normals) the JAX function draws:
the test reproduces them with ``jax.random.split`` exactly as
``mdbn_tpu/ops/sample.py`` does (one key per step, split into the h and v
keys; ``generate_from_stack`` first splits off the starting state's key;
``MDBN.generate`` likewise), and passes them to the port as ``draws``.
Weights come from numpy with a fixed seed and are carried across by
``convert.py``. Tolerance 2e-5 (relative and absolute) on every output:
both sides sample the same states, and the means differ only in float32
summation order. CPU only, a few seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbn_tpu.config import DBNConfig, MDBNConfig, RBMConfig
from mdbn_tpu.core.rbm_math import RBMParams
from mdbn_tpu.core.state import init_train_state
from mdbn_tpu.models.dbn import DBN as JDBN
from mdbn_tpu.models.mdbn import MDBN as JMDBN
from mdbn_tpu.models.rbm import RBM as JRBM
from mdbn_tpu.ops import sample as JS
from mdbn_tpu_torch.convert import (convert_config, dbn_from_numpy, mdbn_from_numpy,
                                    params_from_numpy, rbm_from_numpy)
from mdbn_tpu_torch.ops import sample as TS

TOL = dict(rtol=2e-5, atol=2e-5)


def _params(V, H, seed, lv=False):
    rng = np.random.default_rng(seed)
    p = {"W": rng.normal(0, 0.5, (V, H)), "b": rng.normal(0, 0.3, V),
         "c": rng.normal(0, 0.3, H)}
    if lv:
        p["z"] = rng.normal(0, 0.3, V)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _jrbm(cfg, p):
    st = init_train_state(cfg, jax.random.PRNGKey(0))
    return JRBM(cfg, state=st._replace(params=RBMParams(**{k: jnp.asarray(v)
                                                          for k, v in p.items()})))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def chain_draws(key, n_steps, rows, V, H, gaussian):
    """The draws of ops/sample.py's Gibbs scan: one key a step, split into
    the h and v keys."""
    hs, vs = [], []
    for k in jax.random.split(key, n_steps):
        kh, kv = jax.random.split(k)
        hs.append(jax.random.uniform(kh, (rows, H)))
        vs.append(jax.random.normal(kv, (rows, V), jnp.float32) if gaussian
                  else jax.random.uniform(kv, (rows, V)))
    return {"h": _t(jnp.stack(hs)), "v": _t(jnp.stack(vs))}


def generate_draws(key, n, V, H, n_steps, gaussian=False):
    """generate_from_stack's draws: the start's uniforms, then the chain's."""
    kinit, kgibbs = jax.random.split(key)
    return {"init": _t(jax.random.uniform(kinit, (n, V))),
            **chain_draws(kgibbs, n_steps, n, V, H, gaussian)}


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want), **TOL)


CHAINS = {
    "bernoulli": RBMConfig(n_visible=12, n_hidden=8),
    "gaussian": RBMConfig(n_visible=12, n_hidden=8, visible="gaussian"),
    "gaussian-lv": RBMConfig(n_visible=12, n_hidden=8, visible="gaussian", learn_variance=True),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_gibbs_sample(name):
    cfg = CHAINS[name]
    p = _params(12, 8, seed=1, lv=cfg.learn_variance)
    key = jax.random.PRNGKey(3)
    v0 = (np.random.default_rng(2).random((5, 12)) < 0.5).astype(np.float32)
    want = JS.gibbs_sample(RBMParams(**{k: jnp.asarray(v) for k, v in p.items()}),
                           jnp.asarray(v0), key, cfg, 9)
    got = TS.gibbs_sample(params_from_numpy(p, device="cpu"), _t(v0), convert_config(cfg), 9,
                          draws=chain_draws(key, 9, 5, 12, 8, cfg.visible == "gaussian"))
    for g, w in zip(got, want):
        _close(g, w)
    # without draws: a generator on the parameters' device, reproducible by seed
    a, b = (TS.gibbs_sample(params_from_numpy(p, device="cpu"), _t(v0), convert_config(cfg),
                            4, generator=torch.Generator().manual_seed(7)) for _ in range(2))
    assert torch.equal(a[1], b[1]) and a[0].dtype == torch.float32


@pytest.mark.parametrize("name", ["bernoulli", "gaussian-lv"])
def test_gibbs_sample_clamped(name):
    cfg = CHAINS[name]
    p = _params(12, 8, seed=4, lv=cfg.learn_variance)
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(6)
    v0 = rng.random((4, 12)).astype(np.float32)
    mask = (np.arange(12) < 7).astype(np.float32)
    want = JS.gibbs_sample_clamped(RBMParams(**{k: jnp.asarray(v) for k, v in p.items()}),
                                   jnp.asarray(v0), jnp.asarray(mask), key, cfg, 10, 4, 3)
    got = TS.gibbs_sample_clamped(params_from_numpy(p, device="cpu"), _t(v0), _t(mask),
                                  convert_config(cfg), 10, n_burnin=4, n_chains=3,
                                  draws=chain_draws(key, 10, 12, 12, 8,
                                                    cfg.visible == "gaussian"))
    for g, w in zip(got, want):
        _close(g, w)
    assert torch.equal(got[0][:, :7], _t(v0)[:, :7])  # the clamped block as given
    with pytest.raises(ValueError, match="n_burnin"):
        TS.gibbs_sample_clamped(params_from_numpy(p, device="cpu"), _t(v0), _t(mask),
                                convert_config(cfg), 4, n_burnin=4)


def _stack(sizes, seed, visible="bernoulli"):
    """A JAX DBN and the port's, with the same random weights."""
    cfg = DBNConfig(layer_sizes=sizes[1:], visible=visible)
    layers = [(_params(v, h, seed + i), cfg.rbm_config(i, v))
              for i, (v, h) in enumerate(zip(sizes, sizes[1:]))]
    jdbn = JDBN(cfg)
    jdbn.layers = [_jrbm(c, p) for p, c in layers]
    return jdbn, dbn_from_numpy(cfg, layers, device="cpu")


@pytest.mark.parametrize("visible", ["bernoulli", "gaussian"])
def test_generate_and_reconstruct_dbn(visible):
    jdbn, tdbn = _stack([14, 10, 6], seed=8, visible=visible)
    want = jdbn.generate(n_samples=5, n_gibbs=8, seed=2)
    _close(tdbn.generate(n_samples=5, n_gibbs=8, draws=generate_draws(
        jax.random.PRNGKey(2), 5, 10, 6, 8)), want)
    layers = [(r.params, r.cfg) for r in tdbn.layers]
    _close(TS.generate_from_stack(layers, 5, 8, draws=generate_draws(
        jax.random.PRNGKey(2), 5, 10, 6, 8)), want)
    assert tdbn.generate(n_samples=3, n_gibbs=2, seed=1).shape == (3, 14)
    v = np.random.default_rng(9).random((6, 14)).astype(np.float32)
    _close(tdbn.reconstruct(v), jdbn.reconstruct(jnp.asarray(v)))


def _mdbn(seed):
    dims, codes = {"ge": (10, 6, 4), "meth": (8, 5), "mirna": (6, 3)}, 8
    cfg = MDBNConfig(towers={m: DBNConfig(layer_sizes=list(s[1:]), visible="gaussian")
                             for m, s in dims.items()},
                     joint=RBMConfig(n_visible=1, n_hidden=codes))
    towers = {m: [(_params(v, h, seed + 10 * j + i), cfg.towers[m].rbm_config(i, v))
                  for i, (v, h) in enumerate(zip(s, s[1:]))]
              for j, (m, s) in enumerate(dims.items())}
    width = sum(s[-1] for s in dims.values())
    jcfg = cfg.joint.replace(n_visible=width)
    joint = (_params(width, codes, seed + 99), jcfg)
    jm = JMDBN(cfg)
    for m, layers in towers.items():
        jm.towers[m] = JDBN(cfg.towers[m])
        jm.towers[m].layers = [_jrbm(c, p) for p, c in layers]
    jm.joint = _jrbm(jcfg, joint[0])
    rng = np.random.default_rng(seed)
    mods = {m: rng.normal(size=(5, s[0])).astype(np.float32) for m, s in dims.items()}
    return jm, mdbn_from_numpy(cfg, towers, joint, device="cpu"), mods, width


def test_mdbn_impute_and_transform_partial():
    jm, tm, mods, width = _mdbn(seed=20)
    observed = {m: mods[m] for m in ("ge", "mirna")}
    draws = chain_draws(jax.random.PRNGKey(4), 10, 8 * 5, width, 8, False)
    want = jm.impute(observed, n_gibbs=10, seed=4)
    got = tm.impute(observed, n_gibbs=10, seed=4, draws=draws)
    assert list(got) == ["meth"] == list(want)
    _close(got["meth"], want["meth"])
    _close(tm.transform_partial(observed, n_gibbs=10, draws=draws),
           jm.transform_partial(observed, n_gibbs=10, seed=4))
    with pytest.raises(ValueError, match="all modalities"):
        tm.impute(mods)
    with pytest.raises(ValueError, match="use transform"):
        tm.transform_partial(mods)
    with pytest.raises(ValueError, match="unknown"):
        tm.impute({"rna": mods["ge"]})
    assert tm._code_layout() == jm._code_layout()


def test_mdbn_generate_and_reconstruct():
    jm, tm, mods, width = _mdbn(seed=30)
    want = jm.generate(n_samples=4, n_gibbs=7, seed=6)
    got = tm.generate(n_samples=4, n_gibbs=7, draws=generate_draws(
        jax.random.PRNGKey(6), 4, width, 8, 7))
    assert list(got) == list(want)
    for m in want:
        _close(got[m], want[m])
    want = jm.reconstruct({m: jnp.asarray(x) for m, x in mods.items()})
    got = tm.reconstruct(mods)
    for m in want:
        _close(got[m], want[m])


@pytest.mark.parametrize("name", list(CHAINS))
def test_rbm_sample_free_energy_gap_and_sigma(name):
    cfg = CHAINS[name]
    p = _params(12, 8, seed=11, lv=cfg.learn_variance)
    jr, tr = _jrbm(cfg, p), rbm_from_numpy(cfg, p, device="cpu")
    rng = np.random.default_rng(12)
    a, b = rng.random((7, 12)).astype(np.float32), rng.random((9, 12)).astype(np.float32)
    assert abs(tr.free_energy_gap(a, b) - jr.free_energy_gap(a, b)) <= 2e-5 * (
        1 + abs(jr.free_energy_gap(a, b)))
    if cfg.learn_variance:
        _close(tr.sigma, jr.sigma)
    else:
        assert tr.sigma is None and jr.sigma is None
    key = jax.random.PRNGKey(13)
    kinit, kchain = jax.random.split(key)
    v0 = (jax.random.uniform(kinit, (5, 12)) < 0.5).astype(jnp.float32)
    _close(tr.sample(n_gibbs=9, v_init=np.asarray(v0),  # test_gibbs_sample's shapes: no compile
                     draws=chain_draws(kchain, 9, 5, 12, 8, cfg.visible == "gaussian")),
           jr.sample(n_samples=5, n_gibbs=9, seed=13))
    assert tr.sample(n_samples=2, n_gibbs=3).shape == (2, 12)

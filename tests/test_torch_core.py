"""mdbn_tpu_torch.core.rbm_math against mdbn_tpu.core.rbm_math and the oracle.

The same parameters, data and uniforms (made with numpy from a seed) go
through the JAX core, the NumPy oracle and the PyTorch port. Tolerance
rtol=atol=2e-5 (tests/test_parity_core.py:20): all three compute in float32
and differ only in the order of sums. Free energy sums H softplus terms and
is held at 1e-4, as in tests/test_parity_core.py.
"""

import numpy as np
import pytest
import torch

import mdbn_tpu.oracle as oracle
from mdbn_tpu.config import RBMConfig
from mdbn_tpu.core import rbm_math as J
from mdbn_tpu_torch.convert import convert_config
from mdbn_tpu_torch.core import rbm_math as T

TOL = dict(rtol=2e-5, atol=2e-5)

# the config set of tests/test_parity_core.py
CONFIGS = [
    RBMConfig(n_visible=13, n_hidden=9, visible="bernoulli", k=1),
    RBMConfig(n_visible=13, n_hidden=9, visible="bernoulli", k=3),
    RBMConfig(n_visible=13, n_hidden=9, visible="bernoulli", k=2, sample_visible=False),
    RBMConfig(n_visible=13, n_hidden=9, visible="bernoulli", k=1, persistent=True),
    RBMConfig(n_visible=13, n_hidden=9, visible="gaussian", k=1),
    RBMConfig(n_visible=13, n_hidden=9, visible="gaussian", k=2, sample_visible=True),
    RBMConfig(n_visible=13, n_hidden=9, visible="gaussian", k=1, persistent=True),
    RBMConfig(n_visible=13, n_hidden=9, visible="bernoulli", k=1, error_metric="xent"),
]
# the branches of cd_step_stats the oracle config set does not reach
EXTRA = [
    RBMConfig(n_visible=13, n_hidden=9, gradient="enhanced", k=2),
    RBMConfig(n_visible=13, n_hidden=9, visible="gaussian", learn_variance=True),
    RBMConfig(n_visible=13, n_hidden=9, visible="gaussian", learn_variance=True,
              sample_visible=False, persistent=True),
    RBMConfig(n_visible=13, n_hidden=9, sparsity_target=0.1, sparsity_cost=0.5),
]


def _ids(c):
    return (f"{c.visible}-k{c.k}-p{int(c.persistent)}-sv{c.sample_visible}-{c.error_metric}"
            f"-{c.gradient}-lv{int(c.learn_variance)}-sp{c.sparsity_target}")


def make_case(cfg, batch=6, seed=0):
    rng = np.random.default_rng(seed)
    p = oracle.init_params(cfg, rng)
    p["b"] = rng.standard_normal(cfg.n_visible).astype(np.float32) * 0.1
    p["c"] = rng.standard_normal(cfg.n_hidden).astype(np.float32) * 0.1
    if cfg.learn_variance:
        p["z"] = rng.standard_normal(cfg.n_visible).astype(np.float32) * 0.2
    if cfg.visible == "bernoulli":
        v0 = (rng.random((batch, cfg.n_visible)) < 0.4).astype(np.float32)
    else:
        v0 = rng.standard_normal((batch, cfg.n_visible)).astype(np.float32)
    uniforms = oracle.draw_uniforms(cfg, batch, rng)
    chain = (rng.random((batch, cfg.n_hidden)) < 0.5).astype(np.float32)
    return p, v0, uniforms, chain


def jx(p):
    return J.RBMParams(**p)


def th(p):
    return T.RBMParams(**{k: torch.as_tensor(v) for k, v in p.items()})


def tu(u):
    return {k: torch.as_tensor(v) for k, v in u.items()}


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or TOL))


@pytest.mark.parametrize("cfg", CONFIGS + EXTRA, ids=_ids)
def test_cd_step_stats_and_update(cfg):
    p, v0, u, chain = make_case(cfg)
    tcfg = convert_config(cfg)
    chain_arg = chain if cfg.persistent else None
    gj, cj, ej = J.cd_step_stats(jx(p), v0, chain_arg, u, cfg)
    gt, ct, et = T.cd_step_stats(th(p), torch.as_tensor(v0),
                                 None if chain_arg is None else torch.as_tensor(chain_arg),
                                 tu(u), tcfg)
    for name in ("W", "b", "c", "z"):
        if getattr(gj, name) is None:
            assert getattr(gt, name) is None
            continue
        close(getattr(gt, name), getattr(gj, name))
    close(ct, cj)
    close(et, ej)
    if not (cfg.learn_variance or cfg.gradient == "enhanced"):
        g_np, chain_np, err_np, _ = oracle.cd_step_stats(p, v0, chain_arg, u, cfg)
        for name in ("W", "b", "c"):
            close(getattr(gt, name), g_np[name])
        close(ct, chain_np)
        close(et, err_np)

    # momentum + L2 + clip update on top of the same gradients
    ucfg = cfg.replace(lr=0.07, momentum=0.9, l2=1e-3, grad_clip=0.05)
    rng = np.random.default_rng(42)
    vel = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32) for k, v in p.items()}
    pj, vj = J.apply_update(jx(p), jx(vel), gj, ucfg, epoch=3)
    pt, vt = T.apply_update(th(p), th(vel), gt, convert_config(ucfg), epoch=3)
    for name in p:
        close(getattr(pt, name), getattr(pj, name))
        close(getattr(vt, name), getattr(vj, name))


@pytest.mark.parametrize("visible", ["bernoulli", "gaussian"])
def test_conditionals_and_free_energy(visible):
    cfg = RBMConfig(n_visible=17, n_hidden=11, visible=visible)
    tcfg = convert_config(cfg)
    p, v0, _, _ = make_case(cfg)
    hj = J.hidden_mean(jx(p), v0, cfg)
    close(T.hidden_mean(th(p), torch.as_tensor(v0), tcfg), hj)
    close(T.hidden_mean(th(p), torch.as_tensor(v0), tcfg), oracle.hidden_mean(p, v0))
    h = np.array(hj, np.float32)
    close(T.visible_mean(th(p), torch.as_tensor(h), tcfg), J.visible_mean(jx(p), h, cfg))
    close(T.free_energy(th(p), torch.as_tensor(v0), tcfg), J.free_energy(jx(p), v0, cfg),
          rtol=1e-4, atol=1e-4)
    close(T.free_energy(th(p), torch.as_tensor(v0), tcfg),
          oracle.free_energy(p, v0, visible), rtol=1e-4, atol=1e-4)


def test_pseudo_likelihood_and_momentum_schedule():
    cfg = RBMConfig(n_visible=13, n_hidden=9, error_metric="pseudo", momentum=0.9,
                    initial_momentum=0.5, momentum_switch_epoch=5)
    tcfg = convert_config(cfg)
    p, v0, _, _ = make_case(cfg)
    for bit in (0, 5, 12):
        close(T.pseudo_likelihood(th(p), torch.as_tensor(v0), bit, tcfg),
              J.pseudo_likelihood(jx(p), v0, bit, cfg), rtol=1e-4, atol=1e-4)
    for ep in (0, 4, 5, 9):
        assert T.resolve_momentum(tcfg, ep) == pytest.approx(float(J.resolve_momentum(cfg, ep)))


def test_bf16_compute_matches_jax():
    """compute_dtype='bfloat16': both sides round the matmul operands to bf16
    and accumulate in fp32, so the products agree to fp32 summation noise."""
    cfg = RBMConfig(n_visible=13, n_hidden=9, compute_dtype="bfloat16")
    p, v0, _, _ = make_case(cfg)
    close(T.hidden_mean(th(p), torch.as_tensor(v0), convert_config(cfg)),
          J.hidden_mean(jx(p), v0, cfg))


def test_init_params_and_velocity():
    tcfg = convert_config(RBMConfig(n_visible=13, n_hidden=9, learn_variance=True,
                                    visible="gaussian", init="uniform_glorot4"))
    p = T.init_params(tcfg, torch.Generator().manual_seed(0))
    bound = 4.0 * (6.0 / 22) ** 0.5
    assert p.W.shape == (13, 9) and float(p.W.abs().max()) <= bound
    assert p.z is not None and float(p.z.abs().sum()) == 0.0
    v = T.zero_velocity(p)
    assert all(float(t.abs().sum()) == 0.0 for t in v.as_dict().values())
    q = T.init_params(tcfg, torch.Generator().manual_seed(0))
    assert torch.equal(p.W, q.W)  # seeded: reproducible

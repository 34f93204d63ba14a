"""ops.cd_epoch_cuda against the JAX train kernel itself.

The port's plain version of the run (``cd_train_run_plain``, which is also
what the CUDA wrapper runs on CPU tensors) against
``mdbn_tpu.ops.cd_epoch_pallas.make_pallas_train_fn(cfg, E, interpret=True,
inject=True)``, the Pallas kernel in the TPU interpreter, run as
tests/test_pallas_dp.py:120-132 runs it. Data, initial state and uniforms
are made with numpy from a seed and handed to both. Tolerance rtol=2e-4,
atol=2e-6 (tests/test_pallas_dp.py:91-101): fp32 on both sides, summed in
another order, over E*nb updates.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mdbn_tpu.config import RBMConfig
from mdbn_tpu.core.rbm_math import RBMParams
from mdbn_tpu.core.state import TrainState
from mdbn_tpu.ops.cd_epoch_pallas import (_prepare_run, harden_uniform_blocks,
                                          make_pallas_train_fn)
from mdbn_tpu_torch.convert import convert_config, state_from_numpy
from mdbn_tpu_torch.ops import cd_epoch_cuda as K

TOL = dict(rtol=2e-4, atol=2e-6)
E = 2

# Four tiny cases, one interpret-mode compile each (the compile is most of a
# case's time): Bernoulli CD-1, run with shuffle=True (test_shuffled_order_*),
# and the three below.
BERNOULLI_CD1 = RBMConfig(n_visible=16, n_hidden=8, batch_size=4, lr=0.1)
CASES = {
    "pcd-k2-momentum-l2": RBMConfig(n_visible=24, n_hidden=12, batch_size=4, k=2,
                                    persistent=True, momentum=0.5, l2=1e-3, lr=0.1),
    "gaussian-meanfield": RBMConfig(n_visible=16, n_hidden=8, batch_size=4,
                                    visible="gaussian", lr=0.01),
    "schedule-sparsity-clip-xent": RBMConfig(
        n_visible=16, n_hidden=8, batch_size=4, lr=0.1, momentum=0.9,
        initial_momentum=0.5, momentum_switch_epoch=1, sparsity_target=0.1,
        sparsity_cost=0.5, grad_clip=0.05, error_metric="xent"),
}


def draw(cfg, nb, seed=7):
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    rng = np.random.default_rng(seed)
    u = {"h0": rng.random((E, nb, B, H), np.float32),
         "h": rng.random((E, nb, cfg.k, B, H), np.float32)}
    if cfg.resolved_sample_visible:
        if cfg.visible == "bernoulli":
            u["v"] = rng.random((E, nb, cfg.k, B, V), np.float32)
        else:
            u["noise"] = rng.standard_normal((E, nb, cfg.k, B, V)).astype(np.float32)
    return u


def numpy_state(cfg, rng):
    """A JAX TrainState made with numpy: W ~ 0.01 N(0, 1), non-zero biases
    and chain (so every term of the update is exercised), zero velocity."""
    V, H, B = cfg.n_visible, cfg.n_hidden, cfg.batch_size

    def f32(x):
        return jnp.asarray(np.asarray(x, np.float32))

    params = RBMParams(W=f32(rng.standard_normal((V, H)) * 0.01),
                       b=f32(rng.standard_normal(V) * 0.1),
                       c=f32(rng.standard_normal(H) * 0.1))
    zeros = RBMParams(W=f32(np.zeros((V, H))), b=f32(np.zeros(V)), c=f32(np.zeros(H)))
    return TrainState(params=params, velocity=zeros, chain_h=f32(rng.random((B, H)) < 0.5),
                      key=jnp.asarray(np.zeros(2, np.uint32)),
                      epoch=jnp.asarray(np.int32(0)))


def make_inputs(cfg, nb, seed=3):
    rng = np.random.default_rng(seed)
    n = nb * cfg.batch_size
    if cfg.visible == "bernoulli":
        data = (rng.random((n, cfg.n_visible)) < 0.3).astype(np.float32)
    else:
        data = rng.standard_normal((n, cfg.n_visible)).astype(np.float32)
    return data, numpy_state(cfg, rng)


def to_port(st):
    tree = {"params": {k: np.asarray(v) for k, v in st.params._asdict().items()
                       if v is not None},
            "velocity": {k: np.asarray(v) for k, v in st.velocity._asdict().items()
                         if v is not None},
            "chain_h": np.asarray(st.chain_h), "epoch": 0}
    return state_from_numpy(tree, device="cpu")


def run_both(cfg, nb, order=None):
    data, st = make_inputs(cfg, nb)
    u = draw(cfg, nb)
    fn = make_pallas_train_fn(cfg, E, interpret=True, inject=True)
    jst, jerrs = fn(st, jnp.asarray(data), {k: jnp.asarray(v) for k, v in u.items()})
    tcfg = convert_config(cfg)
    tst = to_port(st)
    if order is None:
        order = K.batch_order(tcfg, nb, E, None)
    got = K.cd_train_run_plain(tcfg, tst.params, tst.velocity, tst.chain_h,
                               torch.as_tensor(data), order, 0,
                               {k: torch.as_tensor(v) for k, v in u.items()})
    return jst, jerrs, got


def check(jst, jerrs, got):
    params, velocity, chain, errs = got
    for name in ("W", "b", "c"):
        np.testing.assert_allclose(getattr(params, name).numpy(),
                                   np.asarray(getattr(jst.params, name)), **TOL)
        np.testing.assert_allclose(getattr(velocity, name).numpy(),
                                   np.asarray(getattr(jst.velocity, name)), **TOL)
    np.testing.assert_array_equal(chain.numpy(), np.asarray(jst.chain_h))
    np.testing.assert_allclose(errs.numpy(), np.asarray(jerrs), **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_run_matches_pallas_kernel(name):
    check(*run_both(CASES[name], nb=4))


def test_shuffled_order_matches_pallas_kernel():
    """Bernoulli CD-1 with shuffle=True: the TPU kernel permutes super-batches
    of U minibatches; its table, expanded as perm[s]*U + u, is the port's
    minibatch order."""
    cfg = BERNOULLI_CD1.replace(shuffle=True)
    nb = 12
    data, st = make_inputs(cfg, nb)
    _, unroll, nsteps, perm, _, _ = _prepare_run(cfg, st, data.shape[0], E)
    assert nsteps > 1, "the case must shuffle more than one super-batch"
    perm = np.asarray(perm)
    order = torch.as_tensor(np.stack([
        (perm[e][:, None] * unroll + np.arange(unroll)[None, :]).reshape(-1)
        for e in range(E)]).astype(np.int32))
    assert sorted(order[0].tolist()) == list(range(nb))
    check(*run_both(cfg, nb, order))


def test_harden_uniform_blocks_matches_jax():
    """The port's hardening nudges the same draws as the JAX package's (a
    wide eps=0.05 so that many draws move)."""
    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=4, lr=0.1, k=2,
                    persistent=True, momentum=0.5)
    nb = 2
    data, st = make_inputs(cfg, nb)
    u = draw(cfg, nb)
    want = harden_uniform_blocks(cfg, st, data, {k: jnp.asarray(v) for k, v in u.items()},
                                 E, eps=0.05)
    tst = to_port(st)
    got = K.harden_uniform_blocks(convert_config(cfg), tst.params, tst.velocity, tst.chain_h,
                                  torch.as_tensor(data),
                                  {k: torch.as_tensor(v) for k, v in u.items()}, E, eps=0.05)
    assert set(got) == set(u)
    for k in u:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
    assert any(not np.array_equal(got[k].numpy(), u[k]) for k in u)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    cfg = convert_config(BERNOULLI_CD1)
    st = state_from_numpy({"params": {"W": np.full((16, 8), 0.01, np.float32),
                                      "b": np.zeros(16, np.float32),
                                      "c": np.zeros(8, np.float32)},
                           "velocity": {"W": np.zeros((16, 8), np.float32),
                                        "b": np.zeros(16, np.float32),
                                        "c": np.zeros(8, np.float32)},
                           "chain_h": np.zeros((4, 8), np.float32), "epoch": 0},
                          device="cpu")
    data = torch.as_tensor((np.random.default_rng(0).random((16, 16)) < 0.3)
                           .astype(np.float32))
    order = K.batch_order(cfg, 4, E, None)
    before = K.cd_train_launches
    a = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                       torch.Generator().manual_seed(1))
    b = K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                             None, torch.Generator().manual_seed(1))
    assert K.cd_train_launches == before  # no kernel on the CPU
    torch.testing.assert_close(a[0].W, b[0].W, rtol=0, atol=0)
    torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)


def test_batch_order_and_uniform_layout():
    cfg = convert_config(RBMConfig(n_visible=16, n_hidden=8, batch_size=4, k=2,
                                   visible="gaussian", sample_visible=True, shuffle=True))
    order = K.batch_order(cfg, 5, 3, torch.Generator().manual_seed(0))
    assert order.shape == (3, 5) and order.dtype == torch.int32
    assert all(sorted(r) == list(range(5)) for r in order.tolist())
    u = K.draw_uniform_blocks(cfg, torch.Generator().manual_seed(0), 3, 5)
    assert u["h0"].shape == (3, 5, 4, 8) and u["h"].shape == (3, 5, 2, 4, 8)
    assert u["noise"].shape == (3, 5, 2, 4, 16) and "v" not in u
    unshuffled = K.batch_order(cfg.replace(shuffle=False), 5, 2, None)
    assert unshuffled.tolist() == [list(range(5))] * 2

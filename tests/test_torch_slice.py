"""The training slice end to end: DBN and MDBN, port against the JAX package.

Injected: each layer trains on both sides from the same initial state and
the same uniforms (JAX: the interpret-mode Pallas kernel via
``make_pallas_train_fn(..., inject=True)``; port: ``train_rbm(uniforms=...)``),
the next layer's data is the layer's ``transform``, and the codes come from
``stack_transform``. Per-layer errors and parameters are held at rtol=2e-4,
atol=2e-6 (the kernel tolerance of tests/test_pallas_dp.py); codes, which are
sigmoids of those parameters, at atol=1e-5.

Uninjected: ``DBN.train`` / ``MDBN.train`` on the port's CPU eager engine;
the port's ``transform`` must equal the JAX package's ``stack_transform`` on
the converted parameters at rtol=atol=2e-5 (tests/test_parity_core.py:20).
"""

import numpy as np
import torch

import jax.numpy as jnp
import mdbn_tpu.config as jconfig
from mdbn_tpu.config import DBNConfig, MDBNConfig, RBMConfig
from mdbn_tpu.core.rbm_math import RBMParams
from mdbn_tpu.core.state import TrainState
from mdbn_tpu.data.synthetic import mnist_like, tcga_like
from mdbn_tpu.ops.cd_epoch_pallas import make_pallas_train_fn
from mdbn_tpu.ops.transform import stack_transform as j_stack_transform
from mdbn_tpu.ops.transform import transform as j_transform
from mdbn_tpu_torch import DBN as TDBN, MDBN as TMDBN
from mdbn_tpu_torch.convert import (convert_config, dbn_from_numpy, mdbn_from_numpy,
                                    stack_to_numpy, state_from_numpy)
from mdbn_tpu_torch.ops.transform import stack_transform as t_stack_transform
from mdbn_tpu_torch.ops.transform import transform as t_transform
from mdbn_tpu_torch.train.trainer import train_rbm

TOL = dict(rtol=2e-4, atol=2e-6)
CODE_TOL = dict(rtol=0, atol=1e-5)
E = 2


def draw(cfg, nb, seed):
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    rng = np.random.default_rng(seed)
    u = {"h0": rng.random((E, nb, B, H), np.float32),
         "h": rng.random((E, nb, cfg.k, B, H), np.float32)}
    if cfg.resolved_sample_visible:
        key = "v" if cfg.visible == "bernoulli" else "noise"
        u[key] = (rng.random((E, nb, cfg.k, B, V), np.float32) if key == "v"
                  else rng.standard_normal((E, nb, cfg.k, B, V)).astype(np.float32))
    return u


def numpy_state(cfg, seed):
    """A fresh JAX TrainState made with numpy: W ~ init_scale * N(0, 1),
    zero biases, velocity and chain."""
    V, H = cfg.n_visible, cfg.n_hidden

    def zeros(*shape):
        return jnp.asarray(np.zeros(shape, np.float32))

    W = np.random.default_rng(seed).standard_normal((V, H)) * cfg.init_scale
    return TrainState(params=RBMParams(W=jnp.asarray(W.astype(np.float32)), b=zeros(V),
                                       c=zeros(H)),
                      velocity=RBMParams(W=zeros(V, H), b=zeros(V), c=zeros(H)),
                      chain_h=zeros(cfg.batch_size, H),
                      key=jnp.asarray(np.zeros(2, np.uint32)),
                      epoch=jnp.asarray(np.int32(0)))


def train_layer_both(cfg, jdata, tdata, seed):
    """One layer on both sides, checked; returns (jax params, port params, port cfg)."""
    nb = jdata.shape[0] // cfg.batch_size
    u = draw(cfg, nb, seed)
    st = numpy_state(cfg, seed)
    fn = make_pallas_train_fn(cfg, E, interpret=True, inject=True)
    jst, jerrs = fn(st, jdata, {k: jnp.asarray(v) for k, v in u.items()})
    tree = {"params": {k: np.asarray(v) for k, v in st.params._asdict().items() if v is not None},
            "velocity": {k: np.asarray(v) for k, v in st.velocity._asdict().items()
                         if v is not None},
            "chain_h": np.asarray(st.chain_h), "epoch": 0}
    tcfg = convert_config(cfg)
    tst, metrics = train_rbm(tdata, tcfg, state=state_from_numpy(tree, device="cpu"),
                             uniforms={k: torch.as_tensor(v) for k, v in u.items()})
    assert metrics.engine == "eager"  # the CPU runs the kernel's plain version
    for name in ("W", "b", "c"):
        np.testing.assert_allclose(getattr(tst.params, name).numpy(),
                                   np.asarray(getattr(jst.params, name)), **TOL)
    np.testing.assert_allclose(metrics.errors, np.asarray(jerrs), **TOL)
    return jst.params, tst.params, tcfg


# The DBN's bottom layer (24 -> 8, CD-1) is also the MDBN's joint RBM (3 towers
# x 8 codes), and the three towers share one config: the module compiles the
# interpret-mode kernel three times, which is most of its time.
DBN_CFG = DBNConfig(layer_sizes=[8, 6], epochs=E, batch_size=4, lr=0.1)
TOWER_CFG = DBNConfig(layer_sizes=[8], visible="gaussian", epochs=E, batch_size=4,
                      gaussian_lr=0.01)


def test_dbn_layerwise_inject_matches_jax():
    data = mnist_like(16, n_features=24, seed=4)
    dcfg = DBN_CFG
    jrep, trep = jnp.asarray(data), torch.as_tensor(data)
    jlayers, tlayers = [], []
    for l in range(2):
        cfg = dcfg.rbm_config(l, jrep.shape[1])
        jp, tp, tcfg = train_layer_both(cfg, jrep, trep, seed=10 + l)
        jlayers.append((jp, cfg))
        tlayers.append((tp, tcfg))
        jrep, trep = j_transform(jp, jrep, cfg), t_transform(tp, trep, tcfg)
        np.testing.assert_allclose(trep.numpy(), np.asarray(jrep), **CODE_TOL)
    jcodes = np.asarray(j_stack_transform(jlayers, jnp.asarray(data)))
    np.testing.assert_allclose(t_stack_transform(tlayers, torch.as_tensor(data)).numpy(),
                               jcodes, **CODE_TOL)
    # the JAX-trained stack carried across with convert.py computes the same codes
    dbn = dbn_from_numpy(dcfg, [(_np(p), c) for p, c in jlayers], device="cpu")
    np.testing.assert_allclose(dbn.transform(data).numpy(), jcodes, rtol=2e-5, atol=2e-5)


def test_mdbn_layerwise_inject_matches_jax():
    # three towers of one shape (each with its own data and draws)
    mods, _ = tcga_like(16, dims={"ge": 12, "meth": 12, "mirna": 12}, seed=1)
    cfg = TOWER_CFG.rbm_config(0, 12)
    jcodes, tcodes, jtowers = [], [], {}
    for i, name in enumerate(mods):
        jp, tp, tcfg = train_layer_both(cfg, jnp.asarray(mods[name]),
                                        torch.as_tensor(mods[name]), seed=20 + i)
        jtowers[name] = [(_np(jp), cfg)]
        jcodes.append(j_stack_transform([(jp, cfg)], jnp.asarray(mods[name])))
        tcodes.append(t_stack_transform([(tp, tcfg)], torch.as_tensor(mods[name])))
    jcat, tcat = jnp.concatenate(jcodes, axis=1), torch.cat(tcodes, dim=1)
    jcfg = DBN_CFG.rbm_config(0, jcat.shape[1])
    jp, tp, tcfg = train_layer_both(jcfg, jcat, tcat, seed=30)
    jz = np.asarray(j_transform(jp, jcat, jcfg))
    np.testing.assert_allclose(t_transform(tp, tcat, tcfg).numpy(), jz, **CODE_TOL)
    # the JAX-trained MDBN carried across with convert.py
    mcfg = MDBNConfig(towers={m: TOWER_CFG for m in mods}, joint=jcfg)
    mdbn = mdbn_from_numpy(mcfg, jtowers, (_np(jp), jcfg), device="cpu")
    np.testing.assert_allclose(mdbn.transform(mods).numpy(), jz, rtol=2e-5, atol=2e-5)


def _np(params):
    return {k: np.asarray(v) for k, v in params._asdict().items() if v is not None}


def _jax_layers(model):
    return [(RBMParams(**p), jconfig._from_jsonable(c)) for p, c in stack_to_numpy(model)]


def test_dbn_train_eager_transform_matches_jax():
    data = mnist_like(32, n_features=16, seed=5)
    cfg = convert_config(DBNConfig(layer_sizes=[12, 6], epochs=2, batch_size=8, seed=3))
    dbn = TDBN(cfg, device="cpu").train(data)
    assert [len(h) for h in dbn.history] == [2, 2]
    codes = dbn.transform(data)
    assert codes.shape == (32, 6) and bool(torch.isfinite(codes).all())
    np.testing.assert_allclose(codes.numpy(),
                               np.asarray(j_stack_transform(_jax_layers(dbn), jnp.asarray(data))),
                               rtol=2e-5, atol=2e-5)


def test_mdbn_train_eager_transform_matches_jax():
    mods, _ = tcga_like(24, dims={"ge": 12, "meth": 10, "mirna": 6}, seed=2)
    cfg = convert_config(MDBNConfig(
        towers={m: DBNConfig(layer_sizes=[8, 4], visible="gaussian", epochs=2,
                             batch_size=8, seed=i) for i, m in enumerate(mods)},
        joint=RBMConfig(n_visible=1, n_hidden=6, epochs=2, batch_size=8, k=2,
                        persistent=True, momentum=0.5)))
    mdbn = TMDBN(cfg, device="cpu").train(mods)
    codes = mdbn.transform(mods)
    assert codes.shape == (24, 6) and set(mdbn.history) == {"ge", "meth", "mirna", "joint"}
    jcat = jnp.concatenate([j_stack_transform(_jax_layers(mdbn.towers[m]), jnp.asarray(mods[m]))
                            for m in cfg.towers], axis=1)
    jj = mdbn.joint
    want = j_transform(RBMParams(**jj.params_numpy()), jcat, jconfig._from_jsonable(
        jconfig._to_jsonable(jj.cfg)))
    np.testing.assert_allclose(codes.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)

"""The port's phase-2 trainers (mdbn_tpu_torch/train/{finetune,autoencoder,
labeled,updown}.py) and the DBN / MDBN methods on them, against the JAX
package on the CPU.

The same numpy weights and data go to both packages, and the port is fed
the JAX functions' own draws: the tests rebuild them with ``jax.random``
exactly as ``mdbn_tpu/train/*.py`` split their keys (an epoch key split from
``PRNGKey(seed)``, one key a minibatch, split into the step's keys: the
``*_draws`` helpers below name them as the port's ``draws`` take them). The
classifier's head and the label top's initial weights are the reference's
normals, injected too. Tolerance rtol = atol = 2e-5 on every loss,
parameter and output: both sides sample the same states, and float32 sums
in another order differ far below it (a flipped sample would show as
O(lr / B)). Small sizes (stacks of 12 -> 8 -> 6, two towers, batch 10, 2-5
minibatches, 1-2 epochs), on one core in well under a minute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbn_tpu.config import DBNConfig, MDBNConfig, RBMConfig
from mdbn_tpu.core.rbm_math import RBMParams as JParams
from mdbn_tpu.core.state import TrainState
from mdbn_tpu.models.dbn import DBN as JDBN
from mdbn_tpu.models.mdbn import MDBN as JMDBN
from mdbn_tpu.models.rbm import RBM as JRBM
from mdbn_tpu.train import autoencoder as JA
from mdbn_tpu.train import finetune as JF
from mdbn_tpu.train import labeled as JL
from mdbn_tpu.train import updown as JU
from mdbn_tpu_torch.convert import (convert_config, dbn_from_numpy, finetuned_to_numpy,
                                    mdbn_from_numpy, set_finetuned_from_numpy)
from mdbn_tpu_torch.core.rbm_math import RBMParams
from mdbn_tpu_torch.train import autoencoder as TA
from mdbn_tpu_torch.train import finetune as TF
from mdbn_tpu_torch.train import labeled as TL
from mdbn_tpu_torch.train import updown as TU

TOL = dict(rtol=2e-5, atol=2e-5)
B = 10


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **TOL)


def _close_params(got, want):
    for k in ("W", "b", "c"):
        _close(getattr(got, k), getattr(want, k))


def _close_pairs(got, want):
    for (gw, gb), (ww, wb) in zip(got, want, strict=True):
        _close(gw, ww)
        _close(gb, wb)


# -- models and data ---------------------------------------------------------------


def _np_params(V, H, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return {"W": rng.normal(0, scale, (V, H)).astype(np.float32),
            "b": rng.normal(0, 0.3, V).astype(np.float32),
            "c": rng.normal(0, 0.3, H).astype(np.float32)}


def _jparams(p):
    return JParams(W=jnp.asarray(p["W"]), b=jnp.asarray(p["b"]), c=jnp.asarray(p["c"]))


def _tparams(p):
    return RBMParams(W=_t(p["W"]), b=_t(p["b"]), c=_t(p["c"]))


def _jrbm(cfg, p):
    """A trained JAX RBM holding ``p`` (zero velocity and chain)."""
    params = _jparams(p)
    st = TrainState(params=params, velocity=jax.tree.map(jnp.zeros_like, params),
                    chain_h=jnp.zeros((cfg.batch_size, cfg.n_hidden), jnp.float32),
                    key=jax.random.PRNGKey(0), epoch=jnp.int32(0))
    return JRBM(cfg, state=st)


def _stack_np(sizes, seed, visible="bernoulli", **kw):
    cfg = DBNConfig(layer_sizes=list(sizes[1:]), visible=visible, batch_size=B, **kw)
    return cfg, [(_np_params(v, h, seed + i), cfg.rbm_config(i, v))
                 for i, (v, h) in enumerate(zip(sizes, sizes[1:]))]


def _layers(np_layers):
    """(JAX layers, port layers) of the same numpy weights."""
    return ([(_jparams(p), c) for p, c in np_layers],
            [(_tparams(p), convert_config(c)) for p, c in np_layers])


def _data(n, V, seed, visible="bernoulli"):
    rng = np.random.default_rng(seed)
    if visible == "bernoulli":
        return (rng.random((n, V)) < 0.4).astype(np.float32)
    return rng.normal(size=(n, V)).astype(np.float32)


def _labels(n, C, seed, unlabeled=0.0):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, C, n)
    if unlabeled:
        lab = np.where(rng.random(n) < unlabeled, -1, lab)
    return lab.astype(np.int32)


TOWERS = {"ge": (12, 8, 6), "meth": (10, 5)}


def _mdbn_np(seed, codes=7):
    cfg = MDBNConfig(towers={m: DBNConfig(layer_sizes=list(s[1:]), visible="gaussian",
                                          batch_size=B) for m, s in TOWERS.items()},
                     joint=RBMConfig(n_visible=1, n_hidden=codes, batch_size=B))
    towers = {m: [(_np_params(v, h, seed + 10 * j + i), cfg.towers[m].rbm_config(i, v))
                  for i, (v, h) in enumerate(zip(s, s[1:]))]
              for j, (m, s) in enumerate(TOWERS.items())}
    width = sum(s[-1] for s in TOWERS.values())
    joint = (_np_params(width, codes, seed + 99), cfg.joint.replace(n_visible=width))
    return cfg, towers, joint


def _models(kind, seed):
    """A JAX model and the port's (on the CPU) with the same weights."""
    if kind == "dbn":
        cfg, np_layers = _stack_np((12, 8, 6), seed)
        jm = JDBN(cfg)
        jm.layers = [_jrbm(c, p) for p, c in np_layers]
        return jm, dbn_from_numpy(cfg, np_layers, device="cpu")
    cfg, towers, joint = _mdbn_np(seed)
    jm = JMDBN(cfg)
    for m, layers in towers.items():
        jm.towers[m] = JDBN(cfg.towers[m])
        jm.towers[m].layers = [_jrbm(c, p) for p, c in layers]
    jm.joint = _jrbm(joint[1], joint[0])
    return jm, mdbn_from_numpy(cfg, towers, joint, device="cpu")


def _mods(n, seed):
    rng = np.random.default_rng(seed)
    return {m: rng.normal(size=(n, s[0])).astype(np.float32) for m, s in TOWERS.items()}


# -- the reference's draws, rebuilt --------------------------------------------------


def _draw(key, shape, kind):
    if kind == "n":
        return jax.random.normal(key, shape, jnp.float32)
    if kind == "g":
        return jax.random.uniform(key, shape, jnp.float32, 1e-20, 1.0)
    return jax.random.uniform(key, shape)


def _step(key, nk, spec):
    """One step's draws: ``spec`` lists (name, key index, shape, kind) of a
    ``jax.random.split(key, nk)``."""
    keys = jax.random.split(key, nk)
    return {name: _t(_draw(keys[i], shape, kind)) for name, i, shape, kind in spec}


def _epochs(seed, epochs, nb, nk, spec, init_shape=None):
    """The trainers' key schedule: (init draw split off first when asked),
    then per epoch ``key, kepoch = split(key)`` and one key a minibatch."""
    key = jax.random.PRNGKey(seed)
    out = {}
    if init_shape is not None:
        key, kinit = jax.random.split(key)
        out["init"] = _t(jax.random.normal(kinit, init_shape, jnp.float32))
    steps = []
    for _ in range(epochs):
        key, kep = jax.random.split(key)
        steps.append([_step(k, nk, spec) for k in jax.random.split(kep, nb)])
    out["steps"] = steps
    return out


def label_top_spec(n_code, C, H, k, semi):
    spec = [("h0", 0, (B, H), "u")]
    for t in range(k):
        spec += [(f"code{t}", 3 * t + 1, (B, n_code), "u"), (f"label{t}", 3 * t + 2, (B, C), "g"),
                 (f"h{t + 1}", 3 * t + 3, (B, H), "u")]
    if semi:
        spec.append(("fill", 3 * k + 1, (B, C), "g"))
    return 3 * k + 1 + semi, spec


def _sleep_kind(cfg):
    if cfg.visible == "bernoulli":
        return "u"
    return "n" if cfg.resolved_sample_visible else None


def updown_spec(cfgs, top_cfg, k):
    L = len(cfgs)
    spec = [(f"wake{l}", l, (B, c.n_hidden), "u") for l, c in enumerate(cfgs)]
    spec.append(("h0", L, (B, top_cfg.n_hidden), "u"))
    for t in range(k):
        spec += [(f"v{t}", L + 1 + 2 * t, (B, top_cfg.n_visible), "u"),
                 (f"h{t + 1}", L + 2 + 2 * t, (B, top_cfg.n_hidden), "u")]
    spec += [(f"sleep{l}", L + 1 + 2 * k + l, (B, c.n_visible), _sleep_kind(c))
             for l, c in enumerate(cfgs) if _sleep_kind(c)]
    return 2 * L + 2 * k + 2, spec


def updown_labeled_spec(cfgs, C, H, k, semi):
    L, n_code = len(cfgs), cfgs[-1].n_hidden
    spec = [(f"wake{l}", l, (B, c.n_hidden), "u") for l, c in enumerate(cfgs)]
    spec.append(("h0", L, (B, H), "u"))
    for t in range(k):
        spec += [(f"code{t}", L + 1 + 3 * t, (B, n_code), "u"),
                 (f"label{t}", L + 2 + 3 * t, (B, C), "g"),
                 (f"h{t + 1}", L + 3 + 3 * t, (B, H), "u")]
    spec += [(f"sleep{l}", L + 3 * k + 1 + l, (B, c.n_visible), _sleep_kind(c))
             for l, c in enumerate(cfgs) if _sleep_kind(c)]
    if semi:
        spec.append(("fill", 2 * L + 3 * k + 1, (B, C), "g"))
    return 2 * L + 3 * k + 1 + semi, spec


def updown_mdbn_spec(tower_cfgs, joint_cfg, k, label=None):
    """The MDBN steps' sequential key use (``next(keys)``); ``label`` =
    (n_classes, label-top hidden, semi) for the labeled variant."""
    spec, i = [], 0
    for m, cfgs in tower_cfgs.items():
        for l, c in enumerate(cfgs):
            spec.append((f"wake:{m}:{l}", i, (B, c.n_hidden), "u"))
            i += 1
    n_code, width = joint_cfg.n_hidden, joint_cfg.n_visible
    if label is None:
        spec.append(("h0", i, (B, joint_cfg.n_hidden), "u"))
        i += 1
        for t in range(k):
            spec += [(f"v{t}", i, (B, width), "u"), (f"h{t + 1}", i + 1, (B, n_code), "u")]
            i += 2
        nk = sum(2 * len(c) for c in tower_cfgs.values()) + 2 * k + 1
    else:
        C, H, semi = label
        spec.append(("joint_wake", i, (B, n_code), "u"))
        i += 1
        if semi:
            spec.append(("fill", i, (B, C), "g"))
            i += 1
        spec.append(("h0", i, (B, H), "u"))
        i += 1
        for t in range(k):
            spec += [(f"code{t}", i, (B, n_code), "u"), (f"label{t}", i + 1, (B, C), "g"),
                     (f"h{t + 1}", i + 2, (B, H), "u")]
            i += 3
        spec.append(("joint_sleep", i, (B, width), "u"))
        i += 1
        nk = sum(2 * len(c) for c in tower_cfgs.values()) + 3 * k + 3 + semi
    for m, cfgs in tower_cfgs.items():
        for l in range(len(cfgs) - 1, -1, -1):
            kind = _sleep_kind(cfgs[l])
            if kind:
                spec.append((f"sleep:{m}:{l}", i, (B, cfgs[l].n_visible), kind))
                i += 1
    return nk, spec


def dream_draws(seed, n, n_code, C, H, n_gibbs, labeled):
    """``generate_labeled_model`` (``labeled``) / ``generate_class_conditional``'s draws."""
    key = jax.random.PRNGKey(seed)
    out = {}
    if labeled:
        key, kinit, klab = jax.random.split(key, 3)
        out["init_label"] = _t(_draw(klab, (n, C), "g"))
    else:
        key, kinit = jax.random.split(key)
    out["init"] = _t(jax.random.uniform(kinit, (n, n_code)))
    hs, codes, labs = [], [], []
    for k in jax.random.split(key, n_gibbs):
        ks = jax.random.split(k, 3 if labeled else 2)
        hs.append(jax.random.uniform(ks[0], (n, H)))
        codes.append(jax.random.uniform(ks[1], (n, n_code)))
        if labeled:
            labs.append(_draw(ks[2], (n, C), "g"))
    out["h"], out["code"] = _t(jnp.stack(hs)), _t(jnp.stack(codes))
    if labeled:
        out["label"] = _t(jnp.stack(labs))
    return out


# -- the trainers --------------------------------------------------------------------


@pytest.mark.parametrize("visible", ["bernoulli", "gaussian"])
def test_finetune_stack(visible):
    cfg, np_layers = _stack_np((12, 8, 6), 1, visible)
    jl, tl = _layers(np_layers)
    x, y = _data(30, 12, 2, visible), _labels(30, 3, 3)
    js, jh, jhist = JF.finetune_stack(jl, x, y, 3, epochs=2, lr=0.1, batch_size=B, seed=4)
    head = _t(jax.random.normal(jax.random.PRNGKey(4), (6, 3), jnp.float32))
    ts, th, thist = TF.finetune_stack(tl, x, y, 3, epochs=2, lr=0.1, batch_size=B,
                                      draws={"head": head})
    _close(thist, jhist)
    for g, w in zip(ts, js, strict=True):
        _close_params(g, w)
    _close(th[0], jh[0])
    _close(th[1], jh[1])
    _close(TF.predict_stack(list(zip(ts, [c for _, c in tl])), th, x),
           JF.predict_stack(list(zip(js, [c for _, c in jl])), jh, x))


def test_finetune_mdbn():
    cfg, towers, joint = _mdbn_np(5)
    jt = {m: _layers(l)[0] for m, l in towers.items()}
    tt = {m: _layers(l)[1] for m, l in towers.items()}
    mods, y = _mods(40, 6), _labels(40, 3, 7)
    jtp, jjp, jh, jhist = JF.finetune_mdbn(jt, (_jparams(joint[0]), joint[1]), mods, y, 3,
                                           epochs=2, batch_size=B, seed=2)
    head = _t(jax.random.normal(jax.random.PRNGKey(2), (7, 3), jnp.float32))
    ttp, tjp, th, thist = TF.finetune_mdbn(tt, (_tparams(joint[0]), convert_config(joint[1])),
                                           mods, y, 3, epochs=2, batch_size=B,
                                           draws={"head": head})
    _close(thist, jhist)
    for m in TOWERS:
        for g, w in zip(ttp[m], jtp[m], strict=True):
            _close_params(g, w)
    _close_params(tjp, jjp)
    _close(th[0], jh[0])


@pytest.mark.parametrize("visible", ["bernoulli", "gaussian"])
def test_autoencoder_stack_and_resume(visible):
    cfg, np_layers = _stack_np((12, 8, 6), 11, visible)
    jl, tl = _layers(np_layers)
    x = _data(30, 12, 12, visible)
    js, jd, jhist = JA.finetune_autoencoder_stack(jl, x, epochs=2, lr=1e-3, batch_size=B)
    ts, td, thist = TA.finetune_autoencoder_stack(tl, x, epochs=2, lr=1e-3, batch_size=B)
    _close(thist, jhist)
    for g, w in zip(ts, js, strict=True):
        _close_params(g, w)
    for g, w in zip(td, jd, strict=True):
        _close(g, w)
    # resume from the stored decoder
    jl2 = [(p, c) for p, (_, c) in zip(js, jl)]
    tl2 = [(p, c) for p, (_, c) in zip(ts, tl)]
    _, jd2, jh2 = JA.finetune_autoencoder_stack(jl2, x, epochs=1, batch_size=B, decoder=jd)
    _, td2, th2 = TA.finetune_autoencoder_stack(tl2, x, epochs=1, batch_size=B, decoder=td)
    _close(th2, jh2)
    _close(td2[0], jd2[0])
    _close(TA.reconstruct_stack(tl2, td2, x[:7]), JA.reconstruct_stack(jl2, jd2, x[:7]))


def test_autoencoder_mdbn():
    cfg, towers, joint = _mdbn_np(15)
    jt = {m: _layers(l)[0] for m, l in towers.items()}
    tt = {m: _layers(l)[1] for m, l in towers.items()}
    mods = _mods(30, 16)
    jtp, jjp, jd, jhist = JA.finetune_autoencoder_mdbn(jt, (_jparams(joint[0]), joint[1]),
                                                       mods, epochs=2, batch_size=B)
    tj = (_tparams(joint[0]), convert_config(joint[1]))
    ttp, tjp, td, thist = TA.finetune_autoencoder_mdbn(tt, tj, mods, epochs=2, batch_size=B)
    _close(thist, jhist)
    _close_params(tjp, jjp)
    for m in jd:
        for g, w in zip(td[m], jd[m], strict=True):
            _close(g, w)
    got = TA.reconstruct_mdbn({m: [(p, c) for p, (_, c) in zip(ttp[m], tt[m])] for m in tt},
                              (tjp, tj[1]), td, mods)
    want = JA.reconstruct_mdbn({m: [(p, c) for p, (_, c) in zip(jtp[m], jt[m])] for m in jt},
                               (jjp, joint[1]), jd, mods)
    for m in want:
        _close(got[m], want[m])


@pytest.mark.parametrize("semi,k,momentum,l2", [(False, 1, 0.0, 0.0), (True, 2, 0.5, 1e-3)])
def test_fit_label_top(semi, k, momentum, l2):
    cfg, np_layers = _stack_np((12, 8, 6), 21)
    jl, tl = _layers(np_layers)
    x, y = _data(40, 12, 22), _labels(40, 3, 23, unlabeled=0.5 if semi else 0.0)
    kw = dict(n_hidden=9, epochs=2, lr=0.1, k=k, batch_size=B, momentum=momentum, l2=l2,
              seed=5)
    jp, jh = JL.fit_label_top(jl, x, y, 3, **kw)
    nk, spec = label_top_spec(6, 3, 9, k, semi)
    draws = _epochs(5, 2, 4, nk, spec, init_shape=(9, 9))
    tp, th = TL.fit_label_top(tl, x, y, 3, **kw, draws=draws)
    _close(th, jh)
    _close_params(tp, jp)
    # resume from the trained top (no init draw)
    jp2, jh2 = JL.fit_label_top(jl, x, y, 3, **{**kw, "epochs": 1}, params=jp)
    tp2, th2 = TL.fit_label_top(tl, x, y, 3, **{**kw, "epochs": 1}, params=tp,
                                draws=_epochs(5, 1, 4, nk, spec))
    _close(th2, jh2)
    _close_params(tp2, jp2)
    # free-energy classification and the exact posterior
    _close(TL.label_top_logits(tp2, tl, x, 3), JL.label_top_logits(jp2, jl, x, 3))
    assert torch.equal(TL.predict_label_top(tp2, tl, x, 3),
                       _t(JL.predict_label_top(jp2, jl, x, 3)).long())


@pytest.mark.parametrize("visible,sample,k", [("bernoulli", None, 1), ("gaussian", True, 2),
                                              ("gaussian", None, 1)])
def test_updown_stack_and_resume(visible, sample, k):
    over = [{"sample_visible": sample}] if sample is not None else []
    cfg, np_layers = _stack_np((12, 8, 6, 5), 31, visible, layer_overrides=over)
    jl, tl = _layers(np_layers)
    x = _data(30, 12, 32, visible)
    jr, jg, jt, jh = JU.finetune_updown_stack(jl, x, epochs=2, lr=0.05, k=k, batch_size=B,
                                              seed=6)
    nk, spec = updown_spec([c for _, c in np_layers[:-1]], np_layers[-1][1], k)
    tr, tg, tt, th = TU.finetune_updown_stack(tl, x, epochs=2, lr=0.05, k=k, batch_size=B,
                                              draws=_epochs(6, 2, 3, nk, spec))
    _close(th, jh)
    for g, w in zip(tr, jr, strict=True):
        _close_params(g, w)
    _close_pairs(tg, jg)
    _close_params(tt, jt)
    # resume from the stored generative weights
    jl2 = [(p, c) for p, (_, c) in zip([*jr, jt], jl)]
    tl2 = [(p, c) for p, (_, c) in zip([*tr, tt], tl)]
    _, jg2, _, jh2 = JU.finetune_updown_stack(jl2, x, epochs=1, lr=0.05, k=k, batch_size=B,
                                              seed=7, gen=jg)
    _, tg2, _, th2 = TU.finetune_updown_stack(tl2, x, epochs=1, lr=0.05, k=k, batch_size=B,
                                              gen=tg, draws=_epochs(7, 1, 3, nk, spec))
    _close(th2, jh2)
    _close_pairs(tg2, jg2)


@pytest.mark.parametrize("semi", [False, True])
def test_updown_labeled(semi):
    cfg, np_layers = _stack_np((12, 8, 6), 41)
    jl, tl = _layers(np_layers)
    top = _np_params(6 + 3, 7, 42, scale=0.3)
    x, y = _data(40, 12, 43), _labels(40, 3, 44, unlabeled=0.5 if semi else 0.0)
    jr, jg, jt, jh = JU.finetune_updown_labeled(jl, _jparams(top), x, y, 3, epochs=2, lr=0.05,
                                                batch_size=B, seed=8)
    nk, spec = updown_labeled_spec([c for _, c in np_layers], 3, 7, 1, semi)
    tr, tg, tt, th = TU.finetune_updown_labeled(tl, _tparams(top), x, y, 3, epochs=2, lr=0.05,
                                                batch_size=B, draws=_epochs(8, 2, 4, nk, spec))
    _close(th, jh)
    for g, w in zip(tr, jr, strict=True):
        _close_params(g, w)
    _close_pairs(tg, jg)
    _close_params(tt, jt)


def _tower_args(seed):
    cfg, towers, joint = _mdbn_np(seed)
    jt = {m: _layers(l)[0] for m, l in towers.items()}
    tt = {m: _layers(l)[1] for m, l in towers.items()}
    tower_cfgs = {m: [c for _, c in l] for m, l in towers.items()}
    return (jt, (_jparams(joint[0]), joint[1]), tt,
            (_tparams(joint[0]), convert_config(joint[1])), tower_cfgs, joint[1])


def test_updown_mdbn():
    jt, jj, tt, tj, tower_cfgs, jcfg = _tower_args(51)
    mods = _mods(30, 52)
    jr, jg, jjp, jh = JU.finetune_updown_mdbn(jt, jj, mods, epochs=2, lr=0.05, batch_size=B,
                                              seed=9)
    nk, spec = updown_mdbn_spec(tower_cfgs, jcfg, 1)
    tr, tg, tjp, th = TU.finetune_updown_mdbn(tt, tj, mods, epochs=2, lr=0.05, batch_size=B,
                                              draws=_epochs(9, 2, 3, nk, spec))
    _close(th, jh)
    for m in TOWERS:
        for g, w in zip(tr[m], jr[m], strict=True):
            _close_params(g, w)
        _close_pairs(tg[m], jg[m])
    _close_params(tjp, jjp)


@pytest.mark.parametrize("semi", [False, True])
def test_updown_mdbn_labeled(semi):
    jt, jj, tt, tj, tower_cfgs, jcfg = _tower_args(61)
    top = _np_params(7 + 3, 8, 62, scale=0.3)
    mods, y = _mods(40, 63), _labels(40, 3, 64, unlabeled=0.5 if semi else 0.0)
    jr, jg, jjr, jjg, jtop, jh = JU.finetune_updown_mdbn_labeled(
        jt, jj, _jparams(top), mods, y, 3, epochs=2, lr=0.05, batch_size=B, seed=10)
    nk, spec = updown_mdbn_spec(tower_cfgs, jcfg, 1, label=(3, 8, semi))
    tr, tg, tjr, tjg, ttop, th = TU.finetune_updown_mdbn_labeled(
        tt, tj, _tparams(top), mods, y, 3, epochs=2, lr=0.05, batch_size=B,
        draws=_epochs(10, 2, 4, nk, spec))
    _close(th, jh)
    for m in TOWERS:
        for g, w in zip(tr[m], jr[m], strict=True):
            _close_params(g, w)
        _close_pairs(tg[m], jg[m])
    _close_params(tjr, jjr)
    _close_pairs([tjg], [jjg])
    _close_params(ttop, jtop)


def test_dreams_and_posterior():
    cfg, np_layers = _stack_np((12, 8, 6), 71)
    jl, tl = _layers(np_layers)
    top = _np_params(6 + 3, 7, 72)
    x = _data(9, 12, 73)
    _close(torch.softmax(TL.label_top_logits(_tparams(top), tl, x, 3), 1),
           jax.nn.softmax(JL.label_top_logits(_jparams(top), jl, x, 3), axis=1))
    want = JL.generate_labeled_model(_jparams(top), jl, 3, n_samples=5, n_gibbs=6, seed=3)
    got = TL.generate_labeled_model(_tparams(top), tl, 3, n_samples=5, n_gibbs=6,
                                    draws=dream_draws(3, 5, 6, 3, 7, 6, labeled=True))
    _close(got, want)
    want = JL.generate_class_conditional(_jparams(top), jl, 2, 3, n_samples=5, n_gibbs=6,
                                         seed=4)
    got = TL.generate_class_conditional(_tparams(top), tl, 2, 3, n_samples=5, n_gibbs=6,
                                        draws=dream_draws(4, 5, 6, 3, 7, 6, labeled=False))
    _close(got, want)
    assert got.shape == (5, 12)
    with pytest.raises(ValueError, match="out of range"):
        TL.generate_class_conditional(_tparams(top), tl, 3, 3)
    # without draws: a generator on the parameters' device, reproducible by seed
    a, b = (TL.generate_class_conditional(_tparams(top), tl, 1, 3, n_samples=4, n_gibbs=3,
                                          seed=5) for _ in range(2))
    assert torch.equal(a, b)


# -- the model methods, the whole slice ------------------------------------------------


def chain_draws(key, n_steps, rows, V, H):
    """ops/sample.py's Gibbs draws (Bernoulli visibles): a key a step, split
    into the h and v keys."""
    hs, vs = [], []
    for k in jax.random.split(key, n_steps):
        kh, kv = jax.random.split(k)
        hs.append(jax.random.uniform(kh, (rows, H)))
        vs.append(jax.random.uniform(kv, (rows, V)))
    return {"h": _t(jnp.stack(hs)), "v": _t(jnp.stack(vs))}


def generate_draws(seed, n, V, H, n_steps):
    kinit, kgibbs = jax.random.split(jax.random.PRNGKey(seed))
    return {"init": _t(jax.random.uniform(kinit, (n, V))),
            **chain_draws(kgibbs, n_steps, n, V, H)}


def _pretrained(kind):
    """The port's model pretrained on the CPU (its eager engine), and a JAX
    model holding the same weights."""
    from mdbn_tpu_torch import DBN as TDBN
    from mdbn_tpu_torch import MDBN as TMDBN

    if kind == "dbn":
        cfg, _ = _stack_np((12, 8, 6), 0, epochs=2)
        x = _data(40, 12, 81)
        tm = TDBN(convert_config(cfg), device="cpu").train(x)
        jm = JDBN(cfg)
        jm.layers = [_jrbm(cfg.rbm_config(l, r.cfg.n_visible),
                           {k: v.numpy() for k, v in r.params.as_dict().items()})
                     for l, r in enumerate(tm.layers)]
        return jm, tm, x
    cfg, _, _ = _mdbn_np(0)
    cfg = MDBNConfig(towers={m: DBNConfig(**{**t.__dict__, "epochs": 2})
                             for m, t in cfg.towers.items()},
                     joint=cfg.joint.replace(epochs=2))
    x = _mods(40, 82)
    tm = TMDBN(convert_config(cfg), device="cpu").train(x)
    jm = JMDBN(cfg)
    np_of = lambda r: {k: v.numpy() for k, v in r.params.as_dict().items()}  # noqa: E731
    for m, tower in tm.towers.items():
        jm.towers[m] = JDBN(cfg.towers[m])
        jm.towers[m].layers = [_jrbm(convert_config(r.cfg), np_of(r)) for r in tower.layers]
    jm.joint = _jrbm(convert_config(tm.joint.cfg), np_of(tm.joint))
    return jm, tm, x


def _copies(jm, tm):
    import copy

    return copy.deepcopy(jm), copy.deepcopy(tm)


def _jx(x):
    return {m: jnp.asarray(v) for m, v in x.items()} if isinstance(x, dict) else jnp.asarray(x)


def _close_out(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for m in want:
            _close(got[m], want[m])
    else:
        _close(got, want)


def _differs(a, b):
    a = a if isinstance(a, dict) else {"": a}
    b = b if isinstance(b, dict) else {"": b}
    assert any(float((a[m] - b[m]).abs().max()) > 1e-4 for m in a)


def _dbn_updown_spec(tm):
    cfgs = [r.cfg for r in tm.layers]
    return updown_spec(cfgs[:-1], cfgs[-1], 1)


@pytest.mark.parametrize("kind", ["dbn", "mdbn"])
def test_model_methods_whole_slice(kind):
    """Pretrained on the port, then each mode through the model methods on
    copies of one model pair, against the JAX model; after fine-tuning,
    reconstruct / generate / impute / transform_partial use the untied
    weights: equal to the JAX model's and unlike the tied down-pass."""
    jm0, tm0, x = _pretrained(kind)
    y = _labels(40, 3, 83)
    mdbn = kind == "mdbn"
    width = tm0.joint.cfg.n_visible if mdbn else 8
    H = tm0.joint.cfg.n_hidden if mdbn else 6
    tied_rec = tm0.reconstruct(x)
    tied_gen = tm0.generate(n_samples=5, n_gibbs=4, draws=generate_draws(3, 5, width, H, 4))
    # the classifier
    jm, tm = _copies(jm0, tm0)
    _close(tm.finetune(x, y, 3, epochs=1, batch_size=B, draws={"head": _t(jax.random.normal(
        jax.random.PRNGKey(0), (H, 3), jnp.float32))}), jm.finetune(_jx(x), y, 3, epochs=1, batch_size=B))
    assert torch.equal(tm.predict(x), _t(jm.predict(_jx(x))).long())
    # the autoencoder: reconstruct through the decoder
    jm, tm = _copies(jm0, tm0)
    _close(tm.finetune_autoencoder(x, epochs=2, batch_size=B),
           jm.finetune_autoencoder(_jx(x), epochs=2, batch_size=B))
    _close_out(tm.reconstruct(x), jm.reconstruct(_jx(x)))
    _differs(tm.reconstruct(x), tied_rec)
    # up-down: generate (and impute, transform_partial) through the generative weights
    jm, tm = _copies(jm0, tm0)
    if mdbn:
        nk, spec = updown_mdbn_spec({m: [r.cfg for r in t.layers] for m, t in tm.towers.items()},
                                    tm.joint.cfg, 1)
    else:
        nk, spec = _dbn_updown_spec(tm)
    _close(tm.finetune_updown(x, epochs=1, batch_size=B, draws=_epochs(0, 1, 4, nk, spec)),
           jm.finetune_updown(_jx(x), epochs=1, batch_size=B))
    gd = generate_draws(3, 5, width, H, 4)
    got = tm.generate(n_samples=5, n_gibbs=4, draws=gd)
    _close_out(got, jm.generate(n_samples=5, n_gibbs=4, seed=3))
    _differs(got, tied_gen)
    if mdbn:
        obs = {"ge": x["ge"][:6]}
        cd = chain_draws(jax.random.PRNGKey(4), 6, 8 * 6, width, H)
        got = tm.impute(obs, n_gibbs=6, seed=4, draws=cd)
        _close_out(got, jm.impute(_jx(obs), n_gibbs=6, seed=4))
        _differs(got, tm0.impute(obs, n_gibbs=6, draws=cd))
        got = tm.transform_partial(obs, n_gibbs=6, draws=cd)
        _close(got, jm.transform_partial(_jx(obs), n_gibbs=6, seed=4))
        _differs(got, tm0.transform_partial(obs, n_gibbs=6, draws=cd))
    # the label top, then labeled up-down
    jm, tm = _copies(jm0, tm0)
    nk, spec = label_top_spec(H, 3, 9, 1, False)
    _close(tm.fit_label_top(x, y, 3, n_hidden=9, epochs=1, batch_size=B,
                            draws=_epochs(0, 1, 4, nk, spec, init_shape=(H + 3, 9))),
           jm.fit_label_top(_jx(x), y, 3, n_hidden=9, epochs=1, batch_size=B))
    _close(tm.class_posterior(x), jm.class_posterior(_jx(x)))
    dd = dream_draws(5, 4, H, 3, 9, 3, labeled=False)
    _close_out(tm.generate_class(1, n_samples=4, n_gibbs=3, draws=dd),
               jm.generate_class(1, n_samples=4, n_gibbs=3, seed=5))
    if mdbn:
        nk, spec = updown_mdbn_spec({m: [r.cfg for r in t.layers] for m, t in tm.towers.items()},
                                    tm.joint.cfg, 1, label=(3, 9, False))
    else:
        nk, spec = updown_labeled_spec([r.cfg for r in tm.layers], 3, 9, 1, False)
    _close(tm.finetune_updown_labeled(x, y, epochs=1, batch_size=B,
                                      draws=_epochs(0, 1, 4, nk, spec)),
           jm.finetune_updown_labeled(_jx(x), y, epochs=1, batch_size=B))
    assert torch.equal(tm.predict_generative(x), _t(jm.predict_generative(_jx(x))).long())
    got = tm.generate(n_samples=4, n_gibbs=3, draws=dream_draws(6, 4, H, 3, 9, 3, labeled=True))
    _close_out(got, jm.generate(n_samples=4, n_gibbs=3, seed=6))
    _close_out(tm.generate_class(2, n_samples=4, n_gibbs=3, draws=dd),
               jm.generate_class(2, n_samples=4, n_gibbs=3, seed=5))
    # the fine-tuned state crosses between the packages as numpy
    state = finetuned_to_numpy(tm)
    assert set(state) == ({"label_top", "gen", "joint_gen"} if mdbn else {"label_top", "gen"})
    back = set_finetuned_from_numpy(_copies(jm0, tm0)[1], state)
    for a, b in zip(jax.tree.leaves(finetuned_to_numpy(back)), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_updown_gain_in_exact_likelihood():
    """Up-down on the port's weights raises the exact log-likelihood of the
    training data, by the JAX package's enumerator (tests/test_updown.py)."""
    from mdbn_tpu.analysis.ais import exact_dbn_log_likelihood
    from mdbn_tpu_torch import DBN as TDBN
    from mdbn_tpu_torch import DBNConfig as TDBNConfig

    key = jax.random.PRNGKey(3)
    kf, kn = jax.random.split(key)
    base = (jax.random.uniform(kf, (120, 1)) < 0.5).astype(jnp.float32)
    data = np.asarray(jnp.where(jax.random.uniform(kn, (120, 6)) < 0.1, 1.0 - base, base))
    dbn = TDBN(TDBNConfig(layer_sizes=[5, 4], epochs=12, lr=0.2, batch_size=20, seed=0),
               device="cpu").train(data)
    to_j = lambda p: JParams(W=jnp.asarray(p.W.numpy()), b=jnp.asarray(p.b.numpy()),  # noqa
                             c=jnp.asarray(p.c.numpy()))
    cfgs = [convert_config(r.cfg) for r in dbn.layers]
    ll_before = exact_dbn_log_likelihood([(to_j(r.params), c) for r, c in zip(dbn.layers, cfgs)],
                                         data)
    history = dbn.finetune_updown(data, epochs=30, lr=0.05, batch_size=20, seed=1)
    gen = [(jnp.asarray(W.numpy()), jnp.asarray(b.numpy())) for W, b in dbn._gen]
    ll_after = exact_dbn_log_likelihood([(to_j(r.params), c) for r, c in zip(dbn.layers, cfgs)],
                                        data, gen=gen)
    assert len(history) == 30 and all(np.isfinite(history))
    assert ll_after > ll_before, (ll_before, ll_after)


def test_resume_and_errors():
    jm, tm = _models("dbn", 90)
    x, y = _data(40, 12, 91), _labels(40, 3, 92)
    # a second autoencoder call resumes from the stored decoder
    tm.finetune_autoencoder(x, epochs=1, batch_size=B)
    d1 = [D.clone() for D in tm._decoder]
    tm.finetune_autoencoder(x, epochs=1, batch_size=B)
    assert not torch.equal(d1[0], tm._decoder[0])
    # up-down resumes from _gen; a stored gen that covers only the directed
    # layers cannot seed labeled up-down
    tm = _models("dbn", 90)[1]
    tm.finetune_updown(x, epochs=1, batch_size=B)
    g1 = tm._gen[0][0].clone()
    tm.finetune_updown(x, epochs=1, batch_size=B)
    assert len(tm._gen) == 1 and not torch.equal(g1, tm._gen[0][0])
    with pytest.raises(RuntimeError, match="before fit_label_top"):
        tm.finetune_updown_labeled(x, y)
    tm.fit_label_top(x, y, 3, n_hidden=5, epochs=1, batch_size=B)
    top1 = tm._label_top[0].W.clone()
    tm.fit_label_top(x, y, 3, n_hidden=5, epochs=1, batch_size=B)  # resumes
    assert tm._label_top[0].W.shape == (9, 5) and not torch.equal(top1, tm._label_top[0].W)
    with pytest.raises(ValueError, match="stored label top has 3 classes"):
        tm.fit_label_top(x, np.minimum(y, 1), 2, epochs=1, batch_size=B)
    with pytest.raises(ValueError, match="unlabeled finetune_updown"):
        tm.finetune_updown_labeled(x, y, epochs=1, batch_size=B)
    for call, match in ((lambda m: m.predict(x), "before finetune"),
                        (lambda m: m.predict_generative(x), "before fit_label_top"),
                        (lambda m: m.generate_class(0), "before fit_label_top")):
        with pytest.raises(RuntimeError, match=match):
            call(_models("dbn", 90)[1])
    with pytest.raises(ValueError, match="labels must be in"):
        TF.finetune_stack([(r.params, r.cfg) for r in tm.layers], x, y + 3, 3)
    with pytest.raises(ValueError, match="out of range"):
        TL.fit_label_top([], x, y - 2, 3)
    with pytest.raises(ValueError, match="every label is -1"):
        TL.fit_label_top([], x, y * 0 - 1, 3)
    with pytest.raises(ValueError, match=">= 2 layers"):
        TU.finetune_updown_stack([(tm.layers[0].params, tm.layers[0].cfg)], x)
    with pytest.raises(ValueError, match="fewer than one minibatch"):
        TU.finetune_updown_stack([(r.params, r.cfg) for r in tm.layers], x[:5], batch_size=B)
    lv = [(RBMParams(W=r.params.W, b=r.params.b, c=r.params.c, z=r.params.b), r.cfg)
          for r in tm.layers]
    with pytest.raises(ValueError, match="learn_variance"):
        TA.finetune_autoencoder_stack(lv, x)
    _, tmd = _models("mdbn", 93)
    with pytest.raises(ValueError, match="disagree"):
        tmd.finetune_updown({"ge": _mods(20, 1)["ge"]})


# -- under a mesh: gloo ranks on the CPU -----------------------------------------------


def test_finetune_rows_fallback():
    from mdbn_tpu_torch.parallel.dp import finetune_rows
    from mdbn_tpu_torch.parallel.mesh import Mesh

    mesh = lambda r, n: Mesh(rank=r, size=n, device=torch.device("cpu"), backend="gloo")  # noqa
    assert finetune_rows(None, 10) == slice(0, 10)
    assert [finetune_rows(mesh(r, 3), 12) for r in range(3)] == [slice(0, 4), slice(4, 8),
                                                                 slice(8, 12)]
    # 3 does not divide 10: the reference's fallback to the largest divisor, 2
    assert [finetune_rows(mesh(r, 3), 10) for r in range(3)] == [slice(0, 5), slice(5, 10),
                                                                 slice(10, 10)]


@pytest.mark.parametrize("world,batches", [(2, (10,)), (3, (12, 10))])
def test_trainers_under_a_mesh_equal_one_device(tmp_path, world, batches):
    """Each trainer over gloo ranks (each its rows of every minibatch, the
    sums all-reduced) equals the single-device run with the same seeds, on
    every rank; on 3 ranks at batch 10 the third holds no rows."""
    import time

    import torch.multiprocessing as mp
    from torch_dp_ranks import finetune_runs, run_finetune_rank

    from mdbn_tpu_torch.parallel.mesh import _free_port

    ctx = mp.spawn(run_finetune_rank, args=(world, _free_port(), str(tmp_path), batches),
                   nprocs=world, join=False)
    deadline = time.monotonic() + 120.0
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the ranks did not finish in 120 s")
    for batch in batches:
        want = finetune_runs(None, batch)
        for r in range(world):
            got = torch.load(tmp_path / f"finetune{r}.pt")[batch]
            assert list(got) == list(want)
            for name in want:
                assert len(got[name]) == len(want[name]), name
                for a, b in zip(got[name], want[name]):
                    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                               err_msg=f"{name} rank {r} batch {batch}", **TOL)

"""The port's AIS (mdbn_tpu_torch/analysis/ais.py) against the JAX package's
on the CPU, and the runtime options ``profile`` and ``debug_nans``.

The same numpy weights go to both packages (the port's through
``mdbn_tpu_torch/convert.py``), and the port is fed the JAX functions' own
draws, rebuilt with ``jax.random`` exactly as ``mdbn_tpu/analysis/ais.py``
splits its keys (the names of the port module's docstring). At V 12, H 8,
32 chains and 40 betas no ``u < p`` lands within rounding of ``p``, so both
sides visit the same states and every returned float agrees at rtol = atol
= 2e-5 (float32 sums in another order differ far below it); ``n_resamples``
and the final states are equal. The runs share chain, beta and width
counts, so the JAX side compiles each anneal once. The exact enumerators
are float64 numpy on both sides: 1e-12. Two tests hold the port on its own
generator against exact enumeration, with the bounds of tests/test_ais.py.
The CLI's ``ais`` block prints the reference's record keys. On one core the
file takes about 90 s, most of it the JAX side's compiles.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbn_tpu.analysis import ais as J
from mdbn_tpu.config import DBNConfig, RBMConfig
from mdbn_tpu.core.rbm_math import RBMParams as JParams
from mdbn_tpu.run import main as jmain
from mdbn_tpu_torch.analysis import ais as T
from mdbn_tpu_torch.config import TrainRuntimeConfig
from mdbn_tpu_torch.convert import convert_config, params_from_numpy
from mdbn_tpu_torch.core.rbm_math import RBMParams
from mdbn_tpu_torch.data.synthetic import bars_and_stripes, mnist_like
from mdbn_tpu_torch.models.rbm import RBM
from mdbn_tpu_torch.run import main
from mdbn_tpu_torch.train.trainer import train_rbm

TOL = dict(rtol=2e-5, atol=2e-5)
EXACT = dict(rtol=1e-12, atol=1e-12)
V, H = 12, 8
NC, NB = 32, 40  # chains and betas of the runs on the reference's draws


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(_np(got), np.float64),
                               np.asarray(_np(want), np.float64), **tol)


def _np_params(Vn, Hn, seed, scale=0.5, z=False):
    rng = np.random.default_rng(seed)
    p = {"W": (rng.standard_normal((Vn, Hn)) * scale).astype(np.float32),
         "b": (rng.standard_normal(Vn) * 0.2).astype(np.float32),
         "c": (rng.standard_normal(Hn) * 0.2).astype(np.float32)}
    if z:
        p["z"] = (rng.standard_normal(Vn) * 0.3).astype(np.float32)
    return p


def _both(p):
    """(JAX RBMParams, port RBMParams on the CPU) of numpy weights ``p``."""
    return (JParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            params_from_numpy(p, device="cpu"))


def _bern_data(n, Vn, seed, rate=0.4):
    return (np.random.default_rng(seed).random((n, Vn)) < rate).astype(np.float32)


# -- the reference's draws, rebuilt ------------------------------------------------------


def _sweep(k, n, widths, s=0, gauss=False, labeled=False):
    """One Gibbs sweep's draws, named for sweep ``s``: kh, kv(, kl) = split(k)."""
    Hn, Vn = widths[:2]
    ks = jax.random.split(k, 3 if labeled else 2)
    out = {f"h{s}": jax.random.uniform(ks[0], (n, Hn)),
           f"v{s}": (jax.random.normal(ks[1], (n, Vn), jnp.float32) if gauss
                     else jax.random.uniform(ks[1], (n, Vn)))}
    if labeled:
        out[f"l{s}"] = jax.random.uniform(ks[2], (n, widths[2]), jnp.float32, 1e-20, 1.0)
    return out


def _sweeps(k, n, widths, n_sweeps, gauss=False, labeled=False):
    """The sweeps of a step keyed ``k``: sweep s from fold_in(k, s)."""
    out = {}
    for s in range(n_sweeps):
        out.update(_sweep(jax.random.fold_in(k, s), n, widths, s, gauss, labeled))
    return out


def _np_draws(d):
    return {name: torch.as_tensor(np.array(a)) for name, a in d.items()}


def _scan(key, n_betas, n, widths, n_sweeps, smc=False, gauss=False, labeled=False):
    """``_anneal_scan``'s (or ``_anneal_scan_smc``'s) draws: one key a beta
    pair, split into kres, ksweep under SMC."""
    steps = []
    for k in jax.random.split(key, n_betas - 1):
        d = {}
        if smc:
            kres, k = jax.random.split(k)
            d["res"] = jax.random.gumbel(kres, (n, n), jnp.float32)
        steps.append(_np_draws({**d, **_sweeps(k, n, widths, n_sweeps, gauss, labeled)}))
    return {"steps": steps}


def _forward_draws(key, n_betas, n, widths, n_sweeps, smc=False, gauss=False):
    k0, kscan = jax.random.split(key)
    init = (jax.random.normal(k0, (n, widths[1]), jnp.float32) if gauss
            else jax.random.uniform(k0, (n, widths[1])))
    return {"init": torch.as_tensor(np.asarray(init)),
            **_scan(kscan, n_betas, n, widths, n_sweeps, smc, gauss)}


def _labeled_draws(key, n_betas, n, n_code, n_classes, Hn, n_sweeps):
    k0, kl0, kscan = jax.random.split(key, 3)
    return {"init": torch.as_tensor(np.asarray(jax.random.uniform(k0, (n, n_code)))),
            "init_label": torch.as_tensor(np.asarray(jax.random.uniform(
                kl0, (n, n_classes), jnp.float32, 1e-20, 1.0))),
            **_scan(kscan, n_betas, n, (Hn, n_code, n_classes), n_sweeps, labeled=True)}


def _up_draws(kq, n_samples, N, widths):
    """The bounds' up-passes: k = split(kq, S)[s], then k, kl = split(k) a layer."""
    out = {}
    for s, k in enumerate(jax.random.split(kq, n_samples)):
        for li, w in enumerate(widths):
            k, kl = jax.random.split(k)
            out[f"q{s}_{li}"] = torch.as_tensor(np.asarray(jax.random.uniform(kl, (N, w))))
    return out


# -- schedule, base model, ESS -------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["uniform", "sm"])
def test_schedule_base_and_ess(schedule):
    for n in (7, 100, 1000):
        got, want = T.anneal_betas(n, schedule).numpy(), np.asarray(J.anneal_betas(n, schedule))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)  # XLA's rounding: one ulp
        assert got[0] == 0.0 and got[-1] == 1.0
    if schedule == "uniform":  # the default path, bit for bit
        assert np.array_equal(T.anneal_betas(1000).numpy(), np.asarray(J.anneal_betas(1000)))
    for bad, match in ((("nope",), "unknown anneal schedule"), ((), "too small")):
        with pytest.raises(ValueError, match=match):
            T.anneal_betas(5, *(bad or ("sm",)))
    x = _bern_data(50, V, 0, rate=0.3)
    _close(T.base_rate_biases(x), J.base_rate_biases(jnp.asarray(x)))
    logw = np.random.default_rng(1).normal(0, 3, 64).astype(np.float32)
    _close(T._ess(torch.as_tensor(logw)), J._ess(jnp.asarray(logw)))
    jp, tp = _both(_np_params(V, H, 2, z=True))
    _close(T._gaussian_log_z_a(tp), J._gaussian_log_z_a(jp))
    a = jnp.asarray(J.base_rate_biases(jnp.asarray(x)))
    _close(T._bernoulli_log_z_a(tp, torch.as_tensor(np.asarray(a))), J._bernoulli_log_z_a(jp, a))


# -- the anneals on the reference's draws ---------------------------------------------------


def _check_forward(got, want, binary=True):
    """(log_z, logw, final states, n_resamples): binary states equal."""
    log_z, logw, v, n_res = got
    _close(log_z, want[0])
    _close(logw, want[1])
    if binary:
        np.testing.assert_array_equal(_np(v), np.asarray(want[2]))
    else:
        _close(v, want[2])
    assert int(n_res) == int(want[3])


@pytest.mark.parametrize("schedule", ["uniform", "sm"])
def test_forward_anneal_on_jax_draws(schedule):
    """Forward AIS with two sweeps a beta, both schedules."""
    jp, tp = _both(_np_params(V, H, 0))
    a = J.base_rate_biases(jnp.asarray(_bern_data(40, V, 1)))
    key = jax.random.PRNGKey(3)
    n, K = NC, NB
    want = J._ais_forward_bernoulli(jp, a, key, n, K, 2, schedule, 0.0)
    draws = _forward_draws(key, K, n, (H, V), 2)
    got = T._ais_forward_bernoulli(tp, torch.as_tensor(np.asarray(a)), n, K, 2, schedule,
                                   generator=None, draws=draws)
    _check_forward(got, want)
    log_z, logw = T.ais_log_z(tp, np.asarray(a), 0, n, K, 2, schedule, draws=draws)
    _close(log_z, want[0])


def test_reverse_and_smc_anneals_on_jax_draws():
    """SMC at resample_ess 0.9 forward (resampling fires); the reverse anneal
    from exact model samples, plain and under SMC (the Gaussian path's in
    the bracket below)."""
    jp, tp = _both(_np_params(V, H, 4, scale=1.5))
    n, K = NC, NB
    base = jnp.zeros(V, jnp.float32)  # a uniform base: an anneal that resamples
    v1 = J.exact_sample(jp, n, seed=6)
    key = jax.random.PRNGKey(7)
    want = J._ais_forward_bernoulli(jp, base, key, n, K, 1, "uniform", 0.9)
    got = T._ais_forward_bernoulli(tp, torch.zeros(V), n, K, 1, "uniform", 0.9, generator=None,
                                   draws=_forward_draws(key, K, n, (H, V), 1, smc=True))
    _check_forward(got, want)
    assert int(got[3]) > 0
    for ess in (0.0, 0.9):
        want = J.reverse_ais_log_z(jp, base, jnp.asarray(v1), key, K, 1, "uniform", ess)
        got = T.reverse_ais_log_z(tp, torch.zeros(V), v1, 0, K, 1, "uniform", ess,
                                  draws=_scan(key, K, n, (H, V), 1, smc=ess > 0))
        _close(got[0], want[0])
        _close(got[1], want[1])


def test_gaussian_learned_variance_on_jax_draws():
    """The Gaussian path with ``z`` (sigma^2 = e^z), two sweeps a beta."""
    jp, tp = _both(_np_params(V, H, 8, scale=0.3, z=True))
    base = jnp.asarray(np.random.default_rng(9).normal(0, 0.3, V).astype(np.float32))
    base_t = torch.as_tensor(np.asarray(base))
    n, K = NC, NB
    key = jax.random.PRNGKey(11)
    want = J._ais_forward_gaussian(jp, base, key, n, K, 2, "sm", 0.0)
    got = T._ais_forward_gaussian(tp, base_t, n, K, 2, "sm", generator=None,
                                  draws=_forward_draws(key, K, n, (H, V), 2, gauss=True))
    _check_forward(got, want, binary=False)


LABELED = (5, 3, 6)  # the label top's code, classes and hidden units


def test_labeled_anneal_on_jax_draws():
    n_code, C, Ht = LABELED
    jp, tp = _both(_np_params(n_code + C, Ht, 12))
    rng = np.random.default_rng(13)
    a = jnp.asarray(np.concatenate([rng.normal(0, 0.5, n_code), np.zeros(C)]).astype(np.float32))
    n, K, key = NC, NB, jax.random.PRNGKey(14)
    want = J.ais_log_z_labeled(jp, a, n_code, key, n, K, 1, "uniform")
    got = T.ais_log_z_labeled(tp, np.asarray(a), n_code, 0, n, K, 1, "uniform",
                              draws=_labeled_draws(key, K, n, n_code, C, Ht, 1))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("init", ["resample", "gibbs"])
@pytest.mark.parametrize("visible", ["bernoulli", "gaussian"])
def test_log_z_bracket_on_jax_draws(init, visible):
    """Both inits, every key of the record; the resample init under SMC, on
    a sharper model from a uniform base (an anneal that resamples)."""
    gauss = visible == "gaussian"
    smc = init == "resample"
    scale = (0.6 if smc else 0.3) if gauss else (1.5 if smc else 0.5)
    jp, tp = _both(_np_params(V, H, 15, scale=scale))
    cfg = RBMConfig(n_visible=V, n_hidden=H, visible=visible)
    rng = np.random.default_rng(16)
    data = (rng.normal(size=(20, V)).astype(np.float32) if gauss else _bern_data(20, V, 16))
    base = np.full((1, V), 0.0 if gauss else 0.5, np.float32) if smc else None
    n, K, gibbs = NC, NB, 5
    ess = 0.9 if smc else 0.0
    key = jax.random.PRNGKey(17)
    want = J.log_z_bracket(jp, cfg, data, key=key, n_chains=n, n_betas=K, init=init,
                           init_gibbs=gibbs, resample_ess=ess, base_data=base)
    kf, km, kr = jax.random.split(key, 3)
    draws = {"fwd": _forward_draws(kf, K, n, (H, V), 1, smc=ess > 0, gauss=gauss),
             "rev": _scan(kr, K, n, (H, V), 1, smc=ess > 0, gauss=gauss)}
    if init == "resample":
        draws["res"] = torch.as_tensor(np.asarray(jax.random.gumbel(km, (n, n), jnp.float32)))
    else:
        # _mix_at_model: sweep i from fold_in(km, i), split once into kh, kv
        draws["mix"] = {"steps": [
            {k: torch.as_tensor(np.asarray(a)) for k, a in
             _sweep(jax.random.fold_in(km, i), n, (H, V), gauss=gauss).items()}
            for i in range(gibbs)]}
    got = T.log_z_bracket(tp, convert_config(cfg), data, n_chains=n, n_betas=K, init=init,
                          init_gibbs=gibbs, resample_ess=ess, base_data=base, draws=draws)
    assert set(got) == set(want)
    assert got["n_resamples_fwd"] == want["n_resamples_fwd"]
    assert (got["n_resamples_fwd"] > 0) == (ess > 0)
    for k in want:
        _close(got[k], want[k])
    with pytest.raises(ValueError, match="unknown bracket init"):
        T.log_z_bracket(tp, convert_config(cfg), data, init="nope")


def _stack(sizes, seed, visible="bernoulli"):
    cfg = DBNConfig(layer_sizes=list(sizes[1:]), visible=visible)
    nps = [(_np_params(v, h, seed + i), cfg.rbm_config(i, v))
           for i, (v, h) in enumerate(zip(sizes, sizes[1:]))]
    both = [(_both(p), c) for p, c in nps]
    return ([(j, c) for (j, _), c in both], [(t, convert_config(c)) for (_, t), c in both])


def _gens(sizes, seed):
    gens = [_np_params(v, h, seed + 50 + i, scale=0.4) for i, (v, h) in
            enumerate(zip(sizes, sizes[1:]))]
    return ([(jnp.asarray(g["W"]), jnp.asarray(g["b"])) for g in gens],
            [(torch.as_tensor(g["W"]), torch.as_tensor(g["b"])) for g in gens])


@pytest.mark.parametrize("depth,gen", [(1, False), (3, False), (3, True)])
def test_dbn_bound_on_jax_draws(depth, gen):
    sizes = (V, H) if depth == 1 else (10, 7, V, H)  # the top RBM V x H as elsewhere
    jl, tl = _stack(sizes, 20, visible="gaussian" if depth == 3 else "bernoulli")
    rng = np.random.default_rng(21)
    data = (rng.normal(size=(16, sizes[0])).astype(np.float32) if depth == 3
            else _bern_data(16, V, 21))
    jg, tg = _gens(sizes[:-1], 22) if gen else (None, None)
    n, K, S, key = NC, NB, 3, jax.random.PRNGKey(23)
    want = J.dbn_log_likelihood_bound(jl, data, key=key, n_samples=S, n_chains=n, n_betas=K,
                                      gen=jg)
    if depth == 1:
        draws = _forward_draws(key, K, n, (H, V), 1)
    else:
        kais, kq = jax.random.split(key)
        draws = {"ais": _forward_draws(kais, K, n, sizes[-2:][::-1], 1),
                 **_up_draws(kq, S, len(data), sizes[1:-1])}
    got = T.dbn_log_likelihood_bound(tl, data, n_samples=S, n_chains=n, n_betas=K, gen=tg,
                                     draws=draws)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


def test_labeled_dbn_bound_on_jax_draws():
    n_code, C, Ht = LABELED
    sizes = (V, 7, n_code)
    jl, tl = _stack(sizes, 30)
    jtop, ttop = _both(_np_params(n_code + C, Ht, 31))
    jg, tg = _gens(sizes, 32)
    data = _bern_data(16, V, 33)
    n, K, S, key = NC, NB, 3, jax.random.PRNGKey(34)
    want = J.labeled_dbn_log_likelihood_bound(jl, jtop, C, data, key=key, n_samples=S,
                                              n_chains=n, n_betas=K, gen=jg)
    kais, kq = jax.random.split(key)
    draws = {"ais": _labeled_draws(kais, K, n, n_code, C, Ht, 1),
             **_up_draws(kq, S, len(data), sizes[1:])}
    got = T.labeled_dbn_log_likelihood_bound(tl, ttop, C, data, n_samples=S, n_chains=n,
                                             n_betas=K, gen=tg, draws=draws)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    with pytest.raises(ValueError, match="one per stack layer"):
        T.labeled_dbn_log_likelihood_bound(tl, ttop, C, data, gen=tg[:1])


def test_recorded_draws_replay():
    """Draws given as empty dicts come back filled; fed again they give the
    same run (how a card's run is replayed on the CPU)."""
    _, tp = _both(_np_params(V, H, 40))
    cfg = RBMConfig(n_visible=V, n_hidden=H)
    data = _bern_data(20, V, 41)
    draws = {}
    a = T.log_z_bracket(tp, cfg, data, seed=3, n_chains=16, n_betas=20, resample_ess=0.9,
                        draws=draws)
    assert {"fwd", "res", "rev"} <= set(draws) and len(draws["fwd"]["steps"]) == 19
    assert set(draws["fwd"]["steps"][0]) == {"res", "h0", "v0"}
    b = T.log_z_bracket(tp, cfg, data, seed=99, n_chains=16, n_betas=20, resample_ess=0.9,
                        draws=draws)
    assert a == b


# -- the exact enumerators --------------------------------------------------------------------


def _labeled_stack(visible, n_code=4, C=3):
    sizes = (V, 6, n_code)
    jl, tl = _stack(sizes, 57, visible)
    jt, tt = _both(_np_params(n_code + C, 5, 58))
    jg, tg = _gens(sizes, 59)
    return jl, tl, jt, tt, jg, tg


def _mdbn():
    """Two towers (Gaussian ge 8 -> 5 -> 3, Bernoulli meth 6 -> 4), a joint
    RBM over their 7 code bits, 9 rows, untied generative weights."""
    towers = {"ge": (8, 5, 3), "meth": (6, 4)}
    jt, tt, mods, jgen, tgen = {}, {}, {}, {}, {}
    for j, (m, s) in enumerate(towers.items()):
        jt[m], tt[m] = _stack(s, 70 + 10 * j, "gaussian" if m == "ge" else "bernoulli")
        mods[m] = (np.random.default_rng(80 + j).normal(size=(9, s[0])).astype(np.float32)
                   if m == "ge" else _bern_data(9, s[0], 80 + j))
        jgen[m], tgen[m] = _gens(s, 91 + j)
    jj, tj = _both(_np_params(7, 4, 90))
    jcfg = RBMConfig(n_visible=7, n_hidden=4)
    return (jt, (jj, jcfg), jgen), (tt, (tj, convert_config(jcfg)), tgen), mods


ENUMERATORS = ("exact_log_z", "exact_log_z_gaussian", "exact_sample", "exact_log_z_labeled",
               "_enum_states", "_bern_cond_logp", "exact_dbn_log_likelihood",
               "exact_labeled_dbn_log_likelihood", "exact_mdbn_log_likelihood",
               "exact_labeled_mdbn_log_likelihood")


@pytest.mark.parametrize("name", ENUMERATORS)
def test_exact_enumerator_equals_the_reference(name):
    """Each enumerator on the same weights, float64 on both sides: 1e-12
    (``exact_sample``: the same array). The port's take torch tensors, or
    numpy arrays."""
    got_fn, want_fn = getattr(T, name), getattr(J, name)
    jp, tp = _both(_np_params(V, H, 50))
    jz, tz = _both(_np_params(V, H, 51, scale=0.3, z=True))
    C = 3
    labels = np.random.default_rng(60).integers(0, C, 10)
    pairs = []
    if name == "exact_log_z":
        pairs = [(got_fn(tp), want_fn(jp)), (got_fn(RBMParams(**_np_params(V, H, 50))),
                                             want_fn(jp))]
    elif name == "exact_log_z_gaussian":
        pairs = [(got_fn(tp), want_fn(jp)), (got_fn(tz), want_fn(jz))]
    elif name == "exact_sample":
        for (t, j), visible in (((tp, jp), "bernoulli"), ((tp, jp), "gaussian"),
                                ((tz, jz), "gaussian")):
            np.testing.assert_array_equal(got_fn(t, 30, 4, visible), want_fn(j, 30, 4, visible))
    elif name == "exact_log_z_labeled":
        jt, tt = _both(_np_params(5 + C, 6, 52))
        pairs = [(got_fn(tt, 5, C), want_fn(jt, 5, C))]
    elif name == "_enum_states":
        np.testing.assert_array_equal(got_fn(6), want_fn(6))
        with pytest.raises(ValueError, match="widths <= 14"):
            got_fn(15)
    elif name == "_bern_cond_logp":
        S, Tt = J._enum_states(4), J._enum_states(3)
        Wn, bn = _np_params(4, 3, 53)["W"].astype(np.float64), np.linspace(-1, 1, 4)
        pairs = [(got_fn(S, Tt, Wn, bn), want_fn(S, Tt, Wn, bn))]
    elif name == "exact_dbn_log_likelihood":
        for visible in ("bernoulli", "gaussian"):
            sizes = (V, 6, 4, 5)
            jl, tl = _stack(sizes, 54, visible)
            data = (np.random.default_rng(55).normal(size=(10, V)).astype(np.float32)
                    if visible == "gaussian" else _bern_data(10, V, 55))
            jg, tg = _gens(sizes[:-1], 56)
            pairs += [(got_fn(tl, data), want_fn(jl, data)),
                      (got_fn(tl, data, gen=tg), want_fn(jl, data, gen=jg))]
        jl1, tl1 = _stack((V, H), 61)  # one layer: the top RBM alone
        data = _bern_data(10, V, 62)
        pairs.append((got_fn(tl1, data), want_fn(jl1, data)))
    elif name == "exact_labeled_dbn_log_likelihood":
        for visible in ("bernoulli", "gaussian"):
            jl, tl, jt, tt, jg, tg = _labeled_stack(visible)
            data = (np.random.default_rng(55).normal(size=(10, V)).astype(np.float32)
                    if visible == "gaussian" else _bern_data(10, V, 55))
            for lab in (labels, None):
                pairs += [(got_fn(tl, tt, data, lab, C, gen=tg),
                           want_fn(jl, jt, data, lab, C, gen=jg)),
                          (got_fn(tl, tt, data, lab, C), want_fn(jl, jt, data, lab, C))]
    elif name == "exact_mdbn_log_likelihood":
        (jt, jj, jgen), (tt, tj, tgen), mods = _mdbn()
        pairs = [(got_fn(tt, tj, mods, gen=tgen), want_fn(jt, jj, mods, gen=jgen)),
                 (got_fn(tt, tj, mods), want_fn(jt, jj, mods))]
    else:
        (jt, jj, jgen), (tt, tj, tgen), mods = _mdbn()
        jlt, tlt = _both(_np_params(4 + C, 5, 92))
        jjg, tjg = _gens((7, 4), 93)
        lab9 = labels[:9]
        for lab in (lab9, None):
            pairs += [(got_fn(tt, tj, tlt, mods, lab, C, gen=tgen, joint_gen=tjg[0]),
                       want_fn(jt, jj, jlt, mods, lab, C, gen=jgen, joint_gen=jjg[0])),
                      (got_fn(tt, tj, tlt, mods, lab, C), want_fn(jt, jj, jlt, mods, lab, C))]
    for got, want in pairs:
        _close(got, want, EXACT)


# -- on the port's own generator, against exact enumeration ------------------------------


def test_ais_and_smc_match_exact_log_z_on_own_draws():
    """|AIS - exact| < 0.15 at 256 chains and 2,000 betas, plain and SMC at
    resample_ess 0.9 (tests/test_ais.py's bounds)."""
    _, tp = _both(_np_params(V, H, 0))
    exact = T.exact_log_z(tp)
    for ess in (0.0, 0.9):
        est, logw = T.ais_log_z(tp, torch.zeros(V), seed=1, n_chains=256, n_betas=2000,
                                resample_ess=ess)
        assert abs(float(est) - exact) < 0.15, (ess, float(est), exact)
        if ess:  # the final epoch's weights only: near-uniform
            assert float(T._ess(logw)) > 128.0


def test_smc_bracket_sandwiches_exact_on_own_draws():
    """A trained multimodal model (bars and stripes) under a coarse anneal
    from a uniform base: SMC resampling fires, the final-epoch ESS recovers
    above the plain run's, and the bracket sandwiches the exact log Z
    (tests/test_ais.py::test_smc_bracket_triggers_and_sandwiches_exact)."""
    data = bars_and_stripes(512, side=4, seed=1)
    cfg = RBMConfig(n_visible=16, n_hidden=12, lr=0.5, epochs=60, batch_size=16,
                    engine="xla", seed=0)
    rbm = RBM(convert_config(cfg), device="cpu").train(data)
    exact = T.exact_log_z(rbm.params)
    base = np.full((1, 16), 0.5, np.float32)
    kw = dict(base_data=base, seed=7, n_chains=256, n_betas=100)
    plain = T.log_z_bracket(rbm.params, rbm.cfg, data[:64], **kw)
    smc = T.log_z_bracket(rbm.params, rbm.cfg, data[:64], **kw, resample_ess=0.7)
    assert plain["n_resamples_fwd"] == 0 and smc["n_resamples_fwd"] > 0
    assert smc["ess_fwd"] > 1.5 * plain["ess_fwd"], (smc, plain)
    assert smc["log_z_lower"] - 0.5 <= exact <= smc["log_z_upper"] + 0.5, (smc, exact)
    assert smc["log_z_gap"] < 1.0, smc


# -- the CLI's ais block -----------------------------------------------------------------------

AIS_KNOBS = {"ais": True, "ais_samples": 30, "ais_chains": 16, "ais_betas": 20}
DATA = {"kind": "mnist_like", "n_samples": 40, "n_features": 16, "seed": 1}
RBM_CFG = {"__type__": "RBMConfig", "n_visible": 16, "n_hidden": 6, "batch_size": 10,
           "epochs": 1}
DBN_CFG = {"__type__": "DBNConfig", "layer_sizes": [6, 4], "batch_size": 10, "epochs": 1}


def _ais_records(tmp_path, exp, runner, extra=()):
    path = tmp_path / "exp.json"
    metrics = tmp_path / f"m{len(list(tmp_path.glob('m*.jsonl')))}.jsonl"
    path.write_text(json.dumps(exp))
    args = ["--config", str(path), "--metrics", str(metrics), *extra]
    assert runner(args + (["--device", "cpu", "--engine", "xla"] if runner is main else [])) == 0
    return [r for r in map(json.loads, metrics.read_text().splitlines()) if r["kind"] == "ais"]


@pytest.mark.parametrize("case", ["rbm", "rbm_bracket", "dbn", "dbn_updown_labeled"])
def test_cli_ais_block_keys_like_the_reference(tmp_path, monkeypatch, case):
    """An RBM, its bracket, a DBN and a labeled-up-down DBN with "ais": true
    print one record with the JAX CLI's keys on the same config (the
    labeled DBN's bound has the DBN bound's keys: the reference's record is
    ``{"kind", "n_rows", **labeled_dbn_log_likelihood_bound(...)}``, and the
    call is counted); the DBN cases again under --load."""
    analysis = dict(AIS_KNOBS, ais_bracket=case == "rbm_bracket")
    exp = {"data": DATA, "model": RBM_CFG if case.startswith("rbm") else DBN_CFG,
           "analysis": analysis}
    calls = []
    if case == "dbn_updown_labeled":
        exp["finetune"] = {"mode": "updown_labeled", "epochs": 1, "n_hidden": 5,
                           "label_top_epochs": 1}
        bound = T.labeled_dbn_log_likelihood_bound
        monkeypatch.setattr(T, "labeled_dbn_log_likelihood_bound",
                            lambda *a, **k: calls.append(k["n_samples"]) or bound(*a, **k))
    extra = ["--save", str(tmp_path / "model")] if case.startswith("dbn") else []
    (got,) = _ais_records(tmp_path, exp, main, extra)
    if case == "dbn_updown_labeled":
        assert calls == [32]
        want = {"kind", "n_rows", "log_z_top", "mean_log_likelihood_bound", "logw_std",
                "mc_std"}
    else:
        (rec,) = _ais_records(tmp_path, exp, jmain)
        want = set(rec) - {"ts"}
        assert rec["n_rows"] == 30
    assert set(got) - {"ts"} == want and got["n_rows"] == 30
    assert all(np.isfinite(v) for k, v in got.items() if k not in ("kind", "ts"))
    if case.startswith("dbn"):
        exp.pop("finetune", None)  # the saved model keeps its fine-tuned state
        (again,) = _ais_records(tmp_path, exp, main, ["--load", str(tmp_path / "model")])
        assert set(again) == set(got) and calls in ([], [32, 32])


def test_cli_ais_skips_mdbn_and_autoencoder(tmp_path, caplog):
    tower = {"__type__": "DBNConfig", "layer_sizes": [4], "visible": "gaussian",
             "batch_size": 10, "epochs": 1}
    mdbn = {"__type__": "MDBNConfig", "towers": {"ge": tower, "meth": tower, "mirna": tower},
            "joint": {"__type__": "RBMConfig", "n_visible": 1, "n_hidden": 3,
                      "batch_size": 10, "epochs": 1}}
    exp = {"data": {"kind": "tcga_like", "n_patients": 20,
                    "dims": {"ge": 6, "meth": 5, "mirna": 4}, "seed": 0},
           "model": mdbn, "analysis": AIS_KNOBS}
    assert _ais_records(tmp_path, exp, main) == []
    assert "only defined for RBM/DBN configs" in caplog.text
    exp = {"data": DATA, "model": DBN_CFG, "analysis": AIS_KNOBS,
           "finetune": {"mode": "autoencoder", "epochs": 1}}
    assert _ais_records(tmp_path, exp, main) == []
    assert "autoencoder-fine-tuned" in caplog.text


# -- the runtime options profile and debug_nans ---------------------------------------------


def test_profile_writes_a_trace(tmp_path):
    cfg = convert_config(RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=2,
                                   engine="xla"))
    data = mnist_like(40, n_features=16, seed=0)
    rt = TrainRuntimeConfig(profile=True, profile_dir=str(tmp_path / "prof"))
    a, _ = train_rbm(data, cfg, device="cpu", runtime=rt)
    b, _ = train_rbm(data, cfg, device="cpu")
    assert torch.equal(a.params.W, b.params.W)  # the trace changes nothing
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


@pytest.mark.parametrize("per_epoch", [False, True])
def test_debug_nans(per_epoch):
    """Silent on a sound run (the same parameters as without it); a run made
    to diverge raises FloatingPointError naming the epoch and the tensor."""
    data = mnist_like(40, n_features=16, seed=0)
    kw = dict(device="cpu", runtime=TrainRuntimeConfig(debug_nans=True,
                                                        checkpoint_every_epochs=0))
    cb = (lambda *a: None) if per_epoch else None
    sound = convert_config(RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=2,
                                     engine="xla"))
    a, _ = train_rbm(data, sound, epoch_callback=cb, **kw)
    b, _ = train_rbm(data, sound, epoch_callback=cb, device="cpu")
    assert torch.equal(a.params.W, b.params.W)
    wild = sound.replace(visible="gaussian", lr=1e4, epochs=3)
    x = np.random.default_rng(0).normal(0, 3, (40, 16)).astype(np.float32)
    with pytest.raises(FloatingPointError, match=r"debug_nans: .*epoch \d"):
        train_rbm(x, wild, epoch_callback=cb, **kw)


def test_cli_profile_and_debug_nans_flags(tmp_path, monkeypatch):
    """--profile and --debug-nans reach the training runtime: a trace a run,
    under the temporary directory by default (tmp_path here), silence on a
    sound run, FloatingPointError on one made to diverge."""
    import tempfile

    import mdbn_tpu_torch.run as run_mod

    made = []

    def runtime(**kw):
        made.append(kw)
        return TrainRuntimeConfig(**kw)

    monkeypatch.setattr(run_mod, "TrainRuntimeConfig", runtime)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = tmp_path / "exp.json"
    path.write_text(json.dumps({"data": DATA, "model": RBM_CFG}))
    args = ["--config", str(path), "--device", "cpu", "--engine", "xla"]
    assert main(args + ["--profile", "--debug-nans"]) == 0
    assert made[-1]["profile"] and made[-1]["debug_nans"]
    assert len(list((tmp_path / "mdbn_tpu_profile").glob("*.pt.trace.json"))) == 1
    wild = dict(RBM_CFG, visible="gaussian", lr=1e4, epochs=3)
    path.write_text(json.dumps({"data": {"kind": "tcga_like", "n_patients": 40,
                                         "dims": {"ge": 16, "meth": 4, "mirna": 4}, "seed": 0},
                                "modality": "ge", "model": wild}))
    assert main(args) == 0  # without the flag the run ends, not finite
    with pytest.raises(FloatingPointError, match="debug_nans"):
        main(args + ["--debug-nans"])

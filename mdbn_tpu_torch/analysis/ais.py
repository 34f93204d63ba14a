"""Annealed importance sampling for RBM partition functions, and DBN bounds.

Port of ``mdbn_tpu/analysis/ais.py`` (Salakhutdinov & Murray, "On the
quantitative analysis of deep belief networks", ICML 2008): estimate log Z of
a trained RBM by annealing from a base model with a known partition function
through K intermediate distributions, and report the test log-likelihood as
``mean(-F(v)) - log Z``. Covered, as in the reference: Bernoulli- and
Gaussian-visible RBMs (learned variance too), forward and reverse anneals,
the SMC variant (ESS-triggered multinomial resampling), the bidirectional
bracket, the associative label-top RBM over its one-hot support, the DBN and
labeled-DBN variational bounds, and the exact enumerators that validate them.

The anneal runs on the parameters' device (move them to run it elsewhere),
in float32 whatever the storage dtype, with TF32 off for its products (the
log-weights sum 1,000 steps). The reference runs each anneal as one
``jax.lax.scan``; here it is a Python loop over consecutive β pairs that
makes no host read of a device value: the products ``v W + c`` and ``v·a``
are formed once a step and serve log p*_β at both β and the step's first
hidden draw, the SMC's ``lax.cond`` is a device-side ``torch.where`` on the
mask ``ESS < threshold``, and the estimate, the ESS and the resample count
are read once, after the loop. The exact enumerators run in float64 numpy on
the host, as the reference's do; they take the port's ``RBMParams`` (torch
tensors) or numpy arrays.

**Draws.** Every function that takes a ``key`` in the reference takes
``seed`` in its place, and ``generator`` (a ``torch.Generator`` on the
parameters' device, default one seeded with ``seed``) and ``draws``: a dict of
named draws (``train/draws.py``), to feed a run the reference's own draws or
to record a run's draws (a name the dict lacks is drawn from the generator
and written into it, so empty dicts hand back every draw). The names, and
the reference's keys each is rebuilt from:

- a forward anneal (``ais_log_z``, ``ais_log_z_gaussian``, the
  ``_ais_forward_*``): ``k0, kscan = split(key)``; ``"init"`` [n, V] the base
  sample's uniforms from ``k0`` (normals on the Gaussian path); ``"steps"``,
  one dict a β pair, step t from ``k_t = split(kscan, K - 1)[t]``: the SMC
  splits ``kres, ksweep = split(k_t)`` and ``"res"`` [n, n] is the resample's
  Gumbel noise ``gumbel(kres, (n, n))`` (``categorical(kres, logw, (n,))``
  is ``argmax(logw + gumbel, -1)``); sweep s from ``fold_in(ksweep or k_t,
  s)`` split into ``kh, kv``: ``"h{s}"`` [n, H] uniforms, ``"v{s}"`` [n, V]
  uniforms (normals on the Gaussian path);
- a reverse anneal: ``"steps"`` as above from ``split(key, K - 1)``;
- the labeled anneal: ``k0, kl0, kscan = split(key, 3)``: ``"init"`` [n,
  n_code], ``"init_label"`` [n, C] uniforms in [1e-20, 1); sweep s from
  ``kh, kv, kl = split(fold_in(k_t, s), 3)``: ``"h{s}"``, ``"v{s}"`` [n,
  n_code], ``"l{s}"`` [n, C] in [1e-20, 1);
- ``_mix_at_model``: ``"steps"``, sweep i's ``"h0"``, ``"v0"`` from
  ``split(fold_in(key, i))``;
- ``log_z_bracket``: ``kf, km, kr = split(key, 3)``: ``"fwd"`` the forward
  anneal's draws (``kf``), ``"res"`` [n, n] the resample init's Gumbel noise
  (``km``) or ``"mix"`` the Gibbs init's draws (``km``), ``"rev"`` the
  reverse anneal's (``kr``);
- ``log_likelihood``: the forward anneal's;
- the DBN and labeled-DBN bounds: ``kais, kq = split(key)``: ``"ais"`` the
  top's forward anneal (``kais``), and up-pass s's layer l ``"q{s}_{l}"`` [N,
  width] uniforms: ``k = split(kq, S)[s]``, then per layer ``k, kl =
  split(k)``, from ``kl``. A one-layer stack takes ``log_likelihood``'s.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RBMConfig
from ..core.rbm_math import (RBMParams, check_fixed_variance_layers, free_energy,
                             inv_sigma2, noise_scale)
from ..train.draws import GUMBEL_LOW, StepDraws, generator_for, softmax_sample, whole_draw
from ..train.labeled import _class_neg_free_energy

Layers = Sequence[Tuple[RBMParams, RBMConfig]]


# -- set-up ---------------------------------------------------------------------------


@contextlib.contextmanager
def _full_f32():
    """True float32 products (TF32 off) for the duration: the anneal sums
    log-weight increments over every step."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _f32(params: RBMParams, device: torch.device) -> RBMParams:
    return params.map(lambda t: torch.as_tensor(t).to(device=device, dtype=torch.float32))


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def _sub(draws: Optional[dict], name: str) -> Optional[dict]:
    """The nested draw dict ``draws[name]`` (made empty where missing)."""
    return None if draws is None else draws.setdefault(name, {})


# -- schedule and base models ------------------------------------------------------------


def base_rate_biases(data, eps: float = 1e-2) -> torch.Tensor:
    """Visible biases of the base-rate model: logit of smoothed data marginals."""
    p = torch.clamp(torch.as_tensor(data).float().mean(dim=0), eps, 1.0 - eps)
    return torch.log(p) - torch.log1p(-p)


def _linspace32(start: float, stop: float, num: int, endpoint: bool = True) -> np.ndarray:
    """``jnp.linspace`` in float32: start (1 - step) + stop step, step = i (1 /
    div) as XLA computes it (the uniform path 0 -> 1 bit for bit; others to
    an ulp, XLA's own rounding of the sum)."""
    div = num - 1 if endpoint else num
    if div == 0:
        return np.full(num, start, np.float32)
    step = np.arange(div, dtype=np.float32) * (np.float32(1.0) / np.float32(div))
    out = np.float32(start) * (np.float32(1.0) - step) + np.float32(stop) * step
    return np.concatenate([out, [np.float32(stop)]]).astype(np.float32) if endpoint else out


def anneal_betas(n_betas: int, schedule: str = "uniform") -> torch.Tensor:
    """The annealing temperature path, beta_0 = 0 -> beta_{K-1} = 1 (float32,
    on the host).

    ``uniform``: linspace. ``sm``: the Salakhutdinov-Murray (ICML 2008 §4.1)
    piecewise-uniform path, 500:4000:10000 of the betas on [0, 0.5]:[0.5,
    0.9]:[0.9, 1.0], the same proportions applied to any n_betas.
    """
    if schedule == "uniform":
        return torch.from_numpy(_linspace32(0.0, 1.0, n_betas))
    if schedule != "sm":
        raise ValueError(f"unknown anneal schedule {schedule!r}")
    n1 = max(2, round(n_betas * 500 / 14500))
    n2 = max(2, round(n_betas * 4000 / 14500))
    n3 = n_betas - n1 - n2
    if n3 < 2:
        raise ValueError(f"n_betas={n_betas} too small for the sm schedule")
    return torch.from_numpy(np.concatenate([
        _linspace32(0.0, 0.5, n1, endpoint=False),
        _linspace32(0.5, 0.9, n2, endpoint=False),
        _linspace32(0.9, 1.0, n3)]))


def _ess(logw: torch.Tensor) -> torch.Tensor:
    """Kong's effective sample size of importance weights, exp-free."""
    return torch.exp(2.0 * torch.logsumexp(logw, 0) - torch.logsumexp(2.0 * logw, 0))


def _bernoulli_log_z_a(params: RBMParams, a_base: torch.Tensor) -> torch.Tensor:
    # base-rate RBM with H unwired hidden units at beta=0 contributes 2^H
    return F.softplus(a_base).sum() + params.W.shape[1] * math.log(2.0)


def _gaussian_log_z_a(params: RBMParams):
    # log Z_A = sum_i (1/2) log(2 pi sigma_i^2) + H log 2
    V, H = params.W.shape
    lz = 0.5 * V * math.log(2.0 * math.pi) + H * math.log(2.0)
    return lz if params.z is None else lz + 0.5 * params.z.sum()


# -- the anneal paths ---------------------------------------------------------------------


class _BernoulliPath:
    """The Bernoulli anneal path, p_beta(v) ∝ exp((1-beta) a_A.v + beta a_B.v)
    prod_j (1 + exp(beta (v W + c)_j)). ``stats(v)`` forms the products once;
    ``log_p_star(st, beta)`` evaluates log p*_beta at any beta from them and
    hands back beta (v W + c) for the step's first hidden draw."""

    def __init__(self, params: RBMParams, a_base: torch.Tensor):
        self.W, self.c, self.a_base, self.a_B = params.W, params.c, a_base, params.b
        self.ab = torch.stack([a_base, params.b], dim=1)  # [V, 2]

    def stats(self, v: torch.Tensor):
        q = v @ self.ab
        return q[:, 0], q[:, 1], torch.addmm(self.c, v, self.W)

    def log_p_star(self, st, beta: float):
        va, vb, x = st
        z = beta * x
        return (1.0 - beta) * va + beta * vb + F.softplus(z).sum(dim=1), z

    def _hidden(self, d: StepDraws, s: int, v, beta: float, z):
        if z is None:
            z = beta * torch.addmm(self.c, v, self.W)
        return d.bern(f"h{s}", torch.sigmoid(z))

    def _visible_pre(self, h, beta: float) -> torch.Tensor:
        return (1.0 - beta) * self.a_base + beta * torch.addmm(self.a_B, h, self.W.T)

    def sweep(self, d: StepDraws, s: int, v, beta: float, z=None) -> torch.Tensor:
        """Gibbs sweep ``s`` targeting p_beta (``z``: beta (v W + c) where known)."""
        h = self._hidden(d, s, v, beta, z)
        return d.bern(f"v{s}", torch.sigmoid(self._visible_pre(h, beta)))


class _LabeledPath(_BernoulliPath):
    """The associative label-top path: the Bernoulli path's log p* over
    [code ; one-hot label], the label block drawn as one categorical a row
    (Gumbel-max) at every beta."""

    def __init__(self, params: RBMParams, a_base: torch.Tensor, n_code: int):
        super().__init__(params, a_base)
        self.n_code = n_code

    def sweep(self, d: StepDraws, s: int, v, beta: float, z=None) -> torch.Tensor:
        h = self._hidden(d, s, v, beta, z)
        pre = self._visible_pre(h, beta)
        code = d.bern(f"v{s}", torch.sigmoid(pre[:, :self.n_code]))
        return torch.cat([code, d.softmax(f"l{s}", pre[:, self.n_code:])], dim=1)


class _GaussianPath:
    """The Gaussian path (per-unit sigma^2 = exp(z) when the variance is
    learned, else 1): p_beta(v) ∝ exp(-(1-beta)/2 ||v-b_A||_s^2 - beta/2
    ||v-b_B||_s^2) prod_j (1 + exp(beta ((v s) W + c)_j)); the visible
    conditional at every beta is N(m_beta + beta W h, sigma^2)."""

    def __init__(self, params: RBMParams, b_base: torch.Tensor):
        self.W, self.c, self.b_base, self.b_B = params.W, params.c, b_base, params.b
        self.s, self.sigma = inv_sigma2(params), noise_scale(params)
        d = (b_base - params.b) ** 2
        self.d2 = (d if self.s is None else d * self.s).sum()

    def _vin(self, v):
        return v if self.s is None else v * self.s

    def stats(self, v: torch.Tensor):
        return v, torch.addmm(self.c, self._vin(v), self.W)

    def log_p_star(self, st, beta: float):
        v, x = st
        q = (v - ((1.0 - beta) * self.b_base + beta * self.b_B)) ** 2
        quad = (-0.5 * (q if self.s is None else q * self.s).sum(dim=1)
                - 0.5 * beta * (1.0 - beta) * self.d2)
        z = beta * x
        return quad + F.softplus(z).sum(dim=1), z

    def sweep(self, d: StepDraws, s: int, v, beta: float, z=None) -> torch.Tensor:
        if z is None:
            z = beta * torch.addmm(self.c, self._vin(v), self.W)
        h = d.bern(f"h{s}", torch.sigmoid(z))
        m = (1.0 - beta) * self.b_base + beta * self.b_B + beta * (h @ self.W.T)
        noise = d.normal(f"v{s}", m.shape[1])
        return m + (noise if self.sigma is None else noise * self.sigma)


def _steps(draws: Optional[dict], n: int):
    """The per-step draw dicts of an anneal of ``n`` steps (None: none kept)."""
    if draws is None:
        return None
    steps = draws.setdefault("steps", [])
    steps.extend({} for _ in range(n - len(steps)))
    return steps


def _anneal(path, v: torch.Tensor, betas: torch.Tensor, n_sweeps: int, resample_ess: float,
            gen: torch.Generator, draws: Optional[dict]):
    """The AIS chain over consecutive beta pairs (src -> dst): add log
    p*_dst(v) - log p*_src(v) at the current state, then ``n_sweeps`` Gibbs
    transitions targeting p_dst. ``resample_ess`` > 0: the SMC sampler (Del
    Moral, Doucet & Jasra 2006), resampling the chains by weight and
    resetting the weights wherever their ESS falls below ``resample_ess *
    n``, as a device-side select. Returns (v, logw, logz_acc, n_resamples),
    all on the device; log(Z_dst / Z_src) is ``logz_acc + logsumexp(logw) -
    log n``."""
    n, device = v.shape[0], v.device
    logw = torch.zeros(n, device=device)
    logz_acc = torch.zeros((), device=device)
    n_res = torch.zeros((), dtype=torch.int32, device=device)
    thresh, log_n = resample_ess * n, math.log(n)
    bl = betas.tolist()
    steps = _steps(draws, len(bl) - 1)
    for t in range(len(bl) - 1):
        b_src, b_dst = bl[t], bl[t + 1]
        d = StepDraws(None if steps is None else steps[t], gen, device, n)
        st = path.stats(v)
        lp_dst, z = path.log_p_star(st, b_dst)
        logw = logw + lp_dst - path.log_p_star(st, b_src)[0]
        if resample_ess > 0.0:
            lse = torch.logsumexp(logw, 0)
            resample = torch.exp(2.0 * lse - torch.logsumexp(2.0 * logw, 0)) < thresh
            idx = torch.argmax(logw + d.gumbel("res", n), dim=1)
            v = torch.where(resample, v[idx], v)
            z = torch.where(resample, z[idx], z)
            logz_acc = logz_acc + torch.where(resample, lse - log_n, 0.0)
            logw = torch.where(resample, 0.0, logw)
            n_res = n_res + resample
        for s in range(n_sweeps):
            v = path.sweep(d, s, v, b_dst, z if s == 0 else None)
    return v, logw, logz_acc, n_res


# -- forward and reverse anneals ------------------------------------------------------------


def _ais_forward_bernoulli(params, a_base, n_chains, n_betas, n_sweeps, schedule,
                           resample_ess=0.0, *, generator, draws=None):
    """Forward anneal returning (log_z, logw, v_final, n_resamples), on the
    params' device. The final states weighted by exp(logw) are
    importance-weighted samples of the model. ``resample_ess`` > 0: SMC (the
    returned logw are the final epoch's only)."""
    device = params.W.device
    with _full_f32():
        p0 = torch.sigmoid(a_base)
        u = _tensor(whole_draw(draws, "init", lambda: torch.rand(
            (n_chains, params.W.shape[0]), generator=generator, device=device)), device)
        v = (u < p0).float()
        v, logw, logz_acc, n_res = _anneal(_BernoulliPath(params, a_base), v,
                                           anneal_betas(n_betas, schedule), n_sweeps,
                                           resample_ess, generator, draws)
        log_z = (_bernoulli_log_z_a(params, a_base) + logz_acc + torch.logsumexp(logw, 0)
                 - math.log(n_chains))
    return log_z, logw, v, n_res


def _ais_forward_gaussian(params, b_base, n_chains, n_betas, n_sweeps, schedule,
                          resample_ess=0.0, *, generator, draws=None):
    """Gaussian forward anneal returning (log_z, logw, v_final, n_resamples)."""
    device = params.W.device
    with _full_f32():
        noise = _tensor(whole_draw(draws, "init", lambda: torch.randn(
            (n_chains, params.W.shape[0]), generator=generator, device=device)), device)
        v, logw, logz_acc, n_res = _anneal(_GaussianPath(params, b_base), b_base + noise,
                                           anneal_betas(n_betas, schedule), n_sweeps,
                                           resample_ess, generator, draws)
        log_z = (_gaussian_log_z_a(params) + logz_acc + torch.logsumexp(logw, 0)
                 - math.log(n_chains))
    return log_z, logw, v, n_res


def _reverse(path, log_z_a, v_init, n_betas, n_sweeps, schedule, resample_ess, gen, draws):
    with _full_f32():
        betas = anneal_betas(n_betas, schedule).flip(0)
        v, logw, logz_acc, _ = _anneal(path, v_init, betas, n_sweeps, resample_ess, gen, draws)
        log_z = log_z_a - (logz_acc + torch.logsumexp(logw, 0) - math.log(v.shape[0]))
    return log_z, logw


def ais_log_z(params: RBMParams, a_base, seed: int = 0, n_chains: int = 256,
              n_betas: int = 1000, n_sweeps: int = 1, schedule: str = "uniform",
              resample_ess: float = 0.0, *,
              generator: Optional[torch.Generator] = None,
              draws: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate log Z of a Bernoulli RBM. Returns (log_z_estimate,
    log_weights) on the device.

    ``n_sweeps`` Gibbs sweeps per beta; ``schedule`` picks the beta path
    (:func:`anneal_betas`). A stochastic lower bound of log Z in expectation;
    :func:`reverse_ais_log_z` gives the matching upper bound. ``resample_ess``
    in (0, 1) enables SMC resampling whenever the chains' ESS falls below
    that fraction; the returned logw are then the final epoch's only.
    """
    dev = params.W.device
    params = _f32(params, dev)
    log_z, logw, _, _ = _ais_forward_bernoulli(
        params, _tensor(a_base, dev), n_chains, n_betas, n_sweeps, schedule, resample_ess,
        generator=generator_for(dev, seed, generator), draws=draws)
    return log_z, logw


def reverse_ais_log_z(params: RBMParams, a_base, v_init, seed: int = 0, n_betas: int = 1000,
                      n_sweeps: int = 1, schedule: str = "uniform", resample_ess: float = 0.0,
                      *, generator: Optional[torch.Generator] = None,
                      draws: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse AIS: anneal model samples ``v_init`` [n_chains, V] from beta=1
    down to the base model. With exact model samples, ``log Z_A - log
    mean(exp(logw))`` is a stochastic upper bound of log Z in expectation
    (Grosse, Ghahramani & Adams 2015); with approximate ``v_init`` only
    insofar as the chains have mixed. ``resample_ess`` > 0: SMC resampling of
    the descending anneal."""
    dev = params.W.device
    params = _f32(params, dev)
    a_base = _tensor(a_base, dev)
    return _reverse(_BernoulliPath(params, a_base), _bernoulli_log_z_a(params, a_base),
                    _tensor(v_init, dev), n_betas, n_sweeps, schedule, resample_ess,
                    generator_for(dev, seed, generator), draws)


def ais_log_z_gaussian(params: RBMParams, b_base, seed: int = 0, n_chains: int = 256,
                       n_betas: int = 1000, n_sweeps: int = 1, schedule: str = "uniform",
                       resample_ess: float = 0.0, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """AIS log Z of a Gaussian-visible RBM (a stochastic lower bound in
    expectation; :func:`reverse_ais_log_z_gaussian` gives the upper bound).
    ``resample_ess`` > 0: SMC resampling."""
    dev = params.W.device
    params = _f32(params, dev)
    log_z, logw, _, _ = _ais_forward_gaussian(
        params, _tensor(b_base, dev), n_chains, n_betas, n_sweeps, schedule, resample_ess,
        generator=generator_for(dev, seed, generator), draws=draws)
    return log_z, logw


def reverse_ais_log_z_gaussian(params: RBMParams, b_base, v_init, seed: int = 0,
                               n_betas: int = 1000, n_sweeps: int = 1,
                               schedule: str = "uniform", resample_ess: float = 0.0, *,
                               generator: Optional[torch.Generator] = None,
                               draws: Optional[dict] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse AIS for the Gaussian-visible RBM: the upper-bound half of the
    bidirectional bracket (see :func:`reverse_ais_log_z`)."""
    dev = params.W.device
    params = _f32(params, dev)
    return _reverse(_GaussianPath(params, _tensor(b_base, dev)), _gaussian_log_z_a(params),
                    _tensor(v_init, dev), n_betas, n_sweeps, schedule, resample_ess,
                    generator_for(dev, seed, generator), draws)


def _mix_at_model(params: RBMParams, v, seed: int, n_sweeps: int, visible: str, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> torch.Tensor:
    """``n_sweeps`` full Gibbs sweeps at beta=1 (approximate model samples)."""
    dev = params.W.device
    params = _f32(params, dev)
    gen = generator_for(dev, seed, generator)
    # beta=1: the base term vanishes from the conditional
    path = (_BernoulliPath if visible == "bernoulli" else _GaussianPath)(params, params.b)
    v = _tensor(v, dev)
    steps = _steps(draws, n_sweeps)
    with _full_f32():
        for i in range(n_sweeps):
            v = path.sweep(StepDraws(None if steps is None else steps[i], gen, dev, v.shape[0]),
                           0, v, 1.0)
    return v


# -- the bracket and the likelihood --------------------------------------------------------


def _forward(params, cfg, base, n_chains, n_betas, n_sweeps, schedule, resample_ess, gen,
             draws):
    """(a_base, (log_z, logw, v, n_res)) of the forward anneal for ``cfg.visible``."""
    if cfg.visible == "bernoulli":
        a_base = base_rate_biases(base)
        run = _ais_forward_bernoulli
    else:
        a_base = base.mean(dim=0)
        run = _ais_forward_gaussian
    return a_base, run(params, a_base, n_chains, n_betas, n_sweeps, schedule, resample_ess,
                       generator=gen, draws=draws)


def log_z_bracket(params: RBMParams, cfg: RBMConfig, data, seed: int = 0,
                  n_chains: int = 256, n_betas: int = 1000, n_sweeps: int = 1,
                  schedule: str = "uniform", base_data=None, init: str = "resample",
                  init_gibbs: int = 500, v_init=None, resample_ess: float = 0.0, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None) -> dict:
    """Bidirectional Monte Carlo bracket on log Z (Grosse et al. 2015): the
    forward anneal's lower bound and the reverse anneal's upper bound, and
    their gap as the convergence diagnostic.

    The upper bound is only as good as the reverse chains' init: ``v_init``
    (caller-supplied model samples), ``init="resample"`` (the forward
    anneal's final states resampled by their weights; ``ess_fwd`` reports
    how many effective samples backed it) or ``init="gibbs"`` (data rows
    mixed by ``init_gibbs`` Gibbs sweeps at beta=1; an inverted gap under it
    says the chains had not mixed). ``resample_ess`` in (0, 1) runs both
    anneals as SMC samplers (``n_resamples_fwd`` counts the forward
    resampling epochs).
    """
    if v_init is None and init not in ("resample", "gibbs"):
        raise ValueError(f"unknown bracket init {init!r}")
    dev = params.W.device
    params = _f32(params, dev)
    gen = generator_for(dev, seed, generator)
    data = _tensor(data, dev)
    base = _tensor(base_data, dev) if base_data is not None else data
    a_base, (fwd, logw_f, v_f, n_res) = _forward(params, cfg, base, n_chains, n_betas,
                                                 n_sweeps, schedule, resample_ess, gen,
                                                 _sub(draws, "fwd"))
    if v_init is not None:
        v_init = _tensor(v_init, dev)
    elif init == "resample":
        g = StepDraws(draws, gen, dev, n_chains).gumbel("res", n_chains)
        v_init = v_f[torch.argmax(logw_f + g, dim=1)]
    else:
        reps = (n_chains + data.shape[0] - 1) // data.shape[0]
        v_init = _mix_at_model(params, data.repeat(reps, 1)[:n_chains], seed, init_gibbs,
                               cfg.visible, generator=gen, draws=_sub(draws, "mix"))
    if cfg.visible == "bernoulli":
        path, log_z_a = _BernoulliPath(params, a_base), _bernoulli_log_z_a(params, a_base)
    else:
        path, log_z_a = _GaussianPath(params, a_base), _gaussian_log_z_a(params)
    rev, logw_r = _reverse(path, log_z_a, v_init, n_betas, n_sweeps, schedule, resample_ess,
                           gen, _sub(draws, "rev"))
    mean_neg_fe = -free_energy(params, data, cfg).mean()
    return {
        "log_z_lower": float(fwd),
        "log_z_upper": float(rev),
        "log_z_gap": float(rev - fwd),
        "logw_std_fwd": float(logw_f.std(correction=0)),
        "logw_std_rev": float(logw_r.std(correction=0)),
        "ess_fwd": float(_ess(logw_f)),
        "n_resamples_fwd": int(n_res),
        # ll bounds invert: a lower log Z gives the upper log-likelihood
        "mean_log_likelihood_lower": float(mean_neg_fe - rev),
        "mean_log_likelihood_upper": float(mean_neg_fe - fwd),
    }


def log_likelihood(params: RBMParams, cfg: RBMConfig, data, seed: int = 0,
                   n_chains: int = 256, n_betas: int = 1000, base_data=None,
                   n_sweeps: int = 1, schedule: str = "uniform", resample_ess: float = 0.0,
                   *, generator: Optional[torch.Generator] = None,
                   draws: Optional[dict] = None) -> dict:
    """Mean test log-likelihood via AIS, mean(-F(v)) - log Z, of a Bernoulli-
    or Gaussian-visible RBM. ``resample_ess`` > 0: SMC resampling."""
    dev = params.W.device
    params = _f32(params, dev)
    data = _tensor(data, dev)
    base = _tensor(base_data, dev) if base_data is not None else data
    _, (log_z, logw, _, _) = _forward(params, cfg, base, n_chains, n_betas, n_sweeps,
                                      schedule, resample_ess,
                                      generator_for(dev, seed, generator), draws)
    mean_neg_fe = -free_energy(params, data, cfg).mean()
    return {
        "log_z": float(log_z),
        "mean_log_likelihood": float(mean_neg_fe - log_z),
        "logw_std": float(logw.std(correction=0)),
    }


# -- DBN bounds -------------------------------------------------------------------------------


def _up_pass(layers, gen, v: torch.Tensor, d: StepDraws, s: int):
    """One stochastic up-pass through the directed ``layers``: (log p(path
    below the top) - log Q(path) [N], the top code sample). ``gen``: the
    untied generative (W, b) per layer, or None (tied)."""
    eps = 1e-7
    h = v
    total = torch.zeros(v.shape[0], device=v.device)
    for li, (p, cfg) in enumerate(layers):
        hin = h if p.z is None else h * torch.exp(-p.z)
        q = torch.sigmoid(torch.addmm(p.c, hin, p.W)).clamp(eps, 1.0 - eps)
        hs = d.bern(f"q{s}_{li}", q)
        # -log Q(h^l | h^{l-1})
        total = total - (hs * torch.log(q) + (1 - hs) * torch.log1p(-q)).sum(dim=1)
        # + log p_l(h^{l-1} | h^l): the generative top-down term of RBM l
        Wg, bg = gen[li] if gen is not None else (p.W, p.b)
        mean_down = torch.addmm(bg, hs, Wg.T)
        if cfg.visible == "gaussian":
            dd = h - mean_down
            if p.z is None:
                total = total + (-0.5 * (dd * dd).sum(dim=1)
                                 - 0.5 * h.shape[1] * math.log(2.0 * math.pi))
            else:
                # N(mean_down, sigma^2) with learned per-unit sigma
                total = total + (-0.5 * (dd * dd * torch.exp(-p.z)).sum(dim=1)
                                 - 0.5 * (math.log(2.0 * math.pi) + p.z).sum())
        else:
            pd = torch.sigmoid(mean_down).clamp(eps, 1.0 - eps)
            total = total + (h * torch.log(pd) + (1 - h) * torch.log1p(-pd)).sum(dim=1)
        h = hs
    return total, h


def _codes(layers, data: torch.Tensor) -> torch.Tensor:
    """The mean-field codes of ``data`` through ``layers``."""
    reps = data
    for p, _ in layers:
        vin = reps if p.z is None else reps * torch.exp(-p.z)
        reps = torch.sigmoid(torch.addmm(p.c, vin, p.W))
    return reps


def _bound(layers, gen, data, n_samples, top_term, log_z_top, logw, rng, draws) -> dict:
    """E_Q[log p*(path) - log Q(path)] - log Z_top over ``n_samples`` up-passes
    run one after the other (peak memory: one pass), ``top_term(h)`` [N] the
    top's unnormalised log-probability of the top code."""
    device = data.device
    means = []
    with _full_f32():
        for s in range(n_samples):
            d = StepDraws(draws, rng, device, data.shape[0])
            total, h = _up_pass(layers, gen, data, d, s)
            means.append((total + top_term(h)).mean())
    means = torch.stack(means)
    return {
        "log_z_top": float(log_z_top),
        "mean_log_likelihood_bound": float(means.mean() - log_z_top),
        "logw_std": float(logw.std(correction=0)),
        "mc_std": float(means.std(correction=0)),
    }


def _layers_f32(layers, device):
    return [(_f32(p, device), cfg) for p, cfg in layers]


def _gen_f32(gen, device):
    return None if gen is None else [(_tensor(W, device), _tensor(b, device)) for W, b in gen]


def dbn_log_likelihood_bound(layers: Layers, data, seed: int = 0, n_samples: int = 32,
                             n_chains: int = 256, n_betas: int = 1000, base_data=None,
                             n_sweeps: int = 1, schedule: str = "uniform", gen=None, *,
                             generator: Optional[torch.Generator] = None,
                             draws: Optional[dict] = None) -> dict:
    """Salakhutdinov-Murray variational lower bound on DBN log-likelihood:

        log p(v) >= E_Q[ log p*(h^{L-1}) + sum_l log p(h^{l-1}|h^l) - log Q ]
                    - log Z_top,

    Q the factorial stochastic up-pass sampled ``n_samples`` times per row,
    log Z_top from AIS on the top RBM (based at the data codes' marginals).
    A one-layer stack reduces to :func:`log_likelihood`, under this
    function's keys. ``gen``: the untied generative (W, b) per directed layer
    after up-down fine-tuning (``train/updown.py``); None: tied."""
    top_params, top_cfg = layers[-1]
    dev = top_params.W.device
    if len(layers) == 1:
        out = log_likelihood(top_params, top_cfg, data, seed, n_chains, n_betas, base_data,
                             n_sweeps, schedule, generator=generator, draws=draws)
        out["mean_log_likelihood_bound"] = out.pop("mean_log_likelihood")
        # same keys as the multi-layer branch so depth-generic callers work
        out["log_z_top"] = out.pop("log_z")
        out["mc_std"] = 0.0  # no stochastic Q pass for a bare RBM
        return out
    rng = generator_for(dev, seed, generator)
    layers = _layers_f32(layers, dev)
    top_params, top_cfg = layers[-1]
    data = _tensor(data, dev)
    with _full_f32():
        a_base = base_rate_biases(_codes(layers[:-1], data))
    log_z_top, logw = ais_log_z(top_params, a_base, seed, n_chains, n_betas, n_sweeps,
                                schedule, generator=rng, draws=_sub(draws, "ais"))
    return _bound(layers[:-1], _gen_f32(gen, dev), data, n_samples,
                  lambda h: -free_energy(top_params, h, top_cfg), log_z_top, logw, rng, draws)


def _ais_forward_labeled(params, a_base, n_code, n_chains, n_betas, n_sweeps, schedule, *,
                         generator, draws=None):
    device = params.W.device
    n_classes = params.W.shape[0] - n_code
    with _full_f32():
        p0 = torch.sigmoid(a_base[:n_code])
        u = _tensor(whole_draw(draws, "init", lambda: torch.rand(
            (n_chains, n_code), generator=generator, device=device)), device)
        u_l = _tensor(whole_draw(draws, "init_label", lambda: torch.rand(
            (n_chains, n_classes), generator=generator, device=device).clamp_min(GUMBEL_LOW)),
            device)
        label = softmax_sample(u_l, a_base[n_code:].expand(n_chains, n_classes))
        v = torch.cat([(u < p0).float(), label], dim=1)
        v, logw, _, _ = _anneal(_LabeledPath(params, a_base, n_code), v,
                                anneal_betas(n_betas, schedule), n_sweeps, 0.0, generator,
                                draws)
        # base log Z: independent code bits x one categorical label group,
        # times 2^H for the unwired hidden units
        log_z_a = (F.softplus(a_base[:n_code]).sum() + torch.logsumexp(a_base[n_code:], 0)
                   + params.W.shape[1] * math.log(2.0))
        log_z = log_z_a + torch.logsumexp(logw, 0) - math.log(n_chains)
    return log_z, logw


def ais_log_z_labeled(params: RBMParams, a_base, n_code: int, seed: int = 0,
                      n_chains: int = 256, n_betas: int = 1000, n_sweeps: int = 1,
                      schedule: str = "uniform", *,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """AIS log Z of an associative label-top RBM over its true support
    {0,1}^n_code x {one-hot labels}; ``a_base`` [n_code + n_classes] (the
    label block: the base label distribution's logits). Returns
    (log_z_estimate, log_weights)."""
    dev = params.W.device
    return _ais_forward_labeled(_f32(params, dev), _tensor(a_base, dev), int(n_code),
                                n_chains, n_betas, n_sweeps, schedule,
                                generator=generator_for(dev, seed, generator), draws=draws)


def labeled_dbn_log_likelihood_bound(layers: Layers, label_top: RBMParams, n_classes: int,
                                     data, seed: int = 0, n_samples: int = 32,
                                     n_chains: int = 256, n_betas: int = 1000,
                                     n_sweeps: int = 1, schedule: str = "uniform", gen=None,
                                     *, generator: Optional[torch.Generator] = None,
                                     draws: Optional[dict] = None) -> dict:
    """Variational lower bound on log p(v) under the complete labeled 2006
    model (``train/updown.py::finetune_updown_labeled``): every stack layer
    directed, the associative label-top RBM the undirected top, the label
    marginalised exactly at the top (log p*(h^L) = logsumexp_y -F_top([h^L ;
    e_y])), and log Z_top from AIS over the one-hot-restricted support
    (:func:`ais_log_z_labeled`, its label base uniform)."""
    if not layers:
        raise ValueError("needs >= 1 directed layer below the label top")
    n_code = layers[-1][0].W.shape[1]
    if label_top.W.shape[0] != n_code + n_classes:
        raise ValueError(f"label top has visible {label_top.W.shape[0]}, "
                         f"expected {n_code} + {n_classes}")
    if gen is not None and len(gen) != len(layers):
        raise ValueError(f"gen has {len(gen)} entries, expected one per "
                         f"stack layer ({len(layers)})")
    dev = layers[0][0].W.device
    rng = generator_for(dev, seed, generator)
    layers = _layers_f32(layers, dev)
    top = _f32(label_top, dev)
    data = _tensor(data, dev)
    with _full_f32():
        # base the anneal at the aggregate posterior's code marginals; the
        # label base is uniform (labels are unobserved at evaluation time)
        a_base = torch.cat([base_rate_biases(_codes(layers, data)),
                            torch.zeros(n_classes, device=dev)])
    log_z_top, logw = ais_log_z_labeled(top, a_base, n_code, seed, n_chains, n_betas,
                                        n_sweeps, schedule, generator=rng,
                                        draws=_sub(draws, "ais"))
    return _bound(layers, _gen_f32(gen, dev), data, n_samples,
                  lambda h: torch.logsumexp(_class_neg_free_energy(top, h, n_code), dim=1),
                  log_z_top, logw, rng, draws)


# -- exact enumeration (float64, on the host) ----------------------------------------------


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def _hidden_states(H: int) -> np.ndarray:
    return ((np.arange(2 ** H)[:, None] >> np.arange(H)) & 1).astype(np.float64)


def exact_log_z(params: RBMParams) -> float:
    """Brute-force log Z by enumerating hidden states (H <= ~16 only):
    Z = sum_h exp(c.h) prod_i (1 + exp(b_i + (W h)_i))."""
    from scipy.special import logsumexp

    W, b, c = _f64(params.W), _f64(params.b), _f64(params.c)
    V, H = W.shape
    if H > 16:
        raise ValueError("exact enumeration needs n_hidden <= 16")
    hs = _hidden_states(H)
    soft = np.logaddexp(0.0, b[None, :] + hs @ W.T).sum(axis=1)
    return float(logsumexp(hs @ c + soft))


def exact_log_z_gaussian(params: RBMParams) -> float:
    """Brute-force log Z for a GRBM (H <= ~16 only):
    Z = prod_i sqrt(2 pi sigma_i^2)
        * sum_h exp(c.h + sum_i [b_i (Wh)_i + (Wh)_i^2 / 2] / sigma_i^2)."""
    from scipy.special import logsumexp

    W, b, c = _f64(params.W), _f64(params.b), _f64(params.c)
    V, H = W.shape
    if H > 16:
        raise ValueError("exact enumeration needs n_hidden <= 16")
    hs = _hidden_states(H)
    wh = hs @ W.T  # [2^H, V]
    const = 0.5 * V * np.log(2.0 * np.pi)
    if params.z is not None:
        z = _f64(params.z)
        s = np.exp(-z)
        const += 0.5 * float(z.sum())
        expo = hs @ c + wh @ (b * s) + 0.5 * np.sum(wh * wh * s, axis=1)
    else:
        expo = hs @ c + wh @ b + 0.5 * np.sum(wh * wh, axis=1)
    return float(const + logsumexp(expo))


def exact_sample(params: RBMParams, n: int, seed: int = 0,
                 visible: str = "bernoulli") -> np.ndarray:
    """Exact samples from a small RBM (H <= 16) by enumerating hidden states,
    then v | h (sigmoid-Bernoulli, or N(b + W h, sigma^2)): the ground-truth
    initialiser that makes :func:`reverse_ais_log_z` a valid upper bound.
    numpy's ``default_rng(seed)``, as the reference draws them."""
    from scipy.special import logsumexp

    W, b, c = _f64(params.W), _f64(params.b), _f64(params.c)
    V, H = W.shape
    if H > 16:
        raise ValueError("exact sampling needs n_hidden <= 16")
    hs = _hidden_states(H)
    wh = hs @ W.T  # [2^H, V]
    if visible == "bernoulli":
        logp = hs @ c + np.logaddexp(0.0, b[None, :] + wh).sum(axis=1)
    elif params.z is not None:
        s = np.exp(-_f64(params.z))
        logp = hs @ c + wh @ (b * s) + 0.5 * np.sum(wh * wh * s, axis=1)
    else:
        logp = hs @ c + wh @ b + 0.5 * np.sum(wh * wh, axis=1)
    p = np.exp(logp - logsumexp(logp))
    rng = np.random.default_rng(seed)
    idx = rng.choice(2 ** H, size=n, p=p / p.sum())
    mean = b[None, :] + wh[idx]  # [n, V] pre-activation / mean
    if visible == "bernoulli":
        v = (rng.random((n, V)) < 1.0 / (1.0 + np.exp(-mean)))
    else:
        noise = rng.standard_normal((n, V))
        if params.z is not None:
            noise = noise * np.exp(0.5 * _f64(params.z))
        v = mean + noise
    return v.astype(np.float32)


def exact_log_z_labeled(params: RBMParams, n_code: int, n_classes: int) -> float:
    """Brute-force log Z of an associative label-top RBM over its one-hot
    label support (``exact_log_z`` would overcount non-one-hot label
    configurations). Needs n_code <= ~14."""
    from scipy.special import logsumexp

    W, b, c = _f64(params.W), _f64(params.b), _f64(params.c)
    if W.shape[0] != n_code + n_classes:
        raise ValueError(f"W has visible {W.shape[0]}, expected {n_code} + {n_classes}")
    if n_code > 14:
        raise ValueError("exact enumeration needs n_code <= 14")
    return float(logsumexp(_labeled_neg_f(W, b, c, _hidden_states(n_code), n_code)))


def _labeled_neg_f(W, b, c, S, n_code) -> np.ndarray:
    """-F_top([s ; e_y]) for every code state s (rows of ``S``) and class y."""
    pre = S @ W[:n_code] + c[None, :]                                     # [Ns, H]
    hid = np.logaddexp(0.0, pre[:, None, :] + W[n_code:][None, :, :]).sum(axis=2)
    return S @ b[:n_code, None] + b[n_code:][None, :] + hid               # [Ns, C]


def _enum_states(n: int) -> np.ndarray:
    """All 2^n binary states as float64 rows: the bit-enumeration basis of
    the exact-likelihood enumerators."""
    if n > 14:
        raise ValueError(f"exact enumeration needs widths <= 14 (got {n})")
    return _hidden_states(n)


def _bern_cond_logp(S, T, W, b) -> np.ndarray:
    """log p(S_row | T_row) for Bernoulli rows under mean sigma(T W^T + b):
    [Ns, Nt]. Uses log sigma(x) = -softplus(-x)."""
    pre = T @ W.T + b[None, :]
    return (S @ (-np.logaddexp(0.0, -pre)).T
            + (1.0 - S) @ (-np.logaddexp(0.0, pre)).T)


def _bottom_logp(X, T, W0, b0, visible: str) -> np.ndarray:
    """log p(x_n | h^1 = t) for the data rows and the states ``T``: [N, Nt]."""
    if visible == "bernoulli":
        return _bern_cond_logp(X, T, W0, b0)
    mean = T @ W0.T + b0[None, :]                                         # [Nt, V]
    d = X[:, None, :] - mean[None, :, :]
    return -0.5 * np.sum(d * d, axis=2) - 0.5 * X.shape[1] * np.log(2.0 * np.pi)


def _branch(layers, gens, X) -> np.ndarray:
    """G[n, t] = log p(x_n | top of ``layers`` = t), the directed layers
    folded from the top down by message passing (each factor touches two
    adjacent layers)."""
    from scipy.special import logsumexp

    M = None  # [states of h^l, states of the top]
    for li in range(len(layers) - 1, 0, -1):
        W, b = _f64(gens[li][0]), _f64(gens[li][1])
        cond = _bern_cond_logp(_enum_states(W.shape[0]), _enum_states(W.shape[1]), W, b)
        M = cond if M is None else logsumexp(cond[:, :, None] + M[None, :, :], axis=1)
    W0, b0 = _f64(gens[0][0]), _f64(gens[0][1])
    logp = _bottom_logp(X, _enum_states(W0.shape[1]), W0, b0, layers[0][1].visible)
    return logp if M is None else logsumexp(logp[:, :, None] + M[None, :, :], axis=1)


def exact_dbn_log_likelihood(layers: Layers, data, gen=None) -> float:
    """Exact mean log-likelihood of a small DBN by full enumeration: an
    undirected top RBM over (h^{L-1}, h^L) and directed sigmoid layers below,

        log p(v) = logsumexp_{h^1..h^{L-1}} [ sum_l log p(h^l | h^{l+1})
                                              - F_top(h^{L-1}) ] - log Z_top,

    by message passing from the top (O(2^{n_l} 2^{n_{l+1}}) a directed
    layer). Hidden layers Bernoulli and <= ~14 units; the bottom may be
    Gaussian (sigma=1). ``gen``: untied generative (W, b) per directed layer;
    None = tied."""
    from scipy.special import logsumexp

    check_fixed_variance_layers(layers, "exact DBN likelihood enumeration")
    top_params, top_cfg = layers[-1]
    if top_cfg.visible != "bernoulli":
        raise ValueError("DBN top RBM must be Bernoulli-visible (its visible "
                         "layer is the previous stack layer's hidden units)")
    directed = layers[:-1]
    if gen is None:
        gen = [(p.W, p.b) for p, _ in directed]
    elif len(gen) != len(directed):
        raise ValueError(f"gen has {len(gen)} layers, stack has "
                         f"{len(directed)} directed layers")
    Wt, bt, ct = _f64(top_params.W), _f64(top_params.b), _f64(top_params.c)

    def neg_free_energy64(v):
        """-F(v) of the Bernoulli top RBM in float64: v.b + sum softplus."""
        return v @ bt + np.logaddexp(0.0, v @ Wt + ct[None, :]).sum(axis=1)

    if not directed:
        return float(np.mean(neg_free_energy64(_f64(data))) - exact_log_z(top_params))
    # the message from the top RBM over states of h^{L-1}
    f = neg_free_energy64(_enum_states(directed[-1][0].W.shape[1]))
    # fold the intermediate directed layers top-down: f_l(s) over states of h^l
    for li in range(len(directed) - 1, 0, -1):
        W, b = _f64(gen[li][0]), _f64(gen[li][1])
        cond = _bern_cond_logp(_enum_states(W.shape[0]), _enum_states(W.shape[1]), W, b)
        f = logsumexp(cond + f[None, :], axis=1)
    # the bottom layer: p(v | h^1) for the data rows
    W0, b0 = _f64(gen[0][0]), _f64(gen[0][1])
    logp = _bottom_logp(_f64(data), _enum_states(W0.shape[1]), W0, b0, directed[0][1].visible)
    ll = logsumexp(logp + f[None, :], axis=1)                             # [N]
    return float(np.mean(ll) - exact_log_z(top_params))


def exact_labeled_dbn_log_likelihood(layers: Layers, label_top: RBMParams, data, labels,
                                     n_classes: int, gen=None) -> float:
    """Exact mean joint log-likelihood log p(v, y) of a small labeled DBN:
    every layer a directed sigmoid layer, ``label_top`` the undirected
    associative RBM over [top code ; one-hot label],

        log p(v, y) = logsumexp_s [ log p(v | h^L = s) - F_top([s ; e_y]) ]
                      - log Z_top.

    ``labels=None`` sums the label out too (the exact marginal log p(v), the
    ground truth of :func:`labeled_dbn_log_likelihood_bound`). Layer widths
    and the top's code <= ~14 bits."""
    from scipy.special import logsumexp

    check_fixed_variance_layers(layers, "exact labeled-DBN likelihood enumeration")
    X = _f64(data)
    if labels is not None:
        labels = np.asarray(labels, int)
        if X.shape[0] != labels.shape[0]:
            raise ValueError(f"data rows {X.shape[0]} != labels {labels.shape[0]}")
        if labels.min() < 0 or labels.max() >= n_classes:
            raise ValueError(f"labels out of range for n_classes={n_classes}")
    if not layers:
        raise ValueError("needs >= 1 directed layer below the label top")
    n_code = layers[-1][0].W.shape[1]
    if label_top.W.shape[0] != n_code + n_classes:
        raise ValueError(f"label top has visible {label_top.W.shape[0]}, "
                         f"expected {n_code} + {n_classes}")
    if gen is None:
        gen = [(p.W, p.b) for p, _ in layers]
    elif len(gen) != len(layers):
        raise ValueError(f"gen has {len(gen)} layers, stack has {len(layers)}")
    G = _branch(layers, gen, X)                                           # [N, 2^code]
    neg_f = _labeled_neg_f(_f64(label_top.W), _f64(label_top.b), _f64(label_top.c),
                           _enum_states(n_code), n_code)                 # [Ns, C]
    return _labeled_ll(G, neg_f, labels)


def _labeled_ll(G, neg_f, labels) -> float:
    """Mean log p(v, y) (or log p(v) without labels) from the branch
    messages G [N, Ns] and -F_top over the one-hot-restricted support."""
    from scipy.special import logsumexp

    # the label block is a softmax group: Z sums -F over {0,1}^code x one-hot
    log_z_top = logsumexp(neg_f)
    if labels is None:
        ll = logsumexp(G[:, :, None] + neg_f[None, :, :], axis=(1, 2)) - log_z_top
    else:
        ll = logsumexp(G + neg_f[:, labels].T, axis=1) - log_z_top
    return float(np.mean(ll))


def _tower_branches(towers, modalities, gen, what: str):
    """Validate an MDBN's towers against its modalities; the names and each
    tower's branch message G_m [N, 2^(top width)]."""
    names = list(towers)
    if set(names) != set(modalities):
        raise ValueError(f"towers {sorted(names)} and modalities "
                         f"{sorted(modalities)} disagree")
    for tn in names:
        check_fixed_variance_layers(towers[tn], f"{what} (tower {tn!r})")
    if gen is not None and set(gen) != set(names):
        raise ValueError("gen must cover exactly the tower names")
    return names


def _tower_branch(layers_n, gens_n, name, X, n_rows):
    if len(gens_n) != len(layers_n):
        raise ValueError(f"gen for tower {name!r} has wrong depth")
    if n_rows is not None and X.shape[0] != n_rows:
        raise ValueError("modalities disagree on rows")
    return _branch(layers_n, gens_n, X)


def exact_mdbn_log_likelihood(towers, joint, modalities, gen=None) -> float:
    """Exact mean log-likelihood of a small MDBN by full enumeration: an
    undirected joint RBM over the concatenated tower top codes, directed
    sigmoid layers down each tower. Per tower, G_m[n, t] = log p(v_m_n | top_m
    = t); then over the concatenated top state s (<= ~14 bits in all):

        log p(v_n) = logsumexp_s [ sum_m G_m[n, s_m] - F_joint(s) ] - log Z_j.

    ``towers``: {name: [(RBMParams, RBMConfig)] bottom-up, all directed};
    ``joint``: (RBMParams, RBMConfig); ``modalities``: {name: [N, D_m]};
    ``gen``: optional untied generative weights {name: [(W, b)]}."""
    from scipy.special import logsumexp

    joint_params, joint_cfg = joint
    if joint_cfg.visible != "bernoulli":
        raise ValueError("the joint RBM is Bernoulli-visible by construction")
    names = _tower_branches(towers, modalities, gen, "exact MDBN likelihood enumeration")
    widths = [towers[n][-1][0].W.shape[1] for n in names]
    total = int(sum(widths))
    if total > 14:
        raise ValueError(f"exact MDBN enumeration needs the concatenated top "
                         f"code <= 14 bits (got {total})")
    G, n_rows = [], None
    for n in names:
        gens_n = gen[n] if gen is not None else [(p.W, p.b) for p, _ in towers[n]]
        X = _f64(modalities[n])
        G.append(_tower_branch(towers[n], gens_n, n, X, n_rows))
        n_rows = X.shape[0]
    # global enumeration over the concatenated top code
    s_all = _enum_states(total)                                           # [2^total, total]
    Wj, bj, cj = _f64(joint_params.W), _f64(joint_params.b), _f64(joint_params.c)
    neg_f = s_all @ bj + np.logaddexp(0.0, s_all @ Wj + cj[None, :]).sum(axis=1)
    idx = np.arange(2 ** total)
    branch_sum = np.zeros((n_rows, 2 ** total))
    offset = 0
    for Gm, w in zip(G, widths):
        branch_sum += Gm[:, (idx >> offset) & ((1 << w) - 1)]             # tower substate
        offset += w
    ll = logsumexp(branch_sum + neg_f[None, :], axis=1) - exact_log_z(joint_params)
    return float(np.mean(ll))


def exact_labeled_mdbn_log_likelihood(towers, joint, label_top, modalities, labels,
                                      n_classes: int, gen=None, joint_gen=None) -> float:
    """Exact mean joint log-likelihood log p(v, y) of a small labeled MDBN:
    every tower layer and the joint layer directed, ``label_top`` the
    undirected associative RBM over [joint code ; one-hot label]. Per tower
    the branch message G_m[n, t_m] folds against the directed joint layer's
    slice (p(t_m | u) factorises per concat bit),

        H_m[n, u] = logsumexp_{t_m} (G_m[n, t_m] + log p(t_m | u)),
        log p(v, y) = logsumexp_u [ sum_m H_m[n, u] - F_top([u ; e_y]) ]
                      - log Z_top,

    Z_top over the one-hot-restricted support. ``labels=None``: the exact
    marginal log p(v). Each tower's widths and the joint hidden width <= ~14
    bits. ``gen``: untied tower generative weights {name: [(W, b)]};
    ``joint_gen``: the untied joint generative (W, b)."""
    from scipy.special import logsumexp

    joint_params, joint_cfg = joint
    if joint_cfg.visible != "bernoulli":
        raise ValueError("the joint RBM is Bernoulli-visible by construction")
    names = _tower_branches(towers, modalities, gen, "exact MDBN likelihood enumeration")
    n_code = joint_params.W.shape[1]
    if n_code > 14:
        raise ValueError(f"exact enumeration needs joint hidden <= 14 (got {n_code})")
    if label_top.W.shape[0] != n_code + n_classes:
        raise ValueError(f"label top has visible {label_top.W.shape[0]}, "
                         f"expected joint code {n_code} + {n_classes}")
    Wjg, bjg = joint_gen if joint_gen is not None else (joint_params.W, joint_params.b)
    Wjg, bjg = _f64(Wjg), _f64(bjg)
    if labels is not None:
        labels = np.asarray(labels, int)
        if labels.min() < 0 or labels.max() >= n_classes:
            raise ValueError(f"labels out of range for n_classes={n_classes}")
    U = _enum_states(n_code)                                              # joint code states
    S_sum, n_rows, offset = None, None, 0
    for nm in names:
        gens_n = gen[nm] if gen is not None else [(p.W, p.b) for p, _ in towers[nm]]
        X = _f64(modalities[nm])
        G = _tower_branch(towers[nm], gens_n, nm, X, n_rows)              # [N, 2^w_m]
        n_rows = X.shape[0]
        w = towers[nm][-1][0].W.shape[1]
        cond_j = _bern_cond_logp(_enum_states(w), U, Wjg[offset:offset + w],
                                 bjg[offset:offset + w])                 # [2^w_m, 2^code]
        offset += w
        H = logsumexp(G[:, :, None] + cond_j[None, :, :], axis=1)
        S_sum = H if S_sum is None else S_sum + H                         # [N, 2^code]
    if offset != Wjg.shape[0]:
        raise ValueError(f"tower top widths sum to {offset}, joint visible is {Wjg.shape[0]}")
    neg_f = _labeled_neg_f(_f64(label_top.W), _f64(label_top.b), _f64(label_top.c), U,
                           n_code)                                        # [2^code, C]
    return _labeled_ll(S_sum, neg_f, labels)

"""Pure-NumPy CD-k/PCD RBM oracle: the host CPU's reference.

A copy of ``mdbn_tpu/oracle.py`` on the port's ``config.py``, so the port's
benchmark and parity scripts can measure and check against it without
importing JAX (importing anything under ``mdbn_tpu`` does). Same functions,
same classes, same random streams: on the same seeds and the same injected
uniforms it gives the reference's bits. It is the CPU reference by design,
NumPy on the host: it has no device and takes none.

It implements the canonical algorithm (Hinton 2002 / practical-guide
conventions, Theano-tutorial lineage):

- positive statistics use hidden *probabilities* ``h0p``; *samples* flow
  through the Gibbs chain; the negative phase's final hidden uses
  probabilities.
- CD restarts the chain at the data's hidden sample each minibatch; PCD
  carries a persistent hidden-sample chain across minibatches.
- gradient ascent with momentum + L2 decay on W only:
  ``vel = m*vel + lr*(grad - l2*W)``; ``param += vel``.

Every sampling decision can be driven by caller-injected uniforms (the
``uniforms`` argument), which is how the port's torch core and kernels are
held to it on the deterministic sub-computations.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .config import RBMConfig


def sigmoid(x: np.ndarray) -> np.ndarray:
    # numerically stable logistic
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _np_dtype(name: str) -> np.dtype:
    """The NumPy dtype of a config dtype name; bfloat16 is ml_dtypes' (the
    type the reference's NumPy gets from JAX), needed only for that name."""
    if name == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def init_params(cfg: RBMConfig, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    dtype = _np_dtype(cfg.param_dtype)
    if cfg.init == "uniform_glorot4":
        bound = 4.0 * (6.0 / (cfg.n_visible + cfg.n_hidden)) ** 0.5
        W = rng.uniform(-bound, bound, (cfg.n_visible, cfg.n_hidden)).astype(dtype)
    else:
        W = (rng.standard_normal((cfg.n_visible, cfg.n_hidden)) * cfg.init_scale).astype(dtype)
    b = np.zeros(cfg.n_visible, dtype)  # visible bias
    c = np.zeros(cfg.n_hidden, dtype)  # hidden bias
    p = {"W": W, "b": b, "c": c}
    if cfg.learn_variance:
        # Cho/Krizhevsky GRBM: z = log sigma^2 per visible unit, init sigma=1
        p["z"] = np.zeros(cfg.n_visible, dtype)
    return p


def zero_velocity(params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: np.zeros_like(v) for k, v in params.items()}


def _inv_s2(params) -> Optional[np.ndarray]:
    """[V] visible precision e^{-z}; None when sigma^2 = 1 (no learned z)."""
    return np.exp(-params["z"]) if "z" in params else None


def hidden_mean(params, v: np.ndarray) -> np.ndarray:
    s = _inv_s2(params)
    vin = v if s is None else v * s
    return sigmoid(vin @ params["W"] + params["c"])


def visible_mean(params, h: np.ndarray, visible: str) -> np.ndarray:
    pre = h @ params["W"].T + params["b"]
    return sigmoid(pre) if visible == "bernoulli" else pre


def free_energy(params, v: np.ndarray, visible: str) -> np.ndarray:
    """F(v); Bernoulli: -v.b - sum softplus(vW+c); Gaussian:
    0.5 sum (v-b)^2/sigma^2 - sum softplus((v/sigma^2)W+c) (sigma=1 unless
    the variance is learned)."""
    s = _inv_s2(params)
    vin = v if s is None else v * s
    pre = vin @ params["W"] + params["c"]
    softplus = np.logaddexp(0.0, pre).sum(axis=1)
    if visible == "bernoulli":
        return -(v @ params["b"]) - softplus
    diff = v - params["b"]
    quad = diff * diff if s is None else diff * diff * s
    return 0.5 * quad.sum(axis=1) - softplus


def recon_error(v0: np.ndarray, v1mean: np.ndarray, metric: str) -> float:
    if metric == "mse":
        d = v0 - v1mean
        return float(np.mean(d * d))
    eps = 1e-7
    p = np.clip(v1mean, eps, 1.0 - eps)
    return float(-np.mean(np.sum(v0 * np.log(p) + (1.0 - v0) * np.log(1.0 - p), axis=1)))


def draw_uniforms(cfg: RBMConfig, batch: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Draw every random number one CD-k step can consume, in a fixed order."""
    u = {
        "h0": rng.random((batch, cfg.n_hidden), dtype=np.float32),
        "v": rng.random((cfg.k, batch, cfg.n_visible), dtype=np.float32),
        "h": rng.random((cfg.k, batch, cfg.n_hidden), dtype=np.float32),
    }
    if cfg.visible == "gaussian" and cfg.resolved_sample_visible:
        u["noise"] = rng.standard_normal((cfg.k, batch, cfg.n_visible)).astype(np.float32)
    return u


def draw_pt_uniforms(cfg: RBMConfig, batch: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Uniforms for one parallel-tempering update — the NumPy mirror of
    ops.cd_step.draw_pt_uniforms' layout: the Gibbs draws gain a leading rung
    dim M (independent draws PER RUNG, never broadcast), plus [2, M-1, batch]
    swap uniforms for the even + odd Metropolis rounds."""
    M = cfg.pt_temps
    u = {
        "h0": rng.random((batch, cfg.n_hidden), dtype=np.float32),
        "v": rng.random((cfg.k, M, batch, cfg.n_visible), dtype=np.float32),
        "h": rng.random((cfg.k, M, batch, cfg.n_hidden), dtype=np.float32),
        "swap": rng.random((2, M - 1, batch), dtype=np.float32),
    }
    if cfg.visible == "gaussian" and cfg.resolved_sample_visible:
        u["noise"] = rng.standard_normal((cfg.k, M, batch, cfg.n_visible)).astype(np.float32)
    return u


def cd_step_stats(
    params: Dict[str, np.ndarray],
    v0: np.ndarray,
    chain_h: Optional[np.ndarray],
    uniforms: Dict[str, np.ndarray],
    cfg: RBMConfig,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, float, np.ndarray]:
    """One CD-k/PCD step's sufficient statistics (no parameter update).

    Returns (grads, new_chain_h, err, v1mean). ``grads`` is the log-likelihood
    ascent direction (positive minus negative phase, mean over the batch).
    ``chain_h`` is the persistent hidden sample for PCD; pass None for CD.
    """
    B = v0.shape[0]
    h0p = hidden_mean(params, v0)
    h0s = (uniforms["h0"] < h0p).astype(v0.dtype)

    h = chain_h if (cfg.persistent and chain_h is not None) else h0s
    v1mean = None
    vs = v0
    hmean = h0p
    for t in range(cfg.k):
        vmean = visible_mean(params, h, cfg.visible)
        if t == 0:
            v1mean = vmean
        if cfg.visible == "bernoulli":
            vs = (uniforms["v"][t] < vmean).astype(v0.dtype) if cfg.resolved_sample_visible else vmean
        elif cfg.resolved_sample_visible:
            noise = uniforms["noise"][t]
            if "z" in params:
                noise = noise * np.exp(0.5 * params["z"])  # N(mean, sigma^2)
            vs = vmean + noise
        else:
            vs = vmean
        hmean = hidden_mean(params, vs)
        hs = (uniforms["h"][t] < hmean).astype(v0.dtype)
        h = hs

    s = _inv_s2(params)
    vp = v0 if s is None else v0 * s
    vn = vs if s is None else vs * s
    grads = {
        "W": (vp.T @ h0p - vn.T @ hmean) / B,
        "b": (vp - vn).mean(axis=0),
        "c": (h0p - hmean).mean(axis=0),
    }
    if s is not None:
        # d log p / d z = e^{-z} (<A>_d - <A>_m), A = (v-b)^2/2 - v (W h)
        A_d = 0.5 * (v0 - params["b"]) ** 2 - v0 * (h0p @ params["W"].T)
        A_m = 0.5 * (vs - params["b"]) ** 2 - vs * (hmean @ params["W"].T)
        grads["z"] = s * (A_d - A_m).mean(axis=0)
        if not cfg.resolved_sample_visible:
            # Rao-Blackwellized mean-field correction: E[(v-b)^2] over the
            # conditional = (mean-b)^2 + sigma^2 (mirrors core.rbm_math)
            grads["z"] = grads["z"] - 0.5
    if cfg.gradient == "enhanced":
        mu = 0.5 * (v0.mean(axis=0) + vs.mean(axis=0))
        lam = 0.5 * (h0p.mean(axis=0) + hmean.mean(axis=0))
        grads = enhance_grads(grads, mu, lam)
    if cfg.sparsity_target is not None and cfg.sparsity_cost:
        grads["c"] = grads["c"] + cfg.sparsity_cost * (
            cfg.sparsity_target - h0p.mean(axis=0))
    # For PCD the 1-step reconstruction from the *data* is still the monitor
    # (the chain's vmean reflects fantasy particles, not the data):
    if cfg.persistent and chain_h is not None:
        v1mean_data = visible_mean(params, h0s, cfg.visible)
    else:
        v1mean_data = v1mean
    err = recon_error(v0, v1mean_data, cfg.error_metric)
    return grads, h, err, v1mean_data


def enhance_grads(grads: Dict[str, np.ndarray], mu: np.ndarray,
                  lam: np.ndarray) -> Dict[str, np.ndarray]:
    """Enhanced gradient (Cho, Raiko & Ilin, ICML 2011): mirrors
    core.rbm_math.enhance_grads exactly — see there for the derivation."""
    gW = grads["W"] - np.outer(mu, grads["c"]) - np.outer(grads["b"], lam)
    return {"W": gW, "b": grads["b"] - gW @ lam, "c": grads["c"] - gW.T @ mu}


def tempered_log_p_h(params, h: np.ndarray, beta, visible: str) -> np.ndarray:
    """log p*_beta(h), v marginalized exactly (mirrors core.rbm_math)."""
    beta = np.asarray(beta, np.float32)
    hc = h @ params["c"]
    pre = h @ params["W"].T + params["b"]
    if visible == "bernoulli":
        return beta * hc + np.logaddexp(0.0, beta[..., None] * pre).sum(-1)
    s = _inv_s2(params)
    wh = pre - params["b"]
    bw = params["b"] if s is None else params["b"] * s
    sq = wh * wh if s is None else wh * wh * s
    quad = wh @ bw + 0.5 * np.sum(sq, axis=-1)
    return beta * (hc + quad)


def pt_step_stats(
    params: Dict[str, np.ndarray],
    v0: np.ndarray,
    chains_h: np.ndarray,  # [M, B, n_hidden]
    uniforms: Dict[str, np.ndarray],
    cfg: RBMConfig,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, float]:
    """Parallel-tempering PCD update statistics (Desjardins et al. 2010):
    the NumPy mirror of core.rbm_math.pt_step_stats, same uniforms layout
    (ops.cd_step.draw_pt_uniforms). Collapsed tempered Gibbs per rung, then
    an even + an odd Metropolis replica-swap round; rung 0 (beta=1) feeds the
    negative phase."""
    B = v0.shape[0]
    M = cfg.pt_temps
    betas = np.linspace(1.0, cfg.pt_beta_min, M).astype(np.float32)
    bM = betas[:, None, None]
    h0p = hidden_mean(params, v0)
    h0s = (uniforms["h0"] < h0p).astype(v0.dtype)

    s = _inv_s2(params)
    sigma = None if s is None else np.exp(0.5 * params["z"])
    h = chains_h
    vs = hmean = None
    for t in range(cfg.k):
        pre_v = h @ params["W"].T + params["b"]
        if cfg.visible == "bernoulli":
            vmean = sigmoid(bM * pre_v)
            vs = (uniforms["v"][t] < vmean).astype(v0.dtype) if cfg.resolved_sample_visible else vmean
        else:
            vmean = pre_v
            if cfg.resolved_sample_visible:
                noise = uniforms["noise"][t] / np.sqrt(bM)
                vs = vmean + (noise if sigma is None else noise * sigma)
            else:
                vs = vmean
        vin = vs if s is None else vs * s
        hmean = sigmoid(bM * (vin @ params["W"] + params["c"]))
        h = (uniforms["h"][t] < hmean).astype(v0.dtype)

    for parity in (0, 1):
        lp_self = tempered_log_p_h(params, h, betas[:, None], cfg.visible)
        lp_up = tempered_log_p_h(params, h[1:], betas[:-1, None], cfg.visible)
        lp_dn = tempered_log_p_h(params, h[:-1], betas[1:, None], cfg.visible)
        log_a = lp_up + lp_dn - lp_self[:-1] - lp_self[1:]
        accept = np.log(np.maximum(uniforms["swap"][parity], 1e-38)) < log_a
        h = h.copy()
        for m in range(parity, M - 1, 2):
            a = accept[m][:, None]
            hm, hm1 = h[m].copy(), h[m + 1].copy()
            h[m] = np.where(a, hm1, hm)
            h[m + 1] = np.where(a, hm, hm1)

    vp = v0 if s is None else v0 * s
    vn = vs[0] if s is None else vs[0] * s
    grads = {
        "W": (vp.T @ h0p - vn.T @ hmean[0]) / B,
        "b": (vp - vn).mean(axis=0),
        "c": (h0p - hmean[0]).mean(axis=0),
    }
    if s is not None:
        A_d = 0.5 * (v0 - params["b"]) ** 2 - v0 * (h0p @ params["W"].T)
        A_m = (0.5 * (vs[0] - params["b"]) ** 2
               - vs[0] * (hmean[0] @ params["W"].T))
        grads["z"] = s * (A_d - A_m).mean(axis=0)
        if not cfg.resolved_sample_visible:
            grads["z"] = grads["z"] - 0.5  # mean-field correction, rung 0
    if cfg.gradient == "enhanced":
        mu = 0.5 * (v0.mean(axis=0) + vs[0].mean(axis=0))
        lam = 0.5 * (h0p.mean(axis=0) + hmean[0].mean(axis=0))
        grads = enhance_grads(grads, mu, lam)
    if cfg.sparsity_target is not None and cfg.sparsity_cost:
        grads["c"] = grads["c"] + cfg.sparsity_cost * (
            cfg.sparsity_target - h0p.mean(axis=0))
    v1mean_data = visible_mean(params, h0s, cfg.visible)
    metric = cfg.error_metric if cfg.error_metric in ("mse", "xent") else "mse"
    err = recon_error(v0, v1mean_data, metric)
    return grads, h, err


def resolve_momentum(cfg: RBMConfig, epoch: int) -> float:
    """Hinton-guide schedule: initial_momentum until momentum_switch_epoch."""
    if cfg.initial_momentum is not None and epoch < cfg.momentum_switch_epoch:
        return cfg.initial_momentum
    return cfg.momentum


def apply_update(
    params: Dict[str, np.ndarray],
    velocity: Dict[str, np.ndarray],
    grads: Dict[str, np.ndarray],
    cfg: RBMConfig,
    epoch: int = 0,
) -> None:
    """In-place momentum + L2 update (decay on W only): SURVEY.md §2.1.
    The learned-variance z (when present) uses lr_variance (default lr),
    no decay."""
    m = resolve_momentum(cfg, epoch)
    for name in params:
        g = grads[name]
        if cfg.grad_clip is not None:
            g = np.clip(g, -cfg.grad_clip, cfg.grad_clip)
        if name == "W" and cfg.l2:
            g = g - cfg.l2 * params["W"]
        lr = cfg.lr
        if name == "z" and cfg.lr_variance is not None:
            lr = cfg.lr_variance
        velocity[name] = m * velocity[name] + lr * g
        params[name] += velocity[name].astype(params[name].dtype)


def pseudo_likelihood(params, v: np.ndarray, bit_index: int, visible: str) -> float:
    """Theano-tutorial stochastic pseudo-likelihood proxy: flip one (rotating)
    bit per sample; cost = n_visible * mean log sigmoid(FE(v_flip) - FE(v)).
    Bernoulli-visible only. Higher is better; reported negated so all monitors
    decrease as the model improves."""
    fe = free_energy(params, v, visible)
    v_flip = v.copy()
    v_flip[:, bit_index] = 1.0 - v_flip[:, bit_index]
    fe_flip = free_energy(params, v_flip, visible)
    n = v.shape[1]
    # log sigmoid(x) = -softplus(-x)
    return float(-np.mean(n * -np.logaddexp(0.0, -(fe_flip - fe))))


class OracleRBM:
    """Reference-shaped API: ``train(data)`` / ``transform(v)`` (BASELINE.json:5)."""

    def __init__(self, cfg: RBMConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.params = init_params(cfg, self.rng)
        self.velocity = zero_velocity(self.params)
        self.chain_h: Optional[np.ndarray] = None
        self.history: list = []
        self._step_count = 0
        self._epoch = 0

    def train_step(self, v0: np.ndarray, uniforms: Optional[Dict[str, np.ndarray]] = None) -> float:
        if self.cfg.pt_temps > 1:
            # Parallel-tempering PCD: one persistent ladder [M, B, H] per
            # batch slot (zeros init, matching core.state.init_train_state),
            # updated by the tempered-Gibbs + replica-swap step.
            if uniforms is None:
                uniforms = draw_pt_uniforms(self.cfg, v0.shape[0], self.rng)
            if self.chain_h is None:
                self.chain_h = np.zeros(
                    (self.cfg.pt_temps, v0.shape[0], self.cfg.n_hidden), v0.dtype)
            grads, new_chain, err = pt_step_stats(
                self.params, v0, self.chain_h, uniforms, self.cfg)
        else:
            if uniforms is None:
                uniforms = draw_uniforms(self.cfg, v0.shape[0], self.rng)
            if self.cfg.persistent and self.chain_h is None:
                # Theano-tutorial convention, matching core.state.init_train_state:
                # the persistent chain starts at ZEROS, not at the first batch's
                # hidden sample
                self.chain_h = np.zeros((v0.shape[0], self.cfg.n_hidden), v0.dtype)
            grads, new_chain, err, _ = cd_step_stats(self.params, v0, self.chain_h, uniforms, self.cfg)
        if self.cfg.error_metric == "pseudo":
            err = pseudo_likelihood(self.params, v0,
                                    self._step_count % self.cfg.n_visible,
                                    self.cfg.visible)
        apply_update(self.params, self.velocity, grads, self.cfg, epoch=self._epoch)
        if self.cfg.persistent:
            self.chain_h = new_chain
        self._step_count += 1
        return err

    def train(self, data: np.ndarray) -> "OracleRBM":
        cfg = self.cfg
        n = (data.shape[0] // cfg.batch_size) * cfg.batch_size
        if n == 0:
            raise ValueError(f"dataset has {data.shape[0]} samples — fewer "
                             f"than one minibatch (batch_size={cfg.batch_size})")
        for _epoch in range(cfg.epochs):
            order = self.rng.permutation(data.shape[0])[:n] if cfg.shuffle else np.arange(n)
            errs = []
            for s in range(0, n, cfg.batch_size):
                errs.append(self.train_step(data[order[s : s + cfg.batch_size]]))
            self.history.append(float(np.mean(errs)))
            self._epoch += 1
        return self

    def transform(self, v: np.ndarray) -> np.ndarray:
        """Deterministic upward pass (probabilities, not samples): SURVEY.md §3.4."""
        return hidden_mean(self.params, v)

    def reconstruct(self, v: np.ndarray) -> np.ndarray:
        return visible_mean(self.params, self.transform(v), self.cfg.visible)


class OracleDBN:
    """Greedy layer-wise stack of OracleRBMs (SURVEY.md §3.2)."""

    def __init__(self, rbm_cfgs):
        self.layers = [OracleRBM(c) for c in rbm_cfgs]

    def train(self, data: np.ndarray) -> "OracleDBN":
        reps = data
        for rbm in self.layers:
            rbm.train(reps)
            reps = rbm.transform(reps)  # mean-field probabilities feed the next layer
        return self

    def transform(self, v: np.ndarray) -> np.ndarray:
        h = v
        for rbm in self.layers:
            h = rbm.transform(h)
        return h


def oracle_dbn_configs(dcfg, n_visible: int):
    """RBMConfig list for an OracleDBN mirroring DBN(dcfg) on width-n_visible
    data (shared by the parity harness / timing scripts)."""
    cfgs = []
    width = n_visible
    for l in range(len(dcfg.layer_sizes)):
        cfgs.append(dcfg.rbm_config(l, width))
        width = dcfg.layer_sizes[l]
    return cfgs


class OracleMDBN:
    """Per-modality OracleDBN towers + joint OracleRBM (SURVEY.md §3.3).

    ``tower_cfgs``: {modality: [RBMConfig, ...]}; ``joint_cfg.n_visible`` is
    replaced by the concatenated tower-code width at train time.
    """

    def __init__(self, tower_cfgs: Dict[str, list], joint_cfg: RBMConfig):
        self.towers = {m: OracleDBN(cfgs) for m, cfgs in tower_cfgs.items()}
        self._joint_cfg = joint_cfg
        self.joint: Optional[OracleRBM] = None

    def _tower_codes(self, modalities: Dict[str, np.ndarray]) -> np.ndarray:
        return np.concatenate(
            [self.towers[m].transform(modalities[m]) for m in self.towers], axis=1)

    def train(self, modalities: Dict[str, np.ndarray]) -> "OracleMDBN":
        for m, tower in self.towers.items():
            tower.train(modalities[m])
        codes = self._tower_codes(modalities)
        import dataclasses

        self.joint = OracleRBM(dataclasses.replace(
            self._joint_cfg, n_visible=codes.shape[1], visible="bernoulli"))
        self.joint.train(codes)
        return self

    def transform(self, modalities: Dict[str, np.ndarray]) -> np.ndarray:
        assert self.joint is not None, "train first"
        return self.joint.transform(self._tower_codes(modalities))

"""Deterministic PyTorch core of the RBM: conditionals, energy, CD-k statistics.

Port of ``mdbn_tpu/core/rbm_math.py`` at the same ``[V, H]`` weight layout.
All sampling randomness enters through the explicit ``uniforms`` dict (the
layout of ``ops.cd_step.draw_uniforms``, or ``draw_pt_uniforms`` for a
tempering ladder), so every function here is pure and
can be held against the JAX package and ``mdbn_tpu/oracle.py`` by feeding
both the same uniforms.

Matmul precision (``_dot``): ``compute_dtype="float32"`` with
``matmul_precision`` "auto"/"highest" is a true fp32 product (TF32 off);
"fast" allows TF32 on the GPU; ``compute_dtype="bfloat16"`` rounds both
operands to bf16 and accumulates in fp32 (the product of two bf16 values is
exact in fp32).

Tensor parallelism (``parallel/tp.py``): a rank may hold only some of the
hidden units (its columns of W, its entries of c). The few sums over hidden
units then take the optional handle ``tp`` and call ``_tp_sum``, which
all-reduces a partial sum over the tensor-parallel group; without a handle
every function computes exactly what it did before.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import RBMConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("float32" / "bfloat16")."""
    return _DTYPES[name]


@dataclass
class RBMParams:
    """Parameters (or velocities, or gradients) of one RBM.

    ``W`` [n_visible, n_hidden], ``b`` [n_visible], ``c`` [n_hidden], and
    ``z`` [n_visible] = log sigma^2 of Gaussian visible units, present only
    when ``cfg.learn_variance``.
    """

    W: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    z: Optional[torch.Tensor] = None

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "RBMParams":
        return RBMParams(*(None if t is None else fn(t)
                           for t in (self.W, self.b, self.c, self.z)))

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


def check_fixed_variance_layers(layers, what: str) -> None:
    """Phase-2 algorithms that unroll raw (W, b, c) weights reject
    learned-variance layers rather than silently dropping the sigma^2
    scaling from the recognition pass. ``layers``: iterable of (RBMParams,
    RBMConfig)."""
    for p, cfg in layers:
        if p.z is not None or cfg.learn_variance:
            raise ValueError(
                f"{what} does not support learn_variance layers (its "
                "unrolled weight stack would silently drop the learned "
                "sigma^2 scaling); pretrain this stack with "
                "learn_variance=False to use it")


def init_params(cfg: RBMConfig, generator: torch.Generator,
                device: torch.device | str = "cpu") -> RBMParams:
    """W from ``generator`` (a CPU generator, so the init does not depend on
    the device); biases and z start at zero."""
    dtype = torch_dtype(cfg.param_dtype)
    shape = (cfg.n_visible, cfg.n_hidden)
    if cfg.init == "uniform_glorot4":
        # Theano-tutorial lineage: U(+-4*sqrt(6/(nv+nh)))
        bound = 4.0 * (6.0 / (cfg.n_visible + cfg.n_hidden)) ** 0.5
        W = (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound
    else:
        W = cfg.init_scale * torch.randn(shape, generator=generator)
    W = W.to(device=device, dtype=dtype)
    z = (torch.zeros(cfg.n_visible, dtype=dtype, device=device)
         if cfg.learn_variance else None)
    return RBMParams(W=W, b=torch.zeros(cfg.n_visible, dtype=dtype, device=device),
                     c=torch.zeros(cfg.n_hidden, dtype=dtype, device=device), z=z)


def zero_velocity(params: RBMParams) -> RBMParams:
    return params.map(torch.zeros_like)


def inv_sigma2(params: RBMParams) -> Optional[torch.Tensor]:
    """[V] precision of the Gaussian visible units (None = sigma^2 = 1)."""
    return None if params.z is None else torch.exp(-params.z.float())


def noise_scale(params: RBMParams) -> Optional[torch.Tensor]:
    """[V] std-dev sigma of the Gaussian visible units (None = 1), in fp32
    whatever the storage dtype of z."""
    return None if params.z is None else torch.exp(0.5 * params.z.float())


def _tp_sum(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` (a partial sum over this rank's hidden units) summed over the
    tensor-parallel group of the handle ``tp`` (``parallel.tp.TPGroup``);
    ``x`` itself when there is no handle."""
    return x if tp is None else tp.sum(x)


def _dot(a: torch.Tensor, w: torch.Tensor, compute_dtype: str,
         matmul_precision: str = "auto") -> torch.Tensor:
    """``a @ w`` with fp32 accumulation and an fp32 result (see module doc)."""
    if compute_dtype == "bfloat16":
        a, w = a.to(torch.bfloat16), w.to(torch.bfloat16)
        tf32 = False  # bf16 operands are exact in fp32; keep the product exact
    else:
        tf32 = matmul_precision == "fast"
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return a.float() @ w.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def hidden_mean(params: RBMParams, v: torch.Tensor, cfg: RBMConfig) -> torch.Tensor:
    s = inv_sigma2(params)
    vin = v if s is None else v * s
    return torch.sigmoid(_dot(vin, params.W, cfg.compute_dtype, cfg.matmul_precision)
                         + params.c)


def visible_mean(params: RBMParams, h: torch.Tensor, cfg: RBMConfig, tp=None) -> torch.Tensor:
    # learned variance leaves the mean untouched: v|h ~ N(b + h W^T, sigma^2)
    pre = _tp_sum(_dot(h, params.W.T, cfg.compute_dtype, cfg.matmul_precision), tp) + params.b
    return torch.sigmoid(pre) if cfg.visible == "bernoulli" else pre


def free_energy(params: RBMParams, v: torch.Tensor, cfg: RBMConfig, tp=None) -> torch.Tensor:
    s = inv_sigma2(params)
    vin = v if s is None else v * s
    pre = _dot(vin, params.W, cfg.compute_dtype, cfg.matmul_precision) + params.c
    softplus = _tp_sum(F.softplus(pre).sum(dim=1), tp)
    if cfg.visible == "bernoulli":
        return -_dot(v, params.b[:, None], cfg.compute_dtype,
                     cfg.matmul_precision)[:, 0] - softplus
    diff = v - params.b
    quad = diff * diff if s is None else diff * diff * s
    return 0.5 * quad.sum(dim=1) - softplus


def recon_error(v0: torch.Tensor, v1mean: torch.Tensor, metric: str,
                row_mask: Optional[torch.Tensor] = None,
                norm: Optional[float] = None) -> torch.Tensor:
    """Reconstruction-error monitor: "mse" (mean over all entries) or "xent"
    (per-row summed cross-entropy, averaged over rows). With ``row_mask``
    ([B, 1] of 0/1) and ``norm`` (the row count to average over), pad rows
    are left out: under uneven data parallelism the per-rank masked sums
    scaled by 1/norm average over the ranks to the global-batch mean."""
    masked = row_mask is not None or norm is not None
    n = float(norm if norm is not None else v0.shape[0])
    if metric == "mse":
        d = v0 - v1mean
        if row_mask is not None:
            d = d * row_mask
        return torch.sum(d * d) / (n * v0.shape[1]) if masked else torch.mean(d * d)
    eps = 1e-7
    p = torch.clamp(v1mean, eps, 1.0 - eps)
    xe = v0 * torch.log(p) + (1.0 - v0) * torch.log(1.0 - p)
    if row_mask is not None:
        xe = xe * row_mask
    if masked:
        return -torch.sum(xe) / n
    return -torch.mean(torch.sum(xe, dim=1))


def cd_step_stats(
    params: RBMParams,
    v0: torch.Tensor,
    chain_h: Optional[torch.Tensor],
    uniforms: Dict[str, torch.Tensor],
    cfg: RBMConfig,
    factor_dtype: Optional[torch.dtype] = None,
    row_mask: Optional[torch.Tensor] = None,
    norm: Optional[float] = None,
    split: bool = False,
    tp=None,
):
    """One CD-k/PCD step's statistics. Returns (grads, new_chain_h, err).

    ``grads`` is the log-likelihood ascent direction (positive minus
    negative phase, batch mean). ``chain_h`` is the persistent hidden sample
    for PCD (None for CD). Mirrors ``mdbn_tpu.core.rbm_math.cd_step_stats``
    including the enhanced-gradient and learned-variance branches; a
    tempering ladder (``cfg.pt_temps > 1``) goes through ``pt_step_stats``.
    ``factor_dtype``: the negative-phase visibles round through this dtype
    before they enter the hidden units and the gradient, as in the W-blocked
    kernel, which keeps its factors at the storage dtype; the monitor sees
    the unrounded mean. ``row_mask`` ([B, 1] of 0/1) and ``norm``: pad rows
    are zeroed out of every statistic and sums divide by ``norm`` instead of
    B (uneven data parallelism: ``parallel.dp``). ``split``: return
    (grads, enhanced sums, new_chain_h, err) with the statistics in the form
    a data-parallel exchange sums (``split_grads``). ``tp``: the
    tensor-parallel handle (module doc), under which ``params`` and the
    chain hold this rank's hidden units.
    """
    dtype = v0.dtype
    h0p = hidden_mean(params, v0, cfg)
    h0s = (uniforms["h0"] < h0p).to(dtype)

    h = chain_h if (cfg.persistent and chain_h is not None) else h0s
    vs = v0
    hmean = h0p
    v1mean = None
    for t in range(cfg.k):
        vmean = visible_mean(params, h, cfg, tp)
        if t == 0:
            v1mean = vmean
        if cfg.visible == "bernoulli":
            vs = ((uniforms["v"][t] < vmean).to(dtype)
                  if cfg.resolved_sample_visible else vmean)
        elif cfg.resolved_sample_visible:
            noise = uniforms["noise"][t]
            if params.z is not None:
                noise = noise * noise_scale(params)  # N(mean, sigma^2)
            vs = vmean + noise
        else:
            vs = vmean
        if factor_dtype is not None:
            vs = vs.to(factor_dtype).to(vmean.dtype)
        hmean = hidden_mean(params, vs, cfg)
        h = (uniforms["h"][t] < hmean).to(dtype)

    # PCD: the monitor reconstructs the DATA chain (one step from h0s)
    if cfg.persistent and chain_h is not None:
        v1mean_data = visible_mean(params, h0s, cfg, tp)
    else:
        v1mean_data = v1mean
    err = _monitor(v0, v1mean_data, cfg, row_mask, norm)
    if split:
        return (*split_grads(params, v0, h0p, vs, hmean, cfg, row_mask, norm, tp), h, err)
    return _grads(params, v0, h0p, vs, hmean, cfg, row_mask, norm, tp), h, err


def _monitor(v0: torch.Tensor, v1mean: torch.Tensor, cfg: RBMConfig,
             row_mask: Optional[torch.Tensor] = None,
             norm: Optional[float] = None) -> torch.Tensor:
    metric = cfg.error_metric if cfg.error_metric in ("mse", "xent") else "mse"
    return recon_error(v0, v1mean, metric, row_mask, norm)


def _grads(params: RBMParams, v0: torch.Tensor, h0p: torch.Tensor, vs: torch.Tensor,
           hmean: torch.Tensor, cfg: RBMConfig, row_mask: Optional[torch.Tensor] = None,
           norm: Optional[float] = None, tp=None) -> RBMParams:
    """The update direction from one step's positive phase (v0, h0p) and
    negative phase (vs, hmean): plain, learned-variance and enhanced
    statistics plus the sparsity term, in the JAX core's order. Masking the
    v side of each outer product zeroes a pad row's contribution to W. A
    masked mean-field learned-variance step takes its 1/2 times the share of
    real rows, as the JAX core does."""
    grads, sums = split_grads(params, v0, h0p, vs, hmean, cfg, row_mask, norm, tp)
    share = 1.0
    if row_mask is not None:
        share = torch.sum(row_mask) / float(norm if norm is not None else v0.shape[0])
    return finish_grads(params, grads, sums, cfg, share, tp)


@dataclass
class EnhancedSums:
    """The batch means the enhanced gradient recombines around, as masked
    sums over ``norm`` (so a mean over data-parallel ranks is the
    global-batch mean): ``mu`` [V] and ``lam`` [H], the averaged data and
    model means of v and h, and ``h0`` [H], the data-phase mean of h (the
    sparsity term's)."""

    mu: torch.Tensor
    lam: torch.Tensor
    h0: torch.Tensor


def split_grads(params: RBMParams, v0: torch.Tensor, h0p: torch.Tensor, vs: torch.Tensor,
                hmean: torch.Tensor, cfg: RBMConfig, row_mask: Optional[torch.Tensor] = None,
                norm: Optional[float] = None, tp=None
                ) -> Tuple[RBMParams, Optional[EnhancedSums]]:
    """The statistics of ``_grads`` in the form a data-parallel exchange can
    sum, since each is linear in the rows: the plain gW, gb (precision-scaled
    under learned variance) and gc, with the sparsity term unless the
    gradient is enhanced; under learned variance z holds the raw statistic
    sum_r m_r (A_data - A_model) / norm; under the enhanced gradient the
    ``EnhancedSums``. ``finish_grads`` on the mean over the ranks gives the
    global-batch gradient. The order of the TPU's DP mega-kernel
    (mdbn_tpu/ops/cd_epoch_pallas.py:1535-1596)."""
    inv_b = 1.0 / float(norm if norm is not None else v0.shape[0])
    masked = (lambda x: x) if row_mask is None else (lambda x: x * row_mask)
    v_pos, v_neg, h_pos, h_neg = masked(v0), masked(vs), masked(h0p), masked(hmean)
    s = inv_sigma2(params)
    vp = v_pos if s is None else v_pos * s
    vn = v_neg if s is None else v_neg * s
    gW = (_dot(vp.T, h0p, cfg.compute_dtype, cfg.matmul_precision)
          - _dot(vn.T, hmean, cfg.compute_dtype, cfg.matmul_precision)) * inv_b
    gb = torch.sum(vp - vn, dim=0) * inv_b
    gc = torch.sum(h_pos - h_neg, dim=0) * inv_b
    h0 = torch.sum(h_pos, dim=0) * inv_b
    gz = None
    if s is not None:
        wh_d = _tp_sum(_dot(h0p, params.W.T, cfg.compute_dtype, cfg.matmul_precision), tp)
        wh_m = _tp_sum(_dot(hmean, params.W.T, cfg.compute_dtype, cfg.matmul_precision), tp)
        A_d = 0.5 * (v0 - params.b) ** 2 - v0 * wh_d
        A_m = 0.5 * (vs - params.b) ** 2 - vs * wh_m
        gz = torch.sum(masked(A_d - A_m), dim=0) * inv_b
    if cfg.gradient == "enhanced":
        mu = 0.5 * (torch.sum(v_pos, dim=0) + torch.sum(v_neg, dim=0)) * inv_b
        lam = 0.5 * (torch.sum(h_pos, dim=0) + torch.sum(h_neg, dim=0)) * inv_b
        return RBMParams(W=gW, b=gb, c=gc, z=gz), EnhancedSums(mu, lam, h0)
    if cfg.sparsity_target is not None and cfg.sparsity_cost:
        gc = gc + cfg.sparsity_cost * (cfg.sparsity_target - h0)
    return RBMParams(W=gW, b=gb, c=gc, z=gz), None


def finish_grads(params: RBMParams, grads: RBMParams, sums: Optional[EnhancedSums],
                 cfg: RBMConfig, share=1.0, tp=None) -> RBMParams:
    """The update direction from ``split_grads``' statistics averaged over
    the ranks: the z statistic times the precision (minus 1/2 under a
    mean-field negative phase: E[(v-b)^2] adds sigma^2; ``share`` of it on
    a masked shard of its own), and the enhanced recombination of the plain
    statistics followed by the sparsity term."""
    gW, gb, gc, gz = grads.W, grads.b, grads.c, grads.z
    if gz is not None:
        gz = inv_sigma2(params) * gz
        if not cfg.resolved_sample_visible:
            gz = gz - 0.5 * share
    if sums is not None:
        gW, gb, gc = enhance_grads(gW, gb, gc, sums.mu, sums.lam, cfg, tp)
        if cfg.sparsity_target is not None and cfg.sparsity_cost:
            gc = gc + cfg.sparsity_cost * (cfg.sparsity_target - sums.h0)
    return RBMParams(W=gW, b=gb, c=gc, z=gz)


def enhance_grads(gW, gb, gc, mu, lam, cfg: Optional[RBMConfig] = None, tp=None):
    """The enhanced gradient of Cho, Raiko & Ilin (ICML 2011, eqs. 12-14):
    ``gW_e = gW - outer(mu, gc) - outer(gb, lam)``, ``gb_e = gb - gW_e @ lam``,
    ``gc_e = gc - gW_e^T @ mu``, with mu/lam the averaged data+model batch
    means of v/h. The matvecs follow ``cfg``'s compute/precision policy;
    under ``tp`` the sum over hidden units of ``gW_e @ lam`` is all-reduced."""
    gW = gW - torch.outer(mu, gc) - torch.outer(gb, lam)
    if cfg is None:
        return gW, gb - _tp_sum(gW @ lam, tp), gc - gW.T @ mu
    return (gW,
            gb - _tp_sum(_dot(gW, lam[:, None], cfg.compute_dtype,
                              cfg.matmul_precision)[:, 0], tp),
            gc - _dot(gW.T, mu[:, None], cfg.compute_dtype, cfg.matmul_precision)[:, 0])


def pt_betas(cfg: RBMConfig, device: torch.device | str = "cpu") -> torch.Tensor:
    """The tempering ladder: inverse temperatures linspace(1, pt_beta_min, M)
    in float32. Rung 0 is beta = 1 exactly (the model), so its statistics
    stay unbiased."""
    return torch.linspace(1.0, cfg.pt_beta_min, cfg.pt_temps,
                          dtype=torch.float64).to(device=device, dtype=torch.float32)


def tempered_log_p_h(params: RBMParams, h: torch.Tensor, beta,
                     cfg: RBMConfig, tp=None) -> torch.Tensor:
    """log p*_beta(h), the visible marginal of p_beta(v, h) ∝ exp(-beta E)
    up to an h-independent constant. Bernoulli: beta c.h + sum softplus(beta
    (b + W h)); Gaussian: beta (c.h + sum_i (b_i (Wh)_i + (Wh)_i^2 / 2) /
    sigma_i^2). ``h`` [..., H]; ``beta`` broadcasts against the leading dims."""
    beta = torch.as_tensor(beta, dtype=torch.float32, device=h.device)
    hc = _tp_sum(_dot(h, params.c[:, None], cfg.compute_dtype, cfg.matmul_precision)[..., 0],
                 tp)
    pre = _tp_sum(_dot(h, params.W.T, cfg.compute_dtype, cfg.matmul_precision), tp) + params.b
    if cfg.visible == "bernoulli":
        return beta * hc + F.softplus(beta[..., None] * pre).sum(-1)
    s = inv_sigma2(params)
    wh = pre - params.b
    bw = params.b if s is None else params.b * s
    sq = wh * wh if s is None else wh * wh * s
    quad = (_dot(wh, bw[:, None], cfg.compute_dtype, cfg.matmul_precision)[..., 0]
            + 0.5 * torch.sum(sq, dim=-1))
    return beta * (hc + quad)


def pt_log_accept(params: RBMParams, h: torch.Tensor, betas: torch.Tensor,
                  cfg: RBMConfig, tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log Metropolis ratio of swapping rungs m and m+1, per row: [M-1, B],
    and the sum of the magnitudes of its four terms (the scale of its fp32
    rounding)."""
    lp_self = tempered_log_p_h(params, h, betas[:, None], cfg, tp)       # [M, B]
    lp_up = tempered_log_p_h(params, h[1:], betas[:-1, None], cfg, tp)   # h_{m+1} at beta_m
    lp_dn = tempered_log_p_h(params, h[:-1], betas[1:, None], cfg, tp)   # h_m at beta_{m+1}
    log_a = lp_up + lp_dn - lp_self[:-1] - lp_self[1:]
    scale = lp_up.abs() + lp_dn.abs() + lp_self[:-1].abs() + lp_self[1:].abs()
    return log_a, scale


def _pt_swap_round(params: RBMParams, h: torch.Tensor, betas: torch.Tensor,
                   u_swap: torch.Tensor, parity: int, cfg: RBMConfig,
                   tp=None) -> torch.Tensor:
    """One Metropolis replica-swap round over the adjacent rung pairs (m,
    m+1) with m % 2 == parity, per row: accept when log u < log_a."""
    log_a, _ = pt_log_accept(params, h, betas, cfg, tp)
    accept = torch.log(torch.clamp(u_swap, min=1e-38)) < log_a
    rungs = list(h)
    for m in range(parity, h.shape[0] - 1, 2):
        a = accept[m][:, None]
        hm, hm1 = rungs[m], rungs[m + 1]
        rungs[m] = torch.where(a, hm1, hm)
        rungs[m + 1] = torch.where(a, hm, hm1)
    return torch.stack(rungs)


def pt_visible_mean(params: RBMParams, h: torch.Tensor, bM: torch.Tensor,
                    cfg: RBMConfig, tp=None) -> torch.Tensor:
    """Tempered v|h per rung: sigmoid(beta pre) (Bernoulli) or pre
    (Gaussian, whose variance widens to sigma^2 / beta instead)."""
    pre_v = (_tp_sum(_dot(h, params.W.T, cfg.compute_dtype, cfg.matmul_precision), tp)
             + params.b)
    return torch.sigmoid(bM * pre_v) if cfg.visible == "bernoulli" else pre_v


def pt_visible_sample(params: RBMParams, vmean: torch.Tensor, uniforms, t: int,
                      bM: torch.Tensor, cfg: RBMConfig) -> torch.Tensor:
    if cfg.visible == "bernoulli":
        return ((uniforms["v"][t] < vmean).to(vmean.dtype)
                if cfg.resolved_sample_visible else vmean)
    if not cfg.resolved_sample_visible:
        return vmean
    noise = uniforms["noise"][t] / torch.sqrt(bM)
    return vmean + (noise if params.z is None else noise * noise_scale(params))


def pt_hidden_mean(params: RBMParams, vs: torch.Tensor, bM: torch.Tensor,
                   cfg: RBMConfig) -> torch.Tensor:
    s = inv_sigma2(params)
    vin = vs if s is None else vs * s
    return torch.sigmoid(bM * (_dot(vin, params.W, cfg.compute_dtype,
                                    cfg.matmul_precision) + params.c))


def pt_step_stats(
    params: RBMParams,
    v0: torch.Tensor,
    chains_h: torch.Tensor,
    uniforms: Dict[str, torch.Tensor],
    cfg: RBMConfig,
    row_mask: Optional[torch.Tensor] = None,
    norm: Optional[float] = None,
    split: bool = False,
    tp=None,
):
    """One PT-PCD update's statistics (Desjardins et al. 2010); mirrors
    ``mdbn_tpu.core.rbm_math.pt_step_stats``. ``chains_h`` [M, B, H] (rung 0
    at beta = 1); ``uniforms`` in the ``draw_pt_uniforms`` layout. Every rung
    takes k tempered Gibbs sweeps, then an even and an odd swap round couple
    the ladder; the statistics come from rung 0 before the swaps and the
    monitor reconstructs the data chain. Returns (grads, new_chains, err).
    ``row_mask`` and ``norm`` as in ``cd_step_stats``: each batch row owns
    its whole ladder, so a pad row's ladder evolves but enters no statistic.
    ``split`` and ``tp`` as in ``cd_step_stats``."""
    dtype = v0.dtype
    betas = pt_betas(cfg, v0.device)
    bM = betas[:, None, None]
    h0p = hidden_mean(params, v0, cfg)
    h0s = (uniforms["h0"] < h0p).to(dtype)
    h, vs, hmean = chains_h, None, None
    for t in range(cfg.k):
        vs = pt_visible_sample(params, pt_visible_mean(params, h, bM, cfg, tp), uniforms, t,
                               bM, cfg)
        hmean = pt_hidden_mean(params, vs, bM, cfg)
        h = (uniforms["h"][t] < hmean).to(dtype)
    h = _pt_swap_round(params, h, betas, uniforms["swap"][0], 0, cfg, tp)
    h = _pt_swap_round(params, h, betas, uniforms["swap"][1], 1, cfg, tp)
    err = _monitor(v0, visible_mean(params, h0s, cfg, tp), cfg, row_mask, norm)
    if split:
        return (*split_grads(params, v0, h0p, vs[0], hmean[0], cfg, row_mask, norm, tp), h,
                err)
    return _grads(params, v0, h0p, vs[0], hmean[0], cfg, row_mask, norm, tp), h, err


def pseudo_likelihood(params: RBMParams, v: torch.Tensor, bit_index: int,
                      cfg: RBMConfig, row_mask: Optional[torch.Tensor] = None,
                      norm: Optional[float] = None, tp=None) -> torch.Tensor:
    """Theano-tutorial stochastic pseudo-likelihood proxy (Bernoulli visible):
    flip one (rotating) bit per sample; ``n_visible * mean log sigmoid(FE(flip)
    - FE(v))``, negated so the monitor decreases as the model improves.
    ``row_mask`` and ``norm`` as in ``recon_error``: a masked sum over
    ``norm`` rows, which a mean over data-parallel ranks makes the
    global-batch monitor. ``tp`` as in ``free_energy``."""
    fe = free_energy(params, v, cfg, tp)
    flip_col = F.one_hot(torch.tensor(bit_index, device=v.device),
                         v.shape[1]).to(v.dtype)
    v_flip = v * (1 - flip_col) + (1 - v) * flip_col
    fe_flip = free_energy(params, v_flip, cfg, tp)
    terms = v.shape[1] * -F.softplus(-(fe_flip - fe))
    if row_mask is None and norm is None:
        return -torch.mean(terms)
    if row_mask is not None:
        terms = terms * row_mask[:, 0]
    return -torch.sum(terms) / float(norm if norm is not None else v.shape[0])


def resolve_momentum(cfg: RBMConfig, epoch: int) -> float:
    """Hinton-guide schedule: ``initial_momentum`` until
    ``momentum_switch_epoch``, then ``momentum``."""
    if cfg.initial_momentum is None:
        return float(cfg.momentum)
    return float(cfg.initial_momentum if epoch < cfg.momentum_switch_epoch
                 else cfg.momentum)


def apply_update(params: RBMParams, velocity: RBMParams, grads: RBMParams,
                 cfg: RBMConfig, epoch: int = 0) -> Tuple[RBMParams, RBMParams]:
    """``vel = m*vel + lr*(grad - l2*W)`` (decay on W only); ``param += vel``.

    Gradients are clipped first when ``cfg.grad_clip`` is set. z follows the
    same momentum rule at ``cfg.lr_variance`` (default ``cfg.lr``) with no
    decay. Update arithmetic is fp32; velocities and parameters round once
    into their storage dtype. Returns new tensors; the inputs are unchanged.
    """
    if cfg.grad_clip is not None:
        clip = cfg.grad_clip
        grads = grads.map(lambda g: torch.clamp(g, -clip, clip))
    gW = grads.W - cfg.l2 * params.W.float() if cfg.l2 else grads.W
    m = resolve_momentum(cfg, epoch)

    def vel(v: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
        return (m * v.float() + lr * g).to(v.dtype)

    vz = pz = None
    if grads.z is not None:
        vz = vel(velocity.z, grads.z, cfg.lr if cfg.lr_variance is None else cfg.lr_variance)
        pz = params.z + vz.to(params.z.dtype)
    new_vel = RBMParams(W=vel(velocity.W, gW, cfg.lr), b=vel(velocity.b, grads.b, cfg.lr),
                        c=vel(velocity.c, grads.c, cfg.lr), z=vz)
    new_params = RBMParams(W=params.W + new_vel.W.to(params.W.dtype),
                           b=params.b + new_vel.b.to(params.b.dtype),
                           c=params.c + new_vel.c.to(params.c.dtype), z=pz)
    return new_params, new_vel

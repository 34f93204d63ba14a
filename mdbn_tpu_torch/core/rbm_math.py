"""Deterministic PyTorch core of the RBM: conditionals, energy, CD-k statistics.

Port of ``mdbn_tpu/core/rbm_math.py`` at the same ``[V, H]`` weight layout.
All sampling randomness enters through the explicit ``uniforms`` dict (the
layout of ``ops.cd_step.draw_uniforms``), so every function here is pure and
can be held against the JAX package and ``mdbn_tpu/oracle.py`` by feeding
both the same uniforms.

Matmul precision (``_dot``): ``compute_dtype="float32"`` with
``matmul_precision`` "auto"/"highest" is a true fp32 product (TF32 off);
"fast" allows TF32 on the GPU; ``compute_dtype="bfloat16"`` rounds both
operands to bf16 and accumulates in fp32 (the product of two bf16 values is
exact in fp32).
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


def visible_mean(params: RBMParams, h: torch.Tensor, cfg: RBMConfig) -> torch.Tensor:
    # learned variance leaves the mean untouched: v|h ~ N(b + h W^T, sigma^2)
    pre = _dot(h, params.W.T, cfg.compute_dtype, cfg.matmul_precision) + params.b
    return torch.sigmoid(pre) if cfg.visible == "bernoulli" else pre


def free_energy(params: RBMParams, v: torch.Tensor, cfg: RBMConfig) -> torch.Tensor:
    s = inv_sigma2(params)
    vin = v if s is None else v * s
    pre = _dot(vin, params.W, cfg.compute_dtype, cfg.matmul_precision) + params.c
    softplus = F.softplus(pre).sum(dim=1)
    if cfg.visible == "bernoulli":
        return -_dot(v, params.b[:, None], cfg.compute_dtype,
                     cfg.matmul_precision)[:, 0] - softplus
    diff = v - params.b
    quad = diff * diff if s is None else diff * diff * s
    return 0.5 * quad.sum(dim=1) - softplus


def recon_error(v0: torch.Tensor, v1mean: torch.Tensor, metric: str) -> torch.Tensor:
    """Reconstruction-error monitor: "mse" (mean over all entries) or "xent"
    (per-row summed cross-entropy, averaged over rows)."""
    if metric == "mse":
        d = v0 - v1mean
        return torch.mean(d * d)
    eps = 1e-7
    p = torch.clamp(v1mean, eps, 1.0 - eps)
    xe = v0 * torch.log(p) + (1.0 - v0) * torch.log(1.0 - p)
    return -torch.mean(torch.sum(xe, dim=1))


def cd_step_stats(
    params: RBMParams,
    v0: torch.Tensor,
    chain_h: Optional[torch.Tensor],
    uniforms: Dict[str, torch.Tensor],
    cfg: RBMConfig,
) -> Tuple[RBMParams, torch.Tensor, torch.Tensor]:
    """One CD-k/PCD step's statistics. Returns (grads, new_chain_h, err).

    ``grads`` is the log-likelihood ascent direction (positive minus
    negative phase, batch mean). ``chain_h`` is the persistent hidden sample
    for PCD (None for CD). Mirrors ``mdbn_tpu.core.rbm_math.cd_step_stats``
    including the enhanced-gradient and learned-variance branches.
    """
    if cfg.pt_temps > 1:
        raise ValueError("pt_temps > 1 (parallel tempering) is not ported yet "
                         "(ROADMAP.md Queue 1, PT in the core)")
    dtype = v0.dtype
    h0p = hidden_mean(params, v0, cfg)
    h0s = (uniforms["h0"] < h0p).to(dtype)

    h = chain_h if (cfg.persistent and chain_h is not None) else h0s
    vs = v0
    hmean = h0p
    v1mean = None
    for t in range(cfg.k):
        vmean = visible_mean(params, h, cfg)
        if t == 0:
            v1mean = vmean
        if cfg.visible == "bernoulli":
            vs = ((uniforms["v"][t] < vmean).to(dtype)
                  if cfg.resolved_sample_visible else vmean)
        elif cfg.resolved_sample_visible:
            noise = uniforms["noise"][t]
            if params.z is not None:
                noise = noise * torch.exp(0.5 * params.z)  # N(mean, sigma^2)
            vs = vmean + noise
        else:
            vs = vmean
        hmean = hidden_mean(params, vs, cfg)
        h = (uniforms["h"][t] < hmean).to(dtype)

    inv_b = 1.0 / v0.shape[0]
    s = inv_sigma2(params)
    # learned variance: W/b statistics see precision-scaled visibles
    vp = v0 if s is None else v0 * s
    vn = vs if s is None else vs * s
    gW = (_dot(vp.T, h0p, cfg.compute_dtype, cfg.matmul_precision)
          - _dot(vn.T, hmean, cfg.compute_dtype, cfg.matmul_precision)) * inv_b
    gb = torch.sum(vp - vn, dim=0) * inv_b
    gc = torch.sum(h0p - hmean, dim=0) * inv_b
    gz = None
    if s is not None:
        # d log p / d z_i = e^{-z_i} (<A_i>_data - <A_i>_model),
        # A_i(v, h) = (v_i - b_i)^2 / 2 - v_i (W h)_i
        wh_d = _dot(h0p, params.W.T, cfg.compute_dtype, cfg.matmul_precision)
        wh_m = _dot(hmean, params.W.T, cfg.compute_dtype, cfg.matmul_precision)
        A_d = 0.5 * (v0 - params.b) ** 2 - v0 * wh_d
        A_m = 0.5 * (vs - params.b) ** 2 - vs * wh_m
        gz = s * torch.sum(A_d - A_m, dim=0) * inv_b
        if not cfg.resolved_sample_visible:
            # mean-field negative phase: Rao-Blackwellize the conditional's
            # own variance term E[(v-b)^2] = (mean-b)^2 + sigma^2
            gz = gz - 0.5
    if cfg.gradient == "enhanced":
        mu = 0.5 * (torch.sum(v0, dim=0) + torch.sum(vs, dim=0)) * inv_b
        lam = 0.5 * (torch.sum(h0p, dim=0) + torch.sum(hmean, dim=0)) * inv_b
        gW, gb, gc = enhance_grads(gW, gb, gc, mu, lam, cfg)
    if cfg.sparsity_target is not None and cfg.sparsity_cost:
        gc = gc + cfg.sparsity_cost * (
            cfg.sparsity_target - torch.sum(h0p, dim=0) * inv_b)
    grads = RBMParams(W=gW, b=gb, c=gc, z=gz)
    # PCD: the monitor reconstructs the DATA chain (one step from h0s)
    if cfg.persistent and chain_h is not None:
        v1mean_data = visible_mean(params, h0s, cfg)
    else:
        v1mean_data = v1mean
    metric = cfg.error_metric if cfg.error_metric in ("mse", "xent") else "mse"
    err = recon_error(v0, v1mean_data, metric)
    return grads, h, err


def enhance_grads(gW, gb, gc, mu, lam, cfg: Optional[RBMConfig] = None):
    """The enhanced gradient of Cho, Raiko & Ilin (ICML 2011, eqs. 12-14):
    ``gW_e = gW - outer(mu, gc) - outer(gb, lam)``, ``gb_e = gb - gW_e @ lam``,
    ``gc_e = gc - gW_e^T @ mu``, with mu/lam the averaged data+model batch
    means of v/h. The matvecs follow ``cfg``'s compute/precision policy."""
    gW = gW - torch.outer(mu, gc) - torch.outer(gb, lam)
    if cfg is None:
        return gW, gb - gW @ lam, gc - gW.T @ mu
    return (gW,
            gb - _dot(gW, lam[:, None], cfg.compute_dtype, cfg.matmul_precision)[:, 0],
            gc - _dot(gW.T, mu[:, None], cfg.compute_dtype, cfg.matmul_precision)[:, 0])


def pseudo_likelihood(params: RBMParams, v: torch.Tensor, bit_index: int,
                      cfg: RBMConfig) -> torch.Tensor:
    """Theano-tutorial stochastic pseudo-likelihood proxy (Bernoulli visible):
    flip one (rotating) bit per sample; ``n_visible * mean log sigmoid(FE(flip)
    - FE(v))``, negated so the monitor decreases as the model improves."""
    fe = free_energy(params, v, cfg)
    flip_col = F.one_hot(torch.tensor(bit_index, device=v.device),
                         v.shape[1]).to(v.dtype)
    v_flip = v * (1 - flip_col) + (1 - v) * flip_col
    fe_flip = free_energy(params, v_flip, cfg)
    return -torch.mean(v.shape[1] * -F.softplus(-(fe_flip - fe)))


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

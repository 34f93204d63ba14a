"""Generative sampling from trained models: Gibbs chains and the down-pass.

Port of ``mdbn_tpu/ops/sample.py``:

- ``gibbs_sample``: an n-step Gibbs chain in a trained RBM;
- ``gibbs_sample_clamped``: Gibbs with a block of visible units clamped
  (missing-modality inference on the MDBN's joint RBM), averaging the
  per-step mean-field values of several chains after a burn-in;
- ``down_pass`` and ``generate_from_stack``: Gibbs in the top RBM, then a
  deterministic mean-field down-pass through the directed layers below.

The reference runs each chain as a ``lax.scan`` with no Pallas kernel, so
these are plain PyTorch loops. Every chain runs in float32 whatever the
storage dtype, as in the reference. Each function takes ``draws``: the
uniforms (or, for Gaussian visibles, the standard normals) of every step,
``{"h": [n_steps, rows, H], "v": [n_steps, rows, V]}`` (and ``"init"``
[n_samples, V] for ``generate_from_stack``'s starting state), so a test can
feed the JAX functions' own draws; without ``draws`` they come from
``generator`` (default: seeded 0 on the parameters' device).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, hidden_mean, noise_scale, visible_mean

Draws = Dict[str, torch.Tensor]


def _generator(params: RBMParams, generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=params.W.device).manual_seed(0)


def _step_draws(draws: Optional[Draws], t: int, cfg: RBMConfig, rows: int,
                gen: Optional[torch.Generator], device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``t``'s h uniforms [rows, H] and v uniforms or normals [rows, V]."""
    if draws is not None:
        return (draws["h"][t].to(device=device, dtype=torch.float32),
                draws["v"][t].to(device=device, dtype=torch.float32))
    uh = torch.rand((rows, cfg.n_hidden), generator=gen, device=device)
    shape = (rows, cfg.n_visible)
    uv = (torch.rand(shape, generator=gen, device=device) if cfg.visible == "bernoulli"
          else torch.randn(shape, generator=gen, device=device))
    return uh, uv


def _gibbs_step(params: RBMParams, v: torch.Tensor, cfg: RBMConfig, uh: torch.Tensor,
                uv: torch.Tensor, sigma: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h ~ P(h | v), then (v sample, v mean) of P(v | h)."""
    h = (uh < hidden_mean(params, v, cfg)).float()
    vmean = visible_mean(params, h, cfg)
    if cfg.visible == "bernoulli":
        return (uv < vmean).float(), vmean
    return vmean + (uv if sigma is None else uv * sigma), vmean


@torch.no_grad()
def gibbs_sample(params: RBMParams, v_init: torch.Tensor, cfg: RBMConfig, n_steps: int,
                 generator: Optional[torch.Generator] = None, draws: Optional[Draws] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An n-step Gibbs chain from ``v_init`` [B, V]. Returns (v_mean,
    v_sample) at the final step: the mean-field probabilities (for display)
    and the sampled state (for chaining)."""
    device = params.W.device
    gen = None if draws is not None else _generator(params, generator)
    v = torch.as_tensor(v_init).to(device=device, dtype=torch.float32)
    vmean = v
    sigma = noise_scale(params)
    for t in range(n_steps):
        uh, uv = _step_draws(draws, t, cfg, v.shape[0], gen, device)
        v, vmean = _gibbs_step(params, v, cfg, uh, uv, sigma)
    return vmean, v


@torch.no_grad()
def gibbs_sample_clamped(params: RBMParams, v_init: torch.Tensor, clamp_mask: torch.Tensor,
                         cfg: RBMConfig, n_steps: int, n_burnin: int = 0, n_chains: int = 1,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Draws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamped Gibbs with the visible units where ``clamp_mask`` [V] is 1
    fixed to ``v_init`` [B, V]: the free units are sampled from P(v_free |
    v_clamped) by alternating h ~ P(h|v) and v ~ P(v|h) and writing the
    clamped block back each step, in ``n_chains`` chains a row (rows
    chain-major: [n_chains * B]). Returns ``(v_post_mean, v_sample)``: the
    per-step mean-field values averaged over the steps from ``n_burnin`` on
    and over the chains (the Monte-Carlo posterior mean, with the clamped
    block as given), and the final sampled state of the first chain."""
    if not 0 <= n_burnin < n_steps:
        raise ValueError(f"need 0 <= n_burnin < n_steps, got {n_burnin}/{n_steps}")
    device = params.W.device
    gen = None if draws is not None else _generator(params, generator)
    v_init = torch.as_tensor(v_init).to(device=device, dtype=torch.float32)
    mask = torch.as_tensor(clamp_mask).to(device=device, dtype=torch.float32)
    B = v_init.shape[0]
    v0 = v_init.repeat(n_chains, 1)  # [C*B, V]
    v, acc = v0, torch.zeros_like(v0)
    sigma = noise_scale(params)
    for t in range(n_steps):
        uh, uv = _step_draws(draws, t, cfg, v0.shape[0], gen, device)
        vs, vmean = _gibbs_step(params, v, cfg, uh, uv, sigma)
        v = mask * v0 + (1.0 - mask) * vs
        if t >= n_burnin:
            acc = acc + vmean
    post = (acc / (n_steps - n_burnin)).reshape(n_chains, B, -1).mean(0)
    return mask * v_init + (1.0 - mask) * post, v[:B]


@torch.no_grad()
def down_pass(layers: Sequence[Tuple[RBMParams, RBMConfig]], h: torch.Tensor) -> torch.Tensor:
    """Mean-field top-down pass through ``layers`` given deepest first."""
    x = h
    for p, cfg in layers:
        x = visible_mean(p, x, cfg)
    return x


@torch.no_grad()
def generate_from_stack(layers: Sequence[Tuple[RBMParams, RBMConfig]], n_samples: int,
                        n_gibbs: int = 200, generator: Optional[torch.Generator] = None,
                        draws: Optional[Draws] = None) -> torch.Tensor:
    """Sample from a DBN: Gibbs in the top RBM from a uniform binary start,
    mean-field down-pass below. ``layers`` is bottom-up [(params, cfg), ...].
    Returns visible-space mean-field samples [n_samples, n_visible_bottom]."""
    top_params, top_cfg = layers[-1]
    device = top_params.W.device
    gen = None if draws is not None else _generator(top_params, generator)
    u0 = (draws["init"].to(device=device, dtype=torch.float32) if draws is not None
          else torch.rand((n_samples, top_cfg.n_visible), generator=gen, device=device))
    top_mean, _ = gibbs_sample(top_params, (u0 < 0.5).float(), top_cfg, n_gibbs,
                               generator=gen, draws=draws)
    return down_pass(list(reversed(layers[:-1])), top_mean)

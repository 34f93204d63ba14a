"""Random draws of one CD-k step, and one full eager weight update.

Port of ``mdbn_tpu/ops/cd_step.py``. ``draw_uniforms`` returns every random
draw one CD-k step consumes, in the layout of the JAX package and the
oracle, so the deterministic core (``core.rbm_math.cd_step_stats``) is
shared and exactly testable.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, apply_update, cd_step_stats, pt_step_stats


def draw_uniforms(cfg: RBMConfig, batch: int, generator: torch.Generator,
                  device: Optional[torch.device | str] = None) -> Dict[str, torch.Tensor]:
    """{"h0": [B, H], "v": [k, B, V], "h": [k, B, H]} uniforms, plus
    "noise" [k, B, V] standard normals for sampled Gaussian visibles.
    ``device`` defaults to the generator's device."""
    device = generator.device if device is None else device
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    u = {"h0": torch.rand((batch, cfg.n_hidden), **kw),
         "v": torch.rand((cfg.k, batch, cfg.n_visible), **kw),
         "h": torch.rand((cfg.k, batch, cfg.n_hidden), **kw)}
    if cfg.visible == "gaussian" and cfg.resolved_sample_visible:
        u["noise"] = torch.randn((cfg.k, batch, cfg.n_visible), **kw)
    return u


def draw_pt_uniforms(cfg: RBMConfig, batch: int, generator: torch.Generator,
                     device: Optional[torch.device | str] = None) -> Dict[str, torch.Tensor]:
    """The draws of one parallel-tempering update (``core.rbm_math.pt_step_stats``):
    {"h0": [B, H], "v": [k, M, B, V], "h": [k, M, B, H], "swap": [2, M-1, B]}
    (even, then odd round), plus "noise" [k, M, B, V] for sampled Gaussian
    visibles."""
    M = cfg.pt_temps
    device = generator.device if device is None else device
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    u = {"h0": torch.rand((batch, cfg.n_hidden), **kw),
         "v": torch.rand((cfg.k, M, batch, cfg.n_visible), **kw),
         "h": torch.rand((cfg.k, M, batch, cfg.n_hidden), **kw),
         "swap": torch.rand((2, M - 1, batch), **kw)}
    if cfg.visible == "gaussian" and cfg.resolved_sample_visible:
        u["noise"] = torch.randn((cfg.k, M, batch, cfg.n_visible), **kw)
    return u


def step_stats(cfg: RBMConfig, params: RBMParams, v0: torch.Tensor,
               chain_h: Optional[torch.Tensor], uniforms: Dict[str, torch.Tensor]
               ) -> Tuple[RBMParams, torch.Tensor, torch.Tensor]:
    """(grads, new_chain_h, err) of one update: ``cd_step_stats``, or
    ``pt_step_stats`` on the [M*B, H] ladder (``draw_pt_uniforms`` draws)
    under tempering."""
    if cfg.pt_temps > 1:
        M, B = cfg.pt_temps, v0.shape[0]
        grads, chains, err = pt_step_stats(params, v0, chain_h.reshape(M, B, -1),
                                           uniforms, cfg)
        return grads, chains.reshape(M * B, -1), err
    return cd_step_stats(params, v0, chain_h if cfg.persistent else None, uniforms, cfg)


def cd_train_step(
    params: RBMParams,
    velocity: RBMParams,
    chain_h: Optional[torch.Tensor],
    v0: torch.Tensor,
    generator: torch.Generator,
    cfg: RBMConfig,
    epoch: int = 0,
) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """One full CD-k/PCD (or PT-PCD) weight update: stats -> momentum + L2
    update. Returns (params, velocity, chain_h, err)."""
    draw = draw_pt_uniforms if cfg.pt_temps > 1 else draw_uniforms
    grads, new_chain, err = step_stats(cfg, params, v0, chain_h,
                                       draw(cfg, v0.shape[0], generator, v0.device))
    new_params, new_velocity = apply_update(params, velocity, grads, cfg, epoch=epoch)
    return new_params, new_velocity, new_chain, err

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
from ..core.rbm_math import RBMParams, apply_update, cd_step_stats


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


def cd_train_step(
    params: RBMParams,
    velocity: RBMParams,
    chain_h: Optional[torch.Tensor],
    v0: torch.Tensor,
    generator: torch.Generator,
    cfg: RBMConfig,
    epoch: int = 0,
) -> Tuple[RBMParams, RBMParams, torch.Tensor, torch.Tensor]:
    """One full CD-k/PCD weight update: stats -> momentum + L2 update.
    Returns (params, velocity, chain_h, err)."""
    grads, new_chain, err = cd_step_stats(
        params, v0, chain_h, draw_uniforms(cfg, v0.shape[0], generator, v0.device), cfg)
    new_params, new_velocity = apply_update(params, velocity, grads, cfg, epoch=epoch)
    return new_params, new_velocity, new_chain, err

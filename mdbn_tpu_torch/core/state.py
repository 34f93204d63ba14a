"""Training state: the checkpointable unit of one RBM.

Port of ``mdbn_tpu/core/state.py``: params + momentum velocities + PCD chain
+ random state + epoch counter. The JAX key becomes a CPU
``torch.Generator`` held by the state; every random draw of a training run
(batch order, the kernel's Philox seed, the eager engine's uniforms) comes
from it, so a restored state continues the same stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import RBMConfig
from .rbm_math import RBMParams, init_params, torch_dtype, zero_velocity


@dataclass
class TrainState:
    params: RBMParams
    velocity: RBMParams
    # [batch, n_hidden] persistent hidden samples (PCD), zeros if CD; a
    # tempering ladder keeps pt_temps chains stacked rung-major:
    # [pt_temps * batch, n_hidden], rung m = rows [m * batch, (m + 1) * batch)
    chain_h: torch.Tensor
    generator: torch.Generator  # CPU generator for this RBM's training
    epoch: int

    @property
    def device(self) -> torch.device:
        return self.params.W.device


def chain_rows(cfg: RBMConfig) -> int:
    """Rows of the persistent chain: batch_size, times pt_temps under tempering."""
    return cfg.batch_size * max(cfg.pt_temps, 1)


def default_device() -> torch.device:
    """The device a model lives on when the caller names none: the CUDA
    card. Raises when there is none; the CPU is used only when asked for."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; mdbn_tpu_torch runs on the card "
                           "unless asked for the CPU: pass device=\"cpu\" (or "
                           "--device cpu to the CLI)")
    return torch.device("cuda")


def init_train_state(cfg: RBMConfig, generator: Optional[torch.Generator] = None,
                     device: Optional[torch.device | str] = None) -> TrainState:
    """Fresh state: W drawn from ``generator`` (default: seeded with
    ``cfg.seed``), zero biases, velocities and chain, epoch 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    device = torch.device(device) if device is not None else default_device()
    params = init_params(cfg, generator, device)
    # Theano-tutorial convention: the persistent chain starts at zeros
    chain_h = torch.zeros((chain_rows(cfg), cfg.n_hidden),
                          dtype=torch_dtype(cfg.param_dtype), device=device)
    return TrainState(params=params, velocity=zero_velocity(params),
                      chain_h=chain_h, generator=generator, epoch=0)

"""Deterministic forward passes (feature extraction / reconstruction).

Port of ``mdbn_tpu/ops/transform.py``: ``transform`` is a mean-field upward
pass (probabilities, never samples). The JAX package has no kernel here, so
these are plain PyTorch matmuls. The DBN and MDBN ``reconstruct`` methods'
encode -> decode is ``train/autoencoder.py``'s (tied, or through a fine-tuned
decoder).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, hidden_mean, visible_mean


@torch.no_grad()
def transform(params: RBMParams, v: torch.Tensor, cfg: RBMConfig) -> torch.Tensor:
    return hidden_mean(params, v, cfg)


@torch.no_grad()
def reconstruct(params: RBMParams, v: torch.Tensor, cfg: RBMConfig) -> torch.Tensor:
    return visible_mean(params, hidden_mean(params, v, cfg), cfg)


def stack_hidden(params_list: Sequence[RBMParams], cfgs: Sequence[RBMConfig],
                 x: torch.Tensor) -> torch.Tensor:
    """Mean-field upward pass through a stack of RBMs."""
    h = x
    for p, cfg in zip(params_list, cfgs):
        h = hidden_mean(p, h, cfg)
    return h


@torch.no_grad()
def stack_transform(layers: Sequence[Tuple[RBMParams, RBMConfig]],
                    v: torch.Tensor) -> torch.Tensor:
    """Forward through a DBN stack: ``layers`` is [(params, cfg), ...]."""
    return stack_hidden([p for p, _ in layers], [cfg for _, cfg in layers], v)

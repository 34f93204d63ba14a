"""Deterministic forward passes (feature extraction / reconstruction).

Port of ``mdbn_tpu/ops/transform.py``: ``transform`` is a mean-field upward
pass (probabilities, never samples). The JAX package has no kernel here, so
these are plain PyTorch matmuls. ``reconstruct_stack`` / ``reconstruct_mdbn`` are the tied
encode -> decode of the DBN and MDBN ``reconstruct`` methods.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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


def _encode(layers: Sequence[Tuple[RBMParams, RBMConfig]], x: torch.Tensor) -> torch.Tensor:
    """sigmoid(h W + c) up the stack, in float32 (the autoencoder's encoder:
    a Gaussian layer's learned variance does not enter)."""
    h = x.float()
    for p, _ in layers:
        h = torch.sigmoid(h @ p.W.float() + p.c.float())
    return h


def _decode_pre(layers: Sequence[Tuple[RBMParams, RBMConfig]], h: torch.Tensor) -> torch.Tensor:
    """The tied top-down decode, h W^T + b with sigmoids between layers;
    returns the bottom layer's pre-activation."""
    for p, _ in reversed(layers[1:]):
        h = torch.sigmoid(h @ p.W.float().T + p.b.float())
    p = layers[0][0]
    return h @ p.W.float().T + p.b.float()


def _bottom(layers: Sequence[Tuple[RBMParams, RBMConfig]], pre: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(pre) if layers[0][1].visible == "bernoulli" else pre


@torch.no_grad()
def reconstruct_stack(layers: Sequence[Tuple[RBMParams, RBMConfig]],
                      v: torch.Tensor) -> torch.Tensor:
    """Deterministic encode -> decode through a DBN stack with the tied W^T
    down-pass (port of ``mdbn_tpu/train/autoencoder.py::reconstruct_stack``
    with no fine-tuned decoder)."""
    return _bottom(layers, _decode_pre(layers, _encode(layers, v)))


@torch.no_grad()
def reconstruct_mdbn(towers: Dict[str, List[Tuple[RBMParams, RBMConfig]]],
                     joint: Tuple[RBMParams, RBMConfig],
                     modalities: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Deterministic multimodal encode -> decode with tied weights: each
    tower's code, the joint layer up and back down, each modality's slice of
    it down its tower (``reconstruct_mdbn`` of the JAX package with no
    fine-tuned decoder)."""
    jp = joint[0]
    codes = torch.cat([_encode(towers[m], modalities[m]) for m in towers], dim=1)
    top = torch.sigmoid(codes @ jp.W.float() + jp.c.float())
    back = torch.sigmoid(top @ jp.W.float().T + jp.b.float())
    out, lo = {}, 0
    for m, layers in towers.items():
        width = layers[-1][1].n_hidden
        out[m] = _bottom(layers, _decode_pre(layers, back[:, lo:lo + width]))
        lo += width
    return out

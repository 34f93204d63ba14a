"""Carry weights between mdbn_tpu (JAX) and mdbn_tpu_torch, as numpy arrays.

Nothing here imports JAX: the JAX side hands over what its own API already
returns as numpy — ``RBM.params_numpy()`` ({"W", "b", "c"[, "z"]}) and the
``checkpoint._state_to_pytree`` dict ({"params", "velocity", "chain_h",
"key", "epoch"}) — and config objects of either package (converted by their
``__type__`` name, through the JSON form both packages share). The reverse
functions give numpy for the JAX side.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import _from_jsonable, _to_jsonable
from .core.rbm_math import RBMParams, torch_dtype, zero_velocity
from .core.state import TrainState, chain_rows, default_device
from .models.dbn import DBN
from .models.mdbn import MDBN
from .models.rbm import RBM


def convert_config(cfg):
    """A config of either package -> the port's config class of that name."""
    return _from_jsonable(_to_jsonable(cfg))


def config_to_dict(cfg) -> dict:
    """The ``__type__``-tagged JSON form (load it in the JAX package with its
    ``config._from_jsonable``)."""
    return _to_jsonable(cfg)


def _tensor(array, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """numpy has no bfloat16: bf16 state travels as float32 arrays that hold
    bf16 values (``np.asarray(x, np.float32)`` of a JAX bf16 array), which
    round into torch.bfloat16 unchanged."""
    return torch.tensor(np.asarray(array, np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(arrays: Dict[str, np.ndarray], dtype: torch.dtype = torch.float32,
                      device=None) -> RBMParams:
    device = torch.device(device) if device is not None else default_device()
    return RBMParams(**{k: _tensor(v, dtype, device) for k, v in arrays.items()
                        if v is not None})


def params_to_numpy(params: RBMParams) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in params.as_dict().items()}


def state_from_numpy(tree: dict, seed: int = 0, dtype: torch.dtype = torch.float32,
                     device=None) -> TrainState:
    """A ``_state_to_pytree``-shaped dict -> TrainState. A JAX key has no
    torch counterpart, so the new state's generator is seeded with ``seed``."""
    device = torch.device(device) if device is not None else default_device()
    return TrainState(
        params=params_from_numpy(tree["params"], dtype, device),
        velocity=params_from_numpy(tree["velocity"], dtype, device),
        chain_h=_tensor(tree["chain_h"], dtype, device),
        generator=torch.Generator().manual_seed(seed),
        epoch=int(np.asarray(tree["epoch"])),
    )


def state_to_numpy(state: TrainState) -> dict:
    """TrainState -> {"params", "velocity", "chain_h", "epoch"} of numpy."""
    return {"params": params_to_numpy(state.params),
            "velocity": params_to_numpy(state.velocity),
            "chain_h": state.chain_h.detach().float().cpu().numpy(),
            "epoch": np.int32(state.epoch)}


def rbm_from_numpy(cfg, arrays: Dict[str, np.ndarray], seed: Optional[int] = None,
                   device=None) -> RBM:
    """A trained port RBM with the given parameters (zero velocity and chain)."""
    cfg = convert_config(cfg)
    device = torch.device(device) if device is not None else default_device()
    params = params_from_numpy(arrays, torch_dtype(cfg.param_dtype), device)
    state = TrainState(params=params, velocity=zero_velocity(params),
                       chain_h=torch.zeros((chain_rows(cfg), cfg.n_hidden),
                                           dtype=params.W.dtype, device=device),
                       generator=torch.Generator().manual_seed(
                           cfg.seed if seed is None else seed),
                       epoch=0)
    return RBM(cfg, state=state, device=device)


def dbn_from_numpy(cfg, layers: Sequence[Tuple[Dict[str, np.ndarray], object]],
                   device=None) -> DBN:
    """``layers``: [(params_numpy, layer RBMConfig), ...] bottom-up."""
    dbn = DBN(convert_config(cfg), device=device)
    dbn.layers = [rbm_from_numpy(c, p, device=dbn.device) for p, c in layers]
    return dbn


def mdbn_from_numpy(cfg, towers: Dict[str, Sequence[Tuple[Dict[str, np.ndarray], object]]],
                    joint: Tuple[Dict[str, np.ndarray], object], device=None) -> MDBN:
    """``towers``: {modality: [(params_numpy, layer cfg), ...]}; ``joint``:
    (params_numpy, joint RBMConfig)."""
    cfg = convert_config(cfg)
    mdbn = MDBN(cfg, device=device)
    for name in cfg.towers:
        mdbn.towers[name] = dbn_from_numpy(cfg.towers[name], towers[name], mdbn.device)
    mdbn.joint = rbm_from_numpy(joint[1], joint[0], device=mdbn.device)
    return mdbn


def stack_to_numpy(model) -> List[Tuple[Dict[str, np.ndarray], dict]]:
    """A port DBN's layers as [(params_numpy, config dict)] for the JAX side."""
    return [(r.params_numpy(), config_to_dict(r.cfg)) for r in model.layers]

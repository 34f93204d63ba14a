"""Carry weights between mdbn_tpu (JAX) and mdbn_tpu_torch, as numpy arrays.

Nothing here imports JAX: the JAX side hands over what its own API already
returns as numpy — ``RBM.params_numpy()`` ({"W", "b", "c"[, "z"]}) and the
``checkpoint._state_to_pytree`` dict ({"params", "velocity", "chain_h",
"key", "epoch"}) — and config objects of either package (converted by their
``__type__`` name, through the JSON form both packages share). The reverse
functions give numpy for the JAX side. A DBN's or MDBN's fine-tuned state
(the classifier's head, the autoencoder's decoder, up-down's generative
weights, the label top) crosses the same way (``finetuned_to_numpy``,
``set_finetuned_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import _from_jsonable, _to_jsonable
from .core.rbm_math import RBMParams, torch_dtype, zero_velocity
from .core.state import TrainState, chain_rows, default_device
from .models.dbn import DBN
from .models.dbn import _np as _arr
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


# -- the phase-2 state: head, decoder, generative weights, label top ----------------


def _pairs_to_numpy(pairs):
    return [(_arr(W), _arr(b)) for W, b in pairs]


def finetuned_to_numpy(model) -> dict:
    """A port DBN's or MDBN's fine-tuned state as numpy, the keys present
    where the model has the piece: "head" (Wh, bh); "decoder" (a DBN's list,
    an MDBN's {tower: [D...], "__joint__": [Dj]}); "gen" (a DBN's [(W, b)],
    an MDBN's {tower: [(W, b)]}); "label_top" ({"W", "b", "c"}, n_classes);
    "joint_gen" (W, b) (an MDBN after labeled up-down)."""
    out = {}
    if model._head is not None:
        out["head"] = tuple(_arr(t) for t in model._head)
    if model._decoder is not None:
        dec = model._decoder
        out["decoder"] = ({m: [_arr(D) for D in Ds] for m, Ds in dec.items()}
                          if isinstance(dec, dict) else [_arr(D) for D in dec])
    if model._label_top is not None:
        p, n_classes = model._label_top
        out["label_top"] = ({"W": _arr(p.W), "b": _arr(p.b), "c": _arr(p.c)}, int(n_classes))
    if isinstance(model, MDBN):
        gens = {m: t._gen for m, t in model.towers.items() if t._gen is not None}
        if gens:
            out["gen"] = {m: _pairs_to_numpy(g) for m, g in gens.items()}
        if model._joint_gen is not None:
            out["joint_gen"] = tuple(_arr(t) for t in model._joint_gen)
    elif model._gen is not None:
        out["gen"] = _pairs_to_numpy(model._gen)
    return out


def set_finetuned_from_numpy(model, state: dict):
    """Sets a port DBN's or MDBN's fine-tuned state from numpy, in
    ``finetuned_to_numpy``'s layout (the label top's parameters may be any
    object with W, b and c, such as the JAX package's ``RBMParams``).
    Returns the model."""
    def t(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=model.device)

    def pairs(ps):
        return [(t(W), t(b)) for W, b in ps]

    if "head" in state:
        model._head = tuple(t(a) for a in state["head"])
    if "decoder" in state:
        dec = state["decoder"]
        model._decoder = ({m: [t(D) for D in Ds] for m, Ds in dec.items()}
                          if isinstance(dec, dict) else [t(D) for D in dec])
    if "label_top" in state:
        p, n_classes = state["label_top"]
        W, b, c = (p[k] if isinstance(p, dict) else getattr(p, k) for k in "Wbc")
        model._label_top = (RBMParams(W=t(W), b=t(b), c=t(c)), int(n_classes))
    if "gen" in state:
        if isinstance(model, MDBN):
            for m, g in state["gen"].items():
                model.towers[m]._gen = pairs(g)
        else:
            model._gen = pairs(state["gen"])
    if "joint_gen" in state:
        model._joint_gen = tuple(t(a) for a in state["joint_gen"])
    return model

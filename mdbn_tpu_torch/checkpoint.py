"""Checkpoint / resume with ``torch.save`` of plain tensors.

Port of ``mdbn_tpu/checkpoint.py`` (which uses orbax). The checkpointable
unit is the full ``TrainState`` — params, velocities, PCD chain, the
generator's state and the epoch counter — so a resumed run continues the same
trajectory. DBN/MDBN checkpoints store one state per completed layer
(``LayerCheckpointer``); a restored layer is rebuilt through the ``RBM``
constructor, so it counts as trained.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import torch

from .config import RBMConfig, load_config, save_config
from .core.rbm_math import RBMParams
from .core.state import TrainState, default_device


def state_to_dict(state: TrainState) -> dict:
    """Plain tensors and ints only (loadable with ``weights_only=True``).
    Absent optional leaves (z when the variance is not learned) are dropped."""
    return {
        "params": {k: v.detach().cpu() for k, v in state.params.as_dict().items()},
        "velocity": {k: v.detach().cpu() for k, v in state.velocity.as_dict().items()},
        "chain_h": state.chain_h.detach().cpu(),
        "generator": state.generator.get_state(),
        "epoch": int(state.epoch),
    }


def state_from_dict(tree: dict, device: Optional[torch.device | str] = None) -> TrainState:
    device = torch.device(device) if device is not None else default_device()
    gen = torch.Generator()
    gen.set_state(tree["generator"])
    return TrainState(
        params=RBMParams(**{k: v.to(device) for k, v in tree["params"].items()}),
        velocity=RBMParams(**{k: v.to(device) for k, v in tree["velocity"].items()}),
        chain_h=tree["chain_h"].to(device),
        generator=gen,
        epoch=int(tree["epoch"]),
    )


def save_state(state: TrainState, path: str) -> None:
    """Save one TrainState to the file ``path`` (written atomically)."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state_to_dict(state), tmp)
    os.replace(tmp, path)


def restore_state(path: str, device: Optional[torch.device | str] = None) -> TrainState:
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return state_from_dict(tree, device)


class LayerCheckpointer:
    """Layer-boundary checkpointing for DBN/MDBN greedy pretraining.

    Directory layout:
        <dir>/manifest.json           completed layer names, in order
        <dir>/<name>.pt               the layer's TrainState
        <dir>/<name>.config.json      the layer's RBMConfig
    """

    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)
        self._manifest_path = os.path.join(self.dir, "manifest.json")

    def completed(self) -> List[str]:
        if not os.path.exists(self._manifest_path):
            return []
        with open(self._manifest_path) as f:
            return json.load(f)["completed"]

    def save_layer(self, name: str, state: TrainState, cfg: RBMConfig) -> None:
        save_state(state, os.path.join(self.dir, f"{name}.pt"))
        save_config(cfg, os.path.join(self.dir, f"{name}.config.json"))
        done = self.completed()
        if name not in done:
            done.append(name)
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"completed": done}, f)
        os.replace(tmp, self._manifest_path)  # atomic: no torn manifests

    def load_layer(self, name: str, device: Optional[torch.device | str] = None):
        state = restore_state(os.path.join(self.dir, f"{name}.pt"), device)
        cfg = load_config(os.path.join(self.dir, f"{name}.config.json"))
        return state, cfg

    def has_layer(self, name: str) -> bool:
        return name in self.completed()

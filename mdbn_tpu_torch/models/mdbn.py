"""Multimodal DBN: per-modality towers + joint top RBM.

Port of ``mdbn_tpu/models/mdbn.py`` (``train``, ``transform``, ``history``,
``save``, ``load``). ``train({modality: matrix})`` trains one DBN tower per
modality, concatenates the towers' top-layer mean-field codes in config
order, and trains a joint Bernoulli RBM on the concatenation. ``impute``,
``generate`` and the fine-tuning methods wait (ROADMAP.md Queue 1, items 6
and 9).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import torch

from ..config import MDBNConfig, TrainRuntimeConfig
from ..core.state import default_device
from .dbn import DBN
from .rbm import RBM

JOINT_SEED_OFFSET = 997  # the joint RBM's init seed is MDBNConfig.seed + 997


class MDBN:
    """>>> mdbn = MDBN(MDBNConfig(towers={...}, joint=RBMConfig(...)))
    >>> mdbn.train({"ge": ge, "meth": meth, "mirna": mirna})
    >>> joint_codes = mdbn.transform(modalities)
    """

    def __init__(self, cfg: MDBNConfig, device: Optional[torch.device | str] = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else default_device()
        self.towers: Dict[str, DBN] = {}
        self.joint: Optional[RBM] = None

    def _tower_codes(self, modalities) -> torch.Tensor:
        missing = set(self.cfg.towers) - set(modalities)
        if missing:
            raise ValueError(f"missing modalities: {sorted(missing)}")
        # deterministic modality order: config insertion order
        return torch.cat([self.towers[name].transform(modalities[name])
                          for name in self.cfg.towers], dim=1)

    def train(self, modalities, mesh=None, runtime: Optional[TrainRuntimeConfig] = None,
              checkpoint_dir: Optional[str] = None) -> "MDBN":
        """With ``checkpoint_dir``, each tower layer and the joint RBM are
        checkpointed as completed and restored on re-run. ``mesh`` goes to
        every layer's ``RBM.train``; under it rank 0 alone writes the
        checkpoints."""
        from ..checkpoint import LayerCheckpointer

        for name, tower_cfg in self.cfg.towers.items():
            ck = (LayerCheckpointer(f"{checkpoint_dir}/tower_{name}")
                  if checkpoint_dir else None)
            tower = DBN(tower_cfg, device=self.device)
            tower.train(modalities[name], mesh=mesh, runtime=runtime, checkpointer=ck)
            self.towers[name] = tower
        codes = self._tower_codes(modalities)
        joint_cfg = dataclasses.replace(self.cfg.joint, n_visible=codes.shape[1],
                                        visible="bernoulli")
        jck = LayerCheckpointer(f"{checkpoint_dir}/joint") if checkpoint_dir else None
        if jck is not None and jck.has_layer("joint"):
            state, cfg = jck.load_layer("joint", self.device)
            if cfg != joint_cfg:
                raise ValueError(
                    "checkpointed joint RBM was trained with a different config "
                    "(e.g. tower code width changed); clear the checkpoint "
                    f"directory to retrain.\ncheckpoint: {cfg}\ncurrent: {joint_cfg}")
            self.joint = RBM(cfg, state=state, device=self.device)
        else:
            gen = torch.Generator().manual_seed(self.cfg.seed + JOINT_SEED_OFFSET)
            self.joint = RBM(joint_cfg, generator=gen, device=self.device)
            self.joint.train(codes, mesh=mesh, runtime=runtime)
            if jck is not None and (mesh is None or mesh.rank == 0):
                jck.save_layer("joint", self.joint.state, self.joint.cfg)
        return self

    def transform(self, modalities) -> torch.Tensor:
        if self.joint is None:
            raise RuntimeError("MDBN.transform called before train")
        return self.joint.transform(self._tower_codes(modalities))

    @property
    def history(self) -> dict:
        h = {name: tower.history for name, tower in self.towers.items()}
        if self.joint is not None:
            h["joint"] = self.joint.history
        return h

    # -- persistence ---------------------------------------------------------

    def save(self, directory: str) -> None:
        from ..config import save_config

        os.makedirs(directory, exist_ok=True)
        for name, tower in self.towers.items():
            tower.save(os.path.join(directory, f"tower_{name}"))
        if self.joint is not None:
            self.joint.save(os.path.join(directory, "joint"))
        save_config(self.cfg, os.path.join(directory, "mdbn.config.json"))
        with open(os.path.join(directory, "structure.json"), "w") as f:
            json.dump({"towers": list(self.towers), "has_joint": self.joint is not None}, f)

    @classmethod
    def load(cls, directory: str, device: Optional[torch.device | str] = None) -> "MDBN":
        from ..config import load_config

        mdbn = cls(load_config(os.path.join(directory, "mdbn.config.json")), device=device)
        with open(os.path.join(directory, "structure.json")) as f:
            meta = json.load(f)
        for name in meta["towers"]:
            mdbn.towers[name] = DBN.load(os.path.join(directory, f"tower_{name}"),
                                         mdbn.device)
        if meta["has_joint"]:
            mdbn.joint = RBM.load(os.path.join(directory, "joint"), mdbn.device)
        return mdbn

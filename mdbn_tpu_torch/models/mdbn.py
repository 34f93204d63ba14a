"""Multimodal DBN: per-modality towers + joint top RBM.

Port of ``mdbn_tpu/models/mdbn.py`` (``train``, ``transform``, missing-
modality inference (``impute``, ``transform_partial``), ``reconstruct``,
``generate``, ``history``, ``save``, ``load``). ``train({modality:
matrix})`` trains one DBN tower per modality, concatenates the towers'
top-layer mean-field codes in config order, and trains a joint Bernoulli
RBM on the concatenation. The fine-tuning methods wait (ROADMAP.md Queue 1,
item 9), so every down-pass uses the tied weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

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

    # -- missing-modality inference -------------------------------------------

    def _code_layout(self) -> Tuple[List[Tuple[str, slice]], int]:
        """[(name, slice into the joint visible vector)] in config order, and
        the vector's width."""
        out, offset = [], 0
        for name in self.cfg.towers:
            width = self.towers[name].layers[-1].cfg.n_hidden
            out.append((name, slice(offset, offset + width)))
            offset += width
        return out, offset

    def _infer_full_codes(self, modalities, n_gibbs: int, seed: int, n_chains: int = 8,
                          draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The joint visible vector with the observed towers' codes clamped and
        the missing towers' blocks filled by the conditional posterior mean
        E[code_missing | code_observed] under the joint RBM: clamped Gibbs,
        ``n_chains`` chains a patient, the second half of each chain averaged
        (``ops.sample.gibbs_sample_clamped``; draws from a generator seeded
        ``seed`` on the model's device, or ``draws``)."""
        from ..ops.sample import gibbs_sample_clamped

        if self.joint is None:
            raise RuntimeError("called before train")
        unknown = set(modalities) - set(self.cfg.towers)
        if unknown:
            raise ValueError(f"unknown modalities: {sorted(unknown)}")
        observed = [n for n in self.cfg.towers if n in modalities]
        if not observed:
            raise ValueError("need at least one observed modality")
        rows = {int(modalities[n].shape[0]) for n in observed}
        if len(rows) != 1:
            raise ValueError(f"observed modalities disagree on rows: {rows}")
        n = rows.pop()
        layout, total = self._code_layout()
        v0 = torch.full((n, total), 0.5, dtype=torch.float32, device=self.device)
        mask = torch.zeros(total, dtype=torch.float32, device=self.device)
        for name, sl in layout:
            if name in modalities:
                v0[:, sl] = self.towers[name].transform(modalities[name]).float()
                mask[sl] = 1.0
        gen = torch.Generator(device=self.device).manual_seed(seed)
        vmean, _ = gibbs_sample_clamped(self.joint.params, v0, mask, self.joint.cfg, n_gibbs,
                                        n_burnin=n_gibbs // 2, n_chains=n_chains,
                                        generator=gen, draws=draws)
        return vmean

    def _down(self, name: str, code: torch.Tensor) -> torch.Tensor:
        """Tower ``name``'s mean-field down-pass from its top code."""
        from ..ops.sample import down_pass

        return down_pass(list(reversed(self.towers[name]._generative_layers())), code)

    def impute(self, modalities, n_gibbs: int = 200, seed: int = 0, n_chains: int = 8,
               draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Infer the modalities absent from ``modalities`` (a cohort missing
        one omics platform, say): clamped Gibbs on the joint RBM infers the
        missing towers' top codes from the observed ones, then each tower's
        mean-field down-pass maps its code to that modality's features.
        Returns {missing_name: [n, features]}."""
        missing = [n for n in self.cfg.towers if n not in modalities]
        if not missing:
            raise ValueError("all modalities observed — nothing to impute")
        codes = self._infer_full_codes(modalities, n_gibbs, seed, n_chains, draws)
        layout, _ = self._code_layout()
        return {name: self._down(name, codes[:, sl]) for name, sl in layout
                if name not in modalities}

    def transform_partial(self, modalities, n_gibbs: int = 200, seed: int = 0,
                          draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Joint latent codes of a partially observed cohort: the missing
        towers' codes inferred by clamped Gibbs (see ``impute``), then the
        joint layer's mean-field transform of the completed vector. With
        every modality present it raises: ``transform`` is the deterministic
        path."""
        if all(n in modalities for n in self.cfg.towers):
            raise ValueError("all modalities observed — use transform()")
        return self.joint.transform(self._infer_full_codes(modalities, n_gibbs, seed,
                                                           draws=draws))

    def reconstruct(self, modalities) -> Dict[str, torch.Tensor]:
        """Deterministic encode -> decode of every modality through the towers
        and the joint layer, with the tied W^T down-pass."""
        from ..ops.transform import reconstruct_mdbn

        if self.joint is None:
            raise RuntimeError("MDBN.reconstruct called before train")
        towers = {m: self.towers[m]._generative_layers() for m in self.cfg.towers}
        xs = {m: torch.as_tensor(modalities[m]).to(device=self.device) for m in towers}
        return reconstruct_mdbn(towers, (self.joint.params, self.joint.cfg), xs)

    def generate(self, n_samples: int = 16, n_gibbs: int = 200, seed: int = 0,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Synthetic multi-omics profiles: Gibbs in the joint RBM from a
        uniform binary start, the code split by tower, each tower's mean-field
        down-pass. Draws from a generator seeded ``seed`` on the model's
        device, or ``draws`` ({"init", "h", "v"}, as
        ``ops.sample.generate_from_stack`` takes them)."""
        from ..ops.sample import gibbs_sample

        if self.joint is None:
            raise RuntimeError("MDBN.generate called before train")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        u0 = (draws["init"].to(self.device) if draws is not None
              else torch.rand((n_samples, self.joint.cfg.n_visible), generator=gen,
                              device=self.device))
        codes, _ = gibbs_sample(self.joint.params, (u0 < 0.5).float(), self.joint.cfg, n_gibbs,
                                generator=gen, draws=draws)
        layout, _ = self._code_layout()
        return {name: self._down(name, codes[:, sl]) for name, sl in layout}

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

"""Multimodal DBN: per-modality towers + joint top RBM, and its phase 2.

Port of ``mdbn_tpu/models/mdbn.py``: ``train``, ``transform``, missing-
modality inference (``impute``, ``transform_partial``), ``reconstruct``,
``generate``, ``history``, ``save``, ``load``, and the phase-2 methods
(``finetune`` / ``predict``, ``finetune_autoencoder``, ``fit_label_top``,
``predict_generative``, ``class_posterior``, ``generate_class``,
``finetune_updown``, ``finetune_updown_labeled``). ``train({modality:
matrix})`` trains one DBN tower per modality, concatenates the towers'
top-layer mean-field codes in config order, and trains a joint Bernoulli RBM
on the concatenation. After fine-tuning the down-passes use the untied
weights, as the reference does: the autoencoder's decoder in
``reconstruct``; up-down's generative weights of the towers (and, after
labeled up-down, of the joint layer) in ``generate``, ``generate_class``
and ``impute``.
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
        # phase 2: the classifier's head, the autoencoder's decoder ({tower:
        # [D...], "__joint__": [Dj]}), (label-top params, n_classes), and
        # labeled up-down's joint generative (W, b); up-down's tower
        # generative weights live on the towers (DBN._gen)
        self._head: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._decoder: Optional[Dict[str, list]] = None
        self._label_top = None
        self._joint_gen: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

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

    # -- phase 2 -------------------------------------------------------------

    def _towers(self):
        return {m: self.towers[m]._stack() for m in self.cfg.towers}

    def _joint(self):
        return (self.joint.params, self.joint.cfg)

    def _require(self, attr: str, what: str, before: str):
        if getattr(self, attr) is None:
            raise RuntimeError(f"MDBN.{what} called before {before}")
        return getattr(self, attr)

    def _set_tuned(self, tower_p, joint_p) -> None:
        from .dbn import _set_params

        for m, plist in tower_p.items():
            for rbm, p in zip(self.towers[m].layers, plist):
                _set_params(rbm, p)
        _set_params(self.joint, joint_p)

    def _tower_gen(self):
        """The towers' generative weights {tower: [(W, b)]} when every tower
        has them (a resume), else None."""
        gens = {m: self.towers[m]._gen for m in self.cfg.towers}
        return gens if all(g is not None for g in gens.values()) else None

    def finetune(self, modalities, labels, n_classes: int, epochs: int = 10, lr: float = 0.1,
                 batch_size: int = 20, seed: int = 0, mesh=None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> List[float]:
        """Supervised multimodal fine-tuning: a softmax head on the joint
        code, cross-entropy backprop through the joint layer and every
        tower. Updates the weights in place; returns the per-epoch loss."""
        from ..train.finetune import finetune_mdbn

        self._require("joint", "finetune", "train")
        tower_p, joint_p, head, history = finetune_mdbn(
            self._towers(), self._joint(), modalities, labels, n_classes, epochs=epochs,
            lr=lr, batch_size=batch_size, seed=seed, mesh=mesh, draws=draws)
        self._set_tuned(tower_p, joint_p)
        self._head = head
        return history

    def predict(self, modalities) -> torch.Tensor:
        """Class predictions after ``finetune``."""
        from ..train.finetune import predict_mdbn

        head = self._require("_head", "predict", "finetune")
        return predict_mdbn(self._towers(), self._joint(), head, modalities)

    def finetune_autoencoder(self, modalities, epochs: int = 10, lr: float = 1e-3,
                             batch_size: int = 20, mesh=None) -> List[float]:
        """Multimodal deep-autoencoder fine-tuning: the towers, the concat
        and the joint code as the encoder, an untied mirrored decoder back to
        every modality, the summed reconstruction loss. Updates every weight
        in place and keeps the decoder for ``reconstruct``; a second call
        resumes from it. Returns the per-epoch loss."""
        from ..train.autoencoder import finetune_autoencoder_mdbn

        self._require("joint", "finetune_autoencoder", "train")
        tower_p, joint_p, decoder, history = finetune_autoencoder_mdbn(
            self._towers(), self._joint(), modalities, epochs=epochs, lr=lr,
            batch_size=batch_size, decoder=self._decoder, mesh=mesh)
        self._set_tuned(tower_p, joint_p)
        self._decoder = decoder
        return history

    def fit_label_top(self, modalities, labels, n_classes: int, n_hidden: int = 64,
                      epochs: int = 20, lr: float = 0.1, k: int = 1, batch_size: int = 20,
                      momentum: float = 0.0, l2: float = 0.0, seed: int = 0, mesh=None,
                      draws: Optional[dict] = None) -> List[float]:
        """An associative label-top RBM over [joint codes ; one-hot labels]:
        free-energy classification of patients from every modality. The
        towers and the joint RBM are not modified; a second call resumes the
        stored top."""
        from ..train.labeled import fit_label_top

        self._require("joint", "fit_label_top", "train")
        prev = self._label_top
        if prev is not None and prev[1] != n_classes:
            raise ValueError(f"stored label top has {prev[1]} classes, "
                             f"got n_classes={n_classes}")
        params, history = fit_label_top(
            [], self.transform(modalities), labels, n_classes, n_hidden=n_hidden,
            epochs=epochs, lr=lr, k=k, batch_size=batch_size, momentum=momentum, l2=l2,
            seed=seed, params=prev[0] if prev else None, mesh=mesh, device=self.device,
            draws=draws)
        self._label_top = (params, n_classes)
        return history

    def predict_generative(self, modalities) -> torch.Tensor:
        """Free-energy classification through the label-top RBM."""
        from ..train.labeled import predict_label_top

        params, n_classes = self._require("_label_top", "predict_generative",
                                          "fit_label_top")
        return predict_label_top(params, [], self.transform(modalities), n_classes)

    def class_posterior(self, modalities) -> torch.Tensor:
        """Exact p(y | modalities) under the associative model."""
        from ..train.labeled import label_top_logits

        params, n_classes = self._require("_label_top", "class_posterior", "fit_label_top")
        return torch.softmax(label_top_logits(params, [], self.transform(modalities),
                                              n_classes), dim=1)

    def finetune_updown(self, modalities, epochs: int = 10, lr: float = 0.01, k: int = 1,
                        batch_size: int = 20, seed: int = 0, mesh=None,
                        draws: Optional[dict] = None) -> List[float]:
        """Up-down fine-tuning of the whole multimodal model: the joint RBM
        the undirected top, every tower layer directed. Unties each tower's
        recognition and generative weights (kept on the towers, so a tower's
        save keeps them) and tunes both and the joint RBM; a second call
        resumes. Returns the per-epoch mean wake reconstruction mse."""
        from ..train.updown import finetune_updown_mdbn

        self._require("joint", "finetune_updown", "train")
        rec, gen, joint_p, history = finetune_updown_mdbn(
            self._towers(), self._joint(), modalities, epochs=epochs, lr=lr, k=k,
            batch_size=batch_size, seed=seed, gen=self._tower_gen(), mesh=mesh, draws=draws)
        self._set_tuned(rec, joint_p)
        for m in rec:
            self.towers[m]._gen = gen[m]
        return history

    def finetune_updown_labeled(self, modalities, labels, epochs: int = 10, lr: float = 0.01,
                                k: int = 1, batch_size: int = 20, seed: int = 0, mesh=None,
                                draws: Optional[dict] = None) -> List[float]:
        """The complete 2006 fine-tuning on the multimodal tree: up-down with
        the associative label top (``fit_label_top`` first) the only
        undirected module; every tower layer and the joint layer directed.
        Returns the per-epoch wake mse."""
        from ..train.updown import finetune_updown_mdbn_labeled

        self._require("joint", "finetune_updown_labeled", "train")
        top, n_classes = self._require("_label_top", "finetune_updown_labeled",
                                       "fit_label_top")
        rec, gen, joint_p, joint_gen, top, history = finetune_updown_mdbn_labeled(
            self._towers(), self._joint(), top, modalities, labels, n_classes, epochs=epochs,
            lr=lr, k=k, batch_size=batch_size, seed=seed, gen=self._tower_gen(),
            joint_gen=self._joint_gen, mesh=mesh, draws=draws)
        self._set_tuned(rec, joint_p)
        for m in rec:
            self.towers[m]._gen = gen[m]
        self._joint_gen = joint_gen
        self._label_top = (top, n_classes)
        return history

    @torch.no_grad()
    def _dream_down(self, codes: torch.Tensor, joint_gen) -> Dict[str, torch.Tensor]:
        """The generative down-pass from a batch of joint codes: ``joint_gen``
        (untied after labeled up-down, else the joint RBM's tied (W, b)) to
        the concat's probabilities, then each tower's generative layers."""
        Wjg, bjg = joint_gen
        concat = torch.sigmoid(codes @ Wjg.float().T + bjg.float())
        layout, _ = self._code_layout()
        return {name: self._down(name, concat[:, sl]) for name, sl in layout}

    def generate_class(self, label: int, n_samples: int = 16, n_gibbs: int = 200,
                       seed: int = 0, draws: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
        """Dream multi-omics profiles of one class: clamped-label Gibbs in the
        label top gives joint codes, then the generative down-pass (the
        untied joint weights after labeled up-down, else the tied joint RBM
        weights) maps them to every modality."""
        from ..train.labeled import generate_class_conditional

        params, n_classes = self._require("_label_top", "generate_class", "fit_label_top")
        codes = generate_class_conditional(params, [], label, n_classes, n_samples=n_samples,
                                           n_gibbs=n_gibbs, seed=seed, draws=draws)
        return self._dream_down(codes, self._joint_gen or (self.joint.params.W,
                                                           self.joint.params.b))

    def reconstruct(self, modalities) -> Dict[str, torch.Tensor]:
        """Deterministic encode -> decode of every modality through the towers
        and the joint layer: the untied decoder after
        ``finetune_autoencoder``, else the tied W^T down-pass."""
        from ..train.autoencoder import reconstruct_mdbn

        self._require("joint", "reconstruct", "train")
        return reconstruct_mdbn(self._towers(), self._joint(), self._decoder, modalities)

    def generate(self, n_samples: int = 16, n_gibbs: int = 200, seed: int = 0,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """Synthetic multi-omics profiles: Gibbs in the joint RBM from a
        uniform binary start, the code split by tower, each tower's
        mean-field down-pass (through up-down's generative weights where
        there are some). Draws from a generator seeded ``seed`` on the
        model's device, or ``draws`` ({"init", "h", "v"}, as
        ``ops.sample.generate_from_stack`` takes them). After labeled up-down
        the joint layer is directed and the label top the undirected top:
        the Gibbs runs there (``draws`` as
        ``train.labeled.generate_labeled_model`` takes them) and the
        down-pass goes through the joint layer's generative weights."""
        from ..ops.sample import gibbs_sample

        self._require("joint", "generate", "train")
        if self._joint_gen is not None:
            from ..train.labeled import generate_labeled_model

            params, n_classes = self._require(
                "_label_top", "generate", "fit_label_top (joint generative weights exist, "
                "from labeled up-down, but no label top is stored)")
            codes = generate_labeled_model(params, [], n_classes, n_samples=n_samples,
                                           n_gibbs=n_gibbs, seed=seed, draws=draws)
            return self._dream_down(codes, self._joint_gen)
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
        from .dbn import save_decoder, save_gen, save_head, save_label_top

        os.makedirs(directory, exist_ok=True)
        for name, tower in self.towers.items():
            tower.save(os.path.join(directory, f"tower_{name}"))
        if self.joint is not None:
            self.joint.save(os.path.join(directory, "joint"))
        save_config(self.cfg, os.path.join(directory, "mdbn.config.json"))
        with open(os.path.join(directory, "structure.json"), "w") as f:
            json.dump({"towers": list(self.towers), "has_joint": self.joint is not None}, f)
        save_head(self._head, directory)
        save_decoder(self._decoder, directory, filename="mdbn_decoder.npz")
        save_label_top(self._label_top, directory)
        save_gen(None if self._joint_gen is None else [self._joint_gen], directory,
                 filename="joint_gen.npz")

    @classmethod
    def load(cls, directory: str, device: Optional[torch.device | str] = None) -> "MDBN":
        from ..config import load_config
        from .dbn import load_decoder, load_gen, load_head, load_label_top

        mdbn = cls(load_config(os.path.join(directory, "mdbn.config.json")), device=device)
        with open(os.path.join(directory, "structure.json")) as f:
            meta = json.load(f)
        for name in meta["towers"]:
            mdbn.towers[name] = DBN.load(os.path.join(directory, f"tower_{name}"),
                                         mdbn.device)
        if meta["has_joint"]:
            mdbn.joint = RBM.load(os.path.join(directory, "joint"), mdbn.device)
        mdbn._head = load_head(directory, mdbn.device)
        mdbn._decoder = load_decoder(directory, mdbn.device, filename="mdbn_decoder.npz")
        mdbn._label_top = load_label_top(directory, mdbn.device)
        jg = load_gen(directory, mdbn.device, filename="joint_gen.npz")
        mdbn._joint_gen = None if jg is None else jg[0]
        return mdbn

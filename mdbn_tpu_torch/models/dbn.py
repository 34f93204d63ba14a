"""Deep belief network: greedy layer-wise RBM stacking and its phase 2.

Port of ``mdbn_tpu/models/dbn.py``: ``train`` with layer checkpoints,
``transform``, ``reconstruct``, ``generate``, ``history``, ``save``,
``load``, and the phase-2 methods (``train/finetune.py``,
``autoencoder.py``, ``labeled.py``, ``updown.py``): the backprop classifier
(``finetune`` / ``predict``), the deep autoencoder
(``finetune_autoencoder``), the associative label top (``fit_label_top``,
``predict_generative``, ``class_posterior``, ``generate_class``) and up-down
(``finetune_updown``, ``finetune_updown_labeled``). Layer l trains on layer
l-1's mean-field probabilities. Fine-tuning unties the weights:
``reconstruct`` decodes with the autoencoder's decoder where there is one,
and ``generate`` walks down up-down's generative weights where there are
some, as the reference does.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import DBNConfig, TrainRuntimeConfig
from ..core.rbm_math import RBMParams, torch_dtype
from ..core.state import default_device
from ..ops.transform import stack_transform
from .rbm import RBM


class DBN:
    """>>> dbn = DBN(DBNConfig(layer_sizes=[400, 200, 50], visible="gaussian"))
    >>> dbn.train(data)             # greedy layer-wise pretraining
    >>> codes = dbn.transform(data) # top-layer mean-field code
    """

    def __init__(self, cfg: DBNConfig, device: Optional[torch.device | str] = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else default_device()
        self.layers: List[RBM] = []
        # phase 2: the classifier's head, the autoencoder's decoder, up-down's
        # generative (W, b) per directed layer, (label-top params, n_classes)
        self._head: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._decoder: Optional[List[torch.Tensor]] = None
        self._gen: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None
        self._label_top: Optional[Tuple[RBMParams, int]] = None

    def train(self, data, mesh=None, runtime: Optional[TrainRuntimeConfig] = None,
              layer_callback: Optional[Callable[[int, RBM], None]] = None,
              checkpointer=None) -> "DBN":
        """Greedy layer-wise pretraining. With a ``LayerCheckpointer``,
        completed layers are restored (through the RBM constructor, so they
        count as trained) instead of retrained, and each newly trained layer
        is saved. Layer l's RBM is initialised from its config's seed
        (``DBNConfig.seed + l``). ``mesh`` goes to every layer's
        ``RBM.train``; under it rank 0 alone writes the checkpoints."""
        reps = self._as_input(data)
        self.layers = []
        for l in range(len(self.cfg.layer_sizes)):
            name = f"layer{l}"
            expected_cfg = self.cfg.rbm_config(l, reps.shape[1])
            restored = checkpointer is not None and checkpointer.has_layer(name)
            if restored:
                state, cfg = checkpointer.load_layer(name, self.device)
                if cfg != expected_cfg:
                    raise ValueError(
                        f"checkpointed {name} was trained with a different config "
                        f"than the current run (e.g. layer sizes or data width "
                        f"changed); clear the checkpoint directory to retrain. "
                        f"checkpoint: {cfg}\ncurrent: {expected_cfg}")
                rbm = RBM(cfg, state=state, device=self.device)
            else:
                rbm = RBM(expected_cfg, device=self.device)
                rbm.train(reps, mesh=mesh, runtime=runtime)
                if checkpointer is not None and (mesh is None or mesh.rank == 0):
                    checkpointer.save_layer(name, rbm.state, rbm.cfg)
            self.layers.append(rbm)
            # callbacks fire only for layers trained in THIS run
            if layer_callback is not None and not restored:
                layer_callback(l, rbm)
            if l + 1 < len(self.cfg.layer_sizes):
                reps = rbm.transform(reps)
        return self

    def transform(self, v) -> torch.Tensor:
        if not self.layers:
            # an empty stack would silently return the INPUT as the "code"
            raise RuntimeError("DBN.transform called before train(): no "
                               "layers have been trained yet")
        return stack_transform([(r.params, r.cfg) for r in self.layers],
                               self._as_input(v))

    def _stack(self):
        return [(r.params, r.cfg) for r in self.layers]

    def _require(self, attr: str, what: str, before: str):
        if getattr(self, attr) is None:
            raise RuntimeError(f"DBN.{what} called before {before}")
        return getattr(self, attr)

    def finetune(self, data, labels, n_classes: int, epochs: int = 10, lr: float = 0.1,
                 batch_size: int = 20, seed: int = 0, mesh=None,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> List[float]:
        """Supervised fine-tuning: a softmax head on the top code,
        cross-entropy backprop through the whole stack. Updates the layers'
        weights in place and keeps the head for ``predict``; returns the
        per-epoch loss history. ``draws={"head": normals}`` injects the
        head's initial draw."""
        from ..train.finetune import finetune_stack

        stack, head, history = finetune_stack(
            self._stack(), data, labels, n_classes, epochs=epochs, lr=lr,
            batch_size=batch_size, seed=seed, mesh=mesh, draws=draws)
        for rbm, p in zip(self.layers, stack):
            _set_params(rbm, p)
        self._head = head
        return history

    def predict(self, x) -> torch.Tensor:
        """Class predictions after ``finetune``."""
        from ..train.finetune import predict_stack

        return predict_stack(self._stack(), self._require("_head", "predict", "finetune"), x)

    def finetune_autoencoder(self, data, epochs: int = 10, lr: float = 1e-3,
                             batch_size: Optional[int] = None, mesh=None) -> List[float]:
        """Deep-autoencoder fine-tuning (Hinton & Salakhutdinov 2006): the
        stack unrolled into an encoder and an untied decoder, trained by
        reconstruction backprop. Updates the layers' weights in place
        (``transform`` uses the tuned encoder) and keeps the decoder for
        ``reconstruct``; a second call resumes from the stored decoder.
        Returns the per-epoch loss history."""
        from ..train.autoencoder import finetune_autoencoder_stack

        tuned, decoder, history = finetune_autoencoder_stack(
            self._stack(), data, epochs=epochs, lr=lr,
            batch_size=batch_size or self.cfg.batch_size, decoder=self._decoder, mesh=mesh)
        for rbm, p in zip(self.layers, tuned):
            _set_params(rbm, p)
        self._decoder = decoder
        return history

    def fit_label_top(self, data, labels, n_classes: int, n_hidden: int = 64,
                      epochs: int = 20, lr: float = 0.1, k: int = 1, batch_size: int = 20,
                      momentum: float = 0.0, l2: float = 0.0, seed: int = 0, mesh=None,
                      draws: Optional[dict] = None) -> List[float]:
        """Train an associative label-top RBM over [top codes ; one-hot
        labels] (Hinton-Osindero-Teh 2006): free-energy classification
        (``predict_generative``, ``class_posterior``) and class-conditional
        generation (``generate_class``). The stack is not modified. A second
        call resumes the stored top. Returns the per-epoch history."""
        from ..train.labeled import fit_label_top

        prev = self._label_top
        if prev is not None and prev[1] != n_classes:
            raise ValueError(f"stored label top has {prev[1]} classes, "
                             f"got n_classes={n_classes}")
        params, history = fit_label_top(
            self._stack(), data, labels, n_classes, n_hidden=n_hidden, epochs=epochs, lr=lr,
            k=k, batch_size=batch_size, momentum=momentum, l2=l2, seed=seed,
            params=prev[0] if prev else None, mesh=mesh, device=self.device, draws=draws)
        self._label_top = (params, n_classes)
        return history

    def predict_generative(self, x) -> torch.Tensor:
        """Free-energy classification through the label-top RBM."""
        from ..train.labeled import predict_label_top

        params, n_classes = self._require("_label_top", "predict_generative", "fit_label_top")
        return predict_label_top(params, self._stack(), x, n_classes)

    def class_posterior(self, x) -> torch.Tensor:
        """Exact p(y | x) under the associative model: the softmax of the
        classes' negative free energies."""
        from ..train.labeled import label_top_logits

        params, n_classes = self._require("_label_top", "class_posterior", "fit_label_top")
        return torch.softmax(label_top_logits(params, self._stack(), x, n_classes), dim=1)

    def generate_class(self, label: int, n_samples: int = 16, n_gibbs: int = 200,
                       seed: int = 0, draws: Optional[Dict[str, torch.Tensor]] = None
                       ) -> torch.Tensor:
        """Dream inputs of one class: clamped-label Gibbs in the label top,
        then the generative down-pass (the untied weights after up-down)."""
        from ..train.labeled import generate_class_conditional

        params, n_classes = self._require("_label_top", "generate_class", "fit_label_top")
        return generate_class_conditional(params, self._generative_layers(), label, n_classes,
                                          n_samples=n_samples, n_gibbs=n_gibbs, seed=seed,
                                          draws=draws)

    def finetune_updown(self, data, epochs: int = 10, lr: float = 0.01, k: int = 1,
                        batch_size: Optional[int] = None, seed: int = 0, mesh=None,
                        draws: Optional[dict] = None) -> List[float]:
        """Generative fine-tuning by up-down (Hinton, Osindero & Teh 2006,
        appendix B): unties each directed layer's recognition and generative
        weights and tunes both and the top RBM. ``transform`` then uses the
        tuned recognition weights, ``generate`` the generative ones; a
        second call resumes from the stored generative weights. Returns the
        per-epoch wake reconstruction mse."""
        from ..train.updown import finetune_updown_stack

        rec, gen, top, history = finetune_updown_stack(
            self._stack(), data, epochs=epochs, lr=lr, k=k,
            batch_size=batch_size or self.cfg.batch_size, seed=seed, gen=self._gen,
            mesh=mesh, draws=draws)
        for rbm, p in zip(self.layers, [*rec, top]):
            _set_params(rbm, p)
        self._gen = gen
        return history

    def finetune_updown_labeled(self, data, labels, epochs: int = 10, lr: float = 0.01,
                                k: int = 1, batch_size: Optional[int] = None, seed: int = 0,
                                mesh=None, draws: Optional[dict] = None) -> List[float]:
        """The complete Hinton-Osindero-Teh 2006 fine-tuning: up-down over the
        whole stack under the associative label top (``fit_label_top``
        first): wake clamps the true label, sleep dreams code and label.
        Unties every layer and tunes the label top. Returns the per-epoch
        wake mse."""
        from ..train.updown import finetune_updown_labeled

        top, n_classes = self._require("_label_top", "finetune_updown_labeled",
                                       "fit_label_top")
        if self._gen is not None and len(self._gen) != len(self.layers):
            raise ValueError(
                f"stored generative weights cover {len(self._gen)} layers but "
                f"labeled up-down unties all {len(self.layers)} (they came "
                "from unlabeled finetune_updown, which keeps the stack's own "
                "top RBM undirected); rerun from pretrained weights")
        rec, gen, top, history = finetune_updown_labeled(
            self._stack(), top, data, labels, n_classes, epochs=epochs, lr=lr, k=k,
            batch_size=batch_size or self.cfg.batch_size, seed=seed, gen=self._gen,
            mesh=mesh, draws=draws)
        for rbm, p in zip(self.layers, rec):
            _set_params(rbm, p)
        self._gen = gen
        self._label_top = (top, n_classes)
        return history

    def reconstruct(self, v) -> torch.Tensor:
        """Deterministic encode -> decode through the whole stack: the untied
        decoder after ``finetune_autoencoder``, else the tied W^T down-pass."""
        from ..train.autoencoder import reconstruct_stack

        if not self.layers:
            raise RuntimeError("DBN.reconstruct called before train")
        return reconstruct_stack(self._stack(), self._decoder, self._as_input(v))

    def generate(self, n_samples: int = 16, n_gibbs: int = 200, seed: int = 0,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Sample from the DBN: Gibbs in the top RBM, mean-field down-pass
        (through up-down's generative weights where there are some), with
        draws from a generator seeded ``seed`` on the model's device (or
        ``draws``, as ``ops.sample.generate_from_stack`` takes them). After
        labeled up-down every layer is directed and the label top is the
        undirected top: the Gibbs runs there, the label softmax-sampled
        (``draws`` as ``train.labeled.generate_labeled_model`` takes them)."""
        from ..ops.sample import generate_from_stack

        if self._gen is not None and len(self._gen) == len(self.layers):
            from ..train.labeled import generate_labeled_model

            params, n_classes = self._require(
                "_label_top", "generate", "fit_label_top (generative weights cover every "
                "layer, from labeled up-down, but no label top is stored)")
            return generate_labeled_model(params, self._generative_layers(), n_classes,
                                          n_samples=n_samples, n_gibbs=n_gibbs, seed=seed,
                                          draws=draws)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return generate_from_stack(self._generative_layers(), n_samples, n_gibbs,
                                   generator=gen, draws=draws)

    def _generative_layers(self):
        """[(params, cfg)] of the down-pass, bottom-up: up-down's untied
        generative (W, b) swapped into the directed layers where there are
        some, the tied weights otherwise."""
        layers = self._stack()
        if self._gen is None:
            return layers
        return [(dataclasses.replace(p, W=Wg, b=bg), cfg)
                for (p, cfg), (Wg, bg) in zip(layers, self._gen)] + layers[len(self._gen):]

    def _as_input(self, v) -> torch.Tensor:
        return torch.as_tensor(v).to(device=self.device,
                                     dtype=torch_dtype(self.cfg.param_dtype))

    @property
    def history(self) -> List[list]:
        return [r.history for r in self.layers]

    # -- persistence ---------------------------------------------------------

    def save(self, directory: str) -> None:
        from ..config import save_config

        os.makedirs(directory, exist_ok=True)
        for l, rbm in enumerate(self.layers):
            rbm.save(os.path.join(directory, f"layer{l}"))
        save_config(self.cfg, os.path.join(directory, "dbn.config.json"))
        with open(os.path.join(directory, "stack.json"), "w") as f:
            json.dump({"n_layers": len(self.layers)}, f)
        save_head(self._head, directory)
        save_decoder(self._decoder, directory)
        save_gen(self._gen, directory)
        save_label_top(self._label_top, directory)

    @classmethod
    def load(cls, directory: str, device: Optional[torch.device | str] = None) -> "DBN":
        from ..config import load_config

        dbn = cls(load_config(os.path.join(directory, "dbn.config.json")), device=device)
        with open(os.path.join(directory, "stack.json")) as f:
            n = json.load(f)["n_layers"]
        dbn.layers = [RBM.load(os.path.join(directory, f"layer{l}"), dbn.device)
                      for l in range(n)]
        dbn._head = load_head(directory, dbn.device)
        dbn._decoder = load_decoder(directory, dbn.device)
        dbn._gen = load_gen(directory, dbn.device)
        dbn._label_top = load_label_top(directory, dbn.device)
        return dbn


def _set_params(rbm: RBM, p: RBMParams) -> None:
    """Fine-tuned parameters into an RBM's state, at its storage dtype."""
    dtype = torch_dtype(rbm.cfg.param_dtype)
    rbm.state = dataclasses.replace(
        rbm.state, params=p.map(lambda t: t.detach().to(device=rbm.device, dtype=dtype)))


# -- the phase-2 state on disk: the reference's file names and array keys ----------
#
# Each save_* removes a stale file when there is nothing to save, so load never
# pairs an old head, decoder, generative weights or label top with new weights.


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _load_npz(directory: str, filename: str):
    path = os.path.join(directory, filename)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _save_npz(arrays: Optional[dict], directory: str, filename: str) -> None:
    path = os.path.join(directory, filename)
    if arrays is None:
        if os.path.exists(path):
            os.remove(path)
        return
    np.savez(path, **arrays)


def save_head(head, directory: str) -> None:
    """``finetune``'s softmax head (Wh, bh) as ``head.npz`` {W, b}."""
    _save_npz(None if head is None else {"W": _np(head[0]), "b": _np(head[1])},
              directory, "head.npz")


def load_head(directory: str, device=None):
    z = _load_npz(directory, "head.npz")
    return None if z is None else (_to(z["W"], device), _to(z["b"], device))


def save_decoder(decoder, directory: str, filename: str = "decoder.npz") -> None:
    """The autoencoder's untied decoder weights: a DBN's list as {D0, D1,
    ...}, the MDBN's {modality: [D...], "__joint__": [Dj]} as {"m::i"}."""
    if decoder is None:
        arrays = None
    elif isinstance(decoder, dict):
        arrays = {f"{m}::{i}": _np(D) for m, Ds in decoder.items() for i, D in enumerate(Ds)}
    else:
        arrays = {f"D{i}": _np(D) for i, D in enumerate(decoder)}
    _save_npz(arrays, directory, filename)


def load_decoder(directory: str, device=None, filename: str = "decoder.npz"):
    z = _load_npz(directory, filename)
    if z is None:
        return None
    if any("::" in k for k in z):  # the MDBN's dict layout
        out: Dict[str, list] = {}
        for key, a in z.items():
            m, i = key.rsplit("::", 1)
            out.setdefault(m, []).append((int(i), _to(a, device)))
        return {m: [D for _, D in sorted(lst, key=lambda x: x[0])] for m, lst in out.items()}
    return [_to(z[f"D{i}"], device) for i in range(len(z))]


def save_gen(gen, directory: str, filename: str = "gen.npz") -> None:
    """Up-down's generative (W, b) per directed layer as {W0, b0, ...} (the
    MDBN keeps its joint layer's pair as ``joint_gen.npz``)."""
    arrays = None if gen is None else {
        f"{kind}{i}": _np(t) for i, pair in enumerate(gen) for kind, t in zip("Wb", pair)}
    _save_npz(arrays, directory, filename)


def load_gen(directory: str, device=None, filename: str = "gen.npz"):
    z = _load_npz(directory, filename)
    if z is None:
        return None
    return [(_to(z[f"W{i}"], device), _to(z[f"b{i}"], device)) for i in range(len(z) // 2)]


def save_label_top(label_top, directory: str) -> None:
    """``fit_label_top``'s (RBMParams, n_classes) as ``label_top.npz`` {W, b, c,
    n_classes}."""
    arrays = None
    if label_top is not None:
        p, n_classes = label_top
        arrays = {"W": _np(p.W), "b": _np(p.b), "c": _np(p.c), "n_classes": np.asarray(n_classes)}
    _save_npz(arrays, directory, "label_top.npz")


def load_label_top(directory: str, device=None):
    z = _load_npz(directory, "label_top.npz")
    if z is None:
        return None
    return (RBMParams(W=_to(z["W"], device), b=_to(z["b"], device), c=_to(z["c"], device)),
            int(z["n_classes"]))

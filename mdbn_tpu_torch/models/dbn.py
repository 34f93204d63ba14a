"""Deep belief network: greedy layer-wise RBM stacking.

Port of ``mdbn_tpu/models/dbn.py`` (``train`` with layer checkpoints,
``transform``, ``reconstruct``, ``generate``, ``history``, ``save``,
``load``). Layer l trains on layer l-1's mean-field probabilities. The
fine-tuning and up-down methods wait (ROADMAP.md Queue 1, item 9), so the
stack's weights stay tied: ``reconstruct`` decodes with W^T and
``generate`` walks down the recognition weights.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional

import torch

from ..config import DBNConfig, TrainRuntimeConfig
from ..core.rbm_math import torch_dtype
from ..core.state import default_device
from ..ops.transform import reconstruct_stack, stack_transform
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

    def reconstruct(self, v) -> torch.Tensor:
        """Deterministic encode -> decode through the whole stack (the tied
        W^T down-pass)."""
        if not self.layers:
            raise RuntimeError("DBN.reconstruct called before train")
        return reconstruct_stack(self._generative_layers(), self._as_input(v))

    def generate(self, n_samples: int = 16, n_gibbs: int = 200, seed: int = 0,
                 draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Sample from the DBN: Gibbs in the top RBM, mean-field down-pass,
        with draws from a generator seeded ``seed`` on the model's device (or
        ``draws``, as ``ops.sample.generate_from_stack`` takes them)."""
        from ..ops.sample import generate_from_stack

        gen = torch.Generator(device=self.device).manual_seed(seed)
        return generate_from_stack(self._generative_layers(), n_samples, n_gibbs,
                                   generator=gen, draws=draws)

    def _generative_layers(self):
        """[(params, cfg)] of the down-pass, bottom-up: the tied weights
        (untied generative weights come with up-down fine-tuning, which is
        not ported)."""
        return [(r.params, r.cfg) for r in self.layers]

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

    @classmethod
    def load(cls, directory: str, device: Optional[torch.device | str] = None) -> "DBN":
        from ..config import load_config

        dbn = cls(load_config(os.path.join(directory, "dbn.config.json")), device=device)
        with open(os.path.join(directory, "stack.json")) as f:
            n = json.load(f)["n_layers"]
        dbn.layers = [RBM.load(os.path.join(directory, f"layer{l}"), dbn.device)
                      for l in range(n)]
        return dbn

"""User-facing RBM: ``train`` / ``transform`` on top of the PyTorch stack.

Port of ``mdbn_tpu/models/rbm.py``, with ``sample`` on ``ops/sample.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import RBMConfig, TrainRuntimeConfig
from ..core.rbm_math import RBMParams, free_energy, noise_scale, torch_dtype
from ..core.state import TrainState, default_device, init_train_state
from ..ops import transform as tops
from ..train.trainer import EpochMetrics, train_rbm


class RBM:
    """Restricted Boltzmann machine (Bernoulli or Gaussian-Bernoulli visible).

    >>> rbm = RBM(RBMConfig(n_visible=784, n_hidden=500, epochs=5))
    >>> rbm.train(data)              # data: [n_samples, 784]
    >>> codes = rbm.transform(data)  # mean-field hidden probabilities

    ``device`` defaults to the CUDA card (``device="cpu"`` asks for the CPU);
    a given ``state`` (e.g. a checkpoint restore) is moved there and counts
    as trained.
    """

    def __init__(self, cfg: RBMConfig, generator: Optional[torch.Generator] = None,
                 state: Optional[TrainState] = None,
                 device: Optional[torch.device | str] = None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else (
            state.device if state is not None else default_device())
        if state is not None:
            state = TrainState(params=state.params.map(lambda t: t.to(self.device)),
                               velocity=state.velocity.map(lambda t: t.to(self.device)),
                               chain_h=state.chain_h.to(self.device),
                               generator=state.generator, epoch=state.epoch)
        self.state: TrainState = (state if state is not None
                                  else init_train_state(cfg, generator, self.device))
        self.metrics: Optional[EpochMetrics] = None
        # a fresh random init is not trained: transform() on it would hand
        # back noise codes
        self._trained = state is not None

    # -- reference API ------------------------------------------------------

    def train(self, data, mesh=None, runtime: Optional[TrainRuntimeConfig] = None,
              epoch_callback=None) -> "RBM":
        """``mesh``: a ``parallel.mesh.Mesh`` of more than one rank trains
        data-parallel; every rank calls ``train`` with the same data."""
        self.state, self.metrics = train_rbm(data, self.cfg, state=self.state,
                                             runtime=runtime,
                                             epoch_callback=epoch_callback, mesh=mesh)
        self._trained = True
        return self

    def transform(self, v) -> torch.Tensor:
        if not self._trained:
            raise RuntimeError(
                "RBM.transform called before train(): the codes would be "
                "random-init noise. Call train(data) first (or construct "
                "with state= from a checkpoint).")
        return tops.transform(self.params, self._as_input(v), self.cfg)

    # -- extras -------------------------------------------------------------

    def reconstruct(self, v) -> torch.Tensor:
        return tops.reconstruct(self.params, self._as_input(v), self.cfg)

    @torch.no_grad()
    def free_energy(self, v) -> torch.Tensor:
        return free_energy(self.params, self._as_input(v), self.cfg)

    def free_energy_gap(self, train_v, valid_v) -> float:
        """Overfitting monitor (Hinton's practical guide): the mean free
        energy of held-out rows minus that of training rows. It grows as the
        model overfits (the unknown log Z cancels in the difference)."""
        return float(self.free_energy(valid_v).mean() - self.free_energy(train_v).mean())

    def sample(self, n_samples: int = 16, n_gibbs: int = 200, v_init=None, seed: int = 0,
               draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Generate samples by prolonged Gibbs chains ("daydreaming") from a
        uniform binary start (or ``v_init``), with draws from a generator
        seeded ``seed`` on the model's device (or ``draws``, as
        ``ops.sample.gibbs_sample`` takes them). Returns mean-field visible
        probabilities [n_samples, n_visible]."""
        from ..ops.sample import gibbs_sample

        gen = torch.Generator(device=self.device).manual_seed(seed)
        if v_init is None:
            v_init = (torch.rand((n_samples, self.cfg.n_visible), generator=gen,
                                 device=self.device) < 0.5).float()
        vmean, _ = gibbs_sample(self.params, self._as_input(v_init), self.cfg, n_gibbs,
                                generator=gen, draws=draws)
        return vmean

    def _as_input(self, v) -> torch.Tensor:
        return torch.as_tensor(v).to(device=self.device,
                                     dtype=torch_dtype(self.cfg.param_dtype))

    @property
    def params(self) -> RBMParams:
        return self.state.params

    @property
    def history(self) -> list:
        return list(self.metrics.errors) if self.metrics else []

    @property
    def sigma(self) -> Optional[torch.Tensor]:
        """[n_visible] learned visible standard deviations exp(z/2), in
        float32; None unless ``cfg.learn_variance``."""
        return noise_scale(self.params)

    def params_numpy(self) -> dict:
        return {k: v.detach().float().cpu().numpy()
                for k, v in self.state.params.as_dict().items()}

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Save the full train state (``path``) + its config JSON next to it."""
        from ..checkpoint import save_state
        from ..config import save_config

        save_state(self.state, path)
        save_config(self.cfg, path.rstrip("/") + ".config.json")

    @classmethod
    def load(cls, path: str, device: Optional[torch.device | str] = None) -> "RBM":
        from ..checkpoint import restore_state
        from ..config import load_config

        return cls(load_config(path.rstrip("/") + ".config.json"),
                   state=restore_state(path, device), device=device)

"""The draws of one step of a phase-2 trainer, injected or from a generator.

The phase-2 trainers (``train/labeled.py``, ``train/updown.py``) sample
Bernoulli units as ``u < p`` and the softmax label block by Gumbel-max, as
the JAX package does, so every draw is a uniform (or, for a sampled Gaussian
visible layer, a standard normal) of the whole minibatch's shape. A step's
draws are named (``"h0"``, ``"code0"``, ``"wake1"``, ...; each trainer lists
its names): injected as a dict of [batch, n] arrays, so a test can feed the
JAX function's own draws, or drawn from a ``torch.Generator`` in the order
the step asks for them. A name missing from an injected dict is drawn from
the generator and written into the dict, so a run given empty dicts hands
back every draw it made, to replay the run elsewhere (on another device, say).
Under a mesh every rank draws the whole minibatch's values from the same
seeded generator and keeps its own rows, so the ranks together sample what
one device would.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

GUMBEL_LOW = 1e-20  # the label block's uniforms lie in [1e-20, 1)


class StepDraws:
    """One step's draws for rows ``rows`` of a minibatch of ``batch`` rows:
    from ``given`` ({name: [batch, n]}) where it holds the name, else drawn
    from ``generator`` on ``device`` at the whole minibatch's shape (and
    written into ``given`` when there is one)."""

    def __init__(self, given: Optional[Dict[str, torch.Tensor]],
                 generator: Optional[torch.Generator], device: torch.device,
                 batch: int, rows: slice = slice(None)):
        self.given, self.gen, self.device = given, generator, device
        self.batch, self.rows = batch, rows

    def _take(self, name: str, draw) -> torch.Tensor:
        if self.given is not None and name in self.given:
            u = torch.as_tensor(self.given[name]).to(device=self.device, dtype=torch.float32)
        else:
            u = draw()
            if self.given is not None:
                self.given[name] = u
        return u[self.rows]

    def uniform(self, name: str, n: int, low: float = 0.0) -> torch.Tensor:
        def draw():
            u = torch.rand((self.batch, n), generator=self.gen, device=self.device)
            return u.clamp_min(low) if low else u

        return self._take(name, draw)

    def normal(self, name: str, n: int) -> torch.Tensor:
        return self._take(name, lambda: torch.randn((self.batch, n), generator=self.gen,
                                                    device=self.device))

    def gumbel(self, name: str, n: int) -> torch.Tensor:
        """Standard Gumbel noise [batch, n], -log(-log u) of uniforms u in
        [tiny, 1) (a resample's draw: it is injected as the noise itself)."""
        def draw():
            u = torch.rand((self.batch, n), generator=self.gen, device=self.device)
            return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))

        return self._take(name, draw)

    def bern(self, name: str, p: torch.Tensor) -> torch.Tensor:
        """A Bernoulli sample of the probabilities ``p`` [rows, n]."""
        return (self.uniform(name, p.shape[1]) < p).float()

    def softmax(self, name: str, logits: torch.Tensor) -> torch.Tensor:
        """A one-hot categorical sample a row of ``logits`` [rows, C]."""
        return softmax_sample(self.uniform(name, logits.shape[1], GUMBEL_LOW), logits)


def softmax_sample(u: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One-hot categorical sample per row by Gumbel-max on uniforms ``u`` in
    [1e-20, 1) (``mdbn_tpu/train/labeled.py::_softmax_sample``)."""
    g = -torch.log(-torch.log(u))
    return F.one_hot(torch.argmax(logits + g, dim=1), logits.shape[1]).float()


def step_draws(draws, e: int, i: int, generator: Optional[torch.Generator],
               device: torch.device, batch: int, rows: slice = slice(None)) -> StepDraws:
    """Epoch ``e``, step ``i`` of a trainer's ``draws`` (a list over epochs of
    lists over steps of {name: [batch, n]}), completed from ``generator``."""
    return StepDraws(None if draws is None else draws[e][i], generator, device, batch, rows)


def whole_draw(draws: Optional[dict], name: str, draw) -> torch.Tensor:
    """A draw of the whole run (an initial weight matrix, say): ``draws[name]``
    where given, else ``draw()``, written into ``draws`` when there is one."""
    if draws is not None and name in draws:
        return draws[name]
    z = draw()
    if draws is not None:
        draws[name] = z
    return z


def generator_for(device: torch.device, seed: int,
                  generator: Optional[torch.Generator] = None) -> torch.Generator:
    """``generator``, or a new one on ``device`` seeded with ``seed``."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(int(seed))

"""Plain PyTorch reference of one RBM fit by CD-k, as the benchmark's jobs run it.

It reads only the configuration file's numbers, the data the benchmark made
and the job's seed, and works out again everything the measured program
derives from them: the initial weights (``init_scale`` times a normal draw
from a CPU ``torch.Generator`` seeded with the job's seed), the 64-bit seed of
each kernel launch (the next draw from that generator: one for a fused fit,
one an epoch for a fit with a per-epoch callback) and every Bernoulli draw of
every update (``philox``). It imports nothing of the program.

``fit`` replays a whole fit from the start; ``last_update`` follows the last
update of a fit from the state before it, which it recovers from the fit's
outputs (with momentum 0 the velocity holds the last update's step). Products
run in float32 with TF32 off; ``compute`` / ``storage`` "bfloat16" round the
operands of every product / the stored state to bfloat16 (the control).
"""

from __future__ import annotations

import contextlib
import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import philox

_M64 = (1 << 64) - 1


@dataclass(frozen=True)
class Spec:
    """The numbers of a configuration file that a fit depends on."""

    n_visible: int
    n_hidden: int
    visible: str
    batch_size: int
    epochs: int
    lr: float
    momentum: float = 0.0
    l2: float = 0.0
    k: int = 1
    init_scale: float = 0.01
    sample_visible: Optional[bool] = None

    @classmethod
    def from_config(cls, cfg: Dict) -> "Spec":
        unsupported = {key: cfg[key] for key, off in (
            ("persistent", False), ("pt_temps", 1), ("gradient", "plain"),
            ("learn_variance", False), ("grad_clip", None), ("sparsity_target", None),
            ("initial_momentum", None), ("shuffle", False), ("error_metric", "mse"),
            ("init", "normal")) if cfg.get(key, off) != off}
        if unsupported:
            raise ValueError(f"the reference runs plain CD with an mse monitor in order; "
                             f"not {unsupported}")
        names = cls.__dataclass_fields__
        return cls(**{key: cfg[key] for key in names if key in cfg})

    @property
    def sampled_visibles(self) -> bool:
        return (self.visible == "bernoulli" if self.sample_visible is None
                else self.sample_visible)


@dataclass
class FitOutputs:
    """What a fit hands back: parameters, their velocities, per-epoch errors."""

    W: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    vW: torch.Tensor
    vb: torch.Tensor
    vc: torch.Tensor
    errs: List[float]

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {"W": self.W, "b": self.b, "c": self.c}

    def velocities(self) -> Dict[str, torch.Tensor]:
        return {"W": self.vW, "b": self.vb, "c": self.vc}

    def to(self, device) -> "FitOutputs":
        return FitOutputs(*(t.detach().to(device=device, dtype=torch.float32)
                            for t in (self.W, self.b, self.c, self.vW, self.vb, self.vc)),
                          list(self.errs))


@contextlib.contextmanager
def no_tf32():
    """Float32 products as float32 on the card (TF32 off), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def initial_weights(spec: Spec, gen: torch.Generator) -> torch.Tensor:
    """W at the start of a fit: ``init_scale`` times a [V, H] normal draw."""
    return spec.init_scale * torch.randn((spec.n_visible, spec.n_hidden), generator=gen)


def launch_seed(gen: torch.Generator) -> int:
    """The 64-bit seed of one kernel launch: one draw from the fit's generator."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


@dataclass(frozen=True)
class Stream:
    """How the program draws a fit's randomness from the job's generator: after
    the initial weights, one seed a launch (``per_epoch``: one launch an epoch,
    else one for the fit), each update's draws keyed by its index in the fit;
    or, data-parallel over ``ranks`` cards, one seed a step (an [epochs, nb]
    draw), rank r drawing its rows under ``fold_in(step seed, r)`` with update
    index 0."""

    per_epoch: bool = False
    ranks: int = 1


def fold_in(seed: int, rank: int) -> int:
    """A rank's 64-bit seed from a step's seed (splitmix64 of the pair)."""
    z = (seed + (rank + 1) * 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def job_stream(spec: Spec, job_seed: int, stream: Stream, nb: int, device):
    """(initial W on the CPU, ``draws(epoch)``) of a job: ``draws`` gives that
    epoch's draws, h0 [nb, B, H], v [k][nb, B, V] (sampled visibles) and h
    [k - 1][nb, B, H] (the Gibbs steps' hidden draws a later step reads), rows
    in the global minibatch's order."""
    gen = torch.Generator().manual_seed(job_seed)
    W0 = initial_weights(spec, gen)
    H, V, k, B = spec.n_hidden, spec.n_visible, spec.k, spec.batch_size
    kinds = [("h0", philox.KIND_H0, 0, H)]
    kinds += [("v", philox.KIND_V, t, V) for t in range(k) if spec.sampled_visibles]
    kinds += [("h", philox.KIND_H, t, H) for t in range(k - 1)]

    def collect(make) -> Dict:
        u: Dict = {"v": [], "h": []}
        for name, kind, t, cols in kinds:
            x = make(kind, t, cols)
            if name == "h0":
                u["h0"] = x
            else:
                u[name].append(x)
        return u

    if stream.ranks == 1:
        seeds = ([launch_seed(gen) for _ in range(spec.epochs)] if stream.per_epoch
                 else [launch_seed(gen)] * spec.epochs)

        def draws(e: int) -> Dict:
            upd = torch.arange(e * nb, (e + 1) * nb, dtype=torch.int64, device=device)
            return collect(lambda kind, t, cols: philox.uniforms([seeds[e]], upd, kind, t, B, cols,
                                                                 device))
        return W0, draws
    if B % stream.ranks:
        raise ValueError(f"the reference splits a minibatch of {B} evenly over the ranks")
    local = B // stream.ranks
    step_seeds = torch.randint(0, 2 ** 62, (spec.epochs, nb), generator=gen).tolist()

    def draws(e: int) -> Dict:
        keys = [fold_in(step_seeds[e][i], r) for i in range(nb) for r in range(stream.ranks)]
        return collect(lambda kind, t, cols: philox.uniforms(
            keys, 0, kind, t, local, cols, device).reshape(nb, B, cols))
    return W0, draws


def _store(storage: str):
    if storage == "bfloat16":
        return lambda t: t.to(torch.bfloat16).to(torch.float32)
    return lambda t: t


def _mm(a: torch.Tensor, b: torch.Tensor, compute: str) -> torch.Tensor:
    if compute == "bfloat16":
        a, b = a.to(torch.bfloat16).to(a.dtype), b.to(torch.bfloat16).to(b.dtype)
    return a @ b


def _visible_mean(spec: Spec, h, W, b, compute: str):
    pre = _mm(h, W.T, compute) + b
    return torch.sigmoid(pre) if spec.visible == "bernoulli" else pre


def fit(spec: Spec, data: torch.Tensor, job_seed: int, stream: Stream = Stream(),
        compute: str = "float32", storage: str = "float32",
        fault: Optional[str] = None) -> FitOutputs:
    """A whole fit from the start on ``data``'s device: ``spec.epochs`` epochs
    over the minibatches in order. ``fault`` plants one fault for the tests of
    the comparison: "unchanged" (no update changes the state), "half_batch"
    (each update reads only the first half of its minibatch and averages over
    it), "altered" (hidden unit 0's weights handed back as they started),
    "no_exchange" (data-parallel: the first rank's rows alone make each
    update, as when the ranks' statistics are never exchanged)."""
    device = data.device
    rnd = _store(storage)
    B, V, H = spec.batch_size, spec.n_visible, spec.n_hidden
    nb = data.shape[0] // B
    rows = {"half_batch": B // 2, "no_exchange": B // stream.ranks}.get(fault, B)
    batches = rnd(data[: nb * B].float()).reshape(nb, B, V)[:, :rows]
    W0, epoch_draws = job_stream(spec, job_seed, stream, nb, device)
    W = rnd(W0.to(device))
    b = torch.zeros(V, device=device)
    c = torch.zeros(H, device=device)
    vW, vb, vc = torch.zeros_like(W), torch.zeros_like(b), torch.zeros_like(c)
    errs = []
    with no_tf32():
        for e in range(spec.epochs):
            u = epoch_draws(e)
            err_sum = torch.zeros((), device=device)
            for i in range(nb):
                v0 = batches[i]
                h0p = torch.sigmoid(_mm(v0, W, compute) + c)
                h = (u["h0"][i, :rows] < h0p).float()
                for t in range(spec.k):
                    vm = _visible_mean(spec, h, W, b, compute)
                    if t == 0:
                        err_sum += torch.mean((v0 - vm) ** 2)
                    vs = (u["v"][t][i, :rows] < vm).float() if spec.sampled_visibles else vm
                    hm = torch.sigmoid(_mm(vs, W, compute) + c)
                    if t + 1 < spec.k:
                        h = (u["h"][t][i, :rows] < hm).float()
                if fault == "unchanged":
                    continue
                gW = (_mm(v0.T, h0p, compute) - _mm(vs.T, hm, compute)) / rows
                gb = (v0 - vs).mean(0)
                gc = (h0p - hm).mean(0)
                vW = rnd(spec.momentum * vW + spec.lr * (gW - spec.l2 * W))
                vb = rnd(spec.momentum * vb + spec.lr * gb)
                vc = rnd(spec.momentum * vc + spec.lr * gc)
                W, b, c = rnd(W + vW), rnd(b + vb), rnd(c + vc)
            errs.append(err_sum / nb)
    if fault == "altered":
        W = W.clone()
        W[:, 0] = rnd(W0[:, 0].to(device))
    return FitOutputs(W, b, c, vW, vb, vc, [float(x) for x in torch.stack(errs).tolist()])


def last_update(spec: Spec, data: torch.Tensor, job_seed: int, stream: Stream,
                out: FitOutputs, ambiguity: float, max_flips: int) -> Tuple[float, str, int]:
    """Follow the last update of a fit from the state before it, recovered as
    each parameter less its velocity (momentum 0), in float64, and compare the
    fit's velocities with the reference's step: (the worst leaf's gap, that
    leaf, the draws taken both ways). A leaf's gap is the norm of the
    difference over the larger of the reference step's norm on that leaf and
    the median leaf's. A draw within ``ambiguity`` of its probability may fall
    either way under float32 rounding, so the reference takes each such draw
    both ways (the ``max_flips`` closest to their thresholds, in every
    combination) and keeps the branch closest to the fit."""
    if spec.momentum != 0.0 or spec.k != 1:
        raise ValueError("the last update is recovered from the velocity at momentum 0, k 1")
    device, f64 = data.device, torch.float64
    B, V, H = spec.batch_size, spec.n_visible, spec.n_hidden
    nb = data.shape[0] // B
    _, epoch_draws = job_stream(spec, job_seed, stream, nb, device)
    last = epoch_draws(spec.epochs - 1)
    u_h0 = last["h0"][nb - 1].to(f64)
    u_v = last["v"][0][nb - 1].to(f64) if spec.sampled_visibles else None
    lr, l2 = spec.lr, spec.l2
    W, b, c = (out.W.to(f64) - out.vW.to(f64), out.b.to(f64) - out.vb.to(f64),
               out.c.to(f64) - out.vc.to(f64))
    v0 = data[(nb - 1) * B: nb * B].to(f64)
    got = {name: t.to(f64) for name, t in out.velocities().items()}
    h0p = torch.sigmoid(v0 @ W + c)
    best = (float("inf"), "", 0)
    for h0s, n_h in _branches(u_h0, h0p, ambiguity, max_flips):
        vm = _visible_mean(spec, h0s, W, b, "float32")
        if u_v is None:
            options = [(vm, 0)]
        else:
            options = _branches(u_v, vm, ambiguity, max(0, max_flips - n_h))
        for vs, n_v in options:
            hm = torch.sigmoid(vs @ W + c)
            want = {"W": lr * ((v0.T @ h0p - vs.T @ hm) / B - l2 * W),
                    "b": lr * (v0 - vs).mean(0), "c": lr * (h0p - hm).mean(0)}
            gap, leaf = leaf_gap(got, want)
            if gap < best[0]:
                best = (gap, leaf, n_h + n_v)
    return best


def _branches(u: torch.Tensor, p: torch.Tensor, ambiguity: float, max_flips: int):
    """Each way the samples (u < p) can fall when the draws within
    ``ambiguity`` of p (the ``max_flips`` closest) may fall either way:
    (samples, draws taken both ways)."""
    base = (u < p).to(p.dtype)
    margin = (u - p).abs().flatten()
    near = torch.nonzero(margin < ambiguity).flatten()
    near = near[torch.argsort(margin[near])][:max_flips].tolist()
    for flips in itertools.product((False, True), repeat=len(near)):
        s = base.clone().flatten()
        for idx, flip in zip(near, flips):
            if flip:
                s[idx] = 1.0 - s[idx]
        yield s.reshape(base.shape), len(near)


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             base: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[float, str]:
    """The worst leaf's gap between ``got`` and ``want``: the norm of their
    difference over the larger of the norm of ``want`` (less ``base``, where
    given) on that leaf and the median leaf's such norm."""
    scale = {name: float(torch.linalg.vector_norm(
        (want[name] - base[name]) if base else want[name])) for name in want}
    median = sorted(scale.values())[len(scale) // 2]
    gaps = {name: float(torch.linalg.vector_norm(got[name].double() - want[name].double()))
            / max(scale[name], median, 1e-30) for name in want}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf

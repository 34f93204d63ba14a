"""Associative label-top RBM: the Hinton-Osindero-Teh 2006 generative classifier.

Port of ``mdbn_tpu/train/labeled.py``. The top RBM's visible layer is the
concatenation [penultimate code ; one-hot label], so it learns a joint
associative memory over codes and classes: free-energy classification
p(y | v) ∝ exp(-F_top([code(v); e_y])), and a class-conditional generative
model (clamp the label, Gibbs in the top, dream down). During CD the label
block is sampled as a softmax group (Gumbel-max), not as independent
Bernoullis. Rows labeled -1 are unlabeled: their positive-phase label block
is drawn from the exact posterior p(y | code) under the current parameters
(stochastic-EM CD on the marginal).

The reference runs one jitted ``lax.scan`` an epoch, with no Pallas kernel;
here an eager loop on the parameters' device, the per-step errors kept on
the device and read once an epoch. The draws of a step (``train/draws.py``)
are named as the reference splits its key into ``3k + 1 + semi`` keys:
``"h0"`` (keys[0]), ``"code{t}"`` (keys[3t+1]), ``"label{t}"`` (keys[3t+2],
uniforms in [1e-20, 1)), ``"h{t+1}"`` (keys[3t+3]) and, for a run with
unlabeled rows, ``"fill"`` (keys[3k+1]); ``draws={"init": [V, H] normals,
"steps": [epoch][step] {name: [batch, n]}}`` injects them. What ``draws``
does not hold comes from a generator seeded ``seed`` on the device (another
stream than the reference's ``PRNGKey(seed)``) and is written into it.
Under a ``mesh`` each rank takes its rows of every minibatch and the
statistics are all-reduced before each update
(``parallel/dp.py::finetune_rows``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RBMConfig
from ..core.rbm_math import RBMParams
from ..core.state import default_device
from ..ops.sample import down_pass
from ..ops.transform import stack_transform
from .draws import (GUMBEL_LOW, StepDraws, generator_for, softmax_sample, step_draws,
                    whole_draw)
from .finetune import _rows

Layers = Sequence[Tuple[RBMParams, RBMConfig]]


def _class_logits(params: RBMParams, codes: torch.Tensor, n_code: int) -> torch.Tensor:
    """The class-dependent part of -F([codes ; e_y]) for every y: [B, C].
    Softmaxing it gives the exact posterior p(y | code) (the code-bias term
    is the same for every class and cancels)."""
    Wc, Wl = params.W[:n_code], params.W[n_code:]
    pre = codes @ Wc + params.c
    hid = F.softplus(pre[:, None, :] + Wl[None, :, :]).sum(dim=2)
    return params.b[n_code:][None, :] + hid


def _posterior_label_fill(u: torch.Tensor, params: RBMParams, codes: torch.Tensor,
                          onehot: torch.Tensor, mask: torch.Tensor, n_code: int) -> torch.Tensor:
    """The label block under partial labels: the true one-hot where ``mask``
    is 1, a posterior sample y ~ p(y | code) (on uniforms ``u``) where 0."""
    y_s = softmax_sample(u, _class_logits(params, codes, n_code))
    return torch.where(mask[:, None] > 0, onehot, y_s)


def _validate_partial_labels(labels, n_classes: int) -> Tuple[np.ndarray, bool]:
    """Validate class labels where -1 means unlabeled. Returns (int64
    labels, semi) with semi True when any row is unlabeled."""
    labels = np.asarray(labels).astype(np.int64)
    if labels.ndim != 1:
        raise ValueError(f"labels must be 1-D class indices, got {labels.shape}")
    lo, hi = int(labels.min()), int(labels.max())
    if lo < -1 or hi >= n_classes:
        raise ValueError(f"labels out of range for n_classes={n_classes} "
                         "(use -1 for unlabeled rows)")
    if hi < 0:
        raise ValueError("every label is -1 (unlabeled) — semi-supervised "
                         "training needs at least one labeled row; for a "
                         "fully unsupervised top, train a plain RBM on the "
                         "codes instead")
    return labels, lo < 0


def _one_hot(labels: np.ndarray, n_classes: int, device) -> torch.Tensor:
    """One-hot rows, all zeros for -1 (unlabeled), as ``jax.nn.one_hot``."""
    lab = torch.as_tensor(labels, device=device)
    return F.one_hot(lab.clamp_min(0), n_classes).float() * (lab >= 0).float()[:, None]


def label_top_chain(top: RBMParams, vt: torch.Tensor, d: StepDraws, n_code: int, k: int):
    """CD-k in the associative top from ``vt`` = [code ; label]: the code
    block sampled as Bernoullis, the label block as a softmax group.
    Returns (h0p, vneg, hkp, h), the last hidden sample included."""
    h0p = torch.sigmoid(vt @ top.W + top.c)
    h = d.bern("h0", h0p)
    vneg, hkp = vt, h0p
    for t in range(k):
        pre = h @ top.W.T + top.b
        code_s = d.bern(f"code{t}", torch.sigmoid(pre[:, :n_code]))
        label_s = d.softmax(f"label{t}", pre[:, n_code:])
        vneg = torch.cat([code_s, label_s], dim=1)
        hkp = torch.sigmoid(vneg @ top.W + top.c)
        h = d.bern(f"h{t + 1}", hkp)
    return h0p, vneg, hkp, h


def cd_sums(vt, h0p, vneg, hkp) -> List[torch.Tensor]:
    """The CD statistics summed over this rank's rows: [gW, gb, gc]."""
    return [vt.T @ h0p - vneg.T @ hkp, (vt - vneg).sum(0), (h0p - hkp).sum(0)]


@torch.no_grad()
def _label_top_epoch(carry, codes_b, onehot_b, mask_b, n_code, lr, k, momentum, l2,
                     batch_size, e, draws, gen, mesh) -> torch.Tensor:
    """One epoch of CD-k on the associative top; updates ``carry`` = [params,
    velocity] in place and returns this rank's share of each step's
    code-block reconstruction mse [nb]."""
    from ..parallel.dp import all_reduce_sums, finetune_rows

    rows = finetune_rows(mesh, batch_size)
    errs = []
    for i in range(codes_b.shape[0]):
        p, vel = carry
        d = step_draws(draws, e, i, gen, codes_b.device, batch_size, rows)
        codes, onehot = codes_b[i, rows], onehot_b[i, rows]
        if mask_b is not None:
            onehot = _posterior_label_fill(d.uniform("fill", onehot.shape[1], GUMBEL_LOW), p,
                                           codes, onehot, mask_b[i, rows], n_code)
        v0 = torch.cat([codes, onehot], dim=1)
        h0p, vneg, hkp, h = label_top_chain(p, v0, d, n_code, k)
        gW, gb, gc = (g / batch_size for g in all_reduce_sums(cd_sums(v0, h0p, vneg, hkp), mesh))
        vel = RBMParams(W=momentum * vel.W + lr * (gW - l2 * p.W),
                        b=momentum * vel.b + lr * gb, c=momentum * vel.c + lr * gc)
        p = RBMParams(W=p.W + vel.W, b=p.b + vel.b, c=p.c + vel.c)
        r = v0[:, :n_code] - torch.sigmoid((h @ p.W.T + p.b)[:, :n_code])
        errs.append((r * r).sum() / (batch_size * n_code))
        carry[:] = [p, vel]
    return torch.stack(errs)


def fit_label_top(layers: Layers, data, labels, n_classes: int, n_hidden: int = 64,
                  epochs: int = 20, lr: float = 0.1, k: int = 1, batch_size: int = 20,
                  momentum: float = 0.0, l2: float = 0.0, seed: int = 0,
                  params: Optional[RBMParams] = None, mesh=None, device=None,
                  generator: Optional[torch.Generator] = None, draws: Optional[dict] = None
                  ) -> Tuple[RBMParams, List[float]]:
    """Train the associative top RBM over [stack codes ; one-hot labels].
    ``layers`` is the pretrained stack (may be empty: the RBM then sits on
    the data). Pass a previous run's ``params`` to resume. Returns (top
    RBMParams with W [n_code + n_classes, n_hidden], per-epoch code-block
    reconstruction mse). Rows labeled -1 train semi-supervised."""
    from ..parallel.dp import all_reduce_sums

    labels, semi = _validate_partial_labels(labels, n_classes)
    if device is None:  # the stack's, else the data's or the resumed top's, else the card
        device = (layers[0][0].W.device if layers else data.device if torch.is_tensor(data)
                  else params.W.device if params is not None else default_device())
    device = torch.device(device)
    x = _rows(data, device)
    codes = stack_transform(list(layers), x).float() if layers else x
    if codes.shape[0] != labels.shape[0]:
        raise ValueError(f"data rows {codes.shape[0]} != labels {labels.shape[0]}")
    n_code = codes.shape[1]
    n = (codes.shape[0] // batch_size) * batch_size
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"dataset has {codes.shape[0]} samples — fewer than "
                         f"one minibatch (batch_size={batch_size})")
    onehot = _one_hot(labels, n_classes, device)
    codes_b = codes[:n].reshape(nb, batch_size, n_code)
    onehot_b = onehot[:n].reshape(nb, batch_size, n_classes)
    mask_b = (torch.as_tensor(labels[:n] >= 0, device=device).float().reshape(nb, batch_size)
              if semi else None)
    gen = generator_for(device, seed, generator)
    V = n_code + n_classes
    if params is None:
        z = torch.as_tensor(whole_draw(draws, "init", lambda: torch.randn(
            (V, n_hidden), generator=gen, device=device))).to(device=device, dtype=torch.float32)
        params = RBMParams(W=0.01 * z, b=torch.zeros(V, device=device),
                           c=torch.zeros(n_hidden, device=device))
    elif tuple(params.W.shape) != (V, n_hidden):
        raise ValueError(f"resume params have W {tuple(params.W.shape)}, expected "
                         f"{(V, n_hidden)}")
    params = RBMParams(W=params.W, b=params.b, c=params.c).map(
        lambda t: torch.as_tensor(t).to(device=device, dtype=torch.float32))
    carry = [params, RBMParams(W=torch.zeros_like(params.W), b=torch.zeros_like(params.b),
                               c=torch.zeros_like(params.c))]
    steps = None if draws is None else draws["steps"]
    history = []
    for e in range(epochs):
        errs = _label_top_epoch(carry, codes_b, onehot_b, mask_b, n_code, float(lr), int(k),
                                float(momentum), float(l2), batch_size, e, steps, gen, mesh)
        history.append(float(all_reduce_sums([errs], mesh)[0].mean()))
    return carry[0], history


@torch.no_grad()
def _class_neg_free_energy(params: RBMParams, codes: torch.Tensor, n_code: int) -> torch.Tensor:
    """-F([codes ; e_y]) for every class y in one broadcast pass: [N, C]."""
    Wc, Wl = params.W[:n_code], params.W[n_code:]
    bc, bl = params.b[:n_code], params.b[n_code:]
    pre = codes @ Wc + params.c
    hid = F.softplus(pre[:, None, :] + Wl[None, :, :]).sum(dim=2)
    return codes @ bc[:, None] + bl[None, :] + hid


@torch.no_grad()
def label_top_logits(params: RBMParams, layers: Layers, x, n_classes: int) -> torch.Tensor:
    """Unnormalised log p(y | x) = -F_top([code(x); e_y]) for every class;
    softmaxing them gives the exact class posterior."""
    xs = _rows(x, params.W.device)
    codes = stack_transform(list(layers), xs).float() if layers else xs
    n_code = params.W.shape[0] - n_classes
    if codes.shape[1] != n_code:
        raise ValueError(f"codes width {codes.shape[1]} != model's {n_code}")
    return _class_neg_free_energy(params, codes, n_code)


def predict_label_top(params: RBMParams, layers: Layers, x, n_classes: int) -> torch.Tensor:
    """argmax_y -F_top([code(x); e_y]): free-energy classification."""
    return torch.argmax(label_top_logits(params, layers, x, n_classes), dim=1)


def _dream_draw(draws, name, t, shape, gen, device, low=0.0) -> torch.Tensor:
    if draws is not None:
        u = draws[name] if t is None else draws[name][t]
        return torch.as_tensor(u).to(device=device, dtype=torch.float32)
    u = torch.rand(shape, generator=gen, device=device)
    return u.clamp_min(low) if low else u


@torch.no_grad()
def _dream(params: RBMParams, code: torch.Tensor, label: torch.Tensor, n_code: int,
           n_gibbs: int, gen, draws, clamped: bool) -> torch.Tensor:
    """Gibbs over (code, hidden) in the associative top, the label block
    softmax-sampled each step unless ``clamped``; returns the last step's
    code-block mean."""
    device, n, C = code.device, code.shape[0], label.shape[1]
    cm = code
    for t in range(n_gibbs):
        v = torch.cat([code, label], dim=1)
        hp = torch.sigmoid(v @ params.W + params.c)
        h = (_dream_draw(draws, "h", t, hp.shape, gen, device) < hp).float()
        pre = h @ params.W.T + params.b
        cm = torch.sigmoid(pre[:, :n_code])
        code = (_dream_draw(draws, "code", t, cm.shape, gen, device) < cm).float()
        if not clamped:
            label = softmax_sample(_dream_draw(draws, "label", t, (n, C), gen, device,
                                               GUMBEL_LOW), pre[:, n_code:])
    return cm


def _down_all(layers: Layers, code_mean: torch.Tensor) -> torch.Tensor:
    """The mean-field down-pass through every layer of ``layers`` (bottom-up)."""
    return down_pass(list(reversed(list(layers))), code_mean) if layers else code_mean


@torch.no_grad()
def generate_labeled_model(params: RBMParams, layers: Layers, n_classes: int,
                           n_samples: int = 16, n_gibbs: int = 200, seed: int = 0,
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Unconditional dreams from the complete labeled model (after labeled
    up-down every stack layer is directed and the label top is the only
    undirected module): Gibbs over (code, label, hidden) in the top with the
    label block softmax-sampled, then the mean-field down-pass through all
    of ``layers``' generative weights. ``draws``: {"init": [n, n_code],
    "init_label": [n, C] (in [1e-20, 1)), "h": [S, n, H], "code": [S, n,
    n_code], "label": [S, n, C]}. Returns [n_samples, n_visible_bottom]."""
    device = params.W.device
    n_code = params.W.shape[0] - n_classes
    gen = None if draws is not None else generator_for(device, seed, generator)
    code = (_dream_draw(draws, "init", None, (n_samples, n_code), gen, device) < 0.5).float()
    label = softmax_sample(_dream_draw(draws, "init_label", None, (n_samples, n_classes), gen,
                                       device, GUMBEL_LOW),
                           torch.zeros((n_samples, n_classes), device=device))
    cm = _dream(params, code, label, n_code, int(n_gibbs), gen, draws, clamped=False)
    return _down_all(layers, cm)


@torch.no_grad()
def generate_class_conditional(params: RBMParams, layers: Layers, label: int, n_classes: int,
                               n_samples: int = 16, n_gibbs: int = 200, seed: int = 0,
                               generator: Optional[torch.Generator] = None,
                               draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """Dream inputs of one class: clamp the label block to e_y, Gibbs over
    (code, hidden) in the top RBM, then the mean-field down-pass through the
    stack's generative weights. ``draws``: {"init", "h", "code"} as
    ``generate_labeled_model`` takes them. Returns [n_samples,
    n_visible_bottom]."""
    if not 0 <= label < n_classes:
        raise ValueError(f"label {label} out of range for {n_classes} classes")
    device = params.W.device
    n_code = params.W.shape[0] - n_classes
    gen = None if draws is not None else generator_for(device, seed, generator)
    onehot = F.one_hot(torch.full((n_samples,), label, device=device), n_classes).float()
    code = (_dream_draw(draws, "init", None, (n_samples, n_code), gen, device) < 0.5).float()
    cm = _dream(params, code, onehot, n_code, int(n_gibbs), gen, draws, clamped=True)
    return _down_all(layers, cm)

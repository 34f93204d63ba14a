"""Supervised DBN fine-tuning: a softmax head and backprop through the stack.

Port of ``mdbn_tpu/train/finetune.py``. After greedy pretraining a
logistic-regression layer on the top code is trained with the stack by
softmax cross-entropy SGD, the minibatches walked in order (no shuffling).
The reference differentiates the stack with ``jax.grad`` inside one
``lax.scan`` an epoch, with no Pallas kernel; here ``torch.autograd`` does
it in an eager loop on the parameters' device. The per-step losses stay on
the device and are read once an epoch.

The head starts at ``0.01 * normal`` from a generator seeded ``seed`` on the
device, or from ``draws={"head": [top, n_classes]}``, the reference's own
normals. Under a ``mesh`` (``parallel.mesh.Mesh``) each rank takes its rows
of every minibatch and the gradients are all-reduced before the update, the
same math as one device (``parallel/dp.py::finetune_rows``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, hidden_mean
from .draws import generator_for, whole_draw

Layers = Sequence[Tuple[RBMParams, RBMConfig]]


def _batched(batch_size: int, n_rows: int) -> Tuple[int, int]:
    """(n_usable, n_batches) with the shared sub-batch guard."""
    n = (n_rows // batch_size) * batch_size
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"dataset has {n_rows} samples — fewer than one "
                         f"minibatch (batch_size={batch_size})")
    return n, nb


def _check_labels(labels, n_classes: int) -> None:
    """Out-of-range labels would train on the wrong class: validate on the host."""
    lab = np.asarray(labels)
    if lab.size and (lab.min() < 0 or lab.max() >= n_classes):
        raise ValueError(f"labels must be in [0, {n_classes}); got range "
                         f"[{lab.min()}, {lab.max()}]")


def _rows(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not torch.is_tensor(x) else x).to(
        device=device, dtype=torch.float32)


def _trainable(p: RBMParams) -> RBMParams:
    """A leaf copy of the parameters the up-pass reads (W, c and a learned
    variance's z), requiring gradients; b rides along unchanged."""
    def leaf(t):
        return None if t is None else t.detach().clone().requires_grad_(True)

    return RBMParams(W=leaf(p.W), b=p.b, c=leaf(p.c), z=leaf(p.z))


def _leaves(p: RBMParams) -> List[torch.Tensor]:
    return [t for t in (p.W, p.c, p.z) if t is not None]


def _detached(p: RBMParams) -> RBMParams:
    return p.map(lambda t: t.detach())


def _up(params: Sequence[RBMParams], cfgs: Sequence[RBMConfig], x: torch.Tensor) -> torch.Tensor:
    for p, cfg in zip(params, cfgs):
        x = hidden_mean(p, x, cfg)
    return x


def _init_head(top_width: int, n_classes: int, device, gen: torch.Generator,
               draws: Optional[Dict[str, torch.Tensor]]) -> List[torch.Tensor]:
    z = torch.as_tensor(whole_draw(draws, "head", lambda: torch.randn(
        (top_width, n_classes), generator=gen, device=device))).to(device=device,
                                                                  dtype=torch.float32)
    return [(0.01 * z).requires_grad_(True),
            torch.zeros(n_classes, device=device, requires_grad=True)]


def _sgd(leaves: List[torch.Tensor], logits_of, nb: int, labels_b: torch.Tensor,
         epochs: int, lr: float, batch_size: int, mesh) -> List[float]:
    """Softmax cross-entropy SGD over the ``nb`` minibatches in order, each
    epoch. ``logits_of(i, rows)`` gives minibatch i's logits on this rank's
    rows; the loss and gradients are this rank's share of the minibatch mean,
    all-reduced before every update."""
    from ..parallel.dp import all_reduce_sums, finetune_rows

    rows = finetune_rows(mesh, batch_size)
    history = []
    for _ in range(epochs):
        losses = []
        for i in range(nb):
            logp = torch.log_softmax(logits_of(i, rows), dim=1)
            y = labels_b[i, rows]
            loss = -logp.gather(1, y[:, None]).sum() / batch_size
            grads = all_reduce_sums([*torch.autograd.grad(loss, leaves), loss.detach()], mesh)
            with torch.no_grad():
                for p, g in zip(leaves, grads):
                    p -= lr * g
            losses.append(grads[-1])
        history.append(float(torch.stack(losses).mean()))
    return history


def finetune_stack(layers: Layers, data, labels, n_classes: int, epochs: int = 10,
                   lr: float = 0.1, batch_size: int = 20, seed: int = 0, mesh=None,
                   device=None, generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[List[RBMParams], Tuple[torch.Tensor, torch.Tensor], List[float]]:
    """Backprop fine-tuning. Returns (tuned stack params, softmax head (Wh,
    bh), per-epoch mean cross-entropy)."""
    _check_labels(labels, n_classes)
    device = torch.device(device) if device is not None else layers[0][0].W.device
    cfgs = [cfg for _, cfg in layers]
    stack = [_trainable(p.map(lambda t: t.to(device))) for p, _ in layers]
    head = _init_head(cfgs[-1].n_hidden, n_classes, device,
                      generator_for(device, seed, generator), draws)
    data = _rows(data, device)
    n, nb = _batched(batch_size, data.shape[0])
    xb = data[:n].reshape(nb, batch_size, -1)
    yb = torch.as_tensor(np.asarray(labels)).to(device=device, dtype=torch.int64)[:n]

    def logits_of(i, rows):
        return _up(stack, cfgs, xb[i, rows]) @ head[0] + head[1]

    leaves = [t for p in stack for t in _leaves(p)] + head
    history = _sgd(leaves, logits_of, nb, yb.reshape(nb, batch_size), epochs, lr,
                   batch_size, mesh)
    return [_detached(p) for p in stack], (head[0].detach(), head[1].detach()), history


def _mdbn_logits(tower_p, tower_cfgs, joint_p, joint_cfg, head, names, xs) -> torch.Tensor:
    codes = [_up(tower_p[m], tower_cfgs[m], xs[m]) for m in names]
    return hidden_mean(joint_p, torch.cat(codes, dim=1), joint_cfg) @ head[0] + head[1]


def finetune_mdbn(towers, joint, modalities, labels, n_classes: int, epochs: int = 10,
                  lr: float = 0.1, batch_size: int = 20, seed: int = 0, mesh=None,
                  device=None, generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None):
    """Multimodal supervised fine-tuning: backprop through every tower
    (``towers``: {name: [(RBMParams, RBMConfig), ...]} in modality order),
    the concat and the joint RBM layer (``joint``: (RBMParams, RBMConfig))
    into a softmax head. Returns (tuned towers {name: [RBMParams]}, tuned
    joint params, head, per-epoch loss history)."""
    _check_labels(labels, n_classes)
    names = list(towers)
    joint_params, joint_cfg = joint
    device = torch.device(device) if device is not None else joint_params.W.device
    tower_cfgs = {m: [cfg for _, cfg in towers[m]] for m in names}
    tower_p = {m: [_trainable(p.map(lambda t: t.to(device))) for p, _ in towers[m]]
               for m in names}
    joint_p = _trainable(joint_params.map(lambda t: t.to(device)))
    head = _init_head(joint_cfg.n_hidden, n_classes, device,
                      generator_for(device, seed, generator), draws)
    labels_np = np.asarray(labels)
    for m in names:
        if modalities[m].shape[0] != labels_np.shape[0]:
            raise ValueError(f"modality {m!r} has {modalities[m].shape[0]} rows but labels "
                             f"has {labels_np.shape[0]}")
    n, nb = _batched(batch_size, labels_np.shape[0])
    xb = {m: _rows(modalities[m], device)[:n].reshape(nb, batch_size, -1) for m in names}
    yb = torch.as_tensor(labels_np).to(device=device, dtype=torch.int64)[:n]

    def logits_of(i, rows):
        return _mdbn_logits(tower_p, tower_cfgs, joint_p, joint_cfg, head, names,
                            {m: xb[m][i, rows] for m in names})

    leaves = ([t for m in names for p in tower_p[m] for t in _leaves(p)]
              + _leaves(joint_p) + head)
    history = _sgd(leaves, logits_of, nb, yb.reshape(nb, batch_size), epochs, lr,
                   batch_size, mesh)
    return ({m: [_detached(p) for p in tower_p[m]] for m in names}, _detached(joint_p),
            (head[0].detach(), head[1].detach()), history)


@torch.no_grad()
def predict_mdbn(towers, joint, head, modalities) -> torch.Tensor:
    names = list(towers)
    joint_params, joint_cfg = joint
    device = joint_params.W.device
    tower_p = {m: [p for p, _ in towers[m]] for m in names}
    tower_cfgs = {m: [cfg for _, cfg in towers[m]] for m in names}
    xs = {m: _rows(modalities[m], device) for m in names}
    return torch.argmax(_mdbn_logits(tower_p, tower_cfgs, joint_params, joint_cfg, head,
                                     names, xs), dim=1)


@torch.no_grad()
def predict_stack(layers: Layers, head, x) -> torch.Tensor:
    device = layers[0][0].W.device
    h = _up([p for p, _ in layers], [cfg for _, cfg in layers], _rows(x, device))
    return torch.argmax(h @ head[0] + head[1], dim=1)

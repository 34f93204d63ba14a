"""Deep-autoencoder fine-tuning (Hinton & Salakhutdinov 2006).

Port of ``mdbn_tpu/train/autoencoder.py``: the pretrained stack is unrolled
into an encoder (the up-pass) and a decoder that starts at the transposed
weights, the two are untied, and the whole autoencoder is fine-tuned by
reconstruction backprop with Adam. Sigmoids everywhere except the bottom
reconstruction of a Gaussian-visible layer (linear); the loss is the
cross-entropy on the logits for Bernoulli data and the squared error for
Gaussian data, summed over features and averaged over rows.

The reference runs ``optax.adam(lr)`` in one ``lax.scan`` an epoch with no
Pallas kernel; here ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``
steps an eager loop on the parameters' device. That is the same update:
both keep the bias-corrected first and second moments and divide by
``sqrt(v_hat) + eps``, with ``eps`` outside the square root in both. The
per-step losses stay on the device and are read once an epoch. Under a
``mesh`` each rank takes its rows of every minibatch and the gradients are
all-reduced before the step (``parallel/dp.py::finetune_rows``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, check_fixed_variance_layers
from .finetune import _batched, _rows

Layers = Sequence[Tuple[RBMParams, RBMConfig]]
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.adam's defaults


def _recon_loss(x: torch.Tensor, pre: torch.Tensor, visible: str, batch_size: int
                ) -> torch.Tensor:
    """This rank's share of the per-row loss at the data layer, summed over
    its rows and divided by the minibatch's ``batch_size``: cross-entropy on
    the logits for Bernoulli inputs, squared error for Gaussian inputs."""
    if visible == "bernoulli":
        return (F.softplus(pre) - x * pre).sum() / batch_size
    d = x - pre
    return (d * d).sum() / batch_size


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone(memory_format=torch.contiguous_format).float()


def unroll_stack(layers: Layers) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]],
                                          List[Tuple[torch.Tensor, torch.Tensor]]]:
    """(encoder, decoder) from a pretrained stack, as float32 copies: encoder
    layer i is (W_i, c_i), decoder layer i is (a copy of W_i^T, b_i), untied
    from here on."""
    enc = [(_copy(p.W), _copy(p.c)) for p, _ in layers]
    dec = [(_copy(p.W.T), _copy(p.b)) for p, _ in layers]
    return enc, dec


def _encode(enc, x: torch.Tensor) -> torch.Tensor:
    h = x
    for W, c in enc:
        h = torch.sigmoid(h @ W + c)
    return h


def _decode_pre(dec, h: torch.Tensor) -> torch.Tensor:
    """Top-down decode; the BOTTOM pre-activation, sigmoids between layers."""
    for D, b in reversed(dec[1:]):
        h = torch.sigmoid(h @ D + b)
    D, b = dec[0]
    return h @ D + b


def _bottom(visible: str, pre: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(pre) if visible == "bernoulli" else pre


def _leaves(pairs) -> List[torch.Tensor]:
    return [t.requires_grad_(True) for pair in pairs for t in pair]


def _adam_epochs(leaves: List[torch.Tensor], loss_of, nb: int, epochs: int, lr: float,
                 batch_size: int, mesh) -> List[float]:
    """Adam over the ``nb`` minibatches in order, each epoch. ``loss_of(i,
    rows)`` is this rank's share of minibatch i's loss; the gradients and
    the loss are all-reduced before every step."""
    from ..parallel.dp import all_reduce_sums, finetune_rows

    rows = finetune_rows(mesh, batch_size)
    opt = torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    history = []
    for _ in range(epochs):
        losses = []
        for i in range(nb):
            loss = loss_of(i, rows)
            grads = all_reduce_sums([*torch.autograd.grad(loss, leaves), loss.detach()], mesh)
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
            losses.append(grads[-1])
        history.append(float(torch.stack(losses).mean()))
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return history


def finetune_autoencoder_stack(layers: Layers, data, epochs: int = 10, lr: float = 1e-3,
                               batch_size: int = 20, decoder: Optional[List] = None,
                               mesh=None, device=None
                               ) -> Tuple[List[RBMParams], List[torch.Tensor], List[float]]:
    """Unroll + reconstruction fine-tuning of a DBN stack. Returns (tuned
    layer params, untied decoder weights bottom-up, per-epoch mean
    reconstruction loss). Tuned layer i packs the encoder's (W, c) and the
    decoder's visible bias; the decoder weights come back apart (transform
    stays the up-pass; reconstruct uses them). Pass the previous call's
    ``decoder`` to resume instead of starting the decoder at W^T."""
    check_fixed_variance_layers(layers, "autoencoder fine-tuning")
    visible = layers[0][1].visible
    device = torch.device(device) if device is not None else layers[0][0].W.device
    data = _rows(data, device)
    n, nb = _batched(batch_size, data.shape[0])
    xb = data[:n].reshape(nb, batch_size, -1)
    enc, dec = unroll_stack([(p.map(lambda t: t.to(device)), cfg) for p, cfg in layers])
    if decoder is not None:
        dec = [(_copy(torch.as_tensor(D).to(device)), b) for D, (_, b) in zip(decoder, dec)]
    leaves = _leaves(enc) + _leaves(dec)

    def loss_of(i, rows):
        x = xb[i, rows]
        return _recon_loss(x, _decode_pre(dec, _encode(enc, x)), visible, batch_size)

    history = _adam_epochs(leaves, loss_of, nb, epochs, lr, batch_size, mesh)
    tuned = [RBMParams(W=W, b=b, c=c) for (W, c), (_, b) in zip(enc, dec)]
    return tuned, [D for D, _ in dec], history


@torch.no_grad()
def reconstruct_stack(layers: Layers, decoder: Optional[List[torch.Tensor]], v
                      ) -> torch.Tensor:
    """Deterministic encode -> decode with the untied decoder, or with
    ``decoder=None`` the tied W^T down-pass."""
    device = layers[0][0].W.device
    enc = [(p.W.float(), p.c.float()) for p, _ in layers]
    if decoder is None:
        dec = [(p.W.float().T, p.b.float()) for p, _ in layers]
    else:
        dec = [(D, p.b.float()) for D, (p, _) in zip(decoder, layers)]
    pre = _decode_pre(dec, _encode(enc, _rows(v, device)))
    return _bottom(layers[0][1].visible, pre)


def _mdbn_decode(dec, back, names, widths):
    """{modality: bottom pre-activation} from the joint layer's down-pass."""
    out, lo = {}, 0
    for m in names:
        out[m] = _decode_pre(dec[m], back[:, lo:lo + widths[m]])
        lo += widths[m]
    return out


def finetune_autoencoder_mdbn(towers: Dict[str, list], joint: Tuple[RBMParams, RBMConfig],
                              modalities, epochs: int = 10, lr: float = 1e-3,
                              batch_size: int = 20, decoder: Optional[Dict[str, list]] = None,
                              mesh=None, device=None):
    """Multimodal deep autoencoder: each tower's encoder, the concat, the
    joint code, and the mirrored decode back to every modality; the loss is
    the sum of the modalities' reconstruction losses. Returns (tuned towers,
    tuned joint params, decoder dict (the joint layer's under
    ``"__joint__"``), history). Pass the previous call's ``decoder`` to
    resume."""
    for tname, tl in towers.items():
        check_fixed_variance_layers(tl, f"autoencoder fine-tuning (tower {tname!r})")
    names = list(towers)
    widths = {m: towers[m][-1][1].n_hidden for m in names}
    visibles = {m: towers[m][0][1].visible for m in names}
    joint_params, _ = joint
    device = torch.device(device) if device is not None else joint_params.W.device
    n_rows = next(iter(modalities.values())).shape[0]
    n, nb = _batched(batch_size, n_rows)
    xb = {m: _rows(modalities[m], device)[:n].reshape(nb, batch_size, -1) for m in names}
    moved = {m: [(p.map(lambda t: t.to(device)), cfg) for p, cfg in towers[m]] for m in names}
    enc = {m: unroll_stack(moved[m])[0] for m in names}
    dec = {m: unroll_stack(moved[m])[1] for m in names}
    jp = joint_params.map(lambda t: t.to(device))
    jenc = (_copy(jp.W), _copy(jp.c))
    jdec = (_copy(jp.W.T), _copy(jp.b))
    if decoder is not None:
        dec = {m: [(_copy(torch.as_tensor(D).to(device)), b)
                   for D, (_, b) in zip(decoder[m], dec[m])] for m in names}
        jdec = (_copy(torch.as_tensor(decoder["__joint__"][0]).to(device)), jdec[1])
    leaves = ([t for m in names for t in _leaves(enc[m])]
              + [t for m in names for t in _leaves(dec[m])] + _leaves([jenc, jdec]))

    def loss_of(i, rows):
        x = {m: xb[m][i, rows] for m in names}
        codes = torch.cat([_encode(enc[m], x[m]) for m in names], dim=1)
        top = torch.sigmoid(codes @ jenc[0] + jenc[1])
        back = torch.sigmoid(top @ jdec[0] + jdec[1])
        pre = _mdbn_decode(dec, back, names, widths)
        total = 0.0
        for m in names:
            total = total + _recon_loss(x[m], pre[m], visibles[m], batch_size)
        return total

    history = _adam_epochs(leaves, loss_of, nb, epochs, lr, batch_size, mesh)
    tuned_towers = {m: [RBMParams(W=W, b=b, c=c) for (W, c), (_, b) in zip(enc[m], dec[m])]
                    for m in names}
    tuned_joint = RBMParams(W=jenc[0], b=jdec[1], c=jenc[1])
    out = {m: [D for D, _ in dec[m]] for m in names}
    out["__joint__"] = [jdec[0]]
    return tuned_towers, tuned_joint, out, history


@torch.no_grad()
def reconstruct_mdbn(towers, joint, decoder, modalities) -> Dict[str, torch.Tensor]:
    """Deterministic multimodal encode -> decode (the untied decoder if
    given, else the tied W^T down-pass)."""
    names = list(towers)
    jp = joint[0]
    device = jp.W.device
    widths = {m: towers[m][-1][1].n_hidden for m in names}
    codes = torch.cat([_encode([(p.W.float(), p.c.float()) for p, _ in towers[m]],
                               _rows(modalities[m], device)) for m in names], dim=1)
    top = torch.sigmoid(codes @ jp.W.float() + jp.c.float())
    Dj = decoder["__joint__"][0] if decoder is not None else jp.W.float().T
    back = torch.sigmoid(top @ Dj + jp.b.float())
    dec = {m: ([(p.W.float().T, p.b.float()) for p, _ in towers[m]] if decoder is None
               else [(D, p.b.float()) for D, (p, _) in zip(decoder[m], towers[m])])
           for m in names}
    pre = _mdbn_decode(dec, back, names, widths)
    return {m: _bottom(towers[m][0][1].visible, pre[m]) for m in names}

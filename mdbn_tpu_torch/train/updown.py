"""Generative DBN fine-tuning: the up-down (contrastive wake-sleep) algorithm
of Hinton, Osindero & Teh 2006, appendix B.

Port of ``mdbn_tpu/train/updown.py``. Greedy pretraining leaves a DBN whose
lower layers are directed sigmoid belief layers with tied recognition and
generative weights under an undirected top RBM. Up-down unties them and
tunes all three groups together, one minibatch at a time:

- **wake**: a stochastic up-pass through the recognition weights samples
  the states s_0..s_L; each directed layer's generative weights take a
  delta-rule step toward predicting s_l from s_{l+1};
- **top**: CD-k of the undirected top at the wake top states;
- **sleep**: the top's negative sample is dreamed down through the new
  generative weights, and each layer's recognition weights take a step
  toward predicting the dreamed s'_{l+1} from s'_l.

Four variants share one step (``_step``), a tree of directed towers under
one undirected top: the stack (its top RBM undirected); the labeled stack
(every layer directed under the associative label top of
``train/labeled.py``: wake clamps the true label, sleep dreams code and
label); the MDBN (every tower layer directed under the joint RBM, the
negative sample split back into the towers' slices); the labeled MDBN (the
joint layer directed too, under the label top over the joint code). Rows
labeled -1 wake with a posterior label draw in place of a clamped truth.

The reference runs each epoch as one jitted ``lax.scan`` with no Pallas
kernel; here it is an eager loop on the parameters' device in float32, the
per-step errors kept on the device and read once an epoch. A step's draws
(``train/draws.py``) are named after the keys the reference splits: the
stack's ``"wake{l}"`` (keys[l]), ``"h0"`` (keys[L]), ``"v{t}"``
(keys[L+1+2t]), ``"h{t+1}"`` (keys[L+2+2t]), ``"sleep{l}"`` (keys[L+1+2k+l],
uniforms, or normals for a sampled Gaussian bottom, absent for a
mean-field one); the labeled stack's ``"code{t}"`` / ``"label{t}"`` in place
of ``"v{t}"`` (keys[L+1+3t], [L+2+3t], ``"h{t+1}"`` keys[L+3+3t]),
``"sleep{l}"`` keys[L+3k+1+l] and ``"fill"`` keys[2L+3k+1]; the MDBN's
``"wake:{tower}:{l}"`` and ``"sleep:{tower}:{l}"``, and the labeled MDBN's
``"joint_wake"`` and ``"joint_sleep"``. ``draws={"steps": [epoch][step]
{name: [batch, n]}}`` injects them; what it does not hold comes from a
generator seeded ``seed`` on the device and is written into it. Under a ``mesh`` each rank takes its rows of
every minibatch; the generative and top statistics, then the recognition
statistics, are all-reduced before their updates (two all-reduces a step),
the same math as one device (``parallel/dp.py::finetune_rows``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import RBMConfig
from ..core.rbm_math import RBMParams, check_fixed_variance_layers, hidden_mean, visible_mean
from .draws import GUMBEL_LOW, StepDraws, generator_for, step_draws
from .finetune import _rows
from .labeled import (_one_hot, _posterior_label_fill, _validate_partial_labels, cd_sums,
                      label_top_chain)

Layers = Sequence[Tuple[RBMParams, RBMConfig]]
Pair = Tuple[torch.Tensor, torch.Tensor]


def _name(kind: str, tower: Optional[str], l: int) -> str:
    return f"{kind}{l}" if tower is None else f"{kind}:{tower}:{l}"


def _f32(t, device) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=torch.float32)


def _params32(p: RBMParams, device) -> RBMParams:
    return RBMParams(W=_f32(p.W, device), b=_f32(p.b, device), c=_f32(p.c, device))


def _down_mean(gen: Pair, h: torch.Tensor, cfg: RBMConfig) -> torch.Tensor:
    """The generative down-prediction through one directed layer."""
    W, b = gen
    pre = h @ W.T + b
    return torch.sigmoid(pre) if cfg.visible == "bernoulli" else pre


def _top_chain(top: RBMParams, vt: torch.Tensor, cfg: RBMConfig, d: StepDraws, k: int):
    """CD-k of an undirected top RBM from ``vt`` (probabilities in the
    statistics, samples through the chain). Returns (h0p, vneg, hkp)."""
    h0p = hidden_mean(top, vt, cfg)
    h = d.bern("h0", h0p)
    vneg, hkp = vt, h0p
    for t in range(k):
        vneg = d.bern(f"v{t}", visible_mean(top, h, cfg))
        hkp = hidden_mean(top, vneg, cfg)
        h = d.bern(f"h{t + 1}", hkp)
    return h0p, vneg, hkp


def _sleep_states(gen: List[Pair], cfgs: Sequence[RBMConfig], top_state: torch.Tensor,
                  d: StepDraws, tower: Optional[str]) -> List[torch.Tensor]:
    """Dream down a tower from ``top_state`` through its generative weights:
    sampled Bernoulli layers, a sampled or mean-field Gaussian bottom."""
    L = len(cfgs)
    sp = [None] * (L + 1)
    sp[L] = top_state
    for l in range(L - 1, -1, -1):
        cfg = cfgs[l]
        p_down = _down_mean(gen[l], sp[l + 1], cfg)
        if cfg.visible == "bernoulli":
            sp[l] = d.bern(_name("sleep", tower, l), p_down)
        elif cfg.resolved_sample_visible:
            sp[l] = p_down + d.normal(_name("sleep", tower, l), p_down.shape[1])
        else:
            sp[l] = p_down
    return sp


@torch.no_grad()
def _step(st: dict, xs: Dict[Optional[str], torch.Tensor], onehot, mask, d: StepDraws,
          cfg_of: Dict[Optional[str], Sequence[RBMConfig]], top_cfg: Optional[RBMConfig],
          n_code: Optional[int], lr: float, k: int, B: int, mesh) -> torch.Tensor:
    """One up-down step on this rank's rows; updates ``st`` ({"rec": {tower:
    [RBMParams]}, "gen": {tower: [(W, b)]}, "top": RBMParams, and for a
    directed joint layer "jrec" / "jgen"}) in place. ``n_code`` is None for
    an undirected top RBM (``top_cfg``), the label top's code width
    otherwise. Returns this rank's share of the wake reconstruction mse."""
    from ..parallel.dp import all_reduce_sums

    names = list(cfg_of)
    rec, gen, top = st["rec"], st["gen"], st["top"]
    # wake: each tower's stochastic up-pass, its generative delta-rule sums
    wakes, sums, err = {}, [], 0.0
    for m in names:
        s = [xs[m]]
        for l, cfg in enumerate(cfg_of[m]):
            s.append(d.bern(_name("wake", m, l), hidden_mean(rec[m][l], s[l], cfg)))
        wakes[m] = s
        for l, cfg in enumerate(cfg_of[m]):
            resid = s[l] - _down_mean(gen[m][l], s[l + 1], cfg)
            sums += [resid.T @ s[l + 1], resid.sum(0)]
            if l == 0:
                err = err + (resid * resid).sum() / (B * resid.shape[1])
    err = err / len(names)
    code = torch.cat([wakes[m][-1] for m in names], dim=1)
    if "jrec" in st:  # the directed joint layer: up-sample, generative delta rule
        jrec, (Wjg, bjg) = st["jrec"], st["jgen"]
        concat = code
        code = d.bern("joint_wake", torch.sigmoid(concat @ jrec.W + jrec.c))
        resid_c = concat - torch.sigmoid(code @ Wjg.T + bjg)
        sums += [resid_c.T @ code, resid_c.sum(0)]
    # the undirected top: CD-k at the wake states
    if n_code is None:
        vt = code
        h0p, vneg, hkp = _top_chain(top, vt, top_cfg, d, k)
        neg_code = vneg
    else:
        if mask is not None:
            onehot = _posterior_label_fill(d.uniform("fill", onehot.shape[1], GUMBEL_LOW), top,
                                           code, onehot, mask, n_code)
        vt = torch.cat([code, onehot], dim=1)
        h0p, vneg, hkp, _ = label_top_chain(top, vt, d, n_code, k)
        neg_code = vneg[:, :n_code]
    sums += cd_sums(vt, h0p, vneg, hkp)
    it = iter(all_reduce_sums(sums, mesh))

    def step(x, g):  # a weight: (lr / B) times the summed outer products
        return x + (lr / B) * g

    def mean_step(x, g):  # a bias: lr times the minibatch mean
        return x + lr * (g / B)

    new_gen = {m: [(step(W, next(it)), mean_step(b, next(it))) for W, b in gen[m]]
               for m in names}
    if "jrec" in st:
        st["jgen"] = (step(Wjg, next(it)), mean_step(bjg, next(it)))
    st["top"] = RBMParams(W=step(top.W, next(it)), b=mean_step(top.b, next(it)),
                          c=mean_step(top.c, next(it)))
    # sleep: dream down from the top's negative sample, recognition sums
    sums = []
    if "jrec" in st:
        Wjg, bjg = st["jgen"]
        concat = d.bern("joint_sleep", torch.sigmoid(neg_code @ Wjg.T + bjg))
        resid_j = neg_code - torch.sigmoid(concat @ jrec.W + jrec.c)
        sums += [concat.T @ resid_j, resid_j.sum(0)]
    else:
        concat = neg_code
    offset = 0
    for m in names:
        width = cfg_of[m][-1].n_hidden
        sp = _sleep_states(new_gen[m], cfg_of[m], concat[:, offset:offset + width], d, m)
        offset += width
        for l, cfg in enumerate(cfg_of[m]):
            resid = sp[l + 1] - hidden_mean(rec[m][l], sp[l], cfg)
            sums += [sp[l].T @ resid, resid.sum(0)]
    it = iter(all_reduce_sums(sums, mesh))
    if "jrec" in st:
        st["jrec"] = RBMParams(W=step(jrec.W, next(it)), b=jrec.b, c=mean_step(jrec.c, next(it)))
    st["rec"] = {m: [RBMParams(W=step(p.W, next(it)), b=p.b, c=mean_step(p.c, next(it)))
                     for p in rec[m]] for m in names}
    st["gen"] = new_gen
    return err


def _run(st: dict, xb: Dict[Optional[str], torch.Tensor], yb, mb, cfg_of, top_cfg, n_code,
         lr: float, k: int, batch_size: int, epochs: int, seed: int, generator, draws,
         mesh) -> List[float]:
    """``epochs`` epochs of ``_step`` over the minibatches in order."""
    from ..parallel.dp import all_reduce_sums, finetune_rows

    device = next(iter(xb.values())).device
    rng = generator_for(device, seed, generator)
    steps = None if draws is None else draws["steps"]
    rows = finetune_rows(mesh, batch_size)
    nb = next(iter(xb.values())).shape[0]
    history = []
    for e in range(epochs):
        errs = []
        for i in range(nb):
            d = step_draws(steps, e, i, rng, device, batch_size, rows)
            errs.append(_step(st, {m: x[i, rows] for m, x in xb.items()},
                              None if yb is None else yb[i, rows],
                              None if mb is None else mb[i, rows], d, cfg_of, top_cfg,
                              n_code, float(lr), int(k), batch_size, mesh))
        history.append(float(all_reduce_sums([torch.stack(errs)], mesh)[0].mean()))
    return history


def _minibatches(data, batch_size: int, device, n_labels: Optional[int] = None
                 ) -> Tuple[torch.Tensor, int]:
    """The whole minibatches of ``data`` [nb, B, V] and nb; with
    ``n_labels``, the rows must match the labels."""
    x = _rows(data, device)
    if n_labels is not None and x.shape[0] != n_labels:
        raise ValueError(f"data rows {x.shape[0]} != labels {n_labels}")
    nb = x.shape[0] // batch_size
    if nb == 0:
        raise ValueError(f"dataset has {x.shape[0]} samples — fewer than "
                         f"one minibatch (batch_size={batch_size})")
    return x[:nb * batch_size].reshape(nb, batch_size, -1), nb


def _label_batches(labels, n_classes: int, nb: int, batch_size: int, device):
    """(one-hot [nb, B, C], labeled-row mask [nb, B] or None when every row
    is labeled), after the labels' checks (-1: unlabeled)."""
    labels, semi = _validate_partial_labels(labels, n_classes)
    lab = labels[:nb * batch_size]
    yb = _one_hot(lab, n_classes, device).reshape(nb, batch_size, n_classes)
    mb = (torch.as_tensor(lab >= 0, device=device).float().reshape(nb, batch_size)
          if semi else None)
    return yb, mb


def _gen_start(gen, layers: Layers, device) -> List[Pair]:
    """The generative weights to start from: the tied pretrained (W, b), or
    a previous run's ``gen`` to resume."""
    if gen is None:
        gen = [(p.W, p.b) for p, _ in layers]
    return [(_f32(W, device), _f32(b, device)) for W, b in gen]


def finetune_updown_stack(layers: Layers, data, epochs: int = 10, lr: float = 0.01, k: int = 1,
                          batch_size: int = 20, seed: int = 0, gen: Optional[List[Pair]] = None,
                          mesh=None, device=None, generator: Optional[torch.Generator] = None,
                          draws: Optional[dict] = None
                          ) -> Tuple[List[RBMParams], List[Pair], RBMParams, List[float]]:
    """Up-down fine-tuning of a pretrained stack (bottom-up ``layers``; the
    last is the undirected top RBM, the rest become directed). Returns
    (recognition params per directed layer, generative (W, b) per directed
    layer, top RBM params, per-epoch wake reconstruction mse). Pass a
    previous run's ``gen`` to resume with the untied generative weights."""
    if len(layers) < 2:
        raise ValueError("up-down fine-tuning needs >= 2 layers (directed "
                         "layers below an undirected top RBM); a single RBM "
                         "has nothing to untie")
    check_fixed_variance_layers(layers, "up-down fine-tuning")
    *directed, (top_params, top_cfg) = layers
    if gen is not None and len(gen) != len(directed):
        raise ValueError(f"gen has {len(gen)} layers, stack has {len(directed)} "
                         "directed layers")
    device = torch.device(device) if device is not None else top_params.W.device
    xb, _ = _minibatches(data, batch_size, device)
    st = {"rec": {None: [_params32(p, device) for p, _ in directed]},
          "gen": {None: _gen_start(gen, directed, device)}, "top": _params32(top_params, device)}
    history = _run(st, {None: xb}, None, None, {None: [c for _, c in directed]}, top_cfg, None,
                   lr, k, batch_size, epochs, seed, generator, draws, mesh)
    return st["rec"][None], st["gen"][None], st["top"], history


def finetune_updown_labeled(layers: Layers, label_top: RBMParams, data, labels, n_classes: int,
                            epochs: int = 10, lr: float = 0.01, k: int = 1,
                            batch_size: int = 20, seed: int = 0,
                            gen: Optional[List[Pair]] = None, mesh=None, device=None,
                            generator: Optional[torch.Generator] = None,
                            draws: Optional[dict] = None
                            ) -> Tuple[List[RBMParams], List[Pair], RBMParams, List[float]]:
    """Labeled up-down over a whole stack and the associative label top
    (the complete 2006 algorithm): every layer of ``layers`` becomes
    directed; ``label_top`` (from ``train.labeled.fit_label_top``) is the
    undirected top over [top code ; one-hot label]. Returns (recognition
    params per layer, generative (W, b) per layer, tuned label top,
    per-epoch wake reconstruction mse). Rows labeled -1 wake with a
    posterior label draw."""
    if not layers:
        raise ValueError("labeled up-down needs >= 1 stack layer below the label top")
    check_fixed_variance_layers(layers, "labeled up-down fine-tuning")
    n_code = layers[-1][0].W.shape[1]
    if label_top.W.shape[0] != n_code + n_classes:
        raise ValueError(f"label top has visible {label_top.W.shape[0]}, "
                         f"expected code {n_code} + {n_classes} classes")
    if gen is not None and len(gen) != len(layers):
        raise ValueError(f"gen has {len(gen)} layers, stack has {len(layers)}")
    device = torch.device(device) if device is not None else layers[0][0].W.device
    xb, nb = _minibatches(data, batch_size, device, len(labels))
    yb, mb = _label_batches(labels, n_classes, nb, batch_size, device)
    st = {"rec": {None: [_params32(p, device) for p, _ in layers]},
          "gen": {None: _gen_start(gen, layers, device)}, "top": _params32(label_top, device)}
    history = _run(st, {None: xb}, yb, mb, {None: [c for _, c in layers]}, None, int(n_code),
                   lr, k, batch_size, epochs, seed, generator, draws, mesh)
    return st["rec"][None], st["gen"][None], st["top"], history


def _tower_start(towers, modalities, gen, batch_size: int, device, what: str):
    """Checks the towers against the modalities and the stored ``gen``, and
    returns (names, minibatches {tower: [nb, B, V]}, nb, rec, gen)."""
    if set(towers) != set(modalities):
        raise ValueError(f"towers {sorted(towers)} and modalities "
                         f"{sorted(modalities)} disagree")
    for tname, tl in towers.items():
        check_fixed_variance_layers(tl, f"{what} (tower {tname!r})")
    names = list(towers)
    rows = {m: int(modalities[m].shape[0]) for m in names}
    if len(set(rows.values())) != 1:
        raise ValueError(f"modalities disagree on rows: {rows}")
    if gen is not None:
        for m in names:
            if m not in gen or len(gen[m]) != len(towers[m]):
                raise ValueError(f"gen for tower {m!r} missing or wrong depth")
    xb, nb = {}, 0
    for m in names:
        xb[m], nb = _minibatches(modalities[m], batch_size, device)
    rec = {m: [_params32(p, device) for p, _ in towers[m]] for m in names}
    gens = {m: _gen_start(None if gen is None else gen[m], towers[m], device) for m in names}
    return names, xb, nb, rec, gens


def finetune_updown_mdbn(towers, joint: Tuple[RBMParams, RBMConfig], modalities,
                         epochs: int = 10, lr: float = 0.01, k: int = 1, batch_size: int = 20,
                         seed: int = 0, gen=None, mesh=None, device=None,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[dict] = None):
    """Up-down fine-tuning of a whole MDBN: every tower layer (``towers``:
    {name: [(RBMParams, RBMConfig)]} bottom-up, in the joint RBM's concat
    order) directed under the undirected joint RBM. Returns (recognition
    {name: [RBMParams]}, generative {name: [(W, b)]}, joint RBMParams,
    per-epoch mean wake reconstruction mse). ``gen`` ({name: [(W, b)]})
    resumes."""
    joint_params, joint_cfg = joint
    device = torch.device(device) if device is not None else joint_params.W.device
    names, xb, _, rec, gens = _tower_start(towers, modalities, gen, batch_size, device,
                                           "up-down fine-tuning")
    st = {"rec": rec, "gen": gens, "top": _params32(joint_params, device)}
    history = _run(st, xb, None, None, {m: [c for _, c in towers[m]] for m in names},
                   joint_cfg, None, lr, k, batch_size, epochs, seed, generator, draws, mesh)
    return st["rec"], st["gen"], st["top"], history


def finetune_updown_mdbn_labeled(towers, joint: Tuple[RBMParams, RBMConfig],
                                 label_top: RBMParams, modalities, labels, n_classes: int,
                                 epochs: int = 10, lr: float = 0.01, k: int = 1,
                                 batch_size: int = 20, seed: int = 0, gen=None,
                                 joint_gen: Optional[Pair] = None, mesh=None, device=None,
                                 generator: Optional[torch.Generator] = None,
                                 draws: Optional[dict] = None):
    """Labeled up-down over a whole MDBN: the towers and the joint layer all
    directed under the associative label top (``MDBN.fit_label_top``).
    Returns (recognition {name: [RBMParams]}, generative {name: [(W, b)]},
    joint recognition RBMParams, joint generative (W, b), tuned label top,
    per-epoch mean wake reconstruction mse). Rows labeled -1 wake with a
    posterior label draw."""
    joint_params, joint_cfg = joint
    if joint_cfg.visible != "bernoulli":
        raise ValueError("the joint RBM is Bernoulli-visible by construction")
    n_code = joint_params.W.shape[1]
    if label_top.W.shape[0] != n_code + n_classes:
        raise ValueError(f"label top has visible {label_top.W.shape[0]}, "
                         f"expected joint code {n_code} + {n_classes} classes")
    device = torch.device(device) if device is not None else joint_params.W.device
    names, xb, nb, rec, gens = _tower_start(towers, modalities, gen, batch_size, device,
                                            "labeled up-down fine-tuning")
    n_rows = int(modalities[names[0]].shape[0])
    if n_rows != len(labels):
        raise ValueError(f"data rows {n_rows} != labels {len(labels)}")
    if joint_gen is not None and tuple(joint_gen[0].shape) != tuple(joint_params.W.shape):
        raise ValueError(f"joint_gen W {tuple(joint_gen[0].shape)} != joint "
                         f"{tuple(joint_params.W.shape)}")
    yb, mb = _label_batches(labels, n_classes, nb, batch_size, device)
    st = {"rec": rec, "gen": gens, "top": _params32(label_top, device),
          "jrec": _params32(joint_params, device),
          "jgen": _gen_start(None if joint_gen is None else [joint_gen],
                             [joint], device)[0]}
    history = _run(st, xb, yb, mb, {m: [c for _, c in towers[m]] for m in names}, None,
                   int(n_code), lr, k, batch_size, epochs, seed, generator, draws, mesh)
    return st["rec"], st["gen"], st["jrec"], st["jgen"], st["top"], history

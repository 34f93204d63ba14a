#!/usr/bin/env python3
"""Time the CUDA train kernels of two checkouts of mdbn_tpu_torch on one card.

    python3 scripts/torch_kernel_ab.py --base DIR [--reps 20]
    python3 scripts/torch_kernel_ab.py --sweep [--modes] [--reps 10] [--out FILE]

Runs the checkout at DIR (the base) and this checkout in separate processes,
in the order base, this, this, base. Each process builds its own kernels
from its own sources, runs one warm-up epoch per shape, then times ``reps``
one-epoch kernel runs with CUDA events at two shapes the graded configs
train at, c1 (Bernoulli 784x500, B 20, CD-1) and c2 (Gaussian 2000x400, B
20, CD-1, mean-field visibles), on csrc/cd_train.cu called directly and on
the kernel that checkout's ``select_kernel`` picks (the parent's cd_train.cu
against this checkout's csrc/cd_train_resident.cu), and at the four rows of
the wide slice that the main path trains on the W-blocked
csrc/cd_train_wide.cu, w20k (Gaussian 20000x400, B 20, lr 0.001),
w20k_mom_bf16 (the same with momentum 0.5 at bf16 storage and compute), w28k
(28000x400) and w40k_bf16 (40000x1000 at bf16, 10 updates an epoch), and at
the slice's three estimator-mode rows
(w20k_pt3_bf16: 3-rung tempering, PCD, bf16 storage and compute; w20k_enh:
the enhanced gradient; w20k_lv: learned variance) on cd_train.cu called
directly and on the kernel each checkout's ``select_kernel`` picks (the
parent's cd_train.cu against this checkout's csrc/cd_train_wide_modes.cu).
The resident kernel's plain variant also runs at c4's GE tower's second
layer (Bernoulli 400x100, B 20), c5's tower recipe at c2's width (PCD, k=2,
momentum 0.5, L2 1e-4) and c1 at bf16 storage and compute, and the narrow
estimator modes of chip_smoke.py's phase 6 (pt5: 784x500 PCD with 5 rungs;
enhanced: 784x500; lv: Gaussian 2000x200 with learned variance; pseudo: c1
with the pseudo monitor) on cd_train.cu and on the selected kernel (a parent
before the resident kernel took the modes selects cd_train.cu there).
Each process also hashes the parameters and velocities after a 2-epoch run
of the directly called kernel and of the selected one, from a fixed state
with the kernel's own draws from a fixed seed, so the summary says whether
the two checkouts' kernels give the same bits (``identical_bits``; for the
selected kernel, at the shapes where both checkouts select the same one),
and after the W-blocked update alone (csrc/cd_grads_wide.cu's update kernel
over 3 ranks' gathered factors made from a seed at w20k's and w20k_mom_bf16's
shapes: ``update_identical_bits``; it and the W-blocked DP step timed at the
four W-blocked rows with CUDA events, ``dp_update_us``, ``dp_step_us``),
and after the data-parallel kernels (``dp_identical_bits``): csrc/cd_grads.cu's
step (its flat buffer and chain, from a seed) and its update (on 3 ranks' sums
made from a seed) at c1, c5_tower and the four estimator modes, and
csrc/cd_grads_wide.cu's step (its slot and chain) at w20k and w20k_mom_bf16.
The c1_k255 and c4_ge1_k255 rows run 255 Gibbs steps, the most whose draws
(cd_common.cuh::draw_bits) a checkout from before k > 255 was admitted keys.
Prints one JSON line per process, then a summary line with each side's best
time and the card's name and power limit.

--sweep (this checkout alone) measures where the resident kernel takes
over: the card's opt-in shared memory of a block and, per cluster size, the
clusters it holds at once (ops.cd_epoch_resident_cuda.H100_MAX_CLUSTERS),
then for a grid of shapes (V x H at batch 20, float32 and bfloat16; c1's
width at growing batches; narrow V with 2000 to 8192 hidden units at
batches 4 and 20) whether the tiles fit and, where they do, the
resident kernel's and cd_train.cu's time per update in turns (resident,
cd_train, cd_train, resident). One JSON line per shape, then a summary with
the largest fitting shapes and every shape where cd_train.cu is faster.
With --modes the sweep runs the estimator modes instead (the resident
kernel's kModes variant): pt5, enhanced and pseudo (Bernoulli) and lv
(Gaussian, learned variance) at V 250, 784, 2000 and 3000 x H 100, 500 and
1000, batch 20, float32 and bfloat16.
Needs one CUDA device; writes only each checkout's kernel build.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# also timed on the kernel select_kernel picks
SELECTED = ("c1", "c2", "c4_ge1", "c4_ge1_k255", "c1_k255", "c5_tower", "c1_bf16", "pt5", "enhanced", "lv", "pseudo",
            "w20k", "w20k_mom_bf16", "w20k_pt3_bf16", "w20k_enh", "w20k_lv")
WIDE = dict(n_visible=20000, n_hidden=400, batch_size=20, lr=0.001, visible="gaussian")
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
SHAPES = {  # name -> (config fields, data rows, the W-blocked kernel)
    "c1": (dict(n_visible=784, n_hidden=500, batch_size=20, lr=0.1), 2000, False),
    "c2": (dict(n_visible=2000, n_hidden=400, batch_size=20, lr=0.01, visible="gaussian"),
           2000, False),
    "c4_ge1": (dict(n_visible=400, n_hidden=100, batch_size=20, seed=2), 400, False),
    "c4_ge1_k255": (dict(n_visible=400, n_hidden=100, batch_size=20, seed=2, k=255,
                         persistent=True), 100, False),
    "c1_k255": (dict(n_visible=784, n_hidden=500, batch_size=20, lr=0.1, k=255), 40, False),
    "c5_tower": (dict(n_visible=2000, n_hidden=400, batch_size=20, lr=0.005,
                      visible="gaussian", k=2, persistent=True, momentum=0.5, l2=1e-4), 400,
                 False),
    "c1_bf16": (dict(n_visible=784, n_hidden=500, batch_size=20, **BF16), 2000, False),
    "pt5": (dict(n_visible=784, n_hidden=500, batch_size=20, lr=0.1, persistent=True,
                 pt_temps=5, pt_beta_min=0.2), 2000, False),
    "enhanced": (dict(n_visible=784, n_hidden=500, batch_size=20, lr=0.1, gradient="enhanced"),
                 2000, False),
    "lv": (dict(n_visible=2000, n_hidden=200, batch_size=20, lr=0.005, visible="gaussian",
                learn_variance=True), 400, False),
    "pseudo": (dict(n_visible=784, n_hidden=500, batch_size=20, error_metric="pseudo"), 2000,
               False),
    "w20k": (WIDE, 400, True),
    "w20k_mom_bf16": (dict(WIDE, momentum=0.5, **BF16), 400, True),
    "w28k": (dict(WIDE, n_visible=28000), 400, True),
    "w40k_bf16": (dict(WIDE, n_visible=40000, n_hidden=1000, **BF16), 200, True),
    "w20k_pt3_bf16": (dict(WIDE, persistent=True, pt_temps=3, pt_beta_min=0.3, **BF16), 400,
                      False),
    "w20k_enh": (dict(WIDE, gradient="enhanced"), 400, False),
    "w20k_lv": (dict(WIDE, learn_variance=True), 400, False),
}


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _selected(K, cfg, dev):
    """(name, wrapper) of the kernel the checkout's select_kernel picks for
    ``cfg`` (before the resident kernel, select_kernel took the config
    alone and cd_train_run dispatched)."""
    import functools

    if hasattr(K, "kernel_run"):
        from mdbn_tpu_torch.ops.cd_epoch_resident_cuda import device_limits

        name = K.select_kernel(cfg, device_limits(cfg, dev))
        return name, K.kernel_run(name)
    name = K.select_kernel(cfg)
    return name, functools.partial(K.cd_train_run, wide=name == "cd_train_wide")


UPDATE_ROWS = ("w20k", "w20k_mom_bf16")  # the W-blocked update alone, bits


DP_UPDATE_ROWS = ("w20k", "w20k_mom_bf16", "w28k", "w40k_bf16")  # the W-blocked DP kernels, timed


def _update_inputs(cfg, dev):
    """(params, velocity, gathered, v0): 3 ranks' gathered factors, a state and
    a minibatch made from a seed, for the W-blocked update."""
    import torch

    from mdbn_tpu_torch.core.rbm_math import RBMParams, torch_dtype
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    ndev, B, V, H = 3, cfg.batch_size, cfg.n_visible, cfg.n_hidden
    lb = -(-B // ndev)
    local = cfg.replace(batch_size=lb)
    sdt = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(11)
    rand = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=dev)
    state = lambda: RBMParams(W=rand(V, H).to(sdt), b=rand(V).to(sdt), c=rand(H).to(sdt))
    p, vel = state(), state()
    gathered = torch.zeros(ndev * W.wide_factor_size(local), dtype=torch.uint8, device=dev)
    for d, (vs, hmat, err) in enumerate(W.gathered_views(local, gathered, ndev)):
        nv = min(lb, B - d * lb)
        vs.copy_((10.0 * rand(lb, V)).to(sdt))
        hmat[0, :nv] = torch.rand((nv, H), generator=gen, device=dev)
        hmat[1, :nv] = -torch.rand((nv, H), generator=gen, device=dev)
        err.copy_(rand(1).abs())
    v0 = (10.0 * rand(B, V)).to(sdt)
    return p, vel, gathered, v0


def update_bits(cfg, dev) -> str:
    """sha256 of the parameters and velocities after one W-blocked update
    (ops.cd_grads_wide_cuda.cd_wide_update) over 3 ranks' gathered factors
    and a minibatch made from a seed."""
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    p, vel, gathered, v0 = _update_inputs(cfg, dev)
    got = W.cd_wide_update(cfg, p, vel, v0, gathered, 3, 1.0 / 3, 0)
    return digest([*got[0].as_dict().values(), *got[1].as_dict().values()])


def update_us(cfg, dev, reps: int) -> float:
    """us per launch of the W-blocked update kernel on those inputs (CUDA
    events: the kernel runs far longer than the host takes to launch it)."""
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    p, vel, gathered, v0 = _update_inputs(cfg, dev)
    launch = W.update_launcher(cfg, p, vel, v0, gathered, 3, 1.0 / 3, 0)[0]
    return _time_ms(launch, 5 * reps) * 1e3


def step_us(cfg, data, dev, reps: int) -> float:
    """us per launch of the W-blocked DP step kernel on the whole first
    minibatch with seeded draws (CUDA events, as update_us)."""
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    st = init_train_state(cfg, device=dev)
    launch = W.step_launcher(cfg, st.params, data[:cfg.batch_size], st.chain_h, seed=5)[0]
    return _time_ms(launch, 5 * reps) * 1e3


DP_ROWS = ("c1", "c5_tower", "pt5", "enhanced", "lv", "pseudo")  # cd_grads.cu's bits
WIDE_DP_ROWS = ("w20k", "w20k_mom_bf16")  # cd_grads_wide.cu's step, bits


def dp_bits(cfg, data, dev, wide: bool) -> dict:
    """sha256 of csrc/cd_grads.cu's step (flat buffer and chain, seeded
    draws) on the first minibatch and of its update on 3 ranks' sums made
    from a seed; with ``wide``, of csrc/cd_grads_wide.cu's step (slot and
    chain) instead."""
    import torch

    from mdbn_tpu_torch.core.rbm_math import RBMParams, torch_dtype
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    st = init_train_state(cfg, device=dev)
    v0 = data[:cfg.batch_size]
    bit = dict(pseudo_bit=5) if cfg.error_metric == "pseudo" else {}
    if wide:
        slot, ch = W.cd_wide_step(cfg, st.params, v0, st.chain_h, seed=1)
        return {"step": digest([slot, ch])}
    flat = torch.zeros(G.flat_size(cfg), device=dev)
    _, ch, _ = G.cd_grads_step(cfg, st.params, v0, st.chain_h, seed=1, out=flat, **bit)
    sdt = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(4)
    rand = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=dev)
    V, H = cfg.n_visible, cfg.n_hidden
    z = lambda: rand(V).to(sdt) if cfg.learn_variance else None
    p, vel = (RBMParams(W=rand(V, H).to(sdt), b=rand(V).to(sdt), c=rand(H).to(sdt), z=z())
              for _ in range(2))
    got = G.cd_update(cfg, p, vel, 3 * rand(G.flat_size(cfg)),
                      float(torch.tensor(1.0 / 3, dtype=torch.float32)), 0)
    return {"step": digest([flat, ch]),
            "update": digest([*got[0].as_dict().values(), *got[1].as_dict().values(), got[2]])}


def child(root: str, reps: int) -> dict:
    sys.path.insert(0, root)
    import torch

    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import torch_dtype
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K

    dev = torch.device("cuda", 0)
    out = {"root": root}
    for name, (kw, n, wide) in SHAPES.items():
        cfg = RBMConfig(**kw)
        gen = torch.Generator().manual_seed(0)
        if cfg.visible == "bernoulli":
            data = (torch.rand((n, cfg.n_visible), generator=gen) < 0.3).float()
        else:
            data = torch.randn((n, cfg.n_visible), generator=gen)
        data = data.to(device=dev, dtype=torch_dtype(cfg.param_dtype))
        st = init_train_state(cfg, device=dev)
        nb = n // cfg.batch_size
        order = K.batch_order(cfg, nb, 1, None)
        p, v, _, errs = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data,
                                       K.batch_order(cfg, nb, 2, None), 0, None,
                                       torch.Generator().manual_seed(1), wide=wide)
        out[f"{name}_bits"] = digest([*p.as_dict().values(), *v.as_dict().values(), errs])

        def run():
            K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None, gen,
                           wide=wide)

        out[f"{name}_ms_per_epoch"] = _time_ms(run, reps)
        if name in UPDATE_ROWS:
            out[f"{name}_update_bits"] = update_bits(cfg, dev)
        if name in DP_UPDATE_ROWS:
            out[f"{name}_dp_update_us"] = update_us(cfg, dev, reps)
            out[f"{name}_dp_step_us"] = step_us(cfg, data, dev, reps)
        if name in DP_ROWS + WIDE_DP_ROWS:
            for part, h in dp_bits(cfg, data, dev, name in WIDE_DP_ROWS).items():
                out[f"{name}_dp_{part}_bits"] = h
        if name in SELECTED:
            kernel, fn = _selected(K, cfg, dev)
            out[f"{name}_selected"] = kernel
            p, v, _, errs = fn(cfg, st.params, st.velocity, st.chain_h, data,
                               K.batch_order(cfg, nb, 2, None), 0, None,
                               torch.Generator().manual_seed(1))
            out[f"{name}_selected_bits"] = digest([*p.as_dict().values(),
                                                   *v.as_dict().values(), errs])
            out[f"{name}_selected_ms_per_epoch"] = _time_ms(
                lambda: fn(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None, gen),
                reps)
    return out


SWEEP_MODES = {  # --sweep --modes: config fields of each estimator mode
    "pt5": dict(persistent=True, pt_temps=5, pt_beta_min=0.2),
    "enhanced": dict(gradient="enhanced"),
    "lv": dict(visible="gaussian", learn_variance=True, lr=0.005),
    "pseudo": dict(error_metric="pseudo"),
}


def sweep(reps: int, modes: bool = False) -> list:
    """Fit and times of the resident kernel against cd_train.cu (see module doc)."""
    sys.path.insert(0, HERE)
    import ctypes

    import torch

    from mdbn_tpu_torch._build import load_library
    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import torch_dtype
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R

    dev = torch.device("cuda", 0)
    lib = load_library("cd_train_resident").lib
    limits = {}
    for ranks in range(1, R.MAX_RANKS + 1):  # H = 32 * ranks gives that many column tiles
        out = (ctypes.c_int * 2)()
        lib.cd_train_resident_limits(64, 32 * ranks, 0, out)
        limits[ranks] = int(out[1])
    lines = [{"smem_per_block": int(out[0]), "max_clusters_by_ranks": limits}]
    print(json.dumps(lines[0]), flush=True)
    if modes:
        shapes = [dict(n_visible=v, n_hidden=h, batch_size=20, param_dtype=dt, mode=m)
                  for m in SWEEP_MODES for dt in ("float32", "bfloat16")
                  for v in (250, 784, 2000, 3000) for h in (100, 500, 1000)]
    else:
        shapes = [dict(n_visible=v, n_hidden=h, batch_size=20, param_dtype=dt)
                  for dt in ("float32", "bfloat16")
                  for v in (250, 500, 784, 1000, 1500, 2000, 2500, 3000, 3500, 4095)
                  for h in (100, 200, 400, 500, 1000)]
        shapes += [dict(n_visible=784, n_hidden=500, batch_size=b, param_dtype="float32")
                   for b in (32, 48, 64, 80, 96)]
        # past 4096 hidden units a column tile is wider than the block (512 threads)
        shapes += [dict(n_visible=v, n_hidden=h, batch_size=b, param_dtype="float32")
                   for b in (4, 20) for v in (64, 256, 400) for h in (2000, 4352, 8192)]
    for kw in shapes:
        fields = {k: x for k, x in kw.items() if k != "mode"}
        cfg = RBMConfig(**{"lr": 0.05, **fields, **SWEEP_MODES.get(kw.get("mode"), {})})
        tiles = R.resident_tiles(cfg, *R.device_limits(cfg, dev))
        rec = dict(kw, fits=tiles.fits, smem_bytes=tiles.smem_bytes,
                   strips_per_cluster=tiles.strips_per_cluster, clusters=tiles.clusters,
                   selected=K.select_kernel(cfg, R.device_limits(cfg, dev)))
        if tiles.fits:
            nb = 20
            gen = torch.Generator().manual_seed(0)
            if cfg.visible == "bernoulli":
                data = (torch.rand((nb * cfg.batch_size, cfg.n_visible), generator=gen) < 0.3)
            else:
                data = torch.randn((nb * cfg.batch_size, cfg.n_visible), generator=gen)
            data = data.to(device=dev, dtype=torch_dtype(cfg.param_dtype))
            st = init_train_state(cfg, device=dev)
            args = (cfg, st.params, st.velocity, st.chain_h, data, K.batch_order(cfg, nb, 1, None),
                    0, None, gen)
            t = [_time_ms(lambda: R.cd_train_resident_run(*args), reps),
                 _time_ms(lambda: K.cd_train_run(*args, wide=False), reps),
                 _time_ms(lambda: K.cd_train_run(*args, wide=False), reps),
                 _time_ms(lambda: R.cd_train_resident_run(*args), reps)]
            rec.update(resident_us_per_update=min(t[0], t[3]) * 1e3 / nb,
                       cd_train_us_per_update=min(t[1], t[2]) * 1e3 / nb)
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="root of the checkout to compare against")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sweep", action="store_true",
                    help="measure the resident kernel's fit and where cd_train.cu wins")
    ap.add_argument("--modes", action="store_true",
                    help="--sweep: the estimator modes' shapes instead of the plain ones")
    ap.add_argument("--out", help="--sweep: also write its lines to this file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.reps)), flush=True)
        return 0
    if not args.base and not args.sweep:
        ap.error("--base or --sweep is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if args.sweep:
        lines = sweep(args.reps, args.modes)
        timed = [r for r in lines[1:] if "resident_us_per_update" in r]
        groups = ([(m, dt, 20) for m in SWEEP_MODES for dt in ("float32", "bfloat16")]
                  if args.modes else
                  [(None, dt, b) for dt in ("float32", "bfloat16") for b in (4, 20)])
        summary = {"nvidia_smi": smi, "order": "resident, cd_train, cd_train, resident",
                   "largest_fitting": {" ".join(filter(None, (m, dt, f"B{b}"))): max(
                       ((r["n_visible"] * r["n_hidden"], r["n_visible"], r["n_hidden"])
                        for r in lines[1:] if r["fits"] and r["param_dtype"] == dt
                        and r["batch_size"] == b and r.get("mode") == m), default=None)
                       for m, dt, b in groups},
                   "largest_fitting_batch_at_c1": max(
                       (r["batch_size"] for r in lines[1:] if r["fits"]
                        and (r["n_visible"], r["n_hidden"]) == (784, 500)), default=None),
                   "cd_train_faster": [r for r in timed if r["cd_train_us_per_update"]
                                       < r["resident_us_per_update"]]}
        print(json.dumps(summary), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                for r in lines + [summary]:
                    f.write(json.dumps(r) + "\n")
        return 0
    runs = []
    for side, root in (("base", args.base), ("this", HERE), ("this", HERE),
                       ("base", args.base)):
        line = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                               os.path.abspath(root), "--reps", str(args.reps)],
                              capture_output=True, text=True, check=True).stdout
        rec = dict(json.loads(line.strip().splitlines()[-1]), side=side)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    summary = {"order": "base, this, this, base", "nvidia_smi": smi}
    for side in ("base", "this"):
        for name in SHAPES:
            summary[f"{side}_{name}_ms_per_epoch_best"] = min(
                r[f"{name}_ms_per_epoch"] for r in runs if r["side"] == side)
        for name in DP_UPDATE_ROWS:
            for kernel in ("update", "step"):
                summary[f"{side}_{name}_dp_{kernel}_us_best"] = min(
                    r[f"{name}_dp_{kernel}_us"] for r in runs if r["side"] == side)
        for name in SELECTED:
            summary[f"{side}_{name}_selected"] = runs[0 if side == "base" else 1][
                f"{name}_selected"]
            summary[f"{side}_{name}_selected_ms_per_epoch_best"] = min(
                r[f"{name}_selected_ms_per_epoch"] for r in runs if r["side"] == side)
    summary["identical_bits"] = {name: len({r[f"{name}_bits"] for r in runs}) == 1
                                 for name in SHAPES}
    summary["update_identical_bits"] = {name: len({r[f"{name}_update_bits"] for r in runs}) == 1
                                        for name in UPDATE_ROWS}
    summary["dp_identical_bits"] = {key[:-len("_bits")]: len({r[key] for r in runs}) == 1
                                    for key in runs[0] if "_dp_" in key and key.endswith("_bits")}
    summary["selected_identical_bits"] = {
        name: len({r[f"{name}_selected_bits"] for r in runs}) == 1 for name in SELECTED
        if len({r[f"{name}_selected"] for r in runs}) == 1}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

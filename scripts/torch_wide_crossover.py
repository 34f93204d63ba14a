#!/usr/bin/env python3
"""Time the W-blocked CUDA train kernel against the kernel a run would take
without it, on one card; with --dp, both data-parallel routes; with --modes,
cd_train.cu against the strip-split kernel of the estimator modes and the
resident kernel where its tiles fit.

    python3 scripts/torch_wide_crossover.py [--reps 5]
    python3 scripts/torch_wide_crossover.py --dp [--reps 3]
    python3 scripts/torch_wide_crossover.py --modes [--reps 5]

``ops.cd_epoch_cuda.select_kernel`` sends a run inside the W-blocked
kernel's scope (mean-field negative phase, mse monitor, plain gradient) to
``csrc/cd_train_wide.cu`` from ``WIDE_MIN_VISIBLE`` columns on, and below it
to the resident kernel (``csrc/cd_train_resident.cu``) where its tiles fit,
else to ``csrc/cd_train.cu``. This script measures where the W-blocked
kernel overtakes that other kernel (the one ``select_kernel`` picks with
the threshold out of the way): Gaussian RBMs, CD-1, lr 0.001,
standard-normal data from a seed, at H 400 and batch 20 for V = 784, 2000,
3000, 4096, 5000, 10000 and 20000 at float32 and for V = 3000, 4096, 5000
and 10000 at bf16 storage and compute (where the resident kernel holds
wider W), narrow shapes the resident kernel does not hold (V 1000 and 2000
at batch 64, 2000x1000), and the in-scope rows of the wide slice
(scripts/bench_wide.py's shapes: 20000x512, momentum 0.5 at float32 and at
bf16 storage, batch 64, 28000x400, 40000x1000 bf16). Each shape runs one epoch of 20 updates (10 at
batch 64 and at 40000x1000) per call, timed with CUDA events in the order
other, wide, wide, other after a warm-up call each; the better of each
side's two times counts. Per shape one JSON line with both kernels' µs per
update, the weights' bytes, and the W-blocked kernel's median µs in each
phase of an update from its own trace (``wide_trace_phases``) and its
launch plan (``wide_launch_plan``); then a summary line with the card's
name and power limit, whether the resident kernel is ahead wherever its
tiles fit (``resident_ahead_where_it_fits``: ``select_kernel`` tries it
first), and the smallest measured width from which the W-blocked kernel is
ahead of cd_train.cu at every measured shape at least that wide that the
resident kernel does not hold (``wide_ahead_of_cd_train_from``), which sets
``WIDE_MIN_VISIBLE``. Needs one CUDA device.

With --dp the same shapes (H 400 and batch 20, plus w20k_mom_bf16, w28k and
w40k_bf16) run through ``parallel.dp.train_rbm_shard_map(pallas_step=True)``
on a one-rank NCCL mesh, once on each route that
``ops.cd_epoch_cuda.select_dp_kernel`` chooses between (``WIDE_DP_MIN_VISIBLE``
set in this process to force it): ``csrc/cd_grads.cu``'s step, the
all-reduce of the flat statistics and its update, against
``csrc/cd_grads_wide.cu``'s step, the all-gather of the factors and its
update. Per shape and route, in the order cd_grads, wide, wide, cd_grads:
one epoch's wall time (host clock around a synchronised call, after a
warm-up epoch) and, from one torch.profiler trace of an epoch, the device
time per step of the route's two kernels and of every kernel. The better of
each route's two readings counts; "faster" compares the route's kernels.

With --modes, ``ops.cd_epoch_cuda.select_kernel``'s choice for a run under
tempering, the enhanced gradient or learned variance: ``csrc/cd_train.cu``
against ``csrc/cd_train_wide_modes.cu`` (``WIDE_MODES_MIN_VISIBLE``), each
called directly through ``kernel_run``, at H 400 and batch 20 (Gaussian, CD-1,
lr 0.001, standard-normal data from a seed) for V = 784, 1000, 1500, 2000,
3000, 4096, 5000, 10000 and 20000, under 3-rung tempering at bf16 storage and
compute (PCD, beta_min 0.3: the w20k_pt3_bf16 row's recipe), the enhanced
gradient and learned variance at float32 (w20k_enh, w20k_lv) and the
enhanced gradient at bf16; where the tiles fit the card, the resident
kernel's kModes variant (``csrc/cd_train_resident.cu``, which
``select_kernel`` tries first) too. One epoch of 20 updates per call, in the
order cd_train, wide_modes[, resident, resident], wide_modes, cd_train after
a warm-up call each; the better of each side's two times counts. One JSON
line per shape, then a summary with the card's name and power limit, the
smallest width from which the strip-split kernel is faster than cd_train.cu
at every measured width of every mode, and whether the resident kernel is
ahead of both wherever its tiles fit (``resident_ahead_where_it_fits``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(visible="gaussian", lr=0.001, batch_size=20, k=1, seed=0, n_hidden=400)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
SHAPES = {  # name -> (config fields on top of BASE, data rows)
    "v784": (dict(n_visible=784), 400),
    "v2000": (dict(n_visible=2000), 400),
    "v3000": (dict(n_visible=3000), 400),
    "v4096": (dict(n_visible=4096), 400),
    "v5000": (dict(n_visible=5000), 400),
    "v10000": (dict(n_visible=10000), 400),
    "v3000_bf16": (dict(n_visible=3000, **BF16), 400),
    "v4096_bf16": (dict(n_visible=4096, **BF16), 400),
    "v5000_bf16": (dict(n_visible=5000, **BF16), 400),
    "v10000_bf16": (dict(n_visible=10000, **BF16), 400),
    "v1000_b64": (dict(n_visible=1000, batch_size=64), 640),
    "v2000_b64": (dict(n_visible=2000, batch_size=64), 640),
    "v2000_h1000": (dict(n_visible=2000, n_hidden=1000), 400),
    "w20k": (dict(n_visible=20000), 400),
    "w20k_h512": (dict(n_visible=20000, n_hidden=512), 400),
    "w20k_mom": (dict(n_visible=20000, momentum=0.5), 400),
    "w20k_mom_bf16": (dict(n_visible=20000, momentum=0.5, **BF16), 400),
    "w20k_b64": (dict(n_visible=20000, batch_size=64), 640),
    "w28k": (dict(n_visible=28000), 400),
    "w40k_bf16": (dict(n_visible=40000, n_hidden=1000, **BF16), 200),
}


DP_SHAPES = ["v784", "v2000", "v3000", "v4096", "v5000", "v10000", "w20k", "w20k_mom_bf16",
             "w28k", "w40k_bf16"]
MODES_WIDTHS = (784, 1000, 1500, 2000, 3000, 4096, 5000, 10000, 20000)
MODES = {  # config fields on top of BASE (scripts/bench_wide.py's mode rows)
    "pt3_bf16": dict(persistent=True, pt_temps=3, pt_beta_min=0.3, **BF16),
    "enhanced": dict(gradient="enhanced"),
    "lv": dict(learn_variance=True),
    "enhanced_bf16": dict(gradient="enhanced", **BF16),
}
ROUTE_KERNELS = {"cd_grads": ("cd_grads_kernel", "cd_update_kernel"),
                 "cd_grads_wide": ("cd_wide_step_kernel", "cd_wide_update_kernel")}


def device_us(fn, names) -> tuple:
    """(device us of the kernels whose name contains one of ``names``, device
    us of every kernel) in one call of ``fn``, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    mine = every = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us > 0 and ev.self_cpu_time_total == 0:  # a kernel: device time, no CPU time
            every += us
            if any(n in ev.key for n in names):
                mine += us
    return mine, every


def dp_main(reps: int, smi: str) -> int:
    import time

    import torch
    import torch.distributed as dist

    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import torch_dtype
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.parallel import dp
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    mesh = make_mesh(1, backend="nccl")
    threshold, faster = K.WIDE_DP_MIN_VISIBLE, {}
    try:
        for name in DP_SHAPES:
            fields, n = SHAPES[name]
            cfg = RBMConfig(**{**BASE, **fields, "engine": "pallas"})
            gen = torch.Generator(device=dev).manual_seed(0)
            data = torch.randn((n, cfg.n_visible), generator=gen,
                               device=dev).to(torch_dtype(cfg.param_dtype))
            st = init_train_state(cfg, device=dev)
            nb = n // cfg.batch_size

            def epoch():
                dp.train_rbm_shard_map(st, data, cfg, mesh, 1, pallas_step=True)

            rec = {route: {"wall_ms": [], "kernels_us_per_step": [], "all_us_per_step": []}
                   for route in ROUTE_KERNELS}
            for route in ("cd_grads", "cd_grads_wide", "cd_grads_wide", "cd_grads"):
                K.WIDE_DP_MIN_VISIBLE = 1 if route == "cd_grads_wide" else 1 << 30
                if K.select_dp_kernel(cfg) != route:
                    raise AssertionError(f"{name}: could not force the route {route}")
                epoch()  # warm-up
                walls = []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    epoch()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                mine, every = device_us(epoch, ROUTE_KERNELS[route])
                rec[route]["wall_ms"].append(min(walls))
                rec[route]["kernels_us_per_step"].append(mine / nb)
                rec[route]["all_us_per_step"].append(every / nb)
            K.WIDE_DP_MIN_VISIBLE = threshold
            best = {r: min(v["kernels_us_per_step"]) for r, v in rec.items()}
            faster[name] = min(best, key=best.get)
            print(json.dumps({
                "shape": name, "V": cfg.n_visible, "H": cfg.n_hidden, "B": cfg.batch_size,
                "param_dtype": cfg.param_dtype, "steps_per_epoch": nb,
                "cd_grads_us_per_step": best["cd_grads"],
                "cd_grads_wide_us_per_step": best["cd_grads_wide"],
                "routes": rec, "select_dp_kernel": K.select_dp_kernel(cfg),
                "faster": faster[name]}), flush=True)
    finally:
        K.WIDE_DP_MIN_VISIBLE = threshold
        dist.destroy_process_group()
    print(json.dumps({"order": "cd_grads, wide, wide, cd_grads", "nvidia_smi": smi,
                      "ranks": 1, "backend": "nccl", "faster": faster}))
    return 0


def modes_main(reps: int, smi: str) -> int:
    import torch

    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import torch_dtype
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R

    dev = torch.device("cuda", 0)
    faster, resident_ahead = {}, {}
    for mode, fields in MODES.items():
        for v in MODES_WIDTHS:
            cfg = RBMConfig(**{**BASE, **fields, "n_visible": v})
            if K.wide_modes_unsupported(cfg) is not None:
                raise AssertionError(f"{mode}: outside the strip-split kernel's scope")
            gen = torch.Generator(device=dev).manual_seed(0)
            data = torch.randn((400, v), generator=gen,
                               device=dev).to(torch_dtype(cfg.param_dtype))
            st = init_train_state(cfg, device=dev)
            nb = 400 // cfg.batch_size
            order = K.batch_order(cfg, nb, 1, None)
            seeds = torch.Generator().manual_seed(0)

            def run(kern):
                K.kernel_run(kern)(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                   None, seeds)

            fits = R.resident_admits(cfg, R.device_limits(cfg, dev))
            kernels = ("cd_train", "cd_train_wide_modes") + (("cd_train_resident",)
                                                             if fits else ())
            times = {k: [] for k in kernels}
            for kern in kernels + kernels[::-1]:
                times[kern].append(time_runs(lambda kern=kern: run(kern), reps) * 1e6 / nb)
            best = {k: min(t) for k, t in times.items()}
            faster[f"{mode}@{v}"] = min(("cd_train", "cd_train_wide_modes"), key=best.get)
            if fits:
                resident_ahead[f"{mode}@{v}"] = min(best, key=best.get) == "cd_train_resident"
            print(json.dumps({
                "mode": mode, "V": v, "H": cfg.n_hidden, "B": cfg.batch_size,
                "param_dtype": cfg.param_dtype, "updates_per_run": nb,
                "cd_train_us_per_update": best["cd_train"],
                "cd_train_wide_modes_us_per_update": best["cd_train_wide_modes"],
                "cd_train_us_calls": times["cd_train"],
                "cd_train_wide_modes_us_calls": times["cd_train_wide_modes"],
                "cd_train_resident_us_per_update": best.get("cd_train_resident"),
                "cd_train_resident_us_calls": times.get("cd_train_resident"),
                "select_kernel": K.select_kernel(cfg),
                "faster": faster[f"{mode}@{v}"]}), flush=True)
    # the smallest measured width from which the strip-split kernel wins at
    # every larger measured width of every mode
    ahead = [v for v in MODES_WIDTHS
             if all(faster[f"{m}@{w}"] == "cd_train_wide_modes"
                    for m in MODES for w in MODES_WIDTHS if w >= v)]
    print(json.dumps({"order": "cd_train, wide_modes[, resident, resident], wide_modes, "
                               "cd_train",
                      "nvidia_smi": smi, "faster": faster,
                      "resident_ahead_where_it_fits": all(resident_ahead.values()),
                      "resident_ahead": resident_ahead,
                      "wide_modes_ahead_from": min(ahead) if ahead else None,
                      "WIDE_MODES_MIN_VISIBLE": K.WIDE_MODES_MIN_VISIBLE}))
    return 0


def time_runs(fn, reps: int) -> float:
    """Mean seconds per call of ``fn`` on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dp", action="store_true",
                    help="time the two data-parallel routes on one NCCL rank")
    ap.add_argument("--modes", action="store_true",
                    help="time cd_train.cu against the strip-split kernel of the modes")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_wide_crossover: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mdbn_tpu_torch._build import build_all
    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import torch_dtype
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build_all()
    if args.dp:
        return dp_main(args.reps, smi)
    if args.modes:
        return modes_main(args.reps, smi)
    from mdbn_tpu_torch.ops import cd_epoch_wide_cuda as KW
    from mdbn_tpu_torch.ops.cd_epoch_resident_cuda import device_limits

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    faster, others, threshold = {}, {}, K.WIDE_MIN_VISIBLE
    for name, (fields, n) in SHAPES.items():
        cfg = RBMConfig(**{**BASE, **fields})
        limits = device_limits(cfg, dev)
        K.WIDE_MIN_VISIBLE = 1 << 30  # the kernel select_kernel picks without the W-blocked one
        other = others[name] = K.select_kernel(cfg, limits)
        K.WIDE_MIN_VISIBLE = threshold
        gen = torch.Generator(device=dev).manual_seed(0)
        data = torch.randn((n, cfg.n_visible), generator=gen,
                           device=dev).to(torch_dtype(cfg.param_dtype))
        st = init_train_state(cfg, device=dev)
        nb = n // cfg.batch_size
        order = K.batch_order(cfg, nb, 1, None)
        seeds = torch.Generator().manual_seed(0)

        def run(kern, trace=None):
            K.kernel_run(kern)(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                               seeds, **({} if trace is None else {"trace": trace}))

        kerns = (other, "cd_train_wide")
        times = {k: [] for k in kerns}
        for kern in kerns + kerns[::-1]:
            times[kern].append(time_runs(lambda kern=kern: run(kern), args.reps) * 1e6 / nb)
        phases = KW.wide_trace_phases(cfg)
        trace = torch.zeros((1, nb, len(phases) + 1), dtype=torch.int64, device=dev)
        run("cd_train_wide", trace)
        torch.cuda.synchronize()
        spans = (trace[0, :, 1:] - trace[0, :, :-1]).double().median(0).values / 1e3
        best = {k: min(t) for k, t in times.items()}
        width = 2 if cfg.param_dtype == "bfloat16" else 4
        faster[name] = min(best, key=best.get)
        print(json.dumps({
            "shape": name, "V": cfg.n_visible, "H": cfg.n_hidden, "B": cfg.batch_size,
            "momentum": cfg.momentum, "param_dtype": cfg.param_dtype,
            "w_bytes": cfg.n_visible * cfg.n_hidden * width, "updates_per_run": nb,
            "other": other, "other_us_per_update": best[other],
            "cd_train_wide_us_per_update": best["cd_train_wide"],
            "other_us_calls": times[other], "cd_train_wide_us_calls": times["cd_train_wide"],
            "cd_train_wide_phase_us_median": dict(zip(phases, spans.tolist())),
            "launch_plan": KW.wide_launch_plan(cfg).__dict__,
            "select_kernel": K.select_kernel(cfg, limits), "faster": faster[name]}),
            flush=True)
    # the resident kernel against the W-blocked one where its tiles fit; the
    # W-blocked kernel against cd_train.cu from the smallest measured width at
    # which it is ahead at every measured shape at least that wide
    on_cd_train = {n: SHAPES[n][0]["n_visible"] for n in SHAPES if others[n] == "cd_train"}
    ahead = [v for v in sorted(set(on_cd_train.values()))
             if all(faster[n] == "cd_train_wide" for n, w in on_cd_train.items() if w >= v)]
    print(json.dumps({"order": "other, wide, wide, other", "nvidia_smi": smi,
                      "l2_bytes": l2, "faster": faster,
                      "resident_ahead_where_it_fits": all(
                          faster[n] == "cd_train_resident" for n in SHAPES
                          if others[n] == "cd_train_resident"),
                      "wide_ahead_of_cd_train_from": min(ahead) if ahead else None,
                      "WIDE_MIN_VISIBLE": K.WIDE_MIN_VISIBLE}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

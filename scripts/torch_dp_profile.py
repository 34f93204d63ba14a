#!/usr/bin/env python3
"""Where a step of the data-parallel path goes, on one card.

    python3 scripts/torch_dp_profile.py [--epochs 20] [--eager] [--wide ROW] [--out profile_out]

Runs c1 (configs/c1_bernoulli_rbm_mnist.json: 784x500, batch 20, CD-1, 100
steps per epoch) through ``parallel.dp.train_rbm_shard_map(pallas_step=True)``
on a one-rank NCCL mesh, the program of chip_smoke.py's dp_world1 phase, or
with ``--wide ROW`` one of chip_smoke.py's W-blocked DP rows (w20k,
w20k_mom_bf16, w28k, w40k_bf16: step, all-gather, update) as its phase 21
runs it: by default as a captured epoch (one CUDA graph of the epoch's
steps, captured once a call and replayed every epoch), with ``--eager`` as
the eager loop of the same launches:

- times calls of one epoch and of ``--epochs`` + 1 epochs, each three times:
  host clock around each synchronised call; the difference over
  ``--epochs`` is the time of an epoch past a call's fixed work (the
  capture among it); with the host's load average and the CPU cores this
  process may use, before and after;
- takes one torch.profiler trace (CPU and CUDA activity) of the longer
  call: the device time of each kernel a step; the device's busy share over
  the call's device time from the first step kernel's start (a capture,
  made on the host before it, drops out) to the last kernel's end (the union
  of the device activity over that window), and over the whole call's wall
  time; the host time of its ops;
- runs the step kernel once more alone with its trace stamps: the median
  time of each step of its phases (ops.cd_epoch_resident_cuda's
  resident_trace_phases; the update's stamp marks the statistics); on the
  W-blocked route the update kernel instead (ops.cd_grads_wide_cuda's
  UPDATE_TRACE, block 0's: Y staged, then summed over its tiles the wait for
  the ring, the sums and the update, then c).

Prints one JSON line with the card's name and power limit; writes the
profiler's tables to ``<out>/dp_profile.txt`` and the longer call's trace to
``<out>/dp_profile_trace.json``. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--eager", action="store_true", help="the eager loop, not the captured epoch")
    ap.add_argument("--wide", choices=("w20k", "w20k_mom_bf16", "w28k", "w40k_bf16"),
                    help="a W-blocked DP row of chip_smoke.py instead of c1")
    ap.add_argument("--out", default=os.path.join(HERE, "profile_out"))
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_dp_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mdbn_tpu_torch.config import load_config
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
    from mdbn_tpu_torch.ops.cd_epoch_cuda import select_dp_kernel
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh
    from mdbn_tpu_torch.run import build_data

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.wide:
        from chip_smoke import wide_row

        cfg, data = wide_row(args.wide, dev)
        cfg = cfg.replace(engine="pallas")
    else:
        exp = load_config(os.path.join(HERE, "configs", "c1_bernoulli_rbm_mnist.json"))
        cfg = exp["model"].replace(engine="pallas")
        data = torch.as_tensor(build_data(exp["data"])[0], device=dev)
    nb = data.shape[0] // cfg.batch_size
    route = select_dp_kernel(cfg, 1, GR.step_limits(cfg, dev))
    mesh = make_mesh(1, backend="nccl")
    st = init_train_state(cfg, device=dev)
    capture = not args.eager

    def call(n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_rbm_shard_map(st, data, cfg, mesh, n, pallas_step=True, capture=capture)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    call(1)  # warm-up: builds the kernels, starts NCCL
    load_before = os.getloadavg()
    short_ms, long_ms = [], []
    for _ in range(3):
        short_ms.append(call(1))
        long_ms.append(call(args.epochs + 1))
    load_after = os.getloadavg()
    epoch_ms = [(b - a) / args.epochs for a, b in zip(short_ms, long_ms)]

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = call(args.epochs + 1)
    events = prof.key_averages()
    # device kernels: events with device time and no CPU time of their own
    kernels = {e.key: dev_us(e) for e in events if dev_us(e) > 0 and e.self_cpu_time_total == 0}
    per_step = {k: v / ((args.epochs + 1) * nb) for k, v in kernels.items()}
    dev_evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    start = min(e.time_range.start for e in dev_evs
                if any(n in e.name for n in ("cd_train_resident_kernel", "cd_grads_kernel",
                                              "cd_wide_step_kernel")))
    spans = sorted((max(e.time_range.start, start), e.time_range.end) for e in dev_evs
                   if e.time_range.end > start)
    busy, lo, hi = 0.0, None, None
    for a, b in spans:  # the union of the device intervals
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window_us = max(b for _, b in spans) - start
    host_ops = {e.key: float(e.cpu_time_total) for e in events
                if e.cpu_time_total > 0 and e.key.startswith(("c10d::", "nccl:", "aten::",
                                                              "cuda"))}
    top_host = dict(sorted(host_ops.items(), key=lambda kv: -kv[1])[:12])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "dp_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40) + "\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=20) + "\n")
    prof.export_chrome_trace(os.path.join(args.out, "dp_profile_trace.json"))

    # the step kernel's own clock: the median of each step of its phases
    phases = None
    if route == "cd_grads_resident":
        p, v0 = st.params, data[:cfg.batch_size]
        trace = torch.zeros((1, 1, R.resident_trace_len(cfg)), dtype=torch.int64, device=dev)
        launch = GR.step_launcher(cfg, p, v0, st.chain_h, seed=5, trace=trace)[0]
        steps = []
        for _ in range(50):
            launch()
            torch.cuda.synchronize()
            steps.append((trace[0, 0, 1:] - trace[0, 0, :-1]).double() / 1e3)
        med = torch.stack(steps).median(0).values.tolist()
        phases = dict(zip(R.resident_trace_phases(cfg), med))
        phases["total"] = sum(med)
    elif route == "cd_grads_wide":  # the update's phases on one rank's slot of a step
        from mdbn_tpu_torch.ops import cd_grads_wide_cuda as GW

        p, vel = st.params.map(torch.clone), st.velocity.map(torch.clone)
        v0 = data[:cfg.batch_size]
        slot, _ = GW.cd_wide_step(cfg, p, v0, st.chain_h, seed=5)
        trace = torch.zeros(len(GW.UPDATE_TRACE), dtype=torch.int64, device=dev)
        launch = GW.update_launcher(cfg, p, vel, v0, slot, 1, 1.0, 0, trace=trace)[0]
        steps = []
        for _ in range(50):
            launch()
            torch.cuda.synchronize()
            t = dict(zip(GW.UPDATE_TRACE, trace.double().tolist()))
            steps.append([t["y_staged"] - t["entry"], t["ring_wait_ns"], t["sums_ns"],
                          t["update_ns"], t["exit"] - t["tiles_done"], t["exit"] - t["entry"]])
        med = torch.tensor(steps).median(0).values.div(1e3).tolist()
        phases = dict(zip(("y_staged", "ring_wait", "sums", "update", "c_after", "total"), med))
        phases["tiles_of_block_0"] = int(t["tiles"])
    dist.destroy_process_group()
    print(json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__, "route": route, "captured": capture,
        "steps_per_epoch": nb, "one_epoch_call_ms": short_ms,
        f"{args.epochs + 1}_epoch_call_ms": long_ms, "epoch_ms": epoch_ms,
        "step_us": [e * 1e3 / nb for e in epoch_ms],
        "loadavg_before": load_before, "loadavg_after": load_after,
        "cpu_cores_usable": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(),
        "profiled_call_wall_ms": wall_ms, "device_window_ms": window_us / 1e3,
        "device_window_ms_per_epoch": window_us / 1e3 / (args.epochs + 1),
        "device_busy_share": busy / window_us,
        "device_busy_share_whole_call": sum(kernels.values()) / (wall_ms * 1e3),
        "kernel_device_us_per_step": per_step,
        "host_op_us_per_step (inclusive)": {k: v / ((args.epochs + 1) * nb)
                                            for k, v in top_host.items()},
        ("update_kernel_phase_us" if route == "cd_grads_wide" else "step_kernel_phase_us"):
            phases,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

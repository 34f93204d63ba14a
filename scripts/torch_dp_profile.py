#!/usr/bin/env python3
"""Where a step of the data-parallel path goes, on one card.

    python3 scripts/torch_dp_profile.py [--epochs 5] [--out profile_out]

Runs c1 (configs/c1_bernoulli_rbm_mnist.json: 784x500, batch 20, CD-1, 100
steps per epoch) through ``parallel.dp.train_rbm_shard_map(pallas_step=True)``
on a one-rank NCCL mesh, the program of chip_smoke.py's dp_world1 phase:

- times ``--epochs`` epochs one call at a time after a warm-up epoch: host
  clock around each synchronised call, and CUDA events; with the host's load
  average and the CPU cores this process may use, before and after;
- takes one torch.profiler trace (CPU and CUDA activity) of one more epoch:
  the device time of each kernel summed over the epoch, the device's busy
  and idle shares of the epoch's wall time, and the host time of the ops
  each step calls.

Prints one JSON line with the card's name and power limit; writes the
profiler's tables to ``<out>/dp_profile.txt`` and its trace to
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
    ap.add_argument("--epochs", type=int, default=5)
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
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh
    from mdbn_tpu_torch.run import build_data

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    exp = load_config(os.path.join(HERE, "configs", "c1_bernoulli_rbm_mnist.json"))
    cfg = exp["model"].replace(engine="pallas")
    data = torch.as_tensor(build_data(exp["data"])[0], device=dev)
    nb = data.shape[0] // cfg.batch_size
    mesh = make_mesh(1, backend="nccl")
    st = init_train_state(cfg, device=dev)
    epoch = lambda: train_rbm_shard_map(st, data, cfg, mesh, 1, pallas_step=True)
    epoch()  # warm-up: builds the kernels, starts NCCL
    torch.cuda.synchronize()
    load_before = os.getloadavg()
    host_ms, event_ms = [], []
    for _ in range(args.epochs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        epoch()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    load_after = os.getloadavg()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))

    # device kernels: events with device time and no CPU time of their own
    kernels = {e.key: dev_us(e) for e in events if dev_us(e) > 0 and e.self_cpu_time_total == 0}
    busy = sum(kernels.values())
    host_ops = {e.key: float(e.cpu_time_total) for e in events
                if e.cpu_time_total > 0 and e.key.startswith(("c10d::", "nccl:", "aten::",
                                                              "cuda"))}
    top_host = dict(sorted(host_ops.items(), key=lambda kv: -kv[1])[:12])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "dp_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40) + "\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=20) + "\n")
    prof.export_chrome_trace(os.path.join(args.out, "dp_profile_trace.json"))
    dist.destroy_process_group()
    print(json.dumps({
        "nvidia_smi": smi, "torch": torch.__version__, "steps_per_epoch": nb,
        "epoch_ms_host": host_ms, "epoch_ms_events": event_ms,
        "loadavg_before": load_before, "loadavg_after": load_after,
        "cpu_cores_usable": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(),
        "profiled_epoch_wall_us": wall_us, "profiled_step_wall_us": wall_us / nb,
        "device_busy_us": busy, "device_busy_share": busy / wall_us,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernel_device_us_per_step": {k: v / nb for k, v in kernels.items()},
        "kernel_share_of_wall": {k: v / wall_us for k, v in kernels.items()},
        "host_op_us_per_step (inclusive)": {k: v / nb for k, v in top_host.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

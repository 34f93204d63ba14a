#!/usr/bin/env python3
"""Time the CUDA train kernel of two checkouts of mdbn_tpu_torch on one card.

    python3 scripts/torch_kernel_ab.py --base DIR [--reps 20]

Runs the checkout at DIR (the base) and this checkout in separate processes,
in the order base, this, this, base. Each process builds its own kernel from
its own sources, runs one warm-up epoch per shape, then times ``reps``
one-epoch kernel runs with CUDA events at two shapes the graded configs
train at: c1 (Bernoulli 784x500, B 20, CD-1) and c2 (Gaussian 2000x400,
B 20, CD-1, mean-field visibles). Prints one JSON line per process, then a
summary line with each side's best time and the card's name and power
limit. Needs one CUDA device; writes only each checkout's kernel build.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"c1": dict(n_visible=784, n_hidden=500, batch_size=20, lr=0.1),
          "c2": dict(n_visible=2000, n_hidden=400, batch_size=20, lr=0.01,
                     visible="gaussian")}


def child(root: str, reps: int) -> dict:
    sys.path.insert(0, root)
    import torch

    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K

    dev = torch.device("cuda", 0)
    out = {"root": root}
    for name, kw in SHAPES.items():
        cfg = RBMConfig(**kw)
        gen = torch.Generator().manual_seed(0)
        data = (torch.rand((2000, cfg.n_visible), generator=gen) < 0.3).float().to(dev)
        st = init_train_state(cfg, device=dev)
        order = K.batch_order(cfg, 100, 1, None)

        def run():
            K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None, gen)

        run()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        out[f"{name}_ms_per_epoch"] = start.elapsed_time(end) / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="root of the checkout to compare against")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.reps)), flush=True)
        return 0
    if not args.base:
        ap.error("--base is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
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
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the CUDA train kernels of two checkouts of mdbn_tpu_torch on one card.

    python3 scripts/torch_kernel_ab.py --base DIR [--reps 20]

Runs the checkout at DIR (the base) and this checkout in separate processes,
in the order base, this, this, base. Each process builds its own kernels
from its own sources, runs one warm-up epoch per shape, then times ``reps``
one-epoch kernel runs with CUDA events at two shapes the graded configs
train at on csrc/cd_train.cu, c1 (Bernoulli 784x500, B 20, CD-1) and c2
(Gaussian 2000x400, B 20, CD-1, mean-field visibles), and at two rows of the
wide slice on the W-blocked csrc/cd_train_wide.cu, w20k (Gaussian
20000x400, B 20, lr 0.001) and w20k_mom_bf16 (the same with momentum 0.5 at
bf16 storage and compute). Each process also hashes the parameters and
velocities after a 2-epoch run from a fixed state with the kernel's own
draws from a fixed seed, so the summary says whether the two checkouts'
kernels give the same bits. Prints one JSON line per process, then a
summary line with each side's best time and the card's name and power
limit. Needs one CUDA device; writes only each checkout's kernel build.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE = dict(n_visible=20000, n_hidden=400, batch_size=20, lr=0.001, visible="gaussian")
SHAPES = {  # name -> (config fields, data rows, the W-blocked kernel)
    "c1": (dict(n_visible=784, n_hidden=500, batch_size=20, lr=0.1), 2000, False),
    "c2": (dict(n_visible=2000, n_hidden=400, batch_size=20, lr=0.01, visible="gaussian"),
           2000, False),
    "w20k": (WIDE, 400, True),
    "w20k_mom_bf16": (dict(WIDE, momentum=0.5, param_dtype="bfloat16",
                           compute_dtype="bfloat16"), 400, True),
}


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    summary["identical_bits"] = {name: len({r[f"{name}_bits"] for r in runs}) == 1
                                 for name in SHAPES}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

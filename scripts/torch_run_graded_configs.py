#!/usr/bin/env python3
"""Run the seven graded configurations through mdbn_tpu_torch's CLI on the
card and record the outcomes in GRADED_RUNS_TORCH.md.

    python3 scripts/torch_run_graded_configs.py [--epochs 10] [--out GRADED_RUNS_TORCH.md]

Each config in configs/ runs as ``python -m mdbn_tpu_torch.run --config ...
--epochs N --metrics ...`` in a process of its own. The two real-data
configs run on fixture files written to a temporary directory with the
recipe and seeds of scripts/run_graded_configs.py (an IDX file of 2000 random
28x28 images from numpy's generator seeded 0, and tcga_like(200, seed=1)'s
three modalities as CSVs), here from the port's own data.synthetic.tcga_like,
so the files are the same bytes. Each row gives the wall seconds of the
process, the kernel each trained layer took (from the metrics file) and the
outcome, under a heading with the card's name and power limit. Needs one
CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def make_real_data_fixtures(fixdir: str) -> dict:
    """The IDX image file of the mnist_idx loader and the three omics CSVs of
    the omics_csv loader, in the formats the loaders parse."""
    from mdbn_tpu_torch.data.synthetic import tcga_like

    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2000, 28, 28)).astype(np.uint8)
    idx_path = os.path.join(fixdir, "images.idx")
    with open(idx_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, *imgs.shape))
        f.write(imgs.tobytes())
    mods, _ = tcga_like(n_patients=200, seed=1)
    csv_paths = {}
    for m, mat in mods.items():
        p = os.path.join(fixdir, f"{m}.csv")
        np.savetxt(p, np.asarray(mat), delimiter=",")
        csv_paths[m] = p
    return {"mnist_idx": idx_path, "omics_csv": csv_paths}


def rewrite_real_config(cfg_path: str, fixtures: dict, outdir: str) -> str:
    """A real-data config pointed at the fixtures (others as they are)."""
    with open(cfg_path) as f:
        exp = json.load(f)
    kind = exp.get("data", {}).get("kind")
    if kind == "mnist_idx":
        exp["data"]["path"] = fixtures["mnist_idx"]
    elif kind == "omics_csv":
        exp["data"]["paths"] = fixtures["omics_csv"]
    else:
        return cfg_path
    out = os.path.join(outdir, os.path.basename(cfg_path))
    with open(out, "w") as f:
        json.dump(exp, f)
    return out


def summarize(recs: list) -> tuple:
    """(kernels, outcome) of one run's metrics records."""
    epochs = [r for r in recs if r["kind"] == "epoch"]
    layers = [r for r in recs if r["kind"] == "layer"]
    towers = [r for r in recs if r["kind"] == "tower" and r["name"] != "joint"]
    km = [r for r in recs if r["kind"] == "kmeans"]
    kernels = sorted({r["kernel"] for r in epochs + layers if r.get("kernel")}
                     | {k for r in recs if r["kind"] == "tower" for k in r["kernels"] if k})
    summary = ""
    if epochs:
        summary = (f"err {epochs[0]['recon_error']:.4f} → {epochs[-1]['recon_error']:.4f} "
                   f"({epochs[0]['engine']})")
    elif layers:
        summary = "; ".join(f"L{r['layer']}: {r['errors'][0]:.4f}→{r['errors'][-1]:.4f}"
                            for r in layers)
    elif towers:
        summary = f"{len(towers)} towers + joint trained"
    for k in km:
        ari = k.get("ari_vs_planted")
        summary += (f"; ARI {ari:.3f}" if ari is not None
                    else f"; clusters {k['cluster_sizes']} (no planted labels)")
        if "logrank" in k:
            summary += f"; log-rank p={k['logrank']['p_value']:.1e}"
    return kernels, summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(HERE, "GRADED_RUNS_TORCH.md"))
    ap.add_argument("--per-config-timeout", type=int, default=900)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_run_graded_configs: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    rows = []
    with tempfile.TemporaryDirectory(prefix="mdbn_fixtures_") as fixroot:
        fixtures = make_real_data_fixtures(fixroot)
        for cfg_path in sorted(glob.glob(os.path.join(HERE, "configs", "*.json"))):
            name = os.path.basename(cfg_path)
            if "real" in name:
                cfg_path = rewrite_real_config(cfg_path, fixtures, fixroot)
                name += " (generated fixture files)"
            metrics = os.path.join(fixroot, name.split()[0] + ".jsonl")
            t0 = time.time()
            try:
                proc = subprocess.run(
                    [sys.executable, "-m", "mdbn_tpu_torch.run", "--config", cfg_path,
                     "--epochs", str(args.epochs), "--metrics", metrics],
                    capture_output=True, text=True, timeout=args.per_config_timeout, cwd=HERE)
                ok = proc.returncode == 0
                tail = (proc.stderr or "")[-300:].replace("\n", " ")
            except subprocess.TimeoutExpired:
                ok, tail = False, f"timed out after {args.per_config_timeout}s"
            dt = time.time() - t0
            kernels, summary = [], tail
            if ok:
                with open(metrics) as f:
                    kernels, summary = summarize([json.loads(l) for l in f])
            rows.append((name, "PASS" if ok else "FAIL", dt, ", ".join(kernels), summary))
            print(json.dumps({"config": name, "ok": ok, "seconds": round(dt, 1),
                              "kernels": kernels, "outcome": summary}), flush=True)
    lines = ["# GRADED_RUNS_TORCH — the seven graded configurations through mdbn_tpu_torch",
             "",
             f"Card: {smi} (name, power limit); --epochs {args.epochs}; synthetic stand-in "
             "data and generated fixture files (no network); written by "
             "scripts/torch_run_graded_configs.py.",
             "",
             "| config | status | wall | kernel | outcome |",
             "|---|---|---|---|---|"]
    lines += [f"| {n} | {s} | {dt:.0f}s | {k} | {o} |" for n, s, dt, k, o in rows]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0 if all(r[1] == "PASS" for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

"""The readings the comparison's limits are set from, at a cell's own size.

    python3 bench_port/readings.py --workload <cell> --seeds 12 --control-seeds 3

In one process, for each seed: the cell's data made from it, as many of the
cell's jobs as a run's comparison samples, run through the measured program
and held against the reference exactly as a run holds its sampled jobs (the
lower readings); the same with the program at bfloat16 storage and compute,
its own lower-precision path (the control); and the faults a run must catch,
planted in the reference put in the program's place ("unchanged",
"half_batch", "altered", and on several cards "no_exchange": see
``reference.rbm.fit``). Prints one JSON line per reading and a summary: for
each number compared, the largest sound reading and the smallest reading of
the control and of each fault. The benchmark's runs do not run this. A cell on
several cards runs under ``python -m torch.distributed.run --nproc-per-node N``;
rank 0 compares and prints.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import run  # noqa: E402
from bench_port.reference import rbm as ref  # noqa: E402

BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def readings(cell: str, seed: int, kind: str, log, mesh=None) -> dict:
    import torch

    _, _, config, workload = run.load_cell(cell)
    device = torch.device("cuda", 0) if mesh is None else mesh.device
    rank = 0 if mesh is None else mesh.rank
    if rank != 0 and kind not in ("sound", "control"):
        return {}  # the reference in the program's place runs on rank 0 alone
    data = run.load_module("data", workload["data"]["kind"]).make(workload["data"], seed, device)
    jobs = run.load_module("jobs", workload["job"]["kind"])
    fit, overrides = None, None
    if kind == "control":
        overrides = BF16
    elif kind != "sound":
        def fit(job_seed):
            return ref.fit(fits.spec, data, job_seed, fits.stream, fault=kind)
    fits = jobs.Fits(config, workload, data, fit=fit, overrides=overrides,
                     mesh=None if fit is not None else mesh)
    kept = []
    for i in range(int(workload["check"]["jobs"])):
        s = run.job_seed(seed, i)
        kept.append((s, fits.outputs(fits.run(s)).to("cpu")))
    torch.cuda.synchronize()
    if rank != 0:
        return {}
    values = fits.check(kept, log=log)
    return {"cell": cell, "seed": seed, "kind": kind, **values}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="unchanged,half_batch,altered")
    p.add_argument("--ranks", type=int, default=1, help="cards: one process each, under torchrun")
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = p.parse_args(argv)
    log = (lambda msg: print(msg, file=sys.stderr, flush=True))
    import torch

    torch.set_num_threads(run.HOST_THREADS)

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 3
    mesh = None
    if args.ranks > 1:
        from mdbn_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(args.ranks)
    plan = [("sound", args.first_seed + i) for i in range(args.seeds)]
    for kind in ["control"] + [f for f in args.faults.split(",") if f]:
        plan += [(kind, args.first_seed + 1000 + i) for i in range(args.control_seeds)]
    rows = []
    for kind, seed in plan:
        t0 = time.perf_counter()
        row = readings(args.workload, seed, kind, log, mesh)
        if not row:
            continue
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    if mesh is not None and mesh.rank != 0:
        return 0
    names = ("last_update_gap", "fit_error_gap", "fit_param_gap")
    summary = {"cell": args.workload,
               "lower": {n: max(r[n] for r in rows if r["kind"] == "sound") for n in names}}
    for kind in sorted({r["kind"] for r in rows} - {"sound"}):
        summary[kind] = {n: min(r[n] for r in rows if r["kind"] == kind) for n in names}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

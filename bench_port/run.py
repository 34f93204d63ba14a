"""The benchmark of mdbn_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration
(``bench_port/configs/<config>.json``), and ``bench_port/workloads/<cell>.json``
holds its traffic: the data kind (``bench_port/data/<kind>.py``), the job kind
(``bench_port/jobs/<kind>.py``), the route its jobs must take, what the trace
covers and the comparison's parameters and limits. A per-layer metric is read
by ``bench_port/metrics/<name>.py``. A new cell, configuration or metric is a
new file and a new entry; no file here needs an edit.

A run keeps its process to ``HOST_THREADS`` CPU threads, makes the cell's
data from ``--seed`` on the card, warms up with one
job of the cell's own shape (the first run in a checkout builds the program's
kernels there), then runs a closed loop of one client for ``--seconds``
(``window.py``), each job with a seed of its own drawn from ``--seed``. With
``--trace 1`` a short stretch of jobs in the middle of the window runs under
torch.profiler and the per-layer metrics are read from it; with ``--trace 0``
the end-to-end metrics are printed. After the window the device's peak memory
is read, the program's state is let go, and a sample of the window's jobs
drawn from the seed is held against the plain reference (``reference/``).
Each number compared is printed beside its limit as the last lines on
standard error and under ``checks``, the last key of the result, which is the
last line on standard output.

A run exits non-zero and prints no result when there are fewer CUDA devices
than the cell asks for, and when a module of JAX or of the JAX package
(top-level name ``jax``, ``jaxlib``, ``flax`` or ``mdbn_tpu``) is loaded.
"""

import time

T_START, T_START_EPOCH = time.perf_counter(), time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "mdbn_tpu")
BENCH = Path(__file__).resolve().parent
_M64 = (1 << 64) - 1
RANK_SECONDS = 1500  # the ranks of a cell on several cards end within this
# CPU threads of a run's process: the program's host work a job is serial, and a
# pool of a thread a core, spinning beside it on a shared host, spread the jobs'
# times (c1's p95 over 12 s: 42.6-58.4 ms at 8 threads, 36.2-36.4 ms at 1)
HOST_THREADS = 1


def load_cell(name: str):
    """(manifest, the cell's entry, its configuration dict, its workload dict)."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[name]
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    return manifest, cell, config, workload


def job_seed(seed: int, index: int) -> int:
    """A job's own 63-bit seed: splitmix64 of the run's seed and the job's index."""
    z = ((seed & _M64) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(kind: str, name: str):
    """``bench_port/<kind>/<name>.py`` as a module (a metric's name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card(torch, chips: int) -> dict:
    """The card's name, the count used and its power limit (nvidia-smi)."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = [f"nvidia-smi failed: {exc}"]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": smi[0] if smi else "unknown"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a cell on several cards, started by the run's first process
    for name in ("--rank", "--world", "--port"):
        p.add_argument(name, type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, fit=None, overrides=None, device=None, log=None) -> int:
    """One run. ``fit`` (a stand-in for the program's job), ``overrides``
    (fields of the program's config) and ``device`` serve the tests and the
    control: with ``device`` given no card is looked for."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse(argv)
    log = log or _stderr
    manifest, cell, config, workload = load_cell(args.workload)
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)

    if device is None and args.rank is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < cell["chips"]:
            log(f"the cell {cell['name']} needs {cell['chips']} CUDA device(s); found {found}")
            return 3
        if cell["chips"] > 1:
            return launch(argv, cell["chips"], log)
    return run_rank(args, manifest, cell, config, workload, fit, overrides, device, log)


def launch(argv, world: int, log) -> int:
    """A cell on ``world`` cards: one process a card (this file with ``--rank``),
    joined over NCCL on a free localhost port; they hand their results back
    through files in a directory under TMPDIR. Prints rank 0's result, with the
    peak memory of the fullest card."""
    import shutil
    import socket
    import tempfile

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = Path(tempfile.mkdtemp(prefix="bench_port."))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *argv,
                               "--rank", str(r), "--world", str(world), "--port", str(port),
                               "--out", str(out)], env={**os.environ, "LOCAL_RANK": str(r)})
             for r in range(world)]
    try:
        deadline = time.monotonic() + RANK_SECONDS
        codes = []
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if any(c != 0 for c in codes):
            log(f"the ranks ended with {codes}")
            return 6
        line = json.loads((out / "result.json").read_text())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    if "setup_s" in line["metrics"]:
        line["metrics"]["setup_s"]["value"] = line.pop("window_start") - T_START_EPOCH
    else:
        line.pop("window_start")
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 5
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


def run_rank(args, manifest, cell, config, workload, fit, overrides, device, log) -> int:
    """The run on this process's card (one rank of a cell on several cards)."""
    import torch

    seed = args.seed % (1 << 63)
    world, rank = args.world or 1, args.rank or 0
    mesh, ctrl = None, None
    if args.rank is not None:
        import torch.distributed as dist

        os.environ["LOCAL_RANK"] = str(rank)
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu:
            torch.cuda.set_device(rank)
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://127.0.0.1:{args.port}", rank=rank,
                                world_size=world)
        from mdbn_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(world, device="cpu" if cpu else None)
        ctrl = dist.new_group(backend="gloo")
        device = mesh.device
    if device is None:
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        info = card(torch, cell["chips"])
        if rank == 0:
            log(f"card: {info['kind']}, count {info['count']}, power limit {info['power_limit']}")
    else:
        info = {"platform": device.type, "kind": device.type, "count": 1}
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)

    data_kind = load_module("data", workload["data"]["kind"])
    data = data_kind.make(workload["data"], seed, device)
    jobs = load_module("jobs", workload["job"]["kind"])
    fits = jobs.Fits(config, workload, data, fit=fit, overrides=overrides, mesh=mesh)

    fits.run(job_seed(seed, -1))  # warm-up: this cell's shape, the kernels built and loaded
    sync()
    count0 = fits.route_count()

    from bench_port import trace as tr
    from bench_port import window as win
    from torch.profiler import ProfilerActivity, profile, record_function

    keep = win.Reservoir(int(workload["check"]["jobs"]), seed ^ 0x5EED)
    tcfg = workload["trace"]
    state = {"prof": None, "traced": 0, "done": False, "t0": None, "next": False}

    def one(i: int) -> None:
        if state["t0"] is None:
            state["t0"] = time.perf_counter()
        if state["next"]:
            state["next"] = False
            state["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            state["prof"].start()
        with record_function(tr.JOB_SPAN):
            result = fits.run(job_seed(seed, i))
        if rank == 0:
            keep.offer(i, lambda: fits.outputs(result))
        if state["prof"] is not None and not state["done"]:
            state["traced"] += 1
            if state["traced"] == int(tcfg["jobs"]):
                sync()
                state["prof"].stop()
                state["done"] = True

    def agree(stop: bool) -> bool:
        """Rank 0's decisions after a job, the same on every rank: whether the
        window closes, and whether the traced stretch starts with the next job."""
        start = (bool(args.trace) and state["prof"] is None and not state["next"]
                 and time.perf_counter() - state["t0"] >= tcfg["after_s"])
        if ctrl is not None:
            import torch.distributed as dist

            flags = torch.tensor([int(stop), int(start)])
            dist.broadcast(flags, 0, group=ctrl)
            stop, start = bool(flags[0]), bool(flags[1])
        state["next"] = start
        return stop

    w = win.run(one, args.seconds, hold=lambda: bool(args.trace) and not state["done"],
                agree=agree)
    window_start = time.time() - (time.perf_counter() - w.start)
    sync()
    setup_s = w.start - T_START
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    launches = fits.route_count() - count0
    n = len(w.jobs)
    ms = sorted(d * 1e3 for d in w.durations)
    log(f"window{'' if mesh is None else f' (rank {rank})'}: {n} jobs in {w.seconds!r} s, "
        f"{fits.updates_per_job} updates a job; job ms min {ms[0]!r} median "
        f"{win.percentile(ms, 50)!r} p95 {win.percentile(ms, 95)!r} (from {n} samples) max "
        f"{ms[-1]!r}; setup {setup_s!r} s; peak memory {peak} bytes; host: "
        f"{torch.get_num_threads()} torch thread(s)")

    traces = []
    if args.trace:
        if state["prof"] is None:
            log("the window closed before the traced stretch began")
            return 4
        traces.append(tr.from_profiler(state["prof"]))
        del state["prof"]
    if ctrl is not None:
        import torch.distributed as dist

        (Path(args.out) / f"rank{rank}.json").write_text(json.dumps(
            {"peak": peak, "device": traces[0].device if traces else [],
             "spans": traces[0].spans if traces else [], "forbidden": forbidden_modules()}))
        dist.barrier(group=ctrl)
        if rank != 0:
            dist.barrier(group=ctrl)  # until rank 0 has compared
            dist.destroy_process_group()
            return 0
        others = [json.loads((Path(args.out) / f"rank{r}.json").read_text())
                  for r in range(1, world)]
        peak = max([peak] + [o["peak"] for o in others])
        traces += [tr.Trace(device=[tuple(x) for x in o["device"]],
                            spans=[tuple(x) for x in o["spans"]]) for o in others if traces]
        if any(o["forbidden"] for o in others):
            log(f"modules of JAX or of the JAX package are loaded on a rank: "
                f"{[o['forbidden'] for o in others]}")
            return 5

    metrics, breakdown = {}, None
    if traces:
        t = traces[0]
        if not all(x.device for x in traces):
            log("the profiler saw no device activity in the traced stretch")
            return 4
        busy = [tr.busy_us(x.device, *x.window) * 1e-6 for x in traces]
        spans = [(x.window[1] - x.window[0]) * 1e-6 for x in traces]
        ctx = SimpleNamespace(config=fits.config, chips=cell["chips"], trace=t, traces=traces,
                              busy_s=busy, window_s=spans, jobs=t.jobs,
                              updates_per_job=fits.updates_per_job,
                              launches_per_job=fits.launches_per_job,
                              l2_bytes=torch.cuda.get_device_properties(device).L2_cache_size)
        log(f"trace: {len(t.jobs)} jobs, {len(t.device)} device operations on rank 0, busy "
            f"{busy!r} s of {spans!r} s")
        for m in manifest["per_layer"]:
            if "workloads" in m and cell["name"] not in m["workloads"]:
                continue
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.kernel_table(t.device), "idle_gaps": tr.gap_table(t)}
        info.update(busy_s=sum(busy) / len(busy), window_s=sum(spans) / len(spans))
        del t, traces
    else:
        # an end-to-end metric is known by its name up to the first dot; what
        # follows names the family of cells it guards (".wide": ge20k, ".dp")
        e2e = {"updates_per_s": win.rate(fits.updates_per_job, w),
               "job_p95_ms": win.percentile(w.durations, 95) * 1e3, "setup_s": setup_s}
        for m in manifest["end_to_end"]:
            if "workloads" not in m or cell["name"] in m["workloads"]:
                metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
    info["memory_peak_bytes"] = peak

    # the comparison: the sampled jobs' outputs to the host, the program's state freed
    kept = [(job_seed(seed, i), out.to("cpu")) for i, out in keep.kept]
    del keep
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = fits.check(kept, log=log)
    values["route_launches_off"] = float(abs(launches - n * fits.launches_per_job))
    limits = workload["check"]["limits"]
    checks = {name: {"value": values[name], "limit": limits[name]} for name in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package are loaded: {found}")
        return 5
    line = {"correct": correct, "attempted": n, "failed": 0, "metrics": metrics, "device": info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    if ctrl is not None:
        import torch.distributed as dist

        line["window_start"] = window_start
        (Path(args.out) / "result.json").write_text(json.dumps(line))
        dist.barrier(group=ctrl)
        dist.destroy_process_group()
        return 0
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

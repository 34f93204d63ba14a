"""CPU tests of the benchmark in bench_port/: its manifest, yardsticks, window
statistics, trace reduction, reference and comparison.

Run from the repository's root: ``python -m pytest bench_port/tests -q``. The
one test that needs the card is marked ``cuda`` and skips elsewhere.
"""

from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_port"
sys.path.insert(0, str(ROOT))

from bench_port import counts, run, trace, window  # noqa: E402
from bench_port.reference import philox, rbm as ref  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
L2_H100 = 52_428_800


# -- the manifest ---------------------------------------------------------------

def test_manifest_keys_names_and_units():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench_port"]
    assert MANIFEST["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [x["name"] for x in MANIFEST["configs"] + MANIFEST["workloads"] + metrics]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in MANIFEST["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for text in ([c["why"] for c in MANIFEST["configs"] + MANIFEST["workloads"]]
                 + [m["layer"] for m in MANIFEST["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_every_cell_names_a_config_and_every_metric_a_reader():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for c in configs.values():
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("bench_port/")
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        spec = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert spec["config"] == w["config"]
        assert (BENCH / "data" / f"{spec['data']['kind']}.py").is_file()
        assert (BENCH / "jobs" / f"{spec['job']['kind']}.py").is_file()
        assert set(spec["check"]["limits"]) >= {"last_update_gap", "route_launches_off"}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    known = {"updates_per_s", "job_p95_ms", "setup_s"}
    assert all(m["name"].split(".")[0] in known for m in MANIFEST["end_to_end"])
    for cell in cells:
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])
        reported = {m["name"] for m in MANIFEST["end_to_end"]
                    if "workloads" not in m or cell in m["workloads"]}
        assert "setup_s" in reported and len(reported) >= 2
        for m in MANIFEST["per_layer"]:
            if cell in m["workloads"]:
                assert m["moves"] in reported, (cell, m["name"])


def test_configs_keep_their_widths():
    for entry in MANIFEST["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["source"] == entry["source"]
        assert not any(k.endswith(("_dim", "_rank")) or k in ("n_visible", "n_hidden")
                       for k in entry["reduced"])
    c1 = json.loads((BENCH / "configs" / "c1_rbm.json").read_text())
    ge = json.loads((BENCH / "configs" / "ge20k_rbm.json").read_text())
    assert (c1["n_visible"], c1["n_hidden"], c1["batch_size"], c1["lr"]) == (784, 500, 20, 0.1)
    assert (ge["n_visible"], ge["n_hidden"], ge["batch_size"], ge["lr"]) == (20000, 400, 20, 0.001)


# -- yardsticks ---------------------------------------------------------------------

def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_yardsticks_pinned_to_hand_worked_values():
    c1, ge = _cfg("c1_rbm"), _cfg("ge20k_rbm")
    # rows = B + 2kB + 2B = 100 for CD-1 at batch 20: 2 * 100 * V * H
    assert counts.update_flops(c1) == pytest.approx(78.4e6)
    assert counts.update_flops(ge) == pytest.approx(1.6e9)
    assert counts.update_flops(c1) / counts.PEAK_F32_FLOPS == pytest.approx(1.17e-6, rel=2e-3)
    assert counts.update_flops(ge) / counts.PEAK_F32_FLOPS == pytest.approx(23.9e-6, rel=2e-3)
    # a whole fit's launch is bound by its operations on both (W stays in the L2)
    s, what = counts.bound(c1, 1500, L2_H100)
    assert what == "operations" and s / 1500 == pytest.approx(1.17e-6, rel=2e-3)
    s, what = counts.bound(ge, 300, L2_H100)
    assert what == "operations" and s / 300 == pytest.approx(23.9e-6, rel=2e-3)
    assert counts.peak_flops({**c1, "compute_dtype": "bfloat16"}) == 989e12
    # the W-blocked DP step on a rank's 5 rows of 20 and the update over 4 ranks
    step, _ = counts.wide_step_bound(ge, 4)
    update, _ = counts.wide_update_bound(ge, 4)
    assert step > 0 and update > step


# -- the window's statistics ---------------------------------------------------

class _Clock:
    def __init__(self, durations):
        self.t, self.durations, self.i = 0.0, list(durations), 0

    def __call__(self):
        return self.t

    def job(self, i):
        self.t += self.durations[i]


def test_rate_and_p95_take_every_job_and_a_stall_shows():
    durations = [0.03] * 99 + [2.0] + [0.03] * 200
    clock = _Clock(durations)
    w = window.run(clock.job, seconds=8.0, clock=clock)
    # the window closes with the first job to end at or past 8 s: 200 jobs after the stall
    n = len(w.jobs)
    assert w.seconds == pytest.approx(sum(durations[:n]))
    assert window.rate(1500, w) == pytest.approx(1500 * n / w.seconds)
    assert window.rate(1500, w) < 1500 * n / (0.03 * n)  # the stall's 2 s are in the window
    assert max(w.durations) == pytest.approx(2.0)
    assert window.percentile(w.durations, 95) == pytest.approx(0.03)
    # more than 5% of stalled jobs move the tail
    c = _Clock([0.03, 0.5] * 10)
    w2 = window.run(c.job, 5.0, clock=c)
    assert window.percentile(w2.durations, 95) == pytest.approx(0.5)
    assert window.percentile(w2.durations, 50) == pytest.approx((0.03 + 0.5) / 2)


def test_reservoir_is_seeded_and_uniform_in_size():
    a, b = window.Reservoir(4, 7), window.Reservoir(4, 7)
    for i in range(100):
        a.offer(i, lambda i=i: i)
        b.offer(i, lambda i=i: i)
    assert a.kept == b.kept and len(a.kept) == 4


# -- the trace reduction ----------------------------------------------------------

def test_trace_union_gaps_and_labels():
    t = trace.Trace(
        device=[("k1", 10, 40), ("k2", 30, 50), ("copy", 70, 80), ("k1", 120, 190)],
        spans=[("bench.job", 0, 95), ("bench.train", 5, 90), ("bench.job", 105, 200),
               ("bench.model", 105, 118)])
    lo, hi = t.window
    assert (lo, hi) == (0, 200)
    assert trace.busy_us(t.device, lo, hi) == 40 + 10 + 70
    assert trace.idle_gaps(t.device, lo, hi) == [(0, 10), (50, 70), (80, 120), (190, 200)]
    gaps = trace.gap_table(t)
    assert gaps[0][0] == "between jobs" and gaps[0][1] == pytest.approx(40e-6)
    assert [g[0] for g in gaps[1:3]] == ["bench.train", "bench.train"]
    table = trace.kernel_table(t.device)
    assert table[0] == ["k1", pytest.approx(100e-6)]


# -- the reference --------------------------------------------------------------------

def test_philox_known_answers():
    cases = [((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, 2 ** 64 - 1, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0x299F31D0 << 32) | 0xA4093822,
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        assert tuple(int(v) for v in philox.philox4x32_10(*ctr, key)) == want
    u = philox.uniforms([123], torch.tensor([0, 5]), philox.KIND_V, 0, 3, 4)
    x, _, _, _ = philox.philox4x32_10(2, 1, philox.KIND_V << 8, 5, 123)
    assert float(u[1, 1, 2]) == (int(x) & 0x7FFFFF) / 2 ** 23


def _sig(x):
    return 1.0 / (1.0 + math.exp(-x))


def test_reference_against_a_hand_worked_cd1_step():
    """One CD-1 update of a 2x1 Bernoulli RBM on one row, by scalar arithmetic."""
    spec = ref.Spec(n_visible=2, n_hidden=1, visible="bernoulli", batch_size=1, epochs=1, lr=0.5)
    v0 = [1.0, 0.0]
    data = torch.tensor([v0])
    job = 99
    W0, draws = ref.job_stream(spec, job, ref.Stream(), 1, 'cpu')
    u = draws(0)
    w = [float(W0[0, 0]), float(W0[1, 0])]
    gen = torch.Generator().manual_seed(job)
    ref.initial_weights(spec, gen)
    seed = ref.launch_seed(gen)
    uh0 = float(philox.uniforms([seed], 0, philox.KIND_H0, 0, 1, 1)[0, 0, 0])
    uv = [float(x) for x in philox.uniforms([seed], 0, philox.KIND_V, 0, 1, 2)[0, 0]]
    assert uh0 == float(u["h0"][0, 0, 0]) and uv == [float(x) for x in u["v"][0][0, 0]]
    h0p = _sig(v0[0] * w[0] + v0[1] * w[1])
    h0s = 1.0 if uh0 < h0p else 0.0
    vm = [_sig(h0s * w[0]), _sig(h0s * w[1])]
    vs = [1.0 if uv[i] < vm[i] else 0.0 for i in range(2)]
    h1 = _sig(vs[0] * w[0] + vs[1] * w[1])
    want_W = [w[i] + 0.5 * (v0[i] * h0p - vs[i] * h1) for i in range(2)]
    want_b = [0.5 * (v0[i] - vs[i]) for i in range(2)]
    want_c = 0.5 * (h0p - h1)
    out = ref.fit(spec, data, job)
    assert [float(x) for x in out.W[:, 0]] == pytest.approx(want_W, abs=1e-6)
    assert [float(x) for x in out.b] == pytest.approx(want_b, abs=1e-6)
    assert float(out.c[0]) == pytest.approx(want_c, abs=1e-6)
    assert out.errs[0] == pytest.approx(((v0[0] - vm[0]) ** 2 + (v0[1] - vm[1]) ** 2) / 2,
                                        abs=1e-6)
    gap, _, _ = ref.last_update(spec, data, job, ref.Stream(), out, 1e-4, 4)
    assert gap < 1e-6


FORBIDDEN_IN_REFERENCE = {"jax", "jaxlib", "flax", "mdbn_tpu", "mdbn_tpu_torch"}


def test_reference_imports_nothing_of_jax_or_either_package():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN_IN_REFERENCE, (path.name, name)
    probe = ("import sys; sys.path.insert(0, %r); import bench_port.reference.rbm; "
             "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
             % (str(ROOT), FORBIDDEN_IN_REFERENCE))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]"


def test_reference_matches_the_programs_eager_engine_on_its_draws():
    """With the reference's Philox draws injected, the program's plain engine
    trains the same bits, from the same initial weights and launch seed."""
    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops.cd_epoch_cuda import _draw_seed
    from mdbn_tpu_torch.train.trainer import train_rbm

    for visible in ("bernoulli", "gaussian"):
        cfg = RBMConfig(n_visible=48, n_hidden=16, visible=visible, batch_size=4, epochs=2,
                        lr=0.05, engine="xla")
        spec = ref.Spec.from_config(cfg.__dict__)
        g = torch.Generator().manual_seed(3)
        data = (torch.rand(24, 48, generator=g) < 0.3).float() if visible == "bernoulli" \
            else torch.randn(24, 48, generator=g)
        job = 2 ** 40 + 17
        want = ref.fit(spec, data, job)
        gen = torch.Generator().manual_seed(job)
        W0 = ref.initial_weights(spec, gen)
        seeds = [ref.launch_seed(gen)] * 2
        nb, E = 6, 2

        def draws(kind, cols):
            return torch.stack([philox.uniforms([seeds[e]], torch.arange(e * nb, (e + 1) * nb),
                                                kind, 0, 4, cols) for e in range(E)])

        u = {"h0": draws(philox.KIND_H0, 16), "h": draws(philox.KIND_H, 16)[:, :, None]}
        if spec.sampled_visibles:
            u["v"] = draws(philox.KIND_V, 48)[:, :, None]
        gen = torch.Generator().manual_seed(job)
        state = init_train_state(cfg, gen, "cpu")
        assert torch.equal(state.params.W, W0)
        gen2 = torch.Generator().manual_seed(job)
        ref.initial_weights(spec, gen2)
        assert _draw_seed(gen2) == seeds[0]
        got, metrics = train_rbm(data, cfg, state=state, uniforms=u)
        assert torch.equal(got.params.W, want.W) and torch.equal(got.velocity.W, want.vW)
        assert metrics.errors == pytest.approx(want.errs, rel=1e-6)


# -- the harness end to end on the CPU, with the reference in the program's place ----

TINY = {"n_visible": 64, "n_hidden": 24, "visible": "bernoulli", "k": 1, "batch_size": 4,
        "epochs": 3, "lr": 0.1, "momentum": 0.0, "init_scale": 0.01,
        "param_dtype": "float32", "compute_dtype": "float32"}


def _tiny_cell(monkeypatch, visible="bernoulli"):
    config = {**TINY, "visible": visible}
    workload = json.loads((BENCH / "workloads" / "c1_rbm.graded_fit.json").read_text())
    workload["data"] = ({"kind": "mnist_like", "n_samples": 40, "n_features": 64}
                        if visible == "bernoulli" else
                        {"kind": "ge_zscored", "n_patients": 40, "n_genes": 64})
    workload["check"]["jobs"] = 2
    cell = {"name": "tiny", "config": "tiny", "traffic": "tiny", "chips": 1}
    e2e = [{k: v for k, v in m.items() if k != "workloads"} for m in MANIFEST["end_to_end"]
           if "." not in m["name"]]
    manifest = {**MANIFEST, "workloads": [cell], "end_to_end": e2e}
    monkeypatch.setattr(run, "load_cell", lambda name: (manifest, cell, config, workload))
    return config, workload


def _run(monkeypatch, capsys, fault=None, compute="float32", storage="float32",
         visible="bernoulli"):
    config, _ = _tiny_cell(monkeypatch, visible)
    spec = ref.Spec.from_config(config)
    holder = {}

    def stand_in(job_seed):
        return ref.fit(spec, holder["data"], job_seed, compute=compute, storage=storage,
                       fault=fault)

    real_make = run.load_module

    def load_module(kind, name):
        module = real_make(kind, name)
        if kind == "data":
            make = module.make

            def keep(params, seed, device):
                holder["data"] = make(params, seed, device)
                return holder["data"]
            module.make = keep
        return module

    monkeypatch.setattr(run, "load_module", load_module)
    rc = run.main(["--workload", "tiny", "--seed", str(2 ** 31 + 11), "--seconds", "0.5"],
                  fit=stand_in, device="cpu", log=lambda msg: None)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("visible", ["bernoulli", "gaussian"])
def test_a_sound_stand_in_comes_out_correct(monkeypatch, capsys, visible):
    line = _run(monkeypatch, capsys, visible=visible)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] > 0
    assert set(line["metrics"]) == {"updates_per_s", "job_p95_ms", "setup_s"}


@pytest.mark.parametrize("visible", ["bernoulli", "gaussian"])
def test_the_control_at_bfloat16_comes_out_incorrect(monkeypatch, capsys, visible):
    line = _run(monkeypatch, capsys, compute="bfloat16", storage="bfloat16", visible=visible)
    assert line["correct"] is False
    assert line["checks"]["last_update_gap"]["value"] > line["checks"]["last_update_gap"]["limit"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_timed_path_comes_out_incorrect(monkeypatch, capsys, fault):
    line = _run(monkeypatch, capsys, fault=fault)
    assert line["correct"] is False, line["checks"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                           "c1_rbm.graded_fit", "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mdbn_tpu_torch_probe", object())
    assert "mdbn_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mdbn_tpu.probe", object())
    assert "mdbn_tpu" in run.forbidden_modules()


@pytest.mark.cuda
def test_a_short_run_of_each_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the program's CUDA kernels have no CPU mode")
    for cell in MANIFEST["workloads"]:
        proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                               cell["name"], "--seed", "7", "--seconds", "3"],
                              capture_output=True, text=True, cwd=ROOT, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-4000:]
        assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True


# -- a cell on several cards: the ranks' lockstep, files and comparison, on the CPU ----

DP_TINY = {**TINY, "visible": "gaussian", "batch_size": 4, "epochs": 2}


def _dp_rank(rank, world, port, out, fault, compute):
    """One rank of a four-rank run on the CPU (gloo), the reference in the program's place."""
    workload = json.loads((BENCH / "workloads" / "c1_rbm.graded_fit.json").read_text())
    workload["data"] = {"kind": "ge_zscored", "n_patients": 64, "n_genes": 64}
    workload["job"] = {"kind": "rbm_fit", "ranks": world}
    workload["check"]["jobs"] = 2
    workload["route"]["per_job"] = 1
    cell = {"name": "tiny_dp", "config": "tiny", "traffic": "tiny", "chips": world}
    manifest = {**MANIFEST, "workloads": [cell]}
    run.load_cell = lambda name: (manifest, cell, DP_TINY, workload)
    holder = {}
    real = run.load_module

    def load_module(kind, name):
        module = real(kind, name)
        if kind == "data":
            make = module.make

            def keep(params, seed, device):
                holder["data"] = make(params, seed, device)
                return holder["data"]
            module.make = keep
        if kind == "jobs":
            cls = module.Fits

            class Fits(cls):
                def __init__(self, *a, **kw):
                    super().__init__(*a, **kw)
                    holder["fits"] = self
            module.Fits = Fits
        return module

    run.load_module = load_module

    def stand_in(job_seed):
        fits = holder["fits"]
        return ref.fit(fits.spec, holder["data"], job_seed, fits.stream, compute=compute,
                       storage=compute, fault=fault)

    argv = ["--workload", "tiny_dp", "--seed", "77", "--seconds", "0.5", "--rank", str(rank),
            "--world", str(world), "--port", str(port), "--out", str(out)]
    assert run.main(argv, fit=stand_in, device="cpu", log=lambda msg: None) == 0


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault,compute,correct", [(None, "float32", True),
                                                   ("no_exchange", "float32", False),
                                                   (None, "bfloat16", False)])
def test_four_ranks_run_in_lockstep_and_rank_0_compares(tmp_path, fault, compute, correct):
    import torch.multiprocessing as mp

    mp.start_processes(_dp_rank, args=(4, _free_port(), tmp_path, fault, compute), nprocs=4,
                       join=True, start_method="fork")
    line = json.loads((tmp_path / "result.json").read_text())
    assert line["correct"] is correct, line["checks"]
    assert line["attempted"] > 0 and "window_start" in line


def test_the_rank_seeds_are_the_programs():
    from mdbn_tpu_torch.parallel.dp import fold_in

    for seed, rank in ((0, 0), (2 ** 62 - 1, 3), (123456789, 1)):
        assert ref.fold_in(seed, rank) == fold_in(seed, rank)


def test_draws_under_many_seeds_match_one_seed_at_a_time():
    seeds = [ref.fold_in(2 ** 61 + 5, r) for r in range(4)]
    both = philox.uniforms(seeds, 0, philox.KIND_H0, 0, 3, 5)
    for i, s in enumerate(seeds):
        one = philox.uniforms([s], 0, philox.KIND_H0, 0, 3, 5)[0]
        x, _, _, _ = philox.philox4x32_10(4, 2, philox.KIND_H0 << 8, 0, s)
        assert torch.equal(both[i], one) and float(one[2, 4]) == (int(x) & 0x7FFFFF) / 2 ** 23

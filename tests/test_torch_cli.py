"""The port's CLI (``python -m mdbn_tpu_torch.run``) on its real-data kinds and
its analysis block, on the CPU (``--device cpu``) at a tiny size.

- the ``mnist_idx`` and ``omics_csv`` data kinds on fixture files the tests
  write, with ``limit`` and ``labels_path``, and patient IDs that align a
  clinical CSV;
- ``analysis`` with an integer k, ``"auto"`` (silhouette), ``"consensus"``
  (PAC) and the ``consensus`` flag at a fixed k, with ``survival`` true
  (planted) and from a clinical CSV with ``cox``; ``impute``; ``--load``;
- the records: the same kinds and keys as the JAX package's runner prints
  for the same config (the values differ: each side trains its own model).
  ``ais`` has its own cases in tests/test_torch_ais.py;
- the ``finetune`` block in each of its five modes on a DBN and an MDBN,
  after training and on a ``--load``-ed model, with the reference's record
  keys, and ``label_fraction`` with the reference's checks.
"""

import json
import struct

import numpy as np
import pytest

from mdbn_tpu.run import main as jmain
from mdbn_tpu_torch.data.synthetic import tcga_like
from mdbn_tpu_torch.run import main

CPU_ARGS = ["--device", "cpu", "--engine", "xla"]
TOWER = {"__type__": "DBNConfig", "layer_sizes": [6], "visible": "gaussian",
         "batch_size": 10, "epochs": 2, "seed": 1}
MDBN = {"__type__": "MDBNConfig", "seed": 0,
        "towers": {"ge": TOWER, "meth": TOWER, "mirna": TOWER},
        "joint": {"__type__": "RBMConfig", "n_visible": 1, "n_hidden": 6, "batch_size": 10,
                  "epochs": 2, "seed": 0}}
DIMS = {"ge": 12, "meth": 10, "mirna": 6}


def _run(tmp_path, exp, runner=main, extra=()):
    """Run ``exp`` through ``runner``; returns the records of its metrics file."""
    path = str(tmp_path / "exp.json")
    metrics = str(tmp_path / f"m{len(list(tmp_path.glob('m*.jsonl')))}.jsonl")  # one a run
    with open(path, "w") as f:
        json.dump(exp, f)
    args = ["--config", path, "--metrics", metrics, *extra]
    assert runner(args + (CPU_ARGS if runner is main else [])) == 0
    with open(metrics) as f:
        return [json.loads(l) for l in f]


def _records(recs, kind):
    return [r for r in recs if r["kind"] == kind]


def _omics_fixtures(tmp_path, n=40, clinical=True, seed=3):
    """Three omics CSVs with a header row and patient IDs (the second file's
    rows shuffled) and a clinical CSV in yet another order."""
    mods, labels = tcga_like(n, dims=DIMS, seed=seed)
    rng = np.random.default_rng(seed)
    pids = [f"TCGA-{i:03d}" for i in range(n)]
    paths = {}
    for j, (m, mat) in enumerate(mods.items()):
        order = rng.permutation(n) if j == 1 else np.arange(n)
        lines = [",".join(["id"] + [f"{m}{k}" for k in range(mat.shape[1])])]
        lines += [",".join([pids[i]] + [repr(float(x)) for x in mat[i]]) for i in order]
        paths[m] = str(tmp_path / f"{m}.csv")
        with open(paths[m], "w") as f:
            f.write("\n".join(lines) + "\n")
    times = rng.exponential(np.array([1.0, 2.0, 4.0])[labels])
    events = rng.integers(0, 2, n)
    clin = str(tmp_path / "clinical.csv")
    with open(clin, "w") as f:
        f.write("patient,days,status\n")
        for i in rng.permutation(n):
            f.write(f"{pids[i]},{float(times[i])!r},{events[i]}\n")
    return paths, clin


def test_mnist_idx_kind(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (50, 4, 4)).astype(np.uint8)
    with open(tmp_path / "img.idx", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *imgs.shape) + imgs.tobytes())
    with open(tmp_path / "lab.idx", "wb") as f:
        f.write(struct.pack(">II", 2049, 50) + rng.integers(0, 3, 50).astype(np.uint8).tobytes())
    exp = {"data": {"kind": "mnist_idx", "path": str(tmp_path / "img.idx"), "limit": 40,
                    "labels_path": str(tmp_path / "lab.idx")},
           "model": {"__type__": "RBMConfig", "n_visible": 16, "n_hidden": 5, "batch_size": 10,
                     "epochs": 2},
           "analysis": {"kmeans": 3}}
    recs = _run(tmp_path, exp, extra=["--transform-out", str(tmp_path / "c.npy")])
    assert len(_records(recs, "epoch")) == 2
    (km,) = _records(recs, "kmeans")
    assert km["k"] == 3 and sum(km["cluster_sizes"]) == 40 and "ari_vs_planted" in km
    assert np.load(tmp_path / "c.npy").shape == (40, 5)


def test_omics_csv_kind_clinical_survival_cox_and_impute_like_the_reference(tmp_path):
    """Integer k with survival from a clinical CSV aligned by patient ID and
    Cox regression, and imputation; the same record kinds and keys as the
    JAX runner's, and a --load run that clusters the cohort again."""
    paths, clin = _omics_fixtures(tmp_path)
    exp = {"data": {"kind": "omics_csv", "paths": paths, "clinical_csv": clin},
           "model": MDBN,
           "analysis": {"kmeans": 3, "survival": {"clinical_csv": clin, "cox": True},
                        "impute": {"holdout": "meth", "n_gibbs": 6, "n_chains": 2}}}
    got = _run(tmp_path, exp, extra=["--save", str(tmp_path / "model")])
    want = _run(tmp_path, exp, runner=jmain)
    for kind in ("impute", "kmeans"):
        (g,), (w,) = _records(got, kind), _records(want, kind)
        assert sorted(g) == sorted(w)
    g, w = _records(got, "kmeans")[0], _records(want, "kmeans")[0]
    assert sorted(g["logrank"]) == sorted(w["logrank"]) and sorted(g["cox"]) == sorted(w["cox"])
    assert len(g["cox"]["hazard_ratio"]) == 2 and sum(g["cluster_sizes"]) == 40
    assert _records(got, "impute")[0]["ratio"] > 0
    assert [r["name"] for r in _records(got, "tower")] == ["ge", "meth", "mirna", "joint"]
    loaded = _run(tmp_path, {**exp, "analysis": {"kmeans": 3}},
                  extra=["--load", str(tmp_path / "model")])
    assert _records(loaded, "kmeans")[0]["cluster_sizes"] == g["cluster_sizes"]


@pytest.mark.parametrize("analysis,score_key", [
    ({"kmeans": "auto", "k_max": 4, "survival": True}, "silhouette_scores"),
    ({"kmeans": "consensus", "k_max": 4, "consensus_resamples": 5}, "pac_scores"),
    ({"kmeans": 3, "consensus": True, "consensus_resamples": 5}, None),
])
def test_analysis_modes_on_planted_data(tmp_path, analysis, score_key):
    exp = {"data": {"kind": "tcga_like", "n_patients": 40, "dims": DIMS, "seed": 2},
           "model": MDBN, "analysis": analysis}
    (km,) = _records(_run(tmp_path, exp), "kmeans")
    assert sum(km["cluster_sizes"]) == 40 and 0.0 <= km["ari_vs_planted"] <= 1.0 + 1e-12
    if score_key:
        assert sorted(km[score_key]) == ["2", "3", "4"] and str(km["k"]) in km[score_key]
    assert ("logrank" in km) == bool(analysis.get("survival"))


def test_analysis_errors(tmp_path):
    exp = {"data": {"kind": "tcga_like", "n_patients": 40, "dims": DIMS, "seed": 2},
           "model": MDBN, "analysis": {"impute": {"holdout": "rna"}}}
    with pytest.raises(ValueError, match="holdout modality 'rna'"):
        _run(tmp_path, exp)
    paths, _ = _omics_fixtures(tmp_path, n=40)
    short = tmp_path / "short.csv"
    short.write_text("days,status\n" + "1.0,1\n" * 7)
    exp = {"data": {"kind": "omics_csv", "paths": paths}, "model": MDBN,
           "analysis": {"kmeans": 2, "survival": {"clinical_csv": str(short)}}}
    with pytest.raises(ValueError, match="7 rows don't match the 40-patient cohort"):
        _run(tmp_path, exp)


# -- the "finetune" block ---------------------------------------------------------------

DBN = {"__type__": "DBNConfig", "layer_sizes": [8, 6], "batch_size": 10, "epochs": 2, "seed": 0}
FINETUNE_KEYS = {  # the reference's records (mdbn_tpu/run.py:256-405)
    "autoencoder": {"loss_first", "loss_last"},
    "classifier": {"n_classes", "loss_first", "loss_last", "train_accuracy"},
    "label_top": {"n_classes", "err_first", "err_last", "train_accuracy"},
    "updown": {"wake_mse_first", "wake_mse_last"},
    "updown_labeled": {"wake_mse_first", "wake_mse_last", "train_accuracy"},
}


@pytest.mark.parametrize("model", ["dbn", "mdbn"])
@pytest.mark.parametrize("mode", list(FINETUNE_KEYS))
def test_finetune_block_each_mode(tmp_path, mode, model):
    """Each mode of the block after training, on planted labels; the record
    has the reference's keys; a --load run resumes the saved fine-tuned
    state (its record's first value continues from the trained model)."""
    spec = {"mode": mode, "epochs": 2, "n_hidden": 5, "label_top_epochs": 2}
    if model == "dbn":
        exp = {"data": {"kind": "mnist_like", "n_samples": 40, "n_features": 16, "seed": 1},
               "model": DBN, "finetune": spec}
    else:
        exp = {"data": {"kind": "tcga_like", "n_patients": 40, "dims": DIMS, "seed": 2},
               "model": MDBN, "finetune": spec}
    recs = _run(tmp_path, exp, extra=["--save", str(tmp_path / "m")])
    (ft,) = _records(recs, "finetune")
    assert ft["mode"] == mode and ft["epochs"] == 2
    assert set(ft) - {"kind", "mode", "epochs", "ts"} == FINETUNE_KEYS[mode]
    assert all(np.isfinite(v) for k, v in ft.items() if k not in ("kind", "mode", "ts"))
    if "train_accuracy" in ft:
        assert 0.0 <= ft["train_accuracy"] <= 1.0
    (again,) = _records(_run(tmp_path, exp, extra=["--load", str(tmp_path / "m")]), "finetune")
    assert set(again) == set(ft)


def test_finetune_label_fraction(tmp_path):
    """"label_fraction" keeps a seeded share of the labels (the reference's
    rng draw): the label modes train semi-supervised and also report the
    accuracy on the hidden-label rows; the reference's checks."""
    exp = {"data": {"kind": "mnist_like", "n_samples": 40, "n_features": 16, "seed": 1},
           "model": DBN,
           "finetune": {"mode": "updown_labeled", "epochs": 1, "label_fraction": 0.3,
                        "label_seed": 2, "n_hidden": 5, "label_top_epochs": 1}}
    (ft,) = _records(_run(tmp_path, exp), "finetune")
    assert 0.0 <= ft["train_accuracy"] <= 1.0 and 0.0 <= ft["accuracy_unlabeled"] <= 1.0
    exp["finetune"]["label_fraction"] = 1.0  # no hidden rows: no accuracy_unlabeled
    (ft,) = _records(_run(tmp_path, exp), "finetune")
    assert "accuracy_unlabeled" not in ft
    for spec, match in (({"mode": "classifier", "label_fraction": 0.5}, "generative label"),
                        ({"mode": "label_top", "label_fraction": 1.5}, r"not in \(0, 1\]"),
                        ({"mode": "label_top", "label_fraction": 1e-9}, "zero labeled"),
                        ({"mode": "spectral"}, "finetune mode must be")):
        with pytest.raises(ValueError, match=match):
            _run(tmp_path, {**exp, "finetune": spec})
    bars = {"data": {"kind": "bars_and_stripes", "side": 4}, "model": DBN,
            "finetune": {"mode": "label_top"}}
    with pytest.raises(ValueError, match="needs labels"):
        _run(tmp_path, bars)
    rbm = {**exp, "model": {"__type__": "RBMConfig", "n_visible": 16, "n_hidden": 4,
                            "batch_size": 10, "epochs": 1}}
    with pytest.raises(ValueError, match="DBN/MDBN configs"):
        _run(tmp_path, rbm)

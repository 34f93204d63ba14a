"""mdbn_tpu_torch's API around the kernel: configs, engine choice, checkpoints,
the CLI, the build's failure modes, and that the package never imports JAX.

Runs on the CPU (the eager engine) at tiny sizes.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mdbn_tpu.config as jconfig
import mdbn_tpu_torch
from mdbn_tpu_torch import DBN, MDBN, RBM, DBNConfig, MDBNConfig, RBMConfig
from mdbn_tpu_torch.checkpoint import LayerCheckpointer, restore_state, save_state
from mdbn_tpu_torch.config import load_config, save_config
from mdbn_tpu_torch.convert import convert_config
from mdbn_tpu_torch.data.synthetic import mnist_like, tcga_like
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.run import main
from mdbn_tpu_torch.train.trainer import resolve_engine, train_rbm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # a device object only: nothing runs on it here


def test_import_leaves_jax_out():
    code = ("import sys, mdbn_tpu_torch, mdbn_tpu_torch.parallel.dp, "
            "mdbn_tpu_torch.ops.cd_grads_cuda; "
            "print(any(m == 'jax' or m.startswith(('jax.', 'mdbn_tpu.')) or m == 'mdbn_tpu' "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, check=True)
    assert out.stdout.strip() == "False"
    for path in glob.glob(os.path.join(REPO, "mdbn_tpu_torch", "**", "*.py"), recursive=True):
        for line in open(path):
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        or s.startswith("import mdbn_tpu.") or s.startswith("from mdbn_tpu.")), path


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.json"))),
                         ids=os.path.basename)
def test_configs_load_and_round_trip(path, tmp_path):
    exp = load_config(path)
    assert convert_config(jconfig.load_config(path)["model"]) == exp["model"]
    save_config(exp, str(tmp_path / "c.json"))
    assert load_config(str(tmp_path / "c.json")) == exp


@pytest.mark.parametrize("kind", ["mnist_like", "bars_and_stripes", "tcga_like"])
def test_synthetic_data_is_bit_identical(kind):
    """The port's copy of data/synthetic.py gives the JAX package's arrays."""
    import mdbn_tpu.data.synthetic as jsyn
    import mdbn_tpu_torch.data.synthetic as tsyn

    kw = {"mnist_like": dict(n_samples=50, seed=3, return_labels=True),
          "bars_and_stripes": dict(n_samples=40, seed=3),
          "tcga_like": dict(n_patients=30, seed=3)}[kind]
    want, got = getattr(jsyn, kind)(**kw), getattr(tsyn, kind)(**kw)
    if kind == "tcga_like":
        (want, wl), (got, gl) = want, got
        assert list(got) == list(want)
        want, got = [want[m] for m in want] + [wl], [got[m] for m in got] + [gl]
    elif kind == "mnist_like":
        want, got = list(want), list(got)
    else:
        want, got = [want], [got]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_engine_selection():
    cfg = RBMConfig(n_visible=8, n_hidden=4)
    assert resolve_engine(cfg, CPU) == "eager"
    assert resolve_engine(cfg, CUDA) == "cuda"
    assert resolve_engine(cfg.replace(engine="xla"), CUDA) == "eager"
    assert resolve_engine(cfg.replace(engine="pallas"), CUDA) == "cuda"
    with pytest.raises(ValueError, match="engine='pallas'"):
        resolve_engine(cfg.replace(engine="pallas"), CPU)
    with pytest.raises(ValueError, match="engine='pallas'"):
        RBM(cfg.replace(engine="pallas", epochs=1), device="cpu").train(
            mnist_like(40, n_features=8, seed=0))
    # the estimator modes, bf16 storage and any k run on the kernels
    modes = [cfg.replace(gradient="enhanced"),
             cfg.replace(param_dtype="bfloat16"),
             cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16", persistent=True,
                         pt_temps=3, pt_beta_min=0.3),
             cfg.replace(visible="gaussian", learn_variance=True),
             cfg.replace(error_metric="pseudo"),
             cfg.replace(persistent=True, pt_temps=3, pt_beta_min=0.2),
             cfg.replace(visible="gaussian", learn_variance=True, persistent=True, pt_temps=3)]
    for m in modes:
        assert resolve_engine(m, CUDA) == "cuda"
        assert resolve_engine(m.replace(engine="pallas"), CUDA) == "cuda"
        assert resolve_engine(m, CPU) == "eager"
    # past the 255 Gibbs steps the Philox counter once held: the same kernel as k=1
    for k in (256, 300):
        long = cfg.replace(k=k)
        assert resolve_engine(long, CUDA) == "cuda"
        assert resolve_engine(long.replace(engine="pallas"), CUDA) == "cuda"
        assert resolve_engine(long, CPU) == "eager"
        assert K.select_kernel(long) == K.select_kernel(cfg)


def test_eager_engine_variants_train():
    data = mnist_like(40, n_features=16, seed=1)
    for cfg in (RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=2, gradient="enhanced"),
                RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=2,
                          error_metric="pseudo", shuffle=True),
                RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=2,
                          param_dtype="bfloat16", compute_dtype="bfloat16")):
        r = RBM(cfg, device="cpu").train(data)
        assert r.metrics.engine == "eager" and np.all(np.isfinite(r.history))
        assert r.params.W.dtype == (torch.bfloat16 if cfg.param_dtype == "bfloat16"
                                    else torch.float32)


def test_transform_before_train_raises():
    with pytest.raises(RuntimeError, match="before train"):
        RBM(RBMConfig(n_visible=8, n_hidden=4), device="cpu").transform(np.zeros((2, 8)))
    with pytest.raises(RuntimeError, match="before train"):
        DBN(DBNConfig(layer_sizes=[4]), device="cpu").transform(np.zeros((2, 8)))


def test_resume_continues_identically(tmp_path):
    """The state (generator included) round-trips: an epoch trained from a
    restored checkpoint equals the epoch trained from the state in memory."""
    data = mnist_like(40, n_features=16, seed=2)
    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=1, shuffle=True,
                    persistent=True)
    half, _ = train_rbm(data, cfg, device="cpu")
    save_state(half, str(tmp_path / "s.pt"))
    cont, _ = train_rbm(data, cfg, state=half)
    back = restore_state(str(tmp_path / "s.pt"), "cpu")
    assert back.epoch == 1
    resumed, _ = train_rbm(data, cfg, state=back)
    assert resumed.epoch == cont.epoch == 2
    torch.testing.assert_close(resumed.params.W, cont.params.W, rtol=0, atol=0)
    torch.testing.assert_close(resumed.chain_h, cont.chain_h, rtol=0, atol=0)


def test_rbm_save_load_and_epoch_checkpoints(tmp_path):
    from mdbn_tpu_torch.config import TrainRuntimeConfig

    data = mnist_like(40, n_features=16, seed=3)
    rt = TrainRuntimeConfig(checkpoint_dir=str(tmp_path / "ep"), checkpoint_every_epochs=1,
                            metrics_path=str(tmp_path / "m.jsonl"))
    r = RBM(RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=2), device="cpu")
    r.train(data, runtime=rt)
    assert sorted(os.listdir(tmp_path / "ep")) == ["epoch00001.pt", "epoch00002.pt"]
    recs = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert [x["epoch"] for x in recs] == [0, 1] and recs[0]["engine"] == "eager"
    r.save(str(tmp_path / "rbm"))
    back = RBM.load(str(tmp_path / "rbm"), device="cpu")
    torch.testing.assert_close(back.transform(data), r.transform(data), rtol=0, atol=0)


def test_dbn_resume_skips_completed_layers(tmp_path):
    data = mnist_like(64, n_features=32, seed=0)
    cfg = DBNConfig(layer_sizes=[16, 8], epochs=2, batch_size=8, seed=0)
    ck = LayerCheckpointer(str(tmp_path / "dbn"))
    d1 = DBN(cfg, device="cpu").train(data, checkpointer=ck)
    assert ck.completed() == ["layer0", "layer1"]
    calls = []
    d2 = DBN(cfg, device="cpu").train(data, checkpointer=ck,
                                      layer_callback=lambda l, r: calls.append(l))
    assert calls == []  # restored, not retrained
    torch.testing.assert_close(d2.layers[0].params.W, d1.layers[0].params.W, rtol=0, atol=0)
    torch.testing.assert_close(d2.transform(data), d1.transform(data), rtol=0, atol=0)
    with pytest.raises(ValueError, match="different config"):
        DBN(DBNConfig(layer_sizes=[12, 8], epochs=2, batch_size=8, seed=0),
            device="cpu").train(data, checkpointer=ck)


def test_mdbn_resume_and_save_load(tmp_path):
    mods, _ = tcga_like(48, dims={"ge": 16, "meth": 8, "mirna": 8}, seed=0)
    cfg = MDBNConfig(
        towers={m: DBNConfig(layer_sizes=[8, 4], visible="gaussian", epochs=1, batch_size=8,
                             seed=i) for i, m in enumerate(mods)},
        joint=RBMConfig(n_visible=1, n_hidden=4, epochs=1, batch_size=8))
    ckdir = str(tmp_path / "mdbn_ck")
    m1 = MDBN(cfg, device="cpu").train(mods, checkpoint_dir=ckdir)
    codes1 = m1.transform(mods)
    m2 = MDBN(cfg, device="cpu").train(mods, checkpoint_dir=ckdir)  # resumes everything
    torch.testing.assert_close(m2.transform(mods), codes1, rtol=0, atol=0)
    m1.save(str(tmp_path / "saved"))
    m3 = MDBN.load(str(tmp_path / "saved"), device="cpu")
    torch.testing.assert_close(m3.transform(mods), codes1, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["dbn", "mdbn"])
def test_finetuned_state_save_load_round_trip(kind, tmp_path):
    """Each piece of fine-tuned state (head, decoder, generative weights,
    label top, the MDBN's joint generative weights) survives save -> load
    bit for bit, under the reference's file names and array keys, and a
    save without a piece removes its stale file."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 40)
    if kind == "dbn":
        x = (rng.random((40, 12)) < 0.4).astype(np.float32)
        model = DBN(DBNConfig(layer_sizes=[8, 6], epochs=1, batch_size=10), device=CPU).train(x)
        names = ["head.npz", "decoder.npz", "gen.npz", "label_top.npz"]
    else:
        x = {m: rng.normal(size=(40, d)).astype(np.float32) for m, d in (("a", 10), ("b", 8))}
        tower = DBNConfig(layer_sizes=[6], visible="gaussian", epochs=1, batch_size=10)
        model = MDBN(MDBNConfig(towers={"a": tower, "b": tower},
                                joint=RBMConfig(n_visible=1, n_hidden=5, epochs=1,
                                                batch_size=10)), device=CPU).train(x)
        names = ["head.npz", "mdbn_decoder.npz", "tower_a/gen.npz", "label_top.npz",
                 "joint_gen.npz"]
    model.finetune(x, y, 3, epochs=1, batch_size=10)
    model.finetune_autoencoder(x, epochs=1, batch_size=10)
    model.fit_label_top(x, y, 3, n_hidden=4, epochs=1, batch_size=10)
    model.finetune_updown_labeled(x, y, epochs=1, batch_size=10)
    model.save(str(tmp_path / "m"))
    for name in names:
        assert (tmp_path / "m" / name).exists(), name
    back = type(model).load(str(tmp_path / "m"), device=CPU)
    torch.testing.assert_close(back.predict(x), model.predict(x), rtol=0, atol=0)
    torch.testing.assert_close(back.predict_generative(x), model.predict_generative(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(back.class_posterior(x), model.class_posterior(x), rtol=0, atol=0)
    for a, b in ((back.reconstruct(x), model.reconstruct(x)),
                 (back.generate(n_samples=3, n_gibbs=2), model.generate(n_samples=3, n_gibbs=2)),
                 (back.generate_class(1, n_samples=3, n_gibbs=2),
                  model.generate_class(1, n_samples=3, n_gibbs=2))):
        for k in (a if isinstance(a, dict) else {"": a}):
            aa, bb = (a, b) if not isinstance(a, dict) else (a[k], b[k])
            torch.testing.assert_close(aa, bb, rtol=0, atol=0)
    with np.load(tmp_path / "m" / "label_top.npz") as z:
        assert sorted(z.files) == ["W", "b", "c", "n_classes"] and int(z["n_classes"]) == 3
    # saving a model without the pieces removes the stale files
    fresh = type(model).load(str(tmp_path / "m"), device=CPU)
    fresh._head = fresh._decoder = fresh._label_top = None
    if kind == "dbn":
        fresh._gen = None
    else:
        fresh._joint_gen = None
        for t in fresh.towers.values():
            t._gen = None
    fresh.save(str(tmp_path / "m"))
    for name in names:
        assert not (tmp_path / "m" / name).exists(), name


def test_cli_train_save_load_resume(tmp_path):
    cfg_path = str(tmp_path / "exp.json")
    save_config({"model": RBMConfig(n_visible=64, n_hidden=8, epochs=2, batch_size=10),
                 "data": {"kind": "mnist_like", "n_samples": 40, "n_features": 64, "seed": 2}},
                cfg_path)
    assert main(["--config", cfg_path, "--save", str(tmp_path / "m"), "--device", "cpu",
                 "--engine", "xla", "--metrics", str(tmp_path / "m.jsonl")]) == 0
    assert main(["--config", cfg_path, "--load", str(tmp_path / "m"), "--device", "cpu",
                 "--transform-out", str(tmp_path / "codes.npy")]) == 0
    codes = np.load(tmp_path / "codes.npy")
    assert codes.shape == (40, 8) and np.isfinite(codes).all()

    dbn_path = str(tmp_path / "dbn.json")
    save_config({"model": DBNConfig(layer_sizes=[16, 8], epochs=2, batch_size=8, seed=0),
                 "data": {"kind": "mnist_like", "n_samples": 64, "n_features": 64, "seed": 1}},
                dbn_path)
    ck, m1, m2 = str(tmp_path / "ck"), str(tmp_path / "1.jsonl"), str(tmp_path / "2.jsonl")
    assert main(["--config", dbn_path, "--checkpoint-dir", ck, "--metrics", m1,
                 "--device", "cpu"]) == 0
    assert main(["--config", dbn_path, "--checkpoint-dir", ck, "--metrics", m2,
                 "--device", "cpu"]) == 0
    assert [json.loads(l)["kind"] for l in open(m1)].count("layer") == 2
    assert [json.loads(l) for l in open(m2) if json.loads(l)["kind"] == "layer"] == []


def test_cli_not_ported_sections_raise(tmp_path):
    cfg_path = str(tmp_path / "exp.json")
    base = {"model": RBMConfig(n_visible=16, n_hidden=4, epochs=1, batch_size=10),
            "data": {"kind": "mnist_like", "n_samples": 20, "n_features": 16, "seed": 0}}
    # the analysis block's "ais" is ported: it runs after training and writes its record
    for extra in ({"analysis": {"kmeans": 3, "ais": True, "ais_chains": 8, "ais_betas": 10}},):
        metrics = str(tmp_path / "ais.jsonl")
        save_config({**base, **extra}, cfg_path)
        assert main(["--config", cfg_path, "--device", "cpu", "--metrics", metrics]) == 0
        (rec,) = [r for r in map(json.loads, open(metrics)) if r["kind"] == "ais"]
        assert rec["n_rows"] == 20 and np.isfinite(rec["mean_log_likelihood"])
    # the "finetune" block is ported: it runs after training and writes its record
    metrics = str(tmp_path / "ft.jsonl")
    save_config({**base, "model": DBNConfig(layer_sizes=[6, 4], epochs=1, batch_size=10),
                 "finetune": {"mode": "autoencoder", "epochs": 2}}, cfg_path)
    assert main(["--config", cfg_path, "--device", "cpu", "--metrics", metrics]) == 0
    (ft,) = [r for r in map(json.loads, open(metrics)) if r["kind"] == "finetune"]
    assert ft["mode"] == "autoencoder" and ft["epochs"] == 2 and ft["loss_last"] > 0
    save_config(base, cfg_path)
    # --dp 2 --tp 2 is ported: a dp x tp mesh of 4 gloo ranks under torchrun
    # (tests/test_torch_dp.py::test_cli_dp_under_torchrun's pattern)
    tp_metrics = str(tmp_path / "tp.jsonl")
    save_config({**base, "model": RBMConfig(n_visible=16, n_hidden=6, epochs=2, batch_size=5),
                 "data": {"kind": "mnist_like", "n_samples": 40, "n_features": 16, "seed": 2}},
                cfg_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "mdbn_tpu_torch.run", "--config", cfg_path, "--dp", "2", "--tp", "2",
         "--device", "cpu", "--metrics", tp_metrics, "--save", str(tmp_path / "tp_model")],
        cwd=repo, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = [json.loads(line) for line in open(tp_metrics)]
    assert [(r["engine"], r["kernel"]) for r in recs] == [("eager_tp", None)] * 2  # one writer
    assert recs[-1]["recon_error"] < recs[0]["recon_error"]
    assert os.path.exists(tmp_path / "tp_model.config.json")
    # --tp acts only with --dp
    with pytest.raises(ValueError, match="--tp 2 acts only with --dp"):
        main(["--config", cfg_path, "--device", "cpu", "--tp", "2"])
    # --dp runs one process per rank: outside torchrun it names the command
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2 -m mdbn_tpu_torch.run"):
        main(["--config", cfg_path, "--device", "cpu", "--dp", "2"])
    # the card unless the CPU is asked for
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            main(["--config", cfg_path])


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from mdbn_tpu_torch import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_package_exports():
    for name in ("RBM", "DBN", "MDBN", "RBMConfig", "DBNConfig", "MDBNConfig",
                 "load_config", "save_config"):
        assert hasattr(mdbn_tpu_torch, name)


def test_cd_train_step_and_model_extras():
    """cd_train_step is cd_step_stats + apply_update on draw_uniforms' draws;
    RBM.reconstruct / free_energy are the core functions on the trained
    parameters; state_to_numpy / state_from_numpy round-trip."""
    from mdbn_tpu_torch.convert import state_from_numpy, state_to_numpy
    from mdbn_tpu_torch.core.rbm_math import (apply_update, cd_step_stats, free_energy,
                                              hidden_mean, visible_mean)
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops.cd_step import cd_train_step, draw_uniforms

    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=10, momentum=0.5, persistent=True)
    st = init_train_state(cfg, device="cpu")
    v0 = torch.as_tensor(mnist_like(10, n_features=16, seed=4))
    p, v, chain, err = cd_train_step(st.params, st.velocity, st.chain_h, v0,
                                     torch.Generator().manual_seed(5), cfg, epoch=1)
    u = draw_uniforms(cfg, 10, torch.Generator().manual_seed(5))
    g, chain2, err2 = cd_step_stats(st.params, v0, st.chain_h, u, cfg)
    p2, v2 = apply_update(st.params, st.velocity, g, cfg, epoch=1)
    torch.testing.assert_close(p.W, p2.W, rtol=0, atol=0)
    torch.testing.assert_close(chain, chain2, rtol=0, atol=0)
    assert float(err) == float(err2)

    r = RBM(cfg.replace(epochs=1), device="cpu").train(mnist_like(40, n_features=16, seed=4))
    torch.testing.assert_close(r.reconstruct(v0), visible_mean(
        r.params, hidden_mean(r.params, v0, cfg), cfg))
    torch.testing.assert_close(r.free_energy(v0), free_energy(r.params, v0, cfg))
    back = state_from_numpy(state_to_numpy(r.state), device="cpu")
    torch.testing.assert_close(back.params.W, r.params.W, rtol=0, atol=0)
    assert back.epoch == r.state.epoch == 1


@pytest.mark.parametrize("name", ["c1_bernoulli_rbm_mnist", "c2_gaussian_rbm_ge",
                                  "c3_dbn_3layer", "c4_mdbn_3modality", "c5_pcd_kmeans"])
def test_cli_graded_configs_one_epoch(name, tmp_path, capsys):
    """The graded configs' models through the CLI on the CPU eager engine, one
    epoch on a cut of their data (60 rows): each runs to completion and writes
    finite codes, and c5's analysis block prints its k-means record."""
    exp = json.load(open(os.path.join(REPO, "configs", f"{name}.json")))
    size_key = "n_samples" if exp["data"]["kind"] == "mnist_like" else "n_patients"
    exp["data"][size_key] = 60
    path = str(tmp_path / "exp.json")
    json.dump(exp, open(path, "w"))
    out = str(tmp_path / "codes.npy")
    args = ["--config", path, "--epochs", "1", "--engine", "xla", "--transform-out", out,
            "--device", "cpu"]
    assert main(args) == 0
    codes = np.load(out)
    assert codes.shape[0] == 60 and np.isfinite(codes).all()
    if name.startswith("c5"):
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rec["kind"] == "kmeans" and sum(rec["cluster_sizes"]) == 60
        assert "ari_vs_planted" in rec and "logrank" in rec

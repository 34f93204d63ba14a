"""CLI runner: ``python -m mdbn_tpu_torch.run --config configs/<name>.json``.

Port of the model section of ``mdbn_tpu/run.py``: the experiment config's
"model" (an RBMConfig / DBNConfig / MDBNConfig) trains on its "data" spec
(synthetic kinds), and ``--save`` / ``--load`` / ``--transform-out`` persist
the model and write latent codes. It runs on the CUDA card unless
``--device cpu`` asks for the CPU. ``--dp N`` trains data-parallel over N
ranks, one process each, under ``torchrun --nproc-per-node N``; rank 0
writes the files. The config's "analysis" and "finetune" blocks, the
real-data loaders and ``--tp`` raise an error that names the ROADMAP.md item
porting them.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from .config import DBNConfig, MDBNConfig, RBMConfig, TrainRuntimeConfig, load_config
from .data import synthetic
from .models.dbn import DBN
from .models.mdbn import MDBN
from .models.rbm import RBM
from .utils.metrics import MetricsWriter, get_logger

log = get_logger("mdbn_tpu_torch.run")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to mdbn_tpu_torch yet "
                               f"(ROADMAP.md Queue 1, item {item})")


def build_data(spec: dict):
    """Synthetic generators behind the data spec format of mdbn_tpu.run.
    Returns (data, labels)."""
    kind = spec.get("kind", "mnist_like")
    kw = {k: v for k, v in spec.items() if k != "kind"}
    if kind == "mnist_like":
        return synthetic.mnist_like(**kw, return_labels=True)
    if kind == "bars_and_stripes":
        return synthetic.bars_and_stripes(**kw), None
    if kind == "tcga_like":
        return synthetic.tcga_like(**kw)
    if kind in ("mnist_idx", "omics_csv"):
        raise not_ported(f"the {kind!r} data loader (data/loaders.py)", "1")
    raise ValueError(f"unknown data kind {kind!r}")


def _check_sections(exp: dict) -> None:
    """Raise for the config blocks that are not ported; called after
    training, where the JAX runner runs them."""
    if exp.get("finetune"):
        raise not_ported("the 'finetune' block (train/finetune.py, autoencoder.py, "
                         "labeled.py, updown.py)", "9")
    analysis = exp.get("analysis") or {}
    if analysis.get("ais"):
        raise not_ported("the analysis 'ais' block (analysis/ais.py)", "10")
    if analysis.get("impute"):
        raise not_ported("the analysis 'impute' block (ops/sample.py, MDBN.impute)", "6")
    if analysis:
        raise not_ported("the 'analysis' block (k-means, consensus and survival: "
                         "analysis/cluster.py, kmeans_jax.py, consensus.py, "
                         "survival.py)", "8")


def _dp_mesh(n: int, device: str):
    """The mesh of ``--dp n``: this process is one of n ranks started by
    torchrun. Ranks that share a card (or the CPU) talk over gloo, ranks with
    a card each over NCCL."""
    from .parallel.mesh import make_mesh

    if os.environ.get("WORLD_SIZE") != str(n):
        raise RuntimeError(f"--dp {n} runs one process per rank: launch it as "
                           f"`torchrun --nproc-per-node {n} -m mdbn_tpu_torch.run "
                           f"--config <config> --dp {n}` (WORLD_SIZE is "
                           f"{os.environ.get('WORLD_SIZE')!r})")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    mesh = make_mesh(n, backend="nccl" if cards >= n else "gloo")
    if device == "cpu":
        return dataclasses.replace(mesh, device=torch.device("cpu"))
    return mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description="mdbn_tpu_torch experiment runner")
    ap.add_argument("--config", required=True)
    ap.add_argument("--epochs", type=int, default=None, help="override epochs")
    ap.add_argument("--engine", choices=["auto", "xla", "pallas"], default=None,
                    help="xla: eager PyTorch; pallas: the CUDA kernel")
    ap.add_argument("--metrics", default=None, help="JSONL metrics output path")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains (default: the CUDA card)")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel width: N ranks, launched by torchrun --nproc-per-node N")
    ap.add_argument("--tp", type=int, default=1, help="tensor-parallel width (not ported)")
    ap.add_argument("--save", default=None, metavar="DIR",
                    help="save the trained model to DIR after training")
    ap.add_argument("--load", default=None, metavar="DIR",
                    help="load a saved model from DIR instead of training")
    ap.add_argument("--transform-out", default=None, metavar="PATH",
                    help="write latent codes for the configured data to PATH (.npy or .csv)")
    args = ap.parse_args(argv)
    if args.tp != 1:
        raise not_ported("--tp (the dp x tp mesh, make_mesh_2d)", "11")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to train on the CPU")
    mesh = _dp_mesh(args.dp, args.device) if args.dp else None
    device = mesh.device if mesh is not None else args.device
    rank0 = mesh is None or mesh.rank == 0

    exp = load_config(args.config)
    model_cfg = exp["model"]
    data, _labels = build_data(exp.get("data", {"kind": "mnist_like"}))
    if isinstance(data, dict) and "modality" in exp:
        data = data[exp["modality"]]  # single-modality configs on multi-omics data

    def override(cfg):
        """Apply --epochs/--engine to any model config (recursing into MDBN)."""
        if isinstance(cfg, MDBNConfig):
            return dataclasses.replace(cfg, towers={m: override(t) for m, t in cfg.towers.items()},
                                       joint=override(cfg.joint))
        kw = {}
        if args.epochs is not None:
            kw["epochs"] = args.epochs
        if args.engine is not None:
            kw["engine"] = args.engine
        return dataclasses.replace(cfg, **kw) if kw else cfg

    model_cls = (RBM if isinstance(model_cfg, RBMConfig)
                 else DBN if isinstance(model_cfg, DBNConfig)
                 else MDBN if isinstance(model_cfg, MDBNConfig) else None)
    if model_cls is None:
        raise TypeError(f"unsupported model config {type(model_cfg)}")

    def write_codes(model) -> None:
        codes = model.transform(data).float().cpu().numpy()
        out = args.transform_out
        if out.endswith(".csv"):
            np.savetxt(out, codes, delimiter=",")
        else:
            np.save(out, codes)
        log.info("wrote %s latent codes to %s", codes.shape, out)

    if args.load:
        model = model_cls.load(args.load, device=device)
        if args.transform_out and rank0:
            write_codes(model)
        _check_sections(exp)
        return 0

    runtime = TrainRuntimeConfig(checkpoint_dir=args.checkpoint_dir,
                                 # flat RBM runs checkpoint every epoch;
                                 # DBN/MDBN at layer boundaries
                                 checkpoint_every_epochs=1 if args.checkpoint_dir else 0)
    layer_runtime = dataclasses.replace(runtime, checkpoint_every_epochs=0)
    with MetricsWriter(args.metrics if rank0 else None) as mw:
        if model_cls is RBM:
            model = RBM(override(model_cfg), device=device)
            model.train(data, mesh=mesh, runtime=runtime)
            for ep, (err, ups) in enumerate(zip(model.metrics.errors,
                                                model.metrics.updates_per_sec)):
                mw.write({"kind": "epoch", "epoch": ep, "recon_error": err,
                          "updates_per_sec": ups, "engine": model.metrics.engine,
                          "kernel": model.metrics.kernel})
            log.info("RBM trained (%s engine, %s): err %.5f -> %.5f", model.metrics.engine,
                     model.metrics.kernel, model.history[0], model.history[-1])
        elif model_cls is DBN:
            model = DBN(override(model_cfg), device=device)

            def layer_cb(l, rbm):
                mw.write({"kind": "layer", "layer": l, "errors": rbm.history,
                          "engine": rbm.metrics.engine, "kernel": rbm.metrics.kernel})
                log.info("layer %d trained (%s): err %.5f -> %.5f", l,
                         rbm.metrics.engine, rbm.history[0], rbm.history[-1])

            ck = None
            if args.checkpoint_dir:
                from .checkpoint import LayerCheckpointer

                ck = LayerCheckpointer(args.checkpoint_dir)
                if ck.completed():
                    log.info("resuming: restoring completed layers %s", ck.completed())
            model.train(data, mesh=mesh, runtime=layer_runtime, layer_callback=layer_cb,
                        checkpointer=ck)
        else:
            model = MDBN(override(model_cfg), device=device)
            model.train(data, mesh=mesh, runtime=layer_runtime,
                        checkpoint_dir=args.checkpoint_dir)
            for name, hist in model.history.items():
                mw.write({"kind": "tower", "name": name, "history": hist})
                log.info("%s trained", name)
            if args.checkpoint_dir and rank0:
                model.save(os.path.join(args.checkpoint_dir, "mdbn_final"))
        if args.save and rank0:
            model.save(args.save)
            log.info("model saved to %s", args.save)
        if args.transform_out and rank0:
            write_codes(model)
    _check_sections(exp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""CLI runner: ``python -m mdbn_tpu_torch.run --config configs/<name>.json``.

Port of ``mdbn_tpu/run.py``: the experiment config's "model" (an RBMConfig
/ DBNConfig / MDBNConfig) trains on its "data" spec (the synthetic kinds, or
real IDX images and omics CSVs through ``data/loaders.py``), ``--save`` /
``--load`` / ``--transform-out`` persist the model and write latent codes,
the "finetune" block runs the phase-2 trainers after training (and on a
``--load``-ed model, resuming its fine-tuned state): the deep autoencoder,
the backprop classifier, the associative label top, up-down and labeled
up-down, semi-supervised under "label_fraction", each with its record; and
the "analysis" block runs after that and under ``--load``: k-means
of the cohort's codes at a fixed k, by silhouette (``"auto"``) or by
consensus PAC (``"consensus"``), the ARI against planted labels, a log-rank
test and Cox regression across the clusters on planted or clinical survival,
leave-one-modality-out imputation (``"impute"``) and the AIS likelihood
(``"ais"``: an RBM's log-likelihood or its log Z bracket, a DBN's variational
bound, the labeled bound after labeled up-down). Each record is printed as a
JSON line and written to the ``--metrics`` file. Everything runs on the CUDA
card unless ``--device cpu`` asks for the CPU. ``--dp N`` trains
data-parallel over N ranks, one process each, under ``torchrun
--nproc-per-node N`` (the "finetune" block too: each rank its rows of every
minibatch); ``--dp N --tp M`` over a dp x tp mesh of N * M ranks under
``torchrun --nproc-per-node N*M`` (``parallel.mesh.make_mesh_2d``: W split
over the hidden units of M ranks, the minibatch's rows over N; the
"finetune" block splits rows over N and replicates over M); rank 0 writes
the files and runs the analysis. ``--profile`` writes a ``torch.profiler``
trace of each training run, ``--debug-nans`` stops at the first non-finite
parameter or error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from .analysis.cluster import adjusted_rand_index, kmeans_cluster, select_n_clusters
from .config import DBNConfig, MDBNConfig, RBMConfig, TrainRuntimeConfig, load_config
from .data import synthetic
from .models.dbn import DBN
from .models.mdbn import MDBN
from .models.rbm import RBM
from .utils.metrics import MetricsWriter, get_logger

log = get_logger("mdbn_tpu_torch.run")


def build_data(spec: dict):
    """Synthetic generators and real-data loaders behind one spec format.

    Returns (data, labels, patient_ids). Real kinds (``data.loaders``):
    {"kind": "mnist_idx", "path": ..., "binarize": "threshold"|"sample",
    "labels_path": ... (IDX1), "limit": N} and {"kind": "omics_csv", "paths":
    {modality: csv_path}, "zscore": bool, "nan_policy":
    "error"|"drop"|"impute_mean", "align": "strict"|"intersect",
    "orientation": "auto"|"patients_rows"|"features_rows"|{modality: mode},
    "header": "auto"|bool, "clinical_csv": path (its patient IDs are the
    reference cohort of the orientation's auto-detection)}."""
    kind = spec.get("kind", "mnist_like")
    kw = {k: v for k, v in spec.items() if k != "kind"}
    if kind == "mnist_like":
        # the generator's prototype ids double as planted labels
        data, labels = synthetic.mnist_like(**kw, return_labels=True)
        return data, labels, None
    if kind == "bars_and_stripes":
        return synthetic.bars_and_stripes(**kw), None, None
    if kind == "tcga_like":
        mods, labels = synthetic.tcga_like(**kw)
        return mods, labels, None
    if kind == "mnist_idx":
        from .data.loaders import load_mnist_images, load_mnist_labels

        limit = kw.pop("limit", None)
        labels_path = kw.pop("labels_path", None)
        data = load_mnist_images(**kw)
        labels = None
        if labels_path:
            labels = load_mnist_labels(labels_path)
            if len(labels) != len(data):
                raise ValueError(f"{len(labels)} labels for {len(data)} "
                                 "images — mismatched IDX files")
            labels = labels[:limit] if limit else labels
        return (data[:limit] if limit else data), labels, None
    if kind == "omics_csv":
        from .data.loaders import load_clinical_csv, load_omics_csv

        reference_ids = None
        if kw.get("clinical_csv"):
            _, _, reference_ids = load_clinical_csv(kw["clinical_csv"])
        mats, ids = load_omics_csv(
            kw["paths"], zscore_features=kw.get("zscore", True),
            nan_policy=kw.get("nan_policy", "error"),
            align=kw.get("align", "strict"), return_ids=True,
            header=kw.get("header", "auto"),
            orientation=kw.get("orientation", "auto"),
            reference_ids=reference_ids)
        return mats, None, ids
    raise ValueError(f"unknown data kind {kind!r}")


def _emit(rec: dict, mw) -> None:
    """A record to the metrics file (rank 0's) and to stdout as a JSON line."""
    if mw is not None:
        mw.write(rec)
    print(json.dumps(rec), flush=True)


AIS_UP_PASSES = 32  # the DBN bounds' stochastic up-passes a row (the reference's default)
FINETUNE_MODES = ("autoencoder", "classifier", "label_top", "updown", "updown_labeled")


def run_finetune(exp: dict, model, data, labels, mesh, mw) -> bool:
    """The config's "finetune" block (the reference's ``run.py:256-405``):
    {"mode": "autoencoder" | "classifier" | "label_top" | "updown" |
    "updown_labeled", "epochs": N, "lr": x, ...} on a DBN or MDBN, with the
    data spec's labels for the label modes. "label_fraction": f keeps a
    seeded fraction of the labels ("label_seed") and marks the rest -1, so
    the generative label modes train semi-supervised and the record also
    gives the accuracy on the hidden-label rows. Every rank trains (its rows
    of each minibatch under a mesh); rank 0 writes the record. Returns
    whether the block ran (the model's weights changed)."""
    spec = exp.get("finetune")
    if not spec:
        return False
    if isinstance(model, RBM):
        raise ValueError("'finetune' applies to DBN/MDBN configs (an RBM "
                         "has no stack to fine-tune)")
    mode = spec.get("mode", "autoencoder")
    if mode not in FINETUNE_MODES:
        raise ValueError(f"finetune mode must be 'autoencoder', 'classifier', 'label_top', "
                         f"'updown' or 'updown_labeled', got {mode!r}")
    epochs = int(spec.get("epochs", 10))
    batch = int(spec.get("batch_size", 20))
    labels_used, hidden_rows = labels, None
    frac = spec.get("label_fraction")
    if frac is not None:
        if labels is None:
            raise ValueError("'label_fraction' needs labels in the data spec to subsample")
        if mode not in ("label_top", "updown_labeled"):
            raise ValueError("'label_fraction' applies to the generative label modes "
                             "(label_top / updown_labeled)")
        frac = float(frac)
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"label_fraction={frac} not in (0, 1]")
        keep = np.random.default_rng(int(spec.get("label_seed", 0))).random(len(labels)) < frac
        if not keep.any():
            raise ValueError(f"label_fraction={frac} left zero labeled rows at this seed")
        labels_used = np.where(keep, np.asarray(labels), -1)
        hidden_rows = ~keep
    if mode in ("classifier", "label_top", "updown_labeled") and labels is None:
        raise ValueError(f"'finetune': {{'mode': '{mode}'}} needs labels — use a synthetic "
                         "data kind with planted labels or add 'labels_path' (IDX1 file) to "
                         "a mnist_idx data spec")
    n_classes = int(spec.get("n_classes", int(np.max(labels)) + 1)) if labels is not None else 0

    def accuracies(pred) -> dict:
        """Accuracy on the labeled rows, and on the hidden-label rows."""
        pred = pred.cpu().numpy()
        truth = np.asarray(labels)[: len(pred)]
        lab = np.asarray(labels_used)[: len(pred)] >= 0
        accs = {"train_accuracy": float((pred[lab] == truth[lab]).mean())}
        if hidden_rows is not None and hidden_rows[: len(pred)].any():
            hid = hidden_rows[: len(pred)]
            accs["accuracy_unlabeled"] = float((pred[hid] == truth[hid]).mean())
        return accs

    rec = {"kind": "finetune", "mode": mode, "epochs": epochs}
    if mode == "autoencoder":
        history = model.finetune_autoencoder(data, epochs=epochs,
                                             lr=float(spec.get("lr", 1e-3)), mesh=mesh)
        rec.update(loss_first=history[0], loss_last=history[-1])
        log.info("autoencoder fine-tune: loss %.5f -> %.5f", history[0], history[-1])
    elif mode == "updown":
        history = model.finetune_updown(data, epochs=epochs, lr=float(spec.get("lr", 0.01)),
                                        k=int(spec.get("k", 1)), batch_size=batch, mesh=mesh)
        rec.update(wake_mse_first=history[0], wake_mse_last=history[-1])
        log.info("up-down fine-tune: wake mse %.5f -> %.5f", history[0], history[-1])
    elif mode == "label_top":
        history = model.fit_label_top(
            data, np.asarray(labels_used), n_classes, n_hidden=int(spec.get("n_hidden", 64)),
            epochs=epochs, lr=float(spec.get("lr", 0.1)), k=int(spec.get("k", 1)),
            batch_size=batch, mesh=mesh)
        accs = accuracies(model.predict_generative(data))
        rec.update(n_classes=n_classes, err_first=history[0], err_last=history[-1], **accs)
        log.info("label-top fit: code mse %.5f -> %.5f, train acc %.3f",
                 history[0], history[-1], accs["train_accuracy"])
    elif mode == "updown_labeled":
        if model._label_top is None:
            # the label top comes first; fit it with the block's knobs
            model.fit_label_top(
                data, np.asarray(labels_used), n_classes,
                n_hidden=int(spec.get("n_hidden", 64)),
                epochs=int(spec.get("label_top_epochs", 20)),
                lr=float(spec.get("label_top_lr", 0.1)), batch_size=batch, mesh=mesh)
        history = model.finetune_updown_labeled(
            data, np.asarray(labels_used), epochs=epochs, lr=float(spec.get("lr", 0.01)),
            k=int(spec.get("k", 1)), batch_size=batch, mesh=mesh)
        accs = accuracies(model.predict_generative(data))
        rec.update(wake_mse_first=history[0], wake_mse_last=history[-1], **accs)
        log.info("labeled up-down: wake mse %.5f -> %.5f, train acc %.3f",
                 history[0], history[-1], accs["train_accuracy"])
    else:
        history = model.finetune(data, np.asarray(labels), n_classes, epochs=epochs,
                                 lr=float(spec.get("lr", 0.1)), batch_size=batch, mesh=mesh)
        pred = model.predict(data).cpu().numpy()
        acc = float((pred == np.asarray(labels)[: len(pred)]).mean())
        rec.update(n_classes=n_classes, loss_first=history[0], loss_last=history[-1],
                   train_accuracy=acc)
        log.info("classifier fine-tune: loss %.5f -> %.5f, train acc %.3f",
                 history[0], history[-1], acc)
    if mesh is None or mesh.rank == 0:
        _emit(rec, mw)
    return True


class Analysis:
    """The config's "analysis" block on a trained (or loaded) model: the AIS
    likelihood, imputation, the cohort's codes, k-means and its scores, and
    survival across the clusters. Every computation runs on the model's
    device except the survival statistics and the consensus cut, which run
    on the host as in the JAX runner."""

    CHUNK_ROWS = 65536  # cohort rows transformed at once

    def __init__(self, exp: dict, data, labels, patient_ids):
        self.analysis = exp.get("analysis") or {}
        self.data, self.labels, self.patient_ids = data, labels, patient_ids
        self._codes = None

    def cohort_codes(self, model) -> np.ndarray:
        """Latent codes of the whole configured cohort, on the host,
        transformed in chunks of ``CHUNK_ROWS`` rows and cached, so a run that
        both writes codes and clusters transforms once."""
        if self._codes is None:
            data = self.data
            n = len(next(iter(data.values()))) if isinstance(data, dict) else len(data)
            parts = []
            for lo in range(0, n, self.CHUNK_ROWS):
                sl = slice(lo, lo + self.CHUNK_ROWS)
                part = {m: v[sl] for m, v in data.items()} if isinstance(data, dict) else data[sl]
                parts.append(model.transform(part).float().cpu().numpy())
            self._codes = np.concatenate(parts, axis=0)
        return self._codes

    def run(self, model, mw) -> None:
        """The AIS likelihood, imputation, and k-means (fixed k, "auto" or
        "consensus") with survival, as the block asks. Used after training
        and under ``--load``."""
        a = self.analysis
        if not a:
            return
        if a.get("ais"):
            self.ais(model, mw)
        if a.get("impute"):
            self.impute(model, mw, a["impute"])
        if "kmeans" not in a:
            if not (a.get("ais") or a.get("impute")):
                log.warning("config has an 'analysis' block without a 'kmeans', 'ais' or "
                            "'impute' key — nothing to run; keys seen: %s", sorted(a))
            return
        self.kmeans(model, mw)

    def ais(self, model, mw) -> None:
        """The AIS log-likelihood of the trained model on the first
        "ais_samples" rows: an RBM's (``analysis/ais.py::log_likelihood``, or
        under "ais_bracket" the bidirectional bracket on log Z), a DBN's
        variational bound (its generative weights after up-down; the labeled
        bound after labeled up-down, when every layer is directed), each on
        the model's device. An MDBN has no single likelihood over the
        multimodal join, and an autoencoder-fine-tuned model no longer
        defines an energy model: both are skipped with a warning."""
        from .analysis import ais as ais_mod

        a = self.analysis
        if isinstance(model, MDBN):
            log.warning("'ais': true is only defined for RBM/DBN configs "
                        "(no joint likelihood over the multimodal join)")
            return
        if getattr(model, "_decoder", None) is not None:
            log.warning("'ais': true skipped — this model was autoencoder-fine-tuned; its "
                        "weights no longer define a consistent RBM energy model to evaluate")
            return
        sample = self.data[:int(a.get("ais_samples", 1000))]
        # anneal knobs (AIS.md: raise ais_betas first; "sm" concentrates
        # resolution near beta=1)
        kw = {"n_chains": int(a.get("ais_chains", 256)),
              "n_betas": int(a.get("ais_betas", 1000)),
              "n_sweeps": int(a.get("ais_sweeps", 1)),
              "schedule": str(a.get("ais_schedule", "uniform"))}
        # the ESS fraction in (0, 1) that triggers SMC resampling (0: off)
        res_ess = float(a.get("ais_resample_ess", 0.0))
        what = "AIS evaluation"
        if isinstance(model, RBM):
            if a.get("ais_bracket"):
                out = ais_mod.log_z_bracket(
                    model.params, model.cfg, sample, **kw,
                    init=str(a.get("ais_init", "resample")),
                    init_gibbs=int(a.get("ais_init_gibbs", 500)), resample_ess=res_ess)
            else:
                out = ais_mod.log_likelihood(model.params, model.cfg, sample, **kw,
                                             resample_ess=res_ess)
        else:
            if a.get("ais_bracket"):
                log.warning("'ais_bracket' is only defined for single-RBM configs; "
                            "running the one-sided DBN bound")
            gen = model._gen
            layers = [(r.params, r.cfg) for r in model.layers]
            what = f"AIS evaluation ({AIS_UP_PASSES} up-passes a row)"
            if gen is not None and len(gen) == len(model.layers):
                # labeled up-down made every stack layer directed; the
                # undirected top is the label-top RBM, whose softmax label
                # block the bound marginalises
                top, n_classes = model._label_top
                out = ais_mod.labeled_dbn_log_likelihood_bound(
                    layers, top, n_classes, sample, **kw, n_samples=AIS_UP_PASSES, gen=gen)
            else:
                # after up-down the top-down terms use the untied generative weights
                out = ais_mod.dbn_log_likelihood_bound(layers, sample, **kw,
                                                       n_samples=AIS_UP_PASSES, gen=gen)
        log.info("%s: %s", what, {k: round(v, 3) for k, v in out.items()})
        _emit({"kind": "ais", "n_rows": int(len(sample)), **out}, mw)

    def impute(self, model, mw, spec) -> None:
        """Leave-one-modality-out imputation (MDBN only): {"holdout": "meth"}
        withholds that modality, infers it from the rest (clamped Gibbs on the
        joint RBM and the tower's down-pass) and reports its MSE against the
        truth and against a row-shuffled truth; a ratio below 1 means the
        model carries patient-specific signal across modalities."""
        if not isinstance(model, MDBN):
            log.warning("'impute' is only defined for MDBN configs")
            return
        holdout = spec.get("holdout") if isinstance(spec, dict) else None
        if not holdout:
            raise ValueError("'impute' needs {'holdout': '<modality>'}")
        data = self.data
        if not isinstance(data, dict) or holdout not in data:
            raise ValueError(f"holdout modality {holdout!r} not in the data (have: "
                             f"{sorted(data) if isinstance(data, dict) else type(data)})")
        observed = {m: v for m, v in data.items() if m != holdout}
        imp = model.impute(observed, n_gibbs=int(spec.get("n_gibbs", 200)),
                           seed=int(spec.get("seed", 0)),
                           n_chains=int(spec.get("n_chains", 8)))
        x = imp[holdout].float().cpu().numpy()
        truth = np.asarray(data[holdout])
        mse = float(np.mean((x - truth) ** 2))
        shuf = truth[np.random.default_rng(0).permutation(len(truth))]
        control = float(np.mean((x - shuf) ** 2))
        rec = {"kind": "impute", "holdout": holdout, "mse": mse,
               "shuffled_control_mse": control,
               "ratio": mse / control if control else float("nan")}
        log.info("impute %s from %s: mse %.4f vs shuffled control %.4f (ratio %.3f)",
                 holdout, sorted(observed), mse, control, rec["ratio"])
        _emit(rec, mw)

    def kmeans(self, model, mw) -> None:
        a, device = self.analysis, model.device
        codes = self.cohort_codes(model)
        spec = a["kmeans"]
        scores, score_key = None, None
        span = dict(k_min=int(a.get("k_min", 2)), k_max=int(a.get("k_max", 8)))
        consensus = dict(n_resamples=int(a.get("consensus_resamples", 100)),
                         subsample=float(a.get("consensus_subsample", 0.8)), device=device)
        if spec == "auto":
            k, scores, pred = select_n_clusters(codes, **span, device=device)
            score_key = "silhouette_scores"
            log.info("silhouette-selected k=%d (scores: %s)", k,
                     {kk: round(s, 3) for kk, s in scores.items()})
        elif spec == "consensus":
            from .analysis.consensus import select_n_clusters_consensus

            k, scores, pred = select_n_clusters_consensus(codes, **span, **consensus)
            score_key = "pac_scores"
            log.info("consensus-selected k=%d (PAC: %s)", k,
                     {kk: round(s, 3) for kk, s in scores.items()})
        else:
            k = int(spec)
            if a.get("consensus"):
                from .analysis.consensus import consensus_cluster

                pred, _ = consensus_cluster(codes, k, **consensus)
            else:
                pred, _ = kmeans_cluster(codes, k, seed=0, device=device)
        rec = {"kind": "kmeans", "k": k,
               "cluster_sizes": np.bincount(pred, minlength=k).tolist()}
        if scores is not None:
            rec[score_key] = {str(kk): s for kk, s in scores.items()}
        if self.labels is not None:
            rec["ari_vs_planted"] = adjusted_rand_index(self.labels, pred)
            log.info("k-means ARI vs planted clusters: %.3f", rec["ari_vs_planted"])
        self.survival(rec, pred)
        _emit(rec, mw)

    def survival(self, rec: dict, pred: np.ndarray) -> None:
        """Do the clusters separate survival? "survival": true plants
        exponential survival times on the generator's labels;
        {"clinical_csv": path} loads per-patient (time, event) records,
        aligned to the cohort by patient ID where the omics CSVs carried
        one, with "cox" for hazard ratios against cluster "cox_baseline"."""
        spec = self.analysis.get("survival")
        times = events = None
        if isinstance(spec, dict) and spec.get("clinical_csv"):
            from .data.loaders import load_clinical_csv

            times, events, _ = load_clinical_csv(spec["clinical_csv"],
                                                 patient_ids=self.patient_ids)
            if len(times) != len(pred):
                raise ValueError(
                    f"clinical file has {len(times)} patients but the cohort has "
                    f"{len(pred)} — and no patient IDs were available to align them")
        elif spec and self.labels is not None:
            from .analysis.survival import synthetic_survival

            times, events = synthetic_survival(self.labels, seed=0)
        elif spec:
            log.warning("'survival': true needs planted labels (synthetic data kinds) "
                        "or a {'clinical_csv': ...} spec — skipping the survival leg")
        if times is None:
            return
        from .analysis.survival import cox_ph_clusters, logrank_test

        lr = logrank_test(times, events, pred)
        rec["logrank"] = lr
        log.info("log-rank test across clusters: chi2=%.2f p=%.2e", lr["chi2"], lr["p_value"])
        if isinstance(spec, dict) and spec.get("cox"):
            cox = cox_ph_clusters(times, events, pred,
                                  baseline=int(spec.get("cox_baseline", 0)))
            rec["cox"] = {k: cox[k] for k in ("clusters", "hazard_ratio", "ci95_low",
                                              "ci95_high", "p_wald", "lr_chi2", "lr_p",
                                              "converged")}
            log.info("Cox hazard ratios vs baseline: %s (LR p=%.2e)",
                     [round(h, 3) for h in cox["hazard_ratio"]], cox["lr_p"])


def _dp_mesh(n: int, device: str, tp: int = 1):
    """The mesh of ``--dp n`` (``--tp tp``): this process is one of n * tp
    ranks started by torchrun, on a dp x tp grid when tp > 1. Ranks that
    share a card (or the CPU) talk over gloo, ranks with a card each over
    NCCL."""
    from .parallel.mesh import make_mesh_2d

    world = n * tp
    if os.environ.get("WORLD_SIZE") != str(world):
        flags = f"--dp {n}" + (f" --tp {tp}" if tp > 1 else "")
        raise RuntimeError(f"{flags} runs one process per rank: launch it as "
                           f"`torchrun --nproc-per-node {world} -m mdbn_tpu_torch.run "
                           f"--config <config> {flags}` (WORLD_SIZE is "
                           f"{os.environ.get('WORLD_SIZE')!r})")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    return make_mesh_2d(n, tp, backend="nccl" if cards >= world else "gloo",
                        device="cpu" if device == "cpu" else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description="mdbn_tpu_torch experiment runner")
    ap.add_argument("--config", required=True)
    ap.add_argument("--epochs", type=int, default=None, help="override epochs")
    ap.add_argument("--engine", choices=["auto", "xla", "pallas"], default=None,
                    help="xla: eager PyTorch; pallas: the CUDA kernel")
    ap.add_argument("--metrics", default=None, help="JSONL metrics output path")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--profile", action="store_true",
                    help="write a torch.profiler trace of each training run to "
                         "mdbn_tpu_profile under the temporary directory ($TMPDIR)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise at the first non-finite parameter, velocity or error")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains (default: the CUDA card)")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel width: N ranks, launched by torchrun --nproc-per-node N")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width (with --dp): N*M ranks, W split over M of them")
    ap.add_argument("--save", default=None, metavar="DIR",
                    help="save the trained model to DIR after training")
    ap.add_argument("--load", default=None, metavar="DIR",
                    help="load a saved model from DIR instead of training")
    ap.add_argument("--transform-out", default=None, metavar="PATH",
                    help="write latent codes for the configured data to PATH (.npy or .csv)")
    args = ap.parse_args(argv)
    if args.tp < 1 or (args.tp > 1 and not args.dp):
        raise ValueError(f"--tp {args.tp} acts only with --dp N (a dp x tp mesh of N * "
                         f"{args.tp} ranks under torchrun)")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to train on the CPU")
    mesh = _dp_mesh(args.dp, args.device, args.tp) if args.dp else None
    device = mesh.device if mesh is not None else args.device
    rank0 = mesh is None or mesh.rank == 0

    exp = load_config(args.config)
    model_cfg = exp["model"]
    data, labels, patient_ids = build_data(exp.get("data", {"kind": "mnist_like"}))
    if isinstance(data, dict) and "modality" in exp:
        data = data[exp["modality"]]  # single-modality configs on multi-omics data
    analysis = Analysis(exp, data, labels, patient_ids)

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
        codes = analysis.cohort_codes(model)
        out = args.transform_out
        if out.endswith(".csv"):
            np.savetxt(out, codes, delimiter=",")
        else:
            np.save(out, codes)
        log.info("wrote %s latent codes to %s", codes.shape, out)

    def finetune(model, mw) -> None:
        if run_finetune(exp, model, data, labels, mesh, mw):
            analysis._codes = None  # the weights changed: any cached codes are stale

    if args.load:
        # inference: a saved model codes, clusters or imputes the configured
        # cohort; a "finetune" block resumes or extends its fine-tuning
        model = model_cls.load(args.load, device=device)
        with MetricsWriter(args.metrics if rank0 else None) as mw:
            finetune(model, mw)
            if args.transform_out and rank0:
                write_codes(model)
            if rank0:
                analysis.run(model, mw)
        if args.save and rank0:
            model.save(args.save)
            log.info("model saved to %s", args.save)
        return 0

    runtime = TrainRuntimeConfig(profile=args.profile, debug_nans=args.debug_nans,
                                 checkpoint_dir=args.checkpoint_dir,
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
                rbms = model.towers[name].layers if name in model.towers else [model.joint]
                mw.write({"kind": "tower", "name": name, "history": hist,
                          "kernels": [r.metrics.kernel if r.metrics else None for r in rbms]})
                log.info("%s trained", name)
            if args.checkpoint_dir and rank0:
                model.save(os.path.join(args.checkpoint_dir, "mdbn_final"))
        finetune(model, mw)
        if args.save and rank0:
            model.save(args.save)
            log.info("model saved to %s", args.save)
        if args.transform_out and rank0:
            write_codes(model)
        if rank0:
            analysis.run(model, mw)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The fit job: a fresh RBM of the cell's configuration trained on the cell's data
through the measured program's model API, ``RBM(cfg, generator).train(data)``,
until the trained model's parameters are final on the card and its per-epoch
errors are on the host. Each job's CPU generator is seeded with the job's own
seed, so the program draws its initial weights and its kernels' seeds from it.

Workload keys under ``job``: ``epoch_callback`` (true: ``train`` gets a
callback that records each epoch's error, and the trainer runs an epoch a
launch); ``ranks`` (data parallelism: each job trains over the run's mesh of
that many cards, one process a card, at a global batch of ``ranks`` times the
configuration's). Under ``route``: ``counter`` ("module:attribute", a launch
counter of the program) and ``per_job``, the launches each job must add to it
on each rank.

The comparison (``check``) takes a sample of the window's jobs and holds each
against the plain reference (``reference.rbm``):

- ``last_update_gap``: the reference follows the fit's last update from the
  state before it, recovered from the fit's outputs, and compares the step;
  exact to rounding, this covers the kernel's products, draws, gradient and
  update on the program's own state;
- ``fit_error_gap``: the largest relative gap of an epoch's error, and
- ``fit_param_gap``: the worst leaf's gap of the trained parameters, over the
  reference's change from the start, both against the reference's whole fit
  replayed from the start on the same draws. A draw that float32 rounding
  tips the other way lets the two fits part after it, so these two are loose
  and check the start and the order of the fit, which the first skips;
- ``route_launches_off``: how far the launch counter moved from the window's
  jobs times ``per_job``.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from bench_port.reference import rbm as ref


class Fits:
    def __init__(self, config: Dict, workload: Dict, data: torch.Tensor,
                 fit: Optional[Callable[[int], ref.FitOutputs]] = None,
                 overrides: Optional[Dict] = None, mesh=None):
        """``fit``: a stand-in for the program (job seed -> outputs), for the
        tests and the control; ``overrides``: fields of the program's config
        set for the control (its lower precision); ``mesh``: the program's
        data-parallel mesh (``parallel.mesh``) of a ``ranks`` job."""
        ranks = int(workload["job"].get("ranks", 1))
        self.config = {**config, "batch_size": config["batch_size"] * ranks}
        self.data, self.mesh = data, mesh
        self.spec = ref.Spec.from_config(self.config)
        self.per_epoch = bool(workload["job"].get("epoch_callback", False))
        self.stream = ref.Stream(per_epoch=self.per_epoch, ranks=ranks)
        nb = data.shape[0] // self.spec.batch_size
        self.updates_per_job = self.spec.epochs * nb
        self.route = workload["route"]
        self.check_params = workload["check"]
        self._stand_in = fit
        self._stand_in_launches = 0
        if fit is None:
            from mdbn_tpu_torch import RBM, RBMConfig

            fields = {f.name for f in dataclasses.fields(RBMConfig)}
            self._cfg = RBMConfig(**{**{k: v for k, v in self.config.items() if k in fields},
                                     **(overrides or {})})
            self._RBM = RBM

    @property
    def launches_per_job(self) -> int:
        return int(self.route["per_job"])

    def route_count(self) -> int:
        if self._stand_in is not None:
            return self._stand_in_launches
        module, attr = self.route["counter"].split(":")
        return int(getattr(sys.modules.get(module) or importlib.import_module(module), attr))

    def run(self, job_seed: int):
        """One job (the timed call); what ``outputs`` reads its results from."""
        if self._stand_in is not None:
            self._stand_in_launches += self.launches_per_job
            return self._stand_in(job_seed)
        gen = torch.Generator().manual_seed(job_seed)
        with record_function("bench.model"):
            model = self._RBM(self._cfg, generator=gen,
                              device=None if self.mesh is None else self.mesh.device)
        errs: List[float] = []
        callback = None
        if self.per_epoch:
            def callback(epoch, err, state):
                with record_function("bench.callback"):
                    errs.append(err)
        with record_function("bench.train"):
            model.train(self.data, epoch_callback=callback, mesh=self.mesh)
        with record_function("bench.sync"):
            torch.cuda.synchronize(self.data.device)
        return model, errs

    def outputs(self, result) -> ref.FitOutputs:
        if isinstance(result, ref.FitOutputs):
            return result
        model, errs = result
        p, v = model.state.params, model.state.velocity
        return ref.FitOutputs(p.W, p.b, p.c, v.W, v.b, v.c, errs if self.per_epoch
                              else list(model.history))

    def check(self, kept: List[Tuple[int, ref.FitOutputs]], log=print) -> Dict[str, float]:
        """The compared numbers over the sampled jobs (the largest of each)."""
        amb, flips = float(self.check_params["ambiguity"]), int(self.check_params["max_flips"])
        worst = {"last_update_gap": 0.0, "fit_error_gap": 0.0, "fit_param_gap": 0.0}
        for job_seed, out in kept:
            out = out.to(self.data.device)
            step_gap, step_leaf, both_ways = ref.last_update(self.spec, self.data, job_seed,
                                                             self.stream, out, amb, flips)
            replay = ref.fit(self.spec, self.data, job_seed, self.stream)
            if len(out.errs) != len(replay.errs):
                err_gap = 1e30  # a fit that reports another number of epochs
            else:
                err_gap = max(abs(a - b) / abs(b) for a, b in zip(out.errs, replay.errs))
            W0, _ = ref.job_stream(self.spec, job_seed, self.stream, 1, "cpu")
            start = {"W": W0.to(self.data.device), "b": torch.zeros_like(replay.b),
                     "c": torch.zeros_like(replay.c)}
            param_gap, param_leaf = ref.leaf_gap(out.leaves(), replay.leaves(), start)
            log(f"check job seed {job_seed}: last_update_gap {step_gap!r} ({step_leaf}, "
                f"{both_ways} draws both ways), fit_error_gap {err_gap!r}, fit_param_gap "
                f"{param_gap!r} ({param_leaf}); errors {out.errs[-1]!r} vs {replay.errs[-1]!r}")
            for name, value in (("last_update_gap", step_gap), ("fit_error_gap", err_gap),
                                ("fit_param_gap", param_gap)):
                worst[name] = max(worst[name], value)
        return worst

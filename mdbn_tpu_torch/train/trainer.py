"""Epoch/batch training loop for one RBM on one device.

Port of the single-device path of ``mdbn_tpu/train/trainer.py``. The
dataset is moved to the device once. By default the whole multi-epoch run
is one call of the selected engine; per-epoch mode (one call per epoch)
runs when the caller needs per-epoch callbacks or checkpoints.

Engines (``cfg.engine``):

- ``"pallas"`` -> ``"cuda"``: a hand-written kernel, one launch per run,
  the one ``ops.cd_epoch_cuda.select_kernel`` names from the config and the
  card's shared memory: ``csrc/cd_train_resident.cu`` (W resident in shared
  memory) for a run whose tiles fit the card, under the plain estimator or
  any estimator mode, the W-blocked ``csrc/cd_train_wide.cu`` for a wide run
  inside that kernel's scope, ``csrc/cd_train_wide_modes.cu`` for a wide run
  under tempering, the enhanced gradient or learned variance, else
  ``csrc/cd_train.cu`` (``ops.cd_epoch_cuda.kernel_run``), at any k.
  Raises on the CPU.
- ``"xla"`` -> ``"eager"``: ``ops.cd_epoch_cuda.cd_train_run_plain``, the
  plain PyTorch version of the same run, on any device.
- ``"auto"``: ``"cuda"`` when the state lies on a CUDA device, else
  ``"eager"``. Decided from the config and the device before anything runs.

Under a data-parallel ``mesh`` of more than one rank
(``parallel.mesh.make_mesh``) the run goes through
``parallel.dp.train_rbm_shard_map``: ``"cuda_dp"`` runs each rank's step on
the DP kernels (``engine="pallas"`` or ``"auto"`` on CUDA, in every estimator
mode, at both storage dtypes and at any k),
``"eager_dp"`` on their plain versions (``"xla"``, or the CPU). Which DP
kernels, ``ops.cd_epoch_cuda.select_dp_kernel`` decides from the config,
the rank count and the card's limits: the resident kernel's step variant
(``csrc/cd_train_resident.cu``, "cd_grads_resident") where a rank's tiles
fit thread-block clusters, else ``csrc/cd_grads.cu`` (each a step into a
flat buffer, an all-reduce, an elementwise update; over NCCL one epoch
captured as a CUDA graph and replayed), or for a run inside the W-blocked
kernel's scope at least ``WIDE_DP_MIN_VISIBLE`` wide
``csrc/cd_grads_wide.cu`` (a step split over strips of W, an all-gather of
the factors, an update that forms the gradient from them). A mesh of one rank takes the single-device path.
``EpochMetrics.kernel`` names the kernel the route took (under an eager
engine, the kernel whose plain version ran).

Under a dp x tp mesh (``parallel.mesh.make_mesh_2d`` with ``tp > 1``) the
run goes through ``parallel.tp.train_rbm_tp``, engine ``"eager_tp"`` on
CUDA and on the CPU alike (``engine`` "auto" or "xla"; "pallas" raises, as
in the reference, whose dp x tp path is its XLA engine and reaches no
kernel): the eager engine with W, c, their velocities and the chain split
over the hidden units and the tp collectives of its sums; its
``EpochMetrics.kernel`` is None. A dp x 1 mesh is the 1-D mesh.

``TrainRuntimeConfig.profile`` traces the run with ``torch.profiler`` (CPU
and CUDA) into ``profile_dir``; ``debug_nans`` raises ``FloatingPointError``
at the first epoch whose error, parameters or velocities are not finite,
checked by a host read once an epoch (once after the launch on the fused
path, as the reference checks only the outputs of its jitted calls). Neither
sets any global state.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..config import RBMConfig, TrainRuntimeConfig
from ..core.rbm_math import torch_dtype
from ..core.state import TrainState, init_train_state
from ..ops import cd_epoch_cuda
from ..parallel.dp import train_rbm_shard_map
from ..parallel.tp import train_rbm_tp


def resolve_engine(cfg: RBMConfig, device: torch.device) -> str:
    """The engine a run of ``cfg`` on ``device`` uses: "cuda" (the kernel
    ``ops.cd_epoch_cuda.select_kernel`` names, which takes every config) or
    "eager". ``"auto"`` runs the kernel on CUDA and the eager engine on the
    CPU; ``"pallas"`` raises on the CPU; ``"xla"`` is the eager engine."""
    if cfg.engine == "xla":
        return "eager"
    if cfg.engine == "pallas" and device.type != "cuda":
        raise ValueError(f"engine='pallas' runs the CUDA kernel, and the model "
                         f"lies on {device}; use engine='xla' (the eager "
                         f"PyTorch engine) there")
    return "cuda" if device.type == "cuda" else "eager"


def resolve_dp_engine(cfg: RBMConfig, device: torch.device, tp: int = 1) -> str:
    """The engine a run of ``cfg`` on ``device`` under a mesh of more than one
    rank uses: "cuda_dp" or "eager_dp", or under a dp x tp mesh (``tp`` > 1)
    "eager_tp". On CUDA, ``"pallas"`` and ``"auto"``
    run the DP kernels, which take every config; "eager_dp" is ``"xla"``, or
    the CPU. Either engine takes the
    route ``ops.cd_epoch_cuda.select_dp_kernel`` gives: the resident
    kernel's step variant or ``csrc/cd_grads.cu`` (the step's statistics, an
    all-reduce, the update), or for a wide run in
    the W-blocked kernel's scope ``csrc/cd_grads_wide.cu`` (the step's
    factors, an all-gather, the update that forms the gradient from them).
    A tp mesh runs ``parallel.tp`` on any device under "auto" and "xla";
    "pallas" raises there, as the reference's does."""
    if tp > 1:
        if cfg.engine == "pallas":
            raise ValueError("engine='pallas' supports dp meshes only; use engine='xla' (or "
                             "'auto') for dp x tp")
        return "eager_tp"
    if cfg.engine != "xla" and device.type == "cuda":
        return "cuda_dp"
    if cfg.engine == "pallas":
        raise ValueError(f"engine='pallas' under a mesh runs the CUDA kernels of cd_grads.cu, "
                         f"and the model lies on {device}; use engine='xla' there")
    return "eager_dp"


def _check_finite(state: TrainState, errs: torch.Tensor, first_epoch: int) -> None:
    """``runtime.debug_nans``: raise FloatingPointError naming the epoch and
    the tensor when an epoch's error (``errs``, one an epoch from
    ``first_epoch``), a parameter or a velocity is not finite. A host read,
    made only under the flag: once an epoch on the per-epoch path, once after
    the launch on the fused one (whose kernel runs every epoch at once)."""
    for i, e in enumerate(errs.tolist()):
        if not math.isfinite(e):
            raise FloatingPointError(f"debug_nans: the reconstruction error of epoch "
                                     f"{first_epoch + i} is {e}")
    for what, tensors in (("params", state.params), ("velocity", state.velocity)):
        for name, t in tensors.as_dict().items():
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"debug_nans: {what}.{name} is not finite after "
                                         f"epoch {state.epoch - 1}")


@contextlib.contextmanager
def _profiled(runtime: TrainRuntimeConfig):
    """``runtime.profile``: a torch.profiler trace of the CPU and, where
    there is one, the CUDA card over the run, written to
    ``runtime.profile_dir`` when the run ends (or fails), one file a run."""
    if not runtime.profile:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(runtime.profile_dir))
    prof.start()
    try:
        yield
    finally:
        prof.stop()


class EpochMetrics:
    """Per-epoch errors and rates of a run, its engine, and the kernel its
    route took ("cd_train_resident", "cd_train", "cd_train_wide",
    "cd_train_wide_modes", "cd_grads_resident", "cd_grads" or
    "cd_grads_wide"; under an eager
    engine, the kernel whose plain version ran: "cd_train", whose plain
    version is also the resident kernel's and the wide modes kernel's; None
    under "eager_tp", which has no kernel)."""

    __slots__ = ("errors", "updates_per_sec", "wall_seconds", "engine", "kernel")

    def __init__(self, engine: str = "eager", kernel: Optional[str] = None):
        self.errors: List[float] = []
        self.updates_per_sec: List[float] = []
        self.wall_seconds: List[float] = []
        self.engine = engine
        self.kernel = kernel


def _slice_epochs(uniforms: Dict[str, torch.Tensor], lo: int, hi: int):
    return {name: u[lo:hi] for name, u in uniforms.items()}


def train_rbm(
    data,
    cfg: RBMConfig,
    state: Optional[TrainState] = None,
    runtime: Optional[TrainRuntimeConfig] = None,
    epoch_callback: Optional[Callable[[int, float, TrainState], None]] = None,
    uniforms: Optional[Dict[str, torch.Tensor]] = None,
    device: Optional[torch.device | str] = None,
    mesh=None,
) -> Tuple[TrainState, EpochMetrics]:
    """Train one RBM for ``cfg.epochs`` epochs on the device of ``state``
    (a fresh state goes on ``device``, default the CUDA card).

    ``uniforms``: the run's random draws in the inject layout of
    ``ops.cd_epoch_cuda.draw_uniform_blocks`` (the layout of
    ``mdbn_tpu``'s ``make_pallas_train_fn(..., inject=True)``; under a dp x
    tp mesh too), or under a 1-D mesh in that of
    ``parallel.dp.train_rbm_shard_map``, for exact
    comparisons; by default they come from the state's generator.
    ``mesh``: a ``parallel.mesh.Mesh``; every rank calls ``train_rbm`` with
    the same arguments, and rank 0 alone writes checkpoints and metrics.
    """
    runtime = runtime or TrainRuntimeConfig()
    if state is None:
        state = init_train_state(cfg, device=device)
    dev = state.device
    dp = mesh is not None and mesh.size > 1
    engine = resolve_dp_engine(cfg, dev, mesh.tp) if dp else resolve_engine(cfg, dev)
    if dp and mesh.backend == "nccl" and dev != mesh.device:
        raise ValueError(f"the model lies on {dev}, this rank's card is {mesh.device}")
    if engine == "eager_tp":
        kernel = None
    elif dp:
        limits = None
        if engine == "cuda_dp":  # the card's limits for a rank's step
            from ..ops.cd_epoch_resident_cuda import device_limits
            from ..ops.cd_grads_resident_cuda import step_library

            local = cfg.replace(batch_size=-(-cfg.batch_size // mesh.size))
            limits = device_limits(local, dev, step_library(local))
        kernel = cd_epoch_cuda.select_dp_kernel(cfg, mesh.size, limits)
    elif engine == "cuda":
        from ..ops.cd_epoch_resident_cuda import device_limits

        kernel = cd_epoch_cuda.select_kernel(cfg, device_limits(cfg, dev))
    else:
        kernel = "cd_train"
    run = (cd_epoch_cuda.kernel_run(kernel) if engine == "cuda"
           else cd_epoch_cuda.cd_train_run_plain)
    writes = not dp or mesh.rank == 0
    data = torch.as_tensor(data).to(device=dev, dtype=torch_dtype(cfg.param_dtype))
    nb = data.shape[0] // cfg.batch_size
    if nb == 0:
        raise ValueError(f"dataset has {data.shape[0]} samples — fewer than one "
                         f"minibatch (batch_size={cfg.batch_size})")
    if uniforms is not None:
        uniforms = {name: torch.as_tensor(u).to(device=dev, dtype=torch.float32)
                    for name, u in uniforms.items()}

    def run_epochs(st: TrainState, lo: int, hi: int) -> Tuple[TrainState, torch.Tensor]:
        u = None if uniforms is None else _slice_epochs(uniforms, lo, hi)
        if engine == "eager_tp":
            return train_rbm_tp(st, data, cfg, mesh, hi - lo, uniforms=u)
        if dp:
            return train_rbm_shard_map(st, data, cfg, mesh, hi - lo,
                                       pallas_step=engine == "cuda_dp", uniforms=u)
        order = cd_epoch_cuda.batch_order(cfg, nb, hi - lo, st.generator)
        params, velocity, chain, errs = run(cfg, st.params, st.velocity, st.chain_h,
                                            data, order, st.epoch, u, st.generator)
        return TrainState(params, velocity, chain, st.generator, st.epoch + hi - lo), errs

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    metrics = EpochMetrics(engine, kernel)
    per_epoch = epoch_callback is not None or runtime.checkpoint_every_epochs > 0
    with _profiled(runtime):
        if per_epoch:
            ck_every = runtime.checkpoint_every_epochs
            for ep in range(cfg.epochs):
                sync()
                t0 = time.perf_counter()
                state, errs = run_epochs(state, ep, ep + 1)
                err = float(errs[0])
                dt = time.perf_counter() - t0
                if runtime.debug_nans:
                    _check_finite(state, errs, ep)
                metrics.errors.append(err)
                metrics.wall_seconds.append(dt)
                metrics.updates_per_sec.append(nb / dt if dt > 0 else float("inf"))
                if epoch_callback is not None:
                    epoch_callback(ep, err, state)
                if (writes and runtime.checkpoint_dir and ck_every > 0
                        and (ep + 1) % ck_every == 0):
                    from ..checkpoint import save_state

                    save_state(state, f"{runtime.checkpoint_dir}/epoch{ep + 1:05d}.pt")
        else:
            sync()
            t0 = time.perf_counter()
            state, errs = run_epochs(state, 0, cfg.epochs)
            metrics.errors = [float(e) for e in errs.tolist()]
            dt = time.perf_counter() - t0
            if runtime.debug_nans:
                _check_finite(state, errs, 0)
            per = dt / cfg.epochs
            metrics.wall_seconds = [per] * cfg.epochs
            metrics.updates_per_sec = [nb / per if per > 0 else float("inf")] * cfg.epochs
    # runtime.metrics_path: stream per-epoch records for programmatic users
    if runtime.metrics_path and writes:
        from ..utils.metrics import MetricsWriter

        with MetricsWriter(runtime.metrics_path) as mw:
            for ep, (err, ups) in enumerate(zip(metrics.errors, metrics.updates_per_sec)):
                mw.write({"kind": "epoch", "epoch": ep, "recon_error": err,
                          "updates_per_sec": ups, "engine": metrics.engine,
                          "kernel": metrics.kernel})
    return state, metrics

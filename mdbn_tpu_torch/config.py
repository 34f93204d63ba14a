"""Typed configuration for mdbn_tpu_torch.

A copy of ``mdbn_tpu/config.py`` (same frozen dataclasses, validation and
``__type__`` JSON round-trip), so every ``configs/*.json`` loads unchanged.
The port carries its own copy because importing anything under ``mdbn_tpu``
imports JAX.

Engine names carry over from the JAX package: ``"xla"`` selects the eager
PyTorch engine, ``"pallas"`` the hand-written CUDA kernel
(``ops/cd_epoch_cuda.py``), ``"auto"`` the kernel when the tensors are on a
CUDA device and the config is one the kernel takes, else the eager engine.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

VISIBLE_TYPES = ("bernoulli", "gaussian")
ERROR_METRICS = ("mse", "xent", "pseudo")
ENGINES = ("auto", "xla", "pallas")
MATMUL_PRECISIONS = ("auto", "fast", "highest")
INIT_SCHEMES = ("normal", "uniform_glorot4")
GRADIENTS = ("plain", "enhanced")


@dataclass(frozen=True)
class RBMConfig:
    """One restricted Boltzmann machine + its CD-k training recipe.

    Math follows Hinton's practical guide / the Theano-tutorial lineage the
    reference descends from (SURVEY.md §0, §3.1):

    - ``P(h|v) = sigmoid(v @ W + c)``; Bernoulli visible
      ``P(v|h) = sigmoid(h @ W.T + b)``; Gaussian visible (sigma=1, z-scored
      data) ``v|h ~ N(h @ W.T + b, I)``.
    - CD-k restarts the Gibbs chain at the data each minibatch; PCD carries a
      persistent hidden chain state across minibatches.
    - Update: ``vel = momentum * vel + lr * (grad - l2 * W)`` (decay on W
      only), ``param += vel``.
    """

    n_visible: int
    n_hidden: int
    visible: str = "bernoulli"
    # --- learned per-unit visible variance (Gaussian visible only) ---
    # The Cho/Krizhevsky GRBM parameterization with z_i = log sigma_i^2
    # learned by CD alongside W/b/c (Cho, Ilin & Raiko, ICANN 2011):
    #   E(v,h) = sum_i (v_i-b_i)^2/(2 sigma_i^2)
    #            - sum_ij (v_i/sigma_i^2) W_ij h_j - c.h
    #   P(h|v) = sigmoid((v/sigma^2) @ W + c);  v|h ~ N(b + h @ W.T, sigma^2)
    # z is stored as RBMParams.z ([n_visible]); with learn_variance=False the
    # sigma=1 path is unchanged (z is absent from the pytree, so existing
    # checkpoints keep their structure). Removes the hard requirement that
    # continuous data be exactly unit-variance z-scored.
    learn_variance: bool = False
    # lr for z only (None -> cfg.lr). Variance gradients are stiff early in
    # training (Cho et al. recommend a smaller rate).
    lr_variance: Optional[float] = None
    # --- CD/PCD ---
    k: int = 1
    persistent: bool = False
    # --- parallel tempering (Desjardins et al. 2010, AISTATS) ---
    # pt_temps > 1 replaces the PCD negative chain with pt_temps persistent
    # chains at inverse temperatures linspace(1, pt_beta_min, pt_temps),
    # coupled by Metropolis swaps each update — the mixing fix for rough
    # CD/PCD-trained landscapes (see AIS.md's phase-trap measurement).
    # Requires persistent=True; fused in the Pallas mega-kernel (incl.
    # learn_variance) and DP-capable (per-particle ladders shard with the
    # batch; PT.md).
    pt_temps: int = 1
    pt_beta_min: float = 0.0
    # --- gradient estimator ---
    # "plain": the canonical CD/PCD statistics (positive - negative phase).
    # "enhanced": the enhanced gradient of Cho, Raiko & Ilin (ICML 2011) —
    # the same sufficient statistics recombined around the batch's
    # data/model mean offsets, making the update invariant to bit-flip
    # reparameterizations of the units (the centering-trick family,
    # cf. Montavon & Mueller 2012). A pure per-update transformation of the
    # stats: no extra state, sampling/transform/AIS semantics unchanged.
    # Runs on the XLA engine (single chip or GSPMD dp mesh, where the
    # global-batch means are exact by construction).
    gradient: str = "plain"
    # --- optimizer ---
    lr: float = 0.1
    momentum: float = 0.0
    l2: float = 0.0
    # elementwise gradient clip to [-grad_clip, +grad_clip]; stability guard
    # for Gaussian-RBM training (SURVEY.md §7 hard-part 4). None = off.
    grad_clip: Optional[float] = None
    # Hinton practical-guide momentum schedule: start at initial_momentum and
    # switch to `momentum` from epoch momentum_switch_epoch on. None = constant.
    initial_momentum: Optional[float] = None
    momentum_switch_epoch: int = 5
    # Hinton practical-guide sparsity regularization: drive each hidden unit's
    # mean activation toward sparsity_target with weight sparsity_cost
    # (adds sparsity_cost * (target - mean(h0p)) to the hidden-bias gradient).
    sparsity_target: Optional[float] = None
    sparsity_cost: float = 0.0
    # --- schedule ---
    batch_size: int = 20
    epochs: int = 10
    shuffle: bool = False  # Theano-tutorial lineage iterates in order
    # --- sampling choices ---
    # None -> True for bernoulli (tutorial samples visibles in the chain),
    # False for gaussian (mean-field negative phase; standard stability
    # practice for sigma=1 GRBMs on z-scored data), EXCEPT True when
    # learn_variance: sampled visibles carry the variance signal directly
    # (measured to recover planted sigma more accurately than the
    # mean-field path's Rao-Blackwellized correction; both are unbiased
    # in the (v-b)^2 term, mean-field residually couples W to small-sigma
    # noise).
    sample_visible: Optional[bool] = None
    # --- monitoring ---
    # Reconstruction-error formula is ambiguous in the reference
    # (SURVEY.md §4 risk note): implement both, default MSE.
    error_metric: str = "mse"
    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # set "bfloat16" to run matmuls on the MXU in bf16
    # f32 matmul passes on the MXU (ignored for compute_dtype="bfloat16"):
    # - "auto": each engine's measured-optimal default — the XLA engine runs
    #   true f32 (Precision.HIGHEST; its step cost is dominated elsewhere),
    #   the fused Pallas kernels run the one-pass MXU (bf16-grade multiplies,
    #   f32 accumulation — the TF32-like regime; 3.4x the update rate at the
    #   graded 784x500 shape, and the distributional parity criterion holds,
    #   PARITY.md).
    # - "highest": true f32 everywhere — the engines become mutually
    #   replayable to ~1e-7/op (the hardware inject-parity tests use this).
    # - "fast": one-pass MXU everywhere, including the XLA engine.
    matmul_precision: str = "auto"
    # --- engine ---
    engine: str = "auto"  # auto|xla|pallas
    # --- init ---
    # "normal": W ~ N(0, init_scale) (Hinton's practical guide).
    # "uniform_glorot4": W ~ U(±4*sqrt(6/(nv+nh))) — the Theano-tutorial
    # lineage's init; one flag away until the reference pins the convention
    # (SURVEY.md §7 hard-part 5).
    init: str = "normal"
    init_scale: float = 0.01  # N(0, init_scale) weight init (Hinton's guide)
    seed: int = 0

    def __post_init__(self):
        if self.visible not in VISIBLE_TYPES:
            raise ValueError(f"visible must be one of {VISIBLE_TYPES}, got {self.visible!r}")
        if self.error_metric not in ERROR_METRICS:
            raise ValueError(f"error_metric must be one of {ERROR_METRICS}, got {self.error_metric!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {self.engine!r}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.pt_temps < 1:
            raise ValueError("pt_temps must be >= 1 (1 = tempering off)")
        if self.pt_temps > 1:
            if not self.persistent:
                raise ValueError("pt_temps > 1 requires persistent=True "
                                 "(tempering replaces the PCD negative chain)")
            if not 0.0 <= self.pt_beta_min < 1.0:
                raise ValueError("pt_beta_min must be in [0, 1)")
        if self.error_metric == "pseudo" and self.visible != "bernoulli":
            raise ValueError("error_metric='pseudo' (free-energy bit flips) is "
                             "only defined for bernoulli visible units")
        if self.learn_variance:
            if self.visible != "gaussian":
                raise ValueError("learn_variance=True requires "
                                 "visible='gaussian' (it learns the Gaussian "
                                 "units' per-unit variance)")
            if self.gradient == "enhanced":
                raise ValueError("gradient='enhanced' with learn_variance is "
                                 "not supported: the Cho-Raiko-Ilin "
                                 "recombination is derived for the W/b/c "
                                 "statistics of the fixed-variance energy")
        if self.lr_variance is not None and not self.learn_variance:
            raise ValueError("lr_variance set but learn_variance is False — "
                             "the knob would be a silent no-op")
        if self.init not in INIT_SCHEMES:
            raise ValueError(f"init must be one of {INIT_SCHEMES}, got {self.init!r}")
        if self.gradient not in GRADIENTS:
            raise ValueError(f"gradient must be one of {GRADIENTS}, got {self.gradient!r}")
        if self.matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"matmul_precision must be one of "
                             f"{MATMUL_PRECISIONS}, got {self.matmul_precision!r}")
        if self.sparsity_target is not None:
            if not (0.0 < self.sparsity_target < 1.0):
                raise ValueError("sparsity_target must be in (0, 1)")
            if not self.sparsity_cost:
                raise ValueError("sparsity_target set but sparsity_cost is 0 — "
                                 "the regularizer would be a silent no-op")
        elif self.sparsity_cost:
            raise ValueError("sparsity_cost set but sparsity_target is None — "
                             "the regularizer would be a silent no-op")

    @property
    def resolved_sample_visible(self) -> bool:
        if self.sample_visible is not None:
            return self.sample_visible
        if self.learn_variance:
            return True  # sampled visibles carry the variance signal
        return self.visible == "bernoulli"

    def replace(self, **kw) -> "RBMConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class DBNConfig:
    """Greedy layer-wise stack of RBMs (SURVEY.md §3.2, BASELINE.json config 3).

    ``layer_sizes`` are the hidden widths; layer 0's visible width comes from
    the data. ``visible`` applies to layer 0 only (continuous data -> gaussian
    bottom layer); upper layers are always Bernoulli because they consume
    probabilities in [0, 1].
    """

    layer_sizes: List[int] = field(default_factory=lambda: [500, 500, 200])
    visible: str = "bernoulli"
    # Per-layer overrides of the base RBM recipe; entries may be partial dicts.
    layer_overrides: List[Dict[str, Any]] = field(default_factory=list)
    # Base training recipe applied to every layer.
    k: int = 1
    persistent: bool = False
    gradient: str = "plain"
    lr: float = 0.1
    gaussian_lr: Optional[float] = 0.01  # lower lr for the gaussian bottom layer
    momentum: float = 0.0
    l2: float = 0.0
    batch_size: int = 20
    epochs: int = 10
    shuffle: bool = False
    error_metric: str = "mse"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    matmul_precision: str = "auto"
    engine: str = "auto"
    seed: int = 0

    def rbm_config(self, layer: int, n_visible: int) -> RBMConfig:
        base = dict(
            n_visible=n_visible,
            n_hidden=self.layer_sizes[layer],
            visible=self.visible if layer == 0 else "bernoulli",
            k=self.k,
            persistent=self.persistent,
            gradient=self.gradient,
            lr=self.lr,
            momentum=self.momentum,
            l2=self.l2,
            batch_size=self.batch_size,
            epochs=self.epochs,
            shuffle=self.shuffle,
            error_metric=self.error_metric,
            param_dtype=self.param_dtype,
            compute_dtype=self.compute_dtype,
            matmul_precision=self.matmul_precision,
            engine=self.engine,
            seed=self.seed + layer,
        )
        if layer == 0 and self.visible == "gaussian" and self.gaussian_lr is not None:
            base["lr"] = self.gaussian_lr
        if layer < len(self.layer_overrides):
            base.update(self.layer_overrides[layer])
        return RBMConfig(**base)


@dataclass(frozen=True)
class MDBNConfig:
    """Multimodal DBN: per-modality towers + joint top RBM
    (SURVEY.md §3.3, BASELINE.json config 4)."""

    towers: Dict[str, DBNConfig]
    joint: RBMConfig  # n_visible here is ignored; it is the sum of tower top widths
    seed: int = 0


@dataclass(frozen=True)
class TrainRuntimeConfig:
    """Runtime knobs orthogonal to the model math (SURVEY.md §5)."""

    data_parallel: bool = False
    mesh_axis: str = "dp"
    profile: bool = False
    # under the process's temporary directory (TMPDIR), as
    # ``<tmp>/mdbn_tpu_profile``
    profile_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "mdbn_tpu_profile"))
    debug_nans: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every_epochs: int = 0  # 0 = only at layer boundaries
    metrics_path: Optional[str] = None  # JSONL metrics stream


# ---------------------------------------------------------------------------
# JSON round-trip


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        d["__type__"] = type(obj).__name__
        return d
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


_TYPES = {}


def _register(cls):
    _TYPES[cls.__name__] = cls
    return cls


for _cls in (RBMConfig, DBNConfig, MDBNConfig, TrainRuntimeConfig):
    _register(_cls)


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        tname = obj.pop("__type__", None)
        decoded = {k: _from_jsonable(v) for k, v in obj.items()}
        if tname is not None:
            return _TYPES[tname](**decoded)
        return decoded
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(_to_jsonable(cfg), f, indent=2, sort_keys=True)
        f.write("\n")


def load_config(path: str) -> Any:
    with open(path) as f:
        return _from_jsonable(json.load(f))

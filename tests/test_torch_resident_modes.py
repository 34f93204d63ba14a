"""The resident kernel's estimator modes (csrc/cd_train_resident.cu, kModes) from the CPU.

Which kernel ``ops.cd_epoch_cuda.select_kernel`` gives each estimator mode
of chip_smoke.py's phase 6 (pt5, enhanced, lv, pseudo) alone and in pairs at
float32 and bfloat16 storage; the run one step past the shared-memory fit
along the chain rows, V and H going to cd_train.cu; the wide mode rows
keeping cd_train_wide_modes.cu; ``select_dp_kernel`` unchanged;
``smem_bytes`` (the mirror of the kernel's ``layout``) monotone and within an
H100's block for pt5; the trace's steps and barriers per mode; the wrapper's
refusal of CPU tensors. The kernel itself needs the card
(tests/test_torch_cuda.py); its plain version is
``ops.cd_epoch_cuda.cd_train_run_plain``, held here against the Pallas train
kernel in the TPU interpreter (``make_pallas_train_fn(..., interpret=True,
inject=True)``) for each mode at 48x40, batch 8 (a ladder of 3 rungs), on
numpy-made data, state and draws, at rtol=2e-4, atol=2e-6 as
tests/test_torch_modes.py holds it. A few seconds on one core, most of them
the interpreter's.
"""

import numpy as np
import pytest
import torch

from mdbn_tpu.config import RBMConfig as JaxRBMConfig
from mdbn_tpu_torch.config import RBMConfig
from mdbn_tpu_torch.convert import convert_config
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
from test_torch_modes import E, check_run, jax_run, run_draws, run_inputs, to_port, tt

RES, WM = "cd_train_resident", "cd_train_wide_modes"
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
STORAGE = {"float32": {}, "bfloat16": BF16}
C1 = dict(n_visible=784, n_hidden=500, k=1, lr=0.1, batch_size=20)
LV = dict(n_visible=2000, n_hidden=200, visible="gaussian", learn_variance=True, lr=0.005,
          batch_size=20)
# chip_smoke.py::mode_configs
SMOKE = {"pt5": RBMConfig(**C1, persistent=True, pt_temps=5, pt_beta_min=0.2),
         "enhanced": RBMConfig(**C1, gradient="enhanced"),
         "lv": RBMConfig(**LV),
         "pseudo": RBMConfig(**C1, error_metric="pseudo")}


@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("mode", list(SMOKE))
def test_each_mode_takes_the_resident_kernel(mode, storage):
    cfg = SMOKE[mode].replace(**STORAGE[storage])
    assert R.has_modes(cfg)
    assert R.resident_tiles(cfg).fits
    assert K.select_kernel(cfg) == RES
    assert K.kernel_run(K.select_kernel(cfg)) is R.cd_train_resident_run
    # the kernel's variant: the modes with a tempering ladder, or without one
    assert R.resident_library(cfg) == ("cd_train_resident_ladder" if mode == "pt5"
                                       else "cd_train_resident_modes")
    assert R.resident_library(RBMConfig(**C1)) == "cd_train_resident"


# pairs of modes: where the tiles fit (PT + lv at 784x200, enhanced + pseudo at
# c1) the resident kernel, else cd_train.cu on purpose (PT + lv at the smoke's
# 2000x200: a ladder of 60 rows of 2000 and the product phase's 100 partial
# rows a strip pass 227 KB at either storage)
PAIRS = {
    "pt3-lv@784x200": (RBMConfig(**dict(LV, n_visible=784), persistent=True, pt_temps=3,
                                 pt_beta_min=0.4), RES),
    "pt3-lv@2000x200": (RBMConfig(**LV, persistent=True, pt_temps=3, pt_beta_min=0.4),
                        "cd_train"),
    "enhanced-pseudo@c1": (RBMConfig(**C1, gradient="enhanced", error_metric="pseudo"), RES),
}


@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("pair", list(PAIRS))
def test_pairs_of_modes_by_fit(pair, storage):
    cfg, kernel = PAIRS[pair]
    cfg = cfg.replace(**STORAGE[storage])
    tiles = R.resident_tiles(cfg)
    assert tiles.fits == (kernel == RES)
    assert K.select_kernel(cfg) == kernel
    if not tiles.fits:
        assert tiles.smem_bytes > R.H100_SMEM_PER_BLOCK


@pytest.mark.parametrize("grow", ["pt_temps", "n_visible", "n_hidden"])
def test_one_step_past_the_fit_takes_cd_train(grow):
    """Grow pt5 along the chain rows (rungs), V or H until the tiles no
    longer fit an H100's block: the last size that fits takes the resident
    kernel, the next cd_train.cu (V stays below the wide modes' kernel)."""
    cfg = SMOKE["pt5"]
    size = getattr(cfg, grow)
    while R.resident_tiles(cfg.replace(**{grow: size + 1})).fits:
        size += 1
    fits, past = cfg.replace(**{grow: size}), cfg.replace(**{grow: size + 1})
    assert K.select_kernel(fits) == RES
    assert R.resident_tiles(past).smem_bytes > R.H100_SMEM_PER_BLOCK
    assert past.n_visible < K.WIDE_MODES_MIN_VISIBLE
    assert K.select_kernel(past) == "cd_train"
    if grow == "pt_temps":  # a ladder of 6 rungs of 20 rows is the tallest that fits
        assert size == 6


# the wide slice's mode rows (scripts/bench_wide.py): from 5000 columns the
# strip-split kernel, which the resident kernel's tiles never reach there
WIDE = dict(visible="gaussian", lr=0.001, batch_size=20, k=1, n_hidden=400)
WIDE_MODES = {"pt3_bf16": dict(persistent=True, pt_temps=3, pt_beta_min=0.3, **BF16),
              "enhanced": dict(gradient="enhanced"), "lv": dict(learn_variance=True)}


@pytest.mark.parametrize("mode", list(WIDE_MODES))
def test_wide_mode_rows_keep_the_strip_split_kernel(mode):
    for v in (K.WIDE_MODES_MIN_VISIBLE, 20000):
        cfg = RBMConfig(n_visible=v, **WIDE, **WIDE_MODES[mode])
        assert not R.resident_tiles(cfg).fits
        assert K.select_kernel(cfg) == WM


@pytest.mark.parametrize("mode", list(SMOKE))
def test_select_dp_kernel_unchanged(mode):
    """Under a mesh the smoke's modes take the resident kernel's step variant
    too: a rank's tiles fit wherever the whole batch's do."""
    for storage in STORAGE.values():
        assert K.select_dp_kernel(SMOKE[mode].replace(**storage)) == "cd_grads_resident"


@pytest.mark.parametrize("storage", list(STORAGE))
def test_smem_bytes_monotone_and_within_the_block(storage):
    """pt5's layout fits an H100's 232,448 bytes at one strip a block and
    grows with the strips a block holds, the rungs and the batch."""
    cfg = SMOKE["pt5"].replace(**STORAGE[storage])
    need = [R.smem_bytes(cfg, ns) for ns in (1, 2, 3)]
    assert need[0] <= R.H100_SMEM_PER_BLOCK == 232448
    assert need == sorted(set(need))
    rungs = [R.smem_bytes(cfg.replace(pt_temps=m), 1) for m in (2, 3, 4, 5, 6)]
    assert rungs == sorted(set(rungs))
    batches = [R.smem_bytes(cfg.replace(batch_size=b), 1) for b in (4, 8, 12, 16, 20)]
    assert batches == sorted(set(batches))
    # every mode's buffers on top of the plain layout
    plain = R.smem_bytes(RBMConfig(**C1, **STORAGE[storage]), 1)
    assert all(R.smem_bytes(SMOKE[m].replace(**STORAGE[storage]), 1) > plain
               for m in ("pt5", "enhanced", "pseudo"))


def _barriers(cfg):
    steps = R.resident_trace_phases(cfg)
    return (sum(s.endswith(":tile_barrier") for s in steps),
            sum(s.endswith(":cluster_barrier") for s in steps))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", ["pt5", "enhanced", "lv", "pseudo", "pt3-lv"])
def test_trace_steps_and_barriers(mode, k):
    """Against the plain estimator's k + 1 tile and k cluster barriers:
    tempering k + 1 more of each (the ladder's visible and hidden sums
    exchanged over the ranks and the tile's blocks, its product phase, the
    barrier of every block before the swaps), learned variance one more
    cluster barrier (its product phase), the enhanced gradient and the
    pseudo monitor none. The kernel stamps one clock a step and the end."""
    cfg = (PAIRS["pt3-lv@784x200"][0] if mode == "pt3-lv" else SMOKE[mode]).replace(k=k)
    plain = RBMConfig(**C1).replace(k=k)
    tile, cluster = _barriers(cfg)
    pt, lv = cfg.pt_temps > 1, cfg.learn_variance
    assert _barriers(plain) == (k + 1, k)
    assert (tile, cluster) == (k + 1 + (k + 1 if pt else 0),
                               k + (k + 1 if pt else 0) + (1 if lv and not pt else 0))
    steps = R.resident_trace_phases(cfg)
    assert steps[:3] == [f"hidden_from_data:{s}" for s in ("products", "tile_barrier", "sums")]
    assert steps[-1] == "update_and_monitor" and len(set(steps)) == len(steps)
    assert ("products:cluster_barrier" in steps) == (pt or lv)
    assert ("swap:tile_barrier" in steps) == pt
    assert R.resident_trace_len(cfg) == len(steps) + 1


class _OnTheCard:
    """A stand-in for a CUDA tensor: the wrapper reads its device first."""
    device = torch.device("cuda")


@pytest.mark.parametrize("mode", list(SMOKE))
def test_wrapper_refuses_cpu_tensors(mode):
    cfg = SMOKE[mode].replace(n_visible=24, n_hidden=12, batch_size=4)
    st = init_train_state(cfg, device="cpu")
    data = torch.zeros((8, 24))
    before = R.cd_train_resident_launches
    with pytest.raises(ValueError, match="cd_train_run_plain"):
        R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data,
                                K.batch_order(cfg, 2, 1, None), 0, None,
                                torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cd_train_run_plain"):  # k > 255 alike
        R.cd_train_resident_run(cfg.replace(k=300), st.params, st.velocity, st.chain_h, data,
                                K.batch_order(cfg, 2, 1, None), 0, None,
                                torch.Generator().manual_seed(0))
    assert R.cd_train_resident_launches == before


# the plain version each mode's kernel is held to on the card, against the
# Pallas train kernel in the TPU interpreter; ladders warm enough that swaps
# are both accepted and rejected
SMALL = dict(n_visible=48, n_hidden=40, batch_size=8)
RUNS = {
    "pt3": JaxRBMConfig(**SMALL, lr=0.1, momentum=0.5, persistent=True, pt_temps=3,
                        pt_beta_min=0.3),
    "enhanced": JaxRBMConfig(**SMALL, lr=0.1, gradient="enhanced", momentum=0.5,
                             sparsity_target=0.1, sparsity_cost=0.5),
    "learn-variance": JaxRBMConfig(**SMALL, visible="gaussian", lr=0.005,
                                   learn_variance=True, momentum=0.5),
    "pseudo": JaxRBMConfig(**SMALL, lr=0.1, error_metric="pseudo"),
    "pt3-lv": JaxRBMConfig(**SMALL, visible="gaussian", lr=0.005, persistent=True,
                           pt_temps=3, pt_beta_min=0.3, learn_variance=True),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_plain_run_matches_pallas_kernel(name):
    cfg, nb = RUNS[name], 4
    tcfg = convert_config(cfg)
    assert K.select_kernel(tcfg) == RES  # the run the resident kernel takes on the card
    data, st = run_inputs(cfg, nb)
    u = run_draws(cfg, nb)
    jst, jerrs = jax_run(cfg, data, st, u)
    tst = to_port(st)
    got = K.cd_train_run_plain(tcfg, tst.params, tst.velocity, tst.chain_h,
                               torch.as_tensor(data), K.batch_order(tcfg, nb, E, None), 0,
                               tt(u))
    check_run(cfg, jst, jerrs, *got)
    assert np.isfinite(got[3].numpy()).all()

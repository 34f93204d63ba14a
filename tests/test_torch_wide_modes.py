"""The strip-split kernel of the estimator modes (csrc/cd_train_wide_modes.cu)
from the CPU: its admission rule, its wrapper's refusals, its trace layout,
and the plain run it is held to on the card against the JAX package.

The kernel itself needs the card (tests/test_torch_cuda.py). Its plain
version is ``ops.cd_epoch_cuda.cd_train_run_plain``; here that run, at small
widths under each of the three modes the kernel takes and under tempering
with learned variance, is held against the Pallas train kernel in the TPU
interpreter in its ``hbm_state`` mode (the mode the TPU trains such wide
layers through), reached as tests/test_torch_wide.py reaches it, on the same
numpy-made data, state and injected draws. Tolerance rtol=2e-5, atol=2e-6:
float32 on both sides, summed in other orders, over 2 epochs of 4 updates.
These configs are the Gaussian, mean-field or CD-1 families of the wide
slice's rows (w20k_pt3_bf16, w20k_enh, w20k_lv), beside the Bernoulli and
PCD cases of test_torch_wide.py::test_wide_state_plain_matches_hbm_state_kernel.
"""

import numpy as np
import pytest
import torch

from mdbn_tpu.config import RBMConfig
from mdbn_tpu_torch import _build
from mdbn_tpu_torch.convert import convert_config
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC
from test_torch_wide import f32, jax_run, make_inputs, port_run

TOL = dict(rtol=2e-5, atol=2e-6)
WM = "cd_train_wide_modes"

# the wide slice's estimator-mode rows (scripts/bench_wide.py), by mode
WIDE = dict(visible="gaussian", lr=0.001, batch_size=20, k=1, seed=0, n_hidden=400)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
ROW_MODES = {
    "tempering": dict(persistent=True, pt_temps=3, pt_beta_min=0.3),
    "enhanced": dict(gradient="enhanced"),
    "learned-variance": dict(learn_variance=True),
    "pt3-lv": dict(persistent=True, pt_temps=3, pt_beta_min=0.3, learn_variance=True),
}
STORAGE = {"float32": {}, "bfloat16": BF16}


def row(mode, storage, n_visible):
    return convert_config(RBMConfig(n_visible=n_visible, **WIDE, **ROW_MODES[mode],
                                    **STORAGE[storage]))


@pytest.mark.parametrize("storage", list(STORAGE))
@pytest.mark.parametrize("mode", list(ROW_MODES))
def test_admission_of_each_mode_by_width(mode, storage):
    """Every mode at either storage dtype takes the strip-split kernel from
    WIDE_MODES_MIN_VISIBLE columns on, and cd_train.cu one column below."""
    at = K.WIDE_MODES_MIN_VISIBLE
    assert K.select_kernel(row(mode, storage, at - 1)) == "cd_train"
    assert K.select_kernel(row(mode, storage, at)) == WM
    assert K.select_kernel(row(mode, storage, 20000)) == WM
    assert K.wide_modes_unsupported(row(mode, storage, 20000)) is None
    assert K.kernel_run(WM) is WMC.cd_train_wide_modes_run


OUTSIDE = {
    # the pseudo-likelihood monitor stays on cd_train.cu, whatever the modes
    "pseudo": (dict(visible="bernoulli", error_metric="pseudo", gradient="enhanced",
                    persistent=True, pt_temps=3), "pseudo", "cd_train"),
    # the plain estimator belongs to the W-blocked kernel (in its scope) ...
    "plain-meanfield": (dict(), "plain estimator", "cd_train_wide"),
    # ... or to cd_train.cu (sampled visibles are outside the W-blocked scope)
    "plain-sampled": (dict(sample_visible=True), "plain estimator", "cd_train"),
    "batch-over-256": (dict(gradient="enhanced", batch_size=320), "batch", "cd_train"),
    # any k is inside: k 256 takes the modes kernel as k 1 does
    "k-256": (dict(gradient="enhanced", k=256), None, WM),
}


@pytest.mark.parametrize("name", list(OUTSIDE))
def test_outside_the_scope(name):
    fields, reason, kernel = OUTSIDE[name]
    cfg = convert_config(RBMConfig(n_visible=20000, **{**WIDE, **fields}))
    if reason is None:
        assert K.wide_modes_unsupported(cfg) is None
    else:
        assert reason in K.wide_modes_unsupported(cfg)
    assert K.select_kernel(cfg) == kernel


@pytest.mark.parametrize("mode", list(ROW_MODES))
def test_select_dp_kernel_unchanged(mode):
    """Under a mesh the mode rows keep cd_grads.cu (outside the W-blocked
    DP route's scope), as before the strip-split kernel."""
    for storage in STORAGE:
        cfg = row(mode, storage, 20000)
        assert K.select_dp_kernel(cfg) == "cd_grads"
    plain = convert_config(RBMConfig(n_visible=20000, **WIDE))
    assert K.select_dp_kernel(plain) == "cd_grads_wide"


class _OnTheCard:
    """A stand-in for a CUDA tensor: the wrapper reads its device first."""
    device = torch.device("cuda")


def test_wrapper_refuses_before_any_build(monkeypatch):
    """CPU tensors and a config outside the scope raise ValueError before
    the library is built or loaded; no launch is counted."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(_build, "load_library", no_build)
    cfg = row("enhanced", "float32", 64).replace(batch_size=4)
    st = init_train_state(cfg, device="cpu")
    data = torch.zeros((8, 64))
    order = K.batch_order(cfg, 2, 1, None)
    before = WMC.cd_train_wide_modes_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        WMC.cd_train_wide_modes_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                    None, torch.Generator())
    for outside, what in ((cfg.replace(gradient="plain"), "plain estimator"),
                          (cfg.replace(visible="bernoulli", error_metric="pseudo"), "pseudo")):
        with pytest.raises(ValueError, match=what):
            WMC.cd_train_wide_modes_run(outside, st.params, st.velocity, st.chain_h,
                                        _OnTheCard(), order, 0, None, torch.Generator())
    assert WMC.cd_train_wide_modes_launches == before


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("mode", list(ROW_MODES))
def test_trace_len_and_barriers(mode, k):
    """One stamp per phase and one for the end; every phase ends at a grid
    barrier: 3 + 3k, +1 under tempering or learned variance, +2 under
    tempering, none for the enhanced gradient."""
    cfg = row(mode, "float32", 20000).replace(k=k)
    phases = WMC.wide_modes_trace_phases(cfg)
    assert WMC.wide_modes_trace_len(cfg) == len(phases) + 1
    pt, lv = cfg.pt_temps > 1, cfg.learn_variance
    assert len(phases) == 3 + 3 * k + (1 if pt or lv else 0) + (2 if pt else 0)
    assert phases[0] == "xw_from_data" and phases[-1] == "update_and_monitor"
    assert ("products" in phases) == (pt or lv)
    assert ("swap_even" in phases) == ("swap_odd" in phases) == pt
    assert sum(p.startswith("xw_") for p in phases) == k + 1


# the plain run against the interpret-mode hbm_state train kernel
SMALL = dict(n_visible=96, n_hidden=32, batch_size=6, k=1, epochs=2, visible="gaussian",
             seed=0)
PLAIN_CASES = {
    "tempering-gaussian-meanfield": RBMConfig(**SMALL, persistent=True, pt_temps=3,
                                              pt_beta_min=0.3, lr=0.01, l2=1e-4),
    "enhanced-gaussian-cd": RBMConfig(**SMALL, gradient="enhanced", lr=0.01, momentum=0.5,
                                      sparsity_target=0.1, sparsity_cost=0.05),
    "learned-variance-cd": RBMConfig(**SMALL, learn_variance=True, lr=0.005,
                                     grad_clip=0.5),
    "pt3-lv": RBMConfig(**SMALL, persistent=True, pt_temps=3, pt_beta_min=0.3,
                        learn_variance=True, lr=0.005, momentum=0.5),
}


@pytest.mark.parametrize("name", list(PLAIN_CASES))
def test_plain_run_matches_hbm_state_kernel(name):
    cfg = PLAIN_CASES[name]
    tcfg = convert_config(cfg)
    assert K.wide_modes_unsupported(tcfg) is None
    data, st, u = make_inputs(cfg, nb=4)
    jst, jerrs = jax_run(cfg, data, st, u, hbm=True)
    params, velocity, chain, errs = port_run(cfg, data, st, u)
    names = ("W", "b", "c", "z") if cfg.learn_variance else ("W", "b", "c")
    for n in names:
        np.testing.assert_allclose(getattr(params, n).numpy(), f32(getattr(jst.params, n)),
                                   err_msg=n, **TOL)
        np.testing.assert_allclose(getattr(velocity, n).numpy(),
                                   f32(getattr(jst.velocity, n)), err_msg="v" + n, **TOL)
    np.testing.assert_array_equal(chain.numpy(), f32(jst.chain_h))
    np.testing.assert_allclose(errs.numpy(), f32(jerrs), **TOL)

"""The wide-omics slice of the port against the JAX package: bf16 storage,
the TPU kernel's wide-state modes, the W-blocked kernel, the admission rule.

Each run test feeds the same numpy-made data, state and draws to a plain
version of the port (what its CUDA wrappers compute, and what they run on
CPU tensors) and to the Pallas kernel in the TPU interpreter with injected
draws, reached through ``_cached_train_fn(cfg, E, True, True, hbm_state)``
as tests/test_pallas_widemode.py reaches it.

Tolerances. float32 storage: rtol=2e-4, atol=2e-6 (tests/test_pallas_pt.py:
float32 on both sides, summed in other orders). bf16 storage: every stored
value is a float32 result rounded once into bf16, so the two sides agree
exactly except where their float32 results straddle a rounding boundary;
there they differ by one bf16 ulp. The tests allow one ulp, and count the
elements that differ: ``MAX_OFF`` of a tensor's elements at most (on the
CPU every case so far counts none: the two sides are equal bit for bit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mdbn_tpu.ops.cd_epoch_pallas as cep
from mdbn_tpu.config import RBMConfig
from mdbn_tpu.core.rbm_math import RBMParams
from mdbn_tpu.core.state import TrainState
from mdbn_tpu.ops.transform import transform as j_transform
from mdbn_tpu_torch.checkpoint import restore_state, save_state
from mdbn_tpu_torch.convert import (convert_config, rbm_from_numpy, state_from_numpy,
                                    state_to_numpy)
from mdbn_tpu_torch.core.rbm_math import torch_dtype
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops.cd_epoch_resident_cuda import resident_tiles
from mdbn_tpu_torch.ops import cd_epoch_wide_cuda as KW
from mdbn_tpu_torch.train.trainer import resolve_engine, train_rbm

RUN_TOL = dict(rtol=2e-4, atol=2e-6)
MAX_OFF = 0.02  # share of a bf16 tensor's elements that may differ, by one ulp
E = 2


# ---- inputs made with numpy, handed to both sides ----------------------------


def make_inputs(cfg, nb, seed=3):
    """(data, JAX TrainState, draws): W ~ 0.05 N(0, 1), non-zero biases, z
    and chain, zero velocity, all at the config's storage dtype."""
    rng = np.random.default_rng(seed)
    V, H, B, M = cfg.n_visible, cfg.n_hidden, cfg.batch_size, cfg.pt_temps
    n = nb * B
    if cfg.visible == "bernoulli":
        data = (rng.random((n, V)) < 0.3).astype(np.float32)
    else:
        data = rng.standard_normal((n, V)).astype(np.float32)
    sdt = jnp.dtype(cfg.param_dtype)

    def arr(x):
        return jnp.asarray(np.asarray(x, np.float32)).astype(sdt)

    lv = cfg.learn_variance
    params = RBMParams(W=arr(rng.standard_normal((V, H)) * 0.05),
                       b=arr(rng.standard_normal(V) * 0.1),
                       c=arr(rng.standard_normal(H) * 0.1),
                       z=arr(rng.standard_normal(V) * 0.2) if lv else None)
    zeros = RBMParams(W=arr(np.zeros((V, H))), b=arr(np.zeros(V)), c=arr(np.zeros(H)),
                      z=arr(np.zeros(V)) if lv else None)
    st = TrainState(params=params, velocity=zeros, chain_h=arr(rng.random((B * M, H)) < 0.5),
                    key=jnp.asarray(np.zeros(2, np.uint32)), epoch=jnp.asarray(np.int32(0)))
    CR = B * M
    u = {"h0": rng.random((E, nb, B, H), np.float32),
         "h": rng.random((E, nb, cfg.k, CR, H), np.float32)}
    if cfg.resolved_sample_visible:
        if cfg.visible == "bernoulli":
            u["v"] = rng.random((E, nb, cfg.k, CR, V), np.float32)
        else:
            u["noise"] = rng.standard_normal((E, nb, cfg.k, CR, V)).astype(np.float32)
    if M > 1:
        u["swap"] = rng.random((E, nb, 2, (M - 1) * B), np.float32)
    return data, st, u


def f32(x):
    """A JAX array of either storage dtype as float32 numpy."""
    return np.asarray(x, np.float32)


def to_port(st, cfg):
    tree = {"params": {k: f32(v) for k, v in st.params._asdict().items() if v is not None},
            "velocity": {k: f32(v) for k, v in st.velocity._asdict().items() if v is not None},
            "chain_h": f32(st.chain_h), "epoch": 0}
    return state_from_numpy(tree, dtype=torch_dtype(cfg.param_dtype), device="cpu")


def jax_run(cfg, data, st, u, hbm, w_blocked=False):
    """The Pallas kernel in the interpreter. ``w_blocked`` routes the call
    through the W-blocked kernel by replacing the JAX package's probe for
    the duration of the build, as its own tests do."""
    orig = cep.needs_w_chunking
    if w_blocked:
        cep.needs_w_chunking = lambda c, ndev=1, dp_reduce="factor": True
    try:
        fn = cep._cached_train_fn(cfg, E, True, True, hbm)
        return fn(st, jnp.asarray(data), {k: jnp.asarray(v) for k, v in u.items()})
    finally:
        cep.needs_w_chunking = orig


def port_run(cfg, data, st, u, wide=False):
    tcfg, tst = convert_config(cfg), to_port(st, cfg)
    run = KW.cd_train_wide_run_plain if wide else K.cd_train_run_plain
    nb = data.shape[0] // cfg.batch_size
    return run(tcfg, tst.params, tst.velocity, tst.chain_h,
               torch.as_tensor(data).to(torch_dtype(cfg.param_dtype)),
               K.batch_order(tcfg, nb, E, None), 0, {k: torch.as_tensor(v) for k, v in u.items()})


def check_f32(cfg, jst, jerrs, got):
    params, velocity, chain, errs = got
    for name in (("W", "b", "c", "z") if cfg.learn_variance else ("W", "b", "c")):
        np.testing.assert_allclose(getattr(params, name).numpy(), f32(getattr(jst.params, name)),
                                   err_msg=name, **RUN_TOL)
        np.testing.assert_allclose(getattr(velocity, name).numpy(),
                                   f32(getattr(jst.velocity, name)), err_msg="v" + name,
                                   **RUN_TOL)
    np.testing.assert_array_equal(chain.numpy(), f32(jst.chain_h))
    np.testing.assert_allclose(errs.numpy(), f32(jerrs), **RUN_TOL)


def bf16_off(got: torch.Tensor, want) -> int:
    """Number of elements where two bf16 tensors differ; fails if any
    differs by more than one bf16 ulp of the larger value."""
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = got.float().numpy(), f32(want)
    diff = np.abs(g - w)
    big = np.maximum(np.abs(g), np.abs(w))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)  # 8 bits of mantissa
    assert (diff <= ulp).all(), f"{int((diff > ulp).sum())} elements differ by over one ulp"
    return int((diff > 0).sum())


def check_bf16(jst, got, max_off=MAX_OFF):
    """State tensors equal up to one ulp on a counted few; returns the counts."""
    counts = {}
    for part, jpart in ((got[0], jst.params), (got[1], jst.velocity)):
        for name in ("W", "b", "c"):
            t = getattr(part, name)
            key = ("v" if part is got[1] else "") + name
            counts[key] = bf16_off(t, getattr(jpart, name))
            assert counts[key] <= max(1, int(max_off * t.numel())), counts
    return counts


# ---- bf16 storage in the train kernel ----------------------------------------


@pytest.mark.parametrize("momentum,hbm", [(0.0, False), (0.0, True), (0.5, False), (0.5, True)])
def test_bf16_storage_plain_matches_pallas_kernel(momentum, hbm):
    """tests/test_pallas_widemode.py:176-195's case: bf16 parameters,
    velocities, chain and data; const-block and HBM-state kernel."""
    cfg = RBMConfig(n_visible=48, n_hidden=16, batch_size=8, k=1, epochs=E,
                    momentum=momentum, persistent=momentum > 0, l2=1e-4, lr=0.05, seed=0,
                    param_dtype="bfloat16")
    data, st, u = make_inputs(cfg, nb=6)
    jst, jerrs = jax_run(cfg, data, st, u, hbm)
    got = port_run(cfg, data, st, u)
    assert got[0].W.dtype == torch.bfloat16 and got[2].dtype == torch.bfloat16
    counts = check_bf16(jst, got)
    print("bf16 elements that differ by one ulp:", counts)
    np.testing.assert_array_equal(got[2].float().numpy(), f32(jst.chain_h))
    np.testing.assert_allclose(got[3].numpy(), f32(jerrs), rtol=2e-4, atol=1e-6)


# ---- the wide-state modes: the same function as the const-block kernel ------

WIDE_STATE = {
    # tests/test_pallas_widemode.py:414, :559, :497
    "learn-variance": RBMConfig(n_visible=300, n_hidden=48, batch_size=8, k=1, epochs=E,
                                visible="gaussian", learn_variance=True, sample_visible=True,
                                momentum=0.5, persistent=True, l2=1e-4, lr=0.005,
                                grad_clip=0.5, seed=0),
    "enhanced": RBMConfig(n_visible=80, n_hidden=48, batch_size=8, k=1, epochs=E,
                          gradient="enhanced", momentum=0.5, persistent=True, l2=1e-4,
                          lr=0.05, grad_clip=0.5, seed=0, sparsity_target=0.1,
                          sparsity_cost=0.05),
    "tempering": RBMConfig(n_visible=80, n_hidden=48, batch_size=8, k=1, epochs=E,
                           momentum=0.5, persistent=True, pt_temps=3, pt_beta_min=0.3,
                           l2=1e-4, lr=0.05, grad_clip=0.5, seed=0),
}


@pytest.mark.parametrize("name", list(WIDE_STATE))
def test_wide_state_plain_matches_hbm_state_kernel(name):
    cfg = WIDE_STATE[name]
    data, st, u = make_inputs(cfg, nb=4)
    jst, jerrs = jax_run(cfg, data, st, u, hbm=True)
    check_f32(cfg, jst, jerrs, port_run(cfg, data, st, u))


# ---- the W-blocked kernel ------------------------------------------------------

WB = dict(n_visible=64, n_hidden=100, batch_size=8, k=1, epochs=E, sample_visible=False,
          l2=1e-4, lr=0.05, grad_clip=0.5, seed=0)
W_BLOCKED = {
    "gaussian-mse": RBMConfig(**WB, visible="gaussian"),
    "gaussian-mse-momentum": RBMConfig(**WB, visible="gaussian", momentum=0.5),
    "bernoulli-xent": RBMConfig(**WB, error_metric="xent"),
    "bernoulli-pcd": RBMConfig(**WB, persistent=True),
    "batch-40": RBMConfig(**{**WB, "batch_size": 40}, momentum=0.5, persistent=True),
}


@pytest.mark.parametrize("name", list(W_BLOCKED))
def test_wide_plain_matches_w_blocked_kernel(name):
    cfg = W_BLOCKED[name]
    data, st, u = make_inputs(cfg, nb=2 if cfg.batch_size > 8 else 4)
    jst, jerrs = jax_run(cfg, data, st, u, hbm=True, w_blocked=True)
    check_f32(cfg, jst, jerrs, port_run(cfg, data, st, u, wide=True))


def test_wide_plain_matches_w_blocked_kernel_bf16():
    """bf16 storage and compute: the negative-phase visibles round through
    bf16 on both sides. rtol=1e-2, atol=1e-3: products of bf16 operands
    (8 bits of mantissa); the elements that differ are counted."""
    cfg = RBMConfig(**WB, visible="gaussian", momentum=0.5, param_dtype="bfloat16",
                    compute_dtype="bfloat16")
    data, st, u = make_inputs(cfg, nb=4)
    jst, jerrs = jax_run(cfg, data, st, u, hbm=True, w_blocked=True)
    got = port_run(cfg, data, st, u, wide=True)
    counts = {}
    for part, jpart, pre in ((got[0], jst.params, ""), (got[1], jst.velocity, "v")):
        for name in ("W", "b", "c"):
            g, w = getattr(part, name).float().numpy(), f32(getattr(jpart, name))
            np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-3, err_msg=pre + name)
            counts[pre + name] = f"{int((g != w).sum())}/{g.size}"
    print("bf16 elements that differ:", counts)
    np.testing.assert_allclose(got[3].numpy(), f32(jerrs), rtol=1e-2, atol=1e-3)
    # the factor rounding is what the plain train run lacks: it gives another W
    other = port_run(cfg, data, st, u, wide=False)
    assert not torch.equal(other[0].W, got[0].W)


def test_wide_plain_is_the_train_plain_at_f32_and_keeps_its_scope():
    cfg = W_BLOCKED["bernoulli-pcd"]
    data, st, u = make_inputs(cfg, nb=4)
    a, b = port_run(cfg, data, st, u, wide=True), port_run(cfg, data, st, u)
    for x, y in ((a[0].W, b[0].W), (a[1].b, b[1].b), (a[2], b[2]), (a[3], b[3])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    tcfg = convert_config(cfg)
    for outside in (tcfg.replace(sample_visible=True), tcfg.replace(error_metric="pseudo"),
                    tcfg.replace(gradient="enhanced"), tcfg.replace(pt_temps=3),
                    tcfg.replace(visible="gaussian", learn_variance=True)):
        assert K.wide_unsupported(outside) is not None
        with pytest.raises(ValueError, match="W-blocked"):
            port_run(outside, data, st, u, wide=True)
    # the wrapper on CPU tensors: the plain version asked for, no launch
    tst = to_port(st, cfg)
    args = (tcfg, tst.params, tst.velocity, tst.chain_h, torch.as_tensor(data),
            K.batch_order(tcfg, 4, E, None), 0, {k: torch.as_tensor(v) for k, v in u.items()})
    before = K.cd_train_launches, KW.cd_train_wide_launches
    c = K.cd_train_run(*args, wide=True)
    torch.testing.assert_close(c[0].W, a[0].W, rtol=0, atol=0)
    assert (K.cd_train_launches, KW.cd_train_wide_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        KW.cd_train_wide_run(*args)
    assert KW.wide_trace_len(tcfg) == 3 * tcfg.k + 4


# ---- admission ------------------------------------------------------------------

WIDE = dict(visible="gaussian", lr=0.001, batch_size=20, k=1, seed=0)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
SLICE = {  # scripts/bench_wide.py's shapes -> the kernel each takes
    "w20k": (RBMConfig(n_visible=20000, n_hidden=400, **WIDE), "cd_train_wide"),
    "w20k_h512": (RBMConfig(n_visible=20000, n_hidden=512, **WIDE), "cd_train_wide"),
    "w20k_lv": (RBMConfig(n_visible=20000, n_hidden=400, learn_variance=True, **WIDE),
                "cd_train_wide_modes"),
    "w20k_mom": (RBMConfig(n_visible=20000, n_hidden=400, momentum=0.5, **WIDE),
                 "cd_train_wide"),
    "w20k_mom_bf16": (RBMConfig(n_visible=20000, n_hidden=400, momentum=0.5, **WIDE, **BF16),
                      "cd_train_wide"),
    "w20k_enh": (RBMConfig(n_visible=20000, n_hidden=400, gradient="enhanced", **WIDE),
                 "cd_train_wide_modes"),
    "w20k_pt3_bf16": (RBMConfig(n_visible=20000, n_hidden=400, persistent=True, pt_temps=3,
                                pt_beta_min=0.3, **WIDE, **BF16), "cd_train_wide_modes"),
    "w28k": (RBMConfig(n_visible=28000, n_hidden=400, **WIDE), "cd_train_wide"),
    "w40k_bf16": (RBMConfig(n_visible=40000, n_hidden=1000, **WIDE, **BF16), "cd_train_wide"),
    "w20k_b64": (RBMConfig(n_visible=20000, n_hidden=400, **{**WIDE, "batch_size": 64}),
                 "cd_train_wide"),
}


@pytest.mark.parametrize("name", list(SLICE))
def test_admission(name):
    cfg, kernel = SLICE[name]
    tcfg = convert_config(cfg)
    assert K.select_kernel(tcfg) == kernel
    assert K.select_kernel(tcfg.replace(k=300)) == kernel
    cuda = torch.device("cuda")
    assert resolve_engine(tcfg, cuda) == "cuda"
    assert resolve_engine(tcfg.replace(engine="pallas"), cuda) == "cuda"
    # the W-blocked kernel takes every run in its scope from WIDE_MIN_VISIBLE
    # columns on whose tiles the resident kernel (csrc/cd_train_resident.cu,
    # ahead wherever they fit) does not hold, and none outside its scope
    in_scope = K.wide_unsupported(tcfg) is None
    assert in_scope == (kernel == "cd_train_wide")
    assert in_scope == (name in ("w20k", "w20k_h512", "w20k_mom", "w20k_mom_bf16", "w28k",
                                 "w40k_bf16", "w20k_b64"))
    # the estimator-mode rows take the strip-split kernel of the modes
    # (csrc/cd_train_wide_modes.cu) from WIDE_MODES_MIN_VISIBLE columns on
    modes = K.wide_modes_unsupported(tcfg) is None
    assert modes == (kernel == "cd_train_wide_modes")

    def expected(c):
        if resident_tiles(c).fits:
            return "cd_train_resident"
        if in_scope and c.n_visible >= K.WIDE_MIN_VISIBLE:
            return "cd_train_wide"
        if modes and c.n_visible >= K.WIDE_MODES_MIN_VISIBLE:
            return "cd_train_wide_modes"
        return "cd_train"

    for v in (K.WIDE_MIN_VISIBLE - 1, K.WIDE_MIN_VISIBLE, 2000, 3000, 4096, 5000):
        c = tcfg.replace(n_visible=v)
        assert K.select_kernel(c) == expected(c), v
    resident_at = lambda v: K.select_kernel(tcfg.replace(n_visible=v)) == "cd_train_resident"
    # the resident kernel takes the mode rows too where they fit: 64 rows of
    # 2000, and a ladder of 3 x 20 chain rows of 2000, do not
    assert resident_at(2000) == (name not in ("w20k_b64", "w20k_pt3_bf16"))
    # at bf16 storage the resident kernel holds 3000 and 4096 columns of 400
    assert resident_at(4096) == (name == "w20k_mom_bf16")
    if in_scope and name != "w20k_b64" and tcfg.n_hidden == 400:
        assert resident_at(3000) == (tcfg.param_dtype == "bfloat16")


# ---- the W-blocked kernel's launch plan -------------------------------------------

# past the update's staging fit (h0p and hmean [2, 128, 1000] f32 are 1 MB), and
# a row of h wider than the h W^T phase's shared memory (50000 floats)
PAST_FIT = {
    "b128_h1000": RBMConfig(n_visible=4097, n_hidden=1000, **{**WIDE, "batch_size": 128}),
    "h50000_b2": RBMConfig(n_visible=64, n_hidden=50000, **{**WIDE, "batch_size": 2}),
}
H100_SMEM = 232448  # an H100's opt-in shared memory of a block


@pytest.mark.parametrize("name", [n for n, (_, k) in SLICE.items() if k == "cd_train_wide"]
                         + list(PAST_FIT))
def test_wide_launch_plan(name):
    """One block an SM with up to the card's opt-in shared memory: every row
    of the slice that the W-blocked kernel takes stages h0p and hmean once
    per update phase (64 KB at w20k, 160 KB at w40k_bf16, 205 KB at
    w20k_b64) and its whole batch of h once per h W^T pass; past the fit the
    plan reads them from the L2 or stages windows instead, and refuses
    nothing."""
    tcfg = convert_config(SLICE[name][0] if name in SLICE else PAST_FIT[name])
    assert K.wide_unsupported(tcfg) is None
    B, H = tcfg.batch_size, tcfg.n_hidden
    plan = KW.wide_launch_plan(tcfg)
    assert plan.ok and plan.smem_bytes <= H100_SMEM and plan.smem_bytes % 16 == 0
    h_bytes = 2 * B * H * 4
    assert plan.h_staged == (name in SLICE)
    if plan.h_staged:
        assert h_bytes == {"w20k": 64000, "w20k_h512": 81920, "w20k_mom": 64000,
                           "w20k_mom_bf16": 64000, "w28k": 64000, "w40k_bf16": 160000,
                           "w20k_b64": 204800}[name]
        assert plan.strip_rows == B and plan.smem_bytes >= h_bytes + 2 * 16 * B * 4
        # h W^T: the whole batch in one pass of whole rows
        assert (plan.vis_rows, plan.vis_window) == (B, H)
        assert plan.hstride % 8 == 0 and plan.hstride >= H
    else:
        assert h_bytes + 2 * 16 * B * 4 > H100_SMEM and plan.strip_rows == B
    # the update streams the next strip's W (and under momentum its velocity)
    # into shared memory beside them where both fit: not beside w20k_b64's h,
    # nor at all when one strip's 16 rows of 50000 columns (3.2 MB) pass the card's
    assert plan.w_tiles == {"w20k_b64": 0, "h50000_b2": 0, "w20k_mom": 2,
                            "w20k_mom_bf16": 2}.get(name, 1)
    if name == "b128_h1000":  # passes of 32 rows of h, whole rows
        assert (plan.vis_rows, plan.vis_window, plan.hstride) == (32, 1000, 1000)
    if name == "h50000_b2":  # windows of whole W tiles (128 floats) per unit
        assert plan.vis_rows == 2 and plan.vis_window < H and plan.vis_window % 128 == 0
        assert plan.hstride == plan.vis_window
    # under PCD a pass also holds the data chain's rows (the monitor)
    pcd = KW.wide_launch_plan(tcfg.replace(persistent=True))
    assert pcd.ok and plan.vis_rows <= pcd.vis_rows <= min(2 * B, 64)
    if name == "w20k":
        assert (pcd.vis_rows, pcd.smem_bytes) == (40, plan.smem_bytes)
    # a smaller card: the same shapes fit less, and the plan says so
    assert not KW.wide_launch_plan(tcfg, smem_limit=48 * 1024).ok


@pytest.mark.parametrize("k", [1, 2])
def test_wide_trace_layout(k):
    """The W-blocked kernel's trace keeps its layout, so phase times compare
    across versions: per update x W from the data and its reduce, then per
    Gibbs step the visible phase, x W and its reduce, then the update."""
    tcfg = convert_config(RBMConfig(n_visible=20000, n_hidden=400, k=k, **{
        kk: v for kk, v in WIDE.items() if kk != "k"}))
    names = ["xw_from_data", "hidden_from_data"]
    for t in range(k):
        names += [f"visible_{t}", f"xw_{t}", f"hidden_{t}"]
    assert KW.wide_trace_phases(tcfg) == names + ["update_and_monitor"]
    assert KW.wide_trace_len(tcfg) == 3 * k + 4


# ---- bf16 state through convert.py, a checkpoint and the API ---------------------


def test_bf16_state_round_trip_and_transform(tmp_path):
    cfg = RBMConfig(n_visible=48, n_hidden=16, batch_size=8, momentum=0.5, persistent=True,
                    param_dtype="bfloat16", epochs=E)
    data, st, u = make_inputs(cfg, nb=4)
    tst = to_port(st, cfg)
    assert tst.params.W.dtype == tst.velocity.c.dtype == tst.chain_h.dtype == torch.bfloat16
    tree = state_to_numpy(tst)  # float32 arrays that hold the bf16 values
    for part in ("params", "velocity"):
        for k, v in getattr(st, part)._asdict().items():
            if v is not None:
                assert tree[part][k].dtype == np.float32
                np.testing.assert_array_equal(tree[part][k], f32(v))
    np.testing.assert_array_equal(tree["chain_h"], f32(st.chain_h))
    again = state_from_numpy(tree, dtype=torch.bfloat16, device="cpu")  # no second rounding
    torch.testing.assert_close(again.params.W, tst.params.W, rtol=0, atol=0)
    save_state(tst, str(tmp_path / "s.pt"))
    back = restore_state(str(tmp_path / "s.pt"), "cpu")
    for part in ("params", "velocity"):
        for k, v in getattr(tst, part).as_dict().items():
            r = getattr(getattr(back, part), k)
            assert r.dtype == torch.bfloat16
            torch.testing.assert_close(r, v, rtol=0, atol=0)
    torch.testing.assert_close(back.chain_h, tst.chain_h, rtol=0, atol=0)
    # the slice through the API on the CPU: train_rbm on the restored bf16 state
    tcfg = convert_config(cfg)
    state, metrics = train_rbm(data, tcfg, state=back, uniforms=u)
    assert metrics.engine == "eager" and state.params.W.dtype == torch.bfloat16
    want = port_run(cfg, data, st, u)
    torch.testing.assert_close(state.params.W, want[0].W, rtol=0, atol=0)
    # transform on bf16 parameters against the JAX transform of the same values
    rbm = rbm_from_numpy(tcfg, state_to_numpy(state)["params"], device="cpu")
    assert rbm.params.W.dtype == torch.bfloat16
    jparams = RBMParams(**{k: jnp.asarray(v).astype(jnp.bfloat16)
                           for k, v in state_to_numpy(state)["params"].items()}, z=None)
    np.testing.assert_allclose(rbm.transform(data).float().numpy(),
                               f32(j_transform(jparams, jnp.asarray(data, jnp.bfloat16), cfg)),
                               rtol=0, atol=1e-2)

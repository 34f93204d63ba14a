"""The CUDA train kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built from csrc/ at first use);
skips elsewhere. Imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inject mode, hardened uniforms: both sides see the same draws, so the
trajectories agree to fp32 summation-order noise. Tolerance rtol=atol=1e-4
over 2 epochs of a small problem (the two differ only in the order of fp32
sums; a single flipped sample would show as an O(lr/B) = 1e-2 jump).
The estimator modes (tempering, enhanced gradient, learned variance, the
pseudo-likelihood monitor) are held the same way, and so are the W-blocked
kernel (csrc/cd_train_wide.cu) against its own plain version, the resident
kernel (csrc/cd_train_resident.cu) against cd_train_run_plain, and the
data-parallel path's per-step kernels (csrc/cd_grads.cu and the resident
kernel's step variant) one step at a time, with a one-rank NCCL mesh through
its entry points (the captured epoch against the eager loop, bit for bit). At bf16
storage both sides round one float32 result into bf16, so they agree except
where the two results straddle a rounding boundary; over the 12 updates of a
run such an ulp can carry on, so stored bf16 values are held to two ulps
(rtol=2^-6) beside the same atol.
"""

import numpy as np
import pytest
import torch

from mdbn_tpu_torch.config import RBMConfig
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.core.rbm_math import torch_dtype
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
from mdbn_tpu_torch.ops import cd_epoch_wide_cuda as KW

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -6, atol=1e-4)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")

SMALL = dict(n_visible=40, n_hidden=24, batch_size=8)
CASES = [
    RBMConfig(**SMALL, lr=0.1),
    RBMConfig(**SMALL, k=2, persistent=True, momentum=0.5, l2=1e-3, lr=0.1),
    RBMConfig(**SMALL, visible="gaussian", lr=0.01),
    RBMConfig(**SMALL, visible="gaussian", lr=0.01, sample_visible=True, k=2),
    RBMConfig(**SMALL, momentum=0.9, initial_momentum=0.5, momentum_switch_epoch=1,
              sparsity_target=0.1, sparsity_cost=0.5, grad_clip=0.05, error_metric="xent"),
    RBMConfig(**SMALL, compute_dtype="bfloat16"),
]
# the estimator modes; PT ladders warm enough that swaps are accepted and rejected
MODES = {
    "pt-bernoulli": RBMConfig(**SMALL, lr=0.1, k=2, momentum=0.5, persistent=True,
                              pt_temps=4, pt_beta_min=0.2),
    "pt-gaussian-sampled": RBMConfig(**SMALL, visible="gaussian", lr=0.005, persistent=True,
                                     pt_temps=3, pt_beta_min=0.3, sample_visible=True,
                                     grad_clip=1.0),
    "pt-learn-variance": RBMConfig(**SMALL, visible="gaussian", lr=0.005, persistent=True,
                                   pt_temps=3, pt_beta_min=0.3, learn_variance=True,
                                   momentum=0.5),
    "enhanced-sparsity": RBMConfig(**SMALL, lr=0.1, gradient="enhanced", momentum=0.5,
                                   sparsity_target=0.1, sparsity_cost=0.5),
    "learn-variance": RBMConfig(**SMALL, visible="gaussian", lr=0.005, learn_variance=True),
    "learn-variance-meanfield-pcd": RBMConfig(**SMALL, visible="gaussian", lr=0.005,
                                              learn_variance=True, sample_visible=False,
                                              persistent=True, lr_variance=0.002),
    "pseudo": RBMConfig(**SMALL, lr=0.1, error_metric="pseudo"),
    "pseudo-pt-enhanced": RBMConfig(**SMALL, lr=0.1, error_metric="pseudo",
                                    gradient="enhanced", persistent=True, pt_temps=3,
                                    pt_beta_min=0.5),
}


# bf16 storage on cd_train.cu, with f32 and with bf16 compute
BF16_CASES = {
    "cd1-f32-compute": RBMConfig(**SMALL, lr=0.1, param_dtype="bfloat16"),
    "pcd-momentum": RBMConfig(**SMALL, k=2, persistent=True, momentum=0.5, l2=1e-3, lr=0.1,
                              **BF16),
    "gaussian-sampled": RBMConfig(**SMALL, visible="gaussian", lr=0.01, sample_visible=True,
                                  **BF16),
    "pt": RBMConfig(**SMALL, lr=0.1, persistent=True, pt_temps=3, pt_beta_min=0.3, **BF16),
    "learn-variance": RBMConfig(**SMALL, visible="gaussian", lr=0.005, learn_variance=True,
                                **BF16),
    "enhanced": RBMConfig(**SMALL, lr=0.1, gradient="enhanced", momentum=0.5, **BF16),
}
# the W-blocked kernel: V over several strips would need V > 512, so one case is wider
MEANFIELD = dict(sample_visible=False, l2=1e-4, grad_clip=0.5)
WIDE_CASES = {
    "gaussian": RBMConfig(**SMALL, visible="gaussian", lr=0.01, **MEANFIELD),
    "gaussian-momentum": RBMConfig(**SMALL, visible="gaussian", lr=0.01, momentum=0.5,
                                   **MEANFIELD),
    "bernoulli-xent-sparsity": RBMConfig(**SMALL, lr=0.1, error_metric="xent",
                                         sparsity_target=0.1, sparsity_cost=0.5, **MEANFIELD),
    "bernoulli-pcd-k2": RBMConfig(**SMALL, lr=0.1, k=2, persistent=True, momentum=0.5,
                                  **MEANFIELD),
    "three-strips-batch-40": RBMConfig(n_visible=1100, n_hidden=72, batch_size=40,
                                       visible="gaussian", lr=0.005, **MEANFIELD),
    "bf16-gaussian": RBMConfig(**SMALL, visible="gaussian", lr=0.01, **MEANFIELD, **BF16),
    "bf16-pcd-momentum": RBMConfig(**SMALL, lr=0.1, persistent=True, momentum=0.5,
                                   **MEANFIELD, **BF16),
    # the redesigned kernel's edges: V not a multiple of 16 or 512; H 257 and 1000
    # (the update's 4-column groups and h W^T's tiles end part-way); batches 1,
    # 20 and 64 (h W^T's rows per warp 1-8); B 128 at H 1000 past the update's
    # staging fit (h0p and hmean through the L2, h W^T in passes of 32 rows);
    # a row of h wider than shared memory (h W^T by windows, no W tiles)
    "v4097-h257-b1-pcd-momentum": RBMConfig(n_visible=4097, n_hidden=257, batch_size=1,
                                            visible="gaussian", lr=0.005, persistent=True,
                                            momentum=0.5, **MEANFIELD),
    "v4097-h1000-b20-xent": RBMConfig(n_visible=4097, n_hidden=1000, batch_size=20, lr=0.05,
                                      error_metric="xent", **MEANFIELD),
    "v4097-h257-b64-bf16-momentum": RBMConfig(n_visible=4097, n_hidden=257, batch_size=64,
                                              visible="gaussian", lr=0.005, momentum=0.5,
                                              **MEANFIELD, **BF16),
    "v4097-h1000-b20-bf16-pcd-xent": RBMConfig(n_visible=4097, n_hidden=1000, batch_size=20,
                                               lr=0.05, persistent=True, momentum=0.5,
                                               error_metric="xent", **MEANFIELD, **BF16),
    "v4097-h1000-b128-pcd-momentum-past-fit": RBMConfig(
        n_visible=4097, n_hidden=1000, batch_size=128, visible="gaussian", lr=0.005,
        persistent=True, momentum=0.5, **MEANFIELD),
    "v64-h50000-b2-windowed": RBMConfig(n_visible=64, n_hidden=50000, batch_size=2,
                                        visible="gaussian", lr=0.001, **MEANFIELD),
    # bf16 compute on float32 storage: x W's tensor-core tiles round W as they stage it
    "v4097-h1000-b20-f32-store-bf16-compute": RBMConfig(
        n_visible=4097, n_hidden=1000, batch_size=20, visible="gaussian", lr=0.005,
        momentum=0.5, compute_dtype="bfloat16", **MEANFIELD),
    # past 256 rows with h unstaged: the update stages each strip in chunks
    "v600-h1000-b300-chunked-momentum": RBMConfig(n_visible=600, n_hidden=1000, batch_size=300,
                                                  visible="gaussian", lr=0.005, momentum=0.5,
                                                  **MEANFIELD),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cfg, device, E=2, nb=6, seed=0, wide=False):
    rng = np.random.default_rng(seed)
    n = nb * cfg.batch_size
    if cfg.visible == "bernoulli":
        data = (rng.random((n, cfg.n_visible)) < 0.3).astype(np.float32)
    else:
        data = rng.standard_normal((n, cfg.n_visible)).astype(np.float32)
    data = torch.as_tensor(data, device=device).to(torch_dtype(cfg.param_dtype))
    st = init_train_state(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = K.draw_uniform_blocks(cfg, gen, E, nb)
    u = K.harden_uniform_blocks(cfg, st.params, st.velocity, st.chain_h, data, u, E,
                                wide=wide)
    return st, data, K.batch_order(cfg, nb, E, None), u


def _check(got, want):
    for a, b in zip(got[:2], want[:2]):
        for name in ("W", "b", "c", "z"):
            if getattr(b, name) is not None:
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype
                tol = BF16_TOL if y.dtype == torch.bfloat16 else TOL
                torch.testing.assert_close(x.float(), y.float(), **tol)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)  # chain: exact samples
    torch.testing.assert_close(got[3], want[3], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CASES, ids=range(len(CASES)))
def test_kernel_matches_plain_inject(cuda, cfg):
    st, data, order, u = _inputs(cfg, cuda)
    before = K.cd_train_launches
    got = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert K.cd_train_launches == before + 1
    want = K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    _check(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODES))
def test_kernel_modes_match_plain_inject(cuda, name):
    cfg = MODES[name]
    st, data, order, u = _inputs(cfg, cuda)
    before = K.cd_train_launches
    got = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert K.cd_train_launches == before + 1
    _check(got, K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                     u))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["plain-cd1", "pt-bernoulli", "pt-learn-variance",
                                  "enhanced-sparsity", "pseudo-pt-enhanced", "bf16-pcd-momentum",
                                  "bf16-pt"])
def test_kernel_sampling_is_grid_independent_and_trains(cuda, name):
    cfg = {**MODES, "bf16-pcd-momentum": BF16_CASES["pcd-momentum"],
           "bf16-pt": BF16_CASES["pt"]}.get(name, RBMConfig(**SMALL, lr=0.1))
    st, data, order, _ = _inputs(cfg, cuda, E=4)
    trace = [torch.zeros((4, 6, K.trace_len(cfg)), dtype=torch.int64, device=cuda)
             for _ in range(3)]
    runs = [K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                           torch.Generator().manual_seed(3), grid=g, trace=tr)
            for g, tr in zip((1, 7, 0), trace)]
    for r in runs[1:]:
        for name in ("W", "b", "c", "z"):
            if getattr(r[0], name) is not None:
                torch.testing.assert_close(getattr(r[0], name), getattr(runs[0][0], name),
                                           rtol=0, atol=0)
        torch.testing.assert_close(r[2], runs[0][2], rtol=0, atol=0)
        torch.testing.assert_close(r[3], runs[0][3], rtol=0, atol=0)
    assert bool((trace[2].diff(dim=2) >= 0).all()) and bool((trace[2] > 0).all())
    errs = runs[0][3].tolist()
    assert all(np.isfinite(errs))
    if name == "plain-cd1":
        assert errs[-1] < errs[0]


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    cfg = RBMConfig(n_visible=40, n_hidden=24, batch_size=8)
    st, data, order, _ = _inputs(cfg, cuda)
    with pytest.raises(ValueError, match="bfloat16"):  # float32 state under a bf16 config
        K.cd_train_run(cfg.replace(param_dtype="bfloat16"), st.params, st.velocity,
                       st.chain_h, data, order, 0, None, torch.Generator())
    with pytest.raises(ValueError, match="float32"):
        K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data.double(), order, 0,
                       None, torch.Generator())
    with pytest.raises(RuntimeError, match="cudaError"):
        K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                       torch.Generator(), grid=1 << 20)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BF16_CASES))
def test_kernel_bf16_storage_matches_plain_inject(cuda, name):
    cfg = BF16_CASES[name]
    st, data, order, u = _inputs(cfg, cuda)
    assert st.params.W.dtype == data.dtype == torch.bfloat16
    before = K.cd_train_launches, KW.cd_train_wide_launches
    got = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert (K.cd_train_launches, KW.cd_train_wide_launches) == (before[0] + 1, before[1])
    assert got[0].W.dtype == got[1].W.dtype == got[2].dtype == torch.bfloat16
    _check(got, K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                     u))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_CASES))
def test_wide_kernel_matches_plain_inject(cuda, name):
    cfg = WIDE_CASES[name]
    st, data, order, u = _inputs(cfg, cuda, wide=True)
    before = K.cd_train_launches, KW.cd_train_wide_launches
    got = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u,
                         wide=True)
    torch.cuda.synchronize()
    assert (K.cd_train_launches, KW.cd_train_wide_launches) == (before[0], before[1] + 1)
    _check(got, KW.cd_train_wide_run_plain(cfg, st.params, st.velocity, st.chain_h, data,
                                           order, 0, u))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaussian-momentum", "bernoulli-pcd-k2",
                                  "three-strips-batch-40", "bf16-pcd-momentum"])
def test_wide_kernel_sampling_is_grid_independent_and_trains(cuda, name):
    cfg = WIDE_CASES[name]
    st, data, order, _ = _inputs(cfg, cuda, E=4, wide=True)
    trace = [torch.zeros((4, 6, KW.wide_trace_len(cfg)), dtype=torch.int64, device=cuda)
             for _ in range(4)]
    runs = [KW.cd_train_wide_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                                 torch.Generator().manual_seed(3), grid=g, trace=tr)
            for g, tr in zip((1, 7, 132, 0), trace)]
    for r in runs[1:]:
        for name in ("W", "b", "c"):
            for part in (0, 1):
                torch.testing.assert_close(getattr(r[part], name),
                                           getattr(runs[0][part], name), rtol=0, atol=0)
        torch.testing.assert_close(r[2], runs[0][2], rtol=0, atol=0)
        torch.testing.assert_close(r[3], runs[0][3], rtol=0, atol=0)
    assert bool((trace[3].diff(dim=2) >= 0).all()) and bool((trace[3] > 0).all())
    errs = runs[0][3].tolist()
    assert all(np.isfinite(errs)) and errs[-1] < errs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["v4097-h1000-b20-bf16-pcd-xent",
                                  "v4097-h1000-b128-pcd-momentum-past-fit"])
def test_wide_kernel_bits_on_grids(cuda, name):
    """The redesigned kernel's sums run in a fixed order whatever a block
    takes: grids 1, 7 and 132 give the default grid's bits, at bf16 storage
    and past the update's staging fit."""
    cfg = WIDE_CASES[name]
    st, data, order, _ = _inputs(cfg, cuda, E=1, nb=2, wide=True)
    runs = [KW.cd_train_wide_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                                 torch.Generator().manual_seed(3), grid=g)
            for g in (0, 1, 7, 132)]
    for r in runs[1:]:
        for part in (0, 1):
            for x, y in zip(r[part].as_dict().values(), runs[0][part].as_dict().values()):
                assert torch.equal(x, y)
        assert torch.equal(r[2], runs[0][2]) and torch.equal(r[3], runs[0][3])


@pytest.mark.cuda
def test_wide_launch_plan_matches_the_library(cuda):
    """ops.cd_epoch_wide_cuda.wide_launch_plan mirrors csrc's wide_plan
    (the shared memory a launch takes, what it stages) at the card's limit."""
    import ctypes

    from mdbn_tpu_torch._build import load_library

    for cfg in list(WIDE_CASES.values()) + [
            RBMConfig(n_visible=40000, n_hidden=1000, batch_size=20, visible="gaussian",
                      lr=0.001, **BF16),
            RBMConfig(n_visible=20000, n_hidden=400, batch_size=64, visible="gaussian",
                      lr=0.001)]:
        lib = load_library("cd_train_wide", cfg.param_dtype).lib
        limit = R.device_limits(cfg, cuda)[0]  # the card's opt-in shared memory of a block
        out = (ctypes.c_int * 8)()
        lib.cd_train_wide_plan(cfg.n_hidden, cfg.batch_size, K.kernel_flags(cfg),
                               *K.schedule_args(cfg)[:2], limit, out)
        assert tuple(out) == KW.wide_launch_plan(cfg, limit).as_tuple(), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["three-strips-batch-40", "bf16-pcd-momentum"])
def test_wide_dp_one_rank_equals_the_single_device_kernel(cuda, monkeypatch, name):
    """The W-blocked DP step runs cd_train_wide.cu's phases and the update
    its own design (csrc/cd_wide_update.cuh: gW's sums in another order): on
    a one-rank NCCL mesh, three updates one at a time give the single-device
    kernel's parameters and velocities on the same injected draws, float32
    at REPLAY_TOL, bf16 a velocity to one ulp and a parameter to its
    velocity's ulp and one of its own."""
    import torch.distributed as dist

    from mdbn_tpu_torch.core.state import TrainState
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    cfg = WIDE_CASES[name].replace(engine="pallas")
    assert K.select_dp_kernel(cfg) == "cd_grads_wide"
    st, data, _, _ = _inputs(cfg, cuda, E=1, nb=3, wide=True)
    B, one = cfg.batch_size, torch.zeros((1, 1), dtype=torch.int32)
    gen = torch.Generator(device=cuda).manual_seed(40)
    mesh = make_mesh(1, backend="nccl")
    try:
        for t in range(3):
            batch = data[t * B:(t + 1) * B]
            u = K.draw_uniform_blocks(cfg, gen, 1, 1)
            single = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, batch, one, t, u,
                                    wide=True)
            st, errs = train_rbm_shard_map(
                TrainState(st.params, st.velocity, st.chain_h, st.generator, t), batch, cfg,
                mesh, 1, pallas_step=True, uniforms={k: x[:, :, None] for k, x in u.items()})
            torch.cuda.synchronize()
            for n in ("W", "b", "c"):
                _wide_update_close(getattr(st.params, n), getattr(st.velocity, n),
                                   getattr(single[0], n), getattr(single[1], n))
            torch.testing.assert_close(errs, single[3], **REPLAY_TOL)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_kernels_draw_alike_from_one_seed(cuda):
    """The two kernels share the Philox keying: at float32 storage, where
    they compute the same function, one seed gives the same samples."""
    cfg = WIDE_CASES["bernoulli-pcd-k2"]
    st, data, order, _ = _inputs(cfg, cuda, wide=True)
    a, b = (K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                           torch.Generator().manual_seed(5), wide=w) for w in (False, True))
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    torch.testing.assert_close(a[0].W, b[0].W, **TOL)


@pytest.mark.cuda
def test_wide_kernel_raises_outside_its_scope(cuda):
    cfg = RBMConfig(**SMALL, lr=0.1)  # Bernoulli CD samples its visibles
    st, data, order, _ = _inputs(cfg, cuda)
    for outside in (cfg, cfg.replace(sample_visible=False, error_metric="pseudo"),
                    cfg.replace(sample_visible=False, gradient="enhanced")):
        before = K.cd_train_launches, KW.cd_train_wide_launches
        with pytest.raises(ValueError, match="W-blocked"):
            K.cd_train_run(outside, st.params, st.velocity, st.chain_h, data, order, 0, None,
                           torch.Generator(), wide=True)
        assert (K.cd_train_launches, KW.cd_train_wide_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        KW.cd_train_wide_run(cfg.replace(sample_visible=False), st.params, st.velocity,
                             st.chain_h, data.cpu(), order, 0, None, torch.Generator())


# the resident kernel, csrc/cd_train_resident.cu, against its plain version
# (cd_train_run_plain) at both storage dtypes: CD and PCD, momentum, Bernoulli
# and Gaussian (mean-field and sampled), mse and xent, at tolerances of
# cd_train.cu's tests; the odd shape spreads over 13 clusters of 3 ranks with a
# short last strip and tile
RESIDENT_CASES = {
    "cd1": CASES[0],
    "pcd-k2-momentum-l2": CASES[1],
    "gaussian-meanfield": CASES[2],
    "gaussian-sampled-k2": CASES[3],
    "xent-schedule-sparsity-clip": CASES[4],
    "bf16-compute": CASES[5],
    "bf16-storage-f32-compute": BF16_CASES["cd1-f32-compute"],
    "bf16-pcd-momentum": BF16_CASES["pcd-momentum"],
    "bf16-gaussian-sampled": BF16_CASES["gaussian-sampled"],
    "odd-13-clusters-pcd": RBMConfig(n_visible=301, n_hidden=77, batch_size=13, lr=0.05, k=2,
                                     persistent=True, momentum=0.5),
    "c1-width-xent": RBMConfig(n_visible=784, n_hidden=500, batch_size=20, lr=0.05,
                               error_metric="xent"),
    # column tiles of 544, wider than the block's 512 threads
    "wide-tile-64x4352-b4-pcd": RBMConfig(n_visible=64, n_hidden=4352, batch_size=4, lr=0.05,
                                          persistent=True, momentum=0.5),
}
# 13 strips of 16 rows, 4 ranks: the same bits on 13, 7 and 4 clusters
CLUSTERED = dict(n_visible=200, n_hidden=100, batch_size=20)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RESIDENT_CASES))
def test_resident_kernel_matches_plain_inject(cuda, name):
    cfg = RESIDENT_CASES[name]
    assert K.select_kernel(cfg) == "cd_train_resident"
    st, data, order, u = _inputs(cfg, cuda)
    before = R.cd_train_resident_launches, K.cd_train_launches
    got = R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert (R.cd_train_resident_launches, K.cd_train_launches) == (before[0] + 1, before[1])
    assert got[0].W.dtype == got[2].dtype == st.params.W.dtype
    _check(got, K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                     u))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cd1", "pcd-k2-momentum", "bf16-pcd-momentum"])
def test_resident_kernel_is_cluster_count_independent_and_trains(cuda, name):
    base = {"cd1": dict(lr=0.1), "pcd-k2-momentum": dict(lr=0.1, k=2, persistent=True,
                                                         momentum=0.5, l2=1e-3),
            "bf16-pcd-momentum": dict(lr=0.1, k=2, persistent=True, momentum=0.5, **BF16)}
    cfg = RBMConfig(**CLUSTERED, **base[name])
    tiles = R.resident_tiles(cfg)
    assert (tiles.strips, tiles.ranks) == (13, 4)
    st, data, order, _ = _inputs(cfg, cuda, E=4)
    trace = [torch.zeros((4, 6, R.resident_trace_len(cfg)), dtype=torch.int64, device=cuda)
             for _ in range(4)]
    runs = [R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                    None, torch.Generator().manual_seed(3), grid=g, trace=tr)
            for g, tr in zip((13, 7, 4, 0), trace)]
    for r in runs[1:]:
        for part in (0, 1):
            for n in ("W", "b", "c"):
                torch.testing.assert_close(getattr(r[part], n), getattr(runs[0][part], n),
                                           rtol=0, atol=0)
        torch.testing.assert_close(r[2], runs[0][2], rtol=0, atol=0)
        torch.testing.assert_close(r[3], runs[0][3], rtol=0, atol=0)
    for tr in trace:
        assert bool((tr.diff(dim=2) >= 0).all()) and bool((tr > 0).all())
    errs = runs[0][3].tolist()
    assert all(np.isfinite(errs)) and errs[-1] < errs[0]


# the same bits on two cluster counts where two strips fit one block: c5's
# tower recipe at c2's width (2000x400) at batch 4 (at batch 20 only 15
# clusters hold its tiles), and 64x4352 at batch 4 (tiles of 544 columns)
TWO_COUNTS = {
    "c5-tower-recipe-c2-width-b4": (RBMConfig(n_visible=2000, n_hidden=400, batch_size=4,
                                              visible="gaussian", lr=0.01, k=2,
                                              persistent=True, momentum=0.5, l2=1e-4),
                                    (15, 8)),
    "wide-tile-64x4352-b4": (RBMConfig(n_visible=64, n_hidden=4352, batch_size=4, lr=0.05,
                                       k=2, persistent=True, momentum=0.5), (8, 4)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TWO_COUNTS))
def test_resident_kernel_bits_on_two_cluster_counts(cuda, name):
    cfg, counts = TWO_COUNTS[name]
    st, data, order, _ = _inputs(cfg, cuda, E=3)
    runs = [R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                    None, torch.Generator().manual_seed(3), grid=g)
            for g in counts]
    for part in (0, 1):
        for n in ("W", "b", "c"):
            torch.testing.assert_close(getattr(runs[1][part], n), getattr(runs[0][part], n),
                                       rtol=0, atol=0)
    torch.testing.assert_close(runs[1][2], runs[0][2], rtol=0, atol=0)
    torch.testing.assert_close(runs[1][3], runs[0][3], rtol=0, atol=0)
    assert all(np.isfinite(runs[0][3].tolist()))


@pytest.mark.cuda
def test_resident_kernel_rejects_bad_inputs(cuda):
    cfg = RBMConfig(**CLUSTERED, lr=0.1)
    st, data, order, _ = _inputs(cfg, cuda)
    before = R.cd_train_resident_launches
    with pytest.raises(ValueError, match="bfloat16"):  # float32 state under a bf16 config
        R.cd_train_resident_run(cfg.replace(param_dtype="bfloat16"), st.params, st.velocity,
                                st.chain_h, data, order, 0, None, torch.Generator())
    c1 = RBMConfig(n_visible=784, n_hidden=500, batch_size=20, lr=0.1)
    st1, data1, order1, _ = _inputs(c1, cuda)
    with pytest.raises(ValueError, match="too few"):  # c1's 14 strips on one cluster
        R.cd_train_resident_run(c1, st1.params, st1.velocity, st1.chain_h, data1, order1, 0,
                                None, torch.Generator(), grid=1)
    with pytest.raises(ValueError, match="clusters"):  # more clusters than strips
        R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                None, torch.Generator(), grid=14)
    with pytest.raises(ValueError, match="trace"):
        R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                None, torch.Generator(),
                                trace=torch.zeros((2, 6, 3), dtype=torch.int64, device=cuda))
    assert R.cd_train_resident_launches == before


@pytest.mark.cuda
def test_resident_layout_matches_the_library(cuda):
    """The wrapper's fit (resident_tiles, smem_bytes) is the kernel's own."""
    import ctypes

    from mdbn_tpu_torch._build import load_library

    pt5 = dict(persistent=True, pt_temps=5, pt_beta_min=0.2)
    lv = dict(visible="gaussian", learn_variance=True)
    for V, H, B, dtype, pcd, modes in (
            (784, 500, 20, "float32", False, {}), (2000, 400, 20, "float32", True, {}),
            (250, 100, 20, "bfloat16", True, {}), (301, 77, 13, "float32", False, {}),
            (784, 500, 64, "bfloat16", False, {}), (784, 500, 20, "float32", True, pt5),
            (784, 500, 20, "bfloat16", True, pt5), (2000, 200, 20, "float32", False, lv),
            (2000, 200, 20, "bfloat16", True, dict(lv, pt_temps=3, pt_beta_min=0.4)),
            (784, 500, 20, "float32", True, dict(gradient="enhanced", error_metric="pseudo")),
            (64, 4352, 4, "float32", False, dict(gradient="enhanced"))):
        cfg = RBMConfig(n_visible=V, n_hidden=H, batch_size=B, param_dtype=dtype,
                        **dict(dict(persistent=pcd), **modes))
        lib = load_library(R.resident_library(cfg), dtype).lib
        out = (ctypes.c_int * 4)()
        lib.cd_train_resident_tiling(V, H, out)
        t = R.resident_tiles(cfg)
        assert tuple(out) == (t.rows, t.cols, t.strips, t.ranks)
        for ns in (1, 2, 3):
            assert lib.cd_train_resident_smem_bytes(V, H, B, cfg.pt_temps, K.kernel_flags(cfg),
                                                    ns) == R.smem_bytes(cfg, ns)
        smem, maxc = R.device_limits(cfg, cuda)
        if torch.cuda.get_device_name(cuda).startswith("NVIDIA H100"):
            assert (smem, maxc) == (R.H100_SMEM_PER_BLOCK, R.H100_MAX_CLUSTERS[t.ranks])


@pytest.mark.cuda
def test_train_takes_the_resident_kernel(cuda):
    from mdbn_tpu_torch import RBM

    cfg = RBMConfig(**CLUSTERED, lr=0.1, epochs=3, engine="pallas")
    data = _inputs(cfg, cuda)[1]
    before = R.cd_train_resident_launches, K.cd_train_launches
    rbm = RBM(cfg, device=cuda).train(data)
    assert (rbm.metrics.engine, rbm.metrics.kernel) == ("cuda", "cd_train_resident")
    assert (R.cd_train_resident_launches, K.cd_train_launches) == (before[0] + 1, before[1])
    assert rbm.history[-1] < rbm.history[0]
    mode = RBM(cfg.replace(gradient="enhanced"), device=cuda).train(data)
    assert mode.metrics.kernel == "cd_train_resident"
    assert (R.cd_train_resident_launches, K.cd_train_launches) == (before[0] + 2, before[1])


# the data-parallel path's per-step kernel, csrc/cd_grads.cu, at the shapes of
# chip_smoke.py's phase 12: c1 (784x500, batch 20), c1's third shard of a
# 3-way split of 20 (7 rows, one pad row masked, norm 20/3), c5's tower recipe
# at c2's width (Gaussian 2000x400, PCD k=2, sparsity). One step on hardened
# draws: the two sides differ only in the order of fp32 sums, so they agree to
# REPLAY_TOL, and sample the same chain.
REPLAY_TOL = dict(rtol=1e-5, atol=1e-6)
C1 = dict(n_visible=784, n_hidden=500, lr=0.1, batch_size=20)
GRADS_CASES = {
    "c1": (RBMConfig(**C1), None),
    "c1-rank2-of-3": (RBMConfig(**{**C1, "batch_size": 7}), 20 / 3),
    "c1-xent-sparsity-rank2-of-3": (RBMConfig(**{**C1, "batch_size": 7}, error_metric="xent",
                                              sparsity_target=0.1, sparsity_cost=0.1), 20 / 3),
    "c5-tower-c2": (RBMConfig(n_visible=2000, n_hidden=400, visible="gaussian", k=2,
                              persistent=True, lr=0.005, batch_size=20, sparsity_target=0.1,
                              sparsity_cost=0.1), None),
}


def _grads_inputs(cfg, norm, device, seed=0):
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops.cd_step import draw_uniforms

    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    gen = torch.Generator(device=device).manual_seed(seed)
    st = init_train_state(cfg, device=device)
    p = RBMParams(W=st.params.W * 10.0, b=0.1 * torch.randn(V, generator=gen, device=device),
                  c=0.1 * torch.randn(H, generator=gen, device=device))
    if cfg.visible == "bernoulli":
        v0 = (torch.rand((B, V), generator=gen, device=device) < 0.3).float()
    else:
        v0 = torch.randn((B, V), generator=gen, device=device)
    mask = None
    if norm is not None:
        mask = torch.ones((B, 1), device=device)
        mask[-1] = 0.0
        v0[-1] = 0.0  # a pad row
    chain = (torch.rand((B, H), generator=gen, device=device) < 0.5).float()
    u = draw_uniforms(cfg, B, gen)
    u = K.harden_uniform_blocks(cfg, p, st.velocity, chain, v0,
                                {k: x[None, None] for k, x in u.items()}, 1)
    return p, v0, chain, mask, {k: x[0, 0] for k, x in u.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRADS_CASES))
def test_grads_kernel_matches_plain(cuda, name):
    from mdbn_tpu_torch.ops import cd_grads_cuda as G

    cfg, norm = GRADS_CASES[name]
    p, v0, chain, mask, u = _grads_inputs(cfg, norm, cuda)
    before = G.cd_grads_launches
    got = G.cd_grads_step(cfg, p, v0, chain, uniforms=u, mask=mask, norm=norm)
    torch.cuda.synchronize()
    assert G.cd_grads_launches == before + 1
    want = G.cd_grads_step_plain(cfg, p, v0, chain, uniforms=u, mask=mask, norm=norm)
    for a, b in ((got[0].W, want[0].W), (got[0].b, want[0].b), (got[0].c, want[0].c),
                 (got[2], want[2])):
        torch.testing.assert_close(a, b, **REPLAY_TOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    if not cfg.persistent:
        assert torch.equal(got[1], chain)  # CD: the chain passes through


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c1", "c1-rank2-of-3", "c5-tower-c2"])
def test_grads_kernel_is_grid_independent(cuda, name):
    from mdbn_tpu_torch.ops import cd_grads_cuda as G

    cfg, norm = GRADS_CASES[name]
    p, v0, chain, mask, _ = _grads_inputs(cfg, norm, cuda)
    runs = [G.cd_grads_step(cfg, p, v0, chain, seed=3, mask=mask, norm=norm, grid=g)
            for g in (0, 1, 7, 132)]
    for r in runs[1:]:
        for a, b in zip(r[0].as_dict().values(), runs[0][0].as_dict().values()):
            assert torch.equal(a, b)
        assert torch.equal(r[1], runs[0][1]) and torch.equal(r[2], runs[0][2])
    assert bool(torch.isfinite(runs[0][0].W).all())


@pytest.mark.cuda
def test_grads_kernel_refuses(cuda):
    from mdbn_tpu_torch.ops import cd_grads_cuda as G

    cfg, norm = GRADS_CASES["c1-rank2-of-3"]
    p, v0, chain, mask, _ = _grads_inputs(cfg, norm, cuda)
    before = G.cd_grads_launches
    with pytest.raises(ValueError, match="bfloat16"):  # f32 state for a bf16-storage config
        G.cd_grads_step(cfg.replace(param_dtype="bfloat16"), p, v0, chain, seed=1)
    with pytest.raises(ValueError, match="shape"):
        G.cd_grads_step(cfg, p, v0[:-1], chain, seed=1)
    with pytest.raises(ValueError, match="float32"):
        G.cd_grads_step(cfg, p, v0.double(), chain, seed=1)
    with pytest.raises(ValueError, match="pseudo_bit"):
        G.cd_grads_step(cfg.replace(error_metric="pseudo"), p, v0, chain, seed=1)
    with pytest.raises(RuntimeError, match="cudaError"):
        G.cd_grads_step(cfg, p, v0, chain, seed=1, grid=1 << 20)
    assert G.cd_grads_launches == before


# the data-parallel step and update in every estimator mode and at bf16
# storage, on 7-row shards whose last row is padding (norm 20/3)
SHARD = dict(n_visible=40, n_hidden=24, batch_size=7)
GRADS_MODES = {
    "pt3": RBMConfig(**SHARD, lr=0.1, k=2, persistent=True, pt_temps=3, pt_beta_min=0.3),
    "lv-sampled": RBMConfig(**SHARD, visible="gaussian", lr=0.005, learn_variance=True),
    "lv-meanfield-pcd": RBMConfig(**SHARD, visible="gaussian", lr=0.005, learn_variance=True,
                                  sample_visible=False, persistent=True, lr_variance=0.002),
    "pt3-lv": RBMConfig(**SHARD, visible="gaussian", lr=0.005, learn_variance=True,
                        persistent=True, pt_temps=3, pt_beta_min=0.4, sample_visible=True,
                        momentum=0.5),
    "enhanced-sparsity": RBMConfig(**SHARD, lr=0.1, gradient="enhanced", k=2, momentum=0.5,
                                   sparsity_target=0.1, sparsity_cost=0.5),
    "pseudo-pcd": RBMConfig(**SHARD, lr=0.1, error_metric="pseudo", persistent=True),
    "bf16-pcd-momentum": RBMConfig(**SHARD, lr=0.1, k=2, persistent=True, momentum=0.5, **BF16),
    "bf16-storage-gaussian": RBMConfig(**SHARD, visible="gaussian", lr=0.01, momentum=0.5,
                                       param_dtype="bfloat16"),
}


def _mode_inputs(cfg, device, seed=0):
    """A shard's state at the storage dtype (learned variance: z ~ 0.2 N(0, 1)),
    its 7 rows with the last one padding, a 0/1 chain of all its rows, and
    one step's draws hardened against the plain version."""
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops.cd_step import draw_pt_uniforms, draw_uniforms

    B, V, H, M = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.pt_temps
    sdt = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device)
    st = init_train_state(cfg, device=device)
    p = RBMParams(W=st.params.W, b=(0.1 * rand(V)).to(sdt), c=(0.1 * rand(H)).to(sdt),
                  z=(0.2 * rand(V)).to(sdt) if cfg.learn_variance else None)
    v0 = ((torch.rand((B, V), generator=gen, device=device) < 0.3).float()
          if cfg.visible == "bernoulli" else rand(B, V))
    v0[-1] = 0.0
    v0 = v0.to(sdt)
    mask = torch.ones((B, 1), device=device)
    mask[-1] = 0.0
    chain = (torch.rand((B * M, H), generator=gen, device=device) < 0.5).to(sdt)
    u = (draw_pt_uniforms if M > 1 else draw_uniforms)(cfg, B, gen)
    return p, v0, chain, mask, G.harden_step(cfg, p, chain, v0, u)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRADS_MODES))
def test_grads_kernel_modes_match_plain(cuda, name):
    """The step's whole flat buffer (the statistics the exchange sums, the
    enhanced sums and the raw z statistic included) and its chain, kernel
    against plain; the same bits on grids of 1, 7 and 132 blocks."""
    from mdbn_tpu_torch.ops import cd_grads_cuda as G

    cfg = GRADS_MODES[name]
    p, v0, chain, mask, u = _mode_inputs(cfg, cuda)
    bit = 5 if cfg.error_metric == "pseudo" else None
    kw = dict(mask=mask, norm=20 / 3, pseudo_bit=bit)
    got, want = (torch.full((G.flat_size(cfg),), float("nan"), device=cuda) for _ in range(2))
    before = G.cd_grads_launches
    _, c_got, _ = G.cd_grads_step(cfg, p, v0, chain, uniforms=u, out=got, **kw)
    torch.cuda.synchronize()
    assert G.cd_grads_launches == before + 1
    _, c_want, _ = G.cd_grads_step_plain(cfg, p, v0, chain, uniforms=u, out=want, **kw)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, **REPLAY_TOL)
    assert c_got.dtype == chain.dtype
    torch.testing.assert_close(c_got, c_want, rtol=0, atol=0)
    runs = []
    for g in (0, 1, 7, 132):
        flat = torch.empty(G.flat_size(cfg), device=cuda)
        _, ch, _ = G.cd_grads_step(cfg, p, v0, chain, seed=3, out=flat, grid=g, **kw)
        runs.append((flat, ch))
    for flat, ch in runs[1:]:
        assert torch.equal(flat, runs[0][0]) and torch.equal(ch, runs[0][1])


# the update after the all-reduce, csrc/cd_grads.cu's second kernel: each
# product and sum rounds on its own, as in its plain version, so the two agree
# to the bit; c1's settings (no momentum, no decay) and c5's tower recipe with
# momentum, decay and clipping, on the sums of 3 ranks
UPDATE_CASES = {
    "c1": RBMConfig(**C1),
    "c5-tower-c2-momentum-l2-clip": RBMConfig(n_visible=2000, n_hidden=400, visible="gaussian",
                                              k=2, persistent=True, lr=0.005, batch_size=20,
                                              momentum=0.9, initial_momentum=0.5, l2=1e-3,
                                              grad_clip=0.05),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(UPDATE_CASES))
def test_update_kernel_matches_plain(cuda, name):
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.parallel.dp import world_scale

    cfg = UPDATE_CASES[name]
    gen = torch.Generator(device=cuda).manual_seed(4)
    rand = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=cuda)
    V, H = cfg.n_visible, cfg.n_hidden
    for epoch in (0, 5):
        p = RBMParams(W=rand(V, H), b=rand(V), c=rand(H))
        vel = RBMParams(W=rand(V, H), b=rand(V), c=rand(H))
        sums = 3 * rand(G.flat_size(cfg))
        want = G.cd_update_plain(cfg, p, vel, sums, world_scale(3), epoch)
        before = G.cd_update_launches
        got = G.cd_update(cfg, p.map(torch.clone), vel.map(torch.clone), sums, world_scale(3),
                          epoch)
        torch.cuda.synchronize()
        assert G.cd_update_launches == before + 1
        for a, b in zip(list(got[0].as_dict().values()) + list(got[1].as_dict().values()),
                        list(want[0].as_dict().values()) + list(want[1].as_dict().values())):
            assert torch.equal(a, b)
        assert torch.equal(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lv-meanfield-pcd", "pt3-lv", "enhanced-sparsity",
                                  "bf16-pcd-momentum", "bf16-storage-gaussian"])
def test_update_kernel_modes_match_plain(cuda, name):
    """The update on 3 ranks' summed statistics: learned variance's z and
    vz, bf16 storage and the enhanced gradient. Every elementwise result has
    the plain version's bits; the enhanced gradient's b and c, whose matvecs
    cuBLAS sums in another order, and z, whose precision e^{-z} may round
    another way, are held at REPLAY_TOL."""
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.parallel.dp import world_scale

    cfg = GRADS_MODES[name]
    sdt = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=cuda).manual_seed(5)
    rand = lambda *shape: (0.1 * torch.randn(shape, generator=gen, device=cuda)).to(sdt)
    V, H = cfg.n_visible, cfg.n_hidden
    z = cfg.learn_variance
    p = RBMParams(W=rand(V, H), b=rand(V), c=rand(H), z=rand(V) if z else None)
    vel = RBMParams(W=rand(V, H), b=rand(V), c=rand(H), z=rand(V) if z else None)
    sums = 3 * 0.1 * torch.randn(G.flat_size(cfg), generator=gen, device=cuda)
    want = G.cd_update_plain(cfg, p, vel, sums, world_scale(3), 0)
    before = G.cd_update_launches
    got = G.cd_update(cfg, p.map(torch.clone), vel.map(torch.clone), sums, world_scale(3), 0)
    torch.cuda.synchronize()
    assert G.cd_update_launches == before + 1
    loose = {"b", "c"} if cfg.gradient == "enhanced" else set()
    loose |= {"z"} if z else set()
    for i in (0, 1):
        for n, a in got[i].as_dict().items():
            b = getattr(want[i], n)
            assert a.dtype == sdt
            if n in loose:
                torch.testing.assert_close(a.float(), b.float(), **REPLAY_TOL)
            else:
                assert torch.equal(a, b), (i, n)
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_update_kernel_refuses(cuda):
    from mdbn_tpu_torch.ops import cd_grads_cuda as G

    cfg = UPDATE_CASES["c1"]
    st = init_train_state(cfg, device=cuda)
    sums = torch.zeros(G.flat_size(cfg), device=cuda)
    before = G.cd_update_launches
    with pytest.raises(ValueError, match="bfloat16"):  # f32 state for a bf16-storage config
        G.cd_update(cfg.replace(param_dtype="bfloat16"), st.params, st.velocity, sums, 1.0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        G.cd_update(cfg, st.params.map(lambda t: t.t().contiguous().t()), st.velocity,
                    sums, 1.0, 0)
    with pytest.raises(ValueError, match="shape"):
        G.cd_update(cfg, st.params, st.velocity, sums[:-1], 1.0, 0)
    lv = cfg.replace(visible="gaussian", learn_variance=True)
    with pytest.raises(ValueError, match="z"):
        G.cd_update(lv, st.params, st.velocity, torch.zeros(G.flat_size(lv), device=cuda),
                    1.0, 0)
    assert G.cd_update_launches == before


@pytest.mark.cuda
def test_dp_one_rank_nccl(cuda):
    """A mesh of one NCCL rank: RBM.train takes the single-device path; the
    kernel path of train_rbm_shard_map (step and update kernels) matches the
    core path on the same hardened draws, and leaves its input state as it
    was."""
    import torch.distributed as dist

    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    cfg = RBMConfig(**SMALL, lr=0.1, k=2, persistent=True, momentum=0.5, epochs=2)
    st, data, order, u = _inputs(cfg, cuda, E=2, nb=6)
    mesh = make_mesh(1, backend="nccl")
    try:
        assert (mesh.size, mesh.backend, mesh.device) == (1, "nccl", torch.device("cuda", 0))
        rbm = RBM(cfg, device=cuda).train(data, mesh=mesh)
        assert rbm.metrics.engine == "cuda"
        du = {k: x[:, :, None] for k, x in u.items()}
        assert K.select_dp_kernel(cfg) == "cd_grads_resident"
        before = (GR.cd_grads_resident_launches, G.cd_update_launches, G.cd_grads_launches)
        a, ea = train_rbm_shard_map(st, data, cfg, mesh, 2, pallas_step=True, uniforms=du)
        torch.cuda.synchronize()
        assert (GR.cd_grads_resident_launches, G.cd_update_launches, G.cd_grads_launches) == (
            before[0] + 12, before[1] + 12, before[2])
        assert torch.equal(st.params.W, init_train_state(cfg, device=cuda).params.W)
        b, eb = train_rbm_shard_map(st, data, cfg, mesh, 2, pallas_step=False, uniforms=du)
        for x, y in ((a.params.W, b.params.W), (a.params.c, b.params.c),
                     (a.velocity.W, b.velocity.W), (ea, eb)):
            torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(a.chain_h, b.chain_h, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


# the resident kernel's step variant (csrc/cd_train_resident.cu, kStep), the
# data-parallel step of a run whose tiles fit thread-block clusters: the same
# function as cd_grads.cu's step, against the same plain version
def _resident_clusters(cfg):
    """The default cluster count and the fewest that hold the tiles."""
    fits = [c for c in range(1, R.resident_tiles(cfg).strips + 1)
            if c <= R.H100_MAX_CLUSTERS[R.resident_tiles(cfg).ranks]
            and R.smem_bytes(cfg, -(-R.resident_tiles(cfg).strips // c))
            <= R.H100_SMEM_PER_BLOCK]
    return [0, fits[0]] if fits else [0]


def _flat_close(cfg, got, want):
    """The step's flat buffers: REPLAY_TOL at float32 compute; at bf16 compute
    an operand the two compute in float32 in other orders can round to the
    neighbouring bf16 value, so each part is held to one operand ulp (2^-7 of
    each value plus 2^-8 of the part's largest) + the replay atol."""
    from mdbn_tpu_torch.ops import cd_grads_cuda as G

    if cfg.compute_dtype != "bfloat16":
        torch.testing.assert_close(got, want, **REPLAY_TOL)
        return

    def parts(flat):
        grads, sums, err = G.flat_views(cfg, flat)
        return (list(grads.as_dict().values())
                + ([sums.mu, sums.lam, sums.h0] if sums is not None else []) + [err.reshape(1)])

    for a, b in zip(parts(got), parts(want)):
        tol = 2.0 ** -7 * b.abs() + 2.0 ** -8 * b.abs().max() + REPLAY_TOL["atol"]
        assert bool(((a - b).abs() <= tol).all()), float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRADS_CASES))
def test_dp_resident_step_matches_plain(cuda, name):
    """At chip_smoke.py's phase-12 shapes, hardened draws: the statistics at
    REPLAY_TOL, the same chain; one launch counted, none of cd_grads.cu's;
    the kernel's own draws give the same bits on two cluster counts."""
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR

    cfg, norm = GRADS_CASES[name]
    assert K.select_dp_kernel(cfg) == "cd_grads_resident"
    p, v0, chain, mask, u = _grads_inputs(cfg, norm, cuda)
    before = (GR.cd_grads_resident_launches, G.cd_grads_launches)
    got = GR.cd_grads_resident_step(cfg, p, v0, chain, uniforms=u, mask=mask, norm=norm)
    torch.cuda.synchronize()
    assert (GR.cd_grads_resident_launches, G.cd_grads_launches) == (before[0] + 1, before[1])
    want = G.cd_grads_step_plain(cfg, p, v0, chain, uniforms=u, mask=mask, norm=norm)
    for a, b in ((got[0].W, want[0].W), (got[0].b, want[0].b), (got[0].c, want[0].c),
                 (got[2], want[2])):
        torch.testing.assert_close(a, b, **REPLAY_TOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    if not cfg.persistent:
        assert got[1] is chain  # CD: the chain passes through
    runs = [GR.cd_grads_resident_step(cfg, p, v0, chain, seed=3, mask=mask, norm=norm, grid=g)
            for g in _resident_clusters(cfg)]
    for r in runs[1:]:
        for a, b in zip(r[0].as_dict().values(), runs[0][0].as_dict().values()):
            assert torch.equal(a, b)
        assert torch.equal(r[1], runs[0][1]) and torch.equal(r[2], runs[0][2])
    assert len(runs) == 2 and bool(torch.isfinite(runs[0][0].W).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRADS_MODES))
def test_dp_resident_step_modes_match_plain(cuda, name):
    """Every mode of GRADS_MODES on a 7-row shard with a pad row: the whole
    flat buffer (the enhanced sums and the raw z statistic included) against
    plain (_flat_close), the same chain, the same bits on two cluster counts
    and on a third launch sharing their scratch (its barrier counters and
    monitor sums left zero by each launch)."""
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR

    cfg = GRADS_MODES[name]
    assert K.select_dp_kernel(cfg.replace(batch_size=20), 3) == "cd_grads_resident"
    p, v0, chain, mask, u = _mode_inputs(cfg, cuda)
    bit = 5 if cfg.error_metric == "pseudo" else None
    kw = dict(mask=mask, norm=20 / 3, pseudo_bit=bit)
    got, want = (torch.full((G.flat_size(cfg),), float("nan"), device=cuda) for _ in range(2))
    _, c_got, _ = GR.cd_grads_resident_step(cfg, p, v0, chain, uniforms=u, out=got, **kw)
    _, c_want, _ = G.cd_grads_step_plain(cfg, p, v0, chain, uniforms=u, out=want, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _flat_close(cfg, got, want)
    assert c_got.dtype == chain.dtype
    torch.testing.assert_close(c_got, c_want, rtol=0, atol=0)
    scratch = GR.step_scratch(cfg, cuda)
    runs = []
    for g in _resident_clusters(cfg) + [0]:
        flat = torch.empty(G.flat_size(cfg), device=cuda)
        launch, _, ch, _ = GR.step_launcher(cfg, p, v0, chain, seed=3, out=flat, grid=g,
                                            scratch=scratch, **kw)
        launch()
        runs.append((flat, ch))
    torch.cuda.synchronize()
    for flat, ch in runs[1:]:
        assert torch.equal(flat, runs[0][0]) and torch.equal(ch, runs[0][1])


# the enhanced gradient's matvec pass (cd_enhance_kernel) spread over the card:
# the update after it against cd_update_plain on 3 ranks' sums, W, vW and the
# elementwise parts bit for bit, b and c (the matvecs, summed in another order)
# at REPLAY_TOL; at c1's width and at 2000x200 (several tile rows and columns)
ENHANCE_CASES = {
    "c1": RBMConfig(**C1, gradient="enhanced", momentum=0.5),
    "2000x200-sparsity": RBMConfig(n_visible=2000, n_hidden=200, visible="gaussian", lr=0.005,
                                   batch_size=20, gradient="enhanced", sparsity_target=0.1,
                                   sparsity_cost=0.5),
    "c1-bf16": RBMConfig(**C1, gradient="enhanced", **BF16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ENHANCE_CASES))
def test_enhance_pass_matches_plain(cuda, name):
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.parallel.dp import world_scale

    cfg = ENHANCE_CASES[name]
    sdt = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=cuda).manual_seed(6)
    rand = lambda *shape: (0.1 * torch.randn(shape, generator=gen, device=cuda)).to(sdt)
    V, H = cfg.n_visible, cfg.n_hidden
    p = RBMParams(W=rand(V, H), b=rand(V), c=rand(H))
    vel = RBMParams(W=rand(V, H), b=rand(V), c=rand(H))
    sums = 3 * 0.1 * torch.randn(G.flat_size(cfg), generator=gen, device=cuda)
    want = G.cd_update_plain(cfg, p, vel, sums, world_scale(3), 0)
    got = G.cd_update(cfg, p.map(torch.clone), vel.map(torch.clone), sums, world_scale(3), 0)
    again = G.cd_update(cfg, p.map(torch.clone), vel.map(torch.clone), sums, world_scale(3), 0)
    torch.cuda.synchronize()
    bf = cfg.compute_dtype == "bfloat16"
    for i in (0, 1):
        for n, a in got[i].as_dict().items():
            b = getattr(want[i], n)
            assert torch.equal(a, getattr(again[i], n))  # the same bits on every launch
            if n in ("b", "c"):
                if bf:
                    _close_bf16(a, b, atol=REPLAY_TOL["atol"])
                else:
                    torch.testing.assert_close(a.float(), b.float(), **REPLAY_TOL)
            else:
                assert torch.equal(a, b), (i, n)


# a captured epoch (parallel.dp.EpochSteps) on one NCCL rank against the eager
# loop of the same launches on the same seeds: bit for bit, on both routes
# (the resident step; c1 at batch 65, past the resident fit, on cd_grads.cu),
# with an odd and an even count of steps, the momentum switch and the pseudo
# monitor's bit schedule crossing epochs
CAPTURE_CASES = {
    "cd1-nb5": (RBMConfig(**SMALL, lr=0.1), 5),
    "pcd-k2-momentum-switch-nb3": (RBMConfig(**SMALL, lr=0.1, k=2, persistent=True,
                                             momentum=0.9, initial_momentum=0.5,
                                             momentum_switch_epoch=1), 3),
    "pt3-nb4": (RBMConfig(**SMALL, lr=0.1, persistent=True, pt_temps=3, pt_beta_min=0.3), 4),
    "enhanced-pseudo-nb3": (RBMConfig(**SMALL, lr=0.1, gradient="enhanced",
                                      error_metric="pseudo", momentum=0.5), 3),
    "lv-bf16-nb3": (RBMConfig(**SMALL, visible="gaussian", lr=0.005, learn_variance=True,
                              **BF16), 3),
    "c1-b65-cd_grads-nb3": (RBMConfig(**{**C1, "batch_size": 65}, persistent=True,
                                      momentum=0.5), 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CAPTURE_CASES))
def test_dp_captured_epoch_equals_eager(cuda, name):
    import torch.distributed as dist

    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
    from mdbn_tpu_torch.parallel import dp
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    cfg, nb = CAPTURE_CASES[name]
    route = "cd_grads" if "cd_grads" in name else "cd_grads_resident"
    assert K.select_dp_kernel(cfg) == route
    _, data, _, _ = _inputs(cfg, cuda, E=3, nb=nb)
    mesh = make_mesh(1, backend="nccl")
    try:
        counts = lambda: (GR.cd_grads_resident_launches, G.cd_grads_launches,
                          G.cd_update_launches)
        runs = []
        for capture in (True, False):  # each from the same state and generator
            before = counts()
            s2, errs = dp.train_rbm_shard_map(init_train_state(cfg, device=cuda), data, cfg,
                                              mesh, 3, pallas_step=True, capture=capture)
            torch.cuda.synchronize()
            steps = 3 * nb
            assert [a - b for a, b in zip(counts(), before)] == (
                [steps, 0, steps] if route == "cd_grads_resident" else [0, steps, steps])
            runs.append((s2, errs))
        (a, ea), (b, eb) = runs
        for x, y in zip(list(a.params.as_dict().values()) + list(a.velocity.as_dict().values()),
                        list(b.params.as_dict().values()) + list(b.velocity.as_dict().values())):
            assert torch.equal(x, y)
        assert torch.equal(a.chain_h, b.chain_h) and torch.equal(ea, eb)
        assert bool(torch.isfinite(ea).all()) and a.epoch == b.epoch == 3
    finally:
        dist.destroy_process_group()


# the W-blocked kernel's data-parallel mode, csrc/cd_grads_wide.cu: the step on
# a whole batch and on shards whose last row is padding (n_valid rows of 7,
# norm 20/3), and the update on 3 ranks' gathered slots
WIDE_DP_STEPS = {  # name: (the shard's config, real rows, norm)
    "gaussian-momentum": (RBMConfig(**SMALL, visible="gaussian", lr=0.01, momentum=0.5,
                                    **MEANFIELD), 8, None),
    "gaussian-shard-pad": (RBMConfig(**SHARD, visible="gaussian", lr=0.01, **MEANFIELD), 6,
                           20 / 3),
    "pcd-k2-xent-sparsity-shard-pad": (RBMConfig(**SHARD, lr=0.1, k=2, persistent=True,
                                                 error_metric="xent", sparsity_target=0.1,
                                                 sparsity_cost=0.5, **MEANFIELD), 6, 20 / 3),
    "three-strips-batch-40": (RBMConfig(n_visible=1100, n_hidden=72, batch_size=40,
                                        visible="gaussian", lr=0.005, **MEANFIELD), 40, None),
    "bf16-pcd-momentum-shard-pad": (RBMConfig(**SHARD, lr=0.1, persistent=True, momentum=0.5,
                                              **MEANFIELD, **BF16), 6, 20 / 3),
}


def _wide_dp_inputs(cfg, n_valid, device, seed=0):
    """The shard's parameters (W at 10x its init scale, small biases) at the
    storage dtype, its rows with the pad rows zero, a 0/1 chain, and one
    step's draws hardened against the W-blocked plain version."""
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops.cd_step import draw_uniforms

    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    sdt = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=device)
    st = init_train_state(cfg, device=device)
    p = RBMParams(W=(st.params.W.float() * 10.0).to(sdt), b=(0.1 * rand(V)).to(sdt),
                  c=(0.1 * rand(H)).to(sdt))
    v0 = ((torch.rand((B, V), generator=gen, device=device) < 0.3).float()
          if cfg.visible == "bernoulli" else rand(B, V))
    v0[n_valid:] = 0.0
    v0 = v0.to(sdt)
    chain = (torch.rand((B, H), generator=gen, device=device) < 0.5).to(sdt)
    u = G.harden_step(cfg, p, chain, v0, draw_uniforms(cfg, B, gen), wide=True)
    return p, v0, chain, u


def _close_bf16(a, b, atol=1e-6):
    """bf16 values (or values rounded from bf16 operands) within one bf16 ulp."""
    a, b = a.float(), b.float()
    assert bool(((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + atol).all()), \
        float((a - b).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_DP_STEPS))
def test_wide_dp_step_matches_plain(cuda, name):
    """The step's slot (vs, the h-matrix, err) and chain against the plain
    version on hardened draws: float32 at REPLAY_TOL; under bf16 compute the
    products' operands round to bf16, so vs and the h-matrix to one bf16 ulp
    (and 2^-8 absolute for probabilities) and err to 1e-3."""
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    cfg, nv, norm = WIDE_DP_STEPS[name]
    p, v0, chain, u = _wide_dp_inputs(cfg, nv, cuda)
    before = W.cd_wide_step_launches
    got, c_got = W.cd_wide_step(cfg, p, v0, chain, uniforms=u, n_valid=nv, norm=norm)
    torch.cuda.synchronize()
    assert W.cd_wide_step_launches == before + 1
    want, c_want = W.cd_wide_step_plain(cfg, p, v0, chain, uniforms=u, n_valid=nv, norm=norm)
    (gv, gh, ge), (wv, wh, we) = W.slot_views(cfg, got), W.slot_views(cfg, want)
    assert bool(torch.isfinite(gh).all()) and bool(torch.isfinite(gv.float()).all())
    assert torch.equal(gh[:, nv:], torch.zeros_like(gh[:, nv:]))  # pad rows enter nothing
    if cfg.compute_dtype == "bfloat16":
        _close_bf16(gv, wv)
        _close_bf16(gh, wh, atol=2.0 ** -8)
        torch.testing.assert_close(ge, we, rtol=1e-3, atol=1e-6)
    else:
        for a, b in ((gv, wv), (gh, wh), (ge, we)):
            torch.testing.assert_close(a, b, **REPLAY_TOL)
    torch.testing.assert_close(c_got, c_want, rtol=0, atol=0)  # the same samples
    if not cfg.persistent:
        assert torch.equal(c_got, chain)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gaussian-shard-pad", "three-strips-batch-40",
                                  "bf16-pcd-momentum-shard-pad"])
def test_wide_dp_step_is_grid_independent(cuda, name):
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    cfg, nv, norm = WIDE_DP_STEPS[name]
    p, v0, chain, _ = _wide_dp_inputs(cfg, nv, cuda)
    runs = [W.cd_wide_step(cfg, p, v0, chain, seed=3, n_valid=nv, norm=norm, grid=g)
            for g in (0, 1, 7, 132)]
    for slot, ch in runs[1:]:
        assert torch.equal(slot, runs[0][0]) and torch.equal(ch, runs[0][1])


WIDE_DP_UPDATES = {  # the global config; 3 ranks of ceil(B / 3) rows
    "momentum-schedule-l2-clip-sparsity": RBMConfig(
        n_visible=40, n_hidden=24, batch_size=20, lr=0.1, momentum=0.9, initial_momentum=0.5,
        sparsity_target=0.1, sparsity_cost=0.5, **MEANFIELD),
    "three-strips-batch-40": RBMConfig(n_visible=1100, n_hidden=300, batch_size=40,
                                       visible="gaussian", lr=0.005, momentum=0.5, **MEANFIELD),
    "bf16-momentum": RBMConfig(n_visible=40, n_hidden=24, batch_size=20, visible="gaussian",
                               lr=0.01, momentum=0.5, **MEANFIELD, **BF16),
}


def _wide_dp_gathered(cfg, ndev, device, seed=0):
    """Parameters, velocities, the global minibatch and ndev ranks' gathered
    slots of random factors (pad rows of the last rank zero in the h-matrix)."""
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W

    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    lb = -(-B // ndev)
    local = cfg.replace(batch_size=lb)
    sdt = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=device)
    state = lambda: RBMParams(W=rand(V, H).to(sdt), b=rand(V).to(sdt), c=rand(H).to(sdt))
    n = W.wide_factor_size(local)
    gathered = torch.zeros(ndev * n, dtype=torch.uint8, device=device)
    for d, (vs, hmat, err) in enumerate(W.gathered_views(local, gathered, ndev)):
        nv = min(lb, B - d * lb)
        vs.copy_((10.0 * rand(lb, V)).to(sdt))
        hmat[0, :nv] = torch.rand((nv, H), generator=gen, device=device)
        hmat[1, :nv] = -torch.rand((nv, H), generator=gen, device=device)
        err.copy_(rand(1).abs())
    return state(), state(), (10.0 * rand(B, V)).to(sdt), gathered


def _wide_update_close(gp, gv, wp, wv):
    """An update's parameter gp and velocity gv against wp, wv: float32 at
    REPLAY_TOL; bf16 a velocity to one ulp, a parameter to its velocity's ulp
    and one of its own."""
    assert gp.dtype == wp.dtype
    if gp.dtype == torch.bfloat16:
        _close_bf16(gv, wv)
        a, b = gp.float(), wp.float()
        big = torch.maximum(a.abs(), b.abs()) + torch.maximum(gv.float().abs(), wv.float().abs())
        assert bool(((a - b).abs() <= 2.0 ** -7 * big + 1e-6).all())
    else:
        torch.testing.assert_close(gv, wv, **REPLAY_TOL)
        torch.testing.assert_close(gp, wp, **REPLAY_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_DP_UPDATES))
def test_wide_dp_update_matches_plain(cuda, name):
    """The update on 3 ranks' gathered slots against the plain version, at
    epochs 0 and 5 (either side of a momentum switch): float32 at REPLAY_TOL
    (gW's sums run in another order than cuBLAS's), bf16 storage a velocity
    to one ulp and a parameter to its velocity's ulp and one of its own;
    the same bits on grids 1, 7 and 132."""
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W
    from mdbn_tpu_torch.parallel.dp import world_scale

    cfg = WIDE_DP_UPDATES[name]
    p, vel, v0, gathered = _wide_dp_gathered(cfg, 3, cuda)
    for epoch in (0, 5):
        want = W.cd_wide_update_plain(cfg, p, vel, v0, gathered, 3, world_scale(3), epoch)
        before = W.cd_wide_update_launches
        runs = [W.cd_wide_update(cfg, p.map(torch.clone), vel.map(torch.clone), v0, gathered, 3,
                                 world_scale(3), epoch, grid=g) for g in (0, 1, 7, 132)]
        torch.cuda.synchronize()
        assert W.cd_wide_update_launches == before + 4
        for r in runs[1:]:
            for i in (0, 1):
                for a, b in zip(r[i].as_dict().values(), runs[0][i].as_dict().values()):
                    assert torch.equal(a, b)
        got = runs[0]
        assert torch.equal(got[2], want[2])
        for n in ("W", "b", "c"):
            _wide_update_close(getattr(got[0], n), getattr(got[1], n), getattr(want[0], n),
                               getattr(want[1], n))


# the redesigned update (csrc/cd_wide_update.cuh) at wide shapes, each plan of
# update_plan: Y resident with X and W tiles in the ring (the fast path, f32
# FFMA and bf16 mma.sync), in K chunks (f32 at H 1000 under momentum; B 300 at
# H 1000 bf16; V not 4-aligned at f32; H not 8-aligned at bf16), two passes of
# units (H past 1024 at bf16, past 512 at f32); each over an even (4) and an
# uneven (3) split, at momentum 0 and under a schedule from 0 (epoch 0: m = 0
# on the velocity variant) to 0.5 (epoch 5)
_WIDE = dict(visible="gaussian", lr=0.005, sample_visible=False, l2=1e-4, grad_clip=0.5)
WIDE_DP_PLANS = {  # name: (config, expected resident)
    "f32-h400": (RBMConfig(n_visible=2000, n_hidden=400, batch_size=20, **_WIDE), 1),
    "f32-h400-schedule": (RBMConfig(n_visible=2000, n_hidden=400, batch_size=20,
                                    initial_momentum=0.0, momentum=0.5, **_WIDE), 1),
    "bf16-h400-schedule": (RBMConfig(n_visible=2000, n_hidden=400, batch_size=20,
                                     initial_momentum=0.0, momentum=0.5, **_WIDE, **BF16), 1),
    "bf16-h1000": (RBMConfig(n_visible=1000, n_hidden=1000, batch_size=20, **_WIDE, **BF16), 1),
    "f32-h1000-schedule-chunked": (RBMConfig(n_visible=1000, n_hidden=1000, batch_size=20,
                                             initial_momentum=0.0, momentum=0.5, **_WIDE), 0),
    "bf16-h1000-b300-chunked": (RBMConfig(n_visible=600, n_hidden=1000, batch_size=300,
                                          momentum=0.5, **_WIDE, **BF16), 0),
    "f32-v1001-chunked": (RBMConfig(n_visible=1001, n_hidden=130, batch_size=20,
                                    momentum=0.5, **_WIDE), 0),
    "bf16-h1100-two-passes-chunked": (RBMConfig(n_visible=512, n_hidden=1100, batch_size=12,
                                                momentum=0.5, **_WIDE, **BF16), 0),
    "bf16-h1104-two-passes": (RBMConfig(n_visible=512, n_hidden=1104, batch_size=12,
                                        momentum=0.5, **_WIDE, **BF16), 1),
    "f32-h600-two-passes": (RBMConfig(n_visible=500, n_hidden=600, batch_size=12, **_WIDE), 1),
    "f32-store-bf16-compute": (RBMConfig(n_visible=1000, n_hidden=300, batch_size=20,
                                         momentum=0.5, compute_dtype="bfloat16", **_WIDE), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ndev", [3, 4])
@pytest.mark.parametrize("name", list(WIDE_DP_PLANS))
def test_wide_dp_update_plans_match_plain(cuda, name, ndev):
    """Every plan of the update against the plain version over an uneven and
    an even split, at epochs 0 and 5; the same bits on grids 1, 7, 132 and
    the default, the monitor's bits, and the wrapper's plan equal to the
    library's."""
    import ctypes

    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W
    from mdbn_tpu_torch.parallel.dp import world_scale

    cfg, resident = WIDE_DP_PLANS[name]
    plan = W.update_plan(cfg)
    assert plan.ok and int(plan.resident) == resident, plan
    out = (ctypes.c_int * 7)()
    lib = W._library(cfg)
    lib.cd_wide_update_plan(cfg.n_visible, cfg.n_hidden, cfg.batch_size, K.kernel_flags(cfg),
                            int(W.velocity_variant(cfg)), 1, R.H100_SMEM_PER_BLOCK,
                            W.H100_SMEM_PER_SM, out)
    assert tuple(out) == plan.as_tuple()
    p, vel, v0, gathered = _wide_dp_gathered(cfg, ndev, cuda, seed=ndev)
    for epoch in (0, 5):
        want = W.cd_wide_update_plain(cfg, p, vel, v0, gathered, ndev, world_scale(ndev), epoch)
        runs = [W.cd_wide_update(cfg, p.map(torch.clone), vel.map(torch.clone), v0, gathered,
                                 ndev, world_scale(ndev), epoch, grid=g) for g in (0, 1, 7, 132)]
        torch.cuda.synchronize()
        for r in runs[1:]:
            for i in (0, 1):
                for a, b in zip(r[i].as_dict().values(), runs[0][i].as_dict().values()):
                    assert torch.equal(a, b)
        assert torch.equal(runs[0][2], want[2])
        for n in ("W", "b", "c"):
            _wide_update_close(getattr(runs[0][0], n), getattr(runs[0][1], n),
                               getattr(want[0], n), getattr(want[1], n))


@pytest.mark.cuda
def test_wide_dp_one_rank_nccl(cuda, monkeypatch):
    """A mesh of one NCCL rank with the W-blocked DP route forced at this
    width: train_rbm_shard_map on the kernels launches cd_grads_wide's step
    and update once a step and no cd_grads kernel, matches its plain
    versions on the same hardened draws, and matches the single-device
    W-blocked kernel's run."""
    import torch.distributed as dist

    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    cfg = WIDE_CASES["bernoulli-pcd-k2"]
    assert K.select_dp_kernel(cfg) == "cd_grads_wide"
    st, data, order, u = _inputs(cfg, cuda, E=2, nb=6, wide=True)
    mesh = make_mesh(1, backend="nccl")
    try:
        du = {k: x[:, :, None] for k, x in u.items()}
        before = (W.cd_wide_step_launches, W.cd_wide_update_launches, G.cd_grads_launches,
                  G.cd_update_launches)
        a, ea = train_rbm_shard_map(st, data, cfg, mesh, 2, pallas_step=True, uniforms=du)
        torch.cuda.synchronize()
        assert (W.cd_wide_step_launches, W.cd_wide_update_launches, G.cd_grads_launches,
                G.cd_update_launches) == (before[0] + 12, before[1] + 12, *before[2:])
        b, eb = train_rbm_shard_map(st, data, cfg, mesh, 2, pallas_step=False, uniforms=du)
        p, v, chain, es = KW.cd_train_wide_run(cfg, st.params, st.velocity, st.chain_h, data,
                                               order, 0, u)
        for x, y, z in ((a.params.W, b.params.W, p.W), (a.params.c, b.params.c, p.c),
                        (a.velocity.W, b.velocity.W, v.W), (ea, eb, es)):
            torch.testing.assert_close(x, y, rtol=2e-4, atol=2e-6)
            torch.testing.assert_close(x, z, rtol=2e-4, atol=2e-6)
        torch.testing.assert_close(a.chain_h, b.chain_h, rtol=0, atol=0)
        torch.testing.assert_close(a.chain_h, chain, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


# the W-blocked route's captured epoch (parallel.dp.EpochSteps: step, all-gather,
# update from device table rows) on one NCCL rank against the same launches one
# at a time and against the kernel wrappers called step by step on the table's
# seeds: bit for bit, at odd and even nb, with a momentum schedule switching
# from 0 between epochs, PCD and bf16
WIDE_CAPTURE_CASES = {
    "cd1-nb4": (RBMConfig(**SMALL, visible="gaussian", lr=0.01, **MEANFIELD), 4),
    "pcd-k2-switch-from-0-nb3": (RBMConfig(**SMALL, lr=0.1, k=2, persistent=True,
                                           initial_momentum=0.0, momentum=0.5,
                                           momentum_switch_epoch=1, **MEANFIELD), 3),
    "bf16-pcd-momentum-nb3": (RBMConfig(**SMALL, lr=0.1, persistent=True, momentum=0.5,
                                        **MEANFIELD, **BF16), 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_CAPTURE_CASES))
def test_wide_dp_captured_epoch_equals_eager(cuda, monkeypatch, name):
    import torch.distributed as dist

    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W
    from mdbn_tpu_torch.parallel import dp
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    cfg, nb = WIDE_CAPTURE_CASES[name]
    cfg = cfg.replace(engine="pallas")
    assert K.select_dp_kernel(cfg) == "cd_grads_wide"
    E, B = 3, cfg.batch_size
    _, data, _, _ = _inputs(cfg, cuda, E=E, nb=nb, wide=True)
    mesh = make_mesh(1, backend="nccl")
    try:
        counts = lambda: (W.cd_wide_step_launches, W.cd_wide_update_launches,
                          G.cd_grads_launches, G.cd_update_launches)
        runs = []
        for capture in (True, False):  # each from the same state and generator
            before = counts()
            s2, errs = dp.train_rbm_shard_map(init_train_state(cfg, device=cuda), data, cfg,
                                              mesh, E, pallas_step=True, capture=capture)
            torch.cuda.synchronize()
            assert [a - b for a, b in zip(counts(), before)] == [E * nb, E * nb, 0, 0]
            runs.append((s2, errs))
        # the wrappers step by step on the seeds and minibatches of the tables
        st = init_train_state(cfg, device=cuda)
        order = K.batch_order(cfg, nb, E, st.generator).tolist()
        seeds = torch.randint(0, 2 ** 62, (E, nb), generator=st.generator).tolist()
        params, vel = st.params.map(torch.clone), st.velocity.map(torch.clone)
        chain, errs_w = st.chain_h.clone(), []
        batches = data[:nb * B].reshape(nb, B, -1)
        for e in range(E):
            step_errs = []
            for i, j in enumerate(order[e]):
                slot, chain = W.cd_wide_step(cfg, params, batches[j], chain,
                                             seed=dp.fold_in(seeds[e][i], 0), norm=float(B))
                params, vel, err = W.cd_wide_update(cfg, params, vel, batches[j], slot, 1,
                                                    1.0, e)
                step_errs.append(err)
            errs_w.append(torch.stack(step_errs).mean())
        torch.cuda.synchronize()
        (a, ea), (b, eb) = runs
        state = lambda p, v: list(p.as_dict().values()) + list(v.as_dict().values())
        for other, other_errs in (((b.params, b.velocity), eb),
                                  ((params, vel), torch.stack(errs_w))):
            for x, y in zip(state(a.params, a.velocity), state(*other)):
                assert torch.equal(x, y)
            assert torch.equal(ea, other_errs)
        assert torch.equal(a.chain_h, b.chain_h) and torch.equal(a.chain_h, chain)
        assert bool(torch.isfinite(ea).all()) and a.epoch == b.epoch == E
    finally:
        dist.destroy_process_group()


# the strip-split kernel of the estimator modes, csrc/cd_train_wide_modes.cu,
# against its plain version (cd_train_run_plain) under each mode and pt3_lv at
# both storage dtypes, at cd_train.cu's tolerances; one case spans three x W
# strips, several update units and a batch over 8. The cases of more than 64
# rows (a batch over 64, or a ladder of 3 x 32 and more) take x W over several
# row groups and h W^T over several passes of a segment; those where 2 B H
# floats pass the update's shared memory (24576 floats) read h0p and hmean
# from device memory instead of staging them (csrc/cd_train_wide_modes.cu:
# Args::hstaged); the last reaches the largest batch the kernel takes.
WM = "cd_train_wide_modes"
UNSTAGED = dict(visible="gaussian", lr=0.001, n_hidden=400)
WIDE_MODES_CASES = {
    "pt-gaussian-meanfield": RBMConfig(**SMALL, visible="gaussian", lr=0.005, persistent=True,
                                       pt_temps=3, pt_beta_min=0.3, momentum=0.5),
    "pt-bernoulli-k2": MODES["pt-bernoulli"],
    "pt-gaussian-sampled": MODES["pt-gaussian-sampled"],
    "enhanced-sparsity": MODES["enhanced-sparsity"],
    "enhanced-gaussian-three-strips": RBMConfig(n_visible=1100, n_hidden=72, batch_size=20,
                                                visible="gaussian", lr=0.005,
                                                gradient="enhanced", l2=1e-4, grad_clip=0.5),
    "learn-variance": MODES["learn-variance"],
    "learn-variance-meanfield-pcd": MODES["learn-variance-meanfield-pcd"],
    "pt3-lv": MODES["pt-learn-variance"],
    "bf16-pt-gaussian": RBMConfig(**SMALL, visible="gaussian", lr=0.005, persistent=True,
                                  pt_temps=3, pt_beta_min=0.3, **BF16),
    "bf16-pt-bernoulli": BF16_CASES["pt"],
    "bf16-enhanced": BF16_CASES["enhanced"],
    "bf16-learn-variance": BF16_CASES["learn-variance"],
    "bf16-pt3-lv": RBMConfig(**SMALL, visible="gaussian", lr=0.005, persistent=True,
                             pt_temps=3, pt_beta_min=0.3, learn_variance=True, momentum=0.5,
                             **BF16),
    "pt3-gaussian-ladder-96": RBMConfig(n_visible=600, n_hidden=96, batch_size=32,
                                        visible="gaussian", lr=0.002, persistent=True,
                                        pt_temps=3, pt_beta_min=0.3),
    "enhanced-batch-96-unstaged": RBMConfig(n_visible=1100, batch_size=96,
                                            gradient="enhanced", l2=1e-4, grad_clip=0.5,
                                            **UNSTAGED),
    "learn-variance-batch-80-unstaged": RBMConfig(n_visible=600, batch_size=80,
                                                  learn_variance=True, momentum=0.5,
                                                  **dict(UNSTAGED, n_hidden=200)),
    "bf16-pt3-lv-ladder-96-unstaged": RBMConfig(n_visible=1100, batch_size=32,
                                                persistent=True, pt_temps=3, pt_beta_min=0.3,
                                                learn_variance=True, **UNSTAGED, **BF16),
    "pt3-enhanced-bernoulli-batch-256": RBMConfig(n_visible=600, n_hidden=64, batch_size=256,
                                                  lr=0.05, persistent=True, pt_temps=3,
                                                  pt_beta_min=0.3, gradient="enhanced"),
}


def _wide_modes_counts():
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    return (WMC.cd_train_wide_modes_launches, K.cd_train_launches,
            KW.cd_train_wide_launches, R.cd_train_resident_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WIDE_MODES_CASES))
def test_wide_modes_kernel_matches_plain_inject(cuda, name):
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    cfg = WIDE_MODES_CASES[name]
    assert K.wide_modes_unsupported(cfg) is None
    st, data, order, u = _inputs(cfg, cuda)
    before = _wide_modes_counts()
    got = K.kernel_run(WM)(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert _wide_modes_counts() == (before[0] + 1, *before[1:])
    assert got[0].W.dtype == got[2].dtype == st.params.W.dtype
    _check(got, K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                     u))
    assert WMC.cd_train_wide_modes_run is K.kernel_run(WM)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pt-bernoulli-k2", "enhanced-gaussian-three-strips",
                                  "learn-variance", "pt3-lv", "bf16-pt-gaussian",
                                  "enhanced-batch-96-unstaged",
                                  "bf16-pt3-lv-ladder-96-unstaged",
                                  "pt3-enhanced-bernoulli-batch-256"])
def test_wide_modes_kernel_is_grid_independent_and_trains(cuda, name):
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    cfg = WIDE_MODES_CASES[name]
    st, data, order, _ = _inputs(cfg, cuda, E=4)
    trace = [torch.zeros((4, 6, WMC.wide_modes_trace_len(cfg)), dtype=torch.int64,
                         device=cuda) for _ in range(4)]
    runs = [WMC.cd_train_wide_modes_run(cfg, st.params, st.velocity, st.chain_h, data, order,
                                        0, None, torch.Generator().manual_seed(3), grid=g,
                                        trace=tr)
            for g, tr in zip((1, 7, 132, 0), trace)]
    for r in runs[1:]:
        for part in (0, 1):
            for n in ("W", "b", "c", "z"):
                if getattr(r[part], n) is not None:
                    torch.testing.assert_close(getattr(r[part], n),
                                               getattr(runs[0][part], n), rtol=0, atol=0)
        torch.testing.assert_close(r[2], runs[0][2], rtol=0, atol=0)
        torch.testing.assert_close(r[3], runs[0][3], rtol=0, atol=0)
    for tr in trace:
        assert bool((tr.diff(dim=2) >= 0).all()) and bool((tr > 0).all())
    assert all(np.isfinite(runs[0][3].tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pt-gaussian-meanfield", "learn-variance-meanfield-pcd"])
def test_wide_modes_kernel_draws_as_cd_train_from_one_seed(cuda, name):
    """cd_train.cu and the strip-split kernel share the Philox keying: one
    seed gives the same samples, and the runs agree at cd_train.cu's
    tolerance."""
    cfg = WIDE_MODES_CASES[name]
    st, data, order, _ = _inputs(cfg, cuda)
    a, b = (K.kernel_run(kern)(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                               torch.Generator().manual_seed(5)) for kern in ("cd_train", WM))
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    _check(b, a)


@pytest.mark.cuda
def test_wide_modes_kernel_raises_outside_its_scope(cuda):
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    cfg = WIDE_MODES_CASES["enhanced-sparsity"]
    st, data, order, _ = _inputs(cfg, cuda)
    before = _wide_modes_counts()
    for outside, what in ((cfg.replace(gradient="plain"), "plain estimator"),
                          (cfg.replace(error_metric="pseudo"), "pseudo"),
                          (cfg.replace(batch_size=640), "batch")):
        with pytest.raises(ValueError, match=what):
            WMC.cd_train_wide_modes_run(outside, st.params, st.velocity, st.chain_h, data,
                                        order, 0, None, torch.Generator())
    with pytest.raises(ValueError, match="CUDA tensors"):
        WMC.cd_train_wide_modes_run(cfg, st.params, st.velocity, st.chain_h, data.cpu(),
                                    order, 0, None, torch.Generator())
    with pytest.raises(RuntimeError, match="cudaError"):
        WMC.cd_train_wide_modes_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                    None, torch.Generator(), grid=1 << 20)
    assert _wide_modes_counts() == before



# the resident kernel's estimator modes (csrc/cd_train_resident.cu, its kModes
# variant) against cd_train_run_plain on hardened draws: cd_train.cu's mode
# cases and the bf16 ones over whole 2-epoch runs at their tolerances (TOL,
# BF16_TOL), with cases over 13 strips of 4 ranks (CLUSTERED) and the odd
# 301x77 shape; at the smoke's full widths (pt5 at 784x500, learned variance
# at 2000x200) one update at a time at REPLAY_TOL, bf16 to one ulp
RESIDENT_MODES = {
    **MODES,
    "bf16-pt-bernoulli": BF16_CASES["pt"],
    "bf16-enhanced": BF16_CASES["enhanced"],
    "bf16-learn-variance": BF16_CASES["learn-variance"],
    "bf16-pt3-lv": WIDE_MODES_CASES["bf16-pt3-lv"],
    "pt3-clustered-pcd-k2": RBMConfig(**CLUSTERED, lr=0.05, k=2, persistent=True, pt_temps=3,
                                      pt_beta_min=0.3, momentum=0.5),
    "enhanced-pseudo-clustered-pcd": RBMConfig(**CLUSTERED, lr=0.05, gradient="enhanced",
                                               error_metric="pseudo", persistent=True,
                                               momentum=0.5, sparsity_target=0.1,
                                               sparsity_cost=0.5),
    "lv-odd-13-clusters": RBMConfig(n_visible=301, n_hidden=77, batch_size=13,
                                    visible="gaussian", lr=0.005, learn_variance=True,
                                    momentum=0.5),
    "enhanced-wide-tile-64x4352-b4": RBMConfig(n_visible=64, n_hidden=4352, batch_size=4,
                                               lr=0.05, gradient="enhanced", momentum=0.5),
}
FULL_WIDTH = {
    "pt5": RBMConfig(n_visible=784, n_hidden=500, batch_size=20, k=1, lr=0.1, persistent=True,
                     pt_temps=5, pt_beta_min=0.2),
    "lv": RBMConfig(n_visible=2000, n_hidden=200, batch_size=20, visible="gaussian",
                    learn_variance=True, lr=0.005),
    "pt5-bf16": RBMConfig(n_visible=784, n_hidden=500, batch_size=20, k=1, lr=0.1,
                          persistent=True, pt_temps=5, pt_beta_min=0.2, **BF16),
    "lv-bf16": RBMConfig(n_visible=2000, n_hidden=200, batch_size=20, visible="gaussian",
                         learn_variance=True, lr=0.005, **BF16),
}


def _resident_counts():
    return R.cd_train_resident_launches, K.cd_train_launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RESIDENT_MODES))
def test_resident_modes_kernel_matches_plain_inject(cuda, name):
    cfg = RESIDENT_MODES[name]
    assert K.select_kernel(cfg) == "cd_train_resident" and R.has_modes(cfg)
    st, data, order, u = _inputs(cfg, cuda)
    before = _resident_counts()
    got = R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert _resident_counts() == (before[0] + 1, before[1])
    assert got[0].W.dtype == got[2].dtype == st.params.W.dtype
    _check(got, K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                     u))


def _within_one_ulp(got, want):
    """bf16 state: a velocity within one bf16 ulp of the plain one, a
    parameter within its own ulp and its velocity's (each side rounds one
    float32 result once), beside atol."""
    for n in ("W", "b", "c", "z"):
        if getattr(want[0], n) is None:
            continue
        for i in (1, 0):
            a, b = getattr(got[i], n).float(), getattr(want[i], n).float()
            big = torch.maximum(a.abs(), b.abs())
            if i == 0:
                big = big + torch.maximum(getattr(got[1], n).float().abs(),
                                          getattr(want[1], n).float().abs())
            assert bool(((a - b).abs() <= big * 2.0 ** -7 + REPLAY_TOL["atol"]).all()), n


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_resident_modes_replayed_one_update_at_a_time(cuda, name):
    """The smoke's full-width pt5 and lv, each update from the kernel's own
    state on draws hardened against that state, at REPLAY_TOL (bf16: one
    ulp); the chain's samples identical."""
    cfg = FULL_WIDTH[name]
    assert K.select_kernel(cfg) == "cd_train_resident"
    st, data, _, u = _inputs(cfg, cuda, E=1, nb=3)
    p, v, chain = st.params, st.velocity, st.chain_h
    one = torch.zeros((1, 1), dtype=torch.int32)
    B = cfg.batch_size
    for i in range(3):
        d = data[i * B:(i + 1) * B]
        ui = K.harden_uniform_blocks(cfg, p, v, chain, d,
                                     {k: x[:, i:i + 1] for k, x in u.items()}, 1)
        got = R.cd_train_resident_run(cfg, p, v, chain, d, one, 0, ui)
        want = K.cd_train_run_plain(cfg, p, v, chain, d, one, 0, ui)
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
        torch.testing.assert_close(got[3], want[3], **REPLAY_TOL)
        if cfg.param_dtype == "bfloat16":
            _within_one_ulp(got, want)
        else:
            for part in (0, 1):
                for n in ("W", "b", "c", "z"):
                    if getattr(want[part], n) is not None:
                        torch.testing.assert_close(getattr(got[part], n),
                                                   getattr(want[part], n), **REPLAY_TOL)
        p, v, chain = got[:3]


def _fewest_clusters(cfg) -> int:
    """The smallest cluster count whose strips fit a block."""
    tiles = R.resident_tiles(cfg)
    for n in range(1, tiles.clusters + 1):
        try:
            R.resident_tiles(cfg, clusters=n)
            return n
        except ValueError:
            continue
    raise AssertionError("no cluster count holds the tiles")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pt3-clustered-pcd-k2", "enhanced-pseudo-clustered-pcd",
                                  "lv-odd-13-clusters", "bf16-pt3-lv",
                                  "enhanced-wide-tile-64x4352-b4"])
def test_resident_modes_bits_on_two_cluster_counts(cuda, name):
    """The default cluster count and the smallest that holds the tiles give
    the same bits (seeded draws, 3 epochs); the traces rise."""
    cfg = RESIDENT_MODES[name]
    counts = (0, _fewest_clusters(cfg))
    st, data, order, _ = _inputs(cfg, cuda, E=3)
    trace = [torch.zeros((3, 6, R.resident_trace_len(cfg)), dtype=torch.int64, device=cuda)
             for _ in counts]
    runs = [R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                    None, torch.Generator().manual_seed(3), grid=g, trace=tr)
            for g, tr in zip(counts, trace)]
    for part in (0, 1):
        for n in ("W", "b", "c", "z"):
            if getattr(runs[0][part], n) is not None:
                torch.testing.assert_close(getattr(runs[1][part], n),
                                           getattr(runs[0][part], n), rtol=0, atol=0)
    torch.testing.assert_close(runs[1][2], runs[0][2], rtol=0, atol=0)
    torch.testing.assert_close(runs[1][3], runs[0][3], rtol=0, atol=0)
    for tr in trace:
        assert bool((tr.diff(dim=2) >= 0).all()) and bool((tr > 0).all())
    assert all(np.isfinite(runs[0][3].tolist()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pt-gaussian-sampled", "learn-variance-meanfield-pcd",
                                  "pseudo-pt-enhanced", "enhanced-sparsity"])
def test_resident_modes_draw_as_cd_train_from_one_seed(cuda, name):
    """cd_train.cu and the resident kernel share the Philox keying, swap
    draws included: one seed gives the same samples, and the runs agree at
    cd_train.cu's tolerance."""
    cfg = RESIDENT_MODES[name]
    st, data, order, _ = _inputs(cfg, cuda)
    a, b = (K.kernel_run(kern)(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                               torch.Generator().manual_seed(5))
            for kern in ("cd_train", "cd_train_resident"))
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    _check(b, a)


# k = 300, past the 255 Gibbs steps the Philox counter word once held
# (cd_common.cuh::draw_bits): each of the six kernel sources against its plain
# version on hardened injected draws over 2 epochs (the DP kernels one step),
# at a shape each admits; the wide kernels are called directly, as the
# admission rule does not pick them at these widths. Then the seeded draws:
# cd_train.cu and the resident kernel key Philox alike, so one seed gives the
# same run on both at k = 300, as at k = 1.
K300 = {
    "cd_train-pcd-momentum": ("cd_train", RBMConfig(**SMALL, k=300, persistent=True,
                                                    momentum=0.5, lr=0.1)),
    "resident-plain-gaussian": ("cd_train_resident",
                                RBMConfig(**SMALL, k=300, visible="gaussian", lr=0.01)),
    "resident-modes-enhanced": ("cd_train_resident",
                                RBMConfig(**SMALL, k=300, gradient="enhanced", lr=0.1)),
    "resident-ladder-pt3": ("cd_train_resident",
                            RBMConfig(**SMALL, k=300, persistent=True, pt_temps=3,
                                      pt_beta_min=0.3, lr=0.1)),
    "wide-gaussian-meanfield": ("cd_train_wide",
                                RBMConfig(**SMALL, k=300, visible="gaussian", lr=0.01,
                                          **MEANFIELD)),
    "wide-modes-lv": (WM, RBMConfig(**SMALL, k=300, visible="gaussian", lr=0.005,
                                    learn_variance=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K300))
def test_k300_train_kernels_match_plain_inject(cuda, name):
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    kernel, cfg = K300[name]
    wide = kernel == "cd_train_wide"
    st, data, order, u = _inputs(cfg, cuda, nb=3, wide=wide)
    counter = {"cd_train": (K, "cd_train_launches"),
               "cd_train_resident": (R, "cd_train_resident_launches"),
               "cd_train_wide": (KW, "cd_train_wide_launches"),
               WM: (WMC, "cd_train_wide_modes_launches")}[kernel]
    before = getattr(*counter)
    got = K.kernel_run(kernel)(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 1
    plain = KW.cd_train_wide_run_plain if wide else K.cd_train_run_plain
    _check(got, plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u))


@pytest.mark.cuda
def test_k300_dp_kernels_match_plain(cuda):
    """cd_grads.cu's step on a 7-row shard with a pad row and its update on 3
    ranks' sums, and cd_grads_wide.cu's step, at k = 300."""
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W
    from mdbn_tpu_torch.parallel.dp import world_scale

    cfg = RBMConfig(**{**SMALL, "batch_size": 7}, k=300, persistent=True, lr=0.1)
    p, v0, chain, mask, u = _mode_inputs(cfg, cuda)
    got = G.cd_grads_step(cfg, p, v0, chain, uniforms=u, mask=mask, norm=20 / 3)
    want = G.cd_grads_step_plain(cfg, p, v0, chain, uniforms=u, mask=mask, norm=20 / 3)
    for a, b in ((got[0].W, want[0].W), (got[0].b, want[0].b), (got[0].c, want[0].c),
                 (got[2], want[2])):
        torch.testing.assert_close(a, b, **REPLAY_TOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    gen = torch.Generator(device=cuda).manual_seed(4)
    rand = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=cuda)
    V, H = cfg.n_visible, cfg.n_hidden
    p, vel = (RBMParams(W=rand(V, H), b=rand(V), c=rand(H)) for _ in range(2))
    sums = 3 * rand(G.flat_size(cfg))
    want = G.cd_update_plain(cfg, p, vel, sums, world_scale(3), 0)
    got = G.cd_update(cfg, p.map(torch.clone), vel.map(torch.clone), sums, world_scale(3), 0)
    for a, b in zip(list(got[0].as_dict().values()) + list(got[1].as_dict().values()),
                    list(want[0].as_dict().values()) + list(want[1].as_dict().values())):
        assert torch.equal(a, b)
    wcfg = RBMConfig(**{**SMALL, "batch_size": 7}, k=300, visible="gaussian", lr=0.01,
                     **MEANFIELD)
    p, v0, chain, u = _wide_dp_inputs(wcfg, 6, cuda)
    before = W.cd_wide_step_launches
    got, c_got = W.cd_wide_step(wcfg, p, v0, chain, uniforms=u, n_valid=6, norm=20 / 3)
    torch.cuda.synchronize()
    assert W.cd_wide_step_launches == before + 1
    want, c_want = W.cd_wide_step_plain(wcfg, p, v0, chain, uniforms=u, n_valid=6, norm=20 / 3)
    for a, b in zip(W.slot_views(wcfg, got), W.slot_views(wcfg, want)):
        torch.testing.assert_close(a, b, **REPLAY_TOL)
    torch.testing.assert_close(c_got, c_want, rtol=0, atol=0)


@pytest.mark.cuda
def test_k300_seeded_draws_alike_and_train_takes_the_kernel(cuda):
    from mdbn_tpu_torch import RBM

    cfg = RBMConfig(**SMALL, k=300, persistent=True, lr=0.1)
    st, data, order, _ = _inputs(cfg, cuda, E=1, nb=1)  # one update: few knife-edge draws
    runs = [K.kernel_run(name)(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                               torch.Generator().manual_seed(5))
            for name in ("cd_train", "cd_train_resident")]
    torch.testing.assert_close(runs[1][2], runs[0][2], rtol=0, atol=0)
    torch.testing.assert_close(runs[1][0].W, runs[0][0].W, **TOL)
    before = R.cd_train_resident_launches
    rbm = RBM(cfg.replace(engine="pallas", epochs=2), device=cuda).train(data)
    assert rbm.metrics.kernel == K.select_kernel(cfg) == "cd_train_resident"
    assert R.cd_train_resident_launches == before + 1


# -- the phase-2 trainers on the card against the CPU -----------------------------------
#
# No kernel of their own (the reference runs them as plain XLA): each trainer's
# eager loop on the card against the same call on the CPU, fed the draws the
# CPU run made (the trainers write what they draw into the empty dicts they are
# given), TF32 off, at TOL over 2 epochs of 3 minibatches.

FT_TRAINERS = ("finetune_stack", "autoencoder_stack", "label_top", "updown_stack",
               "updown_labeled", "finetune_mdbn", "autoencoder_mdbn", "updown_mdbn",
               "updown_mdbn_labeled")


def _ft_call(name: str, device, draws):
    """Trainer ``name`` on fixed weights and data made from a seed, on
    ``device``; the tensors and floats it returns, flattened."""
    from mdbn_tpu_torch.config import DBNConfig
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.train import autoencoder, finetune, labeled, updown

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731

    def params(V, H):
        return RBMParams(W=f32(rng.normal(0, 0.5, (V, H))), b=f32(rng.normal(0, 0.3, V)),
                         c=f32(rng.normal(0, 0.3, H)))

    def stack(sizes, visible):
        cfg = DBNConfig(layer_sizes=list(sizes[1:]), visible=visible, batch_size=10)
        return [(params(v, h), cfg.rbm_config(l, v))
                for l, (v, h) in enumerate(zip(sizes, sizes[1:]))]

    layers = stack((40, 24, 12), "bernoulli")
    x = (rng.random((30, 40)) < 0.4).astype(np.float32)
    y = rng.integers(0, 3, 30)
    y_semi = np.where(rng.random(30) < 0.5, -1, y)
    towers = {"ge": stack((40, 24, 12), "gaussian"), "meth": stack((20, 10), "gaussian")}
    joint = (params(22, 16), RBMConfig(n_visible=22, n_hidden=16, batch_size=10))
    mods = {"ge": rng.normal(size=(30, 40)).astype(np.float32),
            "meth": rng.normal(size=(30, 20)).astype(np.float32)}
    kw = dict(epochs=2, batch_size=10)
    calls = {
        "finetune_stack": lambda: finetune.finetune_stack(layers, x, y, 3, **kw, draws=draws),
        "autoencoder_stack": lambda: autoencoder.finetune_autoencoder_stack(layers, x, **kw),
        "label_top": lambda: labeled.fit_label_top(layers, x, y_semi, 3, n_hidden=9, k=2,
                                                   momentum=0.5, **kw, draws=draws),
        "updown_stack": lambda: updown.finetune_updown_stack(layers, x, lr=0.05, **kw,
                                                             draws=draws),
        "updown_labeled": lambda: updown.finetune_updown_labeled(
            layers, params(15, 7), x, y_semi, 3, lr=0.05, **kw, draws=draws),
        "finetune_mdbn": lambda: finetune.finetune_mdbn(towers, joint, mods, y, 3, **kw,
                                                        draws=draws),
        "autoencoder_mdbn": lambda: autoencoder.finetune_autoencoder_mdbn(towers, joint, mods,
                                                                          **kw),
        "updown_mdbn": lambda: updown.finetune_updown_mdbn(towers, joint, mods, lr=0.05, **kw,
                                                           draws=draws),
        "updown_mdbn_labeled": lambda: updown.finetune_updown_mdbn_labeled(
            towers, joint, params(19, 8), mods, y_semi, 3, lr=0.05, **kw, draws=draws),
    }

    def flat(obj):
        if isinstance(obj, RBMParams):
            return list(obj.as_dict().values())
        if isinstance(obj, dict):
            return [t for k in obj for t in flat(obj[k])]
        if isinstance(obj, (list, tuple)):
            return [t for o in obj for t in flat(o)]
        if torch.is_tensor(obj):
            return [obj]
        return [torch.tensor(obj, dtype=torch.float32)]  # a loss: on the host

    return flat(calls[name]())


@pytest.mark.cuda
@pytest.mark.parametrize("name", FT_TRAINERS)
def test_phase2_trainer_on_card_matches_cpu(cuda, name):
    assert not torch.backends.cuda.matmul.allow_tf32
    draws = {"steps": [[{} for _ in range(3)] for _ in range(2)]}
    want = _ft_call(name, torch.device("cpu"), draws)
    got = _ft_call(name, cuda, draws)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dim() == 0 or g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), w, **TOL)


AIS_PATHS = ("bernoulli", "bernoulli_smc", "gaussian_z_smc", "labeled")


def _ais_inputs(path, device):
    """A small model's parameters and base biases on ``device``."""
    from mdbn_tpu_torch.core.rbm_math import RBMParams

    rng = np.random.default_rng(3)
    V = 12 if path != "labeled" else 8 + 3
    p = {"W": (rng.standard_normal((V, 8)) * 0.8).astype(np.float32),
         "b": (rng.standard_normal(V) * 0.2).astype(np.float32),
         "c": (rng.standard_normal(8) * 0.2).astype(np.float32)}
    if path.startswith("gaussian"):
        p["z"] = (rng.standard_normal(V) * 0.3).astype(np.float32)
    return RBMParams(**{k: torch.tensor(v, device=device) for k, v in p.items()}), \
        torch.zeros(V, device=device)


def _ais_call(path, params, base, draws):
    """One AIS anneal of a small model: (log_z, logw)."""
    from mdbn_tpu_torch.analysis import ais

    ess = 0.9 if path.endswith("smc") else 0.0
    kw = dict(seed=0, n_chains=32, n_betas=40, draws=draws)
    if path == "labeled":
        return ais.ais_log_z_labeled(params, base, 8, **kw)
    if path.startswith("gaussian"):
        return ais.ais_log_z_gaussian(params, base, resample_ess=ess, **kw)
    return ais.ais_log_z(params, base, resample_ess=ess, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("path", AIS_PATHS)
def test_ais_on_card_matches_cpu_without_sync(cuda, path):
    """An anneal on the card issues no synchronising call (sync debug mode
    "error"), keeps every tensor on the card, and equals the CPU's replay of
    the draws it recorded."""
    assert not torch.backends.cuda.matmul.allow_tf32
    draws = {}
    params, base = _ais_inputs(path, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _ais_call(path, params, base, draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    recorded = [t for k, t in draws.items() if k != "steps"]
    recorded += [t for st in draws["steps"] for t in st.values()]
    assert all(t.device.type == "cuda" for t in list(got) + recorded)
    want = _ais_call(path, *_ais_inputs(path, torch.device("cpu")), draws)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, **TOL)

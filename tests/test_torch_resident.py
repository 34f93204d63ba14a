"""The resident kernel's admission and layout on the CPU (csrc/cd_train_resident.cu).

Which kernel ``ops.cd_epoch_cuda.select_kernel`` gives each layer of the
graded configs, the estimator modes, a run one step past the shared-memory
fit and the wide slice; the tiling and fit of ``resident_tiles``; the
wrapper's refusal of CPU tensors; the eager engine on the CPU. The kernel
itself runs only on the card (tests/test_torch_cuda.py). Its plain version
is ``cd_train_run_plain``, held against the interpret-mode Pallas kernel in
tests/test_torch_cd_epoch.py and, through the trainer's eager engine, here.
JAX only in that last test: a few seconds on one core.
"""

import os

import numpy as np
import pytest
import torch

from mdbn_tpu_torch import RBM
from mdbn_tpu_torch.config import RBMConfig, load_config
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.data.synthetic import mnist_like
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
TCGA = {"ge": 2000, "meth": 1500, "mirna": 500}  # data/synthetic.py::tcga_like's widths
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def graded_layers():
    """name -> the RBMConfig of every layer the graded configs c1-c5 train."""
    out = {"c1": load_config(os.path.join(CONFIGS, "c1_bernoulli_rbm_mnist.json"))["model"],
           "c2": load_config(os.path.join(CONFIGS, "c2_gaussian_rbm_ge.json"))["model"]}
    c3 = load_config(os.path.join(CONFIGS, "c3_dbn_3layer.json"))["model"]
    v = TCGA["ge"]
    for i, h in enumerate(c3.layer_sizes):
        out[f"c3.{i}"] = c3.rbm_config(i, v)
        v = h
    for name in ("c4_mdbn_3modality", "c5_pcd_kmeans"):
        m = load_config(os.path.join(CONFIGS, f"{name}.json"))["model"]
        top = 0
        for mod, tower in m.towers.items():
            v = TCGA[mod]
            for i, h in enumerate(tower.layer_sizes):
                out[f"{name[:2]}.{mod}.{i}"] = tower.rbm_config(i, v)
                v = h
            top += v
        out[f"{name[:2]}.joint"] = m.joint.replace(n_visible=top, visible="bernoulli")
    return out


LAYERS = graded_layers()


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_graded_layers_take_the_resident_kernel(name, storage):
    cfg = LAYERS[name]
    if storage == "bfloat16":
        cfg = cfg.replace(**BF16)
    assert R.resident_tiles(cfg).fits
    assert K.select_kernel(cfg) == "cd_train_resident"


def test_graded_layer_count():
    # c1, c2, c3's three layers, c4's and c5's six tower layers and joint RBM
    assert len(LAYERS) == 1 + 1 + 3 + 7 + 7
    c5 = [c for n, c in LAYERS.items() if n.startswith("c5")]
    assert all(c.persistent and c.k == 2 and c.momentum == 0.5 and c.l2 == 1e-4 for c in c5)


MODES = {
    "tempering": dict(persistent=True, pt_temps=3, pt_beta_min=0.3),
    "enhanced": dict(gradient="enhanced"),
    "learned-variance": dict(visible="gaussian", learn_variance=True),
    "pseudo": dict(error_metric="pseudo"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_estimator_modes_take_the_resident_kernel(mode):
    """Each estimator mode takes the resident kernel at c1's shape (f32 and
    bf16 storage) and stays on cd_train.cu only where its tiles do not fit
    (a batch of 512 rows here)."""
    cfg = LAYERS["c1"].replace(**MODES[mode])
    assert R.has_modes(cfg)
    assert K.select_kernel(cfg) == "cd_train_resident"
    assert K.select_kernel(cfg.replace(**BF16)) == "cd_train_resident"
    past = cfg.replace(batch_size=512)
    assert not R.resident_tiles(past).fits
    assert K.select_kernel(past) == "cd_train"


def test_k_past_the_philox_layout_stays_on_cd_train():
    """Past 255 Gibbs steps the Philox counter still holds each step's draws
    (cd_common.cuh::draw_bits): c1 at k 256 and 300 takes the resident
    kernel, as at k 1."""
    for k in (256, 300):
        cfg = LAYERS["c1"].replace(k=k)
        assert R.resident_admits(cfg)
        assert K.select_kernel(cfg) == "cd_train_resident"


@pytest.mark.parametrize("grow", ["n_hidden", "n_visible", "batch_size"])
def test_one_step_past_the_fit_takes_cd_train(grow):
    """Grow c1 along one dimension until the tiles no longer fit an H100's
    shared memory: the last size that fits takes the resident kernel, the
    next one cd_train.cu."""
    cfg = LAYERS["c1"]
    size = getattr(cfg, grow)
    while R.resident_tiles(cfg.replace(**{grow: size + 1})).fits:
        size += 1
    fits, past = cfg.replace(**{grow: size}), cfg.replace(**{grow: size + 1})
    # every smaller size fits too (c1's batches up to 64)
    assert all(R.resident_tiles(cfg.replace(**{grow: n})).fits for n in range(1, size + 1))
    assert K.select_kernel(fits) == "cd_train_resident"
    assert not R.resident_tiles(past).fits
    assert R.resident_tiles(past).smem_bytes > R.H100_SMEM_PER_BLOCK
    assert K.select_kernel(past) == "cd_train"


def test_wide_rows_keep_the_w_blocked_kernel():
    w20k = RBMConfig(n_visible=20000, n_hidden=400, visible="gaussian", lr=0.001,
                     batch_size=20)
    assert K.select_kernel(w20k) == "cd_train_wide"
    assert K.select_kernel(w20k.replace(momentum=0.5, **BF16)) == "cd_train_wide"
    # below the W-blocked kernel's width, an in-scope run takes the resident
    # kernel where it fits
    assert K.select_kernel(w20k.replace(n_visible=K.WIDE_MIN_VISIBLE - 1)) in (
        "cd_train_resident", "cd_train")
    assert K.select_kernel(w20k.replace(n_visible=2000)) == "cd_train_resident"


def test_resident_tiles_c1():
    t = R.resident_tiles(LAYERS["c1"])
    assert (t.rows, t.cols, t.strips, t.ranks) == (56, 64, 14, 8)
    assert t.strips * t.rows >= 784 > (t.strips - 1) * t.rows
    assert t.ranks * t.cols >= 500 > (t.ranks - 1) * t.cols
    assert (t.clusters, t.strips_per_cluster, t.fits) == (14, 1, True)
    assert t.smem_bytes == R.smem_bytes(LAYERS["c1"], 1) <= R.H100_SMEM_PER_BLOCK


def test_tiles_wider_than_the_block_are_admitted():
    """Past 4096 hidden units a column tile has more columns than the block
    has threads (the kernel's loops over a tile's columns stride by the
    block); such a run is admitted where it fits: 64x4352 at batch 4 (tiles
    of 544 columns), not at batch 20."""
    cfg = RBMConfig(n_visible=64, n_hidden=4352, batch_size=4, lr=0.05)
    t = R.resident_tiles(cfg)
    assert (t.rows, t.cols, t.strips, t.ranks) == (8, 544, 8, 8)
    assert t.cols > R.THREADS and t.fits
    assert K.select_kernel(cfg) == "cd_train_resident"
    assert K.select_kernel(cfg.replace(persistent=True, momentum=0.5)) == "cd_train_resident"
    assert not R.resident_tiles(cfg.replace(batch_size=20)).fits
    assert K.select_kernel(cfg.replace(batch_size=20)) == "cd_train"


def test_resident_tiles_depend_on_the_shape_alone():
    cfg = LAYERS["c2"]
    a = R.resident_tiles(cfg, max_clusters=15)
    b = R.resident_tiles(cfg, max_clusters=8)
    assert (a.rows, a.cols, a.strips, a.ranks) == (b.rows, b.cols, b.strips, b.ranks)
    assert (a.strips_per_cluster, b.strips_per_cluster) == (1, 2)
    assert not b.fits  # two of c2's strips do not fit one block


def test_resident_tiles_refuse_a_grid_too_small_or_too_large():
    cfg = LAYERS["c1"]
    assert R.resident_tiles(cfg, clusters=7).strips_per_cluster == 2
    with pytest.raises(ValueError, match="too few"):
        R.resident_tiles(cfg, clusters=1)
    with pytest.raises(ValueError, match="clusters"):
        R.resident_tiles(cfg, clusters=15)  # more clusters than strips
    with pytest.raises(ValueError, match="clusters"):
        R.resident_tiles(cfg, max_clusters=4, clusters=5)  # more than the card holds
    assert not R.resident_tiles(cfg, max_clusters=0).fits


def test_split_for_shortens_the_longest_walk():
    # c1's hidden products: one 64-column warp unit x 5 row tiles over 16
    # warps, 14 groups of 4 rows: 3 chunks give one round of 5 groups
    assert R.split_for(5, 16, 14, R.MAX_SPLIT) == 3
    assert R.split_for(16, 16, 14, R.MAX_SPLIT) == 1
    # its visible products: one 64-row warp unit x 5 row tiles, 16 groups of
    # 4 columns: two chunks halve the walk
    assert R.split_for(5, 16, 16, R.MAX_VSPLIT) == 2
    # c2's: 3 x 5 units; two chunks would take two rounds of 8, no shorter
    assert R.split_for(15, 16, 16, R.MAX_VSPLIT) == 1


def test_trace_counts_the_barriers():
    for k in (1, 2, 3):
        cfg = LAYERS["c1"].replace(k=k)
        phases = R.resident_trace_phases(cfg)
        assert R.resident_trace_len(cfg) == len(phases) + 1 == 6 * k + 5
        assert sum(p.endswith(":tile_barrier") for p in phases) == k + 1
        assert sum(p.endswith(":cluster_barrier") for p in phases) == k


def test_wrapper_refuses_cpu_tensors():
    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=4)
    st = init_train_state(cfg, device="cpu")
    data = torch.as_tensor(mnist_like(16, n_features=16, seed=0))
    order = K.batch_order(cfg, 4, 1, None)
    before = R.cd_train_resident_launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        R.cd_train_resident_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0,
                                None, torch.Generator())
    assert R.cd_train_resident_launches == before
    assert K.kernel_run("cd_train_resident") is R.cd_train_resident_run
    with pytest.raises(ValueError, match="no kernel"):
        K.kernel_run("cd_train_fast")


def test_xla_engine_on_the_cpu_is_the_plain_run():
    """RBM.train(engine="xla") on the CPU runs cd_train_run_plain, as before
    the resident kernel: the same parameters, bit for bit, as calling it from
    the same state and generator. And that eager run, through the trainer on
    injected draws, matches the JAX package's train kernel in the TPU
    interpreter (``make_pallas_train_fn(..., interpret=True, inject=True)``)
    on the same numpy inputs, at tests/test_torch_cd_epoch.py's tolerance."""
    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=10, epochs=2, engine="xla",
                    persistent=True, k=2, momentum=0.5)
    data = mnist_like(40, n_features=16, seed=1)
    rbm = RBM(cfg, generator=torch.Generator().manual_seed(5), device="cpu").train(data)
    assert (rbm.metrics.engine, rbm.metrics.kernel) == ("eager", "cd_train")
    st = init_train_state(cfg, generator=torch.Generator().manual_seed(5), device="cpu")
    order = K.batch_order(cfg, 4, 2, st.generator)
    p, v, chain, errs = K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h,
                                             torch.as_tensor(data), order, 0, None,
                                             st.generator)
    torch.testing.assert_close(rbm.params.W, p.W, rtol=0, atol=0)
    torch.testing.assert_close(rbm.state.chain_h, chain, rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(rbm.history, np.float32), errs.numpy())

    import jax.numpy as jnp
    from mdbn_tpu.config import RBMConfig as JaxRBMConfig
    from mdbn_tpu.core.rbm_math import RBMParams as JaxParams
    from mdbn_tpu.core.state import TrainState
    from mdbn_tpu.ops.cd_epoch_pallas import make_pallas_train_fn

    from mdbn_tpu_torch.convert import convert_config, state_from_numpy
    from mdbn_tpu_torch.train.trainer import train_rbm

    E, nb, rng = 2, 4, np.random.default_rng(11)
    jcfg = JaxRBMConfig(n_visible=16, n_hidden=8, batch_size=4, epochs=E, k=2,
                        persistent=True, momentum=0.5, l2=1e-3, lr=0.1)
    V, H, B = jcfg.n_visible, jcfg.n_hidden, jcfg.batch_size
    x = (rng.random((nb * B, V)) < 0.3).astype(np.float32)
    W = (rng.standard_normal((V, H)) * 0.01).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    c = (rng.standard_normal(H) * 0.1).astype(np.float32)
    chain0 = (rng.random((B, H)) < 0.5).astype(np.float32)
    u = {"h0": rng.random((E, nb, B, H), np.float32),
         "h": rng.random((E, nb, jcfg.k, B, H), np.float32),
         "v": rng.random((E, nb, jcfg.k, B, V), np.float32)}
    assert jcfg.resolved_sample_visible
    zeros = {"W": np.zeros((V, H), np.float32), "b": np.zeros(V, np.float32),
             "c": np.zeros(H, np.float32)}
    jst = TrainState(params=JaxParams(W=jnp.asarray(W), b=jnp.asarray(b), c=jnp.asarray(c)),
                     velocity=JaxParams(**{n: jnp.asarray(z) for n, z in zeros.items()}),
                     chain_h=jnp.asarray(chain0), key=jnp.asarray(np.zeros(2, np.uint32)),
                     epoch=jnp.asarray(np.int32(0)))
    fn = make_pallas_train_fn(jcfg, E, interpret=True, inject=True)
    want, want_errs = fn(jst, jnp.asarray(x), {n: jnp.asarray(a) for n, a in u.items()})
    tst = state_from_numpy({"params": {"W": W, "b": b, "c": c}, "velocity": zeros,
                            "chain_h": chain0, "epoch": 0}, device="cpu")
    got, metrics = train_rbm(torch.as_tensor(x), convert_config(jcfg).replace(engine="xla"),
                             state=tst, uniforms={n: torch.as_tensor(a) for n, a in u.items()})
    assert (metrics.engine, metrics.kernel) == ("eager", "cd_train")
    tol = dict(rtol=2e-4, atol=2e-6)
    for n in ("W", "b", "c"):
        np.testing.assert_allclose(getattr(got.params, n).numpy(),
                                   np.asarray(getattr(want.params, n)), **tol)
        np.testing.assert_allclose(getattr(got.velocity, n).numpy(),
                                   np.asarray(getattr(want.velocity, n)), **tol)
    np.testing.assert_array_equal(got.chain_h.numpy(), np.asarray(want.chain_h))
    np.testing.assert_allclose(np.asarray(metrics.errors, np.float32), np.asarray(want_errs),
                               **tol)

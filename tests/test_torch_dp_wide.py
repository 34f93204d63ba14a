"""The W-blocked kernel's data-parallel mode in mdbn_tpu_torch against the JAX
package: the route of ``ops.cd_grads_wide_cuda`` (a step into a slot of
factors, an all-gather, an update that forms the gradient from every rank's
factors), forced at test widths by lowering ``WIDE_DP_MIN_VISIBLE`` as
tests/test_pallas_dp_wb.py:40-55 forces the reference's W-blocked tier.

- ``cd_wide_step_plain`` on the three shards of a batch of 20 (7, 7, and 6 +
  1 pad row, norm 20/3), then ``cd_wide_update_plain`` on their gathered
  slots, against the JAX core's step and ``apply_update`` on the global batch
  at rtol=atol=2e-5 (tests/test_parity_core.py:20: float32 on both sides,
  sums in another order).
- The run over 2 and 3 gloo ranks (tests/torch_dp_ranks.py) on injected
  draws, every rank's state bit-identical, against the per-shard JAX replay
  of tests/test_torch_dp.py at rtol 2e-4 / atol 2e-6; the cases of
  tests/test_pallas_dp_wb.py (PCD with momentum 0 and 0.5, L2 and clipping;
  the uneven batch of 20; Gaussian visibles; sparsity; xent), and bf16
  storage one update at a time to one bf16 ulp against the JAX core with the
  negative-phase visibles rounded through bf16, as the W-blocked kernel keeps
  them.
- The admission rule ``select_dp_kernel``, the kernels' refusal of CPU
  tensors, and a one-rank mesh against the single-device W-blocked run, also
  across a momentum switch from 0 (the captured epoch's update reads the
  momentum from the device and keeps the velocity variant of the config).
- The redesigned update's launch plan (``update_plan``, mirrored from
  csrc/cd_wide_update.cuh) at chip_smoke.py's four W-blocked DP rows over 1-8
  ranks: the fast plan inside an H100's 232,448 bytes; its fallbacks on a
  smaller block.

CPU only, seconds each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dp import (CORE_TOL, DP_TOL, both, close, draws, jax_replay, params_np,
                           spawn_ranks, th, visible_data)
from test_torch_dp_modes import bf16, shard_draws, within_bf16_ulp

from mdbn_tpu.core import rbm_math as J
from mdbn_tpu_torch.config import RBMConfig
from mdbn_tpu_torch.core import rbm_math as T
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.data.synthetic import mnist_like
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W
from mdbn_tpu_torch.ops.cd_epoch_wide_cuda import cd_train_wide_run_plain
from mdbn_tpu_torch.parallel import dp
from mdbn_tpu_torch.parallel.mesh import Mesh, make_mesh
from mdbn_tpu_torch.train.trainer import train_rbm

SMALL = dict(n_visible=32, n_hidden=16, lr=0.1)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")

SPLIT_CASES = {
    "gaussian-cd1": dict(visible="gaussian"),
    "meanfield-pcd-k2-sparsity": dict(sample_visible=False, persistent=True, k=2,
                                      sparsity_target=0.1, sparsity_cost=0.5),
    "xent-momentum-l2-clip": dict(sample_visible=False, error_metric="xent", momentum=0.5,
                                  l2=1e-3, grad_clip=0.05),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_plain_split_matches_jax_global_batch(name):
    """Three shards' steps into their slots, the update on the gathered
    slots: the JAX core's update of the whole batch."""
    jc, tc = both(**SMALL, batch_size=20, **SPLIT_CASES[name])
    B, H, ndev, lb = 20, jc.n_hidden, 3, 7
    rng = np.random.default_rng(11)
    p, vel = params_np(jc, rng), params_np(jc, rng)
    v0 = visible_data(jc, B, rng)
    u = draws(jc, B, rng)
    chain = (rng.random((B, H)) < 0.5).astype(np.float32)
    gj, cj, ej = J.cd_step_stats(J.RBMParams(**p), v0, chain if jc.persistent else None, u, jc)
    pj, vj = J.apply_update(J.RBMParams(**p), J.RBMParams(**vel), gj, jc, epoch=0)
    local = tc.replace(batch_size=lb)
    n = W.wide_factor_size(local)
    gathered = torch.full((ndev * n,), 255, dtype=torch.uint8)
    tp, chains = T.RBMParams(**th(p)), []
    for d in range(ndev):
        lo, hi = lb * d, min(lb * d + lb, B)
        pad = lb - (hi - lo)
        v = np.concatenate([v0[lo:hi], np.zeros((pad, jc.n_visible), np.float32)])
        ch = np.concatenate([chain[lo:hi], np.zeros((pad, H), np.float32)])
        slot, new_chain = W.cd_wide_step_plain(
            local, tp, torch.as_tensor(v), torch.as_tensor(ch),
            uniforms=th(shard_draws(u, lo, hi, pad, rng)), n_valid=hi - lo, norm=B / ndev,
            out=gathered[d * n:(d + 1) * n])
        assert slot.data_ptr() == gathered[d * n:].data_ptr()
        chains.append(new_chain[:hi - lo])
    pt, vt, et = W.cd_wide_update_plain(tc, tp, T.RBMParams(**th(vel)), torch.as_tensor(v0),
                                        gathered, ndev, dp.world_scale(ndev), 0)
    for k in ("W", "b", "c"):
        close(getattr(pt, k), getattr(pj, k), CORE_TOL)
        close(getattr(vt, k), getattr(vj, k), CORE_TOL)
    close(et, ej, CORE_TOL)
    if jc.persistent:
        close(torch.cat(chains), cj, dict(rtol=0, atol=0))
    _, hmat, _ = W.slot_views(local, gathered[2 * n:])
    assert torch.equal(hmat[:, 6:], torch.zeros((2, 1, H)))  # the pad row enters nothing


def jax_wide_update_bf16(jc, state, batch, u, ndev, epoch):
    """One data-parallel W-blocked update of a bf16-storage run on the JAX
    core, from the port's ``state``: each shard's mean-field chain on the
    widened values with the negative-phase visibles rounded through bf16
    (the factors the W-blocked kernel keeps), every shard's rows in rank
    order, the gradient over the real rows, then apply_update on the bf16
    state."""
    B = jc.batch_size
    lb = -(-B // ndev)
    jf = jc.replace(param_dtype="float32")
    P = {k: jnp.asarray(x.float().numpy()) for k, x in state["params"].items()}
    Vel = {k: jnp.asarray(x.float().numpy()) for k, x in state["velocity"].items()}
    params = J.RBMParams(**P)
    batch = np.pad(batch, ((0, lb * ndev - B), (0, 0)))
    rows = {"v0": [], "vs": [], "hp": [], "hm": []}
    for d in range(ndev):
        v0 = jnp.asarray(batch[d * lb:(d + 1) * lb])
        h0p = J.hidden_mean(params, v0, jf)
        h = (jnp.asarray(u["h0"][d]) < h0p).astype(jnp.float32)
        for t in range(jc.k):
            vs = J.visible_mean(params, h, jf).astype(jnp.bfloat16).astype(jnp.float32)
            hm = J.hidden_mean(params, vs, jf)
            h = (jnp.asarray(u["h"][d][t]) < hm).astype(jnp.float32)
        for key, x in (("v0", v0), ("vs", vs), ("hp", h0p), ("hm", hm)):
            rows[key].append(x)
    v0, vs, hp, hm = (jnp.concatenate(rows[key])[:B] for key in ("v0", "vs", "hp", "hm"))
    dot = lambda a, b: J._dot(a, b, jf.compute_dtype, jf.matmul_precision)
    grads = J.RBMParams(W=(dot(v0.T, hp) - dot(vs.T, hm)) / B, b=jnp.sum(v0 - vs, axis=0) / B,
                        c=jnp.sum(hp - hm, axis=0) / B)
    as_bf16 = lambda d: J.RBMParams(**{k: x.astype(jnp.bfloat16) for k, x in d.items()})
    return J.apply_update(as_bf16(P), as_bf16(Vel), grads, jc, epoch=epoch)


MEANFIELD = dict(sample_visible=False)
RANK_CASES = {
    # name: (config fields, ranks, global batch); every case runs the W-blocked
    # DP route (the threshold lowered to the test width in each rank)
    "pcd-momentum0-l2-clip": (dict(MEANFIELD, persistent=True, momentum=0.0, l2=1e-4,
                                   grad_clip=0.5), 2, 10),
    "pcd-momentum0.5-l2-clip-uneven20": (dict(MEANFIELD, persistent=True, momentum=0.5,
                                              l2=1e-4, grad_clip=0.5), 3, 20),
    "gaussian-uneven5": (dict(visible="gaussian", momentum=0.5), 2, 5),
    "sparsity-k2": (dict(MEANFIELD, k=2, sparsity_target=0.1, sparsity_cost=0.5), 3, 20),
    "xent": (dict(MEANFIELD, error_metric="xent"), 2, 10),
    "bf16": (dict(visible="gaussian", lr=0.01, momentum=0.5, **BF16), 3, 20),
}


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_dp_wide_ranks_match_jax_replay(name, tmp_path):
    fields, ndev, B = RANK_CASES[name]
    kw = dict(SMALL, batch_size=B, **fields)
    jc, tc = both(**kw)
    assert K.wide_unsupported(tc) is None and K.select_dp_kernel(tc) == "cd_grads_resident"
    each = tc.param_dtype == "bfloat16"  # one update at a time
    lb = -(-B // ndev)
    E, nb = (3, 1) if each else (2, 2)
    rng = np.random.default_rng(19)
    if jc.visible == "bernoulli":
        data = mnist_like(nb * B, n_features=jc.n_visible, seed=3)
    else:
        data = rng.standard_normal((nb * B, jc.n_visible)).astype(np.float32)
    steps = [[[draws(jc, lb, rng) for _ in range(ndev)] for _ in range(nb)] for _ in range(E)]
    uniforms = {k: np.stack([np.stack([np.stack([d[k] for d in s]) for s in ep])
                             for ep in steps]) for k in ("h0", "h")}
    api = name == "gaussian-uneven5"
    got = spawn_ranks(tmp_path, ndev, tc, data, uniforms, E, (False,), api=api,
                      each_epoch=each, wide_dp_min_visible=jc.n_visible)
    r0 = got[0][False]
    for r in got[1:]:  # every rank holds the same bits
        for part in ("params", "velocity"):
            for k, x in r0[part].items():
                assert torch.equal(r[False][part][k], x), (part, k)
        assert torch.equal(r[False]["chain"], r0["chain"])
        assert torch.equal(r[False]["errs"], r0["errs"])
    assert r0["epoch"] == E
    if api:
        assert [(g["api"]["engine"], g["api"]["kernel"]) for g in got] == [
            ("eager_dp", "cd_grads_wide")] * ndev
    if each:
        prev = {part: getattr(init_train_state(tc, device="cpu"), part).as_dict()
                for part in ("params", "velocity")}
        for e, st in enumerate(r0["states"]):
            u = {k: x[e, 0] for k, x in uniforms.items()}
            pj, vj = jax_wide_update_bf16(jc, prev, bf16(data), u, ndev, e)
            for k in ("W", "b", "c"):
                assert st["params"][k].dtype == torch.bfloat16
                within_bf16_ulp(st["velocity"][k].float(), getattr(vj, k).astype(jnp.float32))
                within_bf16_ulp(st["params"][k].float(), getattr(pj, k).astype(jnp.float32),
                                st["velocity"][k].float(), getattr(vj, k).astype(jnp.float32))
            prev = st
        return
    params, vel, chain, errs = jax_replay(kw, data, uniforms, ndev, E)
    for k in ("W", "b", "c"):
        close(r0["params"][k], getattr(params, k), DP_TOL)
        close(r0["velocity"][k], getattr(vel, k), DP_TOL)
    close(r0["errs"], errs, DP_TOL)
    if jc.persistent:
        close(r0["chain"], chain, dict(rtol=0, atol=0))


def test_select_dp_kernel_at_the_threshold(monkeypatch):
    """From WIDE_DP_MIN_VISIBLE columns on, a run in the W-blocked kernel's
    scope takes cd_grads_wide; one column fewer takes the step kernel whose
    tiles fit (the resident kernel's step variant at these shapes); the
    single-device rule is not changed by it."""
    base = RBMConfig(n_visible=8, n_hidden=16, visible="gaussian")
    at = K.WIDE_DP_MIN_VISIBLE
    assert K.select_dp_kernel(base.replace(n_visible=at)) == "cd_grads_wide"
    assert K.select_dp_kernel(base.replace(n_visible=at - 1)) == "cd_grads_resident"
    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    assert K.select_dp_kernel(base.replace(n_visible=32)) == "cd_grads_wide"
    assert K.select_dp_kernel(base.replace(n_visible=31)) == "cd_grads_resident"
    assert K.select_kernel(base.replace(n_visible=32)) == "cd_train_resident"


OUTSIDE = {"sampled visibles": dict(sample_visible=True),
           "pseudo-likelihood": dict(visible="bernoulli", sample_visible=False,
                                     error_metric="pseudo"),
           "enhanced": dict(gradient="enhanced"),
           "tempering": dict(persistent=True, pt_temps=3),
           "learned variance": dict(learn_variance=True, sample_visible=False),
           "Philox": dict(k=300)}  # inside the scope: any k


@pytest.mark.parametrize("name", list(OUTSIDE))
def test_select_dp_kernel_outside_the_scope(name):
    """A config outside the W-blocked kernel's scope takes a step kernel of
    the flat-buffer routes at any width (the resident kernel's step variant
    where its tiles fit, as at this width), and the W-blocked DP step
    refuses it; k 300 lies inside it and takes cd_grads_wide as k 1 does."""
    cfg = RBMConfig(n_visible=K.WIDE_DP_MIN_VISIBLE, n_hidden=16, visible="gaussian",
                    batch_size=5).replace(**OUTSIDE[name])
    if name == "Philox":
        assert K.wide_unsupported(cfg) is None
        assert K.select_dp_kernel(cfg) == "cd_grads_wide"
        return
    assert K.wide_unsupported(cfg) is not None
    assert K.select_dp_kernel(cfg) == "cd_grads_resident"
    st = init_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match=name.split()[0]):
        W.cd_wide_step_plain(cfg, st.params, torch.zeros((5, cfg.n_visible)), st.chain_h, seed=1)


def test_wide_kernels_refuse_cpu_tensors(monkeypatch):
    """The kernel wrappers take CUDA tensors only: no fallback to the plain
    versions, and pallas_step on the CPU reaches them and raises."""
    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    cfg = RBMConfig(n_visible=32, n_hidden=16, batch_size=6, visible="gaussian")
    st = init_train_state(cfg, device="cpu")
    v0 = torch.zeros((6, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        W.cd_wide_step(cfg, st.params, v0, st.chain_h, seed=1)
    slot, _ = W.cd_wide_step_plain(cfg, st.params, v0, st.chain_h, seed=1)
    assert slot.numel() == W.wide_factor_size(cfg) == 6 * 32 * 4 + 2 * 6 * 16 * 4 + 16
    with pytest.raises(ValueError, match="CUDA tensors"):
        W.cd_wide_update(cfg, st.params, st.velocity, v0, slot, 1, 1.0, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp.train_rbm_shard_map(st, v0, cfg, Mesh(0, 1, torch.device("cpu"), "gloo"), 1,
                               pallas_step=True)


@pytest.fixture
def one_rank():
    import torch.distributed as dist

    mesh = make_mesh(1, backend="gloo", device="cpu")
    yield mesh
    dist.destroy_process_group()


def test_one_rank_wide_route_equals_single_device(one_rank, monkeypatch):
    """The W-blocked DP route on a mesh of one rank is the single-device
    W-blocked run (its plain version) on the same draws; train_rbm with that
    mesh takes the single-device path."""
    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    cfg = RBMConfig(n_visible=32, n_hidden=16, batch_size=6, k=2, persistent=True,
                    sample_visible=False, momentum=0.5, lr=0.1, shuffle=True, epochs=2,
                    sparsity_target=0.1, sparsity_cost=0.5)
    data = torch.as_tensor(mnist_like(18, n_features=32, seed=1))
    u = K.draw_uniform_blocks(cfg, torch.Generator().manual_seed(2), 2, 3)
    st, errs = dp.train_rbm_shard_map(init_train_state(cfg, device="cpu"), data, cfg, one_rank,
                                      2, uniforms={k: x[:, :, None] for k, x in u.items()})
    st1 = init_train_state(cfg, device="cpu")
    order = K.batch_order(cfg, 3, 2, st1.generator)
    p, v, chain, errs1 = cd_train_wide_run_plain(cfg, st1.params, st1.velocity, st1.chain_h,
                                                 data, order, 0, u)
    for a, b in ((st.params.W, p.W), (st.params.b, p.b), (st.params.c, p.c),
                 (st.velocity.W, v.W), (st.chain_h, chain), (errs, errs1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    _, metrics = train_rbm(data, cfg, mesh=one_rank, device="cpu")
    assert (metrics.engine, metrics.kernel) == ("eager", "cd_train")


def test_one_rank_wide_route_across_a_momentum_switch(one_rank, monkeypatch):
    """A momentum schedule from 0 that switches between epochs: the one-rank
    W-blocked DP route is the single-device W-blocked run on the same draws;
    the update's velocity variant comes from the config (a momentum of the
    run is not 0), as a captured epoch needs."""
    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    cfg = RBMConfig(n_visible=32, n_hidden=16, batch_size=6, k=1, visible="gaussian",
                    sample_visible=False, initial_momentum=0.0, momentum=0.5,
                    momentum_switch_epoch=1, lr=0.05, l2=1e-3)
    assert W.velocity_variant(cfg) and not W.velocity_variant(cfg.replace(momentum=0.0))
    data = torch.as_tensor(mnist_like(12, n_features=32, seed=4))
    u = K.draw_uniform_blocks(cfg, torch.Generator().manual_seed(5), 2, 2)
    st, errs = dp.train_rbm_shard_map(init_train_state(cfg, device="cpu"), data, cfg, one_rank,
                                      2, uniforms={k: x[:, :, None] for k, x in u.items()})
    st1 = init_train_state(cfg, device="cpu")
    order = K.batch_order(cfg, 2, 2, st1.generator)
    p, v, _, errs1 = cd_train_wide_run_plain(cfg, st1.params, st1.velocity, st1.chain_h, data,
                                             order, 0, u)
    for a, b in ((st.params.W, p.W), (st.params.b, p.b), (st.velocity.W, v.W), (errs, errs1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# chip_smoke.py's WIDE_DP_ROWS (scripts/bench_wide.py's shapes, batch 20)
_ROW = dict(visible="gaussian", lr=0.001, batch_size=20)
WIDE_DP_ROWS = {"w20k": RBMConfig(n_visible=20000, n_hidden=400, **_ROW),
                "w20k_mom_bf16": RBMConfig(n_visible=20000, n_hidden=400, momentum=0.5,
                                           **_ROW, **BF16),
                "w28k": RBMConfig(n_visible=28000, n_hidden=400, **_ROW),
                "w40k_bf16": RBMConfig(n_visible=40000, n_hidden=1000, **_ROW, **BF16)}


@pytest.mark.parametrize("name", list(WIDE_DP_ROWS))
def test_update_plan_fits_an_h100_at_every_row(name):
    """The update's fast plan at each row and at 1-8 ranks (R, the global
    batch, is 20 whatever the split): Y staged once a block, a ring of 2-4
    stages of X's and W's tiles (and vW's under momentum), inside 232,448
    bytes a block and an SM's 233,472 for its blocks; the step's plan of each
    split fits too."""
    from mdbn_tpu_torch.ops.cd_epoch_wide_cuda import wide_launch_plan

    cfg = WIDE_DP_ROWS[name]
    for ndev in range(1, 9):
        plan = W.update_plan(cfg)
        assert plan.ok and plan.resident and 2 <= plan.stages <= 4, plan
        assert plan.smem_bytes * (256 // plan.threads) <= 233472 - 1024 * (256 // plan.threads)
        assert plan.smem_bytes <= 232448 and plan.kc == plan.kp
        assert plan.kp == (48 if cfg.compute_dtype == "bfloat16" else 40)
        local = cfg.replace(batch_size=-(-cfg.batch_size // ndev))
        assert wide_launch_plan(local).ok
    assert W.velocity_variant(cfg) == (name == "w20k_mom_bf16")


def test_update_plan_fallbacks():
    """Two blocks of 128 threads an SM where Y and two stages fit half of it
    (w20k_mom_bf16), else one of 256 threads; on a smaller block the plan
    drops stages, then stages Y and X by chunks of K, smaller chunks as the
    block shrinks; where no chunk fits there is no plan. Rows of X (V) or of
    W (H) not whole 16-byte pieces at the storage width take the chunks
    too."""
    mom = WIDE_DP_ROWS["w20k_mom_bf16"]
    two = W.update_plan(mom)
    assert (two.threads, two.stages) == (128, 2) and two.smem_bytes <= 233472 // 2 - 1024
    one = W.update_plan(mom, smem_per_sm=150_000)
    fewer = W.update_plan(mom, 100_000, smem_per_sm=150_000)
    assert (one.threads, one.stages) == (256, 4) and (fewer.threads, fewer.stages) == (256, 2)
    cfg = WIDE_DP_ROWS["w40k_bf16"]
    assert (W.update_plan(cfg).threads, W.update_plan(cfg).stages) == (256, 4)
    whole = W.update_plan(cfg, 120_000)
    assert not whole.resident and whole.ok and whole.kc == whole.kp
    assert whole.smem_bytes <= 120_000
    chunked = W.update_plan(cfg, 60_000)
    assert not chunked.resident and chunked.ok and chunked.kc % 16 == 0
    assert chunked.kc < chunked.kp and chunked.smem_bytes <= 60_000
    assert not W.update_plan(cfg, 1000).ok
    for odd in (cfg.replace(n_visible=40001), cfg.replace(n_hidden=1004)):
        plan = W.update_plan(odd)
        assert plan.ok and not plan.resident and plan.kc == plan.kp, odd

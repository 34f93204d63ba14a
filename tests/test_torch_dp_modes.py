"""The data-parallel path of mdbn_tpu_torch in every estimator mode and at bf16
storage, against the JAX package.

- The split statistics (``core.rbm_math.split_grads``: the plain sums, learned
  variance's raw z statistic, the enhanced gradient's mean sums), summed over
  a 3-way split of a batch of 20 (7, 7, and 6 + 1 pad row, norm 20/3) and
  finished (``finish_grads``), against the JAX core's ``cd_step_stats`` /
  ``pt_step_stats`` on the global batch at rtol=atol=2e-5 (float32 on both
  sides, sums in another order: tests/test_parity_core.py:20).
- ``cd_grads_step_plain`` (the plain version of ``csrc/cd_grads.cu``'s step
  kernel; the wrapper takes it for CPU tensors) in each mode against the JAX
  core's masked statistics at 2e-5.
- The run over 2 and 3 gloo ranks in each mode, on injected draws, through
  both ``pallas_step`` flags (the kernels' plain versions on the CPU), every
  rank's state bit-identical: tempering and learned variance against the
  per-shard replay of tests/test_torch_dp.py at rtol 2e-4 / atol 2e-6; the
  enhanced gradient and the pseudo monitor against the JAX package's
  single-device replay on the global batch (the recipe of
  tests/test_pallas_dp.py:50-68); bf16 storage one update at a time, a
  velocity to one bf16 ulp and a parameter to its velocity's ulp plus one of
  its own (as tests/test_torch_wide.py holds bf16 runs).

CPU only, seconds each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dp import (CORE_TOL, DP_TOL, MASK, both, close, draws, jax_replay, params_np,
                           spawn_ranks, th, visible_data)

from mdbn_tpu.core import rbm_math as J
from mdbn_tpu_torch.core import rbm_math as T
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.data.synthetic import mnist_like
from mdbn_tpu_torch.ops import cd_grads_cuda as G

SMALL = dict(n_visible=32, n_hidden=16, lr=0.1)


def row_axis(name):
    """The batch-row axis of one step's draw ``name``."""
    return {"h0": 0, "swap": -1}.get(name, -2)


def shard_draws(u, lo, hi, pad, rng):
    """Rows [lo, hi) of each draw, plus ``pad`` rows of fresh draws."""
    out = {}
    for k, x in u.items():
        ax = row_axis(k) % x.ndim
        part = np.take(x, np.arange(lo, hi), axis=ax)
        shape = list(part.shape)
        shape[ax] = pad
        extra = (rng.standard_normal(shape) if k == "noise" else rng.random(shape))
        out[k] = np.concatenate([part, extra.astype(np.float32)], axis=ax)
    return out


SPLIT_CASES = {
    "enhanced-cd1": dict(gradient="enhanced"),
    "enhanced-pcd-k2-sparsity": dict(gradient="enhanced", persistent=True, k=2,
                                     sparsity_target=0.1, sparsity_cost=0.5),
    "enhanced-pt3": dict(gradient="enhanced", persistent=True, pt_temps=3, pt_beta_min=0.3),
    "lv-meanfield-pcd": dict(visible="gaussian", learn_variance=True, sample_visible=False,
                             persistent=True),
    "lv-sampled-k2": dict(visible="gaussian", learn_variance=True, sample_visible=True, k=2),
}


@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_stats_sum_to_the_global_batch(name):
    """Three shards' split statistics, their mean, finish_grads: the JAX
    core's statistics of the whole batch."""
    jc, tc = both(**SMALL, batch_size=20, **SPLIT_CASES[name])
    B, H, M = 20, jc.n_hidden, max(jc.pt_temps, 1)
    rng = np.random.default_rng(11)
    p, v0 = params_np(jc, rng), visible_data(jc, B, rng)
    pt = M > 1
    u = draws(jc, B, rng, pt=pt)
    chain = (rng.random((M, B, H)) < 0.5).astype(np.float32)
    jp = J.RBMParams(**p)
    if pt:
        gj, cj, ej = J.pt_step_stats(jp, v0, chain, u, jc)
    else:
        gj, cj, ej = J.cd_step_stats(jp, v0, chain[0] if jc.persistent else None, u, jc)
    tp, norm = T.RBMParams(**th(p)), B / 3
    shards = []
    for d in range(3):
        lo, hi = 7 * d, min(7 * d + 7, B)
        pad = 7 - (hi - lo)
        v = torch.as_tensor(np.concatenate([v0[lo:hi], np.zeros((pad, jc.n_visible),
                                                                 np.float32)]))
        ch = torch.as_tensor(np.concatenate([chain[:, lo:hi],
                                             np.zeros((M, pad, H), np.float32)], axis=1))
        mask = torch.as_tensor((np.arange(7) < hi - lo).astype(np.float32)[:, None])
        ud = th(shard_draws(u, lo, hi, pad, rng))
        if pt:
            shards.append(T.pt_step_stats(tp, v, ch, ud, tc, row_mask=mask, norm=norm,
                                          split=True))
        else:
            shards.append(T.cd_step_stats(tp, v, ch[0] if jc.persistent else None, ud, tc,
                                          row_mask=mask, norm=norm, split=True))
    mean = lambda xs: None if xs[0] is None else sum(xs) / 3
    grads = T.RBMParams(*[mean([getattr(s[0], n) for s in shards]) for n in ("W", "b", "c", "z")])
    sums = None
    if jc.gradient == "enhanced":
        sums = T.EnhancedSums(*[mean([getattr(s[1], n) for s in shards])
                                for n in ("mu", "lam", "h0")])
    else:
        assert all(s[1] is None for s in shards)
    got = T.finish_grads(tp, grads, sums, tc)
    for n in ("W", "b", "c", "z"):
        if getattr(gj, n) is None:
            assert getattr(got, n) is None
        else:
            close(getattr(got, n), getattr(gj, n), CORE_TOL)
    close(sum(s[3] for s in shards) / 3, ej, CORE_TOL)
    if jc.persistent:
        h = torch.cat([s[2].reshape(M, 7, H)[:, :min(7, B - 7 * d)]
                       for d, s in enumerate(shards)], dim=1)
        close(h.reshape(np.shape(cj)), cj, CORE_TOL)


STEP_CASES = {
    "pt3": dict(persistent=True, pt_temps=3, pt_beta_min=0.3, k=2),
    "lv-meanfield-pcd": dict(visible="gaussian", learn_variance=True, sample_visible=False,
                             persistent=True),
    "pt3-lv-gaussian-sampled": dict(visible="gaussian", learn_variance=True, persistent=True,
                                    pt_temps=3, pt_beta_min=0.4, sample_visible=True),
    "enhanced-sparsity": dict(gradient="enhanced", k=2, sparsity_target=0.1, sparsity_cost=0.5),
    "pseudo-pcd": dict(error_metric="pseudo", persistent=True),
    "bf16-gaussian-pcd": dict(visible="gaussian", persistent=True, param_dtype="bfloat16",
                              compute_dtype="bfloat16"),
}


def bf16(x):
    """x rounded to bf16, as float32 (what a bf16 tensor holds)."""
    return torch.as_tensor(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_plain_step_matches_jax_core(name):
    """The step's flat statistics in each mode, masked (a pad row, norm 2.5),
    against the JAX core: the plain sums against its plain gradient (the
    enhanced gradient's sparsity term comes after the exchange), the
    enhanced mean sums and learned variance's raw z statistic rebuilt from
    its outputs, the pseudo monitor against its pseudo_likelihood on the
    real rows, bf16 storage against float32 on the rounded values."""
    kw = STEP_CASES[name]
    jc, tc = both(**SMALL, batch_size=5, **kw)
    ref_kw = dict(SMALL, batch_size=5, **kw)
    if jc.gradient == "enhanced":  # the raw sums: the plain gradient, no sparsity term
        ref_kw.update(gradient="plain", sparsity_target=None, sparsity_cost=0.0)
    if jc.error_metric == "pseudo":
        ref_kw.update(error_metric="mse")
    ref_kw.update(param_dtype="float32")
    jr, _ = both(**ref_kw)
    sdt = T.torch_dtype(tc.param_dtype)
    rng = np.random.default_rng(13)
    p, v0 = params_np(jc, rng), visible_data(jc, 5, rng)
    v0[-1] = 0.0  # the pad row
    if sdt == torch.bfloat16:
        p, v0 = {k: bf16(x) for k, x in p.items()}, bf16(v0)
    M, pt = max(jc.pt_temps, 1), jc.pt_temps > 1
    u = draws(jc, 5, rng, pt=pt)
    chain = (rng.random((M, 5, jc.n_hidden)) < 0.5).astype(np.float32)
    norm, jp = 2.5, J.RBMParams(**p)
    if pt:
        gj, cj, ej = J.pt_step_stats(jp, v0, chain, u, jr, row_mask=MASK, norm=norm)
    else:
        gj, cj, ej = J.cd_step_stats(jp, v0, chain[0], u, jr, row_mask=MASK, norm=norm)
    bit = 5
    if jc.error_metric == "pseudo":
        ej = J.pseudo_likelihood(jp, v0[:4], bit, jc) * 4 / norm
    tp = T.RBMParams(**{k: torch.as_tensor(x).to(sdt) for k, x in p.items()})
    tv0 = torch.as_tensor(v0).to(sdt)
    tchain = torch.as_tensor(chain.reshape(M * 5, -1)).to(sdt)
    for step in (G.cd_grads_step_plain, G.cd_grads_step):
        flat = torch.full((G.flat_size(tc),), float("nan"))
        g, ct, et = step(tc, tp, tv0, tchain, uniforms=th(u), mask=torch.as_tensor(MASK),
                         norm=norm, out=flat, pseudo_bit=bit)
        assert bool(torch.isfinite(flat).all())
        _, sums, _ = G.flat_views(tc, flat)
        for n in ("W", "b", "c"):
            close(getattr(g, n), getattr(gj, n), CORE_TOL)
        if jc.learn_variance:  # raw: the JAX gradient before e^{-z} and the 1/2
            raw = np.asarray(gj.z)
            if not jc.resolved_sample_visible:
                raw = raw + 0.5 * MASK.sum() / norm
            close(g.z, raw / np.exp(-p["z"]), CORE_TOL)
        if jc.gradient == "enhanced":
            h0 = (np.asarray(J.hidden_mean(jp, v0, jr)) * MASK).sum(0) / norm
            close(sums.mu, (v0 * MASK).sum(0) / norm - 0.5 * np.asarray(gj.b), CORE_TOL)
            close(sums.lam, h0 - 0.5 * np.asarray(gj.c), CORE_TOL)
            close(sums.h0, h0, CORE_TOL)
        else:
            assert sums is None
        close(et, ej, CORE_TOL)
        assert ct.dtype == sdt
        if jc.persistent:
            close(ct.float(), np.reshape(cj, (M * 5, -1)), CORE_TOL)
        else:  # CD: the chain passes through
            assert torch.equal(ct, tchain)


def global_draws(uniforms, e, i, B):
    """Step (e, i)'s draws of the whole batch: the ranks' rows in rank order,
    pad rows dropped."""
    out = {}
    for k, x in uniforms.items():
        parts = x[e, i]  # [ndev, ...]
        ax = row_axis(k) % (parts.ndim - 1)
        whole = np.concatenate(list(parts), axis=ax)
        out[k] = jnp.asarray(np.take(whole, np.arange(B), axis=ax))
    return out


def jax_global_replay(kw, data, uniforms, n_epochs):
    """The JAX package's single-device host replay on the global batch
    (tests/test_pallas_dp.py:50-68), from the port's initial state."""
    jc, tc = both(**kw)
    B, V = jc.batch_size, jc.n_visible
    nb = data.shape[0] // B
    batches = data[: nb * B].reshape(nb, B, V)
    st = init_train_state(tc, device="cpu")
    params = J.RBMParams(**{k: jnp.asarray(x.numpy()) for k, x in st.params.as_dict().items()})
    vel = J.zero_velocity(params)
    chain = jnp.zeros((B, jc.n_hidden), jnp.float32)
    errs = []
    for e in range(n_epochs):
        step_errs = []
        for i in range(nb):
            v0 = jnp.asarray(batches[i])
            grads, ch, err = J.cd_step_stats(params, v0, chain if jc.persistent else None,
                                             global_draws(uniforms, e, i, B), jc)
            if jc.persistent:
                chain = ch
            if jc.error_metric == "pseudo":
                err = J.pseudo_likelihood(params, v0, (e * nb + i) % V, jc)
            params, vel = J.apply_update(params, vel, grads, jc, epoch=e)
            step_errs.append(float(err))
        errs.append(np.mean(step_errs))
    return params, vel, np.asarray(chain), np.asarray(errs, np.float32)


def within_bf16_ulp(got, want, vel_got=None, vel_want=None, atol=1e-6):
    """A velocity within one bf16 ulp (2^-7 of its value) of the replay's; a
    parameter within its velocity's ulp and one of its own (+ atol near 0)."""
    a, b = np.asarray(got, np.float32), np.asarray(want, np.float32)
    big = np.maximum(np.abs(a), np.abs(b))
    if vel_got is not None:
        big = big + np.maximum(np.abs(np.asarray(vel_got, np.float32)),
                               np.abs(np.asarray(vel_want, np.float32)))
    assert np.all(np.abs(a - b) <= big * 2.0 ** -7 + atol), float(np.abs(a - b).max())


def jax_step_bf16(jc, state, batch, u, ndev, epoch):
    """One data-parallel update of a bf16-storage run, replayed on the JAX
    core from the port's ``state``: each shard's masked statistics on the
    widened values (float32 storage, the config's compute dtype), their mean,
    then apply_update on the bf16 state."""
    B = jc.batch_size
    lb = -(-B // ndev)
    jf = jc.replace(param_dtype="float32", batch_size=lb)
    P = {k: jnp.asarray(x.float().numpy()) for k, x in state["params"].items()}
    Vel = {k: jnp.asarray(x.float().numpy()) for k, x in state["velocity"].items()}
    batch = np.pad(batch, ((0, lb * ndev - B), (0, 0)))
    gs = []
    for d in range(ndev):
        mask = jnp.asarray((np.arange(d * lb, (d + 1) * lb) < B).astype(np.float32))[:, None]
        ud = {k: jnp.asarray(x[d]) for k, x in u.items()}
        g, _, _ = J.cd_step_stats(J.RBMParams(**P), jnp.asarray(batch[d * lb:(d + 1) * lb]),
                                  None, ud, jf, row_mask=mask, norm=B / ndev)
        gs.append(g)
    grads = J.RBMParams(*[None if getattr(gs[0], n) is None else
                          sum(getattr(g, n) for g in gs) / ndev for n in ("W", "b", "c", "z")])
    as_bf16 = lambda d: J.RBMParams(**{k: x.astype(jnp.bfloat16) for k, x in d.items()})
    return J.apply_update(as_bf16(P), as_bf16(Vel), grads, jc, epoch=epoch)


DP_MODE_CASES = {
    # (config fields, replay): "shards" per-shard masked statistics and their
    # mean (tests/test_torch_dp.py), "global" the single-device replay on the
    # global batch, "each" one update at a time to one bf16 ulp
    "pt3": (dict(persistent=True, pt_temps=3, pt_beta_min=0.3, momentum=0.5), "shards"),
    "lv": (dict(visible="gaussian", learn_variance=True, lr=0.01, momentum=0.5,
                lr_variance=0.005), "shards"),
    "pt3-lv": (dict(visible="gaussian", learn_variance=True, persistent=True, pt_temps=3,
                    pt_beta_min=0.4, sample_visible=True, lr=0.01), "shards"),
    "enhanced": (dict(gradient="enhanced", persistent=True, k=2, sparsity_target=0.1,
                      sparsity_cost=0.5, momentum=0.5), "global"),
    "pseudo": (dict(error_metric="pseudo", momentum=0.5, l2=1e-3), "global"),
    "bf16": (dict(visible="gaussian", lr=0.01, momentum=0.5, param_dtype="bfloat16",
                  compute_dtype="bfloat16"), "each"),
}


@pytest.mark.parametrize("ndev", [2, 3])
@pytest.mark.parametrize("mode", list(DP_MODE_CASES))
def test_dp_modes_match_jax_replay(mode, ndev, tmp_path):
    fields, replay = DP_MODE_CASES[mode]
    B = 5 if ndev == 2 else 20  # one pad row on the last rank either way
    kw = dict(SMALL, batch_size=B, **fields)
    jc, tc = both(**kw)
    lb = -(-B // ndev)
    E, nb = (3, 1) if replay == "each" else (2, 2)
    rng = np.random.default_rng(17)
    if jc.visible == "bernoulli":
        data = mnist_like(nb * B, n_features=jc.n_visible, seed=3)
    else:
        data = rng.standard_normal((nb * B, jc.n_visible)).astype(np.float32)
    steps = [[[draws(jc, lb, rng, pt=jc.pt_temps > 1) for _ in range(ndev)]
              for _ in range(nb)] for _ in range(E)]
    uniforms = {k: np.stack([np.stack([np.stack([d[k] for d in s]) for s in ep])
                             for ep in steps]) for k in steps[0][0][0]}
    got = spawn_ranks(tmp_path, ndev, tc, data, uniforms, E, (True, False),
                      each_epoch=replay == "each")
    for flag in (True, False):
        r0 = got[0][flag]
        for r in got[1:]:  # every rank holds the same bits
            for part in ("params", "velocity"):
                for k, x in r0[part].items():
                    assert torch.equal(r[flag][part][k], x), (flag, part, k)
            assert torch.equal(r[flag]["chain"], r0["chain"])
            assert torch.equal(r[flag]["errs"], r0["errs"])
        assert r0["epoch"] == E
        if replay == "each":
            prev = {part: {k: x for k, x in
                           getattr(init_train_state(tc, device="cpu"), part).as_dict().items()}
                    for part in ("params", "velocity")}
            for e, st in enumerate(r0["states"]):
                u = {k: x[e, 0] for k, x in uniforms.items()}
                pj, vj = jax_step_bf16(jc, prev, bf16(data), u, ndev, e)
                for k in ("W", "b", "c"):
                    assert st["params"][k].dtype == torch.bfloat16
                    within_bf16_ulp(st["velocity"][k].float(), getattr(vj, k).astype(jnp.float32))
                    within_bf16_ulp(st["params"][k].float(), getattr(pj, k).astype(jnp.float32),
                                    st["velocity"][k].float(), getattr(vj, k).astype(jnp.float32))
                prev = st
            continue
        if replay == "global":
            params, vel, chain, errs = jax_global_replay(kw, data, uniforms, E)
        else:
            params, vel, chain, errs = jax_replay(kw, data, uniforms, ndev, E)
        for k in ("W", "b", "c", "z"):
            if getattr(params, k) is None:
                assert k not in r0["params"]
                continue
            close(r0["params"][k], getattr(params, k), DP_TOL)
            close(r0["velocity"][k], getattr(vel, k), DP_TOL)
        close(r0["errs"], errs, DP_TOL)
        if jc.persistent:
            close(r0["chain"], chain, dict(rtol=0, atol=0))

"""CD-300 on the CPU: the eager engine (the kernels' plain version) against
the JAX package's XLA epoch, on the same injected uniforms.

k = 300 is past the 255 Gibbs steps the kernels' Philox counter word once
held (csrc/cd_common.cuh::draw_bits); the kernels themselves run it on the
card (tests/test_torch_cuda.py, ``-k k300``). Here the port's trainer runs
``RBM.train``'s eager path (``train_rbm(..., uniforms=)``) at 12x8, and the
JAX side replays ``mdbn_tpu/train/trainer.py::_epoch_xla``'s step (the core's
``cd_step_stats`` and ``apply_update``, jitted) with each update's slice of
the same uniforms. Data, state and uniforms are made with numpy from a seed.
Tolerance 2e-5 (relative and absolute) on the parameters, velocities and
errors; the chain is the same samples.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdbn_tpu.config import RBMConfig
from mdbn_tpu.core.rbm_math import RBMParams, apply_update, cd_step_stats
from mdbn_tpu_torch.convert import convert_config, state_from_numpy
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.train.trainer import train_rbm

TOL = dict(rtol=2e-5, atol=2e-5)
E, NB = 2, 3
CASES = {
    "bernoulli-cd300": RBMConfig(n_visible=12, n_hidden=8, batch_size=4, k=300, lr=0.05),
    "gaussian-pcd300-momentum": RBMConfig(n_visible=12, n_hidden=8, batch_size=4, k=300,
                                          visible="gaussian", persistent=True, lr=0.01,
                                          momentum=0.5, l2=1e-3),
}


def _inputs(cfg, seed=0):
    B, V, H, k = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k
    rng = np.random.default_rng(seed)
    n = NB * B
    data = ((rng.random((n, V)) < 0.3) if cfg.visible == "bernoulli"
            else rng.standard_normal((n, V))).astype(np.float32)
    params = {"W": rng.normal(0, 0.1, (V, H)), "b": rng.normal(0, 0.1, V),
              "c": rng.normal(0, 0.1, H)}
    params = {n: v.astype(np.float32) for n, v in params.items()}
    u = {"h0": rng.random((E, NB, B, H), np.float32),
         "h": rng.random((E, NB, k, B, H), np.float32)}
    if cfg.resolved_sample_visible:
        u["v"] = rng.random((E, NB, k, B, V), np.float32)
    chain = (rng.random((B, H)) < 0.5).astype(np.float32)
    return data, params, u, chain


@pytest.mark.parametrize("name", list(CASES))
def test_eager_engine_at_k300_matches_the_jax_epoch(name):
    cfg = CASES[name].replace(epochs=E, shuffle=False)
    data, params, u, chain = _inputs(cfg)
    zeros = {n: np.zeros_like(v) for n, v in params.items()}
    tst = state_from_numpy({"params": params, "velocity": zeros, "chain_h": chain, "epoch": 0},
                           device="cpu")
    st, metrics = train_rbm(data, convert_config(cfg).replace(engine="xla"), state=tst,
                            uniforms={n: torch.as_tensor(v) for n, v in u.items()})
    assert metrics.engine == "eager" and st.epoch == E

    @jax.jit
    def step(p, vel, ch, v0, uu, epoch):
        g, new_chain, err = cd_step_stats(p, v0, ch if cfg.persistent else None, uu, cfg)
        p, vel = apply_update(p, vel, g, cfg, epoch=epoch)
        return p, vel, new_chain, err

    as_j = lambda d: RBMParams(**{n: jnp.asarray(v) for n, v in d.items()})
    p, vel, ch = as_j(params), as_j(zeros), jnp.asarray(chain)
    errs = []
    for e in range(E):
        ep = []
        for i in range(NB):
            uu = {"h0": u["h0"][e, i], "h": u["h"][e, i]}
            if "v" in u:
                uu["v"] = u["v"][e, i]
            v0 = jnp.asarray(data[i * cfg.batch_size:(i + 1) * cfg.batch_size])
            p, vel, new_chain, err = step(p, vel, ch, v0, uu, e)
            ch = new_chain if cfg.persistent else ch
            ep.append(float(err))
        errs.append(np.mean(ep))
    for n in ("W", "b", "c"):
        np.testing.assert_allclose(getattr(st.params, n).numpy(), np.asarray(getattr(p, n)), **TOL)
        np.testing.assert_allclose(getattr(st.velocity, n).numpy(), np.asarray(getattr(vel, n)),
                                   **TOL)
    np.testing.assert_array_equal(st.chain_h.numpy(), np.asarray(ch))
    np.testing.assert_allclose(metrics.errors, errs, **TOL)
    assert K.select_kernel(convert_config(cfg)) == "cd_train_resident"  # on the card

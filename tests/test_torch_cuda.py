"""The CUDA train kernel against its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel is built from csrc/ at first use);
skips elsewhere. Imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inject mode, hardened uniforms: both sides see the same draws, so the
trajectories agree to fp32 summation-order noise. Tolerance rtol=atol=1e-4
over 2 epochs of a small problem (the two differ only in the order of fp32
sums; a single flipped sample would show as an O(lr/B) = 1e-2 jump).
"""

import numpy as np
import pytest
import torch

from mdbn_tpu_torch.config import RBMConfig
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.ops import cd_epoch_cuda as K

TOL = dict(rtol=1e-4, atol=1e-4)

CASES = [
    RBMConfig(n_visible=40, n_hidden=24, batch_size=8, lr=0.1),
    RBMConfig(n_visible=40, n_hidden=24, batch_size=8, k=2, persistent=True,
              momentum=0.5, l2=1e-3, lr=0.1),
    RBMConfig(n_visible=40, n_hidden=24, batch_size=8, visible="gaussian", lr=0.01),
    RBMConfig(n_visible=40, n_hidden=24, batch_size=8, visible="gaussian", lr=0.01,
              sample_visible=True, k=2),
    RBMConfig(n_visible=40, n_hidden=24, batch_size=8, momentum=0.9, initial_momentum=0.5,
              momentum_switch_epoch=1, sparsity_target=0.1, sparsity_cost=0.5,
              grad_clip=0.05, error_metric="xent"),
    RBMConfig(n_visible=40, n_hidden=24, batch_size=8, compute_dtype="bfloat16"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(cfg, device, E=2, nb=6, seed=0):
    rng = np.random.default_rng(seed)
    n = nb * cfg.batch_size
    if cfg.visible == "bernoulli":
        data = (rng.random((n, cfg.n_visible)) < 0.3).astype(np.float32)
    else:
        data = rng.standard_normal((n, cfg.n_visible)).astype(np.float32)
    data = torch.as_tensor(data, device=device)
    st = init_train_state(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = K.draw_uniform_blocks(cfg, gen, E, nb)
    u = K.harden_uniform_blocks(cfg, st.params, st.velocity, st.chain_h, data, u, E)
    return st, data, K.batch_order(cfg, nb, E, None), u


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CASES, ids=range(len(CASES)))
def test_kernel_matches_plain_inject(cuda, cfg):
    st, data, order, u = _inputs(cfg, cuda)
    before = K.cd_train_launches
    got = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    assert K.cd_train_launches == before + 1
    want = K.cd_train_run_plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    for a, b in zip(got[:2], want[:2]):
        for name in ("W", "b", "c"):
            torch.testing.assert_close(getattr(a, name), getattr(b, name), **TOL)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)  # chain: exact samples
    torch.testing.assert_close(got[3], want[3], **TOL)


@pytest.mark.cuda
def test_kernel_sampling_is_grid_independent_and_trains(cuda):
    cfg = RBMConfig(n_visible=40, n_hidden=24, batch_size=8, lr=0.1)
    st, data, order, _ = _inputs(cfg, cuda, E=4)
    runs = [K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                           torch.Generator().manual_seed(3), grid=g) for g in (1, 7, 0)]
    for r in runs[1:]:
        torch.testing.assert_close(r[0].W, runs[0][0].W, rtol=0, atol=0)
        torch.testing.assert_close(r[3], runs[0][3], rtol=0, atol=0)
    errs = runs[0][3].tolist()
    assert all(np.isfinite(errs)) and errs[-1] < errs[0]


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    cfg = RBMConfig(n_visible=40, n_hidden=24, batch_size=8)
    st, data, order, _ = _inputs(cfg, cuda)
    with pytest.raises(ValueError, match="enhanced"):
        K.cd_train_run(cfg.replace(gradient="enhanced"), st.params, st.velocity,
                       st.chain_h, data, order, 0, None, torch.Generator())
    with pytest.raises(ValueError, match="float32"):
        K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data.double(), order, 0,
                       None, torch.Generator())
    with pytest.raises(RuntimeError, match="cudaError"):
        K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                       torch.Generator(), grid=1 << 20)

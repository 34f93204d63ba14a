"""The data-parallel routes and the captured epoch of mdbn_tpu_torch from the CPU.

- ``ops.cd_epoch_cuda.select_dp_kernel``'s three routes: chip_smoke.py's DP
  modes (c1, pt5, enhanced, lv, pseudo, c1 at bf16) at 1-4 ranks take the
  resident kernel's step variant ("cd_grads_resident"); PT + lv at 2000x200
  and a rank's batch one row past the fit take csrc/cd_grads.cu; from
  ``WIDE_DP_MIN_VISIBLE`` columns the W-blocked route.
- The captured epoch's device tables (``parallel.dp.epoch_tables``: each
  step's minibatch, seed and pseudo bit, the epoch's momentum) equal what the
  eager loop passes step by step, recorded from a run on a one-rank gloo
  mesh, on the flat-buffer routes and on the W-blocked route (forced at
  these widths by lowering ``WIDE_DP_MIN_VISIBLE``) across a momentum
  switch; the chain's two buffers (``chain_parity``) hand each step the last
  one's chain at odd and even ``nb``; a run asked to capture off the card
  takes the eager loop, on either route.
- The repairs: ``fit_label_top`` with nothing that names a device, and
  ``make_mesh`` without a card, raise unless asked for the CPU; the CLI's
  ``--dp`` hands ``--device`` to ``make_mesh``.

The kernels need the card (tests/test_torch_cuda.py); the eager loop on the
plain versions is held against the JAX package in tests/test_torch_dp.py.
No JAX here; a few seconds on one core.
"""

import numpy as np
import pytest
import torch

from mdbn_tpu_torch.config import RBMConfig
from mdbn_tpu_torch.core.rbm_math import resolve_momentum
from mdbn_tpu_torch.core.state import init_train_state
from mdbn_tpu_torch.data.synthetic import mnist_like
from mdbn_tpu_torch.ops import cd_epoch_cuda as K
from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
from mdbn_tpu_torch.ops import cd_grads_cuda as G
from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
from mdbn_tpu_torch.parallel import dp
from mdbn_tpu_torch.parallel import mesh as mesh_mod

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
C1 = dict(n_visible=784, n_hidden=500, k=1, lr=0.1, batch_size=20)
LV = dict(n_visible=2000, n_hidden=200, visible="gaussian", learn_variance=True, lr=0.005,
          batch_size=20)
# chip_smoke.py's DP_MODES on the flat-buffer routes
DP_MODES = {"c1": RBMConfig(**C1),
            "pt5": RBMConfig(**C1, persistent=True, pt_temps=5, pt_beta_min=0.2),
            "enhanced": RBMConfig(**C1, gradient="enhanced"),
            "lv": RBMConfig(**LV),
            "pseudo": RBMConfig(**C1, error_metric="pseudo"),
            "c1_bf16": RBMConfig(**C1, **BF16)}


@pytest.mark.parametrize("ndev", [1, 2, 3, 4])
@pytest.mark.parametrize("mode", list(DP_MODES))
def test_smoke_modes_take_the_resident_step(mode, ndev):
    cfg = DP_MODES[mode]
    assert K.select_dp_kernel(cfg, ndev) == "cd_grads_resident"
    local = cfg.replace(batch_size=dp.local_batch(cfg, ndev)[0])
    assert R.resident_tiles(local).fits
    assert GR.step_library(cfg) == R.resident_library(cfg).replace("train", "grads")


def test_routes_past_the_fit_and_wide():
    """PT + lv at 2000x200 fits no cluster: cd_grads.cu at any rank count
    that leaves 20 rows a rank, and a ladder of 3 rungs of 10 rows fits. c1
    fits up to 64 rows a rank: 65 on one rank take cd_grads.cu, on two ranks
    (33 each) the resident step; the admission reads the card's limits. From
    WIDE_DP_MIN_VISIBLE columns a run in the W-blocked scope takes
    cd_grads_wide at any rank count, and a mode run outside it cd_grads.cu
    where its tiles do not fit."""
    pt_lv = RBMConfig(**LV, persistent=True, pt_temps=3, pt_beta_min=0.4)
    assert K.select_dp_kernel(pt_lv) == "cd_grads"
    assert K.select_dp_kernel(pt_lv.replace(**BF16)) == "cd_grads"
    assert K.select_dp_kernel(pt_lv, 2) == "cd_grads_resident"
    c1 = RBMConfig(**C1)
    fits = [b for b in range(20, 80) if R.resident_tiles(c1.replace(batch_size=b)).fits]
    last = max(fits)
    assert last == 64 and fits == list(range(20, 65))
    assert K.select_dp_kernel(c1.replace(batch_size=last)) == "cd_grads_resident"
    assert K.select_dp_kernel(c1.replace(batch_size=last + 1)) == "cd_grads"
    assert K.select_dp_kernel(c1.replace(batch_size=last + 1), 2) == "cd_grads_resident"
    # a card that holds no cluster, or less shared memory a block: cd_grads.cu
    need = R.resident_tiles(c1).smem_bytes
    assert K.select_dp_kernel(c1, 1, (R.H100_SMEM_PER_BLOCK, 0)) == "cd_grads"
    assert K.select_dp_kernel(c1, 1, (need - 1, None)) == "cd_grads"
    assert K.select_dp_kernel(c1, 1, (need, None)) == "cd_grads_resident"
    wide = RBMConfig(n_visible=K.WIDE_DP_MIN_VISIBLE, n_hidden=400, visible="gaussian",
                     batch_size=20)
    for ndev in (1, 2, 3, 4):
        assert K.select_dp_kernel(wide, ndev) == "cd_grads_wide"
        assert K.select_dp_kernel(wide.replace(n_visible=20000, gradient="enhanced"),
                                  ndev) == "cd_grads"


def test_resident_step_on_the_cpu_is_the_plain_step():
    """The wrapper takes the plain version for CPU tensors, and the step
    library of each mode variant is the training library's step build."""
    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=5, persistent=True, k=2)
    st = init_train_state(cfg, device="cpu")
    v0 = torch.as_tensor(mnist_like(5, n_features=16, seed=3))
    mask = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])[:, None]
    got = GR.cd_grads_resident_step(cfg, st.params, v0, st.chain_h, seed=4, mask=mask, norm=4.5)
    want = G.cd_grads_step_plain(cfg, st.params, v0, st.chain_h, seed=4, mask=mask, norm=4.5)
    for a, b in zip(got[0].as_dict().values(), want[0].as_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert GR.step_library(cfg) == "cd_grads_resident"
    assert GR.step_library(cfg.replace(gradient="enhanced")) == "cd_grads_resident_modes"
    assert GR.step_library(cfg.replace(pt_temps=3)) == "cd_grads_resident_ladder"
    with pytest.raises(ValueError, match="CPU or CUDA"):
        GR.cd_grads_resident_step(cfg, st.params, v0.to("meta"), st.chain_h, seed=1)


@pytest.mark.parametrize("nb", [3, 4])
def test_chain_parity_hands_each_step_the_last_chain(nb):
    """Two buffers: each step reads what the step before wrote, and after the
    epoch (with the copy back at an odd nb) buffer 0 holds the last chain,
    where the next epoch starts."""
    slots, copy_back = dp.chain_parity(nb)
    assert copy_back == (nb % 2 == 1)
    for _ in range(2):  # two epochs
        bufs = ["start", None]
        for i, (src, dst) in enumerate(slots):
            assert bufs[src] == ("start" if i == 0 else f"step{i - 1}")
            bufs[dst] = f"step{i}"
        if copy_back:
            bufs[0] = bufs[1]
        assert bufs[0] == f"step{nb - 1}"


@pytest.fixture
def one_rank():
    import torch.distributed as dist

    mesh = mesh_mod.make_mesh(1, backend="gloo", device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("rank", [0, 2])
def test_epoch_tables_equal_what_the_eager_loop_passes(one_rank, monkeypatch, rank):
    """A seeded eager run on a one-rank gloo mesh, its steps recorded (the
    minibatch of each, its seed, the pseudo bit; the momentum of each update)
    against ``epoch_tables`` built from the same generator: every row equal,
    the seeds as int64 bit patterns. ``rank`` only enters the seeds
    (fold_in), so the tables of rank 2 are checked against the recorded
    seeds folded for rank 2."""
    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=4, persistent=True, k=1,
                    error_metric="pseudo", shuffle=True, momentum=0.9, initial_momentum=0.5,
                    momentum_switch_epoch=3, lr=0.05)
    nb, E = 3, 2
    data = torch.as_tensor(mnist_like(nb * 4, n_features=16, seed=5))
    state = init_train_state(cfg, device="cpu")
    state = dp.TrainState(state.params, state.velocity, state.chain_h, state.generator, 2)
    gen = torch.Generator().set_state(state.generator.get_state())
    steps, epochs = [], []
    step, update = dp.cd_grads_step_plain, dp.cd_update_plain

    def record_step(cfg_, params, v0, chain, **kw):
        j = [k for k in range(nb) if torch.equal(v0, data[k * 4:(k + 1) * 4])]
        steps.append((j[0], kw["seed"], kw["pseudo_bit"]))
        return step(cfg_, params, v0, chain, **kw)

    def record_update(cfg_, params, velocity, sums, scale, epoch):
        epochs.append(epoch)
        return update(cfg_, params, velocity, sums, scale, epoch)

    monkeypatch.setattr(dp, "cd_grads_step_plain", record_step)
    monkeypatch.setattr(dp, "cd_update_plain", record_update)
    dp.train_rbm_shard_map(state, data, cfg, one_rank, E)
    order = K.batch_order(cfg, nb, E, gen).tolist()
    seeds = torch.randint(0, 2 ** 62, (E, nb), generator=gen).tolist()
    tab, mom = dp.epoch_tables(cfg, order, seeds, rank, state.epoch)
    assert tab.shape == (E, nb, 3) and tab.dtype == torch.int64 and mom.dtype == torch.float32
    int64 = lambda s: s - (1 << 64) if s >= 1 << 63 else s
    for n, (j, seed, bit) in enumerate(steps):
        e, i = divmod(n, nb)
        want_seed = seed if rank == 0 else dp.fold_in(seeds[e][i], rank)
        assert tab[e, i].tolist() == [j, int64(want_seed), bit]
        assert bit == ((state.epoch + e) * nb + i) % cfg.n_visible
        assert float(mom[e]) == float(np.float32(resolve_momentum(cfg, epochs[n])))
    assert len(steps) == E * nb and sorted(set(epochs)) == [2, 3]
    assert mom.tolist() == [0.5, pytest.approx(0.9)]


def test_capture_off_the_card_runs_the_eager_loop(one_rank):
    """capture=True asks for the captured epoch only on the card over NCCL:
    on the CPU the run is the eager loop's, bit for bit."""
    cfg = RBMConfig(n_visible=16, n_hidden=8, batch_size=4, persistent=True, k=2, lr=0.1,
                    momentum=0.5)
    data = torch.as_tensor(mnist_like(12, n_features=16, seed=6))
    runs = [dp.train_rbm_shard_map(init_train_state(cfg, device="cpu"), data, cfg, one_rank, 2,
                                   pallas_step=True, capture=c) for c in (True, False)]
    for a, b in zip(runs[0][0].params.as_dict().values(), runs[1][0].params.as_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0].chain_h, runs[1][0].chain_h)
    assert torch.equal(runs[0][1], runs[1][1])


WIDE = RBMConfig(n_visible=32, n_hidden=16, batch_size=4, persistent=True, k=1,
                 visible="gaussian", sample_visible=False, shuffle=True, momentum=0.5,
                 initial_momentum=0.0, momentum_switch_epoch=3, lr=0.02)


def test_wide_epoch_tables_equal_what_the_eager_loop_passes(one_rank, monkeypatch):
    """The W-blocked route's captured epoch reads from the same tables: the
    step's minibatch and seed, the update's minibatch (the same row) and the
    epoch's momentum, here across a switch from 0, equal what the eager loop
    passes to the step and the update."""
    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    cfg = WIDE
    assert K.select_dp_kernel(cfg) == "cd_grads_wide"
    nb, E, B = 3, 2, cfg.batch_size
    data = torch.randn((nb * B, cfg.n_visible), generator=torch.Generator().manual_seed(5))
    state = init_train_state(cfg, device="cpu")
    state = dp.TrainState(state.params, state.velocity, state.chain_h, state.generator, 2)
    gen = torch.Generator().set_state(state.generator.get_state())
    steps, updates = [], []
    step, update = dp.cd_wide_step_plain, dp.cd_wide_update_plain
    which = lambda v0: [k for k in range(nb) if torch.equal(v0, data[k * B:(k + 1) * B])][0]

    def record_step(cfg_, params, v0, chain, **kw):
        steps.append((which(v0), kw["seed"]))
        return step(cfg_, params, v0, chain, **kw)

    def record_update(cfg_, params, velocity, v0, gathered, ndev, scale, epoch):
        updates.append((which(v0), epoch))
        return update(cfg_, params, velocity, v0, gathered, ndev, scale, epoch)

    monkeypatch.setattr(dp, "cd_wide_step_plain", record_step)
    monkeypatch.setattr(dp, "cd_wide_update_plain", record_update)
    dp.train_rbm_shard_map(state, data, cfg, one_rank, E)
    order = K.batch_order(cfg, nb, E, gen).tolist()
    seeds = torch.randint(0, 2 ** 62, (E, nb), generator=gen).tolist()
    tab, mom = dp.epoch_tables(cfg, order, seeds, 0, state.epoch)
    int64 = lambda s: s - (1 << 64) if s >= 1 << 63 else s
    assert len(steps) == len(updates) == E * nb
    for n, ((j, seed), (ju, epoch)) in enumerate(zip(steps, updates)):
        e, i = divmod(n, nb)
        assert tab[e, i, :2].tolist() == [j, int64(seed)] and ju == j
        assert float(mom[e]) == float(np.float32(resolve_momentum(cfg, epoch)))
    assert mom.tolist() == [0.0, 0.5]


def test_wide_capture_off_the_card_runs_the_eager_loop(one_rank, monkeypatch):
    """On the W-blocked route too, capture=True changes nothing off the card:
    the run is the eager loop's, bit for bit."""
    monkeypatch.setattr(K, "WIDE_DP_MIN_VISIBLE", 32)
    data = torch.randn((12, 32), generator=torch.Generator().manual_seed(6))
    runs = [dp.train_rbm_shard_map(init_train_state(WIDE, device="cpu"), data, WIDE, one_rank,
                                   2, capture=c) for c in (True, False)]
    for a, b in zip(list(runs[0][0].params.as_dict().values())
                    + list(runs[0][0].velocity.as_dict().values()),
                    list(runs[1][0].params.as_dict().values())
                    + list(runs[1][0].velocity.as_dict().values())):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0].chain_h, runs[1][0].chain_h)
    assert torch.equal(runs[0][1], runs[1][1])


def test_fit_label_top_without_a_device_raises_without_a_card(monkeypatch):
    """No layers, numpy data and no params name no device: the card, so
    without one it raises, as the rest of the port does; device="cpu" runs."""
    from mdbn_tpu_torch.train.labeled import fit_label_top

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = mnist_like(20, n_features=16, seed=7)
    y = np.arange(20) % 2
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fit_label_top([], x, y, 2, n_hidden=4, epochs=1, batch_size=10)
    params, errs = fit_label_top([], x, y, 2, n_hidden=4, epochs=1, batch_size=10, device="cpu")
    assert params.W.device.type == "cpu" and params.W.shape == (18, 4) and len(errs) == 1


def test_make_mesh_without_a_card_raises_unless_asked_for_the_cpu(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"backend": "gloo"}):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mesh_mod.make_mesh(1, **kw)
    with pytest.raises(ValueError, match="card per rank"):
        mesh_mod.make_mesh(1, backend="nccl", device="cpu")
    import torch.distributed as dist

    assert not dist.is_initialized()
    mesh = mesh_mod.make_mesh(1, device="cpu")
    try:
        assert (mesh.size, mesh.device, mesh.backend) == (1, torch.device("cpu"), "gloo")
    finally:
        dist.destroy_process_group()


def test_cli_dp_mesh_passes_the_device(monkeypatch):
    """``--dp n --device cpu`` asks make_mesh for the CPU (gloo); on the card
    it asks for none, and make_mesh takes the rank's card."""
    from mdbn_tpu_torch import run

    calls = []
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda n, **kw: calls.append((n, kw)) or kw)
    monkeypatch.setenv("WORLD_SIZE", "2")
    run._dp_mesh(2, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    run._dp_mesh(2, "cuda")
    assert calls == [(2, {"backend": "gloo", "device": "cpu"}),
                     (2, {"backend": "nccl", "device": None})]

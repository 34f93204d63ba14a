"""The port's analysis (mdbn_tpu_torch/analysis/) against the JAX package's.

Runs on the CPU (``device="cpu"``) at small sizes, on inputs made with numpy
from fixed seeds. Tolerances:

- survival (Kaplan-Meier, log-rank, Cox, planted survival): the port's
  copy against the reference at 1e-12;
- the adjusted Rand index against the reference's (scikit-learn) at 1e-12;
- the silhouette against ``sklearn.metrics.silhouette_score`` at 1e-6 (the
  port's distances are float64, scikit-learn's float32 data upcast);
- ``kmeans_fit`` from the reference's ``_plus_plus_init`` centers: the same
  labels as the JAX ``kmeans_fit`` with that key, centers and inertia at
  1e-5 relative;
- ``kmeans_cluster`` on planted clusters: ARI 1.0 against the reference's
  partition, inertia within 1e-5 relative of scikit-learn's;
- consensus: the accumulation equals a numpy recount exactly, ``pac_score``
  and ``_cut_consensus`` equal the reference's on one M, and
  ``select_n_clusters_consensus`` picks the reference's k on planted data
  over 3 seeds.
"""

import jax
import numpy as np
import pytest
import torch

import mdbn_tpu.analysis.cluster as JC
import mdbn_tpu.analysis.consensus as JCO
import mdbn_tpu.analysis.kmeans_jax as JK
import mdbn_tpu.analysis.survival as JS
import mdbn_tpu_torch.analysis.cluster as TC
import mdbn_tpu_torch.analysis.consensus as TCO
import mdbn_tpu_torch.analysis.kmeans as TK
import mdbn_tpu_torch.analysis.survival as TS

CPU = "cpu"


def _planted(n=120, k=3, d=8, sep=4.0, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, n)
    centers = rng.normal(0, 1, (k, d)) * sep
    return (centers[labels] + rng.normal(0, 1, (n, d))).astype(np.float32), labels


def _close(a, b, tol=1e-12):
    """Nested dicts / lists / numbers / arrays equal to ``tol`` (relative and
    absolute)."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (str, bool)) or (isinstance(a, list) and a and isinstance(a[0], str)):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(b, float), np.asarray(a, float), rtol=tol,
                                   atol=tol)


def _survival_data(seed, n=60, k=3, ties=False):
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, k, n)
    times, events = JS.synthetic_survival(groups, seed=seed)
    if ties:
        times = np.round(times, 1)
    return times, events, groups


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ties", [False, True])
def test_survival_matches_the_reference(seed, ties):
    times, events, groups = _survival_data(seed, ties=ties)
    _close(JS.kaplan_meier(times, events), TS.kaplan_meier(times, events))
    for method in ("exact", "approx"):
        _close(JS.logrank_test(times, events, groups, method=method),
               TS.logrank_test(times, events, groups, method=method))
    age = np.random.default_rng(seed + 10).normal(60, 10, len(times))
    _close(JS.cox_ph(times, events, np.stack([groups == 1, age], 1)),
           TS.cox_ph(times, events, np.stack([groups == 1, age], 1)))
    for base in (0, 2):
        _close(JS.cox_ph_clusters(times, events, groups, baseline=base, extra_covariates=age),
               TS.cox_ph_clusters(times, events, groups, baseline=base, extra_covariates=age))
    for a, b in zip(JS.synthetic_survival(groups, (1.0, 3.0), 0.3, seed),
                    TS.synthetic_survival(groups, (1.0, 3.0), 0.3, seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for fn, args in (("logrank_test", (times, events, np.zeros(len(times)))),
                     ("cox_ph", (times, np.zeros(len(times), int), groups[:, None])),
                     ("cox_ph_clusters", (times, events, groups, 7))):
        with pytest.raises(ValueError):
            getattr(JS, fn)(*args)
        with pytest.raises(ValueError):
            getattr(TS, fn)(*args)


@pytest.mark.parametrize("seed", range(4))
def test_adjusted_rand_index_matches_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 300))
    a = rng.integers(0, int(rng.integers(1, 6)), n)
    b = np.where(rng.random(n) < 0.7, a * 3 + 1, rng.integers(0, 4, n))
    for x, y in ((a, b), (a, a), (a, a * 5 - 2), (a, np.zeros(n, int)), (a, np.arange(n))):
        assert abs(TC.adjusted_rand_index(x, y) - JC.adjusted_rand_index(x, y)) <= 1e-12


@pytest.mark.parametrize("n,k", [(60, 2), (150, 4), (200, 7)])
def test_silhouette_matches_sklearn(n, k):
    from_sklearn = pytest.importorskip("sklearn.metrics").silhouette_score
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    labels = rng.integers(0, k, n)
    labels[0] = k + 3  # a cluster of one row
    assert abs(TC.silhouette_score(x, labels, device=CPU) - from_sklearn(x, labels)) <= 1e-6
    x, labels = _planted(n=n, k=k, seed=n)
    assert abs(TC.silhouette_score(x, labels, device=CPU) - from_sklearn(x, labels)) <= 1e-6


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_kmeans_fit_from_the_reference_seeding(k, seed):
    x, _ = _planted(n=150, k=3, seed=seed)
    key = jax.random.PRNGKey(seed)
    want_l, want_c, want_i = (np.asarray(a) for a in JK.kmeans_fit(key, x, k, 50))
    init = np.asarray(jax.jit(JK._plus_plus_init, static_argnums=2)(key, jax.numpy.asarray(x), k))
    got_l, got_c, got_i = TK.kmeans_fit(torch.as_tensor(x), k, 50, init_centers=init)
    assert np.array_equal(got_l.numpy(), want_l)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-5)


def test_kmeans_seeding_and_empty_clusters():
    """k-means++ from a generator draws k distinct rows; a center with no
    rows keeps its place (the reference's guard)."""
    x, _ = _planted(n=50, k=3, seed=3)
    xt = torch.as_tensor(x)
    centers = TK._plus_plus_init(xt, 4, 6, torch.Generator().manual_seed(0))
    assert centers.shape == (6, 4, 8)
    for c in centers:
        rows = [int(np.flatnonzero((x == r.numpy()).all(1))[0]) for r in c]
        assert len(set(rows)) == 4
    far = np.concatenate([x[:2], np.full((1, 8), 1e3, np.float32)])
    labels, got, _ = TK.kmeans_fit(xt, 3, 5, init_centers=far)
    assert int((labels == 2).sum()) == 0 and np.allclose(got[2].numpy(), 1e3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_cluster_on_planted_clusters(seed):
    from sklearn.cluster import KMeans

    x, truth = _planted(n=150, k=3, seed=seed)
    got, centers = TC.kmeans_cluster(x, 3, seed=seed, device=CPU)
    want, _ = JC.kmeans_cluster(x, 3, seed=seed)
    assert TC.adjusted_rand_index(want, got) == 1.0 == TC.adjusted_rand_index(truth, got)
    inertia = float(((x - centers[got]) ** 2).sum())
    sk = KMeans(n_clusters=3, random_state=seed, n_init=10).fit(x).inertia_
    assert abs(inertia - sk) <= 1e-5 * sk
    assert np.array_equal(TC.cluster_patients(_Codes(x), None, 3, seed=seed), got)


class _Codes:
    """A stand-in model whose codes are given."""
    device = torch.device("cpu")

    def __init__(self, x):
        self.x = x

    def transform(self, _):
        return torch.as_tensor(self.x)


def test_select_n_clusters_by_silhouette():
    x, truth = _planted(n=120, k=4, sep=6.0, seed=5)
    k, scores, pred = TC.select_n_clusters(x, k_min=2, k_max=6, device=CPU)
    want_k, want_scores, _ = JC.select_n_clusters(x, k_min=2, k_max=6)
    assert k == want_k == 4 and TC.adjusted_rand_index(truth, pred) == 1.0
    for kk in scores:  # fixed-k partitions agree by ARI, so the scores agree
        assert abs(scores[kk] - want_scores[kk]) <= 1e-6 or kk > 4
    with pytest.raises(ValueError):
        TC.select_n_clusters(x[:2], k_min=2, device=CPU)


def test_consensus_accumulation_equals_a_recount():
    rng = np.random.default_rng(0)
    n, m, R = 30, 24, 7
    idx = np.stack([rng.permutation(n)[:m] for _ in range(R)])
    labels = rng.integers(0, 3, (R, m))
    C, S = TCO.accumulate(n, torch.as_tensor(idx), torch.as_tensor(labels))
    Cw, Sw = np.zeros((n, n)), np.zeros((n, n))
    for r in range(R):
        for a in range(m):
            for b in range(m):
                Sw[idx[r, a], idx[r, b]] += 1
                Cw[idx[r, a], idx[r, b]] += labels[r, a] == labels[r, b]
    assert np.array_equal(C.numpy(), Cw) and np.array_equal(S.numpy(), Sw)


def test_pac_and_cut_match_the_reference():
    x, truth = _planted(n=80, seed=4)
    M = JCO.consensus_matrix(x, 3, n_resamples=20, seed=0)
    noisy = np.clip(M + np.random.default_rng(1).normal(0, 0.2, M.shape), 0, 1)
    noisy = 0.5 * (noisy + noisy.T)
    for mat in (M, noisy):
        assert TCO.pac_score(mat) == JCO.pac_score(mat)
        assert TCO.pac_score(mat, 0.2, 0.8) == JCO.pac_score(mat, 0.2, 0.8)
        for k in (2, 3, 4):
            assert np.array_equal(TCO._cut_consensus(mat, k), JCO._cut_consensus(mat, k))
    got, Mt = TCO.consensus_cluster(x, 3, n_resamples=20, seed=0, device=CPU)
    assert TC.adjusted_rand_index(truth, got) == 1.0
    assert np.allclose(Mt, Mt.T) and np.allclose(np.diag(Mt), 1.0)
    with pytest.raises(ValueError):
        TCO.consensus_matrix(x[:4], 3, subsample=0.5, device=CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consensus_selects_the_reference_k(seed):
    x, truth = _planted(n=90, sep=6.0, seed=seed + 2)  # three well-apart centers
    kw = dict(k_min=2, k_max=5, n_resamples=15, seed=seed + 1)
    k, scores, pred = TCO.select_n_clusters_consensus(x, **kw, device=CPU)
    want_k, _, _ = JCO.select_n_clusters_consensus(x, **kw)
    assert k == want_k and sorted(scores) == [2, 3, 4, 5]
    assert TC.adjusted_rand_index(truth, pred) == 1.0

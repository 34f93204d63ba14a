"""Survival analysis of patient clusters: Kaplan-Meier, log-rank test and Cox
regression.

A copy of ``mdbn_tpu/analysis/survival.py`` (numpy and scipy only): after
k-means on the MDBN's joint latent codes, whether the discovered patient
subgroups differ in survival. The functions run on the host, as in the JAX
package; no external survival package is needed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def kaplan_meier(times: np.ndarray, events: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Kaplan-Meier estimator. ``times`` >= 0; ``events`` 1 = death observed,
    0 = censored. Returns (unique_event_times, survival_probability)."""
    times = np.asarray(times, float)
    events = np.asarray(events, int)
    order = np.argsort(times)
    times, events = times[order], events[order]
    uniq = np.unique(times[events == 1])
    surv = []
    s = 1.0
    for t in uniq:
        at_risk = np.sum(times >= t)
        deaths = np.sum((times == t) & (events == 1))
        s *= 1.0 - deaths / at_risk
        surv.append(s)
    return uniq, np.asarray(surv)


def logrank_test(times: np.ndarray, events: np.ndarray, groups: np.ndarray,
                 method: str = "exact") -> Dict[str, float]:
    """K-group log-rank test (chi-square with K-1 dof).

    ``method="exact"`` (default) is the standard variance-normalized
    statistic: at each distinct event time the group death counts follow a
    multivariate hypergeometric distribution under the null, giving
    covariance ``V_jk = sum_t d_t (n_t-d_t)/(n_t-1) *
    (delta_jk n_kt/n_t - n_jt n_kt/n_t^2)``; the statistic is
    ``(O-E)' V^- (O-E)`` over the first K-1 groups (Liang et al. 2015 report
    log-rank this way). ``method="approx"`` is the conservative
    sum-of-(O-E)^2/E construction, kept as a cross-check.
    """
    from scipy import stats

    times = np.asarray(times, float)
    events = np.asarray(events, int)
    groups = np.asarray(groups)
    labels = np.unique(groups)
    K = len(labels)
    if K < 2:
        raise ValueError("log-rank test needs >= 2 groups")
    if method not in ("exact", "approx"):
        raise ValueError(f"method must be 'exact' or 'approx', got {method!r}")

    event_times = np.unique(times[events == 1])
    O = np.zeros(K)
    E = np.zeros(K)
    V = np.zeros((K, K))
    for t in event_times:
        at_risk = times >= t
        n_t = at_risk.sum()
        d_t = ((times == t) & (events == 1)).sum()
        n_kt = np.array([(at_risk & (groups == g)).sum() for g in labels], float)
        O += np.array([((times == t) & (events == 1) & (groups == g)).sum()
                       for g in labels], float)
        E += d_t * n_kt / n_t
        if n_t > 1:
            frac = n_kt / n_t
            V += (d_t * (n_t - d_t) / (n_t - 1)) * (np.diag(frac) - np.outer(frac, frac))
    dof = K - 1
    if method == "approx":
        valid = E > 0
        chi2 = float(np.sum((O[valid] - E[valid]) ** 2 / E[valid]))
    else:
        # drop the last group: (O-E) sums to 0, so V is singular over all K
        z = (O - E)[:dof]
        chi2 = float(z @ np.linalg.pinv(V[:dof, :dof]) @ z)
    p = float(stats.chi2.sf(chi2, dof))
    return {"chi2": chi2, "dof": dof, "p_value": p, "method": method,
            "observed": O.tolist(), "expected": E.tolist()}


def cox_ph(times: np.ndarray, events: np.ndarray, covariates: np.ndarray,
           max_iter: int = 50, tol: float = 1e-9) -> Dict:
    """Cox proportional-hazards regression (Breslow tie handling),
    Newton-Raphson on the partial log-likelihood.

    The covariate-adjusted companion to ``logrank_test``: where log-rank
    only asks "do the groups differ", Cox quantifies BY HOW MUCH (hazard
    ratios with confidence intervals) and admits arbitrary covariates
    (age, stage, ...) alongside the cluster indicators. With no ties, the
    score test of this model at beta=0 for a 2-group indicator IS the
    log-rank test — pinned exactly in tests/test_survival.py.

    Returns {beta, hazard_ratio, se, z, p_wald, ci95_low/high (on the HR),
    log_likelihood, null_log_likelihood, lr_chi2, lr_p (likelihood-ratio
    test vs the null model), score_chi2, score_p (score test at beta=0),
    n_iter, converged}.
    """
    from scipy import stats

    times = np.asarray(times, float)
    events = np.asarray(events, int)
    X = np.atleast_2d(np.asarray(covariates, float))
    if X.shape[0] != len(times):
        X = X.T
    if X.shape[0] != len(times):
        raise ValueError(f"covariates have {np.shape(covariates)} rows for "
                         f"{len(times)} patients")
    n, p = X.shape
    if events.sum() == 0:
        raise ValueError("no observed events — Cox model is undefined")
    # center covariates for numerical stability (beta is invariant)
    Xc = X - X.mean(axis=0)
    event_times = np.unique(times[events == 1])

    def ll_grad_hess(beta):
        eta = Xc @ beta
        eta = eta - eta.max()                     # stabilize exp
        w = np.exp(eta)
        ll, g, H = 0.0, np.zeros(p), np.zeros((p, p))
        for t in event_times:
            at_risk = times >= t
            d_mask = (times == t) & (events == 1)
            d = int(d_mask.sum())
            s0 = w[at_risk].sum()
            s1 = Xc[at_risk].T @ w[at_risk]
            s2 = (Xc[at_risk] * w[at_risk, None]).T @ Xc[at_risk]
            xbar = s1 / s0
            ll += eta[d_mask].sum() - d * np.log(s0)
            g += Xc[d_mask].sum(axis=0) - d * xbar
            H -= d * (s2 / s0 - np.outer(xbar, xbar))
        return ll, g, H

    ll0, g0, H0 = ll_grad_hess(np.zeros(p))
    # score test at beta=0 (== log-rank for a tie-free 2-group indicator)
    I0 = -H0
    score_chi2 = float(g0 @ np.linalg.pinv(I0) @ g0)
    score_p = float(stats.chi2.sf(score_chi2, p))

    beta = np.zeros(p)
    ll = ll0
    converged = False
    it = 0
    for it in range(1, max_iter + 1):
        ll, g, H = ll_grad_hess(beta)
        step = np.linalg.solve(H - 1e-10 * np.eye(p), -g)
        # halve until the partial likelihood does not decrease
        for _ in range(30):
            new_ll, _, _ = ll_grad_hess(beta + step)
            if new_ll >= ll - 1e-12:
                break
            step *= 0.5
        beta = beta + step
        if np.max(np.abs(step)) < tol:
            converged = True
            break
    ll, g, H = ll_grad_hess(beta)
    cov = np.linalg.pinv(-H)
    se = np.sqrt(np.maximum(np.diag(cov), 0.0))
    z = np.where(se > 0, beta / np.where(se > 0, se, 1.0), 0.0)
    p_wald = 2.0 * stats.norm.sf(np.abs(z))
    lr_chi2 = float(2.0 * (ll - ll0))
    zq = stats.norm.ppf(0.975)
    return {
        "beta": beta.tolist(),
        "hazard_ratio": np.exp(beta).tolist(),
        "se": se.tolist(),
        "z": z.tolist(),
        "p_wald": p_wald.tolist(),
        "ci95_low": np.exp(beta - zq * se).tolist(),
        "ci95_high": np.exp(beta + zq * se).tolist(),
        "log_likelihood": float(ll),
        "null_log_likelihood": float(ll0),
        "lr_chi2": lr_chi2,
        "lr_p": float(stats.chi2.sf(lr_chi2, p)),
        "score_chi2": score_chi2,
        "score_p": score_p,
        "n_iter": it,
        "converged": bool(converged),
    }


def cox_ph_clusters(times: np.ndarray, events: np.ndarray,
                    groups: np.ndarray, baseline: int = 0,
                    extra_covariates: np.ndarray = None) -> Dict:
    """Cox regression on cluster-indicator covariates: hazard ratio of every
    cluster vs the ``baseline`` cluster, optionally adjusted for
    ``extra_covariates`` [n, q] (e.g. age). Returns the ``cox_ph`` dict plus
    ``clusters`` naming each coefficient."""
    groups = np.asarray(groups)
    labels = [g for g in np.unique(groups) if g != baseline]
    if baseline not in np.unique(groups):
        raise ValueError(f"baseline cluster {baseline} not present in groups")
    if not labels:
        raise ValueError("cox_ph_clusters needs >= 2 distinct clusters")
    X = np.stack([(groups == g).astype(float) for g in labels], axis=1)
    names = [f"cluster_{g}_vs_{baseline}" for g in labels]
    if extra_covariates is not None:
        extra = np.atleast_2d(np.asarray(extra_covariates, float))
        if extra.shape[0] != len(groups):
            extra = extra.T
        X = np.concatenate([X, extra], axis=1)
        names += [f"covariate_{i}" for i in range(extra.shape[1])]
    out = cox_ph(times, events, X)
    out["clusters"] = names
    return out


def synthetic_survival(labels: np.ndarray, mean_survival: Tuple[float, ...] = (1.0, 2.0, 4.0),
                       censor_rate: float = 0.2, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Planted-survival generator for tests/demos: exponential survival times
    with a per-cluster MEAN survival time (= 1/hazard; numpy's exponential
    ``scale``) + uniform censoring. Clusters beyond ``len(mean_survival)``
    get the geometric extension (each further cluster doubles the last given
    mean) so distinct planted clusters never silently share a distribution."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    n_groups = int(labels.max()) + 1 if len(labels) else 0
    scales = list(map(float, mean_survival))
    while len(scales) < n_groups:
        scales.append(scales[-1] * 2.0)
    scales = np.asarray(scales, float)
    t = rng.exponential(scales[labels])
    censored = rng.random(len(t)) < censor_rate
    t = np.where(censored, t * rng.random(len(t)), t)
    return t, (~censored).astype(int)

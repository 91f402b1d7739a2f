"""Synthetic data generators from the paper's §4 and Appendix C.1.

The port's own numpy copy of `repro.data.synthetic` (the port imports
nothing of the JAX package); a test holds the two bitwise equal.

Clustering: stick-breaking for the Dirichlet process (theta = 1), cluster
means mu_k ~ N(0, I_16), points x_i ~ N(mu_{z_i}, 1/4 I_16).

Feature modeling: Paisley et al. stick-breaking for the Beta process,
truncated so remaining weights are negligible (< 1e-4 w.p. > 0.9999);
f_k ~ N(0, I_16), x_i ~ N(sum_k z_ik f_k, 1/4 I_16).

Appendix C.1: separable clusters — DP stick-breaking proportions, centers
mu_k = (2k, 0, ..., 0), points uniform in a ball of radius 1/2 (within-
cluster diameter <= 1 < between-cluster distance), matching Thm 3.3's
assumptions with lambda = 1.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dp_stick_breaking_data", "bp_stick_breaking_data",
           "separable_cluster_data"]


def _dp_sticks_assign(rng: np.random.Generator, n: int, theta: float):
    """On-the-fly DP stick-breaking: break sticks as new clusters are needed."""
    weights: list[float] = []
    remaining = 1.0
    z = np.zeros(n, np.int64)
    u = rng.uniform(size=n)
    for i in range(n):
        # extend sticks until cumulative weight covers u[i]
        while u[i] > 1.0 - remaining:
            beta = rng.beta(1.0, theta)
            weights.append(remaining * beta)
            remaining *= 1.0 - beta
        c = np.searchsorted(np.cumsum(weights), u[i])
        z[i] = min(c, len(weights) - 1)
    return z, np.asarray(weights)


def dp_stick_breaking_data(n: int, dim: int = 16, theta: float = 1.0,
                           noise: float = 0.5, seed: int = 0):
    """Paper §4 clustering data.  noise=0.5 -> covariance (1/4) I."""
    rng = np.random.default_rng(seed)
    z, _ = _dp_sticks_assign(rng, n, theta)
    k = int(z.max()) + 1
    mus = rng.normal(size=(k, dim))
    x = mus[z] + noise * rng.normal(size=(n, dim))
    return x.astype(np.float32), z, mus.astype(np.float32)


def bp_stick_breaking_data(n: int, dim: int = 16, theta: float = 1.0,
                           noise: float = 0.5, seed: int = 0,
                           w_min: float = 1e-4, tail_prob: float = 1e-4):
    """Paper §4 feature data via Beta-process stick-breaking [20].

    Rounds of sticks: in round r, weights are products of r Beta(theta, 1)
    variables; truncate after enough rounds that remaining weights are
    < w_min with high probability (E[w_round_r] = (theta/(theta+1))^r).
    """
    rng = np.random.default_rng(seed)
    weights: list[float] = []
    v_prod = 1.0
    r = 0
    # (theta/(theta+1))^r < w_min * tail_prob  gives a conservative truncation
    while v_prod > w_min * tail_prob and r < 200:
        r += 1
        n_r = rng.poisson(theta)
        v = rng.beta(theta, 1.0, size=max(n_r, 0))
        v_prod *= (theta / (theta + 1.0))
        for vv in v:
            weights.append(float(np.prod(rng.beta(theta, 1.0, size=r))))
    w = np.clip(np.asarray(weights), 0.0, 1.0)
    w = w[w > w_min]
    if w.size == 0:
        w = np.asarray([0.5])
    k = w.size
    zmat = rng.uniform(size=(n, k)) < w[None, :]
    # every point should have at least one active feature for realism
    empty = ~zmat.any(axis=1)
    zmat[empty, rng.integers(0, k, size=int(empty.sum()))] = True
    feats = rng.normal(size=(k, dim))
    x = zmat.astype(np.float64) @ feats + noise * rng.normal(size=(n, dim))
    return x.astype(np.float32), zmat, feats.astype(np.float32)


def separable_cluster_data(n: int, dim: int = 16, theta: float = 1.0, seed: int = 0):
    """Appendix C.1 separable data: within-cluster diameter <= 1, between-
    cluster distance > 1; use with lambda = 1 for Thm 3.3's regime."""
    rng = np.random.default_rng(seed)
    z, _ = _dp_sticks_assign(rng, n, theta)
    k = int(z.max()) + 1
    mus = np.zeros((k, dim))
    mus[:, 0] = 2.0 * np.arange(k)
    # uniform in the ball of radius 1/2
    g = rng.normal(size=(n, dim))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    radii = 0.5 * rng.uniform(size=(n, 1)) ** (1.0 / dim)
    x = mus[z] + g * radii
    return x.astype(np.float32), z, mus.astype(np.float32)

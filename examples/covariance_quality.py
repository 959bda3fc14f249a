"""Covariance estimation quality in the undersampled regime (n < p).

The reference's headline use case (paper: "Low Complexity Gaussian Latent
Factor Models and a Blessing of Dimensionality", arXiv:1706.03353;
SURVEY.md §2.0 "Covariance estimator"): `get_covariance()` as a
structured estimate of Σ that beats the sample covariance — and standard
shrinkage — when p exceeds n.

This script draws data from a KNOWN block covariance, so estimator error
is measured against ground truth, not held-out proxies:

    Σ_true: `n_blocks` equicorrelated blocks (within-block correlation r),
    x ~ N(0, Σ_true), n samples with n < p.

Estimators compared (all on the same draw):
  - sample covariance (the MLE; rank-deficient at n < p)
  - Ledoit-Wolf shrinkage toward scaled identity (the standard fix;
    NumPy implementation of the 2004 estimator below)
  - Linear CorEx `get_covariance()` (m = n_blocks factors)

Run: python examples/covariance_quality.py  (CPU or GPU; ~20 s on CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import linearcorex_tpu as lc


def make_block_cov(p, n_blocks, r):
    """Block-diagonal equicorrelated covariance with unit variances."""
    k = p // n_blocks
    sigma = np.eye(p)
    for b in range(n_blocks):
        s = slice(b * k, (b + 1) * k)
        sigma[s, s] = r
    np.fill_diagonal(sigma, 1.0)
    return sigma


def ledoit_wolf(x):
    """Ledoit-Wolf (2004) shrinkage toward mu*I, plain NumPy.

    S_lw = (1-delta)*S + delta*mu*I with the closed-form optimal delta
    estimated from the data (their eqs. 14: b^2/d^2 with pilot m, d, b)."""
    n, p = x.shape
    xc = x - x.mean(0)
    s = xc.T @ xc / n
    mu = np.trace(s) / p
    d2 = np.sum((s - mu * np.eye(p)) ** 2) / p
    b2_sum = 0.0
    for i in range(n):
        xi = xc[i][:, None]
        b2_sum += np.sum((xi @ xi.T - s) ** 2) / p
    b2 = min(b2_sum / n ** 2, d2)
    delta = b2 / d2
    return (1.0 - delta) * s + delta * mu * np.eye(p), delta


def frob_rel(est, true):
    return float(np.linalg.norm(est - true) / np.linalg.norm(true))


def main():
    p, n, n_blocks, r = 256, 64, 16, 0.7
    rng = np.random.RandomState(0)
    sigma_true = make_block_cov(p, n_blocks, r)
    chol = np.linalg.cholesky(sigma_true)
    x = rng.normal(size=(n, p)) @ chol.T

    xc = x - x.mean(0)
    sample_cov = xc.T @ xc / n
    lw_cov, delta = ledoit_wolf(x)

    model = lc.Corex(n_hidden=n_blocks, seed=0, max_iter=10000)
    model.fit(x)
    corex_cov = np.asarray(model.get_covariance())

    rows = [
        ("sample covariance (MLE)", frob_rel(sample_cov, sigma_true)),
        (f"Ledoit-Wolf shrinkage (delta={delta:.2f})",
         frob_rel(lw_cov, sigma_true)),
        ("Linear CorEx get_covariance()", frob_rel(corex_cov, sigma_true)),
    ]
    print(f"p={p}, n={n} (n/p={n/p:.2f}), {n_blocks} blocks, r={r}\n")
    print(f"{'estimator':42s} rel. Frobenius error vs true Σ")
    for name, err in rows:
        print(f"{name:42s} {err:.4f}")
    blocks_found = len(set(np.asarray(model.clusters).tolist()))
    print(f"\nclusters recovered: {blocks_found}/{n_blocks} distinct "
          f"factors used, TC={float(model.tc):.1f}")


if __name__ == "__main__":
    main()

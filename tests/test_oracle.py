"""Property tests for the float64 oracle (SURVEY.md §4.2 item 2).

The oracle is the executable spec; these tests pin down the behaviors the JAX
path must then match to 1e-5 (test_parity.py).
"""

import numpy as np
import pytest
from scipy.optimize import minimize

from linearcorex_tpu.oracle import (
    OracleCorex,
    anneal_schedule,
    calculate_moments,
    pick_n_hidden_oracle,
)
from tests.conftest import block_data


def test_block_recovery(med_block_data):
    x = med_block_data
    c = OracleCorex(n_hidden=8, seed=42).fit(x)
    cl = c.clusters
    k = 64 // 8
    for j in range(8):
        assert len(set(cl[j * k:(j + 1) * k])) == 1, "block split across factors"
    # distinct blocks get distinct factors
    assert len({cl[j * k] for j in range(8)}) == 8


def test_tc_close_to_direct_gaussian_tc(med_block_data):
    x = med_block_data
    c = OracleCorex(n_hidden=8, seed=42).fit(x)
    s = np.corrcoef(x.T)
    tc_direct = -0.5 * np.linalg.slogdet(s)[1]
    # TC is a lower bound on the Gaussian TC; on block data it should be tight.
    assert c.tc <= tc_direct + 1e-6
    assert c.tc >= 0.9 * tc_direct


def test_mi_nonnegative_tcs_sorted(med_block_data):
    c = OracleCorex(n_hidden=8, seed=1).fit(med_block_data)
    assert np.all(c.mis >= 0)
    assert np.all(np.diff(c.tcs) <= 1e-12), "tcs must be sorted decreasing"


def test_anneal_blend_identity():
    """Analytic moment blend == explicit noise injection (in expectation)."""
    rng = np.random.RandomState(7)
    n, p, m = 200000, 6, 2
    x = rng.normal(size=(n, p))
    x = (x - x.mean(0)) / x.std(0)
    w = rng.normal(size=(m, p))
    eps = 0.5
    m_blend = calculate_moments(x, w, eps=eps)
    z = rng.normal(size=(n, p))
    x_noisy = np.sqrt(1 - eps ** 2) * x + eps * z
    m_noisy = calculate_moments(x_noisy, w, eps=0.0)
    err = np.abs(m_blend["X_i Y_j"] - m_noisy["X_i Y_j"]).max()
    assert err < 0.05, f"anneal blend mismatch {err}"


def test_get_covariance_psd_unit_diag(med_block_data):
    c = OracleCorex(n_hidden=8, seed=0).fit(med_block_data)
    cov = c.get_covariance()
    std = c.pre.theta[1]
    corr = cov / np.outer(std, std)
    assert np.allclose(np.diag(corr), 1.0)
    evals = np.linalg.eigvalsh(corr)
    assert evals.min() > -1e-8, "covariance estimate must be PSD"
    s = np.corrcoef(med_block_data.T)
    assert np.abs(corr - s).max() < 0.15


def test_transform_predict_roundtrip_block():
    """On near-noiseless block data, predict(transform(x)) ~ x.

    The reconstruction is the product-of-experts posterior mean (SURVEY.md
    §3.3) — exact for block/tree-structured dependence, so recovery should be
    near-perfect when each variable is driven by one factor."""
    x = block_data(n=800, p=24, m=3, seed=5, strength=0.98)
    c = OracleCorex(n_hidden=3, seed=0).fit(x)
    xh = c.predict(c.transform(x))
    resid = np.linalg.norm(xh - x) / np.linalg.norm(x)
    assert resid < 0.2, f"roundtrip residual {resid}"


def test_predict_is_wiener_filter_single_factor():
    """With m=1 the PoE reconstruction reduces exactly to the Wiener filter
    E[x_i|y] = rho_i y / sqrt(z2); cross-check against direct least squares."""
    x = block_data(n=4000, p=8, m=1, seed=6, strength=0.9)
    c = OracleCorex(n_hidden=1, seed=0).fit(x)
    y = c.transform(x)
    xh = c.predict(y)
    # direct per-column regression of standardized x on y, accounting for the
    # analytic factor noise: z2_model = <y^2>_emp + y_scale^2
    xs = c._x_fit
    n = xs.shape[0]
    coef = (xs.T @ y / n) / (y.T @ y / n + 1.0)      # p x 1, eta=1
    xh_ls = c.pre.invert(y @ coef.T)
    assert np.abs(xh - xh_ls).max() < 0.02


def test_fixed_point_is_stationary(small_block_data):
    """The damped fixed point must land on a stationary point of the
    objective — cross-checked against L-BFGS from the same point."""
    x = small_block_data
    c = OracleCorex(n_hidden=4, seed=0).fit(x)
    xs = c._x_fit

    def obj(wflat):
        return calculate_moments(xs, wflat.reshape(4, 32))["objective"]

    f0 = obj(c.ws.ravel())
    res = minimize(obj, c.ws.ravel(), method="L-BFGS-B")
    assert res.fun >= f0 - 1e-5, "L-BFGS improved on the fixed point"


def test_overlap_false_path(small_block_data):
    c = OracleCorex(n_hidden=4, discourage_overlap=False, seed=0,
                    max_iter=3000).fit(small_block_data)
    assert c.tc > 0
    cov = c.get_covariance()
    assert cov.shape == (32, 32)
    y = c.transform(small_block_data)
    assert c.predict(y).shape == small_block_data.shape


def test_gaussianize_modes():
    rng = np.random.RandomState(2)
    x = rng.lognormal(size=(400, 10))  # heavy-tailed
    for mode in ("standard", "outliers", "empirical"):
        c = OracleCorex(n_hidden=2, gaussianize=mode, seed=0,
                        max_iter=1000).fit(x)
        assert np.isfinite(c.tc)
    # 'none' is a pass-through: the solver assumes <x_i^2>=1 (SURVEY.md §2.2),
    # so the caller must standardize.
    xs = (x - x.mean(0)) / x.std(0)
    c = OracleCorex(n_hidden=2, gaussianize="none", seed=0,
                    max_iter=1000).fit(xs)
    assert np.isfinite(c.tc)
    # empirical gaussianization produces ~N(0,1) columns
    c = OracleCorex(n_hidden=2, gaussianize="empirical", seed=0)
    xe = c.pre.fit_transform(x)
    assert np.abs(xe.mean(0)).max() < 0.05
    assert np.abs(xe.std(0) - 1).max() < 0.05


def test_missing_values_imputation():
    x = block_data(n=300, p=16, m=2, seed=4)
    x_miss = x.copy()
    x_miss[::7, 3] = -999.0
    c = OracleCorex(n_hidden=2, missing_values=-999.0, seed=0).fit(x_miss)
    assert np.isfinite(c.tc)
    cl_clean = OracleCorex(n_hidden=2, seed=0).fit(x).clusters
    # same partition up to factor relabeling
    mapping = {}
    for a, b in zip(c.clusters, cl_clean):
        assert mapping.setdefault(a, b) == b


def test_pretrained_weights_warm_start(small_block_data):
    c1 = OracleCorex(n_hidden=4, seed=0).fit(small_block_data)
    c2 = OracleCorex(n_hidden=4, pretrained_weights=c1.ws,
                     anneal=False).fit(small_block_data)
    # warm start from the solution converges almost immediately
    assert c2.history["iters_per_stage"][0] < 20
    assert abs(c2.tc - c1.tc) < 1e-3


def test_anneal_schedule_shape():
    assert anneal_schedule(True, 8, True) == pytest.approx(
        [0.6, 0.36, 0.216, 0.1296, 0.07776, 0.046656, 0.0])
    assert anneal_schedule(False, 8, True) == [0.0]
    assert anneal_schedule(True, 1, True) == [0.0]
    assert anneal_schedule(True, 8, False) == [0.0]


def test_pick_n_hidden():
    x = block_data(n=800, p=24, m=3, seed=9)
    best_n, scores = pick_n_hidden_oracle(x, repeat=2, max_n_hidden=6,
                                          max_iter=2000)
    assert best_n == 3
    assert len(scores) >= 3


def test_under_sampled_regime_stable():
    """n << p (BASELINE config 3 shape, scaled down): rho -> +-1 risk."""
    x = block_data(n=50, p=200, m=4, seed=11)
    c = OracleCorex(n_hidden=4, seed=0).fit(x)
    assert np.isfinite(c.tc)
    assert np.all(np.isfinite(c.ws))

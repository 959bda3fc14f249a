"""Oracle parity: the JAX path must reproduce the float64 oracle.

This is the contract from BASELINE.json ("matches the NumPy reference to
1e-5 on TC and recovered weights") executed per SURVEY.md §4.2 item 1: both
implementations consume the same explicit `init_ws`, run the identical
deterministic solver, and must agree step-for-step in float64. The float32
production dtype (float32) is held to the looser-but-meaningful bars
(same clusters, TC to 1e-3 relative).
"""

import numpy as np
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.oracle import OracleCorex
from tests.conftest import block_data


def _shared_init(m, p, seed=42):
    return np.random.RandomState(seed).normal(scale=1.0 / np.sqrt(p),
                                              size=(m, p))


@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_f64_parity_nonoverlap(strategy, med_block_data):
    x = med_block_data
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64",
                 moment_strategy=strategy).fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8).fit(x, init_ws=w0)
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() == \
        o.history["iters_per_stage"], "solver must be step-matched"
    assert abs(c.tc - o.tc) < 1e-5
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-5
    assert np.array_equal(np.asarray(c.clusters), o.clusters)
    assert np.abs(np.asarray(c.tcs) - o.tcs).max() < 1e-5
    assert np.abs(np.asarray(c.mis) - o.mis).max() < 1e-5


@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_f64_parity_overlap(strategy, small_block_data):
    x = small_block_data
    w0 = _shared_init(4, 32, seed=7)
    c = lc.Corex(n_hidden=4, dtype="float64", discourage_overlap=False,
                 max_iter=2000, moment_strategy=strategy).fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=4, discourage_overlap=False,
                    max_iter=2000).fit(x, init_ws=w0)
    # Converged-optimum comparison (NOT step-matched — the step-matched
    # 1e-8 surface is the non-overlap tests above): both solvers stop at
    # |ΔW| < tol=1e-5, so TC agreement is bounded by stopping noise, and
    # rounding-level input differences (e.g. the fused prepare program's
    # reduction order vs the oracle's NumPy order) shift the long
    # trajectory by ~1e-4 on TC ≈ 10.7 (1e-5 relative).
    assert abs(c.tc - o.tc) < 5e-4
    # The overlap objective has weakly-determined directions at the optimum,
    # so tiny fp ordering differences (gram vs samples associativity, cho vs
    # inv solves) drift W along the flat manifold while TC pins the optimum.
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 5e-3


def test_f64_parity_inference(med_block_data):
    x = med_block_data
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8).fit(x, init_ws=w0)
    y, yo = np.asarray(c.transform(x)), o.transform(x)
    assert np.abs(y - yo).max() < 1e-5
    assert np.abs(np.asarray(c.predict(y)) - o.predict(yo)).max() < 1e-5
    assert np.abs(np.asarray(c.get_covariance())
                  - o.get_covariance()).max() < 1e-5


def test_f64_details_moments(med_block_data):
    x = med_block_data
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8).fit(x, init_ws=w0)
    _, md = c.transform(x, details=True)
    mo = o.transform(x, details=True)[1]
    for key in ("rho", "Si", "TCs", "MI", "X_i^2 | Y", "Y_j^2"):
        assert np.abs(np.asarray(md[key]) - mo[key]).max() < 1e-5, key


def test_f32_dtype_quality(med_block_data):
    """float32 (the production dtype): identical clusters, close TC."""
    x = med_block_data
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float32").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8).fit(x, init_ws=w0)
    assert np.array_equal(np.asarray(c.clusters), o.clusters), \
        "cluster assignments must be stable under float32"
    assert abs(c.tc - o.tc) / o.tc < 1e-3


def test_gaussianize_parity():
    rng = np.random.RandomState(2)
    x = rng.lognormal(size=(300, 12))
    for mode in ("standard", "outliers", "empirical"):
        import linearcorex_tpu.ops.preprocessing as P
        import jax.numpy as jnp
        xp_jax, theta = P.fit_preprocess(jnp.asarray(x, jnp.float64), mode)
        from linearcorex_tpu.oracle.oracle import _Preprocessor
        pre = _Preprocessor(gaussianize=mode)
        xp_np = pre.fit_transform(x)
        assert np.abs(np.asarray(xp_jax) - xp_np).max() < 1e-9, mode


def test_rankdata_ties_match_scipy():
    from scipy.stats import rankdata as scipy_rankdata
    import jax.numpy as jnp
    from linearcorex_tpu.ops.preprocessing import rankdata_average
    col = np.array([3.0, 1.0, 2.0, 2.0, 2.0, 5.0, 1.0])
    got = np.asarray(rankdata_average(jnp.asarray(col)))
    assert np.allclose(got, scipy_rankdata(col))


def test_missing_values_parity():
    x = block_data(n=300, p=16, m=2, seed=4)
    x[::5, 2] = -1.0
    w0 = _shared_init(2, 16, seed=1)
    c = lc.Corex(n_hidden=2, missing_values=-1.0,
                 dtype="float64").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=2, missing_values=-1.0).fit(x, init_ws=w0)
    assert abs(c.tc - o.tc) < 1e-5
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-5


def test_under_sampled_parity():
    """n << p regime (BASELINE config 3 shape, scaled): rho clipping path."""
    x = block_data(n=60, p=240, m=4, seed=11)
    w0 = _shared_init(4, 240, seed=5)
    c = lc.Corex(n_hidden=4, dtype="float64").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=4).fit(x, init_ws=w0)
    assert abs(c.tc - o.tc) < 1e-4
    assert np.array_equal(np.asarray(c.clusters), o.clusters)


def test_full_moment_dict_keys_parity(med_block_data):
    """The details dict carries every key the oracle's full moments have."""
    x = med_block_data
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8).fit(x, init_ws=w0)
    _, md = c.transform(x, details=True)
    mo = o.transform(x, details=True)[1]
    for key in mo:
        assert key in md, f"missing moment key {key!r}"
    assert np.abs(np.asarray(md["X_i Z_j"]) - mo["X_i Z_j"]).max() < 1e-5
    assert abs(float(md["additivity"]) - mo["additivity"]) < 1e-4


def test_f64_parity_stage_tol_factor(med_block_data):
    """stage_tol_factor=10 stays step-matched with the oracle (the
    per-stage tol schedule is mirrored exactly: non-final stages at
    tol x factor, final stage at tol) — and actually changes the
    trajectory vs factor=1, so the pin is not vacuous."""
    x = med_block_data
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64",
                 stage_tol_factor=10.0).fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8, stage_tol_factor=10.0).fit(x, init_ws=w0)
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() == \
        o.history["iters_per_stage"], "solver must be step-matched"
    assert abs(c.tc - o.tc) < 1e-5
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-5
    base = lc.Corex(n_hidden=8, dtype="float64").fit(x, init_ws=w0)
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() != \
        np.asarray(base.diagnostics.iters_per_stage).tolist()

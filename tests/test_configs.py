"""The five BASELINE.json acceptance configs as integration tests
(SURVEY.md §4.2 item 4).

Configs 2/3/5 run at CI-scaled sizes (same shape regime, smaller constants)
so the suite stays fast on the single-core CPU test runner; `bench.py` and
`benchmarks/` exercise the full sizes on the GPU.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.config import CorexConfig
from linearcorex_tpu.models.stacked import StackedCorex
from linearcorex_tpu.oracle import OracleCorex
from linearcorex_tpu.ops import preprocessing as P
from linearcorex_tpu.parallel.restarts import fit_restarts, init_restarts
from linearcorex_tpu.parallel.sharding import (DATA_AXIS, ShardingPlan,
                                               fit_sharded, make_mesh)
from tests.conftest import block_data


def test_config1_block_diag_cpu_parity():
    """Config 1: p=128, m=8, n=1k — full size, NumPy-oracle parity."""
    x = block_data(n=1000, p=128, m=8, seed=0)
    w0 = np.random.RandomState(1).normal(scale=1 / np.sqrt(128),
                                         size=(8, 128))
    c = lc.Corex(n_hidden=8, dtype="float64").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8).fit(x, init_ws=w0)
    assert abs(c.tc - o.tc) < 1e-5
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-5
    assert np.array_equal(np.asarray(c.clusters), o.clusters)
    cl = np.asarray(c.clusters)
    assert all(len(set(cl[j * 16:(j + 1) * 16])) == 1 for j in range(8))


def test_config2_modular_recovery_seed_matched():
    """Config 2 (CI-scaled p=256, m=8): discourage_overlap + full anneal,
    seed-matched to the oracle."""
    x = block_data(n=2000, p=256, m=8, seed=2, strength=0.8)
    c = lc.Corex(n_hidden=8, seed=5, dtype="float64",
                 discourage_overlap=True, anneal=True).fit(x)
    o = OracleCorex(n_hidden=8, seed=5).fit(x)
    # same seed → same init (shared NumPy RandomState) → same solution
    assert abs(c.tc - o.tc) < 1e-5
    assert np.array_equal(np.asarray(c.clusters), o.clusters)


def test_config3_undersampled_omics():
    """Config 3 (CI-scaled p=1000, n=100, m=16): n << p covariance stress."""
    x = block_data(n=100, p=1000, m=16, seed=3, strength=0.85)
    c = lc.Corex(n_hidden=16, seed=0).fit(x)
    assert np.isfinite(c.tc) and c.tc > 0
    assert np.all(np.isfinite(np.asarray(c.ws)))
    # blessing of dimensionality: structure still recoverable at n=100
    cl = np.asarray(c.clusters)
    frac_pure = np.mean([
        len(set(cl[j * 62:(j + 1) * 62 - 30])) == 1 for j in range(16)])
    assert frac_pure > 0.7


def _market_like_returns(n=750, p=120, sectors=10, seed=11):
    """Synthetic daily-returns-like data: one market factor + sector factors
    + idiosyncratic noise, heavy-ish tails (config 4 stand-in; the real
    S&P panel is not available offline)."""
    rng = np.random.RandomState(seed)
    market = rng.standard_t(df=5, size=(n, 1))
    sector = rng.standard_t(df=5, size=(n, sectors))
    k = p // sectors
    x = np.empty((n, p))
    for s in range(sectors):
        for i in range(k):
            x[:, s * k + i] = (0.4 * market[:, 0] + 0.7 * sector[:, s]
                               + 0.6 * rng.normal(size=n))
    return 0.01 * x


def test_config4_two_layer_stacked_market():
    """Config 4: 2-layer stacked CorEx on market-like returns; layer 2 fits
    on layer-1 latent factors Y."""
    x = _market_like_returns()
    s = StackedCorex([10, 1], seed=0, gaussianize="outliers").fit(x)
    cl1 = np.asarray(s.clusters[0])
    k = 120 // 10
    frac_pure = np.mean([
        len(set(cl1[j * k:(j + 1) * k])) == 1 for j in range(10)])
    assert frac_pure >= 0.8, "sectors should map to layer-1 factors"
    # the shared market factor makes sector factors correlated → layer 2
    # captures it as positive TC
    assert float(np.sum(np.asarray(s.tcs[1]))) > 0.1
    assert s.tc > 0


def test_config5_sharded_restart_sweep():
    """Config 5 (CI-scaled p=512, m=16, 8 restarts): sample-sharded moments
    over the 8-device mesh + vmapped restart sweep."""
    x = block_data(n=512, p=512, m=16, seed=4)
    xj = jnp.asarray(x, jnp.float32)
    xp, _ = P.fit_preprocess(xj, "standard")
    cfg = CorexConfig(n_hidden=16, dtype="float32", record_history=False,
                      max_iter=2000)
    # vmapped restart sweep (single device)
    w0 = init_restarts(8, 16, 512, seed=0, dtype=jnp.float32)
    ws_b, mom_b, _ = fit_restarts(xp, w0, cfg, "samples")
    tcs = np.asarray(mom_b.tc)
    assert np.all(np.isfinite(tcs)) and tcs.max() > 0
    # sample-sharded fit equals single-device fit
    mesh = make_mesh(((DATA_AXIS, 8),))
    ws_sh, mom_sh, _ = fit_sharded(xp, w0[0], cfg, mesh, ShardingPlan())
    from linearcorex_tpu.models.corex import _fit_program
    ws_1, mom_1, _ = _fit_program(xp, w0[0], cfg, "samples")
    # float32: psum reduction order differs from the single-device GEMM, and
    # the adaptive-GD trajectory amplifies ulp-level differences; the f64
    # sharding suite (test_sharding.py) pins 1e-7 equivalence.
    assert np.abs(np.asarray(ws_sh) - np.asarray(ws_1)).max() < 5e-3
    assert abs(float(mom_sh.tc) - float(mom_1.tc)) / float(mom_1.tc) < 1e-3


@pytest.mark.parametrize("cfg_name,n,p,m", [
    ("cfg1", 1000, 128, 8),
    ("cfg3_scaled", 120, 480, 4),
])
def test_fixed_point_on_configs(cfg_name, n, p, m):
    """The fixed-point optimizer reaches the heavy-ball optimum on the
    acceptance-config shapes (the 'done' criterion for the
    reference-style update)."""
    x = block_data(n=n, p=p, m=m, seed=2)
    w0 = np.random.RandomState(1).normal(scale=1 / np.sqrt(p), size=(m, p))
    fp = lc.Corex(n_hidden=m, dtype="float64",
                  optimizer="fixed_point").fit(x, init_ws=w0)
    hb = lc.Corex(n_hidden=m, dtype="float64").fit(x, init_ws=w0)
    # same optimum to ~1e-4, or a better one (in the undersampled regime
    # the two updates can land in different local optima; measured: fp
    # found TC 403.0 vs heavy-ball's 400.8 on cfg3_scaled)
    assert fp.tc > hb.tc * (1 - 1e-4)
    assert abs(fp.tc - hb.tc) / abs(hb.tc) < 0.01
    # both fits must recover the planted blocks (cluster LABELS may differ
    # between optima; the partition may not)
    k = p // m
    for fit in (fp, hb):
        cl = np.asarray(fit.clusters)
        assert all(len(set(cl[j * k:(j + 1) * k])) == 1 for j in range(m))

"""Regression tests for the round-1 code-review findings."""

import numpy as np
import jax.numpy as jnp
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.config import CorexConfig
from linearcorex_tpu.parallel.restarts import init_restarts
from tests.conftest import block_data


def test_unknown_moment_strategy_rejected():
    # deferred to first use (sklearn contract: __init__ must not validate)
    with pytest.raises(ValueError, match="unknown moment_strategy"):
        lc.Corex(n_hidden=2, moment_strategy="gram_pallas").config


def test_checkpointed_fit_history_works(tmp_path, small_block_data):
    """fit_with_checkpoints aggregates per-stage diagnostics so `history`
    is usable (regression: only the last stage survived → IndexError)."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints
    m = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(m, small_block_data, str(tmp_path / "ck"))
    h = m.history
    assert len(h["iters_per_stage"]) == 7
    assert len(h["TC"]) == int(np.sum(h["iters_per_stage"]))
    assert abs(h["TC"][-1] - m.tc) / max(m.tc, 1.0) < 0.05


def test_load_corex_roundtrips_solver_config(tmp_path, small_block_data):
    """Saved optimizer/precision settings survive load (regression: they
    were silently reset to defaults)."""
    from linearcorex_tpu.utils.checkpoint import load_corex, save_corex
    c = lc.Corex(n_hidden=4, seed=0, optimizer="gd",
                 matmul_dtype="bfloat16",
                 matmul_precision="highest").fit(small_block_data)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    c2 = load_corex(path)
    assert c2.config.optimizer == "gd"
    assert c2.config.matmul_dtype == "bfloat16"
    assert c2.config.matmul_precision == "highest"


def test_covariance_matvec_unfitted_clear_error():
    with pytest.raises(lc.NotFittedError, match="not fitted"):
        lc.Corex(n_hidden=2).covariance_matvec(np.zeros(4))


def test_pick_n_hidden_gram_strategy():
    """pick_n_hidden with an explicit gram strategy computes the shared
    Gram (regression: passed the sample matrix as a Gram)."""
    x = block_data(n=400, p=128, m=2, seed=9)
    best_n, scores = lc.pick_n_hidden(
        x, repeat=1, max_n_hidden=1, dtype="float32", seed=0,
        max_iter=20, moment_strategy="gram")
    assert np.isfinite(scores).all()


def test_init_restarts_unseeded_not_deterministic():
    """seed=None must draw fresh randomness (advisor r1): two unseeded
    sweeps differ, mirroring Corex(seed=None)."""
    a = np.asarray(init_restarts(2, 3, 16, None, jnp.float32))
    b = np.asarray(init_restarts(2, 3, 16, None, jnp.float32))
    assert not np.array_equal(a, b)
    # seeded sweeps stay reproducible
    c = np.asarray(init_restarts(2, 3, 16, 7, jnp.float32))
    d = np.asarray(init_restarts(2, 3, 16, 7, jnp.float32))
    assert np.array_equal(c, d)


def test_set_params_dtype_change_then_refit():
    """set_params(dtype=...) after a fit must not crash the next fit
    (round-2 review: a stale-dtype weights path; since the round-3
    sklearn contract the refit is FRESH — fitted state never seeds it)."""
    x = block_data(n=300, p=16, m=2, seed=0)
    c = lc.Corex(n_hidden=2, seed=0).fit(x)
    c.set_params(dtype="float64")
    c.fit(x)
    assert c.ws.dtype == jnp.float64
    assert np.isfinite(c.tc)


def test_padded_best_n_rule_matches_sequential_early_stop():
    """_best_n_from_scores applies the sequential loop's early stop, so a
    TC rebound after two flat candidates is ignored by BOTH paths."""
    from linearcorex_tpu.models.selection import _best_n_from_scores
    assert _best_n_from_scores([10.0, 10.5, 10.4, 10.45, 12.0], 1e-3) == 2
    assert _best_n_from_scores([1.0, 2.0, 3.0, 3.0005, 3.0006], 1e-3) == 3


def test_complex_device_array_rejected():
    """Round-3 review: a complex jax.Array bypassed the complex-input
    rejection (the check was nested under isinstance np.ndarray) and cast
    complex->real silently."""
    x = block_data(n=60, p=8, m=2, seed=0)
    c = lc.Corex(n_hidden=2, seed=0, max_iter=30).fit(x)
    xc = jnp.asarray(x, jnp.complex64)
    with pytest.raises(ValueError, match="[Cc]omplex"):
        c.transform(xc)
    with pytest.raises(ValueError, match="[Cc]omplex"):
        lc.Corex(n_hidden=2, seed=0).fit(xc)


def test_predict_width_uses_fitted_factor_count():
    """Round-3 review: predict validated against the MUTABLE n_hidden
    parameter, so set_params(n_hidden=...) after fit rejected the correct
    factors and let wrong-width input through to an XLA shape error."""
    x = block_data(n=60, p=8, m=2, seed=0)
    c = lc.Corex(n_hidden=2, seed=0, max_iter=30).fit(x)
    z = np.asarray(c.transform(x))
    c.set_params(n_hidden=5)  # sklearn: params mutable, fitted state kept
    assert c.predict(z).shape == (60, 8)  # correct factors still accepted
    with pytest.raises(ValueError, match="fitted"):
        c.predict(np.zeros((3, 5)))  # new-param width must NOT validate


def test_fit_positional_init_ws_raises_loudly():
    """Round-3 review: the sklearn `y` slot is fit's second positional
    parameter, so the pre-0.3 form fit(X, W0) would silently DROP the
    warm start into the ignored y. It must raise instead."""
    x = block_data(n=60, p=8, m=2, seed=0)
    w0 = np.zeros((2, 8))
    with pytest.raises(TypeError, match="init_ws"):
        lc.Corex(n_hidden=2, seed=0).fit(x, w0)
    # a legitimate sklearn y (one row per sample) still passes
    assert lc.Corex(n_hidden=2, seed=0, max_iter=30).fit(
        x, np.arange(60)).ws is not None


def test_config_warning_fires_once_per_configuration():
    """Round-3 review: the derived-config property re-validated on every
    access, so config warnings fired once per ACCESS (9x per fit) instead
    of once per distinct configuration."""
    import warnings as W
    c = lc.Corex(n_hidden=2, init="spectral", anneal=True)
    with W.catch_warnings(record=True) as rec:
        W.simplefilter("always")
        for _ in range(5):
            c.config
    assert len([w for w in rec if "anneal" in str(w.message)]) == 1
    # changing a parameter re-validates (new configuration, new warning)
    c.set_params(max_iter=77)
    with W.catch_warnings(record=True) as rec2:
        W.simplefilter("always")
        c.config
    assert len([w for w in rec2 if "anneal" in str(w.message)]) == 1


def test_repr_never_raises():
    """repr reads raw parameters, not the validating config properties:
    sklearn renders estimator reprs inside its own error messages, so a
    deferred-invalid parameter must not make repr itself raise."""
    r = repr(lc.Corex(gaussianize="nope", optimizer="bogus"))
    assert "nope" in r and "bogus" in r
    x = block_data(n=60, p=8, m=2, seed=0)
    rf = repr(lc.Corex(n_hidden=2, seed=0, max_iter=20).fit(x))
    assert "fitted" in rf and "tc=" in rf


def test_array_valued_param_surfaces_config_validation():
    """Round-3 advisor: an array-valued hyperparameter (set_params(
    tol=np.array([1e-5]))) must surface through CorexConfig validation,
    not an ambiguous-truth ValueError from the config memo's tuple
    comparison."""
    c = lc.Corex(n_hidden=4)
    _ = c.config  # populate the memo so the comparison path runs
    c.set_params(tol=np.array([1e-5, 1e-4]))
    with pytest.raises((ValueError, TypeError)) as ei:
        _ = c.config
    assert "ambiguous" not in str(ei.value)


def test_explicit_gram_with_sample_only_plan_warns():
    """Round-3 advisor: moment_strategy='gram' + a mesh plan that shards
    only sample axes yields a fully replicated Gram operand; the strategy
    pick must say so instead of silently running unsharded."""
    from linearcorex_tpu.models.corex import pick_fit_strategy
    from linearcorex_tpu.parallel.sharding import ShardingPlan

    cfg = CorexConfig(n_hidden=4, moment_strategy="gram")
    with pytest.warns(UserWarning, match="REPLICATED"):
        got = pick_fit_strategy(cfg, 4096, 64, ShardingPlan())
    assert got == "gram"  # the explicit request is honored
    # 'auto' silently reroutes to samples instead (no warning)
    import warnings as W
    cfg_auto = CorexConfig(n_hidden=4, moment_strategy="auto")
    with W.catch_warnings():
        W.simplefilter("error")
        assert pick_fit_strategy(cfg_auto, 4096, 64,
                                 ShardingPlan()) == "samples"
    # a vars-sharding plan is the documented gram layout: no warning
    with W.catch_warnings():
        W.simplefilter("error")
        assert pick_fit_strategy(
            cfg, 4096, 64, ShardingPlan(shard_vars=True)) == "gram"

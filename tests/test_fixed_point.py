"""optimizer='fixed_point' — the reference-style damped closed-form update
(`[U] linearcorex/linearcorex.py :: _update_ws`, SURVEY.md §2.5/§7.0).

The target Ŵ = diag(sqz)·(diag(coef) − H)⁻¹·AA is derived from stationarity
of the exact objective; the damped iterate (1−γ)W + γŴ shares the solver's
accept/reject rule, so oracle and JAX are step-matched like the gradient
modes."""

import numpy as np
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.oracle import OracleCorex
from tests.conftest import block_data


def _shared_init(m, p, seed=42):
    return np.random.RandomState(seed).normal(scale=1.0 / np.sqrt(p),
                                              size=(m, p))


@pytest.mark.parametrize("strategy", ["samples", "gram"])
def test_f64_parity_fixed_point(strategy, med_block_data):
    """JAX fixed-point ≡ oracle fixed-point, step-for-step in float64."""
    x = med_block_data
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64", optimizer="fixed_point",
                 moment_strategy=strategy).fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8, optimizer="fixed_point").fit(x, init_ws=w0)
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() == \
        o.history["iters_per_stage"], "solver must be step-matched"
    assert abs(c.tc - o.tc) < 1e-5
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-5
    assert np.array_equal(np.asarray(c.clusters), o.clusters)


def test_fixed_point_reaches_momentum_optimum(med_block_data):
    """Matched n_hidden: the damped fixed point converges to the same TC as
    heavy-ball (both stop at tol=1e-5 delta; endpoints agree to ~1e-4 rel,
    measured 1e-6 level here)."""
    x = med_block_data
    w0 = _shared_init(8, 64)
    fp = lc.Corex(n_hidden=8, dtype="float64",
                  optimizer="fixed_point").fit(x, init_ws=w0)
    hb = lc.Corex(n_hidden=8, dtype="float64",
                  optimizer="momentum").fit(x, init_ws=w0)
    assert abs(fp.tc - hb.tc) / hb.tc < 1e-4
    assert np.array_equal(np.asarray(fp.clusters), np.asarray(hb.clusters))


def test_fixed_point_under_sampled():
    """n << p (BASELINE config 3 shape, scaled): the clipping regime where
    a momentum-accelerated fixed point fails — the plain damped form must
    still reach the heavy-ball optimum."""
    x = block_data(n=60, p=240, m=4, seed=11)
    w0 = _shared_init(4, 240, seed=5)
    fp = lc.Corex(n_hidden=4, dtype="float64",
                  optimizer="fixed_point").fit(x, init_ws=w0)
    hb = lc.Corex(n_hidden=4, dtype="float64").fit(x, init_ws=w0)
    assert abs(fp.tc - hb.tc) / abs(hb.tc) < 1e-4
    assert np.array_equal(np.asarray(fp.clusters), np.asarray(hb.clusters))


def test_fixed_point_rejects_overlap():
    # config validation fires at first use, not construction (sklearn
    # deferred-validation contract)
    with pytest.raises(ValueError, match="fixed_point"):
        lc.Corex(n_hidden=4, optimizer="fixed_point",
                 discourage_overlap=False).config
    with pytest.raises(ValueError, match="fixed_point"):
        OracleCorex(n_hidden=4, optimizer="fixed_point",
                    discourage_overlap=False)._obj_grad(
            np.zeros((4, 8)), np.zeros((10, 8)), 0.0)


def test_unknown_optimizer_rejected():
    with pytest.raises(ValueError, match="unknown optimizer"):
        lc.Corex(n_hidden=4, optimizer="adam").config


def test_optimizer_auto_resolution():
    """'auto' = fixed_point when n >= p on the non-overlap path (full-rank
    Σ̂ — measured faster AND better TC there), momentum otherwise
    (undersampled clipping regime / unknown n / overlap path)."""
    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.models.corex import resolve_config

    cfg = CorexConfig(n_hidden=8, optimizer="auto")
    assert resolve_config(cfg, 64, n_samples=64).optimizer == "fixed_point"
    assert resolve_config(cfg, 64, n_samples=63).optimizer == "momentum"
    assert resolve_config(cfg, 64).optimizer == "momentum"
    overlap = CorexConfig(n_hidden=8, optimizer="auto",
                          discourage_overlap=False)
    assert resolve_config(overlap, 64, n_samples=1000).optimizer == "momentum"


def test_optimizer_auto_unresolved_rejected():
    """Building an objective from an unresolved 'auto' config must fail
    loudly — the solver would otherwise silently run plain GD."""
    import jax.numpy as jnp

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.models.corex import _make_obj_grad

    with pytest.raises(ValueError, match="auto"):
        _make_obj_grad(jnp.zeros((8, 4)), CorexConfig(optimizer="auto"),
                       "samples")


def test_optimizer_auto_estimator_matches_explicit(med_block_data):
    """Corex(optimizer='auto') on fully-sampled data reproduces the
    explicit fixed_point fit bit-for-bit (same resolved program)."""
    x = med_block_data          # n=1000 >= p=64
    w0 = _shared_init(8, 64)
    auto = lc.Corex(n_hidden=8, dtype="float64",
                    optimizer="auto").fit(x, init_ws=w0)
    fp = lc.Corex(n_hidden=8, dtype="float64",
                  optimizer="fixed_point").fit(x, init_ws=w0)
    assert auto.tc == fp.tc
    assert np.array_equal(np.asarray(auto.ws), np.asarray(fp.ws))


def test_optimizer_auto_oracle_parity(med_block_data):
    """The oracle resolves 'auto' with the same regime policy, so
    seed-matched auto-vs-auto runs stay step-matched in float64."""
    x = med_block_data          # n=1000 >= p=64 -> both resolve fixed_point
    w0 = _shared_init(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64", optimizer="auto").fit(
        x, init_ws=w0)
    o = OracleCorex(n_hidden=8, optimizer="auto").fit(x, init_ws=w0)
    assert o.optimizer == "auto"            # constructor value untouched
    assert o.resolved_optimizer_ == "fixed_point"
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() == \
        o.history["iters_per_stage"]
    assert abs(c.tc - o.tc) < 1e-5
    # refit in the undersampled regime re-resolves instead of reusing the
    # stale fixed_point resolution
    o.fit(x[:32])
    assert o.resolved_optimizer_ == "momentum"


def test_optimizer_auto_mesh_gram_resolves_fixed_point(med_block_data):
    """Corex.fit(mesh=...) with the gram strategy must resolve 'auto'
    identically to the unsharded fit: the estimator resolves the optimizer
    BEFORE handing the (sample-count-less) Gram operand to fit_sharded."""
    import jax
    from jax.sharding import Mesh

    x = med_block_data          # n=1000 >= p=64, p <= gram_max_p -> gram
    w0 = _shared_init(8, 64)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("data",))
    meshed = lc.Corex(n_hidden=8, dtype="float64", optimizer="auto")
    meshed.fit(x, init_ws=w0, mesh=mesh)
    plain = lc.Corex(n_hidden=8, dtype="float64",
                     optimizer="fixed_point").fit(x, init_ws=w0)
    assert meshed.config.pick_strategy(1000, 64) == "gram"
    assert abs(meshed.tc - plain.tc) < 1e-9
    assert np.asarray(meshed.diagnostics.iters_per_stage).tolist() == \
        np.asarray(plain.diagnostics.iters_per_stage).tolist()


def test_resolved_optimizer_recorded(med_block_data):
    """Corex records which optimizer 'auto' resolved to (sklearn-style
    fitted attribute, mirroring OracleCorex)."""
    x = med_block_data
    c = lc.Corex(n_hidden=8, optimizer="auto").fit(x)
    assert c.resolved_optimizer_ == "fixed_point"
    assert c.config.optimizer == "auto"     # refits re-resolve
    c.fit(x[:32])
    assert c.resolved_optimizer_ == "momentum"
    e = lc.Corex(n_hidden=8, optimizer="momentum").fit(x)
    assert e.resolved_optimizer_ == "momentum"


def test_oracle_prefit_auto_drive_rejected():
    """Driving the oracle's internals with an unresolved 'auto' raises
    (the JAX side has the same guard in _make_obj_grad)."""
    o = OracleCorex(n_hidden=4, optimizer="auto")
    with pytest.raises(ValueError, match="auto"):
        o._obj_grad(np.zeros((4, 8)), np.zeros((10, 8)), 0.0)

"""stage_subsample: non-final anneal stages on a row subsample.

The knob's contract mirrors stage_tol_factor (the final eps=0 stage always
runs on the FULL data at `tol`): the driver is two compiled programs —
the schedule prefix on every k-th row, the final stage on everything
(models/corex.py :: _fit_staged_subsample). Measured basis:
benchmarks/RESULTS.md "stage-subsample study" (weak structure: 1.6-2.7x
fewer weighted iterations at TC within ±0.1% on every seed; strong
structure shows basin drift to −4% — it is a weak-structure knob;
composes with stage_tol_factor). Parity anchor: the float64 oracle mirrors the staging
step-for-step, including the prefix program's tcs factor sort
(oracle/oracle.py :: OracleCorex.fit).
"""

import warnings

import numpy as np
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.oracle import OracleCorex
from tests.conftest import block_data


def _w0(m, p, seed=42):
    return np.random.RandomState(seed).normal(scale=1.0 / np.sqrt(p),
                                              size=(m, p))


def test_f64_parity_momentum_step_matched():
    """The staged fit is step-matched with the oracle mirror on the
    default (momentum) optimizer — same per-stage iteration counts, same
    optimum — and genuinely changes the trajectory vs the full-data fit
    (the pin is not vacuous). Seed 1 (not the med_block_data fixture):
    on the seed-0 operand the PLAIN one-program fit on x[::4] already
    flips one accept/reject at stage 2 from XLA-vs-NumPy low-bit noise
    (verified independent of the staging driver) — the same seed
    lottery every step-matched parity test in this suite plays."""
    x = block_data(n=1000, p=64, m=8, seed=1)
    w0 = _w0(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64", stage_subsample=0.25,
                 moment_strategy="samples").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8, stage_subsample=0.25).fit(x, init_ws=w0)
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() == \
        o.history["iters_per_stage"], "solver must be step-matched"
    assert abs(c.tc - o.tc) < 1e-5
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-5
    base = lc.Corex(n_hidden=8, dtype="float64",
                    moment_strategy="samples").fit(x, init_ws=w0)
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() != \
        np.asarray(base.diagnostics.iters_per_stage).tolist()


def test_f64_parity_fixed_point_optimum(med_block_data):
    """fixed_point under the staged driver: converged-optimum agreement
    with the oracle mirror. Iteration counts are NOT asserted — measured
    (round 4): on some subsampled operands a low-bit XLA-vs-NumPy
    difference flips one accept/reject at a tol boundary mid-prefix
    (107 vs 108 iterations, final dW ~1e-11) — the known fp-chaos mode,
    not a semantic divergence; momentum (the default) is exactly
    step-matched above."""
    x = med_block_data
    w0 = _w0(8, 64)
    c = lc.Corex(n_hidden=8, dtype="float64", stage_subsample=0.25,
                 optimizer="fixed_point",
                 moment_strategy="samples").fit(x, init_ws=w0)
    o = OracleCorex(n_hidden=8, stage_subsample=0.25,
                    optimizer="fixed_point").fit(x, init_ws=w0)
    assert abs(c.tc - o.tc) < 1e-6 * max(1.0, abs(o.tc))
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-6


def test_stride_one_fraction_matches_plain_fit(small_block_data):
    """A fraction that rounds to stride 1 (> 2/3: no rows would actually
    drop) is INERT: stage_subsample_active warns and the fit runs the
    plain one-program path — no split, no extra sync/compile for zero
    subsampling. Must land bitwise on the plain fit's
    optimum."""
    x = small_block_data
    w0 = _w0(4, 32, seed=5)
    ref = lc.Corex(n_hidden=4, dtype="float64",
                   moment_strategy="samples").fit(x, init_ws=w0)
    with pytest.warns(UserWarning, match="stride 1"):
        c = lc.Corex(n_hidden=4, dtype="float64", stage_subsample=0.9,
                     moment_strategy="samples").fit(x, init_ws=w0)
    assert abs(c.tc - ref.tc) < 1e-9
    assert np.abs(np.asarray(c.ws) - np.asarray(ref.ws)).max() < 1e-9
    # the f64 oracle mirrors the inertness (same staging rule both sides)
    o = OracleCorex(n_hidden=4, stage_subsample=0.9).fit(x, init_ws=w0)
    assert abs(c.tc - o.tc) < 1e-6 * max(1.0, abs(o.tc))


def test_diagnostics_cover_full_schedule(small_block_data):
    """The two programs' per-stage diagnostics concatenate into the FULL
    schedule view: history/verbose labels must match a plain fit's."""
    x = small_block_data
    c = lc.Corex(n_hidden=4, stage_subsample=0.25, seed=0,
                 moment_strategy="samples").fit(x)
    full = lc.Corex(n_hidden=4, seed=0).config.anneal_schedule()
    assert np.asarray(c.diagnostics.eps_schedule).tolist() == \
        pytest.approx(list(full))
    assert len(np.asarray(c.diagnostics.iters_per_stage)) == len(full)
    h = c.history
    assert len(h["iters_per_stage"]) == len(full)
    # per-iteration entries cover BOTH programs' recorded trajectories
    assert len(h["TC"]) == int(np.asarray(
        c.diagnostics.iters_per_stage).sum())


def test_quality_holds_on_block_structure(med_block_data):
    """End-to-end sanity at f32 defaults: the subsampled fit recovers the
    planted clustering and lands within 1% of the full fit's TC (the
    measured envelope on weak structure is 0.1%; this is the loose CI
    bound)."""
    x = med_block_data
    w0 = _w0(8, 64)
    ref = lc.Corex(n_hidden=8, moment_strategy="samples").fit(
        x, init_ws=w0)
    c = lc.Corex(n_hidden=8, stage_subsample=0.25,
                 moment_strategy="samples").fit(x, init_ws=w0)
    assert c.tc > 0.99 * ref.tc
    assert np.array_equal(np.sort(np.asarray(c.clusters)),
                          np.sort(np.asarray(ref.clusters)))


def test_int8_staged_subsample_runs(small_block_data):
    """The QuantizedData operand subsamples by slicing q and keeping the
    per-tensor scale (rows are a subset of the same standardized X)."""
    x = small_block_data
    c = lc.Corex(n_hidden=4, matmul_dtype="int8", tol=1e-4, seed=0,
                 stage_subsample=0.25, moment_strategy="samples").fit(x)
    assert np.isfinite(float(c.tc)) and float(c.tc) > 0


def test_gram_strategy_warns_and_ignores(small_block_data):
    """A Gram operand carries no sample axis: the knob warns and the fit
    proceeds on the full schedule unchanged."""
    x = small_block_data
    w0 = _w0(4, 32)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        c = lc.Corex(n_hidden=4, dtype="float64", stage_subsample=0.25,
                     moment_strategy="gram").fit(x, init_ws=w0)
    assert any("inert on the gram" in str(w.message) for w in rec)
    ref = lc.Corex(n_hidden=4, dtype="float64",
                   moment_strategy="gram").fit(x, init_ws=w0)
    assert np.array_equal(np.asarray(c.ws), np.asarray(ref.ws))


def test_mesh_fit_raises():
    from linearcorex_tpu.parallel.sharding import make_mesh
    x = block_data(n=480, p=32, m=4, seed=0)
    m = lc.Corex(n_hidden=4, stage_subsample=0.5)
    with pytest.raises(ValueError, match="stage_subsample"):
        m.fit(x, mesh=make_mesh())
    with pytest.raises(ValueError, match="stage_subsample"):
        m.warmup(480, 32, mesh=make_mesh())


def test_one_program_drivers_raise():
    """Restart/sharded/selection drivers run the whole schedule as one
    program on one operand — the single guard in _make_obj_grad must
    fail them loudly instead of silently fitting full data per stage."""
    import jax.numpy as jnp

    from linearcorex_tpu.parallel.restarts import fit_restarts
    from linearcorex_tpu.parallel.sharding import fit_shard_map, make_mesh
    x = jnp.asarray(block_data(n=480, p=32, m=4, seed=0))
    cfg = lc.Corex(n_hidden=4, stage_subsample=0.5).config
    w0b = jnp.asarray(
        np.stack([_w0(4, 32, s) for s in range(2)]))
    with pytest.raises(ValueError, match="one-program"):
        fit_restarts(x, w0b, cfg, "samples")
    with pytest.raises(ValueError, match="stage_subsample"):
        fit_shard_map(x, jnp.asarray(_w0(4, 32)), cfg, make_mesh())


def test_validation():
    for bad in (0.0, -0.25, 1.5):
        with pytest.raises(ValueError, match="stage_subsample"):
            lc.Corex(n_hidden=2, stage_subsample=bad).config
    with pytest.raises(TypeError, match="stage_subsample"):
        lc.Corex(n_hidden=2, stage_subsample=np.array([0.5])).config
    # inert combinations do NOT trip the staged driver: anneal=False has
    # no non-final stage to subsample
    x = block_data(n=240, p=16, m=2, seed=0)
    c = lc.Corex(n_hidden=2, anneal=False, stage_subsample=0.25,
                 moment_strategy="samples").fit(x)
    assert len(np.asarray(c.diagnostics.iters_per_stage)) == 1


def test_save_load_roundtrip(tmp_path, small_block_data):
    from linearcorex_tpu.utils.checkpoint import load_corex, save_corex
    c = lc.Corex(n_hidden=4, seed=0, stage_subsample=0.25,
                 moment_strategy="samples").fit(small_block_data)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    c2 = load_corex(path)
    assert c2.stage_subsample == 0.25
    assert c2.get_params()["stage_subsample"] == 0.25


def test_checkpoint_driver_matches_staged_fit(tmp_path, small_block_data):
    """fit_with_checkpoints runs the same subsampled stage inputs as the
    two-program driver (deterministic stride slice), so a checkpointed
    subsampled fit lands on Corex.fit's optimum."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints
    x = small_block_data
    w0 = _w0(4, 32, seed=5)
    ref = lc.Corex(n_hidden=4, dtype="float64", stage_subsample=0.25,
                   moment_strategy="samples").fit(x, init_ws=w0)
    m2 = lc.Corex(n_hidden=4, dtype="float64", stage_subsample=0.25,
                  moment_strategy="samples")
    fit_with_checkpoints(m2, x, str(tmp_path / "ck"), init_ws=w0)
    # 1e-7, not 1e-9: the checkpoint driver factor-sorts after EVERY
    # stage (each stage is its own program) while the two-program driver
    # sorts once after the prefix — measured drift ~1e-9 on this data
    assert abs(m2.tc - ref.tc) < 1e-7
    assert np.abs(np.asarray(m2.ws) - np.asarray(ref.ws)).max() < 1e-7


def test_warmup_is_module_identical_to_staged_fit(monkeypatch):
    """warmup_fit must lower EXACTLY the two modules the staged fit
    dispatches (prefix on the stride-sliced rows, final on the full
    shape) — module-text identity is the persistent-cache-key proxy
    (same rule as every other warmup pin in test_compile_cache.py)."""
    import linearcorex_tpu.models.corex as C
    from tests.conftest import module_text_probe

    texts = []
    monkeypatch.setattr(C, "_fit_program",
                        module_text_probe(C._fit_program, texts))
    # utils.compile_cache imports _fit_program by name at call time
    x = block_data(n=480, p=32, m=4, seed=0)
    model = lc.Corex(n_hidden=4, seed=0, stage_subsample=0.25,
                     max_iter=50, record_history=False,
                     moment_strategy="samples")
    model.warmup(480, 32)
    model.fit(x)
    assert len(texts) == 4, "expected 2 warmup lowers + 2 fit dispatches"
    assert texts[0] == texts[2], "prefix program module drifted"
    assert texts[1] == texts[3], "final-stage program module drifted"

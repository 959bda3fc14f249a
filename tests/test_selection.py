"""Tests for vmapped multi-restart fitting and pick_n_hidden."""

import numpy as np
import jax.numpy as jnp
import pytest

import linearcorex_tpu as lc

from linearcorex_tpu.config import CorexConfig
from linearcorex_tpu.models.selection import pick_n_hidden
from linearcorex_tpu.ops import moments as M
from linearcorex_tpu.ops import preprocessing as P
from linearcorex_tpu.parallel.restarts import (best_restart, fit_restarts,
                                               init_restarts)
from tests.conftest import block_data, module_text_probe


def test_fit_restarts_matches_single():
    """Restart r of a vmapped sweep must equal the plain seeded fit."""
    import linearcorex_tpu as lc
    x = block_data(n=500, p=32, m=4, seed=3)
    cfg = CorexConfig(n_hidden=4, dtype="float64", record_history=False)
    xp, _ = P.fit_preprocess(jnp.asarray(x, jnp.float64), "standard")
    strategy = cfg.pick_strategy(*x.shape)
    data = M.compute_gram(xp) if strategy == "gram" else xp
    w0 = init_restarts(3, 4, 32, seed=17, dtype=jnp.float64)
    ws_b, mom_b, diag_b = fit_restarts(data, w0, cfg, strategy)
    assert ws_b.shape == (3, 4, 32)
    single = lc.Corex(n_hidden=4, seed=18, dtype="float64",
                      record_history=False).fit(x)
    # restart index 1 used RandomState(17+1)
    assert np.abs(np.asarray(ws_b[1]) - np.asarray(single.ws)).max() < 1e-9
    assert abs(float(mom_b.tc[1]) - single.tc) < 1e-9


def test_best_restart_selection():
    x = block_data(n=500, p=32, m=4, seed=3)
    cfg = CorexConfig(n_hidden=4, dtype="float64", record_history=False)
    xp, _ = P.fit_preprocess(jnp.asarray(x, jnp.float64), "standard")
    strategy = cfg.pick_strategy(*x.shape)
    data = M.compute_gram(xp) if strategy == "gram" else xp
    w0 = init_restarts(4, 4, 32, seed=0, dtype=jnp.float64)
    ws_b, mom_b, diag_b = fit_restarts(data, w0, cfg, strategy)
    ws, mom, diag, idx = best_restart(ws_b, mom_b, diag_b)
    assert float(mom.tc) == float(np.max(np.asarray(mom_b.tc)))
    assert ws.shape == (4, 32)


def test_pick_n_hidden_finds_true_m():
    x = block_data(n=800, p=24, m=3, seed=9)
    best_n, scores = pick_n_hidden(x, repeat=2, max_n_hidden=6,
                                   dtype="float64", seed=0, max_iter=4000)
    assert best_n == 3
    # TC gain saturates after the true m
    assert scores[2] - scores[1] > 0.5
    if len(scores) > 3:
        assert scores[3] - scores[2] < 0.05


def test_pick_n_hidden_padded_matches_sequential():
    """The one-compile padded sweep reproduces the per-candidate loop:
    zero surplus rows are a solver invariant, so each candidate's active
    block follows the dedicated fit's trajectory exactly (f64)."""
    x = block_data(n=800, p=24, m=3, seed=9)
    kw = dict(repeat=2, max_n_hidden=5, dtype="float64", seed=0,
              max_iter=4000)
    bp, sp = pick_n_hidden(x, padded_sweep=True, **kw)
    bs, ss = pick_n_hidden(x, padded_sweep=False, **kw)
    assert bp == bs == 3
    k = min(len(ss), len(sp))
    # candidates >= 2 share the anneal schedule: step-exact equality
    assert np.abs(sp[1:k] - ss[1:k]).max() < 1e-8
    # the padded nh=1 candidate rides the anneal schedule (a dedicated
    # n_hidden=1 fit skips it); same optimum, tol-level stopping wiggle
    assert abs(sp[0] - ss[0]) / abs(ss[0]) < 1e-5


def test_pick_n_hidden_padded_is_one_program(monkeypatch):
    """The padded sweep must launch exactly one batched solve for the
    whole (candidate, restart) grid."""
    import linearcorex_tpu.models.selection as S
    import linearcorex_tpu.parallel.restarts as R

    calls = {"n": 0}
    real = R.fit_restarts

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    # the single-device sweep dispatches through restart_batch_runner
    # (parallel.restarts — shared with Corex(n_restarts=k).fit), which
    # closes over its module's fit_restarts
    monkeypatch.setattr(R, "fit_restarts", counting)
    x = block_data(n=400, p=16, m=2, seed=4)
    best_n, scores = S.pick_n_hidden(x, repeat=2, max_n_hidden=4,
                                     dtype="float32", seed=0, max_iter=500)
    assert calls["n"] == 1
    assert len(scores) == 4 and np.isfinite(scores).all()


def test_pick_n_hidden_rejects_bad_bounds():
    import pytest

    x = np.random.RandomState(0).normal(size=(50, 8))
    with pytest.raises(ValueError, match="repeat"):
        pick_n_hidden(x, repeat=0)
    with pytest.raises(ValueError, match="max_n_hidden"):
        pick_n_hidden(x, repeat=1, max_n_hidden=0)


def test_pick_n_hidden_heldout_recovers_planted_m():
    """criterion='heldout': the held-out Gaussian log-likelihood peaks at
    the planted factor count instead of monotonically creeping like
    training TC."""
    x = block_data(n=1200, p=32, m=4, seed=7)
    best, scores = pick_n_hidden(x, repeat=2, max_n_hidden=8, seed=0,
                                 criterion="heldout", tol=1e-4)
    assert len(scores) == 8
    assert 3 <= best <= 5, (best, scores)
    # both sweep modes agree on the criterion
    best_seq, scores_seq = pick_n_hidden(x, repeat=2, max_n_hidden=8,
                                         seed=0, criterion="heldout",
                                         tol=1e-4, padded_sweep=False)
    assert 3 <= best_seq <= 5


def test_pick_n_hidden_heldout_validation():
    import pytest

    x = np.random.RandomState(0).normal(size=(50, 8))
    with pytest.raises(ValueError, match="criterion"):
        pick_n_hidden(x, criterion="bogus")
    with pytest.raises(ValueError, match="val_fraction"):
        pick_n_hidden(x, criterion="heldout", val_fraction=1.5)
    with pytest.raises(ValueError, match="training rows"):
        pick_n_hidden(np.random.RandomState(0).normal(size=(3, 8)),
                      criterion="heldout", val_fraction=0.9)
    with pytest.raises(ValueError, match="gaussianize"):
        pick_n_hidden(x, criterion="heldout", gaussianize="empirical")


def test_smallest_within_tol_nan_handling():
    """Non-finite candidate scores are excluded (a diverged fit must not
    make argmax silently return n_hidden=1); all-NaN raises."""
    import pytest

    from linearcorex_tpu.models.selection import _smallest_within_tol

    assert _smallest_within_tol([-40.0, np.nan, -25.0, -25.0], 1e-3) == 3
    with pytest.raises(ValueError, match="non-finite"):
        _smallest_within_tol([np.nan, np.nan], 1e-3)


def test_pick_n_hidden_accepts_record_history_kwarg():
    """record_history is forced off for sweeps; a user passing it must not
    collide with the forced kwarg (regression: TypeError 'multiple
    values')."""
    x = np.random.RandomState(0).normal(size=(80, 8))
    best, _ = pick_n_hidden(x, repeat=1, max_n_hidden=3,
                            record_history=False, tol=1e-3)
    assert 1 <= best <= 3


# ---------------------------------------------------------------------------
# mesh-sharded selection
# ---------------------------------------------------------------------------

def _mesh_restarts():
    from linearcorex_tpu.parallel.sharding import make_mesh
    return make_mesh((("restarts", 8),))


@pytest.mark.parametrize("criterion", ["tc", "heldout"])
def test_pick_n_hidden_mesh_equivalence(criterion):
    """The restart-axis-sharded sweep picks the same best_n with scores
    equal to the single-device sweep to fp tolerance — including the
    non-divisible batch (3 candidates x 2 restarts = 6 lanes on 8
    devices → 2 padded lanes dropped)."""
    x = block_data(n=400, p=24, m=3, seed=7)
    kw = dict(repeat=2, max_n_hidden=3, max_iter=400, seed=0,
              criterion=criterion)
    best_ref, scores_ref = lc.pick_n_hidden(x, **kw)
    best_mesh, scores_mesh = lc.pick_n_hidden(x, mesh=_mesh_restarts(),
                                              **kw)
    assert best_mesh == best_ref
    np.testing.assert_allclose(scores_mesh, scores_ref, rtol=2e-3,
                               atol=1e-4)


def test_pick_n_hidden_mesh_sequential_path():
    """padded_sweep=False with a mesh shards each candidate's restart
    batch too (same saturation rule, same result)."""
    x = block_data(n=400, p=24, m=3, seed=8)
    kw = dict(repeat=3, max_n_hidden=4, max_iter=400, seed=1,
              padded_sweep=False)
    best_ref, scores_ref = lc.pick_n_hidden(x, **kw)
    best_mesh, scores_mesh = lc.pick_n_hidden(x, mesh=_mesh_restarts(),
                                              **kw)
    assert best_mesh == best_ref
    np.testing.assert_allclose(scores_mesh, scores_ref, rtol=2e-3,
                               atol=1e-4)


def test_pick_n_hidden_mesh_axis_validation():
    from linearcorex_tpu.parallel.sharding import make_mesh
    x = block_data(n=200, p=16, m=2, seed=0)
    with pytest.raises(ValueError, match="restarts"):
        lc.pick_n_hidden(x, mesh=make_mesh((("data", 8),)), repeat=1,
                         max_n_hidden=2, max_iter=50)


def test_padded_nh1_candidate_not_worse_than_dedicated_fit():
    """Pin the one padded-sweep semantic divergence:
    the nh=1 candidate rides the shared multi-factor anneal schedule,
    while a dedicated n_hidden=1 fit skips annealing. The claim in
    selection.py is 'unchanged or better' — assert it on structure where
    annealing matters (correlated blocks, several local optima), with
    seed-matched restarts (the padded candidate's active row is bit-equal
    to the dedicated fit's init)."""
    x = block_data(n=600, p=48, m=4, seed=9)
    seed, repeat = 11, 3
    _, scores = pick_n_hidden(x, repeat=repeat, max_n_hidden=4, seed=seed,
                              dtype="float64", padded_sweep=True,
                              max_iter=2000)
    padded_nh1_tc = float(scores[0])
    from linearcorex_tpu.parallel.restarts import seed_base
    base = seed_base(seed)
    dedicated = max(
        float(lc.Corex(n_hidden=1, seed=base + r, dtype="float64",
                       max_iter=2000).fit(x).tc)
        for r in range(repeat))
    assert padded_nh1_tc >= dedicated - 1e-6 * max(abs(dedicated), 1.0), (
        f"padded nh=1 candidate (annealed, {padded_nh1_tc}) fell below "
        f"the dedicated non-annealed fit ({dedicated}) — the "
        f"'unchanged or better' claim in selection.py no longer holds")


def test_pick_n_hidden_2d_restarts_x_data_mesh_equivalence():
    """pick_n_hidden on a 2-D restarts x data mesh (the combined layout)
    agrees with the single-device sweep."""
    from linearcorex_tpu.parallel.sharding import make_mesh
    x = block_data(n=480, p=32, m=4, seed=5)
    kw = dict(repeat=2, max_n_hidden=5, seed=0, max_iter=800,
              dtype="float64")
    best_u, scores_u = pick_n_hidden(x, **kw)
    mesh = make_mesh((("restarts", 2), ("data", 4)))
    best_s, scores_s = pick_n_hidden(x, mesh=mesh, data_axis="data", **kw)
    assert best_s == best_u
    np.testing.assert_allclose(scores_s, scores_u, rtol=1e-8)


def test_warmup_sweep_is_key_identical_to_the_real_sweep(monkeypatch):
    """warmup_sweep must lower EXACTLY the program pick_n_hidden
    dispatches — same lowered module (operand shapes/dtypes/shardings,
    resolved config, strategy, AND mesh context: fit_restarts_sharded
    compiles inside jax.set_mesh(mesh), so the warmup must too) — or AOT
    warmup compiles a cache entry the real sweep never hits. Intercepts
    the one shared program object (parallel.restarts.
    _fit_restarts_program) on a deliberately awkward case: heldout split
    (changes the row count), int8 (QuantizedData operand), 2-D
    restarts x data mesh, and a batch (3 cands x 3 restarts = 9) that
    needs padding to divide the restart axis."""
    import linearcorex_tpu.parallel.restarts as R
    from linearcorex_tpu.models.selection import warmup_sweep
    from linearcorex_tpu.parallel.sharding import make_mesh

    recorded = []
    monkeypatch.setattr(R, "_fit_restarts_program",
                        module_text_probe(R._fit_restarts_program,
                                           recorded))
    x = block_data(n=480, p=32, m=4, seed=7)
    mesh = make_mesh((("restarts", 2), ("data", 4)))
    kw = dict(repeat=3, max_n_hidden=3, max_iter=300, criterion="heldout",
              val_fraction=0.2, matmul_dtype="int8", tol=1e-4,
              mesh=mesh, data_axis="data")
    warmup_sweep(480, 32, **kw)
    pick_n_hidden(x, seed=0, **kw)
    assert len(recorded) == 2, len(recorded)
    assert recorded[0] == recorded[1], \
        "warmup_sweep lowered a different module than the real sweep"


def test_warmup_sweep_key_identity_single_device_gram(monkeypatch):
    """Same lockstep pin on the single-device gram path (no mesh)."""
    import linearcorex_tpu.parallel.restarts as R
    from linearcorex_tpu.models.selection import warmup_sweep

    recorded = []
    monkeypatch.setattr(R, "_fit_restarts_program",
                        module_text_probe(R._fit_restarts_program,
                                           recorded))
    x = block_data(n=200, p=24, m=3, seed=1)
    kw = dict(repeat=2, max_n_hidden=4, max_iter=300, dtype="float64")
    warmup_sweep(200, 24, **kw)
    pick_n_hidden(x, seed=0, **kw)
    assert len(recorded) == 2
    assert recorded[0] == recorded[1], \
        "warmup_sweep lowered a different module than the real sweep"


def test_data_axis_without_mesh_raises():
    """data_axis without a mesh must raise, not silently run the
    single-device sweep with a silently different strategy choice."""
    from linearcorex_tpu.models.selection import warmup_sweep

    x = block_data(n=200, p=24, m=3, seed=1)
    with pytest.raises(ValueError, match="mesh"):
        pick_n_hidden(x, repeat=2, max_n_hidden=3, data_axis="data")
    with pytest.raises(ValueError, match="mesh"):
        warmup_sweep(200, 24, repeat=2, max_n_hidden=3, data_axis="data")


def test_explicit_gram_with_data_axis_raises_in_sweep_and_warmup():
    """An explicit moment_strategy='gram' with a data axis must raise
    from BOTH pick_n_hidden and warmup_sweep (fit_restarts_sharded
    rejects the combination, so a warmup must not silently compile a
    row-sharded Gram program the real sweep can never dispatch)."""
    from linearcorex_tpu.models.selection import warmup_sweep
    from linearcorex_tpu.parallel.sharding import make_mesh

    x = block_data(n=480, p=24, m=3, seed=1)
    mesh = make_mesh((("restarts", 2), ("data", 4)))
    kw = dict(repeat=2, max_n_hidden=3, mesh=mesh, data_axis="data",
              moment_strategy="gram")
    with pytest.raises(ValueError, match="samples-strategy only"):
        pick_n_hidden(x, **kw)
    with pytest.raises(ValueError, match="samples-strategy only"):
        warmup_sweep(480, 24, **kw)


def test_warmup_sweep_rejects_non_dividing_data_axis():
    """warmup_sweep must reject declared row counts the real sweep's
    fit_restarts_sharded would reject (XLA shards without padding)."""
    from linearcorex_tpu.models.selection import warmup_sweep
    from linearcorex_tpu.parallel.sharding import make_mesh

    mesh = make_mesh((("restarts", 2), ("data", 4)))
    with pytest.raises(ValueError, match="divide"):
        warmup_sweep(481, 24, repeat=2, max_n_hidden=3, mesh=mesh,
                     data_axis="data")


def test_warmup_sweep_accepts_full_sweep_call_signature():
    """The docstring says 'pass EXACTLY the arguments the real
    pick_n_hidden call will use' — so the selection-rule knobs that
    don't touch shapes (seed/verbose/tc_gain_tol) must be accepted,
    padded_sweep=False must raise by name (nothing to warm), and the
    heldout validation must fire HERE with pick_n_hidden's named
    errors, not as an opaque negative-dimension lowering failure
    (round-4 review findings)."""
    from linearcorex_tpu.models.selection import warmup_sweep

    # a literal copy of a sweep call's arguments, selection knobs and all
    warmup_sweep(200, 16, repeat=2, max_n_hidden=2, seed=3, verbose=True,
                 tc_gain_tol=1e-2, max_iter=50)
    with pytest.raises(ValueError, match="padded_sweep"):
        warmup_sweep(200, 16, repeat=2, max_n_hidden=2,
                     padded_sweep=False)
    with pytest.raises(ValueError, match="val_fraction"):
        warmup_sweep(100, 10, criterion="heldout", val_fraction=1.5)
    with pytest.raises(ValueError, match="heldout"):
        warmup_sweep(100, 10, criterion="heldout",
                     gaussianize="empirical")


def test_pick_n_hidden_rejects_spectral_init():
    """The sweep supplies its own seeded init stacks, so init='spectral'
    would be silently ignored — it must raise by name (both the sweep
    and its warmup share the _sweep_cfg_and_strategy guard), pointing at
    Corex(n_restarts=k) where spectral lanes ARE supported."""
    import pytest

    from linearcorex_tpu.models.selection import warmup_sweep

    x = np.random.RandomState(0).normal(size=(60, 8))
    with pytest.raises(ValueError, match="spectral"):
        pick_n_hidden(x, repeat=2, max_n_hidden=3, init="spectral")
    with pytest.raises(ValueError, match="spectral"):
        warmup_sweep(60, 8, repeat=2, max_n_hidden=3, init="spectral")


def test_pick_n_hidden_rejects_n_restarts_kwarg():
    """repeat= is the sweep's restart count; n_restarts= (the
    fixed-n_hidden Corex knob) must raise the targeted message, not
    CorexConfig's generic unexpected-kwarg TypeError."""
    import pytest

    x = np.random.RandomState(0).normal(size=(60, 8))
    with pytest.raises(TypeError, match="repeat=k"):
        pick_n_hidden(x, repeat=1, max_n_hidden=2, n_restarts=2)

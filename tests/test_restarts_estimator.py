"""Estimator-level guarded restarts: `Corex(n_restarts=k)` (round 5:
the measured ~1-in-6 bad-basin rate at cfg5 had no
one-call mitigation on the estimator surface).

Contract: k seeded lanes run as ONE vmapped program
(`parallel.restarts._fit_restarts_program`), the best final TC wins
(the reference's pick_n_hidden(repeat=k) selection rule at fixed
n_hidden); lane r inits from RandomState(seed + r) so lane 0 ≡ a plain
`Corex(seed=seed)` fit; `best_restart_` records the winning lane.
Measured basis: benchmarks/RESULTS.md multi-restart note.
"""
import numpy as np
import pytest

import linearcorex_tpu as lc
from tests.conftest import block_data


def _data():
    # matched-m weak-ish structure: a seed/basin lottery regime, so the
    # lanes actually land in different optima and argmax-TC is meaningful
    return np.asarray(block_data(n=256, p=32, m=4, seed=3, strength=0.3))


KW = dict(n_hidden=4, dtype="float64", record_history=False,
          moment_strategy="samples", max_iter=500)


def test_sweep_equals_best_of_single_fits():
    """Corex(n_restarts=4, seed=s).fit(x) == the best of the four
    single fits Corex(seed=s+r) — the documented seed policy."""
    x = _data()
    sweep = lc.Corex(n_restarts=4, seed=7, **KW).fit(x)
    singles = [lc.Corex(seed=7 + r, **KW).fit(x) for r in range(4)]
    tcs = [c.tc for c in singles]
    best = int(np.argmax(tcs))
    assert sweep.best_restart_ == best
    assert sweep.tc == pytest.approx(tcs[best], rel=1e-9)
    assert np.abs(np.asarray(sweep.ws)
                  - np.asarray(singles[best].ws)).max() < 1e-8
    # the sweep found a real spread (the lottery regime) — if every lane
    # landed identically the best-of-k comparison above would be vacuous
    assert len(set(tcs)) > 1, (
        "all restart lanes converged to identical TC — pick a seed/data "
        "regime with a real basin lottery, or the test proves nothing")


def test_single_restart_is_plain_fit():
    """n_restarts=1 (the default) is EXACTLY the plain fit path."""
    x = _data()
    a = lc.Corex(seed=7, **KW).fit(x)
    b = lc.Corex(n_restarts=1, seed=7, **KW).fit(x)
    assert np.array_equal(np.asarray(a.ws), np.asarray(b.ws))
    assert b.best_restart_ == 0


def test_unseeded_sweep_differs_across_calls():
    x = _data()
    a = lc.Corex(n_restarts=2, seed=None, **KW).fit(x)
    b = lc.Corex(n_restarts=2, seed=None, **KW).fit(x)
    # fresh entropy per call (seed_base) — identical sweeps would mean a
    # silently repeated base seed
    assert not np.array_equal(np.asarray(a.ws), np.asarray(b.ws))


def test_validation_and_guards():
    x = _data()
    with pytest.raises(ValueError, match="n_restarts"):
        lc.Corex(n_restarts=0, **KW).fit(x)
    with pytest.raises(ValueError, match="n_restarts"):
        lc.Corex(n_restarts=2.5, **KW).fit(x)
    with pytest.raises(ValueError, match="warm start"):
        lc.Corex(n_restarts=2, **KW).fit(
            x, init_ws=np.zeros((4, 32)))
    with pytest.raises(ValueError, match="warm start"):
        lc.Corex(n_restarts=2,
                 pretrained_weights=np.zeros((4, 32)), **KW).fit(x)
    with pytest.raises(ValueError, match="stage_subsample"):
        lc.Corex(n_restarts=2, stage_subsample=0.25, **KW).fit(x)
    # warmup must reject EXACTLY where fit rejects (shared guard), not
    # funnel into the staging error or warm a dead key (round-5 review)
    with pytest.raises(ValueError, match="stage_subsample"):
        lc.Corex(n_restarts=2, stage_subsample=0.25, **KW).warmup(256, 32)


def test_unsupported_drivers_raise_by_name(tmp_path):
    """fit_with_checkpoints and partial_fit cannot run a restart sweep —
    they must raise by name, never silently fit one lane (round-5
    review: the silent path would hand back a single fit while the user
    believes they got the best-of-k basin mitigation)."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints
    x = _data()
    with pytest.raises(ValueError, match="fit_with_checkpoints"):
        fit_with_checkpoints(lc.Corex(n_restarts=2, **KW), x,
                             str(tmp_path / "ck"))
    kw = dict(KW, moment_strategy="auto")
    with pytest.raises(ValueError, match="partial_fit"):
        lc.Corex(n_restarts=2, **kw).partial_fit(x)
    # the single-lane drivers mirror the plain fit's fitted attributes
    c = lc.Corex(**kw).partial_fit(x)
    assert c.best_restart_ == 0
    c2 = fit_with_checkpoints(lc.Corex(**KW), x, str(tmp_path / "ck1"))
    assert c2.best_restart_ == 0


def test_mesh_restart_sweep_matches_single_device():
    """Corex(n_restarts=k).fit(x, mesh=...) shards the lanes over the
    mesh's 'restarts' axis (restart_batch_runner pads the batch to the
    axis size and drops the pads) — the selected winner must be the
    single-device sweep's, on both the restart-only mesh and the
    combined restarts x data layout (BASELINE config 5's literal
    layout)."""
    from linearcorex_tpu.parallel.sharding import DATA_AXIS, make_mesh
    x = _data()
    ref = lc.Corex(n_restarts=3, seed=7, **KW).fit(x)
    # restart-only mesh; 3 lanes pad to the 8-wide axis
    m1 = lc.Corex(n_restarts=3, seed=7, **KW).fit(
        x, mesh=make_mesh((("restarts", 8),)))
    assert m1.best_restart_ == ref.best_restart_
    assert m1.tc == pytest.approx(ref.tc, rel=1e-9)
    assert np.abs(np.asarray(m1.ws) - np.asarray(ref.ws)).max() < 1e-8
    # combined layout: lanes over 'restarts', sample rows over 'data'
    ref2 = lc.Corex(n_restarts=2, seed=7, **KW).fit(x)
    m2 = lc.Corex(n_restarts=2, seed=7, **KW).fit(
        x, mesh=make_mesh((("restarts", 2), (DATA_AXIS, 4))))
    assert m2.best_restart_ == ref2.best_restart_
    assert m2.tc == pytest.approx(ref2.tc, rel=1e-7)
    # the winning lane's state serves unchanged (replicated)
    assert m2.transform(x).shape == (x.shape[0], 4)


def test_spectral_sweep_equals_best_of_single_fits():
    """init='spectral' restart lanes draw per-lane random projections
    Ω_r from RandomState(seed + r) — the restart seed policy applied to
    the spectral path — so the sweep equals the best of the k single
    spectral fits Corex(seed=s+r), and lane 0 ≡ the plain spectral fit.
    (Before round 5 this combination raised; spectral lanes genuinely
    differ through Ω — asserted below.)"""
    x = _data()
    kw = dict(KW, init="spectral", anneal=False)  # the spectral pairing
    sweep = lc.Corex(n_restarts=4, seed=7, **kw).fit(x)
    singles = [lc.Corex(seed=7 + r, **kw).fit(x) for r in range(4)]
    tcs = [c.tc for c in singles]
    best = int(np.argmax(tcs))
    assert sweep.best_restart_ == best
    assert sweep.tc == pytest.approx(tcs[best], rel=1e-9)
    assert np.abs(np.asarray(sweep.ws)
                  - np.asarray(singles[best].ws)).max() < 1e-8
    assert len(set(tcs)) > 1, (
        "all spectral lanes converged identically — the per-lane Ω "
        "randomization is not differentiating; pick a harder regime")


def test_throughput_preset_composes_with_restarts():
    """The preset docstring's own advice — pair 'throughput' with
    restarts when the TC matters — must be expressible in one call:
    Corex(preset='throughput', n_restarts=k) runs k spectral lanes."""
    x = np.asarray(_data(), np.float32)
    c = lc.Corex(n_hidden=4, preset="throughput", n_restarts=3, seed=0,
                 max_iter=200, record_history=False).fit(x)
    assert c.best_restart_ in (0, 1, 2)
    assert np.isfinite(float(c.tc))
    # the preset resolved as usual (spectral + int8 + anneal=False)
    assert c.config.init == "spectral"
    assert c.config.matmul_dtype == "int8"


def test_spectral_sweep_on_mesh_matches_single_device():
    from linearcorex_tpu.parallel.sharding import DATA_AXIS, make_mesh
    x = _data()
    kw = dict(KW, init="spectral", anneal=False)
    ref = lc.Corex(n_restarts=3, seed=7, **kw).fit(x)
    msh = lc.Corex(n_restarts=3, seed=7, **kw).fit(
        x, mesh=make_mesh((("restarts", 2), (DATA_AXIS, 4))))
    assert msh.best_restart_ == ref.best_restart_
    assert msh.tc == pytest.approx(ref.tc, rel=1e-7)


def test_mesh_restart_fit_transform_composes():
    """fit_transform under a restart mesh: the combined layout serves
    the transform under the mesh (the fit recorded its sample plan as
    the serving plan, like fit(mesh=...)); a restart-only mesh — which
    carries no serving axes — transforms single-device instead of
    failing the DP-plan validation after a successful fit."""
    from linearcorex_tpu.parallel.sharding import DATA_AXIS, make_mesh
    x = _data()
    ref = lc.Corex(n_restarts=2, seed=7, **KW).fit(x)
    y_ref = np.asarray(ref.transform(x))
    c1 = lc.Corex(n_restarts=2, seed=7, **KW)
    y1 = np.asarray(c1.fit_transform(
        x, mesh=make_mesh((("restarts", 2), (DATA_AXIS, 4)))))
    assert c1._serving_plan is not None  # combined layout recorded
    assert np.abs(y1 - y_ref).max() < 1e-8
    c2 = lc.Corex(n_restarts=2, seed=7, **KW)
    y2 = np.asarray(c2.fit_transform(x, mesh=make_mesh((("restarts", 8),))))
    assert c2._serving_plan is None  # restart-only: no serving layout
    assert np.abs(y2 - y_ref).max() < 1e-8
    # an EXPLICIT sharding_plan is honored, not silently dropped: the
    # user asked for sharded serving, so the plan validation fails loud
    from linearcorex_tpu.parallel.sharding import ShardingPlan
    with pytest.raises(ValueError, match="mesh has axes"):
        lc.Corex(n_restarts=2, seed=7, **KW).fit_transform(
            x, mesh=make_mesh((("restarts", 8),)),
            sharding_plan=ShardingPlan(shard_samples=True))


def test_mesh_restart_sweep_gram_strategy():
    """An explicit gram-strategy sweep under a restarts-only mesh runs
    with the operand replicated per lane and still matches the
    single-device sweep."""
    from linearcorex_tpu.parallel.sharding import make_mesh
    x = _data()
    kw = dict(KW, moment_strategy="gram")
    ref = lc.Corex(n_restarts=3, seed=7, **kw).fit(x)
    m = lc.Corex(n_restarts=3, seed=7, **kw).fit(
        x, mesh=make_mesh((("restarts", 8),)))
    assert m.best_restart_ == ref.best_restart_
    assert m.tc == pytest.approx(ref.tc, rel=1e-9)


@pytest.mark.parametrize("layout", ["combined", "restart_only", "gram"])
def test_mesh_restart_warmup_is_module_identical_to_fit(monkeypatch,
                                                        layout):
    """warmup_fit(mesh=...) with n_restarts > 1 must lower EXACTLY the
    sharded restart-sweep module fit dispatches (module-text identity =
    persistent-cache-key identity; see the round-4 warmup notes in
    DESIGN.md) — on every layout: combined restarts x data, restart-only
    mesh (replicated samples operand), and explicit-gram (replicated
    Gram operand)."""
    import linearcorex_tpu.parallel.restarts as R
    from linearcorex_tpu.parallel.sharding import DATA_AXIS, make_mesh
    from tests.conftest import module_text_probe

    texts = []
    monkeypatch.setattr(R, "_fit_restarts_program",
                        module_text_probe(R._fit_restarts_program, texts))
    x = _data()
    kw = dict(KW, max_iter=50)
    if layout == "combined":
        mesh = make_mesh((("restarts", 2), (DATA_AXIS, 4)))
    else:
        mesh = make_mesh((("restarts", 8),))
        if layout == "gram":
            kw["moment_strategy"] = "gram"
    model = lc.Corex(n_restarts=3, seed=7, **kw)
    model.warmup(x.shape[0], x.shape[1], mesh=mesh)
    model.fit(x, mesh=mesh)
    assert len(texts) == 2 and texts[0] == texts[1], \
        "warmup_fit lowered a different sharded restart-sweep module " \
        "than fit"


@pytest.mark.parametrize("layout", ["combined", "restart_only"])
def test_spectral_sweep_warmup_identity(monkeypatch, layout):
    """With init='spectral', warmup must lower BOTH the sweep module and
    the per-lane spectral-init module exactly as fit does (the sweep
    calls the single fit's spectral program once per lane — zero new
    cache keys; on the combined layout the operand is plan-sharded, on
    a restart-only mesh it is the single-device variant)."""
    import linearcorex_tpu.models.corex as C
    import linearcorex_tpu.parallel.restarts as R
    from linearcorex_tpu.parallel.sharding import DATA_AXIS, make_mesh
    from tests.conftest import module_text_probe

    fit_texts, spec_texts = [], []
    monkeypatch.setattr(R, "_fit_restarts_program",
                        module_text_probe(R._fit_restarts_program,
                                          fit_texts))
    monkeypatch.setattr(C, "_spectral_init_program",
                        module_text_probe(C._spectral_init_program,
                                          spec_texts))
    mesh = (make_mesh((("restarts", 2), (DATA_AXIS, 4)))
            if layout == "combined" else make_mesh((("restarts", 8),)))
    x = _data()
    kw = dict(KW, init="spectral", anneal=False, max_iter=50)
    model = lc.Corex(n_restarts=2, seed=7, **kw)
    model.warmup(x.shape[0], x.shape[1], mesh=mesh)
    model.fit(x, mesh=mesh)
    assert len(fit_texts) == 2 and fit_texts[0] == fit_texts[1], \
        "warmup lowered a different sharded sweep module than fit"
    # 1 warmup lowering + 2 per-lane fit calls, all one module text
    assert len(spec_texts) == 3 and len(set(spec_texts)) == 1, \
        "the sweep's per-lane spectral init must reuse the warmed " \
        "spectral program (one cache key)"


def test_mesh_restart_guards_raise_by_name():
    """The unsupported mesh combinations raise by name: a mesh without a
    'restarts' axis (fit AND warmup — the shared layout definition), and
    var/factor/slice-sharding plans."""
    from linearcorex_tpu.parallel.sharding import (DATA_AXIS, VAR_AXIS,
                                                   ShardingPlan, make_mesh)
    x = _data()
    mesh_nr = make_mesh(((DATA_AXIS, 8),))
    with pytest.raises(ValueError, match="'restarts'"):
        lc.Corex(n_restarts=2, **KW).fit(x, mesh=mesh_nr)
    with pytest.raises(ValueError, match="'restarts'"):
        lc.Corex(n_restarts=2, **KW).warmup(256, 32, mesh=mesh_nr)
    mesh_rv = make_mesh((("restarts", 4), (VAR_AXIS, 2)))
    with pytest.raises(ValueError, match="sample sharding only"):
        lc.Corex(n_restarts=2, **KW).fit(
            x, mesh=mesh_rv, sharding_plan=ShardingPlan(shard_vars=True))


def test_save_load_roundtrips_restart_state(tmp_path):
    """save_corex/load_corex carry the sweep state: `best_restart_`
    round-trips (fitted-attribute completeness) and `n_restarts` is
    restored VERBATIM — a post-load fit() on a best-of-k model raises
    the warm-start x restarts guard by name instead of silently fitting
    one lane."""
    from linearcorex_tpu.utils.checkpoint import load_corex, save_corex
    x = _data()
    c = lc.Corex(n_restarts=3, seed=7, **KW).fit(x)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    c2 = load_corex(path)
    assert c2.n_restarts == 3
    assert c2.best_restart_ == c.best_restart_
    assert np.array_equal(np.asarray(c2.ws), np.asarray(c.ws))
    with pytest.raises(ValueError, match="load_corex"):
        c2.fit(x)  # warm start x restarts: by name, never one lane
    # single-lane models round-trip best_restart_=0
    save_corex(lc.Corex(seed=7, **KW).fit(x), path)
    assert load_corex(path).best_restart_ == 0
    # numpy scalars from sklearn param grids (np.arange/GridSearchCV)
    # are stored verbatim on the estimator and must still serialize
    c3 = lc.Corex(n_restarts=np.int64(2), seed=np.int64(7), **KW).fit(x)
    save_corex(c3, path)
    c4 = load_corex(path)
    assert c4.n_restarts == 2 and c4.best_restart_ == c3.best_restart_


def test_sweep_oom_raises_with_guidance(monkeypatch):
    """A device OOM inside a restart sweep (measured: 6 lanes at cfg5)
    must surface the lane-memory model and the remedies (fewer lanes,
    sequential fits, restart-axis sharding) instead of a raw XLA
    RESOURCE_EXHAUSTED — on the estimator path AND the selection sweep
    (the guidance lives on the shared restart_batch_runner, with the
    results synced inside the scope so async-dispatch delivery cannot
    escape it); other runtime errors pass through untouched."""
    import jax
    import linearcorex_tpu.parallel.restarts as R
    x = _data()

    def boom(*a, **k):
        raise jax.errors.JaxRuntimeError(
            "RESOURCE_EXHAUSTED: Out of memory while trying to allocate.")

    monkeypatch.setattr(R, "_fit_restarts_program", boom)
    with pytest.raises(jax.errors.JaxRuntimeError, match="fewer lanes"):
        lc.Corex(n_restarts=3, seed=0, **KW).fit(x)
    with pytest.raises(jax.errors.JaxRuntimeError, match="fewer lanes"):
        lc.pick_n_hidden(np.asarray(x), repeat=2, max_n_hidden=3,
                         max_iter=50, seed=0)

    def other(*a, **k):
        raise jax.errors.JaxRuntimeError("INTERNAL: something else")

    monkeypatch.setattr(R, "_fit_restarts_program", other)
    with pytest.raises(jax.errors.JaxRuntimeError,
                       match="something else"):
        lc.Corex(n_restarts=3, seed=0, **KW).fit(x)


def test_sklearn_protocol_roundtrip():
    """n_restarts is a verbatim constructor parameter: get_params /
    set_params / clone round-trip, validation deferred to fit."""
    from sklearn.base import clone
    c = lc.Corex(n_restarts=3, **KW)
    assert c.get_params()["n_restarts"] == 3
    c2 = clone(c)
    assert c2.get_params()["n_restarts"] == 3
    c.set_params(n_restarts="bad")  # stored verbatim, no raise here
    with pytest.raises(ValueError, match="n_restarts"):
        c.fit(_data())


def test_fit_transform_and_inference_after_sweep():
    x = _data()
    c = lc.Corex(n_restarts=3, seed=0, **KW)
    y = c.fit_transform(x)
    assert y.shape == (256, 4)
    assert np.asarray(c.transform(x)).shape == (256, 4)
    assert c.get_covariance().shape == (32, 32)
    assert len(c.history["iters_per_stage"]) == \
        len(c.config.anneal_schedule())


def test_warmup_covers_restart_sweep(monkeypatch):
    """Corex(n_restarts=k).warmup(n, p) must lower EXACTLY the vmapped
    sweep module fit dispatches (the warmup-identity invariant: a warmed
    single-fit key would be dead for a restarts model)."""
    import linearcorex_tpu.parallel.restarts as R
    from tests.conftest import module_text_probe

    texts = []
    monkeypatch.setattr(R, "_fit_restarts_program",
                        module_text_probe(R._fit_restarts_program, texts))
    x = _data()
    c = lc.Corex(n_restarts=3, seed=1, **KW)
    c.warmup(256, 32)
    c.fit(x)
    assert len(texts) == 2 and texts[0] == texts[1], (
        "warmup lowered a different restart-sweep module than fit")
    # and a mesh warmup on a restarts model raises like fit(mesh=...)
    # when the mesh lacks a 'restarts' axis (the shared layout
    # definition; the supported mesh layouts are pinned by
    # test_mesh_restart_warmup_is_module_identical_to_fit)
    from linearcorex_tpu.parallel.sharding import make_mesh
    with pytest.raises(ValueError, match="'restarts'"):
        c.warmup(256, 32, mesh=make_mesh())

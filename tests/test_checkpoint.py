"""Checkpoint round-trip tests (SURVEY.md §5 checkpoint/resume)."""

import numpy as np

import linearcorex_tpu as lc
from linearcorex_tpu.utils.checkpoint import load_corex, save_corex


def test_save_load_roundtrip(tmp_path, small_block_data):
    x = small_block_data
    c = lc.Corex(n_hidden=4, seed=0, dtype="float64").fit(x)
    path = str(tmp_path / "model.npz")
    save_corex(c, path)
    c2 = load_corex(path)
    assert np.array_equal(np.asarray(c2.ws), np.asarray(c.ws))
    assert abs(c2.tc - c.tc) < 1e-12
    assert np.array_equal(np.asarray(c2.clusters), np.asarray(c.clusters))
    # inference from the restored model matches
    y1, y2 = np.asarray(c.transform(x)), np.asarray(c2.transform(x))
    assert np.abs(y1 - y2).max() < 1e-12
    cov1, cov2 = np.asarray(c.get_covariance()), np.asarray(
        c2.get_covariance())
    assert np.abs(cov1 - cov2).max() < 1e-12


def test_resume_warm_start(tmp_path, small_block_data):
    x = small_block_data
    c = lc.Corex(n_hidden=4, seed=0).fit(x)
    path = str(tmp_path / "model.npz")
    save_corex(c, path)
    c2 = load_corex(path)
    c2.fit(x)  # warm start from stored ws (rides the full anneal schedule)
    cold_iters = int(np.asarray(c.diagnostics.iters_per_stage).sum())
    warm_iters = int(np.asarray(c2.diagnostics.iters_per_stage).sum())
    assert warm_iters < cold_iters
    assert abs(c2.tc - c.tc) < 1e-2


def test_unfitted_raises(tmp_path):
    import pytest
    with pytest.raises(ValueError):
        save_corex(lc.Corex(n_hidden=2), str(tmp_path / "x.npz"))


def test_fit_with_checkpoints_matches_plain_fit(tmp_path, small_block_data):
    """Stage-by-stage fit with boundary checkpoints lands on the same
    solution as the one-program fit (momentum buffer resets at stage
    boundaries in both paths — scan stages don't carry v either)."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints
    x = small_block_data
    w0 = np.random.RandomState(5).normal(scale=1 / np.sqrt(32), size=(4, 32))
    ref = lc.Corex(n_hidden=4, dtype="float64").fit(x, init_ws=w0)
    m2 = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(m2, x, str(tmp_path / "ck"), init_ws=w0)
    assert abs(m2.tc - ref.tc) < 1e-9
    assert np.abs(np.asarray(m2.ws) - np.asarray(ref.ws)).max() < 1e-9


def test_fit_with_checkpoints_resumes(tmp_path, small_block_data):
    """Interrupting after stage k and restarting resumes from stage k+1 and
    reaches the same final solution."""
    import dataclasses
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints
    from linearcorex_tpu.models.corex import _fit_program
    from linearcorex_tpu.ops import preprocessing as Pre
    from linearcorex_tpu.ops import moments as M
    import jax.numpy as jnp

    x = small_block_data
    w0 = np.random.RandomState(5).normal(scale=1 / np.sqrt(32), size=(4, 32))
    ckdir = str(tmp_path / "ck")

    # simulate an interrupted run: execute only the first 3 stages manually
    model = lc.Corex(n_hidden=4, dtype="float64")
    xj = jnp.asarray(x, jnp.float64)
    xp, theta = Pre.fit_preprocess(xj, "standard")
    strategy = model.config.pick_strategy(*x.shape)
    data = M.compute_gram(xp) if strategy.startswith("gram") else xp
    schedule = model.config.anneal_schedule()
    ws = jnp.asarray(w0, jnp.float64)
    import os
    from linearcorex_tpu.utils.checkpoint import _fit_fingerprint
    os.makedirs(ckdir, exist_ok=True)
    fp = np.frombuffer(
        _fit_fingerprint(model, x, schedule).encode(), dtype=np.uint8)
    for s in range(3):
        cfg_s = dataclasses.replace(model.config, eps_override=schedule[s])
        ws, _, _ = _fit_program(data, ws, cfg_s, strategy)
        np.savez(os.path.join(ckdir, "stage_state.npz"),
                 ws=np.asarray(ws), stage=s + 1, fingerprint=fp)

    # resume completes the remaining stages
    m2 = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(m2, x, ckdir, init_ws=w0)
    ref = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(ref, x, str(tmp_path / "ck2"), init_ws=w0)
    assert abs(m2.tc - ref.tc) < 1e-9


def test_fit_with_checkpoints_rejects_stale_checkpoint(tmp_path,
                                                       small_block_data):
    """Reusing a checkpoint dir after changing data or hyperparameters must
    NOT silently resume stale weights (advisor r1, medium): the fingerprint
    mismatch warns and restarts from stage 0."""
    import pytest
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints

    x = small_block_data
    ckdir = str(tmp_path / "ck")
    w0 = np.random.RandomState(5).normal(scale=1 / np.sqrt(32), size=(4, 32))
    m1 = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(m1, x, ckdir, init_ws=w0)

    # different data in the same dir => warn + full refit, result must
    # equal a clean fit on the new data
    x2 = x[::-1].copy() * 1.5 + 0.1
    m2 = lc.Corex(n_hidden=4, dtype="float64")
    with pytest.warns(UserWarning, match="different"):
        fit_with_checkpoints(m2, x2, ckdir, init_ws=w0)
    ref = lc.Corex(n_hidden=4, dtype="float64").fit(x2, init_ws=w0)
    assert abs(m2.tc - ref.tc) < 1e-9

    # different hyperparameters likewise
    m3 = lc.Corex(n_hidden=4, dtype="float64", tol=1e-4)
    with pytest.warns(UserWarning, match="different"):
        fit_with_checkpoints(m3, x2, ckdir, init_ws=w0)
    assert np.isfinite(m3.tc)


def test_fit_with_checkpoints_validates_like_fit(tmp_path):
    """fit_with_checkpoints shares Corex.fit's input validation (round-1
    gap: it accepted inputs plain fit rejects)."""
    import pytest
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints

    m = lc.Corex(n_hidden=2)
    with pytest.raises(ValueError, match="2-D"):
        fit_with_checkpoints(m, np.zeros(8), str(tmp_path / "ck"))
    bad = np.random.RandomState(0).normal(size=(20, 8))
    bad[3, 4] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        fit_with_checkpoints(m, bad, str(tmp_path / "ck"))


def test_save_load_path_without_suffix(tmp_path, small_block_data):
    """save_corex('ckpt') writes ckpt.npz (np.savez appends the suffix);
    load_corex('ckpt') must find it, and update_iter/verbose round-trip."""
    c = lc.Corex(n_hidden=4, seed=0, update_iter=7, verbose=True).fit(
        small_block_data)
    path = str(tmp_path / "model")  # no .npz
    save_corex(c, path)
    c2 = load_corex(path)
    assert np.array_equal(np.asarray(c2.ws), np.asarray(c.ws))
    assert c2.update_iter == 7 and c2.verbose is True


def test_checkpointed_int8_fit_close_to_plain(tmp_path, small_block_data):
    """int8 checkpointed fits agree with the plain int8 fit to
    quantization-noise level (NOT bitwise: the stage-by-stage programs
    compile separately, and per-column max reductions may reassociate,
    shifting operands by +/-1 quantization level — the accept/reject
    trajectory then diverges within the noise floor)."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints

    x = small_block_data
    m = lc.Corex(n_hidden=4, seed=0, matmul_dtype="int8", tol=1e-4)
    fit_with_checkpoints(m, x, str(tmp_path / "ck8"))
    plain = lc.Corex(n_hidden=4, seed=0, matmul_dtype="int8",
                     tol=1e-4).fit(x)
    assert abs(float(m.tc) - float(plain.tc)) / float(plain.tc) < 0.02
    assert np.array_equal(np.asarray(m.clusters),
                          np.asarray(plain.clusters))


def test_fit_with_checkpoints_sharded_matches_sharded_fit(tmp_path,
                                                          med_block_data):
    """mesh= runs every stage through the sharded program: the
    checkpointed sharded fit equals the uncheckpointed Corex.fit(mesh=...)
    (f64, 8-device CPU mesh)."""
    from linearcorex_tpu.parallel.sharding import make_mesh
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints

    x = med_block_data
    mesh = make_mesh()
    w0 = np.random.RandomState(5).normal(scale=1 / np.sqrt(64),
                                         size=(8, 64))
    ref = lc.Corex(n_hidden=8, dtype="float64").fit(x, init_ws=w0,
                                                    mesh=mesh)
    m2 = lc.Corex(n_hidden=8, dtype="float64")
    fit_with_checkpoints(m2, x, str(tmp_path / "ck"), init_ws=w0,
                         mesh=mesh)
    assert abs(m2.tc - ref.tc) < 1e-9
    assert np.abs(np.asarray(m2.ws) - np.asarray(ref.ws)).max() < 1e-9


def test_fit_with_checkpoints_mesh_resume_is_layout_invariant(
        tmp_path, small_block_data):
    """A checkpoint written by a SINGLE-DEVICE stage run resumes under
    mesh= (the .npz format carries replicated ws; the fingerprint covers
    config/data/schedule, not layout) and reaches the same solution.

    Rows are trimmed to a mesh-divisible count: since the mesh-aware
    prepare the GSPMD divisibility contract is
    enforced at `_prepare_fit(mesh=...)` — BEFORE the resume discovers
    the checkpoint is complete — exactly like every other mesh entry
    point. Both runs must see the same x (the fingerprint covers it)."""
    from linearcorex_tpu.parallel.sharding import make_mesh
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints

    x = small_block_data[:496]  # 496 % 8 devices == 0
    w0 = np.random.RandomState(5).normal(scale=1 / np.sqrt(32),
                                         size=(4, 32))
    ckdir = str(tmp_path / "ck")
    single = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(single, x, ckdir, init_ws=w0)  # full run: stage
    # file now says "all stages done"; a mesh resume just finalizes
    m2 = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(m2, x, ckdir, init_ws=w0, mesh=make_mesh())
    assert abs(m2.tc - single.tc) < 1e-9


def test_stage_callback_runs_per_stage(tmp_path, small_block_data):
    """stage_callback fires once per anneal stage with (stage, eps, ws,
    stats) and sees monotonically-filled stats (SURVEY §5 metrics row)."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints

    seen = []

    def cb(stage, eps, ws, stats):
        seen.append((stage, float(eps), ws.shape,
                     int(stats["iters"][stage])))

    model = lc.Corex(n_hidden=4, dtype="float64")
    fit_with_checkpoints(model, small_block_data, str(tmp_path / "ck"),
                         stage_callback=cb)
    schedule = model.config.anneal_schedule()
    assert [s[0] for s in seen] == list(range(len(schedule)))
    assert [s[1] for s in seen] == [float(e) for e in schedule]
    assert all(shape == (4, 32) for _, _, shape, _ in seen)
    assert all(iters > 0 for *_, iters in seen)


def test_fit_with_checkpoints_respects_stage_tol_factor(tmp_path,
                                                        small_block_data):
    """The stage-by-stage driver pre-bakes each stage's tol from
    tol_schedule() into its eps_override config, so a checkpointed
    stage_tol_factor fit lands exactly on the one-program fit."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints
    x = small_block_data
    w0 = np.random.RandomState(5).normal(scale=1 / np.sqrt(32),
                                         size=(4, 32))
    ref = lc.Corex(n_hidden=4, dtype="float64",
                   stage_tol_factor=10.0).fit(x, init_ws=w0)
    m2 = lc.Corex(n_hidden=4, dtype="float64", stage_tol_factor=10.0)
    fit_with_checkpoints(m2, x, str(tmp_path / "ck"), init_ws=w0)
    assert abs(m2.tc - ref.tc) < 1e-9
    assert np.abs(np.asarray(m2.ws) - np.asarray(ref.ws)).max() < 1e-9
    # and the driver genuinely loosened the non-final stages: compare
    # against a factor=1 BASELINE (comparing m2 to the factor=10 ref
    # would be vacuous — they were just asserted identical)
    base = lc.Corex(n_hidden=4, dtype="float64").fit(x, init_ws=w0)
    assert (np.asarray(m2.diagnostics.iters_per_stage)[:-1].sum()
            < np.asarray(base.diagnostics.iters_per_stage)[:-1].sum())


def test_save_load_roundtrips_stage_tol_factor(tmp_path, small_block_data):
    """load_corex must restore EVERY config field; stage_tol_factor was
    the one omission (a warm-started refit of the loaded model silently
    ran the reference-parity stage schedule)."""
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints
    x = small_block_data
    c = lc.Corex(n_hidden=4, seed=0, dtype="float64",
                 stage_tol_factor=10.0).fit(x)
    path = str(tmp_path / "m.npz")
    save_corex(c, path)
    c2 = load_corex(path)
    assert c2.stage_tol_factor == 10.0
    assert c2.get_params()["stage_tol_factor"] == 10.0
    assert c2.config.tol_schedule() == c.config.tol_schedule()


def test_fingerprint_ignores_default_valued_config_fields(
        tmp_path, small_block_data):
    """Additive config evolution must not invalidate resumes: a
    checkpoint fingerprinted before a new (defaulted) config field
    landed must still resume after it. Pinned by asserting the
    fingerprint payload excludes default-valued fields entirely — and
    that NON-default values still change it."""
    from linearcorex_tpu.utils.checkpoint import _fit_fingerprint
    x = np.asarray(small_block_data)
    m_default = lc.Corex(n_hidden=4, dtype="float64")
    m_explicit = lc.Corex(n_hidden=4, dtype="float64",
                          stage_tol_factor=1.0)   # AT the default
    m_changed = lc.Corex(n_hidden=4, dtype="float64",
                         stage_tol_factor=10.0)
    sched = m_default.config.anneal_schedule()
    fp_d = _fit_fingerprint(m_default, x, sched)
    assert fp_d == _fit_fingerprint(m_explicit, x, sched)
    assert fp_d != _fit_fingerprint(m_changed, x, sched)


def test_load_legacy_checkpoint_with_use_pallas(tmp_path, small_block_data):
    """Checkpoints written while the fused-chain option existed carry a
    `use_pallas` config entry; load_corex ignores it and the model
    serves and refits as before."""
    import json

    from linearcorex_tpu.utils.checkpoint import load_corex, save_corex

    m = lc.Corex(n_hidden=4, seed=0).fit(small_block_data)
    path = str(tmp_path / "legacy.npz")
    save_corex(m, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta["config"]["use_pallas"] = "always"
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez(path, **arrays)
    m2 = load_corex(path)
    assert not hasattr(m2.config, "use_pallas")
    assert "use_pallas" not in m2.get_params()
    np.testing.assert_allclose(np.asarray(m2.transform(small_block_data)),
                               np.asarray(m.transform(small_block_data)),
                               rtol=1e-6, atol=1e-6)
    assert np.isfinite(m2.fit(small_block_data).tc)

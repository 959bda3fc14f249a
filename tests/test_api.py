"""API surface tests for the Corex estimator (SURVEY.md §2.6 contract)."""

import numpy as np
import pytest

import linearcorex_tpu as lc


def test_fit_transform(med_block_data):
    c = lc.Corex(n_hidden=8, seed=0)
    y = c.fit_transform(med_block_data)
    assert y.shape == (1000, 8)
    assert np.allclose(np.asarray(y),
                       np.asarray(c.transform(med_block_data)))


def test_tcs_sorted_and_tc_sum(med_block_data):
    c = lc.Corex(n_hidden=8, seed=0).fit(med_block_data)
    tcs = np.asarray(c.tcs)
    assert np.all(np.diff(tcs) <= 1e-6)
    assert abs(c.tc - tcs.sum()) < 1e-5


def test_clusters_shape_range(med_block_data):
    c = lc.Corex(n_hidden=8, seed=0).fit(med_block_data)
    cl = np.asarray(c.clusters)
    assert cl.shape == (64,)
    assert cl.min() >= 0 and cl.max() < 8


def test_pretrained_weights_warm_start(small_block_data):
    c1 = lc.Corex(n_hidden=4, seed=0).fit(small_block_data)
    c2 = lc.Corex(n_hidden=4, pretrained_weights=np.asarray(c1.ws),
                  anneal=False).fit(small_block_data)
    assert int(np.asarray(c2.diagnostics.iters_per_stage)[0]) < 25
    assert abs(c2.tc - c1.tc) < 1e-2


def test_history(med_block_data):
    c = lc.Corex(n_hidden=8, seed=0).fit(med_block_data)
    h = c.history
    assert len(h["TC"]) == int(np.sum(h["iters_per_stage"]))
    assert len(h["eps"]) == len(h["TC"])
    # TC curve finishes near the reported optimum
    assert abs(h["TC"][-1] - c.tc) / max(c.tc, 1.0) < 0.05


def test_history_labels_survive_set_params(med_block_data, capsys):
    """The eps labels in `history`/verbose come from the FIT-TIME schedule
    snapshot in the diagnostics: a post-fit
    set_params(anneal=False) must neither relabel nor truncate the
    recorded trajectory."""
    c = lc.Corex(n_hidden=8, seed=0, verbose=False).fit(med_block_data)
    h_before = c.history
    n_stages = len(np.asarray(c.diagnostics.iters_per_stage))
    assert n_stages == 7  # the annealed 0.6^1..0.6^6, 0 schedule ran
    c.set_params(anneal=False)  # current config now says 1 stage
    h_after = c.history
    assert h_after["eps"] == h_before["eps"]
    assert h_after["TC"] == h_before["TC"]
    # verbose reporting labels from the snapshot too
    c.verbose = True
    c._print_verbose()
    out = capsys.readouterr().out
    assert out.count("eps:") == n_stages
    assert "eps: 0.6000" in out  # the fitted schedule's first stage


def test_fit_report_default_schedule(small_block_data):
    """fit_report labels stages from the diagnostics' schedule snapshot
    when no explicit schedule is passed."""
    from linearcorex_tpu.utils.profiling import fit_report
    c = lc.Corex(n_hidden=4, seed=0).fit(small_block_data)
    rep = fit_report(c.diagnostics)
    assert "0.6000" in rep and "nan" not in rep


def test_record_history_off(small_block_data):
    c = lc.Corex(n_hidden=4, seed=0, record_history=False).fit(
        small_block_data)
    assert c.diagnostics.tc_history.shape[1] == 0
    assert c.history["TC"] == []


def test_covariance_matvec_matches_dense(med_block_data):
    c = lc.Corex(n_hidden=8, seed=0, dtype="float64").fit(med_block_data)
    cov = np.asarray(c.get_covariance())
    v = np.random.RandomState(0).normal(size=64)
    got = np.asarray(c.covariance_matvec(v))
    assert np.abs(got - cov @ v).max() < 1e-8


def test_covariance_matvec_matches_dense_overlap(med_block_data):
    """matvec ≡ dense for the overlap (discourage_overlap=False) path too
    (round-1 regression: the non-overlap factorization was applied
    unconditionally, silently wrong for overlap models)."""
    c = lc.Corex(n_hidden=8, seed=0, dtype="float64",
                 discourage_overlap=False).fit(med_block_data)
    cov = np.asarray(c.get_covariance())
    v = np.random.RandomState(0).normal(size=64)
    got = np.asarray(c.covariance_matvec(v))
    assert np.abs(got - cov @ v).max() < 1e-8


def test_verbose_prints(small_block_data, capsys):
    lc.Corex(n_hidden=4, seed=0, verbose=True).fit(small_block_data)
    out = capsys.readouterr().out
    assert "eps" in out and "TC" in out


def test_verbose_update_iter_cadence(small_block_data, capsys):
    """One TC progress line every update_iter iterations (`[U] :: Corex.fit`
    logging contract), derived post-fit from the diagnostics arrays."""
    c = lc.Corex(n_hidden=4, seed=0, verbose=True, update_iter=5).fit(
        small_block_data)
    out = capsys.readouterr().out
    iters = np.asarray(c.diagnostics.iters_per_stage)
    expected = int(sum(k // 5 for k in iters))
    assert out.count("iter=") == expected
    # coarser cadence => fewer lines
    c2 = lc.Corex(n_hidden=4, seed=0, verbose=True, update_iter=50)
    c2.fit(small_block_data)
    out2 = capsys.readouterr().out
    assert out2.count("iter=") < max(expected, 1)


def test_gpu_flag_accepted(small_block_data):
    """`gpu=` is reference API compatibility; ignored (one XLA backend)."""
    c = lc.Corex(n_hidden=4, seed=0, gpu=True).fit(small_block_data)
    assert np.isfinite(c.tc)


def test_bad_gaussianize_raises(small_block_data):
    # sklearn deferred-validation contract: constructing with an invalid
    # value is allowed; the error surfaces at first use (fit)
    c = lc.Corex(gaussianize="nope")
    with pytest.raises(ValueError, match="unknown gaussianize"):
        c.fit(small_block_data)


def test_anneal_off_single_stage(small_block_data):
    c = lc.Corex(n_hidden=4, seed=0, anneal=False).fit(small_block_data)
    assert np.asarray(c.diagnostics.iters_per_stage).shape == (1,)


def test_seed_reproducibility(small_block_data):
    c1 = lc.Corex(n_hidden=4, seed=123).fit(small_block_data)
    c2 = lc.Corex(n_hidden=4, seed=123).fit(small_block_data)
    assert np.array_equal(np.asarray(c1.ws), np.asarray(c2.ws))
    c3 = lc.Corex(n_hidden=4, seed=124).fit(small_block_data)
    assert not np.array_equal(np.asarray(c1.ws), np.asarray(c3.ws))


def test_bf16_matmul_mode_quality(med_block_data):
    """Throughput mode: bf16 GEMMs still recover structure; TC within 1%."""
    import linearcorex_tpu as lc
    w0 = np.random.RandomState(7).normal(scale=1 / 8, size=(8, 64))
    c32 = lc.Corex(n_hidden=8, tol=1e-4).fit(med_block_data, init_ws=w0)
    cbf = lc.Corex(n_hidden=8, tol=1e-4, matmul_dtype="bfloat16").fit(
        med_block_data, init_ws=w0)
    # same partition up to factor relabeling (the tcs sort can swap
    # near-tied factors between numeric modes)
    mapping = {}
    for a, b in zip(np.asarray(cbf.clusters), np.asarray(c32.clusters)):
        assert mapping.setdefault(int(a), int(b)) == int(b)
    assert abs(cbf.tc - c32.tc) / c32.tc < 0.02


def test_matmul_precision_option(small_block_data):
    """'highest' precision mode runs and matches default on CPU (where f32
    matmuls are true f32 either way; the knob matters on the GPU, where
    the default is TF32)."""
    import linearcorex_tpu as lc
    w0 = np.random.RandomState(9).normal(scale=1 / np.sqrt(32), size=(4, 32))
    c1 = lc.Corex(n_hidden=4).fit(small_block_data, init_ws=w0)
    c2 = lc.Corex(n_hidden=4, matmul_precision="highest").fit(
        small_block_data, init_ws=w0)
    assert abs(c1.tc - c2.tc) / c1.tc < 1e-4


def test_bf16_samples_strategy_quality(med_block_data):
    """bf16 mode on the samples path (X stored bf16) still recovers blocks."""
    import linearcorex_tpu as lc
    w0 = np.random.RandomState(8).normal(scale=1 / 8, size=(8, 64))
    c32 = lc.Corex(n_hidden=8, tol=1e-4, moment_strategy="samples").fit(
        med_block_data, init_ws=w0)
    cbf = lc.Corex(n_hidden=8, tol=1e-4, moment_strategy="samples",
                   matmul_dtype="bfloat16").fit(med_block_data, init_ws=w0)
    mapping = {}
    for a, b in zip(np.asarray(cbf.clusters), np.asarray(c32.clusters)):
        assert mapping.setdefault(int(a), int(b)) == int(b)
    assert abs(cbf.tc - c32.tc) / c32.tc < 0.02


def test_sklearn_params_protocol(small_block_data):
    c = lc.Corex(n_hidden=4, seed=0)
    params = c.get_params()
    assert params["n_hidden"] == 4 and params["seed"] == 0
    c.set_params(n_hidden=3, tol=1e-4)
    assert c.config.n_hidden == 3 and c.config.tol == 1e-4
    with pytest.raises(ValueError, match="invalid parameter"):
        c.set_params(bogus=1)
    # clone-style roundtrip
    c2 = lc.Corex(**c.get_params())
    assert c2.get_params() == c.get_params()
    c2.fit(small_block_data)
    assert np.isfinite(c2.tc)


def test_set_params_preserves_fitted_state(small_block_data):
    """sklearn contract: set_params updates parameters only — fitted state
    (ws, moments, theta, diagnostics) survives cosmetic changes."""
    c = lc.Corex(n_hidden=4, seed=0).fit(small_block_data)
    ws_before = np.asarray(c.ws)
    tc_before = c.tc
    c.set_params(verbose=True, update_iter=3)
    assert c.ws is not None and c.moments is not None
    assert np.array_equal(np.asarray(c.ws), ws_before)
    assert c.tc == tc_before
    assert c.verbose is True and c.update_iter == 3
    c.set_params(gaussianize="empirical", missing_values=-1.0)
    assert c.pre_config.gaussianize == "empirical"
    assert c.pre_config.missing_values == -1.0
    # value validation is deferred to first use (sklearn contract:
    # set_params itself must not validate values, only names)
    c.set_params(gaussianize="bogus")
    with pytest.raises(ValueError, match="unknown gaussianize"):
        c.pre_config


def test_covariance_beats_sample_cov_undersampled():
    """The reference's headline use case (paper §'blessing of
    dimensionality'; SURVEY.md §2.0): at n < p, get_covariance() is a
    materially better estimate of the TRUE covariance than the sample
    covariance. Full comparison incl. Ledoit-Wolf shrinkage (measured
    corex 0.35 vs LW 0.59 vs sample 0.70 rel. Frobenius at p=256/n=64):
    examples/covariance_quality.py."""
    p, n, n_blocks, r = 96, 32, 8, 0.7
    k = p // n_blocks
    sigma_true = np.eye(p)
    for b in range(n_blocks):
        s = slice(b * k, (b + 1) * k)
        sigma_true[s, s] = r
    np.fill_diagonal(sigma_true, 1.0)
    rng = np.random.RandomState(1)
    x = rng.normal(size=(n, p)) @ np.linalg.cholesky(sigma_true).T

    xc = x - x.mean(0)
    err_sample = np.linalg.norm(xc.T @ xc / n - sigma_true)
    model = lc.Corex(n_hidden=n_blocks, seed=0).fit(x)
    err_corex = np.linalg.norm(
        np.asarray(model.get_covariance()) - sigma_true)
    assert err_corex < 0.7 * err_sample, (err_corex, err_sample)


def _dense_ll(x, cov, mean, std):
    """Reference mean log-likelihood via dense slogdet (test-only)."""
    xc = np.asarray(x, np.float64) - np.asarray(mean, np.float64)
    c = np.asarray(cov, np.float64)
    sign, logdet = np.linalg.slogdet(c)
    assert sign > 0
    sol = np.linalg.solve(c, xc.T)
    quad = np.sum(xc.T * sol, axis=0)
    p = c.shape[0]
    return float(np.mean(-0.5 * (quad + logdet + p * np.log(2 * np.pi))))


@pytest.mark.parametrize("overlap", [False, True])
def test_score_matches_dense_loglik(small_block_data, overlap):
    """score() (Woodbury, O(npm)) equals the dense slogdet log-likelihood
    of get_covariance() on both solver paths."""
    x = small_block_data
    c = lc.Corex(n_hidden=4, seed=0, dtype="float64",
                 discourage_overlap=not overlap).fit(x)
    got = float(c.score(x))
    want = _dense_ll(x, c.get_covariance(), c.theta.mean, c.theta.std)
    assert abs(got - want) < 1e-6 * max(1.0, abs(want)), (got, want)


def test_score_ranks_model_data_above_noise(small_block_data):
    """In-model data scores higher than permutation-destroyed data."""
    x = small_block_data
    c = lc.Corex(n_hidden=4, seed=0).fit(x)
    rng = np.random.RandomState(0)
    x_shuf = np.column_stack([rng.permutation(col) for col in x.T])
    assert float(c.score(x)) > float(c.score(x_shuf))


def test_score_rejects_nonaffine_gaussianize(small_block_data):
    c = lc.Corex(n_hidden=4, seed=0, gaussianize="empirical").fit(
        small_block_data)
    with pytest.raises(ValueError, match="affine|empirical|standard"):
        c.score(small_block_data)


@pytest.mark.parametrize("overlap", [False, True])
def test_covariance_matmat_matches_dense(med_block_data, overlap):
    """Σ̂·V block application ≡ dense Σ̂ @ V on both solver paths (f64)."""
    c = lc.Corex(n_hidden=8, seed=0, dtype="float64",
                 discourage_overlap=not overlap).fit(med_block_data)
    cov = np.asarray(c.get_covariance())
    v = np.random.RandomState(1).normal(size=(64, 5))
    got = np.asarray(c.covariance_matmat(v))
    assert got.shape == (64, 5)
    assert np.abs(got - cov @ v).max() < 1e-8
    # and column-wise consistency with matvec
    mv = np.asarray(c.covariance_matvec(v[:, 0]))
    assert np.abs(got[:, 0] - mv).max() < 1e-10


def test_covariance_matmat_validates_width(med_block_data):
    c = lc.Corex(n_hidden=4, seed=0).fit(med_block_data)
    with pytest.raises(ValueError, match="rows"):
        c.covariance_matmat(np.zeros((3, 2)))
    with pytest.raises(ValueError, match="rows"):
        c.covariance_matmat(np.zeros(64))


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("block_size", [64, 17, 100])
def test_covariance_blocks_assemble_dense(med_block_data, overlap,
                                          block_size):
    """Row-block export reassembles exactly the dense covariance on both
    paths, for exact-dividing, ragged, and larger-than-p block sizes."""
    c = lc.Corex(n_hidden=8, seed=0, dtype="float64",
                 discourage_overlap=not overlap).fit(med_block_data)
    cov = np.asarray(c.get_covariance())
    out = np.full_like(cov, np.nan)
    for start, rows in c.covariance_blocks(block_size):
        rows = np.asarray(rows)
        out[start:start + rows.shape[0]] = rows
    assert np.isfinite(out).all()
    assert np.abs(out - cov).max() < 1e-8


def test_covariance_blocks_validates(med_block_data):
    c = lc.Corex(n_hidden=4, seed=0).fit(med_block_data)
    with pytest.raises(ValueError, match="block_size"):
        list(c.covariance_blocks(0))
    with pytest.raises(lc.NotFittedError, match="not fitted"):
        list(lc.Corex(n_hidden=4).covariance_blocks())


def test_unseeded_init_is_device_side_and_fresh(small_block_data):
    """seed=None inits draw on device (no W-sized host→device transfer —
    ~12 s at cfg5 through this attachment) with fresh entropy per fit."""
    import jax
    m1 = lc.Corex(n_hidden=4, max_iter=5, record_history=False)
    w_a = m1._init_ws(32)
    w_b = m1._init_ws(32)
    assert isinstance(w_a, jax.Array)
    assert w_a.shape == (4, 32)
    assert float(np.abs(np.asarray(w_a) - np.asarray(w_b)).max()) > 0
    # scale matches the seeded convention: std ≈ 1/sqrt(p)
    assert abs(float(np.asarray(w_a).std()) - 1 / np.sqrt(32)) < 0.05
    m1.fit(small_block_data)
    assert np.isfinite(m1.tc)


# ---------------------------------------------------------------------------
# init='spectral' (round-3 addition; measured at cfg5 in
# benchmarks/RESULTS.md — pair with anneal=False)
# ---------------------------------------------------------------------------

def test_spectral_init_recovers_blocks(med_block_data):
    """Overcomplete no-anneal fit with spectral init reaches the same
    optimum as random init and recovers the planted partition. (The
    regime where spectral MATTERS is scale — the cfg5 measurements in
    RESULTS.md: it rescues the no-anneal collapse on weak structure and
    edges out every config on strong structure; at small scale matched-m
    fits are a basin lottery under either init, so this test pins the
    regime where both agree.)"""
    m = lc.Corex(n_hidden=16, seed=0, init="spectral", anneal=False).fit(
        med_block_data)
    r = lc.Corex(n_hidden=16, seed=0, anneal=False).fit(med_block_data)
    assert np.isfinite(m.tc)
    assert abs(m.tc - r.tc) / r.tc < 1e-3     # same optimum
    clusters = np.asarray(m.clusters)
    # 8 planted blocks of 8 variables: perfect partition
    assert all(len(set(clusters[k * 8:(k + 1) * 8])) == 1
               for k in range(8))


def test_spectral_init_warns_with_anneal():
    # config validation/warnings fire at first use, not construction
    # (sklearn deferred-validation contract)
    with pytest.warns(UserWarning, match="anneal"):
        lc.Corex(n_hidden=4, init="spectral", anneal=True).config


def test_int8_stage_tol_scale_hazard_warns():
    """Pin the measured int8 x stage_tol_factor scale hazard
    (benchmarks/RESULTS.md stage-tol study, cfg5 rows): at p=100k with
    int8's tol=1e-4, factor>=3 collapses TC ~24%, so resolve_config
    warns when tol*factor*sqrt(p) >= 0.05 on the int8 annealed path —
    and stays silent at every measured-safe point."""
    from linearcorex_tpu.models.corex import resolve_config

    def cfg(**kw):
        base = dict(n_hidden=8, tol=1e-4, matmul_dtype="int8",
                    optimizer="momentum", anneal=True,
                    stage_tol_factor=10.0)
        base.update(kw)
        return lc.CorexConfig(**base)

    with pytest.warns(UserWarning, match="int8 moment noise"):
        resolve_config(cfg(), 100_000, n_samples=10_000)
    # composed 3e-4 at p=100k -> 0.095: the measured strong-structure
    # collapse point must warn too
    with pytest.warns(UserWarning, match="COLLAPSE"):
        resolve_config(cfg(stage_tol_factor=3.0), 100_000,
                       n_samples=10_000)
    import warnings as W
    with W.catch_warnings():
        W.simplefilter("error")
        # measured-safe: small scale (p=2048 -> 0.045), factor=1 at any
        # scale, f32 at the same composed tol, and anneal=False
        resolve_config(cfg(), 2048, n_samples=4096)
        resolve_config(cfg(stage_tol_factor=1.0), 100_000,
                       n_samples=10_000)
        resolve_config(cfg(matmul_dtype="float32", tol=1e-5,
                           stage_tol_factor=30.0), 100_000,
                       n_samples=10_000)
        resolve_config(cfg(anneal=False), 100_000, n_samples=10_000)
        # the checkpoint driver's unit: a pre-baked single-stage program
        # (eps_override set, tol already composed, factor kept). The
        # factor is inert on a length-1 schedule — recomputing
        # tol*factor here would square the factor and mis-warn on a
        # measured-safe fit (found in round-4 review)
        import dataclasses as _dc
        resolve_config(_dc.replace(cfg(), eps_override=0.6, tol=1e-3),
                       2048, n_samples=4096)


def test_spectral_init_f64_oracle_parity(med_block_data):
    """Seeded spectral init is step-matched with the oracle (same
    RandomState Ω, same one-power-iteration range finder): identical
    iteration counts, TC/W to 1e-5 (samples strategy pins the same
    Σ-application associativity on both sides)."""
    from linearcorex_tpu.oracle import OracleCorex
    kw = dict(n_hidden=8, seed=3, init="spectral", anneal=False,
              max_iter=2000)
    c = lc.Corex(dtype="float64", moment_strategy="samples", **kw).fit(
        med_block_data)
    o = OracleCorex(**kw).fit(med_block_data)
    assert np.asarray(c.diagnostics.iters_per_stage).tolist() == \
        o.history["iters_per_stage"]
    assert abs(c.tc - o.tc) < 1e-5 * max(1.0, abs(o.tc))
    assert np.abs(np.asarray(c.ws) - o.ws).max() < 1e-5


def test_spectral_init_unseeded_and_int8(small_block_data):
    a = lc.Corex(n_hidden=4, init="spectral", anneal=False).fit(
        small_block_data)
    b = lc.Corex(n_hidden=4, seed=0, init="spectral", anneal=False,
                 matmul_dtype="int8", tol=1e-3).fit(small_block_data)
    assert np.isfinite(a.tc) and np.isfinite(b.tc)


def test_spectral_init_params_roundtrip(tmp_path, small_block_data):
    from linearcorex_tpu.utils.checkpoint import load_corex, save_corex
    m = lc.Corex(n_hidden=4, seed=0, init="spectral", anneal=False).fit(
        small_block_data)
    assert m.get_params()["init"] == "spectral"
    m.set_params(init="random")
    assert m.config.init == "random"
    m.set_params(init="spectral")
    save_corex(m, str(tmp_path / "m"))
    assert load_corex(str(tmp_path / "m")).config.init == "spectral"


def test_empirical_transform_batch_relative_semantics():
    """Pin: gaussianize='empirical' re-ranks the
    TRANSFORM batch against itself (matching the oracle / presumed
    upstream `preprocess(x, fit=False)`). Sharp consequence: the
    transform is invariant to any strictly monotone per-column
    deformation of the batch — only ranks matter."""
    rng = np.random.RandomState(0)
    x = rng.lognormal(size=(300, 16))
    c = lc.Corex(n_hidden=4, seed=0, gaussianize="empirical",
                 max_iter=300).fit(x)
    batch = rng.lognormal(size=(64, 16))
    y1 = np.asarray(c.transform(batch))
    y2 = np.asarray(c.transform(np.exp(batch)))  # monotone deformation
    np.testing.assert_allclose(y1, y2, atol=1e-6)


def test_empirical_transform_single_row_raises():
    """A 1-row 'empirical' transform maps every value to ndtri(0.5)=0
    exactly — all-zero factors, silently. It must raise by name."""
    rng = np.random.RandomState(1)
    x = rng.normal(size=(200, 8))
    c = lc.Corex(n_hidden=2, seed=0, gaussianize="empirical",
                 max_iter=200).fit(x)
    with pytest.raises(ValueError, match="empirical"):
        c.transform(x[:1])
    with pytest.raises(ValueError, match="empirical"):
        c.transform(x[:1], details=True)


def test_empirical_transform_small_batch_warns():
    rng = np.random.RandomState(1)
    x = rng.normal(size=(200, 8))
    c = lc.Corex(n_hidden=2, seed=0, gaussianize="empirical",
                 max_iter=200).fit(x)
    with pytest.warns(UserWarning, match="batch-relative"):
        y = c.transform(x[:5])
    assert y.shape == (5, 2)
    # affine modes have no batch-size hazard: no warning, no raise
    c2 = lc.Corex(n_hidden=2, seed=0, max_iter=200).fit(x)
    import warnings as W
    with W.catch_warnings():
        W.simplefilter("error")
        assert c2.transform(x[:1]).shape == (1, 2)


# ---------------------------------------------------------------------------
# Presets: named hyperparameter bundles, resolved through
# the single config policy in Corex.config (config.apply_preset)


def test_throughput_preset_resolves_the_measured_recipe():
    cfg = lc.Corex(preset="throughput").config
    assert cfg.matmul_dtype == "int8"
    assert cfg.init == "spectral"
    assert cfg.anneal is False
    assert cfg.tol == 1e-4
    assert cfg.optimizer == "auto"
    # reference preset == bare constructor (the implicit preset)
    assert lc.Corex(preset="reference").config == lc.Corex().config


def test_preset_user_overrides_win():
    cfg = lc.Corex(preset="throughput", matmul_dtype="bfloat16",
                   tol=1e-3).config
    assert cfg.matmul_dtype == "bfloat16"
    assert cfg.tol == 1e-3
    assert cfg.init == "spectral"     # untouched knobs keep the preset


def test_preset_unknown_is_deferred_to_first_use():
    model = lc.Corex(preset="warp9")  # sklearn contract: ctor never raises
    with pytest.raises(ValueError, match="preset"):
        model.config
    with pytest.raises(ValueError, match="preset"):
        model.fit(np.zeros((20, 4)))


def test_preset_participates_in_sklearn_protocol():
    from sklearn.base import clone
    m = clone(lc.Corex(preset="throughput"))
    assert m.preset == "throughput"
    assert m.get_params()["preset"] == "throughput"
    m.set_params(preset="reference")
    assert m.config.matmul_dtype == "float32"


def test_throughput_preset_matches_maintained_e2e_row():
    """Lockstep pin: the preset must resolve, at the cfg5 shapes, to
    exactly the solver settings of the maintained benchmark row
    'momentum+int8, anneal=False, init=spectral'
    (benchmarks/run_benchmarks.py e2e harness; RESULTS.md init study) —
    if either side changes, re-measure and update both."""
    from linearcorex_tpu.models.corex import resolve_config
    cfg = lc.Corex(n_hidden=512, preset="throughput").config
    r = resolve_config(cfg, 100_000, n_samples=10_000)
    assert (r.matmul_dtype, r.init, r.anneal, r.tol) == (
        "int8", "spectral", False, 1e-4)
    assert r.optimizer == "momentum"   # 'auto' at n=10k < p=100k
    assert cfg.anneal_schedule() == (0.0,)


def test_throughput_preset_fit_runs_end_to_end():
    rng = np.random.RandomState(3)
    z = rng.normal(size=(400, 4))
    x = np.repeat(z, 8, axis=1) * 0.9 + 0.5 * rng.normal(size=(400, 32))
    m = lc.Corex(n_hidden=4, seed=0, preset="throughput").fit(x)
    assert m.tc > 5.0
    assert m.transform(x[:16]).shape == (16, 4)


def test_stage_tol_factor_semantics(med_block_data):
    """stage_tol_factor loosens ONLY the non-final anneal stages: at an
    extreme factor every eps>0 stage stops after its first accepted
    step, while the final eps=0 stage still converges at the full tol.
    Values < 1 are rejected (at config derivation, per the sklearn
    deferred-validation contract); anneal=False makes the knob inert."""
    import pytest

    from linearcorex_tpu.config import CorexConfig

    x = med_block_data
    w0 = np.random.RandomState(5).normal(scale=1 / 8, size=(8, 64))
    c = lc.Corex(n_hidden=8, dtype="float64",
                 stage_tol_factor=1e6).fit(x, init_ws=w0)
    iters = np.asarray(c.diagnostics.iters_per_stage)
    deltas = np.asarray(c.diagnostics.delta_per_stage)
    assert (iters[:-1] == 1).all(), iters
    assert deltas[-1] < 1e-5
    # deferred validation: constructing is fine, deriving config raises
    bad = lc.Corex(n_hidden=2, stage_tol_factor=0.5)
    with pytest.raises(ValueError, match="stage_tol_factor"):
        bad.config
    # schedule alignment + anneal=False inertness
    cfg = CorexConfig(n_hidden=8, tol=1e-5, stage_tol_factor=10.0)
    assert cfg.tol_schedule() == (1e-4,) * 6 + (1e-5,)
    assert len(cfg.tol_schedule()) == len(cfg.anneal_schedule())
    off = CorexConfig(n_hidden=8, tol=1e-5, anneal=False,
                      stage_tol_factor=10.0)
    assert off.tol_schedule() == (1e-5,)

"""sklearn ecosystem interop (Pipeline / cross-validation / clone).

The reference is a plain sklearn-style estimator (SURVEY.md §1:
`[U] linearcorex/linearcorex.py :: Corex` exposes fit/transform/
fit_transform and is used inside sklearn tooling downstream). This
estimator mirrors that contract: `y` is accepted-and-ignored on
fit/fit_transform/score (Pipelines and cross-validation pass it
positionally), `get_params`/`set_params` support `clone`, and the
sklearn >=1.6 `__sklearn_tags__`/`__sklearn_is_fitted__` hooks are
implemented lazily so sklearn remains an optional integration, not a
dependency.
"""

import numpy as np
import pytest

import linearcorex_tpu as lc

sklearn = pytest.importorskip("sklearn")

from sklearn.base import clone  # noqa: E402
from sklearn.exceptions import NotFittedError  # noqa: E402
from sklearn.model_selection import GridSearchCV, cross_val_score  # noqa: E402
from sklearn.pipeline import Pipeline  # noqa: E402
from sklearn.utils.validation import check_is_fitted  # noqa: E402


def _est(**kw):
    kw.setdefault("n_hidden", 4)
    kw.setdefault("max_iter", 40)
    kw.setdefault("seed", 0)
    kw.setdefault("verbose", False)
    return lc.Corex(**kw)


def test_fit_accepts_and_ignores_y(small_block_data):
    y = np.arange(small_block_data.shape[0])
    a = _est().fit(small_block_data, y)
    b = _est().fit(small_block_data)
    assert np.array_equal(np.asarray(a.ws), np.asarray(b.ws))
    # fit_transform and score take y positionally too
    z = _est().fit_transform(small_block_data, y)
    assert z.shape == (small_block_data.shape[0], 4)
    assert np.isfinite(a.score(small_block_data, y))


def test_pipeline_fit_transform(small_block_data):
    pipe = Pipeline([("corex", _est())])
    z = pipe.fit_transform(small_block_data, None)
    assert z.shape == (small_block_data.shape[0], 4)
    direct = _est().fit_transform(small_block_data)
    assert np.allclose(np.asarray(z), np.asarray(direct))


def test_clone_is_unfitted_param_copy(small_block_data):
    c = _est(tol=1e-4, gaussianize="standard").fit(small_block_data)
    c2 = clone(c)
    assert c2.get_params() == c.get_params()
    assert not c2.__sklearn_is_fitted__()
    c2.fit(small_block_data)
    assert np.array_equal(np.asarray(c2.ws), np.asarray(c.ws))


def test_check_is_fitted_protocol(small_block_data):
    c = _est()
    with pytest.raises(NotFittedError):
        check_is_fitted(c)
    with pytest.raises(AttributeError, match="not fitted"):
        c.n_features_in_
    c.fit(small_block_data)
    check_is_fitted(c)  # no raise
    assert c.n_features_in_ == small_block_data.shape[1]


def test_cross_val_score_uses_woodbury_score(small_block_data):
    scores = cross_val_score(_est(), np.asarray(small_block_data), cv=3)
    assert scores.shape == (3,)
    assert np.all(np.isfinite(scores))


def test_grid_search_recovers_structure():
    # 3 planted factors: GridSearchCV's held-out Gaussian likelihood
    # should prefer n_hidden=3 over a clearly-too-small model.
    rng = np.random.default_rng(0)
    z = rng.normal(size=(240, 3))
    w = rng.normal(size=(3, 18))
    x = z @ w + 0.1 * rng.normal(size=(240, 18))
    gs = GridSearchCV(_est(n_hidden=1), {"n_hidden": [1, 3]}, cv=2)
    gs.fit(x)
    assert gs.best_params_["n_hidden"] == 3


# Checks that CANNOT pass by design: sklearn's battery assumes
# predict(X) consumes feature-space input, but the reference API
# (`[U] :: Corex.predict`, SURVEY.md §1) defines predict(Y) as the
# factor→variable reconstruction (sklearn's inverse_transform, which we
# also expose under that name). Every entry below fails only because the
# battery feeds predict feature-space X.
_PREDICT_SEMANTICS = (
    "predict takes the (n, m) FACTOR matrix (reference API parity; "
    "sklearn's battery calls predict with feature-space X)")
_EXPECTED_FAILURES = {
    "check_estimators_dtypes": _PREDICT_SEMANTICS,
    "check_dtype_object": _PREDICT_SEMANTICS,
    "check_estimators_nan_inf": _PREDICT_SEMANTICS,
    # both pickle variants (plain and readonly_memmap=True) report this
    # same check_name in the results listing
    "check_estimators_pickle": _PREDICT_SEMANTICS,
    "check_f_contiguous_array_estimator": _PREDICT_SEMANTICS,
    "check_methods_sample_order_invariance": _PREDICT_SEMANTICS,
    "check_methods_subset_invariance": _PREDICT_SEMANTICS,
    "check_dict_unchanged": _PREDICT_SEMANTICS,
    "check_n_features_in_after_fitting": _PREDICT_SEMANTICS,
}


def test_check_estimator_battery():
    """Run sklearn's full estimator-contract battery. Everything must
    pass except the documented predict-semantics set (as of sklearn 1.9:
    35 passed / 10 expected-failed / 1 env-gated array-API skip — the
    pinned contract is the failure SET, not the counts)."""
    from sklearn.utils.estimator_checks import check_estimator
    results = check_estimator(
        lc.Corex(n_hidden=2, max_iter=30, seed=0, verbose=False),
        on_fail=None)
    unexpected, surprises = [], []
    for r in results:
        name = r["check_name"]
        if r["status"] == "failed" and name not in _EXPECTED_FAILURES:
            unexpected.append((name, str(r.get("exception"))[:200]))
        if r["status"] == "passed" and name in _EXPECTED_FAILURES:
            surprises.append(name)  # expected-failure list gone stale
    assert not unexpected, unexpected
    assert not surprises, (
        f"checks now pass — prune them from _EXPECTED_FAILURES: "
        f"{surprises}")


def test_fitted_estimator_pickles(small_block_data):
    """Fitted state (jax.Arrays included) must survive pickle — joblib
    parallel cross-validation and model persistence depend on it. (The
    battery's check_estimators_pickle failure is predict-SEMANTICS only;
    pickling itself is contract.)"""
    import pickle
    m = _est().fit(small_block_data)
    m2 = pickle.loads(pickle.dumps(m))
    assert m2.__sklearn_is_fitted__()
    assert np.allclose(np.asarray(m2.transform(small_block_data)),
                       np.asarray(m.transform(small_block_data)))
    assert m2.get_params() == m.get_params()


def test_sklearn_tags():
    t = _est().__sklearn_tags__()
    assert t.estimator_type == "transformer"
    assert t.target_tags.required is False
    assert t.input_tags.two_d_array is True
    assert t.input_tags.allow_nan is False
    assert t.non_deterministic is False
    t_nan = _est(missing_values=float("nan")).__sklearn_tags__()
    assert t_nan.input_tags.allow_nan is True
    t_unseeded = _est(seed=None).__sklearn_tags__()
    assert t_unseeded.non_deterministic is True


def test_feature_names_and_pandas_output(small_block_data):
    """get_feature_names_out + set_output(transform='pandas'): DataFrame
    factors with corex{i} columns, input index preserved; 'default'
    restores arrays; works through Pipeline.set_output."""
    pd = pytest.importorskip("pandas")
    x = np.asarray(small_block_data)
    xdf = pd.DataFrame(x, index=np.arange(len(x)) + 1000)
    pipe = Pipeline([("corex", _est())]).set_output(transform="pandas")
    z = pipe.fit_transform(xdf)
    assert isinstance(z, pd.DataFrame)
    assert list(z.columns) == [f"corex{i}" for i in range(4)]
    assert z.index[0] == 1000
    est = pipe.named_steps["corex"]
    # input_features length-checked against the fitted width
    with pytest.raises(ValueError, match="length"):
        est.get_feature_names_out(["one"])
    with pytest.raises(NotFittedError):
        _est().get_feature_names_out()
    pipe.set_output(transform="default")
    assert not isinstance(pipe.transform(xdf), pd.DataFrame)
    with pytest.raises(ValueError, match="set_output"):
        _est().set_output(transform="polars")


def test_pandas_output_leaves_details_path_raw(small_block_data):
    """transform(details=True) is documented to stay raw arrays even
    under set_output(transform='pandas')."""
    pd = pytest.importorskip("pandas")
    est = _est().set_output(transform="pandas").fit(small_block_data)
    y, mom = est.transform(small_block_data, details=True)
    assert not isinstance(y, pd.DataFrame)
    assert isinstance(mom, dict)
    # the plain path wraps, and plain ndarray input yields a range index
    z = est.transform(small_block_data)
    assert isinstance(z, pd.DataFrame) and z.index[0] == 0

"""Using the Corex estimator inside the sklearn ecosystem.

The estimator implements the full sklearn protocol (get/set_params,
clone, tags, check_is_fitted, an ignored `y` on fit/score — see
docs/API.md "sklearn-contract notes"), so it drops into Pipelines,
cross-validation, and grid search unchanged. `score(X)` is the held-out
mean Gaussian log-likelihood under the fitted factor model (Woodbury —
the p x p covariance never materializes), which is what makes
GridSearchCV model selection meaningful for an unsupervised estimator.

Run: python examples/sklearn_pipeline.py   (CPU-friendly; requires sklearn)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

    import linearcorex_tpu as lc
    from sklearn.model_selection import GridSearchCV, cross_val_score
    from sklearn.pipeline import Pipeline

    # 3 planted factors, 18 observed variables
    rng = np.random.default_rng(0)
    z = rng.normal(size=(400, 3))
    w = rng.normal(size=(3, 18))
    x = z @ w + 0.1 * rng.normal(size=(400, 18))

    # --- Pipeline: fit_transform / inverse_transform round trip --------
    pipe = Pipeline([("corex", lc.Corex(n_hidden=3, seed=0, max_iter=200))])
    factors = pipe.fit_transform(x)
    recon = pipe.inverse_transform(factors)
    rel = np.linalg.norm(recon - x) / np.linalg.norm(x)
    print(f"pipeline factors {factors.shape}, reconstruction rel-err {rel:.3f}")

    # --- pandas output: named factor columns ---------------------------
    try:
        import pandas as pd
    except ImportError:
        pd = None
    if pd is not None:
        xdf = pd.DataFrame(x, columns=[f"v{i}" for i in range(18)])
        named = Pipeline([("corex", lc.Corex(n_hidden=3, seed=0,
                                             max_iter=200))])
        named.set_output(transform="pandas")
        zdf = named.fit_transform(xdf)
        print("pandas factors:", type(zdf).__name__, list(zdf.columns))

    # --- Cross-validated likelihood ------------------------------------
    scores = cross_val_score(
        lc.Corex(n_hidden=3, seed=0, max_iter=200), x, cv=3)
    print("3-fold held-out log-likelihood:", np.round(scores, 3))

    # --- Grid search over n_hidden: recovers the planted factor count --
    gs = GridSearchCV(lc.Corex(seed=0, max_iter=200),
                      {"n_hidden": [1, 2, 3, 5]}, cv=2)
    gs.fit(x)
    print("grid search best n_hidden:", gs.best_params_["n_hidden"],
          "(planted: 3)")


if __name__ == "__main__":
    main()

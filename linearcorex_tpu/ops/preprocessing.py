"""Preprocessing for Linear CorEx, as pure JAX ops (SURVEY.md §2.2).

Parity anchors: `[U] linearcorex/linearcorex.py :: Corex.preprocess /
invert / mean_impute`. Four gaussianize modes ('none' | 'standard' |
'outliers' | 'empirical') plus sentinel-value mean imputation.

Device notes:
- 'empirical' needs average-tie ranks; implemented with two
  `jnp.searchsorted` calls per column over the sorted values (O(n log n),
  shape-static, vmappable) and `jax.scipy.special.ndtri` for norm.ppf.
- Everything is jitted once per (shape, mode); theta (mean, std) is returned
  as a pytree so fit-time statistics can be reapplied at transform time
  exactly as the reference stores `self.theta`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.special import ndtri


class Theta(NamedTuple):
    """Fitted preprocessing statistics (the reference's `self.theta`)."""

    mean: jax.Array  # p
    std: jax.Array   # p


def mean_impute(x: jax.Array, missing_values: float):
    """Replace sentinel entries by the per-column mean of observed entries
    (`[U] :: mean_impute`). Columns with no observed entries impute to 0.
    A NaN sentinel is matched with isnan (NaN != NaN)."""
    import math
    if isinstance(missing_values, float) and math.isnan(missing_values):
        mask = jnp.isnan(x)
    else:
        mask = x == missing_values
    cnt = jnp.sum(~mask, axis=0)
    total = jnp.sum(jnp.where(mask, 0.0, x), axis=0)
    col_mean = jnp.where(cnt > 0, total / jnp.maximum(cnt, 1), 0.0)
    return jnp.where(mask, col_mean[jnp.newaxis, :], x)


def fit_theta(x: jax.Array) -> Theta:
    mean = jnp.mean(x, axis=0)
    std = jnp.std(x, axis=0)
    std = jnp.where(std < 1e-10, 1.0, std)
    return Theta(mean=mean, std=std)


def soft_clip(z: jax.Array, t: float = 4.0) -> jax.Array:
    """Bounded transform of |z|>t ('outliers' mode): heavy tails stop
    dominating second moments but ordering is preserved."""
    return jnp.where(jnp.abs(z) < t, z,
                     jnp.sign(z) * (t + jnp.tanh(jnp.abs(z) - t)))


def rankdata_average(col: jax.Array) -> jax.Array:
    """Average-tie ranks of a 1-D array (scipy.stats.rankdata parity).

    rank_i = (#less + #less_or_equal + 1)/2, computed with two binary
    searches against the sorted column — shape-static and
    accelerator-friendly (SURVEY.md §7.3 item 5)."""
    s = jnp.sort(col)
    lo = jnp.searchsorted(s, col, side="left")
    hi = jnp.searchsorted(s, col, side="right")
    return 0.5 * (lo + hi + 1)


def empirical_gaussianize(x: jax.Array) -> jax.Array:
    """Rank-based gaussianization: norm.ppf((rank − 0.5)/n) per column
    (`[U] :: preprocess`, 'empirical' mode; SURVEY.md §2.2 [HIGH])."""
    n = x.shape[0]
    ranks = jax.vmap(rankdata_average, in_axes=1, out_axes=1)(x)
    return ndtri((ranks - 0.5) / n).astype(x.dtype)


def preprocess(x: jax.Array, gaussianize: str, theta: Theta,
               missing_values: Optional[float] = None) -> jax.Array:
    """Apply the fitted preprocessing (transform-time path)."""
    if missing_values is not None:
        x = mean_impute(x, missing_values)
    if gaussianize == "none":
        return x
    z = (x - theta.mean[jnp.newaxis, :]) / theta.std[jnp.newaxis, :]
    if gaussianize == "standard":
        return z
    if gaussianize == "outliers":
        return soft_clip(z)
    return empirical_gaussianize(x)


def fit_preprocess(x: jax.Array, gaussianize: str,
                   missing_values: Optional[float] = None):
    """Fit theta on x and return (x_preprocessed, theta) — the reference's
    `preprocess(x, fit=True)`."""
    if missing_values is not None:
        x = mean_impute(x, missing_values)
    if gaussianize == "none":
        p = x.shape[1]
        theta = Theta(mean=jnp.zeros(p, x.dtype), std=jnp.ones(p, x.dtype))
        return x, theta
    theta = fit_theta(x)
    z = (x - theta.mean[jnp.newaxis, :]) / theta.std[jnp.newaxis, :]
    if gaussianize == "standard":
        return z, theta
    if gaussianize == "outliers":
        return soft_clip(z), theta
    return empirical_gaussianize(x), theta


def invert(z: jax.Array, theta: Theta) -> jax.Array:
    """Undo the affine part (`[U] :: Corex.invert`; used by predict)."""
    return z * theta.std[jnp.newaxis, :] + theta.mean[jnp.newaxis, :]

"""Streaming moment accumulation: fit Linear CorEx from batched data.

The reference requires the full n x p sample matrix in memory
(SURVEY.md §1: single-process NumPy). The Gram fast path of this library
makes an out-of-core / streaming workflow natural: the solver only needs
the p x p correlation matrix, which is a plain average over samples — so
batches can be accumulated on device one at a time (raw second moments +
per-column sums via a single GEMM per batch), and the fit runs from the
accumulated moments without ever holding X.

    acc = GramAccumulator(p)
    for batch in stream:              # each batch: (b, p)
        acc.update(batch)
    model = acc.fit(n_hidden=8, seed=0)

Exactly equivalent (to fp precision) to `Corex(...).fit(concat(batches))`
with gaussianize='standard' — the accumulated mean/variance standardize the
Gram analytically: corr = D⁻¹ (G_raw/n − μμᵀ) D⁻¹.

With `mesh=` (and a `shard_vars` ShardingPlan) the accumulated p x p Gram
lives ROW-SHARDED over the mesh's variable axis from the first batch, and
the solve runs through `parallel.fit_sharded` (gram strategy) — so the
out-of-core story and the p-beyond-one-chip story COMPOSE: no p x p (or
n x p) buffer ever materializes on one device. Mirrors the round-4
mesh-aware prepare (`Corex.fit(mesh=...)`) for the streaming drivers.
"""

from __future__ import annotations

import functools as _functools

import jax
import jax.numpy as jnp
import numpy as np

from linearcorex_tpu.models.corex import Corex, _fit_program, resolve_config
from linearcorex_tpu.ops import moments as M
from linearcorex_tpu.ops import preprocessing as P

__all__ = ["GramAccumulator", "fit_from_covariance", "iter_text_blocks",
           "fit_csv"]


def iter_text_blocks(path: str, block_rows: int = 8192,
                     delimiter: str = ",", skip_header: int = 0):
    """Yield (block_rows, p) float64 blocks from a delimited numeric text
    file. Uses the native C++ single-pass reader (native/loader.cpp;
    measured up to ~4.5x numpy.loadtxt, O(block) memory) when the library
    is built; otherwise a pure-Python fallback with identical output."""
    from linearcorex_tpu.utils import native

    if native.available():
        yield from native.CsvReader(path, block_rows=block_rows,
                                    delimiter=delimiter,
                                    skip_header=skip_header)
        return
    rows = []
    cols = None
    with open(path) as f:
        for i, line in enumerate(f):
            if i < skip_header:
                continue
            line = line.strip()
            if not line:
                continue
            # strict field semantics matching the native reader: blank
            # delimiters split on runs of whitespace; other delimiters
            # require non-empty fields (an empty field is silent data
            # misalignment, not a value)
            if delimiter in (" ", "\t"):
                parts = line.split()
            else:
                parts = [v.strip() for v in line.split(delimiter)]
                if any(not v for v in parts):
                    raise ValueError(
                        f"{path}:{i + 1}: empty field in row {line[:60]!r}")
            row = np.array([float(v) for v in parts])
            if cols is None:
                cols = row.size
            elif row.size != cols:
                raise ValueError(
                    f"{path}:{i + 1}: expected {cols} fields, got "
                    f"{row.size}")
            rows.append(row)
            if len(rows) == block_rows:
                yield np.stack(rows)
                rows = []
    if rows:
        yield np.stack(rows)


def fit_csv(path: str, n_hidden: int, block_rows: int = 8192,
            delimiter: str = ",", skip_header: int = 0,
            mesh=None, sharding_plan=None, **corex_kwargs) -> "Corex":
    """Out-of-core fit straight from a delimited numeric text file: stream
    blocks through a GramAccumulator (native reader when available), then
    fit from the accumulated moments — the file is never held in memory.
    `mesh=`/`sharding_plan=` accumulate AND solve var-sharded over the
    mesh (see GramAccumulator), so neither the file NOR the p x p Gram
    ever lives on one device.

    Equivalent (to fp precision) to Corex(...).fit(np.loadtxt(path, ...))
    with gaussianize='standard'."""
    dtype = corex_kwargs.get("dtype", "float32")
    acc = None
    for block in iter_text_blocks(path, block_rows, delimiter, skip_header):
        if acc is None:
            acc = GramAccumulator(block.shape[1], dtype=dtype, mesh=mesh,
                                  sharding_plan=sharding_plan)
        acc.update(block)
    if acc is None:
        raise ValueError(f"{path}: no data rows")
    return acc.fit(n_hidden, **corex_kwargs)


def fit_from_covariance(sigma, n_samples: int, n_hidden: int,
                        variable_means=None, mesh=None, sharding_plan=None,
                        **corex_kwargs) -> Corex:
    """Fit Linear CorEx directly from a p x p covariance (or correlation)
    matrix — no sample matrix needed.

    Common when only the second-moment matrix is available (e.g. shared
    summary statistics). `n_samples` is the sample count behind sigma; the
    moments are exact inputs so it does not enter the moment math, but it
    IS recorded on the model and feeds the optimizer='auto' regime policy
    (fixed_point iff n_samples >= p) — pass the real count.
    `variable_means` (default zeros) populates the model's theta so
    `transform`/`predict` standardize new data with sigma's scale.

    `mesh=`/`sharding_plan=` (shard_vars plans) device_put sigma
    ROW-SHARDED over the mesh's variable axis — H2D goes per shard, the
    normalization runs under the mesh, and the solve goes through
    `parallel.fit_sharded` — so the full p x p never lands on one device
    (the var-sharded analog of `Corex.fit(mesh=...)`'s prepare).
    """
    _reject_missing_values(corex_kwargs, "fit_from_covariance")
    if not isinstance(sigma, (np.ndarray, jax.Array)):
        sigma = np.asarray(sigma)   # lists etc. — keep host-side: the
        #                             mesh path below device_puts per shard
    p = sigma.shape[0]
    if sigma.shape != (p, p):
        raise ValueError(f"sigma must be square, got {sigma.shape}")
    plan = None
    if mesh is not None:
        from jax.sharding import NamedSharding

        plan = _resolve_stream_plan(mesh, sharding_plan, p,
                                    where="fit_from_covariance")
        sigma = jax.device_put(sigma, NamedSharding(mesh, plan.v_spec(2)))
    else:
        if sharding_plan is not None:
            raise ValueError(
                "fit_from_covariance received sharding_plan= without "
                "mesh=; pass both, or neither")
        sigma = jnp.asarray(sigma)
    corr, std = _normalize_sigma(sigma)
    model = Corex(n_hidden=n_hidden, gaussianize="standard", **corex_kwargs)
    mean = (jnp.zeros(p) if variable_means is None
            else jnp.asarray(variable_means))
    return _solve_from_moments(model, corr, mean, std, int(n_samples),
                               mesh=mesh, plan=plan)


@jax.jit
def _normalize_sigma(sigma):
    """(correlation, std) from a covariance matrix. Sharding-transparent:
    a row-sharded sigma yields a row-sharded correlation (the outer-
    product column term gathers only the small (p,) std vector)."""
    var = jnp.diagonal(sigma)
    std = jnp.sqrt(jnp.maximum(var, 1e-20))
    std = jnp.where(std < 1e-10, 1.0, std)
    return sigma / jnp.outer(std, std), std


def _resolve_stream_plan(mesh, sharding_plan, p, where: str):
    """The ShardingPlan a streaming/moment-input driver runs under: the
    operand is the p x p correlation (gram strategy), so the plan MUST
    shard the variable axis — a sample-only plan would map it to
    P(None, None) and silently run fully replicated (the same hazard
    `models.corex.pick_fit_strategy` warns about on the estimator path;
    here the operand is gram BY CONSTRUCTION, so it is an error, not a
    warning). Also fails fast on GSPMD's divisibility rule for p."""
    import dataclasses

    from linearcorex_tpu.parallel.sharding import (ShardingPlan,
                                                   validate_plan_shapes)

    plan = sharding_plan if sharding_plan is not None else ShardingPlan(
        shard_samples=False, shard_vars=True)
    if not plan.shard_vars:
        raise ValueError(
            f"{where}(mesh=...) operates on the accumulated p x p "
            f"correlation (gram strategy), which carries no sample axis — "
            f"the ShardingPlan must set shard_vars=True to shard its rows "
            f"(got {plan}); shard_samples/shard_slices do not apply here")
    if plan.shard_slices:
        raise ValueError(
            f"{where}(mesh=...): shard_slices splits the SAMPLE axis; a "
            f"Gram operand carries none — use a shard_vars plan")
    # the factor-axis check needs n_hidden, which the accumulator does not
    # know yet — fit_sharded re-validates the full plan at solve time
    validate_plan_shapes(dataclasses.replace(plan, shard_factors=False),
                         "gram", mesh, None, p, 1)
    return plan


def _solve_from_moments(model, corr, mean, std, n_samples, init_ws=None,
                        mesh=None, plan=None):
    """Shared solve for every moment-input fit (`fit_from_covariance`,
    `GramAccumulator.fit`, `Corex.partial_fit`): record the affine theta,
    resolve the 'auto' knobs against the TRUE sample count (the Gram
    operand carries none — CLAUDE.md invariant), cast the correlation
    operand per matmul_dtype, and run the gram-strategy fit program
    in place on `model`. `init_ws` warm-starts (partial_fit); otherwise
    the init follows the model's own policy via `_resolve_w0` —
    pretrained weights and init='spectral' included (previously these
    moment-input drivers silently fell back to the random init).

    With `mesh`/`plan` (a validated shard_vars plan; `corr`/`mean`/`std`
    already laid out per the plan, or host arrays to be placed), the
    solve runs through `parallel.fit_sharded` (gram strategy) and the
    model's serving plan is set, mirroring `Corex.fit(mesh=...)`."""
    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache
    ensure_compile_cache()  # every fit-shaped entry point wires the
    #                         persistent cache (compile_cache.py policy);
    #                         partial_fit/fit_csv/fit_from_covariance may
    #                         be a process's FIRST library call
    p = corr.shape[0]
    model.n_samples, model.nv = int(n_samples), p
    model.theta = P.Theta(mean=jnp.asarray(mean).astype(model._dt),
                          std=jnp.asarray(std).astype(model._dt))
    cfg = resolve_config(model.config, p, n_samples=model.n_samples)
    model.resolved_optimizer_ = cfg.optimizer
    data = corr.astype(model._dt)
    if cfg.matmul_dtype == "bfloat16":
        data = data.astype(jnp.bfloat16)
    elif cfg.matmul_dtype == "int8":
        # check_overflow at the DRIVER boundary: eager guard on the (maybe
        # sharded) operand, same as every other int8 entry point
        data = M.quantize_gram(data)
    w0 = model._resolve_w0(init_ws, data=data, strategy="gram")
    if mesh is not None:
        from linearcorex_tpu.parallel.sharding import fit_sharded

        model.ws, model.moments, model.diagnostics = fit_sharded(
            data, w0, cfg, mesh, plan, strategy="gram",
            n_samples=model.n_samples, check_overflow=False)
        model._serving_plan = plan  # serving calls default to this layout
    else:
        model.ws, model.moments, model.diagnostics = _fit_program(
            data, w0, cfg, "gram")
        model._serving_plan = None  # single-device state
    # single-lane drivers mirror the plain fit's fitted attributes
    # (n_restarts > 1 is rejected upstream): lane 0 ≡ the plain fit
    model.best_restart_ = 0
    return model


def _reject_missing_values(corex_kwargs, where):
    """Moment-input fits never see the raw samples, so the estimator's
    mean-imputation path cannot run — accepting the kwarg would silently
    skip imputation (the wrong model, no error)."""
    if corex_kwargs.get("missing_values") is not None:
        raise ValueError(
            f"{where} fits from accumulated second moments and cannot "
            f"mean-impute missing_values (imputation needs the samples); "
            f"impute each batch before accumulation, or use Corex.fit on "
            f"the full sample matrix")


def _update_moments(g, s, x, x0):
    """One pass over a batch, folded into the running moments: shift by
    the accumulation pivot x0, one GEMM (XᵀX) + column sums, accumulate.
    ONE program per batch shape (vs the former eager-sub / jit-stats /
    eager-add chain: fewer dispatches and compiles — and `donate_argnums`
    below updates the p x p accumulator IN PLACE instead of allocating a
    second one).
    Highest matmul precision — the accumulated moments feed every solver
    iteration (see ops.moments.compute_gram)."""
    xs = x - x0[jnp.newaxis, :]
    with jax.default_matmul_precision("highest"):
        gb = M._mm(xs.T, xs)
    return g + gb, s + jnp.sum(xs, axis=0)


_update_single = jax.jit(_update_moments, donate_argnums=(0, 1))


def _finalize_corr(g_raw, col_sum, n):
    """Standardized correlation matrix from raw accumulated moments."""
    mean = col_sum / n
    cov = g_raw / n - jnp.outer(mean, mean)
    var = jnp.maximum(jnp.diagonal(cov), 1e-20)
    std = jnp.sqrt(var)
    std = jnp.where(std < 1e-10, 1.0, std)
    corr = cov / jnp.outer(std, std)
    return corr, mean, std


_finalize_single = jax.jit(_finalize_corr)


@_functools.lru_cache(maxsize=None)
def _sharded_programs(gsh, vsh):
    """(alloc_g, alloc_s, update, finalize) jit wrappers for one sharded
    accumulator LAYOUT — cached module-level so a second accumulator on
    the same mesh/plan/shape reuses the traced programs instead of
    re-creating fresh jit objects per instance (each would compile
    anew). NamedShardings are hashable; the cache holds mesh references for
    the process lifetime, which is
    the lifetime meshes have in practice."""
    return (
        jax.jit(lambda p, dt: jnp.zeros((p, p), dt), out_shardings=gsh,
                static_argnums=(0, 1)),
        jax.jit(lambda p, dt: jnp.zeros((p,), dt), out_shardings=vsh,
                static_argnums=(0, 1)),
        jax.jit(_update_moments, donate_argnums=(0, 1),
                out_shardings=(gsh, vsh)),
        jax.jit(_finalize_corr, out_shardings=(gsh, vsh, vsh)),
    )


class GramAccumulator:
    """Accumulate second moments over data batches; fit without holding X.

    Only gaussianize='standard' semantics are possible in one streaming
    pass (rank-based 'empirical' needs all data); that is also the solver's
    default mode.

    `mesh=` (optionally with a `shard_vars` ShardingPlan — the default
    plan if omitted) keeps the p x p accumulator ROW-SHARDED over the
    mesh's variable axis for its whole life: batches are device_put with
    their COLUMNS sharded (H2D goes per shard), the update GEMM computes
    each device's Gram row-block locally (GSPMD all-gathers only the
    transient (b, p) batch — bound it with block_rows), and `fit` solves
    through `parallel.fit_sharded`. This is how streaming fits reach the
    p-beyond-one-chip regime (docs/SCALING.md): without a mesh the p x p
    Gram caps p at one device's memory no matter how the batches stream.
    """

    def __init__(self, p: int, dtype: str = "float32", mesh=None,
                 sharding_plan=None):
        self.p = p
        self.dtype = jnp.dtype(dtype)
        self.mesh = mesh
        self.plan = None
        if mesh is None:
            if sharding_plan is not None:
                raise ValueError(
                    "GramAccumulator received sharding_plan= without "
                    "mesh=; a plan without a mesh cannot take effect — "
                    "pass both, or neither")
            self._g = jnp.zeros((p, p), self.dtype)
            self._s = jnp.zeros((p,), self.dtype)
            self._update_fn = _update_single
            self._finalize_fn = _finalize_single
            self._xsh = None
        else:
            from jax.sharding import NamedSharding

            self.plan = _resolve_stream_plan(mesh, sharding_plan, p,
                                             where="GramAccumulator")
            gsh = NamedSharding(mesh, self.plan.v_spec(2))   # (p, p) rows
            vsh = NamedSharding(mesh, self.plan.v_spec(1))   # (p,)
            # batch columns follow the Gram rows; rows stay unsharded (a
            # streaming batch is transient — sharding its columns is what
            # keeps the H2D transfer and the update GEMM per-shard)
            self._xsh = NamedSharding(mesh, jax.sharding.PartitionSpec(
                None, self.plan.v_spec(1)[0]))
            alloc_g, alloc_s, self._update_fn, self._finalize_fn = \
                _sharded_programs(gsh, vsh)
            # allocate the accumulators ALREADY sharded (a jnp.zeros +
            # device_put would materialize the full p x p on one device
            # first — the exact thing this path exists to avoid)
            self._g = alloc_g(p, self.dtype)
            self._s = alloc_s(p, self.dtype)
        self._x0 = None   # shift point (first batch's column means)
        self._n = 0

    def update(self, x) -> "GramAccumulator":
        # NaN screening on host arrays is free and a NaN batch poisons the
        # whole accumulated Gram irreversibly (TC=nan after fit); on-device
        # batches skip the check rather than force a sync per batch,
        # mirroring Corex._validate_input.
        if isinstance(x, np.ndarray) and not np.isfinite(x).all():
            raise ValueError(
                "batch contains NaN/inf; clean it before accumulation "
                "(the accumulated Gram cannot be repaired afterwards)")
        if not isinstance(x, (np.ndarray, jax.Array)):
            x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != self.p:
            raise ValueError(
                f"expected batch of shape (b, {self.p}), got {x.shape}")
        if x.shape[0] == 0:
            # an empty FIRST batch would set the shift point _x0 to
            # mean-of-nothing = NaN and silently poison every later
            # batch; reject empties uniformly
            raise ValueError("batch has 0 rows")
        if self._xsh is not None:
            # shard the batch columns per the plan with the HOST buffer
            # kept host-side: a jnp.asarray first would commit the whole
            # batch to one device before the reshard (defeating the
            # per-shard H2D this path exists for) — cast on host, then
            # device_put goes per shard (and reshards an
            # already-committed device array too)
            if isinstance(x, np.ndarray):
                x = np.asarray(x, self.dtype)
            x = jax.device_put(x, self._xsh)
            if x.dtype != self.dtype:
                x = x.astype(self.dtype)   # sharded cast, no gather
        else:
            x = jnp.asarray(x, self.dtype)
        if self._x0 is None:
            # Accumulate around the first batch's mean (shifted-data trick):
            # cov = G'/n − μ'μ'ᵀ with μ' = μ − x0 small, so the subtraction
            # does not cancel catastrophically in float32 (observed ~1% TC
            # drift without the shift when means dominate variances).
            # Under a mesh the row-reduction of the column-sharded batch
            # yields the var-sharded (p,) pivot directly.
            self._x0 = jnp.mean(x, axis=0)
        self._g, self._s = self._update_fn(self._g, self._s, x, self._x0)
        self._n += x.shape[0]
        return self

    @property
    def n_samples(self) -> int:
        return self._n

    def _moments(self):
        """(corr, mean, std) of everything accumulated so far."""
        if self._n < 2:
            raise ValueError("need at least 2 accumulated samples")
        corr, mean_shift, std = self._finalize_fn(self._g, self._s,
                                                  float(self._n))
        return corr, self._x0 + mean_shift, std

    def correlation(self):
        """The standardized p x p correlation matrix accumulated so far."""
        return self._moments()[0]

    def fit(self, n_hidden: int, **corex_kwargs) -> Corex:
        """Fit a Corex model from the accumulated moments (gram strategy).
        Accumulators built with `mesh=` solve through
        `parallel.fit_sharded` under the same layout, and the fitted
        estimator serves under it too (`_serving_plan`).

        Returns a fitted estimator whose transform/predict/get_covariance
        behave exactly as if fit on the concatenated data with
        gaussianize='standard'."""
        corr, mean, std = self._moments()
        _reject_missing_values(corex_kwargs, "GramAccumulator.fit")
        corex_kwargs.setdefault("dtype", str(self.dtype))
        model = Corex(n_hidden=n_hidden, gaussianize="standard",
                      **corex_kwargs)
        return _solve_from_moments(model, corr, mean, std, self._n,
                                   mesh=self.mesh, plan=self.plan)

"""The `Corex` estimator — sklearn-style surface over the pure JAX solver.

This is layer L5 of the reference (`[U] linearcorex/linearcorex.py :: class
Corex`, SURVEY.md §1): a thin stateful wrapper holding hyperparameters and
learned state (ws, moments, theta) over pure jitted functions. The public
surface matches the reference contract (BASELINE.json north star):
`fit / transform / fit_transform / predict / get_covariance` and properties
`tc / tcs / mis / clusters / history`.

Differences by design:
- The whole annealed fit is ONE compiled XLA program with a single host sync
  (SURVEY.md §7.3 item 0); `verbose` reporting comes from the returned
  diagnostics arrays, not per-iteration prints.
- Results stay on device; properties return JAX arrays (convert with
  `np.asarray` when wanted).
- `gpu=` is accepted for API compatibility and ignored: there is exactly one
  backend (XLA), no flag-switched duplicate math (SURVEY.md §2.1).
"""

from __future__ import annotations

import contextlib
import sys
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from linearcorex_tpu.config import (CorexConfig, PreprocessConfig,
                                    apply_preset)
from linearcorex_tpu.core.solver import FitDiagnostics, fit_core, sort_by_tcs
from linearcorex_tpu.ops import moments as M
from linearcorex_tpu.ops import preprocessing as P

__all__ = ["Corex", "NotFittedError"]


class NotFittedError(ValueError, AttributeError):
    """Inference was requested before `fit`. Mirrors
    `sklearn.exceptions.NotFittedError` (same ValueError+AttributeError
    bases). When sklearn is ALREADY imported in the process, the raised
    exception is a subclass of BOTH this class and sklearn's, so either
    `except lc.NotFittedError` or `except sklearn...NotFittedError`
    catches it — but sklearn is never imported for this (a cold
    `import sklearn.exceptions` measures ~6 s; sklearn stays an
    optional integration, not a dependency)."""


_dual_not_fitted_cls = None


def _raise_not_fitted(msg):
    global _dual_not_fitted_cls
    cls = NotFittedError
    if "sklearn" in sys.modules:  # free — the user already paid the import
        if _dual_not_fitted_cls is None:
            try:
                from sklearn.exceptions import NotFittedError as _SkNFE

                class _DualNotFitted(NotFittedError, _SkNFE):
                    pass

                _DualNotFitted.__name__ = "NotFittedError"
                _DualNotFitted.__qualname__ = "NotFittedError"
                _dual_not_fitted_cls = _DualNotFitted
            except Exception:
                _dual_not_fitted_cls = NotFittedError
        cls = _dual_not_fitted_cls
    raise cls(msg)


def _is_sparse(x) -> bool:
    # scipy.sparse duck-typing: avoids importing scipy on the hot path
    return hasattr(x, "toarray") and hasattr(x, "tocsr")


def resolve_config(cfg: CorexConfig, nv: int,
                   n_samples: Optional[int] = None) -> CorexConfig:
    """Resolve the 'auto' config knobs against the data shapes.

    Single source of truth shared by Corex.fit, sharded fits, streaming
    fits, and checkpointed fits.

    optimizer='auto' → 'fixed_point' when the problem is fully sampled
    (n_samples >= nv, so Σ̂ is full rank) on the non-overlap path, else
    'momentum'. Measured basis (DESIGN.md table): at n >= p the damped
    closed-form fixed point is both ~2x cheaper per iteration (2 big GEMMs
    vs 4) and converges to equal-or-better TC in fewer iterations
    (north-star p=10k/m=512: TC 12810 in 179 iters vs heavy-ball's 11564
    in 401 iters); in the undersampled n < p clipping regime
    it commits to visibly worse optima (cfg5: TC 130k vs momentum's 204k),
    so heavy-ball stays the choice there. Unknown n_samples (a raw Gram
    operand passed to a low-level driver without its sample count)
    resolves to the robust 'momentum'. Nothing here depends on the device
    platform: the same shapes resolve the same way on every backend.

    Also the single p-aware hazard check shared by every resolution
    funnel (Corex.fit, sharded/streaming/checkpointed drivers, AOT
    warmup): stage_tol_factor x int8 at scale — see the warning below."""
    # Read the composed stage tol off the ACTUAL schedule, not
    # tol*factor: the checkpoint driver pre-bakes tol*factor into each
    # stage's `tol` while keeping stage_tol_factor, so recomputing the
    # product here would square the factor and warn on measured-safe
    # fits — and its eps_override programs (length-1 schedule, factor
    # inert) have no non-final stage to hazard-check at all.
    stage_tols = cfg.tol_schedule()
    if (len(stage_tols) > 1 and cfg.stage_tol_factor > 1.0
            and cfg.matmul_dtype == "int8"
            and max(stage_tols[:-1]) * np.sqrt(nv) >= 0.05):
        # Measured hazard (benchmarks/RESULTS.md stage-tol study, cfg5
        # rows): under int8 moment noise, a composed non-final stage tol
        # (tol x factor) that is large relative to the ~1/sqrt(p) W-entry
        # scale TRUNCATES annealing and collapses TC at scale — cfg5
        # (p=100k, tol=1e-4): -24% TC on BOTH structure regimes at
        # factor=10, and strong structure collapses already at factor=3
        # (composed 3e-4), while float32 at the SAME composed tols holds
        # TC. Threshold 0.05 on tol*factor*sqrt(p) is bracketed by six
        # measured points (RESULTS.md "int8 hazard-threshold bracketing"):
        # 0.045 @ p=2048 mild drift; 0.030/0.050/0.090 @ p=10k SAFE (the
        # in-band TC movement there is annealing-truncation shared with
        # f32, not the int8 mechanism); 0.067 @ p=50k -1..-3%; 0.095 @
        # p=100k -24% collapse. Severity ramps with p at comparable
        # hazard, so 0.05 is kept as a conservative advisory — it marks
        # where annealed-path fidelity measurably starts to degrade.
        import warnings
        warnings.warn(
            f"stage_tol_factor={cfg.stage_tol_factor:g} with "
            f"matmul_dtype='int8' at p={nv}: the composed non-final "
            f"stage tol ({max(stage_tols[:-1]):g}) "
            f"is large relative to the ~1/sqrt(p) W-entry scale, and "
            f"under int8 moment noise this is measured to truncate "
            f"annealing and COLLAPSE TC at scale (p=100k: -24% on both "
            f"structure regimes; float32 holds TC at the same composed "
            f"tols — benchmarks/RESULTS.md stage-tol study). Use "
            f"stage_tol_factor=1 with int8, or keep the factor on the "
            f"float32/bfloat16 path.")
    if cfg.optimizer != "auto":
        return cfg
    import dataclasses
    fp_ok = (cfg.discourage_overlap and n_samples is not None
             and n_samples >= nv)
    return dataclasses.replace(
        cfg, optimizer="fixed_point" if fp_ok else "momentum")


def pick_fit_strategy(config: CorexConfig, n: int, p: int,
                      plan=None) -> str:
    """moment_strategy resolution for a fit, INCLUDING the plan-aware
    rule — the single definition shared by `Corex._prepare_fit` and
    `utils.compile_cache.warmup_fit` (a drifted copy would make warmup
    compile a different program than fit, silently defeating AOT): a
    sample-sharding plan forces the samples strategy, because
    distributing X over the mesh is the point of such a plan and a Gram
    operand carries no sample axis to shard."""
    strategy = config.pick_strategy(n, p)
    if (strategy == "gram" and plan is not None
            and (plan.shard_samples or plan.shard_slices)
            and not plan.shard_vars):
        if config.moment_strategy == "auto":
            return "samples"
        # explicit 'gram' request: honor it, but a sample-only plan maps
        # a Gram operand to P(None, None) — the mesh fit would silently
        # run fully replicated, with no sharded data axis at all
        import warnings
        warnings.warn(
            "moment_strategy='gram' with a ShardingPlan that shards only "
            "sample axes: a Gram operand carries no sample axis, so the "
            "mesh fit will run fully REPLICATED (every chip holds the "
            "whole p x p operand and does the whole work). Use "
            "ShardingPlan(shard_vars=True) to shard the Gram rows, or "
            "moment_strategy='auto'/'samples' to shard the sample axis.")
    return strategy


def _make_obj_grad(data, cfg: CorexConfig, strategy: str):
    """Close the active objective/direction over the data (samples or Gram).

    strategy: 'samples' | 'gram'. For optimizer='fixed_point' the
    returned "gradient" is the fixed-point residual ws − Ŵ
    (`[U] :: _update_ws`), which the solver's plain-GD step turns into the
    damped update (1−γ)·ws + γ·Ŵ."""
    if cfg.optimizer == "auto":
        raise ValueError(
            "optimizer='auto' must be resolved against the data shapes "
            "before building the objective — call resolve_config(cfg, nv, "
            "n_samples=n) first (Corex.fit and the sharded/streaming "
            "drivers do)")
    if cfg.matmul_dtype == "int8" and not isinstance(data,
                                                     M.QuantizedData):
        # the int8 mode is carried by the operand (ops.moments dispatches
        # on QuantizedData); a plain array here would SILENTLY run f32
        raise ValueError(
            "matmul_dtype='int8' requires the quantized samples operand — "
            "pass M.quantize_samples(x) (Corex.fit and the restart/"
            "selection drivers do this)")
    if (cfg.stage_subsample < 1.0 and strategy == "samples"
            and subsample_stride(cfg.stage_subsample) > 1
            and len(cfg.anneal_schedule()) > 1):
        # single funnel for EVERY one-program solver driver (restarts,
        # GSPMD sharded, selection sweeps, audits): they run the whole
        # schedule on ONE operand, so the two-program subsampled staging
        # cannot apply — failing loudly here beats silently fitting the
        # full data on every stage. Corex.fit/fit_with_checkpoints
        # implement the staging and hand the pieces stage_subsample=1
        # configs (_staged_subsample_cfgs); the gram strategy ignores
        # the knob by design (no sample axis — stage_subsample_active
        # warns); stride-1 fractions (> 2/3) are INERT, matching
        # stage_subsample_active — no rows would drop, so the
        # one-program fit IS the subsampled fit.
        raise ValueError(
            "stage_subsample < 1 reached a one-program solver driver, "
            "which runs the whole anneal schedule on one operand. Only "
            "Corex.fit and fit_with_checkpoints implement the "
            "two-program subsampled staging — set stage_subsample=1 for "
            "restart/sharded/selection drivers.")
    bf16 = cfg.matmul_dtype == "bfloat16"
    gram = strategy == "gram"
    if cfg.optimizer == "fixed_point":
        # fixed_point + overlap is rejected by CorexConfig.__post_init__
        fn = M.ns_fp_gram if gram else M.ns_fp_samples
        return lambda ws, eps: fn(ws, data, eps, cfg.y_scale, cfg.rho_clip,
                                  bf16=bf16)
    if cfg.discourage_overlap:
        fn = M.ns_obj_grad_gram if gram else M.ns_obj_grad_samples
        return lambda ws, eps: fn(ws, data, eps, cfg.y_scale, cfg.rho_clip,
                                  bf16=bf16)
    if gram:
        return lambda ws, eps: M.overlap_obj_grad_gram(
            ws, data, eps, cfg.y_scale)
    return lambda ws, eps: M.overlap_obj_grad_samples(
        ws, data, eps, cfg.y_scale)


def precision_ctx(cfg: CorexConfig):
    """Matmul-precision scope for a fit program — single definition shared
    by the single-device, sharded, and shard_map programs (on the GPU the
    knob is the difference between TF32 and true-f32 moment GEMMs)."""
    import contextlib
    if cfg.matmul_precision == "default":
        return contextlib.nullcontext()
    return jax.default_matmul_precision(cfg.matmul_precision)


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _prepare_program(x, pre_cfg: Optional[PreprocessConfig],
                     strategy: str, matmul_dtype: str, plan=None):
    """Preprocessing + operand construction as ONE compiled program:
    gaussianize/standardize → (optionally) Gram → bf16 cast / int8
    quantize, fused: one dispatch and one compile instead of ~10, and
    no intermediate X-sized device buffers (the unfused
    standardize→quantize chain held ~4 extra 4 GB buffers at p=100k).
    pre_cfg=None means `x` is already preprocessed (the native-host fast
    path) — only the operand step
    runs. Returns (data, theta); theta is None when pre_cfg is None.
    The int8 overflow guard runs EAGERLY on the result in
    `Corex._prepare_fit` (it needs host control flow).

    `plan` (a ShardingPlan, jit-static; mesh fits only — call under
    `jax.set_mesh(mesh)` with `x` device_put per `plan.x_spec()`)
    constrains the OUTPUT operand to `operand_specs(plan, strategy)`,
    so the whole prepare runs under the target sharding and no
    full-size buffer ever lives on one device: standardization stats
    are per-column reductions GSPMD partitions, and the Gram build
    contracts the sharded sample axis
    (previously the operand was built on ONE device before fit_sharded
    device_put it, capping p at a single device's memory)."""
    if pre_cfg is None:
        xp, theta = x, None
    else:
        xp, theta = P.fit_preprocess(x, pre_cfg.gaussianize,
                                     pre_cfg.missing_values)
    data = M.compute_gram(xp) if strategy == "gram" else xp
    if matmul_dtype == "bfloat16":
        data = data.astype(jnp.bfloat16)
    elif matmul_dtype == "int8":
        data = M.quantize_samples(data, check_overflow=False)
    if plan is not None:
        # deferred import: parallel.sharding imports this module
        from linearcorex_tpu.parallel.sharding import operand_specs
        data_spec, _ = operand_specs(plan, strategy)
        if isinstance(data, M.QuantizedData):
            data = M.QuantizedData(
                q=jax.lax.with_sharding_constraint(data.q, data_spec),
                scale=data.scale)
        else:
            data = jax.lax.with_sharding_constraint(data, data_spec)
    return data, theta


@partial(jax.jit, static_argnums=(2, 3))
def _spectral_init_program(data, omega, strategy: str, matmul_dtype: str):
    """Randomized range-finder init (config.init='spectral'): W₀ = Qᵀ
    with Q·R = Σ_emp·Ω for a random (p, m) block Ω — rows of W start
    spanning the top-m subspace of Σ̂. One Σ-application (the same
    per-iteration operator the solver uses: gram/samples/int8 backends
    via `_apply_sigma_t`) + a thin QR; cost ≈ one solver iteration.
    A second power iteration measured no better (cfg5, RESULTS.md)."""
    gram = strategy == "gram"
    bf16 = matmul_dtype == "bfloat16"
    apply = M._apply_sigma_t(data, bf16, gram, omega.dtype)
    q, _ = jnp.linalg.qr(apply(omega).astype(omega.dtype))
    return q.T


@partial(jax.jit, static_argnums=(2, 3))
def _fit_program(data, w0, cfg: CorexConfig, strategy: str):
    """The complete fit as one XLA program: annealed solve → final moments →
    factor sort (SURVEY.md §3.1). Returns (ws, Moments, FitDiagnostics)."""
    with precision_ctx(cfg):
        obj_grad = _make_obj_grad(data, cfg, strategy)
        ws, diag = fit_core(obj_grad, w0, cfg)
        zero = jnp.asarray(0.0, w0.dtype)
        if strategy == "gram":
            c_xy = M.cxy_gram(data, ws, zero)
        else:
            c_xy = M.cxy_samples(data, ws, zero)
        mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
        ws_sorted, order = sort_by_tcs(ws, mom.tcs)
        return ws_sorted, M.permute_moments(mom, order), diag


def stage_subsample_active(cfg: CorexConfig, strategy: str) -> bool:
    """Whether the two-program stage-subsample driver applies — the single
    definition shared by `Corex.fit` and `utils.compile_cache.warmup_fit`
    (a forked copy would make warmup compile different cache keys than
    the fit, silently defeating AOT — the same rule as
    `pick_fit_strategy`). Active iff the config asks for it
    (stage_subsample < 1), the resolved strategy is 'samples' (a Gram
    operand carries no sample axis — warned and ignored), and the
    schedule has a non-final stage to subsample."""
    if cfg.stage_subsample >= 1.0:
        return False
    if strategy != "samples":
        import warnings
        warnings.warn(
            f"stage_subsample={cfg.stage_subsample:g} is inert on the "
            f"gram moment strategy: the p x p operand carries no sample "
            f"axis (iteration cost is n-independent there). Use "
            f"moment_strategy='samples' — or drop the knob; the fit "
            f"proceeds on the full schedule unchanged.")
        return False
    if subsample_stride(cfg.stage_subsample) == 1:
        # fraction > 2/3 rounds to stride 1: no rows would actually be
        # dropped, so the two-program split would pay its extra host
        # sync + compile for ZERO subsampling (the split itself is a
        # numerical no-op — tests/test_stage_subsample.py pins that).
        # Run the one-program fit instead; the f64 oracle mirrors this.
        import warnings
        warnings.warn(
            f"stage_subsample={cfg.stage_subsample:g} rounds to row "
            f"stride 1 (fractions > 2/3 keep every row) — no actual "
            f"subsampling, so the staged two-program driver is skipped. "
            f"Use a fraction <= 2/3 (e.g. 0.5, 0.25) or drop the knob.")
        return False
    return len(cfg.anneal_schedule()) > 1


def check_restart_sweep_supported(cfg: CorexConfig, strategy: str) -> None:
    """Reject configs the vmapped restart sweep cannot honor — the single
    definition shared by `Corex._fit_restart_sweep` and
    `utils.compile_cache.warmup_fit`: the warmup must raise exactly where
    the fit raises instead of warming a dead cache key (and instead of
    funneling into `_make_obj_grad`'s staging error, whose guidance points
    the wrong way for this combination — round-5 review finding)."""
    if stage_subsample_active(cfg, strategy):
        raise ValueError(
            "stage_subsample < 1 is not supported with n_restarts > "
            "1: the restart sweep is one vmapped program over the "
            "whole anneal schedule. Set stage_subsample=1, or run "
            "the staged fits sequentially.")


RESTART_AXIS = "restarts"  # mesh axis the restart lanes shard over


def resolve_restart_mesh_layout(mesh, plan):
    """Layout for `Corex(n_restarts>1).fit(mesh=...)`: the single
    definition shared by `Corex.fit` and `utils.compile_cache.
    warmup_fit` (the warmup must compile the sweep's exact cache key, so
    the layout decision cannot fork). Returns (strategy_plan,
    data_axis):

    - strategy_plan is what `pick_fit_strategy`/`_prepare_fit` see — the
      caller's plan when the mesh carries DATA_AXIS and the plan shards
      samples (the combined restarts x data layout, BASELINE config 5's
      literal layout — SURVEY.md §2.8 DP+EP rows; the operand is then
      prepared SHARDED, so the raw X never lands whole on one device),
      else None (restart-only sharding, operand replicated per lane).
    - data_axis is the sample-sharding mesh axis for
      `parallel.restarts.fit_restarts_sharded`, or None. Callers must
      drop it to None when the resolved strategy is not 'samples' (an
      explicit moment_strategy='gram' under a sample plan runs
      replicated — `pick_fit_strategy` warns).

    The restart lanes always shard over the RESTART_AXIS ('restarts')
    mesh axis; var/factor/slice sharding has no restart-sweep program —
    both raise by name."""
    from linearcorex_tpu.parallel.sharding import DATA_AXIS
    if RESTART_AXIS not in mesh.axis_names:
        raise ValueError(
            f"n_restarts > 1 under fit(mesh=...): the restart lanes "
            f"shard over a mesh axis named {RESTART_AXIS!r}, but the "
            f"mesh has axes {mesh.axis_names}. Build it with that axis "
            f"— make_mesh((({RESTART_AXIS!r}, n_devices),)), or the "
            f"combined restarts x data layout make_mesh"
            f"((({RESTART_AXIS!r}, a), ({DATA_AXIS!r}, b))) — or call "
            f"parallel.restarts.fit_restarts_sharded directly for a "
            f"custom axis name.")
    if plan.shard_vars or plan.shard_factors or plan.shard_slices:
        raise ValueError(
            "n_restarts > 1 under fit(mesh=...) supports sample "
            "sharding only (the combined restarts x data layout); "
            "var/factor/slice sharding has no restart-sweep program. "
            "Use n_restarts=1 for those layouts, or drop them from the "
            "ShardingPlan.")
    if plan.shard_samples and DATA_AXIS in mesh.axis_names:
        return plan, DATA_AXIS
    return None, None


def subsample_stride(fraction: float) -> int:
    """Row stride k for stage_subsample: rows x[::k], k = round(1/f)."""
    return max(1, int(round(1.0 / float(fraction))))


def subsample_len(n: int, fraction: float) -> int:
    """len(x[::k]) for n rows — the prefix program's row count (shared
    with warmup_fit, which declares the shape without data)."""
    return -(-int(n) // subsample_stride(fraction))


def _subsample_rows(data, fraction: float):
    """The non-final-stage operand: every k-th row (order-robust against
    sorted inputs, deterministic — no RNG). QuantizedData keeps its
    per-tensor scale: rows are a subset of the same standardized X."""
    k = subsample_stride(fraction)
    if k == 1:
        return data
    if isinstance(data, M.QuantizedData):
        return M.QuantizedData(q=data.q[::k], scale=data.scale)
    return data[::k]


def _staged_subsample_cfgs(cfg: CorexConfig):
    """(prefix_cfg, final_cfg) for the two-program stage-subsample fit.
    The prefix runs anneal_schedule()[:-1] as ONE program (tuple
    eps_override) on the subsampled rows with the non-final stage tol
    pre-baked; the final stage runs on the FULL data at `tol` exactly —
    so the returned optimum's convergence guarantee is unchanged (the
    stage_tol_factor contract). Shared with warmup_fit (AOT compiles
    the fit's exact cache keys)."""
    import dataclasses
    sched = cfg.anneal_schedule()
    tols = cfg.tol_schedule()
    # stage_subsample=1.0 in the derived configs: the staging is realized
    # HERE (operand choice), so the one-program guard in _make_obj_grad
    # must not trip on the pieces
    prefix = dataclasses.replace(cfg, eps_override=tuple(sched[:-1]),
                                 tol=tols[0], stage_tol_factor=1.0,
                                 stage_subsample=1.0)
    final = dataclasses.replace(cfg, eps_override=float(sched[-1]),
                                stage_tol_factor=1.0, stage_subsample=1.0)
    return prefix, final


def _fit_staged_subsample(data, w0, cfg: CorexConfig, strategy: str):
    """Stage-subsample fit driver: non-final anneal stages on every k-th
    row (samples-path iteration cost is linear in n), final stage on the
    full data. Two compiled programs instead of one — one extra host sync
    and compile against the stage savings
    (benchmarks/RESULTS.md "stage-subsample study"). Each program ends
    with a tcs factor sort like any `_fit_program` (the float64 oracle
    mirrors the mid-sort, so seeded f64 runs stay step-matched).
    Returns (ws, Moments, FitDiagnostics) with the per-stage diagnostics
    of both programs concatenated and the FULL schedule snapshotted."""
    prefix_cfg, final_cfg = _staged_subsample_cfgs(cfg)
    n = (data.q if isinstance(data, M.QuantizedData) else data).shape[0]
    p = w0.shape[1]
    if cfg.optimizer == "fixed_point" and subsample_len(
            n, cfg.stage_subsample) < p <= n:
        # 'auto' resolves on the FULL n (optimizer='fixed_point' iff
        # n >= p), but the basin-selecting anneal prefix runs on n_sub
        # rows — if the subsample drops it into the undersampled regime
        # (n_sub < p), fixed_point is measured to commit to worse optima
        # there (resolve_config docstring; DESIGN.md optimizer study).
        import warnings
        warnings.warn(
            f"stage_subsample={cfg.stage_subsample:g}: the anneal-prefix "
            f"program runs on n_sub={subsample_len(n, cfg.stage_subsample)}"
            f" < p={p} rows with optimizer='fixed_point' — the prefix "
            f"selects the basin in the undersampled regime where "
            f"fixed_point is measured to commit to worse optima. Use "
            f"optimizer='momentum' (the undersampled-regime choice) or a "
            f"larger fraction.")
    data_sub = _subsample_rows(data, cfg.stage_subsample)
    ws1, _, d1 = _fit_program(data_sub, w0, prefix_cfg, strategy)
    ws, mom, d2 = _fit_program(data, ws1, final_cfg, strategy)
    diag = FitDiagnostics(*[jnp.concatenate([a, b])
                            for a, b in zip(d1, d2)])
    return ws, mom, diag


@partial(jax.jit, static_argnums=(3, 4))
def _details_program(x, ws, theta, pre_cfg: PreprocessConfig,
                     cfg: CorexConfig):
    xp = P.preprocess(x, pre_cfg.gaussianize, theta, pre_cfg.missing_values)
    y = M._mm(xp, ws.T)
    c_xy = M.cxy_samples(xp, ws, jnp.asarray(0.0, ws.dtype))
    return y, M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)


# Inference programs are jitted so that each serving call is one
# dispatch, like the fit path.
@partial(jax.jit, static_argnums=(3,))
def _transform_program(x, ws, theta, pre_cfg: PreprocessConfig):
    xp = P.preprocess(x, pre_cfg.gaussianize, theta, pre_cfg.missing_values)
    return M._mm(xp, ws.T)


@jax.jit
def _predict_ns_program(y, rhoinvrho, si, z2, theta):
    rec_w = (rhoinvrho.T / (1.0 + si)[:, None]
             / jnp.sqrt(z2)[jnp.newaxis, :])
    return P.invert(M._mm(y, rec_w.T), theta)


@jax.jit
def _predict_overlap_program(y, cy, c_xy, theta):
    coef = jnp.linalg.solve(cy, c_xy.T)
    return P.invert(M._mm(y, coef), theta)


def _unit_diag_scaled(cov, std):
    nv = cov.shape[0]
    cov = cov - jnp.diag(jnp.diagonal(cov)) + jnp.eye(nv, dtype=cov.dtype)
    return std[:, jnp.newaxis] * std[jnp.newaxis, :] * cov


@jax.jit
def _cov_ns_program(rhoinvrho, si, std):
    z = rhoinvrho / (1.0 + si)[jnp.newaxis, :]
    return _unit_diag_scaled(M._mm(z.T, z), std)


@jax.jit
def _cov_overlap_program(cy, c_xy, std):
    sol = jnp.linalg.solve(cy, c_xy.T)
    return _unit_diag_scaled(M._mm(c_xy, sol), std)


@jax.jit
def _matvec_ns_program(rhoinvrho, si, std, v):
    z = rhoinvrho / (1.0 + si)[jnp.newaxis, :]
    sv = std * v
    low = z.T @ (z @ sv)
    diag = jnp.sum(z * z, axis=0)
    return std * (low + (1.0 - diag) * sv)


def _factor_z_ns(rhoinvrho, si):
    """Z with Σ_std = diag(d) + ZᵀZ, non-overlap path (the `get_covariance`
    factorization) — single definition shared by score() and the
    pick_n_hidden held-out scorer."""
    return rhoinvrho / (1.0 + si)[jnp.newaxis, :]


def _factor_z_overlap(cy, c_xy):
    """Z for the overlap path: Σ_offdiag = C_xy·C_y⁻¹·C_xyᵀ = ZᵀZ with
    Z = L⁻¹·C_xyᵀ, C_y = L·Lᵀ."""
    lchol = jnp.linalg.cholesky(cy)
    return jax.scipy.linalg.solve_triangular(lchol, c_xy.T, lower=True)


def _gaussian_ll(xp, z, std):
    """Mean Gaussian log-likelihood of preprocessed rows under the factor
    covariance Σ_std = diag(d) + ZᵀZ (d = 1 − Σ_j z_ji², the unit-diagonal
    completion `get_covariance` uses), via Woodbury + the matrix
    determinant lemma: O(n·p·m + m³), the p x p never materializes. The
    `− Σ log std` term maps the density back through the affine
    standardization to the original data scale."""
    p = xp.shape[1]
    mdim = z.shape[0]
    d = jnp.maximum(1.0 - jnp.sum(z * z, axis=0), 1e-6)
    zd = z / d[jnp.newaxis, :]
    a = jnp.eye(mdim, dtype=z.dtype) + M._mm(zd, z.T)
    chol = jnp.linalg.cholesky(a)
    logdet = jnp.sum(jnp.log(d)) + 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(chol)))
    t = xp / d[jnp.newaxis, :]
    q1 = jnp.sum(xp * t, axis=1)
    u = M._mm(t, z.T)                                       # n x m
    sol = jax.scipy.linalg.cho_solve((chol, True), u.T)     # m x n
    q2 = jnp.sum(u.T * sol, axis=0)
    ll = -0.5 * (q1 - q2 + logdet
                 + p * jnp.log(jnp.asarray(2.0 * np.pi, xp.dtype)))
    return jnp.mean(ll) - jnp.sum(jnp.log(std))


@partial(jax.jit, static_argnums=(4,))
def _score_ns_program(x, rhoinvrho, si, theta, pre_cfg):
    xp = P.preprocess(x, pre_cfg.gaussianize, theta, pre_cfg.missing_values)
    return _gaussian_ll(xp, _factor_z_ns(rhoinvrho, si), theta.std)


@partial(jax.jit, static_argnums=(4,))
def _score_overlap_program(x, cy, c_xy, theta, pre_cfg):
    xp = P.preprocess(x, pre_cfg.gaussianize, theta, pre_cfg.missing_values)
    return _gaussian_ll(xp, _factor_z_overlap(cy, c_xy), theta.std)


@jax.jit
def _matvec_overlap_program(cy, c_xy, std, v):
    sol = jnp.linalg.solve(cy, c_xy.T)                   # m x p
    sv = std * v
    low = c_xy @ (sol @ sv)
    diag = jnp.sum(c_xy * sol.T, axis=1)
    return std * (low + (1.0 - diag) * sv)


@jax.jit
def _matmat_ns_program(rhoinvrho, si, std, v):
    z = _factor_z_ns(rhoinvrho, si)
    sv = std[:, None] * v
    low = M._mm(z.T, M._mm(z, sv))
    diag = jnp.sum(z * z, axis=0)
    return std[:, None] * (low + (1.0 - diag)[:, None] * sv)


@jax.jit
def _matmat_overlap_program(cy, c_xy, std, v):
    sol = jnp.linalg.solve(cy, c_xy.T)                   # m x p
    sv = std[:, None] * v
    low = c_xy @ (sol @ sv)
    diag = jnp.sum(c_xy * sol.T, axis=1)
    return std[:, None] * (low + (1.0 - diag)[:, None] * sv)


@partial(jax.jit, static_argnums=(3,))
def _cov_rows_program(z, std, start, block):
    """Dense rows [start, start+block) of the factor-model covariance from
    its shared factorization Σ_std = diag(1 − Σ_j z_ji²) + ZᵀZ (unit
    diagonal), scaled back by std. `start` is traced (dynamic_slice), so
    every block of one export reuses ONE compiled program."""
    zb = jax.lax.dynamic_slice_in_dim(z, start, block, axis=1)   # m x b
    rows = M._mm(zb.T, z)                                        # b x p
    idx = jnp.arange(block)
    rows = rows.at[idx, start + idx].set(1.0)   # unit-diagonal completion
    stdb = jax.lax.dynamic_slice_in_dim(std, start, block, 0)
    return stdb[:, None] * std[None, :] * rows


def serving_state_specs(plan):
    """PartitionSpec layout the sharded serving path commits the fitted
    state with — the SINGLE definition shared by `Corex._serving_mesh`
    and `utils.compile_cache._warmup_serving_mesh` (the warmup rule:
    a forked copy would lower a different module than the real dispatch
    and silently defeat AOT warmup). The m x m `cy` stays replicated
    (small solves/Cholesky are best unpartitioned); `theta` is the spec
    for each of its p-vectors."""
    from jax.sharding import PartitionSpec as PS

    from linearcorex_tpu.parallel.sharding import FACTOR_AXIS, VAR_AXIS

    var = VAR_AXIS if plan.shard_vars else None
    fac = FACTOR_AXIS if plan.shard_factors else None
    return {"ws": PS(fac, var), "rhoinvrho": PS(fac, var), "si": PS(var),
            "z2": PS(fac), "cy": PS(None, None), "c_xy": PS(var, fac),
            "theta": PS(var)}


def _ctor_defaults():
    """Constructor-signature defaults of Corex.__init__, read from the
    signature itself so preset resolution (`Corex.config`) can never
    drift from the real defaults. Cached after the first call."""
    cached = getattr(_ctor_defaults, "_cache", None)
    if cached is None:
        import inspect
        cached = {
            k: v.default
            for k, v in inspect.signature(Corex.__init__).parameters.items()
            if v.default is not inspect.Parameter.empty}
        _ctor_defaults._cache = cached
    return cached


class Corex:
    """Linear CorEx estimator in JAX (reference-compatible surface)."""

    def __init__(self, n_hidden=10, max_iter=10000, tol=1e-5, anneal=True,
                 missing_values=None, discourage_overlap=True,
                 gaussianize="standard", gpu=None, y_scale=1.0,
                 update_iter=10, pretrained_weights=None, verbose=False,
                 seed=None, dtype="float32", moment_strategy="auto",
                 record_history=True, matmul_dtype="float32",
                 matmul_precision="default",
                 optimizer="momentum", momentum_beta=0.9, init="random",
                 preset="reference", stage_tol_factor=1.0,
                 stage_subsample=1.0, n_restarts=1):
        # sklearn init contract: store the constructor arguments VERBATIM
        # and nothing else (no validation, no derived objects) — the
        # frozen jit-static CorexConfig/PreprocessConfig are derived
        # lazily by the `config`/`pre_config` properties, so invalid
        # values surface at first use (fit), per the sklearn deferred-
        # validation convention, and set_params is a plain attribute
        # update. `gpu` is stored but ignored: XLA is the one backend.
        self.n_hidden = n_hidden
        self.max_iter = max_iter
        self.tol = tol
        self.anneal = anneal
        self.missing_values = missing_values
        self.discourage_overlap = discourage_overlap
        self.gaussianize = gaussianize
        self.gpu = gpu
        self.y_scale = y_scale
        self.update_iter = update_iter
        self.pretrained_weights = pretrained_weights
        self.verbose = verbose
        self.seed = seed
        self.dtype = dtype
        self.moment_strategy = moment_strategy
        self.record_history = record_history
        self.matmul_dtype = matmul_dtype
        self.matmul_precision = matmul_precision
        self.optimizer = optimizer
        self.momentum_beta = momentum_beta
        self.init = init
        self.preset = preset
        self.stage_tol_factor = stage_tol_factor
        self.stage_subsample = stage_subsample
        self.n_restarts = n_restarts
        # warm-start weights live APART from fitted state so that a
        # repeated fit() is fresh/idempotent (sklearn contract; matches
        # the reference, which re-initializes per fit from
        # pretrained_weights or a seeded draw — SURVEY.md §5 checkpoint
        # row). `load_corex` re-arms this so a post-load fit() warm-starts.
        self._pretrained_ws: Optional[jax.Array] = None

    # Fitted state defaults live on the CLASS: instances carry no fitted
    # attributes until fit() sets them (sklearn's
    # check_no_attributes_set_in_init / check_dont_overwrite_parameters
    # contract), while pre-fit reads still see None. The public names —
    # ws, theta, moments, diagnostics, nv, n_samples — keep the
    # reference's attribute API (`[U] :: Corex` exposes `ws` etc., no
    # trailing underscores), via properties over private storage.
    _ws: Optional[jax.Array] = None
    _theta: Optional[P.Theta] = None
    _moments: Optional[M.Moments] = None
    _diagnostics: Optional[FitDiagnostics] = None
    _nv: Optional[int] = None
    _n_samples: Optional[int] = None
    # the optimizer the last fit actually ran ('auto' resolved per fit)
    resolved_optimizer_: Optional[str] = None
    # which restart lane the last fit kept (0 for single fits; argmax-TC
    # lane of an n_restarts>1 sweep — its init seed is seed + lane)
    best_restart_: Optional[int] = None
    # the ShardingPlan the state currently lives under (last mesh fit or
    # mesh serving call); None = single-device placement. Serving calls
    # with sharding_plan=None reuse it (see _serving_mesh).
    _serving_plan = None

    ws = property(lambda self: self._ws,
                  lambda self, v: setattr(self, "_ws", v),
                  doc="Fitted (m, p) weight matrix (None before fit).")
    theta = property(lambda self: self._theta,
                     lambda self, v: setattr(self, "_theta", v),
                     doc="Preprocessing parameters (None before fit).")
    moments = property(lambda self: self._moments,
                       lambda self, v: setattr(self, "_moments", v),
                       doc="Fitted moment pytree (None before fit).")
    diagnostics = property(
        lambda self: self._diagnostics,
        lambda self, v: setattr(self, "_diagnostics", v),
        doc="Per-stage FitDiagnostics (None before fit).")
    nv = property(lambda self: self._nv,
                  lambda self, v: setattr(self, "_nv", v),
                  doc="Fitted n_variables (None before fit).")
    n_samples = property(
        lambda self: self._n_samples,
        lambda self, v: setattr(self, "_n_samples", v),
        doc="n_samples of the last fit (None before fit).")

    # ------------------------------------------------------------------
    @property
    def config(self) -> CorexConfig:
        """The frozen jit-static solver config, derived from the current
        hyperparameters (equal configs hash equal, so jit cache keys are
        unaffected). Validation happens here — i.e. at first USE, not in
        __init__ (sklearn deferred-validation contract). Memoized on the
        parameter values so validation WARNINGS fire once per distinct
        configuration, not once per access (a single fit reads this
        several times).

        `preset` resolution also happens here (config.PRESETS): a
        preset supplies DEFAULTS — any parameter the user set
        to a non-default value wins over the preset's value (a parameter
        explicitly passed AT its constructor default is indistinguishable
        from one left alone, so it takes the preset's value; use
        preset='reference' for full manual control). Resolving in this
        one place means warmup/AOT compiles, sharded fits, and
        checkpoint drivers all derive the same cache key — no forked
        policy."""
        key = (self.n_hidden, self.max_iter, self.tol, self.anneal,
               self.discourage_overlap, self.y_scale, self.dtype,
               self.moment_strategy, self.record_history,
               self.matmul_dtype, self.matmul_precision,
               self.optimizer, self.momentum_beta, self.init, self.preset,
               self.stage_tol_factor, self.stage_subsample)
        cached = getattr(self, "_cfg_cache", None)
        # an array-valued parameter (e.g. set_params(tol=np.array([1e-5])))
        # makes tuple equality raise ambiguous-truth; such a key can never
        # hit the cache, so fall through to CorexConfig validation, which
        # owns the error message for invalid parameter types
        try:
            hit = cached is not None and bool(cached[0] == key)
        except (ValueError, TypeError):
            hit = False
        if hit:
            return cached[1]
        raw = dict(
            n_hidden=self.n_hidden, max_iter=self.max_iter, tol=self.tol,
            anneal=self.anneal, discourage_overlap=self.discourage_overlap,
            y_scale=self.y_scale, dtype=self.dtype,
            moment_strategy=self.moment_strategy,
            record_history=self.record_history,
            matmul_dtype=self.matmul_dtype,
            matmul_precision=self.matmul_precision,
            optimizer=self.optimizer, momentum_beta=self.momentum_beta,
            init=self.init, stage_tol_factor=self.stage_tol_factor,
            stage_subsample=self.stage_subsample)
        defaults = _ctor_defaults()
        user_set = {}
        for name, val in raw.items():
            try:
                changed = bool(val != defaults[name])
            except (ValueError, TypeError):
                # array-valued parameter: treat as user-set and let
                # CorexConfig validation own the error message
                changed = True
            if changed:
                user_set[name] = val
        cfg = CorexConfig(**{**raw, **apply_preset(self.preset, user_set)})
        self._cfg_cache = (key, cfg)
        return cfg

    @property
    def pre_config(self) -> PreprocessConfig:
        return PreprocessConfig(gaussianize=self.gaussianize,
                                missing_values=self.missing_values)

    @property
    def m(self) -> int:
        """Alias for n_hidden (the solver's factor-axis size)."""
        return self.n_hidden

    @property
    def _dt(self):
        return jnp.dtype(self.config.dtype)

    def _init_ws(self, p: int):
        """N(0, 1/sqrt(p)) init (`[U] :: Corex.fit` [MED]).

        Seeded: NumPy's RandomState — not JAX's threefry — so that a given
        seed produces the same starting point as the float64 oracle,
        making seed-matched parity runs possible (SURVEY.md §7.3 item 3).
        Unseeded (seed=None, no reproducibility contract): drawn ON
        DEVICE with fresh entropy — a host-generated W is m x p (205 MB
        at cfg5), which would cost a host→device transfer."""
        if self.seed is None:
            key = jax.random.PRNGKey(
                int(np.random.SeedSequence().generate_state(1)[0]))
            return jax.random.normal(key, (self.m, p), self._dt) \
                / jnp.sqrt(jnp.asarray(float(p), self._dt))
        rng = np.random.RandomState(self.seed)
        return rng.normal(loc=0.0, scale=1.0 / np.sqrt(p),
                          size=(self.m, p))

    def _host_preprocess(self, x):
        """Native host-side fast path for 'empirical' gaussianization of
        NumPy inputs (native/gaussianize.cpp via utils.native); agrees with
        the device path to double precision. Returns None when inapplicable
        (non-NumPy input or library unavailable)."""
        if self.pre_config.gaussianize != "empirical" or not isinstance(
                x, np.ndarray):
            return None
        from linearcorex_tpu.utils import native
        if not native.available():
            return None
        xh = np.asarray(x, dtype=np.float64)
        if self.pre_config.missing_values is not None:
            xh = native.mean_impute(xh, self.pre_config.missing_values)
        theta = P.Theta(mean=jnp.asarray(xh.mean(0), self._dt),
                        std=jnp.asarray(
                            np.where(xh.std(0) < 1e-10, 1.0, xh.std(0)),
                            self._dt))
        xp = jnp.asarray(native.empirical_gaussianize(xh), self._dt)
        return xp, theta

    @staticmethod
    def _coerce_2d(x, what="x"):
        """Shared input coercion: reject sparse explicitly, densify
        array-likes (lists, DataFrames, `__array__` wrappers) via
        np.asarray, require 2-D. Returns the coerced array."""
        if _is_sparse(x):
            raise TypeError(
                f"sparse input is not supported: Linear CorEx operates on "
                f"dense (n_samples, n_variables) arrays — densify {what} "
                f"first (e.g. X.toarray())")
        if not isinstance(x, (np.ndarray, jax.Array)):
            x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(
                f"expected a 2-D (n_samples, n_variables) array for "
                f"{what}, got shape {x.shape}. Reshape your data to 2-D "
                f"(samples in rows).")
        # dtype check reads .dtype only — applies to jax arrays too (a
        # complex device array would otherwise cast complex->real
        # silently, dropping the imaginary part)
        if np.iscomplexobj(x):
            raise ValueError(
                f"Complex data not supported: {what} must be real-valued")
        if isinstance(x, np.ndarray) and x.dtype == object:
            # numeric object arrays densify; strings raise numpy's
            # clear could-not-convert ValueError
            x = x.astype(np.float64)
        return x

    def _validate_input(self, x, for_fit=False):
        x = self._coerce_2d(x)
        shape = x.shape
        if shape[1] == 0:
            raise ValueError(
                f"0 feature(s) (shape={shape}) while a minimum of 1 is "
                f"required.")
        if for_fit and shape[0] < 2:
            raise ValueError(
                f"need at least 2 samples to fit, got n_samples={shape[0]}")
        if for_fit and shape[1] < self.m:
            import warnings
            warnings.warn(
                f"n_hidden={self.m} exceeds n_variables={shape[1]}; "
                f"surplus factors will converge to zero TC")
        # Non-finite screening is free on host arrays; on-device we skip it
        # rather than force a sync (non-finite values would surface as
        # TC=nan anyway — this just makes the failure loud and early).
        if isinstance(x, np.ndarray) and self.pre_config.missing_values \
                is None and not np.isfinite(x).all():
            raise ValueError(
                "input contains NaN/inf; pass missing_values=<sentinel> "
                "after encoding missing entries, or clean the data first")
        return x

    def _prepare_fit(self, x, plan=None, mesh=None):
        """Shared data preparation for every fit driver (`fit`,
        `fit_with_checkpoints`): input validation, host/device
        preprocessing (sets self.theta/nv/n_samples), moment-strategy
        choice, and 'auto' resolution. Returns (data, cfg, strategy)
        where `data` is the solver operand (X or the Gram matrix, bf16-cast
        when matmul_dtype='bfloat16'). `plan` (a ShardingPlan, mesh fits
        only) informs moment_strategy='auto': a sample-sharding plan
        forces the samples strategy — distributing X over the mesh is the
        point of such a plan, and a Gram operand carries no sample axis
        to shard.

        With `mesh`, the raw X is device_put per `plan.x_spec()` BEFORE
        the prepare program, which runs under the mesh with its output
        constrained to the plan's operand layout — so no full-size
        buffer (raw X, standardized X, Gram) ever materializes on one
        device, and `fit(mesh=..., plan=shard_vars)` works for p beyond
        a single device's memory (docs/SCALING.md).
        The native 'empirical' host fast path is skipped under a mesh
        (it would materialize X on the host — the sharded device path
        computes the same ranks)."""
        from linearcorex_tpu.utils.compile_cache import ensure_compile_cache
        ensure_compile_cache()
        self._partial_acc = None  # full fits are fresh: drop any
        #                           partial_fit accumulation (sklearn
        #                           convention: fit resets, partial_fit
        #                           continues)
        x = self._validate_input(x, for_fit=True)
        host = self._host_preprocess(x) if mesh is None else None
        if mesh is None:
            x = jnp.asarray(x, dtype=self._dt)
        elif not isinstance(x, jax.Array):
            # keep host input a HOST buffer: the device_put below shards
            # it H2D per the plan, so the full X never lands on one device
            x = np.asarray(x, dtype=self._dt)
        self.n_samples, self.nv = x.shape
        strategy = pick_fit_strategy(self.config, self.n_samples, self.nv,
                                     plan)
        # resolved HERE, where n is still known (a Gram operand handed
        # to fit_sharded carries no sample count)
        cfg = resolve_config(self.config, self.nv, n_samples=self.n_samples)
        # record what 'auto' resolved to (sklearn-style fitted attribute,
        # mirrored by OracleCorex.resolved_optimizer_) — config.optimizer
        # stays 'auto' so refits re-resolve against their own shapes
        self.resolved_optimizer_ = cfg.optimizer
        # preprocessing → operand (Gram / bf16 / int8 quantize, fused) is
        # ONE compiled program (_prepare_program): one dispatch and one
        # compile instead of ~10, and no intermediate X-sized device
        # copies. The bf16 cast halves the dominant per-iteration memory
        # traffic; int8 quantizes AFTER
        # preprocessing (the per-tensor scale relies on the standardized
        # columns' homogeneous range).
        if host is not None:
            xp, self.theta = host
            data, _ = _prepare_program(xp, None, strategy,
                                       self.config.matmul_dtype)
        elif mesh is not None:
            from jax.sharding import NamedSharding

            from linearcorex_tpu.parallel.sharding import (
                validate_plan_shapes)
            # raw_x=True: the device_put below shards the RAW (n, p) X
            # per x_spec even for gram strategy, so the sample-axis
            # divisibility check applies regardless of the operand
            validate_plan_shapes(plan, strategy, mesh, self.n_samples,
                                 self.nv, self.m, raw_x=True)
            x = jax.device_put(x, NamedSharding(mesh, plan.x_spec()))
            if x.dtype != self._dt:
                x = x.astype(self._dt)  # sharded cast, no gather
            with jax.set_mesh(mesh):
                data, self.theta = _prepare_program(
                    x, self.pre_config, strategy,
                    self.config.matmul_dtype, plan)
        else:
            data, self.theta = _prepare_program(
                x, self.pre_config, strategy, self.config.matmul_dtype)
        if self.config.matmul_dtype == "int8":
            M._check_int8_wrap(data)  # eager guard (host control flow)
        return data, cfg, strategy

    def _resolve_w0(self, init_ws, data=None, strategy=None):
        """Initial weights: explicit init_ws > shape-matching pretrained
        weights (constructor arg or `load_corex`; held apart from fitted
        state so repeated fit() is fresh) > fresh init per config.init
        ('random' seeded draw, or 'spectral' — which needs the prepared
        operand, so fit passes (data, strategy))."""
        if init_ws is not None:
            w0 = jnp.asarray(init_ws, dtype=self._dt)
            if w0.shape != (self.m, self.nv):
                raise ValueError(
                    f"init_ws shape {w0.shape} does not match "
                    f"(n_hidden, n_variables)=({self.m}, {self.nv})")
            return w0
        pre = self._pretrained_ws if self._pretrained_ws is not None \
            else self.pretrained_weights
        if pre is not None:
            # pretrained warm start (SURVEY.md §5); cast covers a dtype
            # changed via set_params after construction/load. Converted
            # lazily — __init__ stores the parameter verbatim.
            pre = jnp.asarray(pre, dtype=self._dt)
            if pre.shape == (self.m, self.nv):
                return pre
        if self.config.init == "spectral" and data is not None:
            # Ω follows the same seeding policy as the random init:
            # seeded → NumPy RandomState (oracle-parity-capable),
            # unseeded → fresh device entropy (no W-sized H2D transfer)
            if self.seed is None:
                key = jax.random.PRNGKey(
                    int(np.random.SeedSequence().generate_state(1)[0]))
                omega = jax.random.normal(key, (self.nv, self.m),
                                          self._dt)
            else:
                omega = jnp.asarray(
                    np.random.RandomState(self.seed).normal(
                        size=(self.nv, self.m)), self._dt)
            return _spectral_init_program(data, omega, strategy,
                                          self.config.matmul_dtype)
        # fresh init (also when refitting on data of a different width)
        return jnp.asarray(self._init_ws(self.nv), dtype=self._dt)

    def _validated_restarts(self, init_ws) -> int:
        """Validate `n_restarts` at first use (the sklearn deferred-
        validation contract — __init__/set_params store it verbatim) and
        reject the combinations a restart sweep cannot honor, by name.
        (Mesh-layout validation lives in `resolve_restart_mesh_layout`,
        the definition shared with AOT warmup.) init='spectral' sweeps
        are supported: each lane draws its own random projection
        (`_spectral_restart_inits`)."""
        import numbers
        r = self.n_restarts
        if not isinstance(r, numbers.Integral) or isinstance(r, bool) \
                or r < 1:
            raise ValueError(
                f"n_restarts must be an integer >= 1, got {r!r}")
        r = int(r)
        if r == 1:
            return 1
        if init_ws is not None or self._pretrained_ws is not None \
                or self.pretrained_weights is not None:
            raise ValueError(
                "n_restarts > 1 with an explicit warm start (init_ws / "
                "pretrained_weights / load_corex) would run identical "
                "lanes — every restart starts from the same W0. Drop the "
                "warm start, or set n_restarts=1.")
        return r

    def _spectral_restart_inits(self, data, strategy, restarts):
        """Per-lane spectral inits for a restart sweep: lane r draws its
        random projection Ω_r from RandomState(seed + r) — the restart
        seed policy applied to the spectral path, so lane 0 ≡ the plain
        spectral fit and the sweep is reproducible from one seed (the
        lanes differ through Ω, whose top-m range capture varies by
        draw — measured at cfg5: 3 of 4 seeded throughput singles land
        6-9% below the best basin, and the one-call best-of-4 sweep
        recovers it — benchmarks/RESULTS.md multi-restart note). Unseeded
        lanes draw
        device-side Ω (no Ω-sized H2D at scale, mirroring _resolve_w0);
        seeded lanes pay k host draws for reproducibility, like the
        seeded single fit. Each lane runs the SAME compiled
        `_spectral_init_program` the single fit uses — k dispatches,
        zero new cache keys (the AOT warmup's spectral variant covers
        the sweep too)."""
        from linearcorex_tpu.parallel.restarts import seed_base
        base = seed_base(self.seed)
        outs = []
        for r in range(restarts):
            if self.seed is None:
                omega = jax.random.normal(
                    jax.random.PRNGKey(base + r), (self.nv, self.m),
                    self._dt)
            else:
                omega = jnp.asarray(
                    np.random.RandomState(base + r).normal(
                        size=(self.nv, self.m)), self._dt)
            outs.append(_spectral_init_program(
                data, omega, strategy, self.config.matmul_dtype))
        return jnp.stack(outs)

    def _fit_restart_sweep(self, data, cfg, strategy, restarts,
                           mesh=None, data_axis=None, serving_plan=None):
        """n_restarts > 1: one vmapped program fits every lane, keep the
        best final TC (the reference's pick_n_hidden(repeat=k) selection
        rule, applied at fixed n_hidden — SURVEY.md §2.7/§2.8 EP row).
        Seed policy: lane r starts from RandomState(seed + r), so lane 0
        ≡ a plain Corex(seed=seed) fit and the sweep is reproducible;
        seed=None draws a fresh base per call (parallel.restarts.
        init_restarts). Measured basis (benchmarks/RESULTS.md multi-
        restart note): unseeded single fits at cfg5 hit a visibly worse
        basin ~1-in-6 (TC −12%). Every lane holds its own solver state,
        so the lane count is bounded by device memory (int8 operands
        leave the most room).

        With `mesh` the lanes shard over its RESTART_AXIS (and the
        sample rows over `data_axis` when given — the combined layout;
        `resolve_restart_mesh_layout` decided both): `parallel.restarts.
        restart_batch_runner` pads the batch to the axis size with
        duplicate last-lane inits and drops the pads, so the selected
        winner is identical to the single-device sweep's."""
        from linearcorex_tpu.parallel.restarts import (
            best_restart, init_restarts, lane_oom_guidance,
            restart_batch_runner)
        check_restart_sweep_supported(cfg, strategy)
        # one runner for both layouts (mesh=None → the single-device
        # vmapped sweep); it syncs its results under lane_oom_guidance,
        # and this outer scope additionally covers the lane-INIT
        # allocations (k Ω draws / the (k, m, p) W0 stack) and the
        # best-lane fetch — under async dispatch a device OOM can
        # surface at any of these points
        run = restart_batch_runner(mesh, RESTART_AXIS, data_axis)
        with lane_oom_guidance(restarts):
            if cfg.init == "spectral":
                w0_batch = self._spectral_restart_inits(data, strategy,
                                                        restarts)
            else:
                w0_batch = init_restarts(restarts, self.m, self.nv,
                                         self.seed, self._dt)
            ws_b, mom_b, diag_b = run(data, w0_batch, cfg, strategy,
                                      self.n_samples)
            self.ws, self.moments, self.diagnostics, best = best_restart(
                ws_b, mom_b, diag_b)
            best = int(best)  # first host fetch, inside the scope
        self.best_restart_ = best
        # combined layout: the caller's sample plan is a valid serving
        # layout on this mesh — record it like fit(mesh=...) does, so
        # fit_transform / later mesh serving calls default to it. A
        # restart-only sweep records None (its 'restarts' axis is a
        # fit-time concept; the winning lane's state comes back whole).
        self._serving_plan = serving_plan
        if self.verbose:
            self._print_verbose()
        return self

    def fit(self, x, y=None, init_ws=None, mesh=None, sharding_plan=None):
        """Fit the model. `y` is ignored (unsupervised; accepted so the
        estimator composes with sklearn Pipelines/cross-validation, which
        pass it positionally). `mesh` (a jax.sharding.Mesh) runs the
        identical annealed program sharded over the mesh's devices — the
        estimator surface's bridge to `parallel.fit_sharded`;
        `sharding_plan` (a `ShardingPlan`, default sample-sharding) maps
        the n/p/m axes onto the mesh's named axes. Learned state comes
        back replicated, so transform/predict/get_covariance work
        unchanged.

        With `n_restarts=k > 1` the fit runs k seeded lanes as ONE
        vmapped program and keeps the best final TC
        (`_fit_restart_sweep`: lane r inits from RandomState(seed + r),
        lane 0 ≡ the plain fit; `best_restart_` records the winner).
        Under `mesh=` the lanes shard over the mesh's 'restarts' axis —
        and the sample rows over its 'data' axis too when the plan
        shards samples (the combined restarts x data layout;
        `resolve_restart_mesh_layout`). init='spectral' sweeps run one
        spectral init per lane, each with its own RandomState(seed+r)
        random projection (`_spectral_restart_inits` — so
        preset='throughput' composes). The guarded combinations (warm
        starts, var/factor/slice-sharding plans, a mesh without a
        'restarts' axis) raise by name."""
        # Loud failure for the pre-0.3 positional form fit(X, W0): a
        # legitimate sklearn y has one row per sample, so a 2-D y shaped
        # exactly (n_hidden, n_variables) with the wrong row count is a
        # warm start silently landing in the ignored target slot.
        ysh = getattr(y, "shape", None)
        xsh = getattr(x, "shape", None)
        if (ysh is not None and len(ysh) == 2 and init_ws is None
                and xsh is not None and len(xsh) == 2
                and ysh == (self.n_hidden, xsh[1]) and ysh[0] != xsh[0]):
            raise TypeError(
                f"fit() received a 2-D y of shape {ysh} == (n_hidden, "
                f"n_variables) — this looks like initial weights passed "
                f"positionally under the pre-0.3 signature fit(X, "
                f"init_ws). y is the (ignored) sklearn target slot; pass "
                f"weights as fit(x, init_ws=...).")
        del y
        restarts = self._validated_restarts(init_ws)
        if mesh is not None:
            from linearcorex_tpu.parallel.sharding import (ShardingPlan,
                                                           fit_sharded)
            plan = sharding_plan or ShardingPlan()
            if restarts > 1:
                strategy_plan, data_axis = resolve_restart_mesh_layout(
                    mesh, plan)
                xsh = getattr(x, "shape", None)
                if self.config.stage_subsample < 1.0 and xsh is not None \
                        and len(xsh) == 2:
                    # raise BEFORE the sharded H2D + prepare program
                    # (minutes at scale, cold) — warmup raises
                    # pre-lowering too; _fit_restart_sweep re-checks on
                    # the validated shapes as the authoritative guard
                    check_restart_sweep_supported(
                        self.config,
                        pick_fit_strategy(self.config, xsh[0], xsh[1],
                                          strategy_plan))
                data, cfg, strategy = self._prepare_fit(
                    x, plan=strategy_plan,
                    mesh=mesh if strategy_plan is not None else None)
                if strategy != "samples":
                    # explicit moment_strategy='gram' under a sample
                    # plan: the Gram operand has no sample axis — it
                    # runs replicated (pick_fit_strategy warned)
                    data_axis = None
                return self._fit_restart_sweep(
                    data, cfg, strategy, restarts, mesh=mesh,
                    data_axis=data_axis,
                    serving_plan=plan if data_axis is not None else None)
        data, cfg, strategy = self._prepare_fit(
            x, plan=None if mesh is None else plan, mesh=mesh)
        if restarts > 1:
            return self._fit_restart_sweep(data, cfg, strategy, restarts)
        w0 = self._resolve_w0(init_ws, data=data, strategy=strategy)
        if mesh is not None:
            if stage_subsample_active(cfg, strategy):
                raise ValueError(
                    "stage_subsample < 1 is not supported under "
                    "fit(mesh=...) yet: a stride slice of the sharded "
                    "sample axis would reshard mid-fit and break the "
                    "GSPMD divisibility contract. Run the mesh fit with "
                    "stage_subsample=1, or fit single-device.")
            # check_overflow=False: _prepare_fit already ran the eager
            # int8 wrap guard on this exact operand
            self.ws, self.moments, self.diagnostics = fit_sharded(
                data, w0, cfg, mesh, plan, strategy,
                check_overflow=False)
            self._serving_plan = plan  # mesh serving calls default to it
        elif stage_subsample_active(cfg, strategy):
            self.ws, self.moments, self.diagnostics = \
                _fit_staged_subsample(data, w0, cfg, strategy)
            self._serving_plan = None
        else:
            self.ws, self.moments, self.diagnostics = _fit_program(
                data, w0, cfg, strategy)
            self._serving_plan = None  # state is single-device again
        self.best_restart_ = 0
        if self.verbose:
            self._print_verbose()
        return self

    def _print_verbose(self):
        """Reference-cadence progress output (`[U] :: Corex.fit` logging,
        SURVEY.md §3.1): one TC line every `update_iter` iterations plus a
        per-stage summary. Printed host-side from the returned diagnostics
        arrays after the single compiled fit — no extra device syncs."""
        d = self.diagnostics
        iters = np.asarray(d.iters_per_stage)
        tcs = np.asarray(d.tc_per_stage)
        deltas = np.asarray(d.delta_per_stage)
        hist = np.asarray(d.tc_history)
        step = max(1, int(self.update_iter))
        # eps labels come from the FITTED schedule snapshot, not the
        # current config — set_params(anneal=...) after fit must not
        # relabel the recorded trajectory
        for s, eps in enumerate(np.asarray(d.eps_schedule).tolist()):
            k = int(iters[s])
            if hist.shape[1]:  # record_history=True: per-iteration TC known
                for i in range(step - 1, k, step):
                    print(f"eps={eps:.4f} iter={i + 1} TC={hist[s, i]:.6f}")
            print(f"eps: {eps:.4f}, iterations: {k}, TC: {tcs[s]:.6f}, "
                  f"delta: {deltas[s]:.2e}")

    def fit_transform(self, x, y=None, mesh=None, sharding_plan=None):
        del y  # sklearn Pipeline calls fit_transform(X, y); unsupervised
        self.fit(x, mesh=mesh, sharding_plan=sharding_plan)
        if mesh is not None and sharding_plan is None \
                and self._serving_plan is None:
            # a restart-only sweep layout: the mesh carries no serving
            # axes (its 'restarts' axis is a fit-time concept) and the
            # winning lane's state is replicated — transform
            # single-device rather than demanding a serving mesh the
            # fit never used. An EXPLICIT sharding_plan is honored (and
            # fails its validation loudly) — a user who asked for
            # sharded serving must not be silently handed one device.
            return self.transform(x)
        # the fitted state already carries the plan; pass it explicitly so
        # a replicated-data plan still routes transform through the mesh
        return self.transform(x, mesh=mesh, sharding_plan=sharding_plan)

    def partial_fit(self, x, y=None, mesh=None, sharding_plan=None):
        """Incremental fit over row batches (the sklearn out-of-core
        convention, e.g. IncrementalPCA): each call folds the batch into
        an accumulated second-moment state (`utils.streaming.
        GramAccumulator` — one GEMM per batch, X never held) and
        re-solves from the accumulated correlation, warm-started from
        the current weights, so the estimator is fully usable after
        every call. `fit` resets the accumulation (fresh, per the
        sklearn contract); `partial_fit` continues it.

        `mesh=` (with an optional shard_vars `sharding_plan=`) keeps the
        accumulated p x p state row-sharded over the mesh and solves via
        `parallel.fit_sharded` — streaming + p-beyond-one-chip compose
        (see GramAccumulator). The layout binds on the FIRST call of a
        stream; later calls may omit it (the stream's layout continues),
        and passing a DIFFERENT mesh or plan mid-stream raises (by VALUE —
        rebuilding an identical mesh per call keeps working) — resharding
        a live accumulation silently would hide a wrong-mesh bug.

        Equivalent to `fit(concat(batches))` with gaussianize='standard'
        up to the W init (identical accumulated moments; the warm start
        only changes the solver trajectory — converged-TC agreement is
        pinned by tests/test_streaming.py). Cost: one warm-started
        solve per call — for accumulate-once/solve-once streaming use
        `GramAccumulator` or `fit_csv`, which this method wraps.

        Named errors: gaussianize must be an affine-'standard' mode
        (rank-based 'empirical' needs all data at once),
        missing_values is unsupported (mean-imputation needs the full
        sample matrix — `utils.streaming` has the same contract), and
        moment_strategy='samples' contradicts fitting from accumulated
        moments. Batches may be any row count >= 1; the first solve
        needs >= 2 accumulated samples."""
        del y  # unsupervised (sklearn slot)
        from linearcorex_tpu.utils.streaming import (GramAccumulator,
                                                     _solve_from_moments)
        pre = self.pre_config  # deferred validation fires here
        if pre.gaussianize != "standard":
            raise ValueError(
                f"partial_fit accumulates second moments in one streaming "
                f"pass, which only gaussianize='standard' semantics "
                f"permit (got {pre.gaussianize!r}; rank-based 'empirical' "
                f"needs all data at once)")
        if pre.missing_values is not None:
            raise ValueError(
                "partial_fit fits from accumulated second moments and "
                "cannot mean-impute missing_values (imputation needs the "
                "full sample matrix); impute each batch before the call, "
                "or use Corex.fit on the full data")
        if self.config.moment_strategy == "samples":
            raise ValueError(
                "partial_fit solves from the accumulated correlation "
                "matrix (gram strategy); moment_strategy='samples' "
                "contradicts that — use 'auto' or 'gram'")
        if self._validated_restarts(None) != 1:
            # raise by name like every other driver — each partial_fit
            # call is ONE warm-started re-solve from the accumulated
            # moments; silently ignoring the sweep would hand back a
            # single lane (round-5 review finding)
            raise ValueError(
                "n_restarts > 1 is not supported by partial_fit: each "
                "call warm-starts from the current weights, so restart "
                "lanes have no fresh seeded inits to draw. Set "
                "n_restarts=1, or run Corex(n_restarts=k).fit on the "
                "full data.")
        x = self._validate_input(x)  # >=1-row batches are legal here
        acc = getattr(self, "_partial_acc", None)
        expect = acc.p if acc is not None else getattr(self, "nv", None)
        if expect is not None and x.shape[1] != expect:
            # covers both the mid-stream width change AND a new stream on
            # an estimator fit on different-width data — sklearn expects
            # n_features consistency with the fitted state, and silently
            # refitting from scratch would absorb a wrong-dataset bug
            raise ValueError(
                f"partial_fit batch has {x.shape[1]} variables; the "
                f"{'accumulated' if acc is not None else 'fitted'} state "
                f"has {expect} (use a fresh estimator — sklearn.clone — "
                f"to change the width)")
        if acc is not None and (
                (mesh is not None and mesh != acc.mesh)
                or (sharding_plan is not None
                    and sharding_plan != acc.plan)):
            # mesh equality, not identity: rebuilding an identical mesh
            # per call (a natural streaming pattern) must keep working —
            # jax.sharding.Mesh defines value equality; ShardingPlan is a
            # frozen dataclass
            raise ValueError(
                "partial_fit received a different mesh/sharding_plan "
                "mid-stream; the accumulation layout binds on the first "
                "call (resharding a live p x p accumulation silently "
                "would hide a wrong-mesh bug) — finish the stream, or "
                "start a fresh one (fit resets, or use a new estimator)")
        if acc is None:
            acc = GramAccumulator(x.shape[1], dtype=str(jnp.dtype(self._dt)),
                                  mesh=mesh, sharding_plan=sharding_plan)
        # _validate_input already NaN-screened host arrays; on the
        # single-device path hand the accumulator a device array so
        # update() does not repeat the identical O(n·p) host scan (it
        # transfers H2D either way). On the MESH path keep the batch
        # host-side: update() device_puts it per-shard, and a jnp.asarray
        # here would land the whole batch on one device first (the repeat
        # host cast there is the price of the sharded H2D)
        acc.update(jnp.asarray(x, acc.dtype)
                   if isinstance(x, np.ndarray) and acc.mesh is None
                   else x)
        self._partial_acc = acc  # commit before solving: the batch is
        #                          folded in even if this call cannot
        #                          solve yet (n=1 below)
        if acc.n_samples < 2:
            import warnings
            warnings.warn(
                "partial_fit has accumulated a single sample; the first "
                "solve needs >= 2. The batch is retained — the next "
                "partial_fit call will fit.")
            return self
        warm = getattr(self, "ws", None)
        if warm is not None and (warm.shape != (self.m, acc.p)):
            warm = None  # stale shape (e.g. n_hidden changed via set_params)
        elif warm is not None and acc.mesh is None:
            # a mesh fit / mesh serving leaves ws committed to mesh
            # devices; the single-device solve program would reject
            # mixed-device arguments — uncommit via host round-trip
            # (m x p, small). The MESH solve skips the round-trip (a
            # needless full-W D2H gather per call):
            # fit_sharded device_puts w0 per its w_spec, which moves a
            # committed array across meshes too
            warm = np.asarray(warm)
        corr, mean, std = acc._moments()
        _solve_from_moments(self, corr, mean, std, acc.n_samples,
                            init_ws=warm, mesh=acc.mesh, plan=acc.plan)
        if self.verbose:
            self._print_verbose()
        return self

    def warmup(self, n_samples, n_variables, mesh=None,
               sharding_plan=None):
        """Ahead-of-time compile of the fit program for declared input
        shapes (no data; `utils.compile_cache.warmup_fit`). With the
        persistent compile cache (on by default), the first real
        `fit(X)` on matching shapes reuses the artifact instead of
        paying the first-call compile wait. Returns self."""
        from linearcorex_tpu.utils.compile_cache import warmup_fit
        warmup_fit(self, n_samples, n_variables, mesh=mesh,
                   sharding_plan=sharding_plan)
        return self

    # ------------------------------------------------------------------
    def _check_fitted(self):
        if self.ws is None or self.moments is None:
            _raise_not_fitted(
                "this Corex instance is not fitted yet; call fit(X) first")

    def _check_width(self, x, what="x", coerced=False):
        if not coerced:
            x = self._coerce_2d(x, what=what)
        if x.shape[1] != self.nv:
            raise ValueError(
                f"{what} must be 2-D with {self.nv} columns (the fitted "
                f"n_variables); got shape {x.shape}")
        return x

    def _to_dt(self, a):
        """Model-dtype cast that never stages a host array on one device:
        NumPy input casts host-side (the mesh serving path device_puts it
        straight into its sharded layout afterwards)."""
        if isinstance(a, jax.Array):
            return a.astype(self._dt) if a.dtype != self._dt else a
        return np.asarray(a, dtype=self._dt)

    def _serving_mesh(self, mesh, sharding_plan, n_rows):
        """Resolve the serving layout for an inference call under `mesh`
        and move the FITTED state onto it per the plan — the inference
        side of the mesh-aware prepare (round 4 made `fit(mesh=...,
        plan=shard_vars)` reachable for p beyond one device's memory; this
        makes the fitted model SERVE in the same regime, with no p-sized
        buffer required to live on one device: `transform`/`score` shard
        the incoming X per the plan, `predict` shards its (n, p) output,
        and the m x p state shards over VAR_AXIS). State placement
        follows `serving_state_specs` — the single definition shared
        with `warmup_serving(mesh=...)`.

        `sharding_plan=None` REUSES the model's current plan (the last
        mesh fit's or mesh serving call's), not the DP default: a
        var-sharded model must not be silently replicated — at the scale
        shard_vars exists for, replicating the m x p state per device is
        an OOM, and resharding every call would defeat the zero-cost
        steady state. Pass an explicit plan to deliberately relay out.

        The sharded state is stored back on the estimator: `device_put`
        of an already-resident array is a no-op, so repeated serving
        calls pay zero placement cost (`load_corex` → first sharded call
        pays the one host→mesh transfer).

        Returns (plan, put) with put(array, spec) committing an operand
        to the mesh."""
        from jax.sharding import NamedSharding

        from linearcorex_tpu.parallel.sharding import (ShardingPlan,
                                                       validate_plan_shapes)

        plan = sharding_plan or self._serving_plan or ShardingPlan()
        validate_plan_shapes(plan, "samples", mesh, n_rows, self.nv,
                             self.ws.shape[0], raw_x=True)

        def put(a, spec):
            return jax.device_put(a, NamedSharding(mesh, spec))

        specs = serving_state_specs(plan)
        self.ws = put(self.ws, specs["ws"])
        mom = self.moments
        self.moments = mom._replace(
            rhoinvrho=put(mom.rhoinvrho, specs["rhoinvrho"]),
            si=put(mom.si, specs["si"]),
            z2=put(mom.z2, specs["z2"]),
            cy=put(mom.cy, specs["cy"]),
            c_xy=put(mom.c_xy, specs["c_xy"]))
        self.theta = P.Theta(mean=put(self.theta.mean, specs["theta"]),
                             std=put(self.theta.std, specs["theta"]))
        self._serving_plan = plan
        return plan, put

    def _serving_operand(self, a, which, mesh, sharding_plan, n_rows):
        """Shared dispatch step of every serving method: under a mesh,
        place the fitted state (`_serving_mesh`) and commit the input per
        the plan's `which` spec ('x' | 'y' | 'v' | 'v2'); without one,
        the input lands on the default device. Returns (operand, context)
        — run the program inside the context (jax.set_mesh under a mesh,
        matching the warmup's lowering scope)."""
        if mesh is None:
            return jnp.asarray(a, dtype=self._dt), contextlib.nullcontext()
        plan, put = self._serving_mesh(mesh, sharding_plan, n_rows)
        spec = {"x": plan.x_spec, "y": plan.y_spec, "v": plan.v_spec,
                "v2": lambda: plan.v_spec(ndim=2)}[which]()
        return put(self._to_dt(a), spec), jax.set_mesh(mesh)

    def transform(self, x, details=False, mesh=None, sharding_plan=None):
        """Project to factors: Y = X_preproc·Wᵀ (`[U] :: Corex.transform`).
        Under `set_output(transform='pandas')` the plain (details=False)
        return is a DataFrame with `get_feature_names_out` columns; the
        details path always returns raw arrays.

        `mesh` (+ optional `sharding_plan`, default sample-sharding) runs
        the identical program sharded over the mesh — the serving
        companion to `fit(mesh=...)`: X is device_put per the plan and the
        fitted state per its axis roles, so `plan=ShardingPlan(
        shard_vars=True)` serves p beyond one device's memory (the output Y is
        n x m, sharded over the sample axes). Verified equivalent to the
        single-device call on the CPU mesh (tests/test_sharding.py).

        gaussianize='empirical' is BATCH-RELATIVE at transform time: the
        new batch is re-ranked against itself, norm.ppf((rank-0.5)/n_batch)
        — matching the oracle and the reference's `preprocess(x,
        fit=False)` [MED] semantics (docs/API.md pins this). The hazardous
        edge is guarded: a 1-row batch would map every value to
        ndtri(0.5) = 0.0 exactly (all-zero factors, silently), so it
        raises; small batches warn (coarse n_batch-quantile resolution).
        For single-row serving use an affine mode ('standard'/'outliers')
        or transform rows together with reference data."""
        self._check_fitted()
        x_orig = x  # pre-coercion input: carries the DataFrame index
        x = self._check_width(x)
        if self.pre_config.gaussianize == "empirical":
            n_batch = x.shape[0]
            if n_batch == 1:
                raise ValueError(
                    "transform of a single row with gaussianize="
                    "'empirical' is ill-defined: the batch-relative rank "
                    "transform maps every value to ndtri(0.5) = 0.0 "
                    "exactly, returning all-zero factors. Transform rows "
                    "in batches, or refit with an affine mode "
                    "('standard'/'outliers') for single-row serving.")
            if n_batch < 20:
                import warnings
                warnings.warn(
                    f"transform batch of {n_batch} rows with gaussianize="
                    f"'empirical': ranks are batch-relative, so quantiles "
                    f"resolve only to 1/{n_batch} — factor values will be "
                    f"coarse. Larger batches (or an affine gaussianize "
                    f"mode) give stable transforms.")
        if isinstance(x, np.ndarray) and self.pre_config.missing_values \
                is None and not np.isfinite(x).all():
            raise ValueError(
                "input to transform contains NaN/inf; pass "
                "missing_values=<sentinel> or clean the data first")
        x, ctx = self._serving_operand(x, "x", mesh, sharding_plan,
                                       x.shape[0])
        with ctx:
            if details:
                y, mom = _details_program(x, self.ws, self.theta,
                                          self.pre_config, self.config)
                return y, mom.asdict()
            z = _transform_program(x, self.ws, self.theta, self.pre_config)
        return self._maybe_wrap_output(z, x_orig)

    def predict(self, y, mesh=None, sharding_plan=None):
        """Reconstruct variables from factors (`[U] :: Corex.predict`):
        posterior-mean reconstruction, then invert preprocessing. Note the
        reference semantics: the argument is the FACTOR matrix (n, m) from
        `transform`, not raw data — `inverse_transform` is the sklearn
        spelling of the same operation.

        `mesh` (+ optional `sharding_plan`) reconstructs under the mesh:
        the (n, p) output — the big buffer here — shards over the plan's
        sample/variable axes, so reconstruction works for p beyond one
        device's memory (`shard_vars=True`)."""
        self._check_fitted()
        y = self._coerce_2d(y, what="y")
        # validate against the FITTED factor count (ws.shape[0]), not the
        # mutable n_hidden parameter — set_params(n_hidden=...) after fit
        # must not make the correct factors un-predictable
        m_fit = self.ws.shape[0]
        if y.shape[1] != m_fit:
            raise ValueError(
                f"y must be 2-D with {m_fit} columns (the fitted "
                f"n_hidden); got shape {y.shape}")
        if isinstance(y, np.ndarray) and not np.isfinite(y).all():
            raise ValueError(
                "factor input to predict contains NaN/inf")
        y, ctx = self._serving_operand(y, "y", mesh, sharding_plan,
                                       y.shape[0])
        with ctx:
            if self.config.discourage_overlap:
                mom = self.moments
                return _predict_ns_program(y, mom.rhoinvrho, mom.si,
                                           mom.z2, self.theta)
            return _predict_overlap_program(y, self.moments.cy,
                                            self.moments.c_xy, self.theta)

    def inverse_transform(self, y, mesh=None, sharding_plan=None):
        """sklearn spelling of `predict`: map factors (n, m) back to the
        variable space (n, p). Enables `Pipeline.inverse_transform`."""
        return self.predict(y, mesh=mesh, sharding_plan=sharding_plan)

    def get_covariance(self):
        """Dense p x p factor-model covariance estimate
        (`[U] :: Corex.get_covariance`, SURVEY.md §3.4). For very large p
        prefer `covariance_matvec`, which never materializes p x p.

        Raises by name on var-sharded state (a mesh fit or serving call
        with ShardingPlan(shard_vars=True)): that plan exists exactly
        because p-sized-squared buffers cannot live on one device, so a
        dense p x p export is the OOM the plan was chosen to avoid — use
        `covariance_blocks(mesh=...)` (sharded row blocks) or
        `covariance_matvec`/`covariance_matmat(mesh=...)` (apply without
        materializing). Other plans (sample/factor sharding) keep the
        dense export: the result is p x p on one device, which those
        plans' scales admit (pinned in tests/test_sharding.py)."""
        self._check_fitted()
        if self._serving_plan is not None and self._serving_plan.shard_vars:
            raise ValueError(
                "get_covariance() on var-sharded state (the model was fit "
                "or served under ShardingPlan(shard_vars=True)): the dense "
                "p x p export would materialize exactly the buffer the "
                "plan shards away. Use covariance_blocks(mesh=...) for "
                "dense row blocks per the plan, or covariance_matvec/"
                "covariance_matmat(mesh=...) to apply Σ̂ without "
                "materializing it.")
        mom = self.moments
        if self.config.discourage_overlap:
            return _cov_ns_program(mom.rhoinvrho, mom.si, self.theta.std)
        return _cov_overlap_program(mom.cy, mom.c_xy, self.theta.std)

    def score(self, x, y=None, mesh=None, sharding_plan=None):
        """Mean Gaussian log-likelihood of `x` under the fitted factor
        covariance N(mean, Σ̂) — the sklearn scoring convention (higher is
        better; `y` is accepted and ignored, as cross-validation passes it
        positionally), making the estimator usable with cross-validation
        and grid search. Computed via Woodbury on the diagonal-plus-low-rank
        structure of Σ̂ (O(n·p·m); the p x p never materializes), exactly
        consistent with `get_covariance` on both solver paths.

        Only affine preprocessing modes carry a tractable density back to
        the original data scale, so gaussianize must be 'none' or
        'standard' (the rank-based 'empirical' and clipped 'outliers'
        transforms have non-affine Jacobians)."""
        del y
        self._check_fitted()
        if self.pre_config.gaussianize not in ("none", "standard"):
            raise ValueError(
                "score() requires gaussianize='none' or 'standard': the "
                "'empirical'/'outliers' transforms are non-affine, so a "
                "density on the original scale is not defined by Σ̂ alone")
        x = self._validate_input(x)
        x = self._check_width(x, coerced=True)
        x, ctx = self._serving_operand(x, "x", mesh, sharding_plan,
                                       x.shape[0])
        mom = self.moments
        with ctx:
            if self.config.discourage_overlap:
                return _score_ns_program(x, mom.rhoinvrho, mom.si,
                                         self.theta, self.pre_config)
            return _score_overlap_program(x, mom.cy, mom.c_xy, self.theta,
                                          self.pre_config)

    def covariance_matvec(self, v, mesh=None, sharding_plan=None):
        """Σ̂·v via skinny GEMMs — the blocked/matvec form required at
        p=100k where dense p x p is 40 GB (SURVEY.md §3.4 note). Matches
        `get_covariance` exactly on both solver paths: the non-overlap
        factorization Z = rhoinvrho/(1+S_i), or the m x m-solve form
        C_xy·C_y⁻¹·C_xyᵀ for overlap (discourage_overlap=False) models.
        `mesh` (+ `sharding_plan`, typically shard_vars) applies the
        operator sharded — the export path for p beyond one chip."""
        self._check_fitted()
        if not hasattr(v, "ndim"):
            v = np.asarray(v)
        if v.ndim != 1 or v.shape[0] != self.nv:
            raise ValueError(
                f"v must be 1-D with {self.nv} entries (the fitted "
                f"n_variables); got shape {getattr(v, 'shape', None)} — "
                f"use covariance_matmat for (p, k) blocks")
        v, ctx = self._serving_operand(v, "v", mesh, sharding_plan, None)
        mom = self.moments
        with ctx:
            if self.config.discourage_overlap:
                return _matvec_ns_program(mom.rhoinvrho, mom.si,
                                          self.theta.std, v)
            return _matvec_overlap_program(mom.cy, mom.c_xy,
                                           self.theta.std, v)

    def covariance_matmat(self, v, mesh=None, sharding_plan=None):
        """Σ̂·V for a (p, k) block of vectors — the block generalization of
        `covariance_matvec` (SURVEY.md §3.4 note):
        k columns cost one skinny-GEMM pass instead of k matvec dispatches,
        and the p x p never materializes. Matches `get_covariance` exactly
        on both solver paths (tests/test_api.py). `mesh` as in
        `covariance_matvec`."""
        self._check_fitted()
        if not hasattr(v, "ndim"):
            v = np.asarray(v)
        if v.ndim != 2 or v.shape[0] != self.nv:
            raise ValueError(
                f"v must be 2-D with {self.nv} rows (the fitted "
                f"n_variables); got shape {getattr(v, 'shape', None)}")
        v, ctx = self._serving_operand(v, "v2", mesh, sharding_plan, None)
        mom = self.moments
        with ctx:
            if self.config.discourage_overlap:
                return _matmat_ns_program(mom.rhoinvrho, mom.si,
                                          self.theta.std, v)
            return _matmat_overlap_program(mom.cy, mom.c_xy,
                                           self.theta.std, v)

    def _factor_z(self):
        """The shared covariance factorization Z (m x p): Σ̂_std has
        off-diagonal ZᵀZ and unit diagonal, on either solver path."""
        mom = self.moments
        if self.config.discourage_overlap:
            return _factor_z_ns(mom.rhoinvrho, mom.si)
        return _factor_z_overlap(mom.cy, mom.c_xy)

    def covariance_blocks(self, block_size: int = 4096, mesh=None,
                          sharding_plan=None):
        """Yield `(start, rows)` dense row blocks of `get_covariance()`
        without ever materializing the p x p matrix — the export path for
        very large p (at p=100k dense Σ̂ is 40 GB; a 4096-row block is
        1.6 GB). Blocks tile [0, p) in order;
        `rows` has shape (min(block_size, p-start), p). One compiled
        program serves every block (the final partial block is computed as
        the tail slice of a full-size block), so the export costs one
        compile + ceil(p/block_size) dispatches. Rows agree with
        `get_covariance` to fp rounding on both solver paths.

        `mesh` (+ optional `sharding_plan`, typically shard_vars) runs
        the block program sharded — SURVEY.md §3.4's Σ̂-row export in the
        p-beyond-one-chip regime `fit(mesh=..., shard_vars)` opened:
        the fitted state commits per
        `serving_state_specs` and each yielded block is a global (b, p)
        array whose columns stay sharded over VAR_AXIS — reduce or
        consume it on-device per shard; pulling a block to host gathers
        it. Bit-comparable to the single-device export on the CPU mesh
        (tests/test_sharding.py)."""
        self._check_fitted()
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        p = self.nv
        b = min(block_size, p)
        plan = put = None
        if mesh is not None:
            plan, put = self._serving_mesh(mesh, sharding_plan, None)
        # the mesh context is entered PER DISPATCH, never held across a
        # yield — a generator holding jax.set_mesh open would leak the
        # global mesh scope into whatever the consumer runs between blocks
        def ctx():
            return (jax.set_mesh(mesh) if mesh is not None
                    else contextlib.nullcontext())
        with ctx():
            z = self._factor_z()
        if put is not None:
            # commit z to the layout `warmup_serving` declares (the
            # rhoinvrho spec). The NS path's eager z = rhoinvrho/(1+si)
            # already lands there (this device_put is a no-op), but the
            # OVERLAP path's solve_triangular output commits REPLICATED —
            # without the re-commit the real dispatch lowers a different
            # module than the warmup and the AOT compile is wasted (the
            # round-4 cache-key rule; pinned per solver path by the
            # module-text identity test in tests/test_sharding.py)
            z = put(z, serving_state_specs(plan)["rhoinvrho"])
        start = 0
        while start < p:
            s = min(start, p - b)
            # strongly-typed int32 start so the call's jit key matches the
            # warmup_serving lowering (a bare Python int traces weakly);
            # created OUTSIDE the mesh scope so it stays UNCOMMITTED —
            # an eager scalar under set_mesh commits a replicated
            # sharding, annotating the module and missing the warmup's
            # sharding-less declaration (the round-4 cache-key rule)
            s_arg = jnp.asarray(s, jnp.int32)
            with ctx():
                rows = _cov_rows_program(z, self.theta.std, s_arg, b)
                tail = rows[start - s:]
            yield start, tail
            start = s + b

    # -- sklearn estimator protocol (works inside sklearn Pipelines) -----
    _PARAM_NAMES = (
        "n_hidden", "max_iter", "tol", "anneal", "missing_values",
        "discourage_overlap", "gaussianize", "gpu", "y_scale",
        "update_iter", "pretrained_weights", "verbose", "seed", "dtype",
        "moment_strategy", "record_history", "matmul_dtype",
        "matmul_precision", "optimizer", "momentum_beta", "init", "preset",
        "stage_tol_factor", "stage_subsample", "n_restarts")

    def get_params(self, deep=True):
        """Every constructor argument, verbatim (sklearn protocol; the
        attribute IS the parameter, so `clone` identity checks hold)."""
        return {k: getattr(self, k) for k in self._PARAM_NAMES}

    def __sklearn_tags__(self):
        """sklearn >=1.6 estimator-tags hook. Imported lazily: only
        sklearn itself calls this, so the import cannot fail in
        sklearn-free environments (sklearn stays an optional integration,
        not a dependency). Declares an unsupervised 2-D transformer;
        allow_nan reflects whether the missing marker is NaN (mean
        imputation, SURVEY.md §2.2)."""
        from sklearn.utils import (InputTags, Tags, TargetTags,
                                   TransformerTags)
        mv = self.missing_values
        return Tags(
            estimator_type="transformer",
            target_tags=TargetTags(required=False),
            transformer_tags=TransformerTags(preserves_dtype=[]),
            input_tags=InputTags(two_d_array=True,
                                 allow_nan=mv is not None and mv != mv),
            non_deterministic=self.seed is None,
        )

    def __sklearn_is_fitted__(self):
        """sklearn `check_is_fitted` hook."""
        return self.ws is not None and self.moments is not None

    @property
    def n_features_in_(self):
        """sklearn convention for the fitted input width (== `nv`)."""
        if self.nv is None:
            raise AttributeError(
                "n_features_in_ is not available: this Corex instance is "
                "not fitted yet")
        return self.nv

    @property
    def n_iter_(self):
        """sklearn convention: total solver iterations of the last fit
        (summed over anneal stages). Computed lazily from the on-device
        diagnostics — fit itself stays a single compiled program with no
        extra host sync."""
        if self.diagnostics is None:
            raise AttributeError(
                "n_iter_ is not available: this Corex instance is not "
                "fitted yet")
        return int(np.sum(np.asarray(self.diagnostics.iters_per_stage)))

    def get_feature_names_out(self, input_features=None):
        """sklearn convention: names of the transform outputs, one per
        FITTED factor (`corex0`..`corex{m-1}` — the class-name-prefix
        scheme). `input_features`, when given, must match the fitted
        width; factor names do not derive from input names."""
        self._check_fitted()
        if input_features is not None \
                and len(input_features) != self.nv:
            raise ValueError(
                f"input_features should have length equal to "
                f"n_features_in_ ({self.nv}), got {len(input_features)}")
        m_fit = self.ws.shape[0]
        return np.asarray([f"corex{i}" for i in range(m_fit)],
                          dtype=object)

    def set_output(self, *, transform=None):
        """sklearn set_output API (self-contained — no sklearn import):
        `transform='pandas'` makes `transform`/`fit_transform` return a
        DataFrame with `get_feature_names_out` columns (index preserved
        from DataFrame inputs); `'default'` restores arrays; None leaves
        the setting unchanged. `Pipeline.set_output` calls this on every
        step."""
        if transform is None:
            return self
        if transform not in ("default", "pandas"):
            raise ValueError(
                f"set_output transform must be 'default' or 'pandas', "
                f"got {transform!r}")
        self._output_transform = None if transform == "default" \
            else transform
        return self

    def _maybe_wrap_output(self, z, x_orig):
        if getattr(self, "_output_transform", None) != "pandas":
            return z
        import pandas as pd
        index = x_orig.index if hasattr(x_orig, "index") \
            and hasattr(x_orig, "columns") else None
        return pd.DataFrame(np.asarray(z),
                            columns=self.get_feature_names_out(),
                            index=index)

    def set_params(self, **params):
        """Update hyperparameters in place (sklearn contract: parameters
        only — fitted state, pretrained weights, and diagnostics are
        preserved; value validation is deferred to first use, like
        __init__)."""
        for k in params:
            if k not in self._PARAM_NAMES:
                raise ValueError(f"invalid parameter {k!r} for Corex")
        for k, v in params.items():
            setattr(self, k, v)
        return self

    # ------------------------------------------------------------------
    def __repr__(self):
        # reads the RAW parameters, never the validating config/pre_config
        # properties: a repr must not raise, and sklearn renders estimator
        # reprs inside its own error messages — including for estimators
        # holding a deferred-invalid parameter
        fitted = "" if self.ws is None else (
            f", fitted: nv={self.nv}, n_samples={self.n_samples}, "
            f"tc={self.tc:.4f}")
        return (f"Corex(n_hidden={self.n_hidden}, "
                f"discourage_overlap={self.discourage_overlap}, "
                f"gaussianize={self.gaussianize!r}, "
                f"optimizer={self.optimizer!r}, dtype={self.dtype!r}"
                f"{fitted})")

    @property
    def tcs(self):
        """Per-factor total correlation (sorted decreasing)."""
        return self.moments.tcs

    @property
    def tc(self):
        return float(jnp.sum(self.moments.tcs))

    @property
    def mis(self):
        """MI matrix I(x_i; y_j), shape (m, p)."""
        return self.moments.mi

    @property
    def clusters(self):
        """Hard assignment of each variable to argmax_j I(x_i; y_j)."""
        return jnp.argmax(self.moments.mi, axis=0)

    @property
    def history(self):
        """Reference-style history dict reconstructed from the on-device
        diagnostics (one host sync here, by explicit user request)."""
        if self.diagnostics is None:
            raise RuntimeError(
                "no fit diagnostics available; call fit(X) first")
        d = self.diagnostics
        iters = np.asarray(d.iters_per_stage)
        out = {"iters_per_stage": iters,
               "TC": [], "eps": []}
        # the schedule the fit RAN (snapshotted into the diagnostics), so
        # post-fit set_params cannot mislabel/truncate the trajectory
        schedule = np.asarray(d.eps_schedule).tolist()
        hist = np.asarray(d.tc_history)
        for s, eps in enumerate(schedule):
            k = int(iters[s])
            if hist.shape[1]:
                out["TC"].extend(hist[s, :k].tolist())
                out["eps"].extend([eps] * k)
        return out

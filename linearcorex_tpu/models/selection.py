"""Model selection: `pick_n_hidden` (SURVEY.md §2.7, layer L6).

Parity anchor: `[U] linearcorex/linearcorex.py :: pick_n_hidden` — fit Corex
for increasing n_hidden with `repeat` random restarts each (keep the best
TC), stop when additional factors stop increasing TC; return the chosen n.

Difference by design (SURVEY.md §3.5: "rebuild as vmapped batched solves"):
the WHOLE scan — every (n_hidden candidate, restart) pair — is one compiled
program. Candidates share the padded factor axis max_n_hidden; candidate
nh's initial weights zero the surplus rows, and zero rows are an invariant
of the solver (their gradient is exactly zero: rho=0 ⇒ aa row = 0,
hmat/coef contributions = 0 — the same mechanism by which surplus factors
die to zero TC, tests/test_robustness.py) and contribute 0 to TCs and a
constant to the objective, so the padded fit reproduces the dedicated
nh-factor fit's trajectory for the active rows (bit-exact in float64; in
float32 the wider GEMM's tiling introduces rounding-level divergence).
The win scales with per-candidate compile cost, the price is max_n/nh
extra FLOPs per candidate; its H100 wall against the sequential loop is
not measured yet.

The one semantic difference vs per-candidate fits: the nh=1 candidate rides
the shared multi-factor anneal schedule (a dedicated n_hidden=1 fit skips
annealing); annealing only smooths the landscape, so its best-restart TC is
unchanged or better. Set padded_sweep=False for the reference's sequential
per-candidate loop (early-stops on saturation; one compile per candidate).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from linearcorex_tpu.config import CorexConfig, PreprocessConfig
from linearcorex_tpu.models.corex import (Corex, _prepare_program,
                                          pick_fit_strategy)
from linearcorex_tpu.ops import moments as M
from linearcorex_tpu.ops import preprocessing as P
from linearcorex_tpu.parallel.restarts import (init_restarts,
                                               restart_batch_runner,
                                               seed_base)

__all__ = ["pick_n_hidden", "warmup_sweep"]

_DATA_AXIS_NEEDS_MESH = (
    "data_axis shards the sample rows over a mesh axis — pass "
    "mesh= too (make_mesh(((restart_axis, a), (data_axis, b))))")


def _sweep_cfg_and_strategy(n: int, p: int, max_n_hidden: int, dtype: str,
                            data_axis: Optional[str], corex_kwargs: dict):
    """(sweep CorexConfig, moment strategy) for the padded sweep — the ONE
    definition of the compiled program's static key, shared by
    `pick_n_hidden` and `warmup_sweep` (a forked copy would let warmup
    compile a cache entry the real sweep never hits, silently defeating
    AOT warmup — the same rule CLAUDE.md pins for warmup_fit). The
    strategy choice delegates to `models.corex.pick_fit_strategy` — the
    single plan-aware policy — by expressing `data_axis` as the
    sample-sharding plan it is; an EXPLICIT 'gram' request with a data
    axis raises here (a Gram operand has no sample axis to shard —
    `fit_restarts_sharded` rejects the combination, so a warmup must
    too, not silently compile a program the sweep can never dispatch).
    `corex_kwargs` must already exclude the preprocessing-only kwargs
    (gaussianize/missing_values) and record_history (sweeps force it
    off)."""
    if "n_restarts" in corex_kwargs:
        # the confusable pair: the sweep's restart count is `repeat=`
        # (the reference's pick_n_hidden(repeat=k) spelling); n_restarts
        # is the fixed-n_hidden estimator knob and CorexConfig would
        # reject it with an unhelpful TypeError
        raise TypeError(
            "the selection sweep (pick_n_hidden / warmup_sweep) runs "
            "its own restart lanes — pass repeat=k (the per-candidate "
            "restart count), not n_restarts= (the fixed-n_hidden Corex "
            "knob).")
    probe = CorexConfig(n_hidden=1, dtype=dtype, record_history=False,
                        **corex_kwargs)
    if probe.init == "spectral":
        # the sweep hands the solver explicit padded init stacks
        # (_padded_inits / init_restarts), so cfg.init never resolves a
        # W0 here — honoring the repo rule (raise by name, never
        # silently ignore a requested knob)
        raise ValueError(
            "init='spectral' is not supported by the selection sweep "
            "(pick_n_hidden / warmup_sweep): it draws its own seeded "
            "random init per (candidate, restart) lane, so the spectral "
            "init would be silently ignored. Drop init from the sweep "
            "kwargs, or run Corex(init='spectral', n_restarts=k) at a "
            "fixed n_hidden (spectral restart lanes are supported "
            "there).")
    plan = None
    if data_axis is not None:
        if probe.moment_strategy == "gram":
            raise ValueError(
                "data_axis shards the SAMPLE rows of X; a Gram operand "
                "carries none — the combined restarts x data layout is "
                "samples-strategy only (drop data_axis, or use "
                "moment_strategy='auto'/'samples')")
        from linearcorex_tpu.parallel.sharding import ShardingPlan
        plan = ShardingPlan(shard_samples=True)
    strategy = pick_fit_strategy(probe, n, p, plan)
    cfg = CorexConfig(n_hidden=max_n_hidden, dtype=dtype,
                      record_history=False, **corex_kwargs)
    return cfg, strategy


def _padded_inits(max_n: int, repeat: int, p: int, seed: Optional[int],
                  dtype):
    """(max_n*repeat, max_n, p) init stack: candidate k (n_hidden=k+1),
    restart r is RandomState(base+r).normal(size=(max_n, p)) with rows
    >= k+1 zeroed. NumPy fills row-major, so the active rows are bit-equal
    to the dedicated init_restarts(repeat, k+1, p, seed) draw."""
    import jax.numpy as jnp

    base = seed_base(seed)
    full = np.stack([
        np.random.RandomState(base + r).normal(
            loc=0.0, scale=1.0 / np.sqrt(p), size=(max_n, p))
        for r in range(repeat)
    ])                                                  # (repeat, max_n, p)
    mask = (np.arange(max_n)[None, :] <= np.arange(max_n)[:, None])
    # (max_n, repeat, max_n, p): candidate-major so tc reshapes cleanly
    w0 = full[None, :, :, :] * mask[:, None, :, None]
    return jnp.asarray(w0.reshape(max_n * repeat, max_n, p), dtype=dtype)


def _smallest_within_tol(scores, tol: float) -> int:
    """Parsimony rule for the held-out criterion: the SMALLEST n_hidden
    whose score is within `tol` of the best. The non-overlap solver kills
    surplus factors (they converge to exactly zero), so past the supported
    model size the held-out likelihood plateaus rather than declining —
    a bare argmax would pick the largest candidate by float noise.
    Non-finite candidate scores (a diverged fit) are excluded; all-
    non-finite raises instead of silently returning n_hidden=1."""
    scores = np.asarray(scores)
    if not np.isfinite(scores).any():
        raise ValueError(
            "every candidate's held-out score is non-finite — the fits "
            "diverged; check the data and tolerance")
    best = np.nanmax(np.where(np.isfinite(scores), scores, -np.inf))
    ok = np.isfinite(scores) & (scores >= best - tol)
    return int(np.argmax(ok)) + 1


def _best_n_from_scores(scores, tc_gain_tol: float) -> int:
    """The reference's saturation rule over the score curve, INCLUDING its
    early stop: scanning in order, a candidate that improves best-so-far TC
    by more than tc_gain_tol becomes best; two consecutive non-improving
    candidates end the scan. Applying the identical rule here keeps the
    padded sweep's best_n equal to the sequential loop's on any score
    curve (a later rebound past the stop point is ignored by BOTH paths)."""
    best_n, best_tc = 1, -np.inf
    for k, tc in enumerate(scores, start=1):
        if tc > best_tc + tc_gain_tol:
            best_tc, best_n = tc, k
        elif k > best_n + 1:
            break
    return best_n


@functools.lru_cache(maxsize=None)
def _heldout_scorer(overlap: bool):
    """Jitted vmapped scorer: mean Gaussian log-likelihood of the
    (preprocessed) validation rows under each batched model's factor
    covariance, via the same Woodbury form `Corex.score` uses. Computed in
    the standardized space (the affine-Jacobian constant is identical
    across candidates, so rankings are unaffected). Padded candidates
    score correctly as-is: dead surplus factors have rhoinvrho rows ~0 and
    contribute nothing to ZᵀZ.

    lru_cached per overlap flag: a fresh jax.jit wrapper per call would
    defeat the jit dispatch cache and recompile the scorer once per
    candidate on the sequential (padded_sweep=False) path."""
    import jax
    import jax.numpy as jnp

    from linearcorex_tpu.models.corex import (_factor_z_ns,
                                              _factor_z_overlap,
                                              _gaussian_ll)

    if not overlap:
        def one(xv, rr, si):
            return _gaussian_ll(xv, _factor_z_ns(rr, si),
                                jnp.ones((1,), xv.dtype))
    else:
        def one(xv, cy, c_xy):
            return _gaussian_ll(xv, _factor_z_overlap(cy, c_xy),
                                jnp.ones((1,), xv.dtype))
    return jax.jit(jax.vmap(one, in_axes=(None, 0, 0)))


def _score_batch(xv, mom_b, overlap: bool):
    scorer = _heldout_scorer(overlap)
    if not overlap:
        return np.asarray(scorer(xv, mom_b.rhoinvrho, mom_b.si))
    return np.asarray(scorer(xv, mom_b.cy, mom_b.c_xy))


def _restart_batch_runner(mesh, restart_axis: str,
                          data_axis: Optional[str] = None):
    """Batch-fit dispatcher for the selection sweep's (candidate,
    restart) lanes — `parallel.restarts.restart_batch_runner` (moved
    there when `Corex(n_restarts=k).fit(mesh=...)` started sharing it);
    this alias keeps the historical selection-module spelling."""
    return restart_batch_runner(mesh, restart_axis, data_axis)


def _heldout_split_sizes(n: int, val_fraction: float,
                         gaussianize: str) -> Tuple[int, int]:
    """Validate criterion='heldout' arguments and return
    (n_train, n_val). Shared by `pick_n_hidden` and `warmup_sweep` so
    the two agree on both the rules and the training-row count — the
    warmup compiles the sweep's exact shapes, and a forked copy would
    either warm a program the sweep refuses to run or fail with an
    opaque negative-dimension error instead of the named check."""
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(
            f"val_fraction must be in (0, 1), got {val_fraction}")
    if gaussianize not in ("none", "standard"):
        # same guard as Corex.score: 'empirical' re-ranks validation
        # rows against THEMSELVES (rank transforms ignore theta), so
        # the held-out likelihood would be meaningless
        raise ValueError(
            "criterion='heldout' requires gaussianize='none' or "
            "'standard' (non-affine transforms have no comparable "
            "held-out density)")
    n_val = max(1, int(round(n * val_fraction)))
    if n - n_val < 2:
        raise ValueError(
            f"need >= 2 training rows after holding out {n_val}")
    return n - n_val, n_val


def pick_n_hidden(data, repeat: int = 1, max_n_hidden: Optional[int] = None,
                  verbose: bool = False, tc_gain_tol: float = 1e-3,
                  dtype: str = "float32", seed: Optional[int] = None,
                  padded_sweep: bool = True, criterion: str = "tc",
                  val_fraction: float = 0.2, mesh=None,
                  restart_axis: str = "restarts",
                  data_axis: Optional[str] = None, **corex_kwargs):
    """Choose n_hidden; returns (best_n, scores).

    `mesh` (a jax.sharding.Mesh with a `restart_axis` axis) shards the
    (candidate, restart) batch over the mesh's devices — each device runs
    its slice of the sweep against a replicated copy of the data, the
    zero-communication layout for many small/medium fits. `data_axis`
    (a second mesh axis) additionally shards the sample rows over that
    axis — the combined restarts x data layout for sweeps whose data is
    too large to replicate per device (samples strategy only; the psum'd
    cross-moments ride the data axis, nothing rides the restart axis —
    `parallel.audit.audit_restarts`). Results are identical to the
    single-device sweep up to fp reduction order (tests/test_selection.py
    equivalence test).

    criterion='tc' (the reference's rule, `[U] :: pick_n_hidden`): scan
    until the training TC saturates; scores[k] is the best TC over
    `repeat` restarts at n_hidden = k+1. criterion='heldout' (TPU-native
    addition): hold out `val_fraction` of the rows, fit candidates on the
    rest, and pick the n_hidden whose model maximizes the held-out
    Gaussian log-likelihood (the `Corex.score` quantity) — unlike training
    TC, which never decreases with more factors, the held-out likelihood
    stops improving at the supported model size (measured: it plateaus on
    small problems — the non-overlap solver kills surplus factors — and
    mildly DECLINES past the true size at scale, e.g. p=4096/m_true=12
    where the sweep picks exactly 12 — in f32 AND under int8 quantization
    noise; `_smallest_within_tol` picks the smallest candidate within
    tc_gain_tol of the best, correct in both shapes). scores[k] is then
    the best held-out mean log-likelihood per candidate.

    Extra kwargs flow into `CorexConfig` (max_iter, tol, anneal, ...).
    padded_sweep=True (default) runs the whole (candidate, restart) grid as
    ONE compiled batched program; False runs the sequential per-candidate
    loop (with the saturation early-stop under criterion='tc'). The
    padded sweep saves dispatches and compiles but pays lockstep
    stragglers where the sweep is compute-bound; both modes choose the
    planted rank. Which is faster at which p is not measured on the H100
    yet."""
    import jax
    import jax.numpy as jnp

    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache
    ensure_compile_cache()
    if repeat < 1:
        raise ValueError(f"repeat must be >= 1, got {repeat}")
    if max_n_hidden is not None and max_n_hidden < 1:
        raise ValueError(f"max_n_hidden must be >= 1, got {max_n_hidden}")
    if criterion not in ("tc", "heldout"):
        raise ValueError(f"unknown criterion: {criterion!r} "
                         f"(expected 'tc' or 'heldout')")
    if data_axis is not None and mesh is None:
        # without this, the single-device runner would silently ignore
        # the requested combined restarts x data layout (while the
        # strategy choice still honored it — a different, slower program
        # than the user asked for, with no sharding at all)
        raise ValueError(_DATA_AXIS_NEEDS_MESH)
    n, p = np.shape(data)
    dt = jnp.dtype(dtype)
    if max_n_hidden is None:
        max_n_hidden = min(p, 16)
    gaussianize = corex_kwargs.pop("gaussianize", "standard")
    missing_values = corex_kwargs.pop("missing_values", None)
    # sweeps always disable the TC history (it would cost
    # batch x stages x max_iter memory); accept-and-drop a user-passed
    # record_history instead of colliding with the forced kwarg
    corex_kwargs.pop("record_history", None)
    n_train, n_val = n, 0
    if criterion == "heldout":
        n_train, n_val = _heldout_split_sizes(n, val_fraction, gaussianize)
    # kwargs/config validation BEFORE the heldout split: the split's
    # device gathers move the full operand (GBs at scale), and a pure
    # argument error must not cost that
    cfg, strategy = _sweep_cfg_and_strategy(n_train, p, max_n_hidden,
                                            dtype, data_axis,
                                            corex_kwargs)
    xv = None
    if criterion == "heldout":
        perm = np.random.RandomState(seed_base(seed)).permutation(n)
        if isinstance(data, jax.Array):
            # split with a device row gather: np.asarray on a device-
            # resident X is a bulk D2H (4 GB for the p=100k f32 operand)
            # plus a second full H2D, for the same values a gather
            # produces in place
            xq = jnp.asarray(data, dtype=dt)
            xv = jnp.take(xq, jnp.asarray(perm[:n_val]), axis=0)
            x = jnp.take(xq, jnp.asarray(perm[n_val:]), axis=0)
            xq = None
        else:
            arr = np.asarray(data)
            xv = jnp.asarray(arr[perm[:n_val]], dtype=dt)
            x = jnp.asarray(arr[perm[n_val:]], dtype=dt)
        n = x.shape[0]
    else:
        x = jnp.asarray(data, dtype=dt)
    # Preprocess once (training rows only under 'heldout') → operand
    # (Gram / int8 quantize) as the fit's ONE fused prepare program
    # (models.corex._prepare_program): an eager unfused chain would hold
    # extra X-sized f32 device copies — p=100k rows under
    # benchmarks/RESULTS.md "Selection at flagship scale".
    # Every candidate fit shares the operand; validation rows
    # use the training theta. The operand dtype stays `dtype` for
    # non-int8 sweeps (matmul_dtype='bfloat16' casts inside the sweep
    # program), so the compiled sweep's cache key matches the operand
    # warmup_sweep declares.
    shared, theta = _prepare_program(
        x, PreprocessConfig(gaussianize, missing_values), strategy,
        "int8" if cfg.matmul_dtype == "int8" else "float32")
    x = None   # release the raw training rows before the lanes allocate
    if cfg.matmul_dtype == "int8":
        M._check_int8_wrap(shared)   # eager guard (host control flow)
    if xv is not None:
        xv = P.preprocess(xv, gaussianize, theta, missing_values)
    overlap = not cfg.discourage_overlap
    label = "TC" if criterion == "tc" else "held-out loglik"
    run_batch = _restart_batch_runner(mesh, restart_axis, data_axis)

    if padded_sweep:
        w0 = _padded_inits(max_n_hidden, repeat, p, seed, jnp.dtype(dtype))
        _, mom_b, _ = run_batch(shared, w0, cfg, strategy, n)
        if criterion == "heldout":
            per = _score_batch(xv, mom_b, overlap)
        else:
            per = np.asarray(mom_b.tc)
        scores = per.reshape(max_n_hidden, repeat).max(axis=1)
        if verbose:
            for nh, s in enumerate(scores, start=1):
                print(f"n_hidden={nh}: best {label} over {repeat} "
                      f"restarts = {s:.5f}")
        if criterion == "heldout":
            return _smallest_within_tol(scores, tc_gain_tol), \
                np.array(scores)
        return _best_n_from_scores(scores, tc_gain_tol), np.array(scores)

    scores = []
    best_n, best_tc_overall = 1, -np.inf
    for nh in range(1, max_n_hidden + 1):
        cfg = CorexConfig(n_hidden=nh, dtype=dtype, record_history=False,
                          **corex_kwargs)
        w0 = init_restarts(repeat, nh, p, seed, jnp.dtype(dtype))
        _, mom_b, _ = run_batch(shared, w0, cfg, strategy, n)
        if criterion == "heldout":
            s_best = float(np.max(_score_batch(xv, mom_b, overlap)))
        else:
            s_best = float(np.max(np.asarray(mom_b.tc)))
        scores.append(s_best)
        if verbose:
            print(f"n_hidden={nh}: best {label} over {repeat} restarts = "
                  f"{s_best:.5f}")
        if criterion == "tc":
            if s_best > best_tc_overall + tc_gain_tol:
                best_tc_overall, best_n = s_best, nh
            elif nh > best_n + 1:
                break  # two consecutive values added nothing: saturated
    if criterion == "heldout":
        best_n = _smallest_within_tol(np.array(scores), tc_gain_tol)
    return best_n, np.array(scores)


def warmup_sweep(n_samples: int, n_variables: int, repeat: int = 1,
                 max_n_hidden: Optional[int] = None, dtype: str = "float32",
                 criterion: str = "tc", val_fraction: float = 0.2,
                 mesh=None, restart_axis: str = "restarts",
                 data_axis: Optional[str] = None, verbose: bool = False,
                 tc_gain_tol: float = 1e-3, seed: Optional[int] = None,
                 padded_sweep: bool = True, **corex_kwargs) -> None:
    """Ahead-of-time compile of the padded `pick_n_hidden` sweep program
    for declared shapes — the selection counterpart of
    `utils.compile_cache.warmup_fit`. The (candidate, restart) grid is the
    single most expensive compile in the library; with the persistent
    cache on, running this at
    deploy time turns the first real sweep's compile wait into a cache
    deserialize.

    Pass EXACTLY the arguments the real `pick_n_hidden(data, ...)` call
    will use (jit is shape- and config-specialized): `n_samples` /
    `n_variables` are the data's shape — under criterion='heldout' the
    validation split is reproduced here, so pass the FULL row count. The
    config/strategy/padding pipeline is shared with `pick_n_hidden`
    (`_sweep_cfg_and_strategy`; lockstep-pinned by
    tests/test_selection.py), so the lowered program is key-identical to
    the one the sweep dispatches. Selection-rule knobs that don't touch
    the compiled shapes (`verbose`, `tc_gain_tol`, `seed`) are accepted
    and ignored, so a literal copy of the sweep call's arguments warms
    cleanly. Only the padded sweep can be warmed — `padded_sweep=False`
    raises by name (the sequential path compiles one small program per
    candidate on first use); the tiny heldout scorer / preprocessing
    programs compile in seconds and are not worth declaring shapes
    for."""
    import jax
    import jax.numpy as jnp

    from linearcorex_tpu.models.corex import resolve_config
    from linearcorex_tpu.ops.moments import QuantizedData
    from linearcorex_tpu.parallel import restarts as R
    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    # Accepted so a literal copy of the pick_n_hidden call's arguments
    # warms cleanly; they steer the selection rule / init values, not
    # the compiled program's shapes or cache key.
    del verbose, tc_gain_tol, seed
    n, p = int(n_samples), int(n_variables)
    if criterion not in ("tc", "heldout"):
        raise ValueError(f"unknown criterion: {criterion!r} "
                         f"(expected 'tc' or 'heldout')")
    if not padded_sweep:
        raise ValueError(
            "warmup_sweep warms the padded one-program sweep only; "
            "padded_sweep=False runs small per-candidate programs that "
            "compile quickly on first use — nothing to warm")
    if data_axis is not None and mesh is None:
        raise ValueError(_DATA_AXIS_NEEDS_MESH)
    if criterion == "heldout":
        # training rows only; shares pick_n_hidden's validation so the
        # warmup never compiles a program the real sweep would refuse
        n, _ = _heldout_split_sizes(
            n, val_fraction, corex_kwargs.get("gaussianize", "standard"))
    if max_n_hidden is None:
        max_n_hidden = min(p, 16)
    kwargs = dict(corex_kwargs)
    for k in ("gaussianize", "missing_values", "record_history"):
        kwargs.pop(k, None)
    cfg, strategy = _sweep_cfg_and_strategy(n, p, max_n_hidden, dtype,
                                            data_axis, kwargs)
    cfg = resolve_config(cfg, p, n_samples=n)
    dt = jnp.dtype(dtype)
    data_shape = (p, p) if strategy == "gram" else (n, p)
    batch = max_n_hidden * repeat
    w_spec, data_spec, scale_spec = None, None, None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P_

        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        if restart_axis not in sizes:
            raise ValueError(
                f"mesh has axes {mesh.axis_names}; the sweep shards the "
                f"restart batch over {restart_axis!r}")
        if data_axis is not None:
            dd = sizes.get(data_axis)
            if dd is None or n % dd:
                # mirror fit_restarts_sharded's check: a warmup must not
                # compile a program the real sweep would reject
                raise ValueError(
                    f"data_axis={data_axis!r}: the {n} (training) sample "
                    f"rows must divide the mesh axis (size {dd}) evenly "
                    f"— trim/pad the rows or adjust the mesh (XLA shards "
                    f"without padding)")
        batch += (-batch) % sizes[restart_axis]   # the runner's padding
        w_spec = NamedSharding(mesh, P_(restart_axis, None, None))
        data_spec = NamedSharding(
            mesh, P_(data_axis, None) if data_axis is not None else P_())
        scale_spec = NamedSharding(mesh, P_())
    if cfg.matmul_dtype == "int8":
        data_arg = QuantizedData(
            q=jax.ShapeDtypeStruct(data_shape, jnp.int8,
                                   sharding=data_spec),
            scale=jax.ShapeDtypeStruct((), jnp.float32,
                                       sharding=scale_spec))
    else:
        data_arg = jax.ShapeDtypeStruct(data_shape, dt, sharding=data_spec)
    w_arg = jax.ShapeDtypeStruct((batch, max_n_hidden, p), dt,
                                 sharding=w_spec)
    # module-attribute access (not a from-import) so tests can intercept
    # the one program object both this warmup and the real sweep use.
    # The mesh context matters for the cache key, not just the operand
    # shardings: fit_restarts_sharded compiles INSIDE jax.set_mesh(mesh),
    # and a module lowered outside it differs (and misses the cache) —
    # tests/test_selection.py pins lowered-module-text identity.
    import contextlib
    ctx = jax.set_mesh(mesh) if mesh is not None else (
        contextlib.nullcontext())
    with ctx:
        R._fit_restarts_program.lower(data_arg, w_arg, cfg,
                                      strategy).compile()

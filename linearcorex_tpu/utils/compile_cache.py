"""Persistent-compilation-cache wiring for the library entry points.

XLA:GPU compiles locally, but the fit programs are large (the whole
annealed solve is one program) and XLA autotunes each GEMM shape on the
card, so a cold first `Corex.fit` at cfg5 scale pays seconds of compile
before any work. JAX's persistent compilation cache removes that cost for
every process after the first. Every fit-shaped entry point (`Corex.fit`,
`fit_sharded`, `fit_shard_map`, `fit_restarts*`, `pick_n_hidden`,
`fit_with_checkpoints`) calls `ensure_compile_cache()` once per process.

Policy:
- an explicitly-configured cache (`JAX_COMPILATION_CACHE_DIR`, or
  `jax_compilation_cache_dir` set via jax.config) is always respected and
  left untouched — no other directory is set then;
- `LINEARCOREX_TPU_NO_COMPILE_CACHE=1` opts out entirely;
- `LINEARCOREX_TPU_CACHE_DIR=<dir>` (or the `cache_dir` argument) names
  the location; a directory asked for this way that cannot be used
  raises;
- otherwise, off the CPU backend, the cache lives at the fixed path
  `.jax_cache/` next to the package checkout (a fixed path, because the
  path is part of the cache key).

`warmup_fit` is the ahead-of-time companion: it lowers + compiles the fit
program for declared shapes (no data needed), so the artifact is in the
persistent cache before the first real fit — move the compile wait to
deploy time instead of first-request time. The cold / persistent-cache /
AOT first-call walls belong in benchmarks/RESULTS.md "First-call wall
time" table (not measured on the H100 yet).
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["ensure_compile_cache", "warmup_fit", "warmup_serving"]


def ensure_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Enable JAX's persistent compilation cache (idempotent, opt-out-able;
    see module docstring for the policy). Returns the active cache dir, or
    None when disabled."""
    import jax

    if os.environ.get("LINEARCOREX_TPU_NO_COMPILE_CACHE"):
        return None
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    cache_dir = cache_dir or os.environ.get("LINEARCOREX_TPU_CACHE_DIR")
    requested = cache_dir is not None
    if not requested:
        # Default-on only off-CPU: CPU compiles are fast, and XLA:CPU AOT
        # artifacts are machine-feature-flag sensitive — reloading an
        # entry compiled by a process with different CPU feature flags
        # logs SIGILL-risk errors. Opt in explicitly (env var / cache_dir
        # arg) to cache CPU compiles.
        if jax.default_backend() == "cpu":
            return None
        cache_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        if requested:
            raise
        return None  # default location unwritable (read-only checkout)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    # GEMM autotuning makes even mid-size programs worth keeping
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir


def warmup_fit(model, n_samples: int, n_variables: int, mesh=None,
               sharding_plan=None) -> None:
    """Ahead-of-time compile of `model`'s fit program for declared shapes.

    Resolves strategy / 'auto' knobs / operand dtype exactly as
    `Corex.fit` would for an (n_samples, n_variables) input and runs
    `jit(...).lower(shapes).compile()` on ShapeDtypeStructs — no data, no
    execution. With the persistent cache on (`ensure_compile_cache`, called
    here), the compiled artifact is reused by the first real
    `fit` on matching shapes, turning the first-call compile wait into a
    cache deserialize. With `mesh` (+ optional `sharding_plan`) the warmed
    program is the sharded one `fit(mesh=...)` runs.

    The preprocessing/quantization programs are small and compile in
    seconds; the fit program is the one worth warming.
    """
    import jax
    import jax.numpy as jnp

    from linearcorex_tpu.models.corex import (_fit_program,
                                              _prepare_program,
                                              pick_fit_strategy,
                                              resolve_config)
    from linearcorex_tpu.ops.moments import QuantizedData

    ensure_compile_cache()
    n, p = int(n_samples), int(n_variables)
    plan = None
    data_axis = None
    # the restart-combination rejects must fire HERE exactly as in fit —
    # warming a key the fit would refuse to run is a dead cache entry
    restarts = model._validated_restarts(None)
    if mesh is not None:
        from linearcorex_tpu.parallel.sharding import ShardingPlan
        plan = sharding_plan or ShardingPlan()
        if restarts > 1:
            # layout decision SHARED with Corex.fit: plan becomes what
            # pick_fit_strategy/_prepare_fit see (None ⇒ the sweep's
            # operand is prepared single-device and replicated)
            from linearcorex_tpu.models.corex import (
                resolve_restart_mesh_layout)
            plan, data_axis = resolve_restart_mesh_layout(mesh, plan)
    # strategy/config resolution SHARED with the real fit paths
    # (pick_fit_strategy / resolve_config) — a drifted copy here
    # would compile a different cache key than the fit and silently
    # defeat AOT warmup
    strategy = pick_fit_strategy(model.config, n, p, plan)
    dt = model._dt
    data_shape = (p, p) if strategy == "gram" else (n, p)
    if model.config.matmul_dtype == "bfloat16":
        data_dt = jnp.bfloat16
    else:
        data_dt = dt

    if mesh is None or (restarts > 1 and plan is None):
        # single-device fit: the preprocessing+operand program runs on
        # the host device layout (the mesh variant is warmed below,
        # under the mesh, with the plan baked in — a different program).
        # A restart-only mesh sweep prepares the SAME way: Corex.fit
        # runs the single-device prepare and fit_restarts_sharded
        # replicates the operand over the mesh.
        _prepare_program.lower(
            jax.ShapeDtypeStruct((n, p), dt), model.pre_config, strategy,
            model.config.matmul_dtype).compile()
        if model.pre_config.gaussianize == "empirical":
            from linearcorex_tpu.utils import native
            if native.available():
                # a fit on NumPy input takes the native host fast path
                # (Corex._host_preprocess), which calls
                # _prepare_program(xp, None, ...) — a DIFFERENT static
                # key than the pre_cfg=model.pre_config variant above;
                # warm it too so that fit-time prepare compile is also
                # covered
                _prepare_program.lower(
                    jax.ShapeDtypeStruct((n, p), dt), None, strategy,
                    model.config.matmul_dtype).compile()
        if model.config.init == "spectral":
            # the spectral-init program runs on the prepared operand
            from linearcorex_tpu.models.corex import _spectral_init_program
            if model.config.matmul_dtype == "int8":
                init_data = QuantizedData(
                    q=jax.ShapeDtypeStruct(data_shape, jnp.int8),
                    scale=jax.ShapeDtypeStruct((), jnp.float32))
            else:
                init_data = jax.ShapeDtypeStruct(data_shape, data_dt)
            _spectral_init_program.lower(
                init_data, jax.ShapeDtypeStruct((p, model.m), dt), strategy,
                model.config.matmul_dtype).compile()

    def sds(shape, dtype, spec=None):
        if mesh is None:
            return jax.ShapeDtypeStruct(shape, dtype)
        from jax.sharding import NamedSharding
        return jax.ShapeDtypeStruct(
            shape, dtype, sharding=NamedSharding(mesh, spec))

    def fit_data_arg(shape, spec=None, scale_spec=None):
        """The solver-operand declaration — ONE definition for every warm
        path below (int8 carries QuantizedData with a committed scalar
        scale on mesh paths); matmul_dtype never changes under config
        resolution, so model.config is authoritative here."""
        if model.config.matmul_dtype == "int8":
            return QuantizedData(q=sds(shape, jnp.int8, spec),
                                 scale=sds((), jnp.float32, scale_spec))
        return sds(shape, data_dt, spec)

    if mesh is not None:
        from jax.sharding import PartitionSpec as P

        from linearcorex_tpu.parallel import sharding as S

        if restarts > 1:
            # warm the SHARDED restart-sweep key fit dispatches
            # (Corex._fit_restart_sweep(mesh=...) → restart_batch_runner
            # → fit_restarts_sharded), via the same shared derivations:
            # resolve_restart_mesh_layout above decided (plan, data_axis),
            # fit_restarts_sharded resolves the config, and the runner
            # pads the lane batch to the restart-axis size
            from linearcorex_tpu.models.corex import (
                RESTART_AXIS, check_restart_sweep_supported)
            from linearcorex_tpu.parallel.restarts import (
                _fit_restarts_program)
            if strategy != "samples":
                data_axis = None  # explicit-gram: replicated operand
            cfg = resolve_config(model.config, p, n_samples=n)
            check_restart_sweep_supported(cfg, strategy)
            if plan is not None:
                # combined restarts x data layout: the fit's prepare
                # runs UNDER the mesh with the plan and the raw X
                # sharded per x_spec (Corex._prepare_fit(mesh=...))
                S.validate_plan_shapes(plan, strategy, mesh, n, p,
                                       model.m, raw_x=True)
                with jax.set_mesh(mesh):
                    _prepare_program.lower(
                        sds((n, p), dt, plan.x_spec()), model.pre_config,
                        strategy, model.config.matmul_dtype,
                        plan).compile()
            from linearcorex_tpu.parallel.restarts import padded_lanes
            d = dict(zip(mesh.axis_names,
                         mesh.devices.shape))[RESTART_AXIS]
            lanes = padded_lanes(restarts, d)
            data_spec = P(data_axis, None) if data_axis else P()
            data_arg = fit_data_arg(data_shape, data_spec, P())
            if plan is not None and model.config.init == "spectral":
                # spectral sweep lanes call the SAME per-lane spectral
                # program as the single fit, here on the PLAN-sharded
                # operand (the replicated-operand variant is warmed by
                # the single-device block above); omega arrives
                # uncommitted from _spectral_restart_inits
                from linearcorex_tpu.models.corex import (
                    _spectral_init_program)
                _spectral_init_program.lower(
                    fit_data_arg(data_shape,
                                 S.operand_specs(plan, strategy)[0], P()),
                    jax.ShapeDtypeStruct((p, model.m), dt), strategy,
                    model.config.matmul_dtype).compile()
            # fit_restarts_sharded compiles INSIDE jax.set_mesh(mesh)
            # with every operand committed (device_put) — lower under
            # the same context with the same committed shardings
            with jax.set_mesh(mesh):
                _fit_restarts_program.lower(
                    data_arg,
                    sds((lanes, model.m, p), dt,
                        P(RESTART_AXIS, None, None)),
                    cfg, strategy).compile()
            return
        cfg = resolve_config(model.config, p, n_samples=n)
        from linearcorex_tpu.models.corex import stage_subsample_active
        if stage_subsample_active(cfg, strategy):
            raise ValueError(
                "stage_subsample < 1 is not supported under "
                "fit(mesh=...) (see Corex.fit) — there is no sharded "
                "staged program to warm; set stage_subsample=1 for mesh "
                "fits")
        # raw_x=True: the prepare lowered below declares the RAW (n, p)
        # X sharded per x_spec even for gram strategy — same rule as
        # Corex._prepare_fit(mesh=...)
        S.validate_plan_shapes(plan, strategy, mesh, n, p, model.m,
                               raw_x=True)
        data_spec, w_spec = S.operand_specs(plan, strategy)
        data_arg = fit_data_arg(data_shape, data_spec, P())
        # the mesh fit's prepare runs UNDER the mesh with the plan
        # constraining its output and the raw X sharded per x_spec
        # (Corex._prepare_fit(mesh=...)); the native host fast path is
        # skipped there, so this is the only live prepare variant
        with jax.set_mesh(mesh):
            _prepare_program.lower(
                sds((n, p), dt, plan.x_spec()), model.pre_config,
                strategy, model.config.matmul_dtype, plan).compile()
        if model.config.init == "spectral":
            # under a mesh, spectral init consumes the PLAN-sharded
            # operand; omega is small and arrives UNCOMMITTED from
            # _resolve_w0 — declare it without a sharding, or the
            # lowered module carries an annotation the real call's
            # doesn't and the cache key never matches
            from linearcorex_tpu.models.corex import _spectral_init_program
            _spectral_init_program.lower(
                data_arg, jax.ShapeDtypeStruct((p, model.m), dt), strategy,
                model.config.matmul_dtype).compile()
        # fit_sharded compiles INSIDE jax.set_mesh(mesh); the mesh
        # context is part of the lowered module (hence the cache key),
        # so the warmup must lower under it too
        with jax.set_mesh(mesh):
            S._fit_program_sharded.lower(
                data_arg, sds((model.m, p), dt, w_spec), cfg, plan,
                strategy).compile()
        return

    cfg = resolve_config(model.config, p, n_samples=n)

    # n_restarts > 1: the real fit dispatches the vmapped restart-sweep
    # program (Corex._fit_restart_sweep), not _fit_program — warm THAT
    # cache key (the combination rejects fired at the top, so no dead
    # key is warmed)
    if restarts > 1:
        from linearcorex_tpu.models.corex import (
            check_restart_sweep_supported)
        from linearcorex_tpu.parallel.restarts import _fit_restarts_program
        check_restart_sweep_supported(cfg, strategy)
        _fit_restarts_program.lower(
            fit_data_arg(data_shape),
            sds((restarts, model.m, p), dt), cfg, strategy).compile()
        return

    from linearcorex_tpu.models.corex import (_staged_subsample_cfgs,
                                              stage_subsample_active,
                                              subsample_len)
    if stage_subsample_active(cfg, strategy):
        # the real fit runs the TWO-program stage-subsample driver
        # (Corex.fit -> _fit_staged_subsample): warm both its cache keys
        # — the prefix program on the stride-sliced row count and the
        # final-stage program on the full shape — via the SHARED config
        # derivation (a forked copy would warm keys the fit never uses)
        prefix_cfg, final_cfg = _staged_subsample_cfgs(cfg)
        n_sub = subsample_len(n, cfg.stage_subsample)
        _fit_program.lower(fit_data_arg((n_sub, p)),
                           sds((model.m, p), dt), prefix_cfg,
                           strategy).compile()
        _fit_program.lower(fit_data_arg((n, p)), sds((model.m, p), dt),
                           final_cfg, strategy).compile()
    else:
        _fit_program.lower(fit_data_arg(data_shape), sds((model.m, p), dt),
                           cfg, strategy).compile()


def warmup_serving(model, batch_rows: int, n_variables=None,
                   matmat_k=None, cov_block=None, mesh=None,
                   sharding_plan=None) -> None:
    """Ahead-of-time compile of the serving programs for declared shapes:
    `transform`, `predict`, `score` (affine gaussianize modes only), and
    — when `matmat_k` / `cov_block` are given — `covariance_matmat` /
    `covariance_blocks`. The companion to `warmup_fit` for
    inference-only deployments (load_corex → serve): with the persistent
    cache on, the first request of each kind deserializes instead of
    compiling.

    `n_variables` defaults to the fitted width (`model.nv`); pass it
    explicitly to warm before any fit/load. Shapes must match the real
    calls exactly (jit is shape-specialized).

    With `mesh` (+ optional `sharding_plan`) the warmed programs are the
    sharded-serving ones `transform(mesh=...)` etc. dispatch: every
    operand is declared WITH the sharding the real call commits it with
    (state per its axis roles, inputs per x/y/v_spec — all committed in
    the serving path), and lowering happens INSIDE jax.set_mesh(mesh),
    matching the dispatch scope (the round-4 cache-key rule). Pinned by
    module-text identity in tests/test_compile_cache.py. `cov_block`
    with `mesh` warms the sharded `covariance_blocks(mesh=...)` row
    program (z and std declared per the serving state specs)."""
    import jax
    import jax.numpy as jnp

    from linearcorex_tpu.models import corex as C
    from linearcorex_tpu.ops.preprocessing import Theta

    ensure_compile_cache()
    if n_variables is None:
        n_variables = model.nv
    if n_variables is None:
        raise ValueError(
            "n_variables is required when the model is not fitted yet")
    p = int(n_variables)
    b, m, dt = int(batch_rows), model.m, model._dt

    if mesh is not None:
        _warmup_serving_mesh(model, b, p, m, dt, matmat_k, mesh,
                             sharding_plan, cov_block)
        return

    def s(shape):
        return jax.ShapeDtypeStruct(shape, dt)

    theta = Theta(mean=s((p,)), std=s((p,)))
    C._transform_program.lower(s((b, p)), s((m, p)), theta,
                               model.pre_config).compile()
    if model.config.discourage_overlap:
        rr, si = s((m, p)), s((p,))
        C._predict_ns_program.lower(s((b, m)), rr, si, s((m,)),
                                    theta).compile()
        if model.pre_config.gaussianize in ("none", "standard"):
            C._score_ns_program.lower(s((b, p)), rr, si, theta,
                                      model.pre_config).compile()
        if matmat_k:
            C._matmat_ns_program.lower(rr, si, s((p,)),
                                       s((p, int(matmat_k)))).compile()
    else:
        cy, c_xy = s((m, m)), s((p, m))
        C._predict_overlap_program.lower(s((b, m)), cy, c_xy,
                                         theta).compile()
        if model.pre_config.gaussianize in ("none", "standard"):
            C._score_overlap_program.lower(s((b, p)), cy, c_xy, theta,
                                           model.pre_config).compile()
        if matmat_k:
            C._matmat_overlap_program.lower(
                cy, c_xy, s((p,)), s((p, int(matmat_k)))).compile()
    if cov_block:
        blk = min(int(cov_block), p)
        C._cov_rows_program.lower(
            s((m, p)), s((p,)), jax.ShapeDtypeStruct((), jnp.int32),
            blk).compile()


def _warmup_serving_mesh(model, b, p, m, dt, matmat_k, mesh,
                         sharding_plan, cov_block=None):
    """The mesh branch of `warmup_serving`: lower the sharded-serving
    programs with every operand declared per the layout
    `Corex._serving_mesh` commits (state axis roles; x/y/v_spec inputs),
    inside the jax.set_mesh scope the real dispatch uses."""
    import jax

    from jax.sharding import NamedSharding

    from linearcorex_tpu.models import corex as C
    from linearcorex_tpu.ops.preprocessing import Theta
    from linearcorex_tpu.parallel import sharding as S

    plan = sharding_plan or S.ShardingPlan()
    S.validate_plan_shapes(plan, "samples", mesh, b, p, m, raw_x=True)
    # the state layout is the SHARED definition the real dispatch commits
    # (Corex._serving_mesh) — a forked copy here would lower a different
    # module and silently defeat the warmup
    specs = C.serving_state_specs(plan)

    def s(shape, spec):
        return jax.ShapeDtypeStruct(
            shape, dt, sharding=NamedSharding(mesh, spec))

    theta = Theta(mean=s((p,), specs["theta"]),
                  std=s((p,), specs["theta"]))
    x_arg = s((b, p), plan.x_spec())
    y_arg = s((b, m), plan.y_spec())
    std = s((p,), specs["theta"])
    affine = model.pre_config.gaussianize in ("none", "standard")
    with jax.set_mesh(mesh):
        C._transform_program.lower(x_arg, s((m, p), specs["ws"]), theta,
                                   model.pre_config).compile()
        if model.config.discourage_overlap:
            rr = s((m, p), specs["rhoinvrho"])
            si = s((p,), specs["si"])
            C._predict_ns_program.lower(y_arg, rr, si,
                                        s((m,), specs["z2"]),
                                        theta).compile()
            if affine:
                C._score_ns_program.lower(x_arg, rr, si, theta,
                                          model.pre_config).compile()
            if matmat_k:
                C._matmat_ns_program.lower(
                    rr, si, std,
                    s((p, int(matmat_k)), plan.v_spec(ndim=2))).compile()
        else:
            cy = s((m, m), specs["cy"])
            c_xy = s((p, m), specs["c_xy"])
            C._predict_overlap_program.lower(y_arg, cy, c_xy,
                                             theta).compile()
            if affine:
                C._score_overlap_program.lower(x_arg, cy, c_xy, theta,
                                               model.pre_config).compile()
            if matmat_k:
                C._matmat_overlap_program.lower(
                    cy, c_xy, std,
                    s((p, int(matmat_k)), plan.v_spec(ndim=2))).compile()
        if cov_block:
            # covariance_blocks(mesh=...): z carries rhoinvrho's layout on
            # both solver paths — natively on the NS path (eager
            # z = rhoinvrho/(1+si) propagates it), by the dispatch's
            # explicit re-commit on the overlap path (its solve_triangular
            # output lands replicated) — pinned per solver path by the
            # module-text identity tests in tests/test_sharding.py
            import jax.numpy as jnp
            blk = min(int(cov_block), p)
            C._cov_rows_program.lower(
                s((m, p), specs["rhoinvrho"]), std,
                jax.ShapeDtypeStruct((), jnp.int32), blk).compile()

"""Checkpoint / resume for fitted Corex state (SURVEY.md §5).

The reference offers warm restarts through the `pretrained_weights`
constructor arg and otherwise relies on pickling the estimator object
(`[U] linearcorex/linearcorex.py :: Corex.__init__(pretrained_weights=...)`).
Here checkpointing is first-class: the learned state (ws, theta, moments,
config) is one flat dict of arrays saved as a portable .npz, so a fit can be
resumed (`Corex.fit(init_ws=...)` keeps warm-start semantics), inference can
run without refitting, and long anneal schedules can be snapshotted at stage
boundaries. No pickle: the format is inspectable arrays + a JSON config
string.
"""

from __future__ import annotations

import dataclasses
import json

import jax.numpy as jnp
import numpy as np

from linearcorex_tpu.config import CorexConfig, PreprocessConfig
from linearcorex_tpu.models.corex import Corex
from linearcorex_tpu.ops.moments import Moments
from linearcorex_tpu.ops.preprocessing import Theta

__all__ = ["save_corex", "load_corex", "fit_with_checkpoints"]

_FORMAT_VERSION = 1


def _json_scalar(o):
    """json.dumps default= for checkpoint metadata: numpy scalars arrive
    VERBATIM from sklearn param grids (np.int64 seeds/n_restarts from
    np.arange, np.float64 tols) — the estimator stores parameters
    verbatim by contract, so canonicalize only here, at the
    serialization boundary (the loaded value is the same number)."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(
        f"checkpoint metadata value {o!r} ({type(o).__name__}) is not "
        f"JSON-serializable")


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing; normalize once so save and
    load agree on the real filename."""
    return path if path.endswith(".npz") else path + ".npz"


def _non_default_fields(cfg_obj) -> dict:
    """Config as a dict with fields AT their dataclass default dropped.
    Used by the fit fingerprint so ADDING a config field (with a default)
    does not invalidate every pre-existing stage checkpoint: a long fit
    interrupted before a library upgrade must resume after it when its
    semantics are bit-identical (found when `stage_tol_factor` landed —
    the asdict-based payload restarted default-factor fits from stage 0).
    A field explicitly set TO its default is indistinguishable from one
    left alone; the resulting fit is identical, so the fingerprint
    SHOULD treat them the same."""
    out = {}
    for f in dataclasses.fields(cfg_obj):
        v = getattr(cfg_obj, f.name)
        if f.default is not dataclasses.MISSING and v == f.default:
            continue
        out[f.name] = v
    return out


def _fit_fingerprint(model: Corex, x, schedule) -> str:
    """Hash of (config, preprocessing, data shape + content sample, anneal
    schedule). Stored in stage checkpoints so a resume against different
    data or hyperparameters is detected instead of silently continuing
    from stale weights. Default-valued config fields are excluded
    (`_non_default_fields`) so additive config evolution preserves
    resumes."""
    import hashlib

    payload = json.dumps(
        {
            "config": _non_default_fields(model.config),
            "pre_config": _non_default_fields(model.pre_config),
            "shape": [int(s) for s in np.shape(x)],
            "schedule": [float(e) for e in schedule],
        },
        sort_keys=True, default=str).encode()
    h = hashlib.sha256(payload)
    if isinstance(x, np.ndarray):
        flat = x.ravel()
        stride = max(1, flat.size // 1024)
        sample = np.ascontiguousarray(flat[::stride][:1024], np.float64)
    else:  # device array: subsample ON device, pull <=8 KB to host
        flat = jnp.ravel(x)
        stride = max(1, flat.size // 1024)
        sample = np.asarray(flat[::stride][:1024], np.float64)
    h.update(sample.tobytes())
    return h.hexdigest()


def save_corex(model: Corex, path: str) -> None:
    """Save a fitted Corex to `path` (.npz). One device→host pull, by
    explicit user request."""
    if model.ws is None or model.moments is None:
        raise ValueError("model is not fitted")
    path = _npz_path(path)
    meta = {
        "format_version": _FORMAT_VERSION,
        "config": dataclasses.asdict(model.config),
        "pre_config": dataclasses.asdict(model.pre_config),
        "seed": model.seed,
        "nv": model.nv,
        "n_samples": model.n_samples,
        "update_iter": model.update_iter,
        "verbose": model.verbose,
        # restart-sweep state: n_restarts so a post-load fit() raises by
        # name (warm start x restarts) instead of silently fitting one
        # lane; best_restart_ so the fitted-attribute surface round-trips.
        "n_restarts": model.n_restarts,
        "best_restart": model.best_restart_,
    }
    arrays = {
        "ws": np.asarray(model.ws),
        "theta_mean": np.asarray(model.theta.mean),
        "theta_std": np.asarray(model.theta.std),
        "meta_json": np.frombuffer(
            json.dumps(meta, default=_json_scalar).encode(),
            dtype=np.uint8),
    }
    for name, val in model.moments._asdict().items():
        arrays[f"mom_{name}"] = np.asarray(val)
    np.savez(path, **arrays)


def fit_with_checkpoints(model: Corex, x, ckpt_dir: str, init_ws=None,
                         mesh=None, sharding_plan=None,
                         stage_callback=None):
    """Run the annealed fit one stage at a time, saving (ws, stage) at each
    anneal-stage boundary — preemption recovery for long fits on
    preemptible machines (SURVEY.md §5 checkpoint/resume). If `ckpt_dir`
    already holds a stage
    file, fitting resumes from the stage after it.

    Each stage compiles once and runs with a single host sync; the extra
    cost vs the one-program `fit` is one sync + one small save per stage.
    Data preparation is shared with `Corex.fit` (`Corex._prepare_fit`), so
    the checkpointed fit sees identically validated and preprocessed data.
    A fingerprint of (config, data, schedule) is stored with each stage; a
    resume whose fingerprint mismatches restarts from stage 0 with a
    warning instead of silently continuing from stale weights. Finishes by
    populating `model` exactly like `Corex.fit` (final moments, sorted
    factors) and returns the model.

    `mesh` (+ optional `sharding_plan`) runs every stage through the
    sharded program `Corex.fit(mesh=...)` uses — checkpointing where
    preemption actually matters: long sharded cfg5+ fits. The stage weights come back replicated, so the .npz
    format is mesh-independent: a fit checkpointed on one mesh can resume
    on another mesh, or on a single device (the fingerprint covers
    (config, data, schedule) — the math is layout-invariant). Like every
    mesh entry point, the GSPMD divisibility contract applies to the
    TARGET mesh — it is enforced when the data is prepared under the
    mesh, even if the checkpoint turns out to be complete.

    `stage_callback(stage, eps, ws, stats)` runs on host after each stage
    (SURVEY.md §5 metrics row: host observability at stage boundaries
    only — the only points where the one-sync-per-program discipline
    already pays a host sync). `stats` is the dict of per-stage arrays
    accumulated so far (iters/tc/delta/obj[/hist]); return values are
    ignored; exceptions propagate (the checkpoint for the completed stage
    is already on disk, so a crashing callback costs nothing).
    """
    import dataclasses as _dc
    import os
    import warnings

    import jax

    from linearcorex_tpu.core.solver import FitDiagnostics
    from linearcorex_tpu.models.corex import _fit_program
    from linearcorex_tpu.ops import moments as M

    if model._validated_restarts(init_ws) != 1:
        # every other driver raises by name on unsupported restart
        # combinations — silently running ONE lane here would hand the
        # user a single fit while they believe they got the best-of-k
        # basin mitigation (round-5 review finding)
        raise ValueError(
            "n_restarts > 1 is not supported by fit_with_checkpoints: "
            "the stage-boundary driver re-enters the solver one stage "
            "at a time on a single lane. Run Corex(n_restarts=k).fit "
            "without checkpoints, or checkpoint k seeded single-restart "
            "fits (seed=s+r) and keep the best TC.")

    os.makedirs(ckpt_dir, exist_ok=True)
    state_path = os.path.join(ckpt_dir, "stage_state.npz")

    plan = None
    if mesh is not None:
        from linearcorex_tpu.parallel.sharding import (ShardingPlan,
                                                       fit_sharded)
        plan = sharding_plan or ShardingPlan()
    data, cfg, strategy = model._prepare_fit(x, plan=plan, mesh=mesh)
    schedule = cfg.anneal_schedule()
    fingerprint = _fit_fingerprint(model, x, schedule)
    n_stages = len(schedule)
    # per-stage diagnostics, persisted alongside ws so a resumed run still
    # reports the full history
    stats = {
        "iters": np.zeros(n_stages, np.int32),
        "tc": np.zeros(n_stages, np.float64),
        "delta": np.zeros(n_stages, np.float64),
        "obj": np.zeros(n_stages, np.float64),
        "hist": np.zeros((n_stages,
                          cfg.max_iter if cfg.record_history else 0),
                         np.float64),
    }
    start_stage = 0
    if os.path.exists(state_path):
        with np.load(state_path) as z:
            stored_fp = (bytes(z["fingerprint"]).decode()
                         if "fingerprint" in z.files else "")
            if stored_fp != fingerprint:
                warnings.warn(
                    f"checkpoint in {ckpt_dir!r} was written for a "
                    f"different (config, data, schedule); restarting the "
                    f"fit from stage 0")
            else:
                start_stage = min(int(z["stage"]), n_stages)
                ws = jnp.asarray(z["ws"], model._dt)
                for k in stats:
                    if k in z.files and z[k].shape == stats[k].shape:
                        stats[k] = z[k].copy()
    if start_stage == 0:
        ws = model._resolve_w0(init_ws, data=data, strategy=strategy)

    fp_arr = np.frombuffer(fingerprint.encode(), dtype=np.uint8)
    tols = cfg.tol_schedule()
    # stage_subsample: non-final stages run on every k-th row (the same
    # contract as Corex.fit's two-program driver — the final stage always
    # sees the FULL data at `tol`). The subsampled operand is a
    # deterministic stride slice, so a resumed run rebuilds the identical
    # stage inputs. Not supported under a mesh (same GSPMD-divisibility
    # reasoning as Corex.fit(mesh=...)).
    from linearcorex_tpu.models.corex import (_subsample_rows,
                                              stage_subsample_active)
    sub_active = stage_subsample_active(cfg, strategy)
    if sub_active and mesh is not None:
        raise ValueError(
            "stage_subsample < 1 is not supported under "
            "fit_with_checkpoints(mesh=...): a stride slice of the "
            "sharded sample axis would reshard mid-fit and break the "
            "GSPMD divisibility contract. Set stage_subsample=1, or "
            "checkpoint single-device.")
    data_sub = (_subsample_rows(data, cfg.stage_subsample) if sub_active
                else data)
    for s in range(start_stage, n_stages):
        # pre-bake this stage's tol (stage_tol_factor loosens non-final
        # stages): an eps_override program's length-1 schedule makes its
        # only stage "final", so tol passes through unchanged.
        # stage_subsample=1 in the stage config: the staging is realized
        # here by the operand choice (same rule as _staged_subsample_cfgs)
        stage_cfg = _dc.replace(cfg, eps_override=schedule[s],
                                tol=tols[s], stage_subsample=1.0)
        stage_data = data if (not sub_active or s == n_stages - 1) \
            else data_sub
        if mesh is not None:
            # check_overflow=False: _prepare_fit already guarded this
            # operand; re-probing at every anneal stage would be waste
            ws, mom, diag = fit_sharded(data, ws, stage_cfg, mesh, plan,
                                        strategy, check_overflow=False)
        else:
            ws, mom, diag = _fit_program(stage_data, ws, stage_cfg,
                                         strategy)
        stats["iters"][s] = int(diag.iters_per_stage[0])
        stats["tc"][s] = float(diag.tc_per_stage[0])
        stats["delta"][s] = float(diag.delta_per_stage[0])
        stats["obj"][s] = float(diag.objective_per_stage[0])
        if cfg.record_history:
            stats["hist"][s] = np.asarray(diag.tc_history[0])
        np.savez(state_path, ws=np.asarray(ws), stage=s + 1,
                 fingerprint=fp_arr, **stats)
        if stage_callback is not None:
            stage_callback(s, schedule[s], ws, stats)

    # finalize exactly like Corex.fit: full moments at eps=0 + factor sort
    # (no further solver steps)
    from linearcorex_tpu.core.solver import sort_by_tcs

    @jax.jit
    def _finalize(d, w):
        zero = jnp.asarray(0.0, w.dtype)
        c_xy = (M.cxy_gram(d, w, zero) if strategy == "gram"
                else M.cxy_samples(d, w, zero))
        mom = M.moments_from_cxy(w, c_xy, cfg.y_scale, cfg.rho_clip)
        w_sorted, order = sort_by_tcs(w, mom.tcs)
        return w_sorted, M.permute_moments(mom, order)

    model.ws, model.moments = _finalize(data, ws)
    dt = model._dt
    model.diagnostics = FitDiagnostics(
        iters_per_stage=jnp.asarray(stats["iters"]),
        tc_per_stage=jnp.asarray(stats["tc"], dt),
        delta_per_stage=jnp.asarray(stats["delta"], dt),
        objective_per_stage=jnp.asarray(stats["obj"], dt),
        tc_history=jnp.asarray(stats["hist"], dt),
        eps_schedule=jnp.asarray(schedule, dt))
    # mirror the plain fit's fitted attributes (n_restarts > 1 is
    # rejected above): lane 0 ≡ the plain fit
    model.best_restart_ = 0
    return model


def load_corex(path: str) -> Corex:
    """Reconstruct a fitted Corex (inference-ready; fit() warm-starts from
    the stored weights)."""
    path = _npz_path(path)
    with np.load(path) as z:
        if "meta_json" not in z.files:
            raise ValueError(
                f"{path} is not a linearcorex_tpu checkpoint "
                f"(missing meta_json; found keys {z.files[:5]})")
        meta = json.loads(bytes(z["meta_json"]).decode())
        if meta["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {meta['format_version']} is newer than "
                f"this library ({_FORMAT_VERSION})")
        # an option retired since the checkpoint was written (e.g. the
        # fused-chain kernel switch) selects nothing any more: drop it
        known = {f.name for f in dataclasses.fields(CorexConfig)}
        cfg = CorexConfig(**{k: v for k, v in meta["config"].items()
                             if k in known})
        pre = PreprocessConfig(**meta["pre_config"])
        model = Corex(
            n_hidden=cfg.n_hidden, max_iter=cfg.max_iter, tol=cfg.tol,
            anneal=cfg.anneal, missing_values=pre.missing_values,
            discourage_overlap=cfg.discourage_overlap,
            gaussianize=pre.gaussianize, y_scale=cfg.y_scale,
            seed=meta["seed"], dtype=cfg.dtype,
            moment_strategy=cfg.moment_strategy,
            record_history=cfg.record_history,
            matmul_dtype=cfg.matmul_dtype,
            matmul_precision=cfg.matmul_precision,
            optimizer=cfg.optimizer, momentum_beta=cfg.momentum_beta,
            init=getattr(cfg, "init", "random"),
            stage_tol_factor=cfg.stage_tol_factor,
            stage_subsample=cfg.stage_subsample,
            update_iter=meta.get("update_iter", 10),
            verbose=meta.get("verbose", False),
            # restored VERBATIM: a post-load fit() on an n_restarts>1
            # model raises by name (the warm-start x restarts guard
            # names load_corex) rather than silently fitting one lane
            n_restarts=meta.get("n_restarts", 1))
        dt = jnp.dtype(cfg.dtype)
        model.ws = jnp.asarray(z["ws"], dt)
        # re-arm the warm start: a post-load fit() starts from the stored
        # weights (fitted state alone no longer warm-starts — fit() is
        # fresh/idempotent per the sklearn contract)
        model._pretrained_ws = model.ws
        model.theta = Theta(mean=jnp.asarray(z["theta_mean"], dt),
                            std=jnp.asarray(z["theta_std"], dt))
        mom_fields = {name: jnp.asarray(z[f"mom_{name}"])
                      for name in Moments._fields}
        model.moments = Moments(**mom_fields)
        model.nv = meta["nv"]
        model.n_samples = meta["n_samples"]
        # pre-n_restarts checkpoints (no key) carry a single-lane fit
        best = meta.get("best_restart", 0)
        model.best_restart_ = None if best is None else int(best)
    return model

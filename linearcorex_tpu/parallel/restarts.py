"""Batched multi-restart solves via vmap (SURVEY.md §2.8 "EP" row, §7.2.2).

The reference runs random restarts as a serial Python loop
(`[U] linearcorex/linearcorex.py :: pick_n_hidden(repeat=k)` refits k times).
On an accelerator the restart axis is free parallelism: every core
function in this package is written batch-free, and restarts batch
through one `vmap` — a single compiled program whose GEMMs carry an extra
leading (batch) axis. The while_loop under vmap runs until the
slowest restart converges (per-lane convergence is carried in the predicate).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from linearcorex_tpu.config import CorexConfig
from linearcorex_tpu.core.solver import fit_core, sort_by_tcs
from linearcorex_tpu.models.corex import _make_obj_grad
from linearcorex_tpu.ops import moments as M

__all__ = ["init_restarts", "fit_restarts", "best_restart",
           "restart_batch_runner", "padded_lanes", "lane_oom_guidance"]


def seed_base(seed: Optional[int]) -> int:
    """Restart-sweep seed base: seed itself, or fresh entropy when None
    (like Corex(seed=None) — unseeded sweeps must differ across calls)."""
    if seed is None:
        return int(np.random.SeedSequence().generate_state(1)[0] % (2**31))
    return seed


def init_restarts(n_restarts: int, m: int, p: int, seed: Optional[int],
                  dtype) -> jax.Array:
    """Stack of seeded N(0, 1/sqrt(p)) inits — restart r uses NumPy
    RandomState(seed + r), matching single-fit seeding so restart 0 of a
    sweep equals a plain `Corex(seed=seed)` fit. seed=None draws a fresh
    random base (like Corex(seed=None)), so unseeded sweeps differ across
    calls instead of silently repeating base 0."""
    base = seed_base(seed)
    w0 = np.stack([
        np.random.RandomState(base + r).normal(
            loc=0.0, scale=1.0 / np.sqrt(p), size=(m, p))
        for r in range(n_restarts)
    ])
    return jnp.asarray(w0, dtype=dtype)


@partial(jax.jit, static_argnums=(2, 3))
def _fit_restarts_program(data, w0_batch, cfg: CorexConfig, strategy: str):
    """vmapped annealed fit + final moments, one XLA program for the whole
    restart sweep. Data (samples or Gram) is shared across the batch."""
    obj_grad = _make_obj_grad(data, cfg, strategy)

    def one(w0):
        ws, diag = fit_core(obj_grad, w0, cfg)
        zero = jnp.asarray(0.0, w0.dtype)
        c_xy = (M.cxy_gram(data, ws, zero)
                if strategy == "gram"
                else M.cxy_samples(data, ws, zero))
        mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
        ws_sorted, order = sort_by_tcs(ws, mom.tcs)
        return ws_sorted, M.permute_moments(mom, order), diag

    return jax.vmap(one)(w0_batch)


def fit_restarts(data, w0_batch, cfg: CorexConfig, strategy: str,
                 n_samples=None):
    """Run `len(w0_batch)` independent annealed fits in one batched program.

    Returns (ws_batch, Moments_batch, FitDiagnostics_batch); reduce with
    `best_restart`. Tip: pass cfg with record_history=False for large sweeps
    (history costs batch x n_stages x max_iter). `n_samples` feeds the
    optimizer='auto' policy when `data` is a Gram matrix (which carries no
    sample count); on the samples strategy it is inferred from the data."""
    from linearcorex_tpu.models.corex import resolve_config
    from linearcorex_tpu.ops.moments import QuantizedData
    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    if n_samples is None and strategy == "samples":
        n_samples = (data.q if isinstance(data, QuantizedData)
                     else data).shape[0]
    cfg = resolve_config(cfg, w0_batch.shape[-1], n_samples=n_samples)
    return _fit_restarts_program(data, w0_batch, cfg, strategy)


def fit_restarts_sharded(data, w0_batch, cfg: CorexConfig, strategy: str,
                         mesh, axis_name: str = "restarts",
                         n_samples=None, check_overflow: bool = True,
                         data_axis: Optional[str] = None):
    """Restart sweep with the RESTART axis sharded over a device mesh: each
    chip runs its slice of the batch — the zero-communication layout for
    many small/medium fits (the EP-analog row of SURVEY.md §2.8).
    Complements `parallel.sharding.fit_sharded`, which shards the data
    instead (one big fit).

    `data_axis` (a second mesh axis, e.g. 'data') additionally shards the
    SAMPLE rows of the operand across that axis — the combined
    restarts x data layout of BASELINE config 5 ("sample-sharded with
    psum moments; vmapped 32-restart sweep", SURVEY.md §2.8 DP+EP rows,
    §3.5): restart lanes split over `axis_name`, each lane's X row-blocks
    over `data_axis`, and GSPMD reduces each lane's p x m cross-moment
    over the data axis ONLY (audited: `parallel.audit.audit_restarts`;
    no collective rides the restart axis). This is the layout that makes
    a 32-restart cfg5 sweep feasible: with the data replicated, every
    device holds all of X beside its lanes' solver state.
    Samples strategy only: a Gram operand has no sample axis to shard.

    A caller-built `QuantizedData` operand runs the int8 accumulator-wrap
    guard eagerly here (the public sharded boundary is where pre-quantized
    operands bypass `quantize_samples`'s own guard); check_overflow=False
    opts out when the same operand was already guarded upstream."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from linearcorex_tpu.models.corex import resolve_config

    from linearcorex_tpu.ops.moments import QuantizedData, _check_int8_wrap
    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    if (isinstance(data, QuantizedData) and check_overflow
            and isinstance(data.q, (jax.Array, np.ndarray))):
        _check_int8_wrap(data)
    operand = data.q if isinstance(data, QuantizedData) else data
    if n_samples is None and strategy == "samples":
        n_samples = operand.shape[0]
    cfg = resolve_config(cfg, w0_batch.shape[-1], n_samples=n_samples)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    d = sizes.get(axis_name)
    if d is None or w0_batch.shape[0] % d:
        raise ValueError(
            f"the restart batch ({w0_batch.shape[0]} fits) shards over "
            f"mesh axis {axis_name!r} (size {d}); the batch must divide "
            f"evenly — pad the init stack (pick_n_hidden does this "
            f"automatically) or adjust the mesh")
    data_spec = P()
    if data_axis is not None:
        if strategy != "samples":
            raise ValueError(
                "data_axis shards the SAMPLE rows of X; a Gram operand "
                "carries none — the combined restarts x data layout is "
                "samples-strategy only")
        dd = sizes.get(data_axis)
        if dd is None or operand.shape[0] % dd:
            raise ValueError(
                f"data_axis={data_axis!r}: the {operand.shape[0]} sample "
                f"rows must divide the mesh axis (size {dd}) evenly — "
                f"trim/pad the rows or adjust the mesh (XLA shards "
                f"without padding)")
        data_spec = P(data_axis, None)
    w0_batch = jax.device_put(
        w0_batch, NamedSharding(mesh, P(axis_name, None, None)))
    if isinstance(data, QuantizedData):
        data = QuantizedData(
            q=jax.device_put(data.q, NamedSharding(mesh, data_spec)),
            scale=jax.device_put(data.scale, NamedSharding(mesh, P())))
    else:
        data = jax.device_put(data, NamedSharding(mesh, data_spec))
    with jax.set_mesh(mesh):
        return _fit_restarts_program(data, w0_batch, cfg, strategy)


import contextlib


@contextlib.contextmanager
def lane_oom_guidance(lanes):
    """Scope that re-raises a device RESOURCE_EXHAUSTED from a restart
    sweep with the lane-memory model and the remedies (the raw
    XLA error names no knob). Callers must allocate the lane batch AND
    consume (host-sync) the results INSIDE the scope — under JAX async
    dispatch the OOM can surface at first consumption, not at
    enqueue."""
    try:
        yield
    except jax.errors.JaxRuntimeError as e:
        if "RESOURCE_EXHAUSTED" not in str(e):
            raise
        raise type(e)(
            f"the {lanes}-lane restart sweep ran out of device memory: "
            f"every lane holds its own (n_hidden, n_variables) solver "
            f"state. Use fewer lanes (Corex n_restarts= / pick_n_hidden "
            f"repeat=), run the fits sequentially (seeded single fits; "
            f"pick_n_hidden(padded_sweep=False)), or shard the lane "
            f"axis over more devices (a mesh with a 'restarts' axis, "
            f"data_axis= for the combined restarts x data "
            f"layout).") from e


def padded_lanes(batch: int, axis_size: int) -> int:
    """Lane count after padding `batch` up to a multiple of the restart
    axis (GSPMD sharding needs divisibility) — the single definition
    shared by `restart_batch_runner` and `utils.compile_cache.
    warmup_fit` (the warmup must lower the padded lane count the runner
    actually dispatches; a forked copy would warm a dead cache key)."""
    return batch + ((-batch) % axis_size)


def restart_batch_runner(mesh, restart_axis: str = "restarts",
                         data_axis: Optional[str] = None):
    """Batch-fit dispatcher for restart sweeps: single-device
    `fit_restarts`, or — with a mesh — `fit_restarts_sharded` with the
    restart batch axis sharded over `restart_axis` (the
    zero-communication EP layout, SURVEY.md §2.8)
    and, when `data_axis` is given, the sample rows over that axis too
    (the combined restarts x data layout — for sweeps whose data is too
    large to replicate per device). A batch that does not divide the axis
    is padded by repeating the last init (GSPMD sharding needs
    divisibility) and the padded lanes are dropped from every result
    before selection/scoring. Shared by `pick_n_hidden` (candidate x
    restart lanes) and `Corex(n_restarts=k)` (seeded restart lanes).
    Both paths run under `lane_oom_guidance` with the results synced
    inside it, so a lane-memory OOM names the remedies instead of
    surfacing as a raw XLA error at some later consumption point."""
    if mesh is None:
        def run_single(data, w0, cfg, strategy, n):
            with lane_oom_guidance(w0.shape[0]):
                out = fit_restarts(data, w0, cfg, strategy, n_samples=n)
                jax.block_until_ready(out)
            return out

        return run_single
    if restart_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh has axes {mesh.axis_names}; the restart batch shards "
            f"over {restart_axis!r} — build the mesh with that axis "
            f"(make_mesh((({restart_axis!r}, n_devices),))) or pass "
            f"restart_axis=")
    d = dict(zip(mesh.axis_names, mesh.devices.shape))[restart_axis]

    def run(data, w0, cfg, strategy, n):
        pad = padded_lanes(w0.shape[0], d) - w0.shape[0]
        with lane_oom_guidance(w0.shape[0] + pad):
            if pad:
                w0 = jnp.concatenate(
                    [w0, jnp.repeat(w0[-1:], pad, axis=0)], axis=0)
            # check_overflow=False: every caller's prepare path already
            # ran the eager int8 wrap guard on this exact operand
            # (Corex._prepare_fit / pick_n_hidden's fused sweep prepare)
            out = fit_restarts_sharded(data, w0, cfg, strategy, mesh,
                                       axis_name=restart_axis,
                                       n_samples=n,
                                       check_overflow=False,
                                       data_axis=data_axis)
            jax.block_until_ready(out)
        if pad:
            out = jax.tree_util.tree_map(lambda a: a[:-pad], out)
        return out

    return run


def best_restart(ws_batch, mom_batch, diag_batch):
    """Select the restart with the highest final TC (the reference keeps the
    best-TC refit, SURVEY.md §2.7)."""
    best = jnp.argmax(mom_batch.tc)
    ws = ws_batch[best]
    mom = jax.tree_util.tree_map(lambda a: a[best], mom_batch)
    diag = jax.tree_util.tree_map(lambda a: a[best], diag_batch)
    return ws, mom, diag, best

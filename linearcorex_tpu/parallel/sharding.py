"""Multi-device execution: sharded moment computation over a device mesh.

The reference is strictly single-device (SURVEY.md §2.8: no parallelism of
any kind); its scalability analog table maps here as first-class components:

- **Sample (data) sharding** — the primary strategy (SURVEY.md §2.8 DP row):
  X is sharded along n across devices; each device computes its partial
  Xᵀ·Y; the p x m cross-moment reduces over the interconnect (NVLink
  within one host). This is BASELINE.json config 5 (p=100k, m=512,
  sample-sharded, "psum moments").
- **Variable sharding** — the long-axis analog (SURVEY.md §2.8 SP row): X
  column-blocks and W column-blocks live on different devices; per-variable
  quantities (S_i, v_i, MI sums) are local, the m x m C_y reduces over the
  variable shards. Required once p ≫ one device's memory.
- **Factor sharding** — TP over the m axis (rows of W); rho/MI/tcs are
  row-parallel, the cross-factor coupling Q = ry·rhoinvrho all-gathers the
  m x m ry.

Following the scaling-book recipe, sharding is expressed with
`jax.sharding.NamedSharding` annotations on the jitted fit program and XLA's
GSPMD partitioner inserts the collectives (all-reduces for the moment
reductions, all-gathers for the small m x m blocks; XLA:GPU hands them to
NCCL). There is no hand-rolled
comm layer — the reference has none to mirror (no NCCL/MPI, SURVEY.md §5),
and the entire communication surface of the algorithm is those two
reductions. Reductions in a fixed compiled program have a fixed order, which
gives run-to-run determinism on a fixed mesh (SURVEY.md §4.2 item 3).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from linearcorex_tpu.config import CorexConfig
from linearcorex_tpu.core.solver import fit_core, sort_by_tcs
from linearcorex_tpu.models.corex import (_make_obj_grad, precision_ctx,
                                          resolve_config)
from linearcorex_tpu.ops import moments as M

__all__ = ["ShardingPlan", "make_mesh", "make_hybrid_mesh", "fit_sharded",
           "fit_shard_map", "operand_specs", "SLICE_AXIS", "DATA_AXIS",
           "VAR_AXIS", "FACTOR_AXIS"]

DATA_AXIS = "data"     # shards the sample axis n (within one host)
VAR_AXIS = "var"       # shards the variable axis p
FACTOR_AXIS = "model"  # shards the factor axis m
SLICE_AXIS = "slice"   # OUTER sample-axis shard: the inter-host
#                        data-parallel axis of a 2-level host x device mesh


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """How one fit maps onto a mesh. Hashable → jit-static.

    shard_samples: split X rows (n) over DATA_AXIS          [DP, primary]
    shard_vars:    split X cols + W cols (p) over VAR_AXIS  [SP analog]
    shard_factors: split W rows (m) over FACTOR_AXIS        [TP]
    shard_slices:  split X rows over SLICE_AXIS too — the multi-host
                   layout (NVLink within a host, the network between
                   hosts): build a 2-level mesh
                   ((SLICE_AXIS, n_hosts), (DATA_AXIS, devices_per_host))
                   and the sample axis shards over BOTH, so each host
                   holds an n/n_hosts row-block and each device an
                   n/(n_hosts*devices) block. The p x m cross-moment
                   psum then reduces over host x device. Audited
                   mechanically in tests/test_sharding.py via
                   parallel.audit's replica-group parsing.
    Any combination over a multi-axis mesh is valid as long as the mesh
    has the named axes.
    """

    shard_samples: bool = True
    shard_vars: bool = False
    shard_factors: bool = False
    shard_slices: bool = False

    def _sample_axes(self):
        axes = []
        if self.shard_slices:
            axes.append(SLICE_AXIS)
        if self.shard_samples:
            axes.append(DATA_AXIS)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else tuple(axes)

    def x_spec(self) -> P:
        return P(self._sample_axes(),
                 VAR_AXIS if self.shard_vars else None)

    def w_spec(self) -> P:
        return P(FACTOR_AXIS if self.shard_factors else None,
                 VAR_AXIS if self.shard_vars else None)

    def y_spec(self) -> P:
        """(n, m) factor-matrix layout: rows over the sample axes, columns
        over FACTOR_AXIS — the transform-output / predict-input spec used
        by the sharded serving surface (`Corex.transform(mesh=...)`)."""
        return P(self._sample_axes(),
                 FACTOR_AXIS if self.shard_factors else None)

    def v_spec(self, ndim: int = 1) -> P:
        """(p,) / (p, k) operand layout (`covariance_matvec` / `_matmat`
        under a mesh): rows over VAR_AXIS, trailing dims replicated."""
        return P(VAR_AXIS if self.shard_vars else None,
                 *([None] * (ndim - 1)))


def operand_specs(plan: "ShardingPlan", strategy: str):
    """(data_spec, w_spec) for a fit operand under `plan` — the single
    definition shared by fit_sharded, parallel.audit.audit_fit, and
    utils.compile_cache.warmup_fit. strategy='gram' shards Σ's rows along
    the variable axis (the sample axes don't exist on a Gram operand)."""
    if strategy == "gram":
        if plan.shard_slices:
            raise ValueError(
                "shard_slices splits the SAMPLE axis; a Gram operand "
                "carries none — use shard_vars for multi-chip gram "
                "layouts (Σ row-blocks)")
        return (P(VAR_AXIS if plan.shard_vars else None, None),
                P(FACTOR_AXIS if plan.shard_factors else None, None))
    return plan.x_spec(), plan.w_spec()


def validate_plan_shapes(plan: "ShardingPlan", strategy: str, mesh: Mesh,
                         n: Optional[int], p: int, m: int,
                         raw_x: bool = False) -> None:
    """Fail fast, by name, on GSPMD's divisibility requirement: every
    sharded dimension must divide by the product of its mesh axes (XLA
    does not pad operands). Without this, the error surfaces as an
    opaque device_put sharding exception deep inside jit (found by the
    round-3 fuzzer). Pad or trim the data — or drop the offending plan
    flag — to fix.

    raw_x=True: the caller shards the RAW X (n x p) per `plan.x_spec()`
    BEFORE the operand is built (the mesh-aware prepare, `Corex.
    _prepare_fit(mesh=...)` / `warmup_fit(mesh=...)`), so the sample-axis
    check applies even when strategy='gram' — the Gram OPERAND has no
    sample axis, but the raw input being sharded does."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def need(axes_used, dim, value, what):
        total = 1
        for a in axes_used:
            if a not in sizes:
                raise ValueError(
                    f"plan shards {what} over mesh axis {a!r}, but the "
                    f"mesh has axes {tuple(sizes)} — build the mesh with "
                    f"that axis (make_mesh) or change the ShardingPlan")
            total *= sizes[a]
        if value % total:
            raise ValueError(
                f"{what} = {value} is not divisible by the mesh's "
                f"{'x'.join(axes_used)} extent ({total}); XLA shards "
                f"without padding — trim/pad the {dim} dimension or "
                f"adjust the plan/mesh")

    if raw_x or strategy != "gram":
        sample_axes = [a for a, on in ((SLICE_AXIS, plan.shard_slices),
                                       (DATA_AXIS, plan.shard_samples))
                       if on]
        if sample_axes and n is not None:
            need(sample_axes, "sample", n, "n_samples")
    if plan.shard_vars:
        need([VAR_AXIS], "variable", p, "n_variables")
    if plan.shard_factors:
        need([FACTOR_AXIS], "factor", m, "n_hidden")


def make_mesh(axes: Optional[Tuple[Tuple[str, int], ...]] = None,
              devices=None) -> Mesh:
    """Build a named mesh. Default: 1-D data-parallel mesh over all devices.
    A plain reshape of the device list: the cards of one host reach each
    other all to all over NVLink, so no device order is better than
    another.

    axes: tuple of (axis_name, size); sizes must multiply to len(devices).
    """
    if devices is None:
        devices = jax.devices()
    if axes is None:
        axes = ((DATA_AXIS, len(devices)),)
    names = tuple(a for a, _ in axes)
    sizes = tuple(s for _, s in axes)
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, names)


def make_hybrid_mesh(axes, devices=None, *, granule_key=None) -> Mesh:
    """Build the 2-level multi-host mesh: devices grouped by host, so that
    the outer SLICE_AXIS is the inter-host (network) axis and every inner
    axis stays inside one host's NVLink domain. `make_mesh` reshapes
    `jax.devices()` in enumeration order, which need not group devices by
    host; this helper groups them explicitly. The audit classification
    (`parallel.audit.groups_subset_of_axis`) indexes LOGICAL mesh
    positions, so the comm-surface tests hold unchanged on these meshes
    (tests/test_sharding.py).

    axes: ((SLICE_AXIS, n_hosts), (name, size), ...) — the FIRST axis
      must be `SLICE_AXIS` (the inter-host axis); the remaining axes are
      within one host.
    devices: defaults to `jax.devices()` — on a multi-host deployment
      call `jax.distributed.initialize()` first so this is the GLOBAL
      device list (docs/SCALING.md has the recipe).
    granule_key: optional callable `device -> host id`; defaults to
      `device.process_index` (one process per host). Tests pass their own
      key, since a single CPU process is one host. Groups are ordered by
      sorted key.

    Returns a `Mesh` of shape (n_hosts, *intra_sizes) with the given axis
    names; pass it to `fit_sharded` with a `shard_slices=True` plan.
    """
    names = tuple(a for a, _ in axes)
    sizes = tuple(s for _, s in axes)
    if not names or names[0] != SLICE_AXIS:
        raise ValueError(
            f"the first axis of a hybrid mesh must be {SLICE_AXIS!r} "
            f"(the inter-host axis); got axes {names} — reorder, or use "
            f"make_mesh for single-host layouts")
    n_hosts, intra_sizes = sizes[0], sizes[1:]
    if devices is None:
        devices = jax.devices()
    if len(devices) != int(np.prod(sizes)):
        raise ValueError(
            f"axes {dict(axes)} need {int(np.prod(sizes))} devices, "
            f"got {len(devices)}")
    if granule_key is None:
        granule_key = lambda d: d.process_index  # noqa: E731
    groups: dict = {}
    for d in devices:
        groups.setdefault(granule_key(d), []).append(d)
    if len(groups) != n_hosts:
        raise ValueError(
            f"the devices come from {len(groups)} hosts (slices); the "
            f"mesh asks for {n_hosts}")
    per_host = int(np.prod(intra_sizes, dtype=int))
    blocks = []
    for key in sorted(groups):
        g = groups[key]
        if len(g) != per_host:
            raise ValueError(
                f"host {key!r} holds {len(g)} devices; the intra-host "
                f"axes {dict(axes[1:])} need {per_host}")
        blocks.append(np.asarray(g))
    return Mesh(np.stack(blocks).reshape(sizes), names)


@partial(jax.jit, static_argnums=(2, 3, 4))
def _fit_program_sharded(data, w0, cfg: CorexConfig, plan: ShardingPlan,
                         strategy: str):
    """Identical math to models.corex._fit_program; the sharding of the
    operands makes GSPMD partition every GEMM and insert the
    collectives. Keeping one code path for 1-device and N-device execution is
    the point: sharded-vs-single equivalence is a test invariant."""
    with precision_ctx(cfg):
        obj_grad = _make_obj_grad(data, cfg, strategy)
        ws, diag = fit_core(obj_grad, w0, cfg)
        zero = jnp.asarray(0.0, w0.dtype)
        c_xy = (M.cxy_gram(data, ws, zero) if strategy == "gram"
                else M.cxy_samples(data, ws, zero))
        mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
        ws_sorted, order = sort_by_tcs(ws, mom.tcs)
        return ws_sorted, M.permute_moments(mom, order), diag


@partial(jax.jit, static_argnums=(2, 3, 4))
def _fit_program_shard_map(x, w0, cfg: CorexConfig, mesh_axis: str,
                           mesh: Mesh):
    """Explicit-collective variant of the sample-sharded fit via shard_map.

    Where `_fit_program_sharded` lets GSPMD infer the collectives from
    sharding annotations, this path spells them out: each device holds an
    n/d row-block of X, computes its partial Xᵀ(XWᵀ) and psums the p x m
    cross-moment — the algorithm's entire communication surface
    (SURVEY.md §2.8). Everything downstream of the psum is replicated
    per device.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as PS

    n_total = x.shape[0]

    def sharded_fit(x_local, w0_rep):
        def apply_sigma(v_t):
            # v_t: (p, k) replicated; returns Σ_emp·v_t via local partial +
            # psum over the data axis — the ONLY collective in the fit.
            part = M._mm(x_local.T, M._mm(x_local, v_t)) / n_total
            return jax.lax.psum(part, mesh_axis)

        def obj_grad(ws, eps):
            c0 = apply_sigma(ws.T)
            c_xy = (1.0 - eps ** 2) * c0 + (eps ** 2) * ws.T
            if cfg.optimizer == "fixed_point":
                # Ŵ is m x m algebra on the psum'd cross-moment — no
                # further collectives needed
                return M.ns_fp_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
            mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
            aa, hmat, coef, sqz = M._ns_gradient_terms(mom)
            aas = apply_sigma(aa.T).T
            aas = (1.0 - eps ** 2) * aas + (eps ** 2) * aa
            grad = (aas + M._mm(hmat, mom.rho)
                    - coef[:, None] * mom.rho) / sqz[:, None]
            return mom.objective, grad, mom.tc

        ws, diag = fit_core(obj_grad, w0_rep, cfg)
        c_xy = apply_sigma(ws.T)
        mom = M.moments_from_cxy(ws, c_xy, cfg.y_scale, cfg.rho_clip)
        ws_sorted, order = sort_by_tcs(ws, mom.tcs)
        return ws_sorted, M.permute_moments(mom, order), diag

    with precision_ctx(cfg):
        return shard_map(
            sharded_fit, mesh=mesh,
            in_specs=(PS(mesh_axis, None), PS()),
            out_specs=(PS(), PS(), PS()),   # pytree prefixes: all replicated
            check_vma=False,
        )(x, w0)


def fit_shard_map(x, w0, cfg: CorexConfig, mesh: Mesh,
                  axis_name: str = DATA_AXIS):
    """Sample-sharded fit with explicit psum collectives (shard_map).

    Equivalent to `fit_sharded` with the default plan, with the
    collectives spelled out in the program instead of inferred by GSPMD.
    Only the non-overlap solver path is supported here."""
    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache
    ensure_compile_cache()
    if not cfg.discourage_overlap:
        raise ValueError("fit_shard_map supports discourage_overlap=True "
                         "only; use fit_sharded for the overlap path")
    from linearcorex_tpu.ops.moments import QuantizedData
    if isinstance(x, QuantizedData) or cfg.matmul_dtype == "int8":
        raise ValueError(
            "fit_shard_map spells out its own f32/bf16 collectives; use "
            "fit_sharded (GSPMD) for matmul_dtype='int8' — it partitions "
            "the quantized program and was verified against the "
            "single-device int8 fit")
    cfg = resolve_config(cfg, x.shape[1], n_samples=x.shape[0])
    if cfg.stage_subsample < 1.0 and len(cfg.anneal_schedule()) > 1:
        # this path builds its own explicit-psum obj_grad, so the
        # one-program guard in models.corex._make_obj_grad cannot catch
        # it — mirror it (fit_shard_map is always samples-strategy)
        raise ValueError(
            "stage_subsample < 1 is not supported by fit_shard_map (one "
            "program over the whole schedule); set stage_subsample=1, or "
            "fit single-device via Corex.fit")
    d = dict(zip(mesh.axis_names, mesh.devices.shape)).get(axis_name)
    if d is None or x.shape[0] % d:
        raise ValueError(
            f"fit_shard_map shards the {x.shape[0]} sample rows over mesh "
            f"axis {axis_name!r} (size {d}); the row count must divide "
            f"evenly (XLA shards without padding)")
    x = jax.device_put(x, NamedSharding(mesh, P(axis_name, None)))
    w0 = jax.device_put(w0, NamedSharding(mesh, P()))
    return _fit_program_shard_map(x, w0, cfg, axis_name, mesh)


def fit_sharded(data, w0, cfg: CorexConfig, mesh: Mesh,
                plan: ShardingPlan = ShardingPlan(),
                strategy: str = "samples", n_samples=None,
                check_overflow: bool = True):
    """Run the annealed fit with the data laid out per `plan` on `mesh`.

    strategy='samples': `data` is X (n x p); shardable along samples and/or
    variables per the plan. strategy='gram': `data` is Σ = XᵀX/n (p x p);
    its rows shard along the variable axis (the multi-chip layout for
    medium-p, high-iteration fits — Σ row-blocks live on different devices,
    ΣWᵀ row-blocks are device-local, and the small m x m products reduce
    across devices). Returns (ws, Moments, FitDiagnostics) with ws
    replicated (m x p — small, needed by every device each iteration).

    A caller-built `QuantizedData` operand runs the int8 accumulator-wrap
    guard eagerly here (this public boundary is exactly where pre-quantized
    operands arrive, bypassing `quantize_samples`'s own guard); pass
    check_overflow=False only when the same operand was already guarded —
    `Corex.fit(mesh=...)` does, having guarded in `_prepare_fit`."""
    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache
    ensure_compile_cache()
    # 'auto' knobs resolve against the shapes (resolve_config — shared
    # with warmup_fit so AOT compiles the same program).
    # A Gram operand carries no sample count — pass `n_samples` explicitly
    # there (Corex.fit(mesh=...) has already resolved the optimizer before
    # reaching here), else 'auto' falls back to the robust momentum
    from linearcorex_tpu.ops.moments import QuantizedData

    operand = data.q if isinstance(data, QuantizedData) else data
    if (isinstance(data, QuantizedData) and check_overflow
            and isinstance(operand, (jax.Array, np.ndarray))):
        M._check_int8_wrap(data)
    if n_samples is None and strategy == "samples":
        n_samples = operand.shape[0]
    cfg = resolve_config(cfg, operand.shape[-1], n_samples=n_samples)
    validate_plan_shapes(
        plan, strategy, mesh,
        operand.shape[0] if strategy != "gram" else None,
        operand.shape[-1], w0.shape[0])
    data_spec, w_spec = operand_specs(plan, strategy)
    if isinstance(data, QuantizedData):
        # shard the int8 operand like the plain one; the per-tensor scale
        # is a replicated scalar. The quantized math is shape-global
        # (int8 GEMM partials reduce like the f32 ones; the mid-chain
        # per-column operand maxes become cross-shard reduces), so GSPMD
        # partitions it the same way — verified against the single-device
        # int8 fit on the CPU mesh (tests/test_int8.py).
        data = QuantizedData(
            q=jax.device_put(data.q, NamedSharding(mesh, data_spec)),
            scale=jax.device_put(data.scale, NamedSharding(mesh, P())))
    else:
        data = jax.device_put(data, NamedSharding(mesh, data_spec))
    w0 = jax.device_put(w0, NamedSharding(mesh, w_spec))
    with jax.set_mesh(mesh):
        return _fit_program_sharded(data, w0, cfg, plan, strategy)

"""Collective-traffic audit of compiled sharded programs.

SURVEY.md §2.8 claims the algorithm's entire communication surface is two
reductions (a psum of the p x m cross-moment over the data axis; an
all-gather of small m-sized blocks under factor sharding). Multi-chip
hardware is not available in CI, but the claim is checkable WITHOUT
hardware: compile the sharded program for a virtual mesh and read the
collectives XLA actually emitted out of the optimized HLO. `audit_fit`
returns every collective op with its payload shape/bytes AND its replica
groups (materialized to device-id tuples), so tests (and capacity
planning) can assert the comm surface — including WHICH mesh axis each
collective rides, the load-bearing fact for a 2-level host x device
mesh, where the inner axes stay on one host's NVLink and the outer
'slice' axis crosses the inter-host network (SURVEY.md §2.8 comm row;
tests/test_sharding.py multi-host tests).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["CollectiveOp", "hlo_collectives", "audit_fit",
           "groups_subset_of_axis"]

# optimized-HLO instruction names that move data between devices.
# `-start` is matched (the async form's initiating op carries the payload
# shape); the paired `-done` is deliberately NOT matched — counting both
# halves of one async collective would double every payload.
_COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*"
    r"(\([^)]*\)|[\w\[\],{}]+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|"
    r"all-to-all)(?:-start)?\(")

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s32|u32|s8|u8|pred)\[([\d,]*)\]")

_ITEMSIZE = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
             "s8": 1, "u8": 1, "pred": 1}

# replica_groups comes in two spellings in optimized HLO:
#   explicit:  replica_groups={{0,1,2,3},{4,5,6,7}}
#   iota:      replica_groups=[2,4]<=[4,2]T(1,0)
#              ([num_groups,group_size] <= iota over [dims] transposed by T)
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{(\{[\d, ]*\}"
                                 r"(?:,\{[\d, ]*\})*)\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
    r"(?:T\(([\d,]+)\))?")


@dataclass(frozen=True)
class CollectiveOp:
    kind: str          # all-reduce | all-gather | ...
    shapes: tuple      # payload shapes as strings, e.g. ('f32[64,8]',)
    bytes: int         # total payload bytes (one device's share)
    groups: Tuple[Tuple[int, ...], ...] = field(default=())
    # device-id groups the collective runs over; () when the HLO line
    # carried no replica_groups (e.g. collective-permute source-target
    # pairs, or cross-replica defaults)

    @property
    def group_size(self) -> int:
        """Devices per group (0 when groups are unknown)."""
        return len(self.groups[0]) if self.groups else 0


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _ITEMSIZE[dtype]
    return total


def _parse_groups(line: str) -> Tuple[Tuple[int, ...], ...]:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        import numpy as np
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(d) for d in m.group(3).split(",")]
        arr = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            arr = arr.transpose([int(d) for d in m.group(4).split(",")])
        return tuple(map(tuple, arr.reshape(g, s)))
    m = _GROUPS_EXPLICIT_RE.search(line)
    if m:
        return tuple(
            tuple(int(v) for v in grp.split(",") if v.strip())
            for grp in m.group(1).strip("{}").split("},{"))
    return ()


def groups_subset_of_axis(op: CollectiveOp, mesh, axis: str) -> bool:
    """True when every group of `op` stays within one set of devices that
    differ ONLY along `axis` of `mesh` — i.e. the collective rides that
    mesh axis (for a 2-level host x device mesh: 'data' groups stay on
    one host's NVLink, 'slice' groups cross the inter-host network).
    Groups spanning several axes return False
    for each single axis.

    HLO replica_groups index the program's LOGICAL device assignment
    (position in mesh.devices' flattened order), NOT physical device ids
    — on a mesh built from a permuted device array (every real
    multi-host mesh, e.g. sharding.make_hybrid_mesh) the two
    differ, so classification must use positional indices
    (tests/test_sharding.py permuted-mesh regression)."""
    import numpy as np
    pos = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    k = mesh.axis_names.index(axis)
    lines = np.moveaxis(pos, k, -1).reshape(-1, pos.shape[k])
    line_sets = [frozenset(int(v) for v in row) for row in lines]
    return all(
        any(frozenset(g) <= s for s in line_sets) for g in op.groups
    ) if op.groups else False


def hlo_collectives(hlo_text: str) -> List[CollectiveOp]:
    """Parse collectives out of optimized HLO text (`-start` and plain
    forms; the paired `-done` ops are excluded so each async collective
    is counted once). Each op carries its payload shapes/bytes and its
    replica groups materialized to device-id tuples (both the explicit
    and the iota `[G,S]<=[dims]T(perm)` HLO spellings)."""
    ops = []
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.match(line)
        if not m:
            continue
        shape_text, kind = m.group(1), m.group(2)
        shapes = tuple(f"{d}[{s}]"
                       for d, s in _SHAPE_RE.findall(shape_text))
        ops.append(CollectiveOp(kind=kind, shapes=shapes,
                                bytes=_shape_bytes(shape_text),
                                groups=_parse_groups(line)))
    return ops


def audit_fit(data, w0, cfg, mesh, plan=None, strategy="samples",
              n_samples=None):
    """Compile (without executing) the sharded fit for `mesh` and return
    its collectives. Uses the same program `fit_sharded` runs — including
    its config resolution, so pass the same `n_samples` you would pass to
    `fit_sharded` for a Gram operand with optimizer='auto' (otherwise the
    audit would report the momentum program's collectives while the fit
    runs the fixed-point one).

    `data` may be a plain array / ShapeDtypeStruct (f32/bf16 layouts) or a
    `QuantizedData` (audits the int8 program directly — its collective
    surface is a SUPERSET of the f32 one: the same reduces over the same
    axes, plus per-column operand-max reductions from the mid-chain
    requantization on sharded layouts)."""
    import jax
    from jax.sharding import NamedSharding

    from linearcorex_tpu.ops.moments import QuantizedData
    from linearcorex_tpu.parallel import sharding as S

    plan = plan or S.ShardingPlan()
    quant = isinstance(data, QuantizedData)
    operand = data.q if quant else data
    if quant and cfg.matmul_dtype != "int8":
        raise ValueError(
            "a QuantizedData operand requires cfg.matmul_dtype='int8' "
            "(the audited program must be the one fit_sharded would run)")
    if n_samples is None and strategy == "samples":
        n_samples = operand.shape[0]
    from linearcorex_tpu.models.corex import resolve_config
    cfg = resolve_config(cfg, operand.shape[-1], n_samples=n_samples)
    S.validate_plan_shapes(
        plan, strategy, mesh,
        operand.shape[0] if strategy != "gram" else None,
        operand.shape[-1], w0.shape[0])
    data_spec, w_spec = S.operand_specs(plan, strategy)
    data_arg = jax.ShapeDtypeStruct(
        operand.shape, operand.dtype,
        sharding=NamedSharding(mesh, data_spec))
    if quant:
        import jax.numpy as jnp
        data_arg = QuantizedData(
            q=data_arg,
            scale=jax.ShapeDtypeStruct((), jnp.float32,
                                       sharding=NamedSharding(mesh,
                                                              S.P())))
    lowered = S._fit_program_sharded.lower(
        data_arg,
        jax.ShapeDtypeStruct(w0.shape, w0.dtype,
                             sharding=NamedSharding(mesh, w_spec)),
        cfg, plan, strategy)
    hlo = lowered.compile().as_text()
    return hlo_collectives(hlo)


def audit_restarts(data, w0_batch, cfg, mesh, strategy="samples",
                   axis_name="restarts", data_axis=None, n_samples=None):
    """Compile (without executing) the sharded restart sweep and return
    its collectives — the audit companion of
    `parallel.restarts.fit_restarts_sharded`. With `data_axis` set (the
    combined restarts x data layout, BASELINE config 5) the expected
    surface is: p x m-shaped all-reduces riding the data axis only, and
    NOTHING riding the restart axis (restart lanes are independent);
    tests/test_sharding.py asserts exactly that. `data`/`w0_batch` may be
    arrays or ShapeDtypeStructs."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from linearcorex_tpu.models.corex import resolve_config
    from linearcorex_tpu.ops.moments import QuantizedData
    from linearcorex_tpu.parallel.restarts import _fit_restarts_program

    quant = isinstance(data, QuantizedData)
    operand = data.q if quant else data
    if quant and cfg.matmul_dtype != "int8":
        raise ValueError(
            "a QuantizedData operand requires cfg.matmul_dtype='int8' "
            "(the audited program must be the one the sweep would run)")
    if data_axis is not None and strategy != "samples":
        raise ValueError(
            "data_axis shards sample rows; the combined layout is "
            "samples-strategy only (fit_restarts_sharded raises too)")
    if n_samples is None and strategy == "samples":
        n_samples = operand.shape[0]
    cfg = resolve_config(cfg, w0_batch.shape[-1], n_samples=n_samples)
    data_spec = P(data_axis, None) if data_axis is not None else P()
    data_arg = jax.ShapeDtypeStruct(
        operand.shape, operand.dtype,
        sharding=NamedSharding(mesh, data_spec))
    if quant:
        import jax.numpy as jnp
        data_arg = QuantizedData(
            q=data_arg,
            scale=jax.ShapeDtypeStruct((), jnp.float32,
                                       sharding=NamedSharding(mesh, P())))
    w_arg = jax.ShapeDtypeStruct(
        w0_batch.shape, w0_batch.dtype,
        sharding=NamedSharding(mesh, P(axis_name, None, None)))
    hlo = _fit_restarts_program.lower(
        data_arg, w_arg, cfg, strategy).compile().as_text()
    return hlo_collectives(hlo)

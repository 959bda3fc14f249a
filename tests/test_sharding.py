"""Multi-chip equivalence tests on the 8-device virtual CPU mesh
(SURVEY.md §4.2 item 3): every sharded layout must produce the same fit as
the single-device program to fp tolerance, and layouts must agree with each
other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.config import CorexConfig
from linearcorex_tpu.ops import preprocessing as P
from linearcorex_tpu.parallel.sharding import (DATA_AXIS, FACTOR_AXIS,
                                               VAR_AXIS, ShardingPlan,
                                               fit_sharded, make_mesh)
from tests.conftest import block_data


@pytest.fixture(scope="module")
def setup():
    x = block_data(n=512, p=64, m=8, seed=0)
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(8, 64))
    xj = jnp.asarray(x, jnp.float64)
    xp, _ = P.fit_preprocess(xj, "standard")
    cfg = CorexConfig(n_hidden=8, dtype="float64", record_history=False)
    # single-device reference fit (samples strategy = same code path)
    ref = lc.Corex(n_hidden=8, dtype="float64", record_history=False,
                   moment_strategy="samples").fit(x, init_ws=w0)
    return xp, jnp.asarray(w0, jnp.float64), cfg, ref


def _check(ws, mom, ref):
    assert np.abs(np.asarray(ws) - np.asarray(ref.ws)).max() < 1e-7
    assert abs(float(mom.tc) - ref.tc) < 1e-7


def test_devices_available():
    assert len(jax.devices()) == 8


def test_data_sharded_fit(setup):
    xp, w0, cfg, ref = setup
    mesh = make_mesh(((DATA_AXIS, 8),))
    ws, mom, diag = fit_sharded(xp, w0, cfg, mesh, ShardingPlan())
    _check(ws, mom, ref)


def test_var_sharded_fit(setup):
    xp, w0, cfg, ref = setup
    mesh = make_mesh(((VAR_AXIS, 8),))
    plan = ShardingPlan(shard_samples=False, shard_vars=True)
    ws, mom, diag = fit_sharded(xp, w0, cfg, mesh, plan)
    _check(ws, mom, ref)


def test_factor_sharded_fit(setup):
    xp, w0, cfg, ref = setup
    mesh = make_mesh(((FACTOR_AXIS, 8),))
    plan = ShardingPlan(shard_samples=False, shard_factors=True)
    ws, mom, diag = fit_sharded(xp, w0, cfg, mesh, plan)
    _check(ws, mom, ref)


def test_2d_mesh_data_factor(setup):
    xp, w0, cfg, ref = setup
    mesh = make_mesh(((DATA_AXIS, 4), (FACTOR_AXIS, 2)))
    plan = ShardingPlan(shard_samples=True, shard_factors=True)
    ws, mom, diag = fit_sharded(xp, w0, cfg, mesh, plan)
    _check(ws, mom, ref)


def test_2d_mesh_data_var(setup):
    xp, w0, cfg, ref = setup
    mesh = make_mesh(((DATA_AXIS, 2), (VAR_AXIS, 4)))
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    ws, mom, diag = fit_sharded(xp, w0, cfg, mesh, plan)
    _check(ws, mom, ref)


def test_sharded_deterministic(setup):
    """Same mesh + same program ⇒ bitwise-identical results across runs
    (fixed reduction order, SURVEY.md §7.3 item 3)."""
    xp, w0, cfg, ref = setup
    mesh = make_mesh(((DATA_AXIS, 8),))
    ws1, mom1, _ = fit_sharded(xp, w0, cfg, mesh, ShardingPlan())
    ws2, mom2, _ = fit_sharded(xp, w0, cfg, mesh, ShardingPlan())
    assert np.array_equal(np.asarray(ws1), np.asarray(ws2))
    assert float(mom1.tc) == float(mom2.tc)


def test_restart_axis_sharded_matches_unsharded():
    """Sharding the restart axis over the mesh reproduces the vmapped sweep
    (zero-communication layout — BASELINE config 5's 32-restart sweep)."""
    from linearcorex_tpu.parallel.restarts import (fit_restarts,
                                                   fit_restarts_sharded,
                                                   init_restarts)
    x = block_data(n=256, p=64, m=4, seed=1)
    xp, _ = P.fit_preprocess(jnp.asarray(x, jnp.float64), "standard")
    cfg = CorexConfig(n_hidden=4, dtype="float64", record_history=False,
                      max_iter=1500)
    w0 = init_restarts(8, 4, 64, seed=3, dtype=jnp.float64)
    ws_u, mom_u, _ = fit_restarts(xp, w0, cfg, "samples")
    mesh = make_mesh((("restarts", 8),))
    ws_s, mom_s, _ = fit_restarts_sharded(xp, w0, cfg, "samples", mesh)
    assert np.abs(np.asarray(ws_s) - np.asarray(ws_u)).max() < 1e-8
    assert np.abs(np.asarray(mom_s.tc) - np.asarray(mom_u.tc)).max() < 1e-8


def test_gram_var_sharded_fit(setup):
    """Gram strategy with Σ row-sharded over the variable axis equals the
    single-device gram fit."""
    from linearcorex_tpu.ops import moments as M
    from linearcorex_tpu.models.corex import _fit_program
    xp, w0, cfg, ref = setup
    gram = M.compute_gram(xp)
    ws_1, mom_1, _ = _fit_program(gram, w0, cfg, "gram")
    mesh = make_mesh(((VAR_AXIS, 8),))
    plan = ShardingPlan(shard_samples=False, shard_vars=True)
    ws_s, mom_s, _ = fit_sharded(gram, w0, cfg, mesh, plan, strategy="gram")
    assert np.abs(np.asarray(ws_s) - np.asarray(ws_1)).max() < 1e-7
    assert abs(float(mom_s.tc) - float(mom_1.tc)) < 1e-7


def test_shard_map_explicit_psum_matches(setup):
    """The explicit-collective shard_map path equals GSPMD and single-device
    fits."""
    from linearcorex_tpu.parallel.sharding import fit_shard_map
    xp, w0, cfg, ref = setup
    mesh = make_mesh(((DATA_AXIS, 8),))
    ws, mom, diag = fit_shard_map(xp, w0, cfg, mesh)
    _check(ws, mom, ref)


def test_resolve_config_auto_platform_rules():
    """'auto' resolution depends on the data shapes alone, never on the
    device platform: the resolver takes no platform, and a config
    resolves identically whatever backend runs it (the GPU and the CPU
    test mesh resolve the same)."""
    import inspect

    from linearcorex_tpu.models.corex import resolve_config
    assert "platform" not in inspect.signature(resolve_config).parameters
    for cfg in (CorexConfig(n_hidden=128, optimizer="auto"),
                CorexConfig(n_hidden=128, optimizer="auto",
                            dtype="float64"),
                CorexConfig(n_hidden=128, optimizer="auto",
                            discourage_overlap=False)):
        a = resolve_config(cfg, 256, n_samples=512)
        b = resolve_config(cfg, 256, n_samples=512)
        assert a == b
        assert a.optimizer == ("fixed_point" if cfg.discourage_overlap
                               else "momentum")
        assert resolve_config(cfg, 256, n_samples=100).optimizer \
            == "momentum"


def test_shard_map_fixed_point_matches_single_device():
    """fit_shard_map with optimizer='fixed_point' (the psum'd cross-moment
    feeds the m x m closed-form update locally) equals the single-device
    fixed-point fit."""
    x = block_data(n=512, p=64, m=8, seed=0)
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(8, 64))
    xj = jnp.asarray(x, jnp.float64)
    xp, _ = P.fit_preprocess(xj, "standard")
    from linearcorex_tpu.parallel.sharding import fit_shard_map
    cfg = CorexConfig(n_hidden=8, dtype="float64", record_history=False,
                      optimizer="fixed_point")
    mesh = make_mesh(((DATA_AXIS, 8),))
    ws, mom, _ = fit_shard_map(xp, w0, cfg, mesh)
    ref = lc.Corex(n_hidden=8, dtype="float64", record_history=False,
                   optimizer="fixed_point",
                   moment_strategy="samples").fit(x, init_ws=w0)
    assert np.abs(np.asarray(ws) - np.asarray(ref.ws)).max() < 1e-7
    assert abs(float(mom.tc) - ref.tc) < 1e-7


def test_corex_fit_with_mesh_matches_plain_fit(setup):
    """The estimator-surface mesh bridge: Corex.fit(x, mesh=...) equals the
    single-device fit (GSPMD over 8 virtual devices), and inference from
    the replicated state works unchanged."""
    x = block_data(n=512, p=64, m=8, seed=0)
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(8, 64))
    mesh = make_mesh(((DATA_AXIS, 8),))
    cm = lc.Corex(n_hidden=8, dtype="float64", record_history=False).fit(
        x, init_ws=w0, mesh=mesh)
    cs = lc.Corex(n_hidden=8, dtype="float64", record_history=False,
                  moment_strategy="samples").fit(x, init_ws=w0)
    assert abs(cm.tc - cs.tc) < 1e-7
    assert np.abs(np.asarray(cm.ws) - np.asarray(cs.ws)).max() < 1e-7
    y = cm.transform(x)
    assert np.abs(np.asarray(y) - np.asarray(cs.transform(x))).max() < 1e-7
    assert np.isfinite(np.asarray(cm.get_covariance())).all()


def test_corex_fit_with_mesh_and_plan(setup):
    """An explicit 2-D dp x tp plan through the estimator surface."""
    x = block_data(n=512, p=64, m=8, seed=0)
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(8, 64))
    mesh = make_mesh(((DATA_AXIS, 4), (FACTOR_AXIS, 2)))
    plan = ShardingPlan(shard_samples=True, shard_factors=True)
    cm = lc.Corex(n_hidden=8, dtype="float64", record_history=False).fit(
        x, init_ws=w0, mesh=mesh, sharding_plan=plan)
    cs = lc.Corex(n_hidden=8, dtype="float64", record_history=False,
                  moment_strategy="samples").fit(x, init_ws=w0)
    assert abs(cm.tc - cs.tc) < 1e-7


def test_dp_comm_surface_is_pxm_allreduce_only():
    """Mechanical check of SURVEY §2.8's comm-surface claim: the compiled
    sample-sharded (DP) program's ONLY collectives are all-reduces whose
    payloads are p x m cross-moments (plus scalars) — no all-gathers, no
    all-to-alls, nothing O(n) or O(p²)."""
    from linearcorex_tpu.parallel.audit import audit_fit
    p, m, n = 64, 8, 512
    x = jax.ShapeDtypeStruct((n, p), jnp.float32)
    w = jax.ShapeDtypeStruct((m, p), jnp.float32)
    cfg = CorexConfig(n_hidden=m, record_history=False, max_iter=50)
    mesh = make_mesh(((DATA_AXIS, 8),))
    ops = audit_fit(x, w, cfg, mesh, ShardingPlan())
    assert ops, "expected collectives in the sharded program"
    assert all(o.kind == "all-reduce" for o in ops), \
        [o.kind for o in ops]
    pm_bytes = p * m * 4
    assert all(o.bytes <= pm_bytes for o in ops), \
        [(o.kind, o.shapes, o.bytes) for o in ops]


def test_var_sharded_comm_is_nm_and_mm():
    """Variable-sharded layout: collectives are the n x m factor
    reduction and m-sized blocks — never p-sized."""
    from linearcorex_tpu.parallel.audit import audit_fit
    p, m, n = 64, 8, 512
    x = jax.ShapeDtypeStruct((n, p), jnp.float32)
    w = jax.ShapeDtypeStruct((m, p), jnp.float32)
    cfg = CorexConfig(n_hidden=m, record_history=False, max_iter=50)
    mesh = make_mesh(((VAR_AXIS, 8),))
    plan = ShardingPlan(shard_samples=False, shard_vars=True)
    ops = audit_fit(x, w, cfg, mesh, plan)
    assert all(o.kind == "all-reduce" for o in ops)
    # the fused multi-payload reduce carries one n x m block plus O(m)
    # blocks; nothing reaches O(p^2) or O(n x p)
    assert all(o.bytes <= max(n * m, m * p) * 4 + 512 for o in ops), \
        [(o.shapes, o.bytes) for o in ops]


def test_sharded_fit_resolves_optimizer_auto(setup):
    """fit_sharded resolves optimizer='auto' against the data shapes: on
    fully-sampled data (n >= p) the sharded program runs the fixed-point
    update and reproduces the explicit-fixed_point sharded fit exactly."""
    import dataclasses

    xp, w0, cfg, _ = setup                 # n=500 >= p=32
    mesh = make_mesh(((DATA_AXIS, 8),))
    cfg_auto = dataclasses.replace(cfg, optimizer="auto")
    cfg_fp = dataclasses.replace(cfg, optimizer="fixed_point")
    ws_a, mom_a, _ = fit_sharded(xp, w0, cfg_auto, mesh, ShardingPlan())
    ws_f, mom_f, _ = fit_sharded(xp, w0, cfg_fp, mesh, ShardingPlan())
    assert float(mom_a.tc) == float(mom_f.tc)
    assert np.array_equal(np.asarray(ws_a), np.asarray(ws_f))


# ---------------------------------------------------------------------------
# Multi-host (2-level host x device mesh): NVLink within a host, the
# network between hosts. The outer axis is named 'slice'.
# ---------------------------------------------------------------------------

def _slice_mesh(inner_axis=DATA_AXIS, inner=4):
    from linearcorex_tpu.parallel.sharding import SLICE_AXIS
    return make_mesh(((SLICE_AXIS, 8 // inner), (inner_axis, inner)))


def test_multislice_two_level_dp_equivalence(setup):
    """Sample sharding over BOTH levels of a slice(2) x data(4) mesh
    reproduces the single-device fit exactly (f64)."""
    xp, w0, cfg, ref = setup
    mesh = _slice_mesh()
    plan = ShardingPlan(shard_samples=True, shard_slices=True)
    ws, mom, _ = fit_sharded(xp, w0, cfg, mesh, plan)
    assert abs(float(mom.tc) - ref.tc) < 1e-8
    assert np.abs(np.asarray(ws) - np.asarray(ref.ws)).max() < 1e-8


def test_multislice_comm_surface_is_merged_pxm_allreduce():
    """2-level DP: the compiled program's only collectives are p x m
    cross-moment all-reduces whose replica groups span the full
    slice x device product (XLA merges the two-axis psum into one
    all-reduce). Nothing O(n) or O(p²) crosses either axis."""
    from linearcorex_tpu.parallel.audit import audit_fit
    p, m, n = 64, 8, 512
    x = jax.ShapeDtypeStruct((n, p), jnp.float32)
    w = jax.ShapeDtypeStruct((m, p), jnp.float32)
    cfg = CorexConfig(n_hidden=m, record_history=False, max_iter=50)
    mesh = _slice_mesh()
    ops = audit_fit(x, w, cfg, mesh,
                    ShardingPlan(shard_samples=True, shard_slices=True))
    assert ops
    assert all(o.kind == "all-reduce" for o in ops), [o.kind for o in ops]
    assert all(o.bytes <= p * m * 4 for o in ops)
    assert all(o.group_size == 8 for o in ops), \
        [(o.kind, o.group_size) for o in ops]


def test_multislice_dcn_vs_ici_axis_classification():
    """slice(2) x model(4) layout (samples over the inter-host slice axis,
    factors over the intra-host axis): the audit's replica-group parsing
    proves the big cross-moment reduces ride ONLY the slice axis — the
    per-host network payload is p x (m/tp) — while every all-gather (the
    m-block factor couplings) stays on the intra-host factor axis."""
    from linearcorex_tpu.parallel.audit import (audit_fit,
                                                groups_subset_of_axis)
    from linearcorex_tpu.parallel.sharding import SLICE_AXIS
    p, m, n = 64, 8, 512
    x = jax.ShapeDtypeStruct((n, p), jnp.float32)
    w = jax.ShapeDtypeStruct((m, p), jnp.float32)
    cfg = CorexConfig(n_hidden=m, record_history=False, max_iter=50)
    mesh = _slice_mesh(inner_axis=FACTOR_AXIS)
    ops = audit_fit(x, w, cfg, mesh,
                    ShardingPlan(shard_samples=False, shard_slices=True,
                                 shard_factors=True))
    tp = 4
    big = p * (m // tp) * 4   # the per-slice cross-moment shard
    cross_slice = [o for o in ops
                   if groups_subset_of_axis(o, mesh, SLICE_AXIS)]
    assert cross_slice, "expected cross-moment reduces on the slice axis"
    # slice-axis (inter-host) traffic: only the p x (m/tp) cross-moment reduces
    assert all(o.kind == "all-reduce" and o.bytes <= big
               for o in cross_slice), \
        [(o.kind, o.shapes, o.bytes) for o in cross_slice]
    # factor-axis couplings (all-gathers) never cross slices
    gathers = [o for o in ops if o.kind == "all-gather"]
    assert gathers
    assert all(groups_subset_of_axis(o, mesh, FACTOR_AXIS)
               for o in gathers)
    # and everything with groups rides exactly one axis (nothing spans
    # slice x factor at once)
    for o in ops:
        if o.groups:
            assert groups_subset_of_axis(o, mesh, SLICE_AXIS) \
                != groups_subset_of_axis(o, mesh, FACTOR_AXIS), o


def test_audit_int8_program_is_f32_superset():
    """Auditing the int8 operand directly: same p x m
    cross-moment reduces (int32 partials) over the same axis, PLUS the
    per-column operand-max reductions the mid-chain requantization
    needs — the f32 audit is a lower bound on the int8 surface."""
    from linearcorex_tpu.ops.moments import QuantizedData
    from linearcorex_tpu.parallel.audit import audit_fit
    p, m, n = 64, 8, 512
    w = jax.ShapeDtypeStruct((m, p), jnp.float32)
    mesh = make_mesh(((DATA_AXIS, 8),))
    qd = QuantizedData(q=jax.ShapeDtypeStruct((n, p), jnp.int8),
                       scale=jax.ShapeDtypeStruct((), jnp.float32))
    cfgq = CorexConfig(n_hidden=m, record_history=False, max_iter=50,
                       matmul_dtype="int8", moment_strategy="samples",
                       tol=1e-4)
    ops = audit_fit(qd, w, cfgq, mesh, ShardingPlan())
    assert all(o.kind == "all-reduce" for o in ops)
    assert all(o.bytes <= p * m * 4 for o in ops)
    # the int8-only extra: tiny per-column max reduces (f32[m])
    assert any(o.shapes == (f"f32[{m}]",) for o in ops), \
        [o.shapes for o in ops]
    # big cross-moment reduces present as int32 partials
    assert any(f"s32[{p},{m}]" in o.shapes for o in ops)


def test_audit_int8_requires_int8_config():
    from linearcorex_tpu.ops.moments import QuantizedData
    from linearcorex_tpu.parallel.audit import audit_fit
    qd = QuantizedData(q=jax.ShapeDtypeStruct((64, 16), jnp.int8),
                       scale=jax.ShapeDtypeStruct((), jnp.float32))
    w = jax.ShapeDtypeStruct((4, 16), jnp.float32)
    cfg = CorexConfig(n_hidden=4, record_history=False)
    with pytest.raises(ValueError, match="int8"):
        audit_fit(qd, w, cfg, make_mesh(((DATA_AXIS, 8),)),
                  ShardingPlan())


def test_gram_operand_rejects_slice_axis():
    from linearcorex_tpu.parallel.sharding import operand_specs
    with pytest.raises(ValueError, match="[Gg]ram"):
        operand_specs(ShardingPlan(shard_slices=True), "gram")


def test_audit_axis_classification_on_permuted_mesh():
    """Regression (round-3 self-review): HLO replica groups index the
    LOGICAL device order, not physical ids. On a mesh built from a
    permuted device array — which a host-grouped hybrid mesh can be —
    classification by d.id silently reported False for the very axis a
    collective rides. Positional indexing must classify identically on
    the permuted mesh."""
    from jax.sharding import Mesh
    from linearcorex_tpu.parallel.audit import (audit_fit,
                                                groups_subset_of_axis)
    from linearcorex_tpu.parallel.sharding import SLICE_AXIS

    p, m, n = 64, 8, 512
    x = jax.ShapeDtypeStruct((n, p), jnp.float32)
    w = jax.ShapeDtypeStruct((m, p), jnp.float32)
    cfg = CorexConfig(n_hidden=m, record_history=False, max_iter=50)
    perm = np.array(jax.devices())[[3, 1, 4, 6, 0, 2, 5, 7]].reshape(2, 4)
    mesh = Mesh(perm, (SLICE_AXIS, FACTOR_AXIS))
    ops = audit_fit(x, w, cfg, mesh,
                    ShardingPlan(shard_samples=False, shard_slices=True,
                                 shard_factors=True))
    cross_slice = [o for o in ops
                   if groups_subset_of_axis(o, mesh, SLICE_AXIS)]
    assert cross_slice, "cross-moment reduces must classify onto 'slice'"
    assert all(o.kind == "all-reduce" for o in cross_slice)
    gathers = [o for o in ops if o.kind == "all-gather"]
    assert gathers and all(
        groups_subset_of_axis(o, mesh, FACTOR_AXIS) for o in gathers)


def test_restarts_x_data_2d_layout_matches_unsharded():
    """The combined restarts x data layout
    (BASELINE config 5 literal: sample-sharded psum moments + vmapped
    restart sweep in ONE program): restart lanes split over 'restarts',
    each lane's X row-blocks over 'data'. Must reproduce the
    single-device vmapped sweep step-for-step (f64, 1e-7)."""
    from linearcorex_tpu.parallel.restarts import (fit_restarts,
                                                   fit_restarts_sharded,
                                                   init_restarts)
    x = block_data(n=256, p=64, m=4, seed=1)
    xp, _ = P.fit_preprocess(jnp.asarray(x, jnp.float64), "standard")
    cfg = CorexConfig(n_hidden=4, dtype="float64", record_history=False,
                      max_iter=1500, moment_strategy="samples")
    w0 = init_restarts(4, 4, 64, seed=3, dtype=jnp.float64)
    ws_u, mom_u, diag_u = fit_restarts(xp, w0, cfg, "samples")
    mesh = make_mesh((("restarts", 2), ("data", 4)))
    ws_s, mom_s, diag_s = fit_restarts_sharded(xp, w0, cfg, "samples",
                                               mesh, data_axis="data")
    assert np.array_equal(np.asarray(diag_u.iters_per_stage),
                          np.asarray(diag_s.iters_per_stage))
    assert np.abs(np.asarray(ws_s) - np.asarray(ws_u)).max() < 1e-7
    assert np.abs(np.asarray(mom_s.tc) - np.asarray(mom_u.tc)).max() < 1e-7


def test_restarts_x_data_comm_surface():
    """The combined layout's collectives: every payload-carrying
    all-reduce is the p x m cross-moment family riding the 'data' axis
    ONLY; nothing but the while_loop's 1-byte convergence predicate may
    ride 'restarts' (restart lanes are independent)."""
    from linearcorex_tpu.parallel.audit import (audit_restarts,
                                                groups_subset_of_axis)
    mesh = make_mesh((("restarts", 2), ("data", 4)))
    cfg = CorexConfig(n_hidden=8, record_history=False,
                      moment_strategy="samples")
    data = jax.ShapeDtypeStruct((1024, 256), jnp.float32)
    w0 = jax.ShapeDtypeStruct((4, 8, 256), jnp.float32)
    ops = audit_restarts(data, w0, cfg, mesh, data_axis="data")
    assert ops, "expected collectives on the 2-D layout"
    for o in ops:
        assert o.kind == "all-reduce", o
        if o.bytes > 16:  # payload-carrying (not the loop predicate)
            assert groups_subset_of_axis(o, mesh, "data"), o
            assert not groups_subset_of_axis(o, mesh, "restarts"), o
            # p x (lanes_per_shard x m) partials: 256*2*8 f32
            assert o.bytes == 256 * 2 * 8 * 4, o
        else:
            assert groups_subset_of_axis(o, mesh, "restarts"), o


def test_restarts_x_data_validation():
    from linearcorex_tpu.parallel.restarts import (fit_restarts_sharded,
                                                   init_restarts)
    mesh = make_mesh((("restarts", 2), ("data", 4)))
    w0 = init_restarts(4, 2, 16, seed=0, dtype=jnp.float32)
    gram = jnp.eye(16, dtype=jnp.float32)
    cfg = CorexConfig(n_hidden=2, record_history=False)
    with pytest.raises(ValueError, match="[Gg]ram"):
        fit_restarts_sharded(gram, w0, cfg, "gram", mesh,
                             data_axis="data", n_samples=100)
    x = jnp.zeros((30, 16), jnp.float32)  # 30 rows % 4 devices != 0
    with pytest.raises(ValueError, match="divide"):
        fit_restarts_sharded(x, w0, cfg, "samples", mesh,
                             data_axis="data")


def test_mesh_aware_prepare_shards_from_first_program():
    """With fit(mesh=...), the raw X is sharded
    per the plan BEFORE the prepare program and the prepared operand
    comes out in the plan's layout — no full-size buffer (raw X,
    standardized X, Gram) ever materializes on one device. Checked by
    inspecting the prepared operand's sharding directly."""
    from jax.sharding import NamedSharding
    from linearcorex_tpu.parallel.sharding import operand_specs

    x = np.asarray(block_data(n=512, p=64, m=8, seed=0))
    for plan, strategy_hint in (
            # sample-only plan forces the samples strategy (plan rule)
            (ShardingPlan(), "samples"),
            # with shard_vars the auto rule keeps gram at n>p: the
            # prepare contracts the sharded sample axis into var-sharded
            # Σ row-blocks
            (ShardingPlan(shard_samples=True, shard_vars=True), "gram"),
            (ShardingPlan(shard_samples=False, shard_vars=True), None)):
        mesh = (make_mesh(((DATA_AXIS, 4), (VAR_AXIS, 2)))
                if plan.shard_vars else make_mesh(((DATA_AXIS, 8),)))
        model = lc.Corex(n_hidden=8, dtype="float64",
                         record_history=False)
        data, cfg, strategy = model._prepare_fit(x, plan=plan, mesh=mesh)
        if strategy_hint is not None:
            assert strategy == strategy_hint
        want = NamedSharding(mesh, operand_specs(plan, strategy)[0])
        assert data.sharding.is_equivalent_to(want, data.ndim), (
            plan, strategy, data.sharding)
        if plan.shard_samples or plan.shard_vars:
            assert not data.sharding.is_fully_replicated


def test_mesh_fit_with_gaussianize_matches_single_device():
    """fit(mesh=...) now runs preprocessing UNDER the mesh (the host
    fast path is skipped); the sharded device path must compute the
    same gaussianize='empirical' ranks + standardization as the
    single-device fit."""
    x = np.asarray(block_data(n=512, p=64, m=8, seed=3))
    w0 = np.random.RandomState(7).normal(scale=1 / 8, size=(8, 64))
    mesh = make_mesh(((DATA_AXIS, 8),))
    kw = dict(n_hidden=8, dtype="float64", record_history=False,
              gaussianize="empirical", moment_strategy="samples")
    cm = lc.Corex(**kw).fit(x, init_ws=w0, mesh=mesh)
    cs = lc.Corex(**kw).fit(x, init_ws=w0)
    assert abs(cm.tc - cs.tc) < 1e-7
    assert np.abs(np.asarray(cm.ws) - np.asarray(cs.ws)).max() < 1e-7
    # theta learned under the mesh serves single-device transforms
    yt = cm.transform(x[:32])
    assert np.abs(np.asarray(yt)
                  - np.asarray(cs.transform(x[:32]))).max() < 1e-7


def test_mesh_aware_prepare_int8_still_guarded():
    """The eager int8 wrap guard must still fire on the mesh-prepared
    (sharded) operand: rank-1 sign-aligned data survives standardization
    as ±1 columns, so the n=2^18-long int8 contraction provably wraps
    int32 (127² x 2^18 > 2³¹)."""
    rs = np.random.RandomState(0)
    u = rs.choice([-1.0, 1.0], size=(1 << 18, 1))
    x = np.tile(u, (1, 16)).astype(np.float32)
    mesh = make_mesh(((DATA_AXIS, 8),))
    model = lc.Corex(n_hidden=2, matmul_dtype="int8",
                     record_history=False, moment_strategy="samples")
    with pytest.raises(ValueError, match="overflow"):
        model._prepare_fit(x, plan=ShardingPlan(), mesh=mesh)


def test_mesh_aware_prepare_gram_non_dividing_n_fails_by_name():
    """The mesh-aware prepare shards the RAW (n, p) X per plan.x_spec()
    for EVERY strategy — so the sample-axis divisibility check must fire
    even when the resolved strategy is 'gram' (whose OPERAND carries no
    sample axis). Without raw_x=True in the validator this surfaced as
    the opaque device_put sharding exception the round-3 fuzzer
    contract forbids."""
    x = np.asarray(block_data(n=502, p=64, m=8, seed=0))   # 502 % 4 != 0
    mesh = make_mesh(((DATA_AXIS, 4), (VAR_AXIS, 2)))
    model = lc.Corex(n_hidden=8, record_history=False)
    # auto strategy picks 'gram' here (n > p/2 regime), plan shards both
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    with pytest.raises(ValueError, match="n_samples"):
        model._prepare_fit(x, plan=plan, mesh=mesh)


def test_make_hybrid_mesh_granule_key_and_audit_classification():
    """make_hybrid_mesh: the outer (inter-host) axis follows the host
    grouping, not enumeration order. One CPU process is one host, so the
    granule_key hook assigns an INTERLEAVED fake host id (d.id % 2) — the
    resulting device array is genuinely permuted vs make_mesh, and the
    audit's positional classification must still put the cross-moment
    reduces on the slice axis."""
    from linearcorex_tpu.parallel.audit import (audit_fit,
                                                groups_subset_of_axis)
    from linearcorex_tpu.parallel.sharding import (SLICE_AXIS,
                                                   make_hybrid_mesh)

    mesh = make_hybrid_mesh(((SLICE_AXIS, 2), (DATA_AXIS, 4)),
                            granule_key=lambda d: d.id % 2)
    assert mesh.axis_names == (SLICE_AXIS, DATA_AXIS)
    assert mesh.devices.shape == (2, 4)
    # slice rows are exactly the granule groups, ordered by sorted key
    for s in range(2):
        assert {d.id % 2 for d in mesh.devices[s]} == {s}
    # interleaved ids != enumeration order: the construction permutes
    assert [d.id for d in mesh.devices.ravel()] != list(range(8))

    p, m, n = 64, 8, 512
    ops = audit_fit(jax.ShapeDtypeStruct((n, p), jnp.float32),
                    jax.ShapeDtypeStruct((m, p), jnp.float32),
                    CorexConfig(n_hidden=m, record_history=False,
                                max_iter=50),
                    mesh, ShardingPlan(shard_samples=True,
                                       shard_slices=True))
    big = [o for o in ops if o.bytes == p * m * 4]
    assert big, [o.shapes for o in ops]
    # the p x m reduce spans slice x chip: NOT a subset of either axis
    # alone (the 2-level all-reduce; XLA lowers it hierarchically)
    for o in big:
        assert not groups_subset_of_axis(o, mesh, SLICE_AXIS), o
        assert not groups_subset_of_axis(o, mesh, DATA_AXIS), o


def test_make_hybrid_mesh_process_granule_degenerate_matches_make_mesh():
    """The default grouping (device.process_index): a single CPU process
    is one host, so n_slices=1 is the only constructible case — it must
    agree with make_mesh's device set, and asking for two hosts fails by
    name."""
    from linearcorex_tpu.parallel.sharding import (SLICE_AXIS,
                                                   make_hybrid_mesh)
    mesh = make_hybrid_mesh(((SLICE_AXIS, 1), (DATA_AXIS, 8)))
    assert mesh.devices.shape == (1, 8)
    assert ({d.id for d in mesh.devices.ravel()}
            == {d.id for d in jax.devices()})
    with pytest.raises(ValueError, match="1 hosts"):
        make_hybrid_mesh(((SLICE_AXIS, 2), (DATA_AXIS, 4)))


def test_make_hybrid_mesh_validation():
    from linearcorex_tpu.parallel.sharding import (SLICE_AXIS,
                                                   make_hybrid_mesh)
    with pytest.raises(ValueError, match="first axis"):
        make_hybrid_mesh(((DATA_AXIS, 8),))
    with pytest.raises(ValueError, match="devices"):
        make_hybrid_mesh(((SLICE_AXIS, 2), (DATA_AXIS, 8)))
    with pytest.raises(ValueError, match="hosts"):
        make_hybrid_mesh(((SLICE_AXIS, 4), (DATA_AXIS, 2)),
                         granule_key=lambda d: d.id % 2)
    with pytest.raises(ValueError, match="holds 2 devices"):
        # uneven host groups cannot fill the intra-host axes
        make_hybrid_mesh(((SLICE_AXIS, 2), (DATA_AXIS, 4)),
                         granule_key=lambda d: d.id < 6)


# ------------------------------------------------------------------------
# Sharded serving: the inference surface under a mesh (round 4 — the
# serving companion to the mesh-aware prepare: fit(mesh=..., shard_vars)
# made p-beyond-one-chip FITTABLE; transform/predict/score/covariance_*
# (mesh=...) make the same regime SERVABLE).
# ------------------------------------------------------------------------

def _fresh_pair(**kw):
    """Two identically-initialized fitted models on the module's block
    data: mesh serving mutates state placement in place, so each test
    drives its own instance and compares against an untouched twin."""
    x = np.asarray(block_data(n=512, p=64, m=8, seed=0))
    w0 = np.random.RandomState(42).normal(scale=1 / 8, size=(8, 64))
    kw = dict(dict(n_hidden=8, dtype="float64", record_history=False,
                   moment_strategy="samples", seed=0), **kw)
    return (x, lc.Corex(**kw).fit(x, init_ws=w0),
            lc.Corex(**kw).fit(x, init_ws=w0))


SERVING_PLANS = (
    (ShardingPlan(), ((DATA_AXIS, 8),)),
    (ShardingPlan(shard_samples=False, shard_vars=True), ((VAR_AXIS, 8),)),
    (ShardingPlan(shard_samples=True, shard_vars=True),
     ((DATA_AXIS, 4), (VAR_AXIS, 2))),
    (ShardingPlan(shard_samples=True, shard_factors=True),
     ((DATA_AXIS, 2), (FACTOR_AXIS, 4))),
)


@pytest.mark.parametrize("plan,axes", SERVING_PLANS)
def test_serving_mesh_equivalence_nonoverlap(plan, axes):
    x, cm, cs = _fresh_pair()
    mesh = make_mesh(axes)
    y_ref = np.asarray(cs.transform(x))
    y = cm.transform(x, mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(y) - y_ref).max() < 1e-9
    xh = cm.predict(y_ref, mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(xh) - np.asarray(cs.predict(y_ref))).max() \
        < 1e-9
    s = cm.score(x, mesh=mesh, sharding_plan=plan)
    assert abs(float(s) - float(cs.score(x))) < 1e-9
    v = np.random.RandomState(3).normal(size=64)
    mv = cm.covariance_matvec(v, mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(mv)
                  - np.asarray(cs.covariance_matvec(v))).max() < 1e-9
    vb = np.random.RandomState(4).normal(size=(64, 5))
    mm = cm.covariance_matmat(vb, mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(mm)
                  - np.asarray(cs.covariance_matmat(vb))).max() < 1e-9


def test_serving_mesh_equivalence_overlap():
    """The overlap (discourage_overlap=False) inference programs — m x m
    solves on replicated cy, var-shardable c_xy — under the 2-D mesh."""
    x, cm, cs = _fresh_pair(discourage_overlap=False, max_iter=300)
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    mesh = make_mesh(((DATA_AXIS, 4), (VAR_AXIS, 2)))
    y_ref = np.asarray(cs.transform(x))
    y = cm.transform(x, mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(y) - y_ref).max() < 1e-9
    xh = cm.predict(y_ref, mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(xh) - np.asarray(cs.predict(y_ref))).max() \
        < 1e-9
    assert abs(float(cm.score(x, mesh=mesh, sharding_plan=plan))
               - float(cs.score(x))) < 1e-9
    v = np.random.RandomState(5).normal(size=64)
    assert np.abs(np.asarray(cm.covariance_matvec(v, mesh=mesh,
                                                  sharding_plan=plan))
                  - np.asarray(cs.covariance_matvec(v))).max() < 1e-9


def test_serving_mesh_shards_input_and_state():
    """Under shard_vars the serving path must actually DISTRIBUTE the
    p-sized buffers: the fitted state and the device_put input carry
    var-sharded (not fully replicated) layouts — the property that makes
    p-beyond-one-chip serving real, mirroring the mesh-prepare test."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    x, cm, _ = _fresh_pair()
    plan = ShardingPlan(shard_samples=False, shard_vars=True)
    mesh = make_mesh(((VAR_AXIS, 8),))
    cm.transform(x, mesh=mesh, sharding_plan=plan)
    assert cm.ws.sharding.is_equivalent_to(
        NamedSharding(mesh, PS(None, VAR_AXIS)), 2), cm.ws.sharding
    assert not cm.ws.sharding.is_fully_replicated
    assert cm.moments.rhoinvrho.sharding.is_equivalent_to(
        NamedSharding(mesh, PS(None, VAR_AXIS)), 2)
    assert cm.theta.std.sharding.is_equivalent_to(
        NamedSharding(mesh, PS(VAR_AXIS)), 1)
    # the (n, p) reconstruction comes back var-sharded, never gathered
    xh = cm.predict(np.asarray(cm.transform(x)), mesh=mesh,
                    sharding_plan=plan)
    assert not xh.sharding.is_fully_replicated
    assert xh.addressable_shards[0].data.shape[1] == 64 // 8


def test_serving_mesh_details_and_empirical():
    """details=True and the batch-relative 'empirical' rank transform run
    under the mesh (the distributed sort/searchsorted path) and match the
    single-device call."""
    x, cm, cs = _fresh_pair(gaussianize="empirical")
    mesh = make_mesh(((DATA_AXIS, 8),))
    y, det = cm.transform(x, details=True, mesh=mesh)
    y_ref, det_ref = cs.transform(x, details=True)
    assert np.abs(np.asarray(y) - np.asarray(y_ref)).max() < 1e-9
    assert abs(float(det["TC"]) - float(det_ref["TC"])) < 1e-9
    assert np.abs(np.asarray(det["rho"])
                  - np.asarray(det_ref["rho"])).max() < 1e-9


def test_serving_mesh_divisibility_error():
    x, cm, _ = _fresh_pair()
    mesh = make_mesh(((DATA_AXIS, 8),))
    with pytest.raises(ValueError, match="divisible"):
        cm.transform(x[:510], mesh=mesh)
    with pytest.raises(ValueError, match="mesh has axes"):
        # plan shards over VAR_AXIS but the mesh carries only DATA_AXIS
        cm.covariance_matvec(np.zeros(64), mesh=mesh,
                             sharding_plan=ShardingPlan(shard_vars=True))


def test_serving_comm_surface():
    """The serving programs' collective surface, audited from compiled
    HLO like every fit layout: DP transform is communication-FREE (the
    GEMM is row-local against replicated W), and var-sharded transform
    all-reduces exactly the (n, m) factor block over 'var' — never an
    O(n·p) payload."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    from linearcorex_tpu.models import corex as C
    from linearcorex_tpu.parallel.audit import hlo_collectives

    x, cm, _ = _fresh_pair(dtype="float32")
    n, p, m = 512, 64, 8
    for plan, axes, comm_free in (
            (ShardingPlan(), ((DATA_AXIS, 8),), True),
            (ShardingPlan(shard_samples=False, shard_vars=True),
             ((VAR_AXIS, 8),), False)):
        mesh = make_mesh(axes)
        var = VAR_AXIS if plan.shard_vars else None

        def s(shape, spec):
            return jax.ShapeDtypeStruct(
                shape, jnp.float32, sharding=NamedSharding(mesh, spec))

        theta = P.Theta(mean=s((p,), PS(var)), std=s((p,), PS(var)))
        with jax.set_mesh(mesh):
            hlo = C._transform_program.lower(
                s((n, p), plan.x_spec()), s((m, p), PS(None, var)),
                theta, cm.pre_config).compile().as_text()
        ops = hlo_collectives(hlo)
        if comm_free:
            assert ops == [], (plan, ops)
        else:
            assert ops and all(o.kind == "all-reduce" for o in ops), ops
            assert all(o.bytes <= 4 * n * m for o in ops), ops


def test_serving_after_load_corex():
    """The serving deployment story: fit → save_corex → load in a fresh
    estimator (host-side state) → first sharded call device_puts the
    state per the plan and matches the original model."""
    from linearcorex_tpu.utils.checkpoint import load_corex, save_corex

    x, cm, _ = _fresh_pair()
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.npz")
        save_corex(cm, path)
        served = load_corex(path)
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    mesh = make_mesh(((DATA_AXIS, 4), (VAR_AXIS, 2)))
    y = served.transform(x, mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(y) - np.asarray(cm.transform(x))).max() < 1e-9
    assert abs(float(served.score(x, mesh=mesh, sharding_plan=plan))
               - float(cm.score(x))) < 1e-9


def test_stacked_mesh_end_to_end():
    """StackedCorex under a mesh: fit routes the inter-layer transform
    through the sharded path (never staging the p-wide X on one device
    under shard_vars), and transform/predict/transform_all accept the
    mesh with the layer-plan demotion rule. Equals the single-device
    stack."""
    from linearcorex_tpu.models.stacked import StackedCorex

    x = np.asarray(block_data(n=512, p=64, m=8, seed=5))
    kw = dict(dtype="float64", record_history=False, seed=0, max_iter=500,
              moment_strategy="samples")
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    mesh = make_mesh(((DATA_AXIS, 4), (VAR_AXIS, 2)))
    sm = StackedCorex([8, 2], **kw).fit(x, mesh=mesh, sharding_plan=plan)
    ss = StackedCorex([8, 2], **kw).fit(x)
    assert abs(sm.tc - ss.tc) < 1e-7
    ym = sm.transform(x, mesh=mesh, sharding_plan=plan)
    ys = ss.transform(x)
    assert np.abs(np.asarray(ym) - np.asarray(ys)).max() < 1e-9
    xm = sm.predict(np.asarray(ys), mesh=mesh, sharding_plan=plan)
    assert np.abs(np.asarray(xm) - np.asarray(ss.predict(ys))).max() < 1e-9
    alls = sm.transform_all(x, mesh=mesh, sharding_plan=plan)
    assert len(alls) == 2 and alls[1].shape == (512, 2)


def test_fit_transform_threads_mesh():
    """fit_transform(mesh=..., sharding_plan=...) is the one-shot spelling
    of fit(mesh)+transform(mesh) — both estimators thread the pair, so a
    Pipeline-style one-call workflow never stages p-wide buffers on one
    device under shard_vars."""
    from linearcorex_tpu.models.stacked import StackedCorex

    x, cm, cs = _fresh_pair()
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    mesh = make_mesh(((DATA_AXIS, 4), (VAR_AXIS, 2)))
    y = cm.fit_transform(x, mesh=mesh, sharding_plan=plan)
    y_ref = cs.fit_transform(x)
    assert np.abs(np.asarray(y) - np.asarray(y_ref)).max() < 1e-7
    kw = dict(dtype="float64", record_history=False, seed=0, max_iter=300,
              moment_strategy="samples")
    ys = StackedCorex([8, 2], **kw).fit_transform(x, mesh=mesh,
                                                  sharding_plan=plan)
    ys_ref = StackedCorex([8, 2], **kw).fit_transform(x)
    assert np.abs(np.asarray(ys) - np.asarray(ys_ref)).max() < 1e-7


def test_serving_plan_sticky_and_matvec_validation():
    """sharding_plan=None on a serving call reuses the state's CURRENT
    plan (a var-sharded model must not be silently replicated — at the
    scale shard_vars exists for, that is an OOM), while an explicit plan
    relays out; a fresh single-device refit resets the default. Plus the
    covariance_matvec input contract (1-D, fitted width) raising by name
    instead of an opaque GSPMD device_put error."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as PS

    x, cm, _ = _fresh_pair()
    plan = ShardingPlan(shard_samples=False, shard_vars=True)
    mesh = make_mesh(((VAR_AXIS, 8),))
    cm.transform(x, mesh=mesh, sharding_plan=plan)
    # plan omitted → state stays var-sharded, not replicated
    cm.covariance_matvec(np.ones(64), mesh=mesh)
    assert cm.ws.sharding.is_equivalent_to(
        NamedSharding(mesh, PS(None, VAR_AXIS)), 2), cm.ws.sharding
    assert not cm.ws.sharding.is_fully_replicated
    # a fresh fit resets the serving default to single-device
    cm.fit(x)
    assert cm._serving_plan is None
    with pytest.raises(ValueError, match="1-D"):
        cm.covariance_matvec(np.ones(63))
    with pytest.raises(ValueError, match="1-D"):
        cm.covariance_matvec(np.ones((64, 2)), mesh=mesh,
                             sharding_plan=plan)


# ------------------------------------------------------------------------
# Covariance export under shard_vars (round 5):
# covariance_blocks(mesh=...) yields Σ̂ row blocks per the plan — the
# SURVEY §3.4 export requirement in exactly the p-beyond-one-chip regime
# fit(mesh=..., shard_vars) opened — and get_covariance() on var-sharded
# state raises by name instead of materializing the buffer the plan
# shards away.
# ------------------------------------------------------------------------

COV_EXPORT_PLANS = (
    (ShardingPlan(shard_samples=False, shard_vars=True), ((VAR_AXIS, 8),)),
    (ShardingPlan(shard_samples=True, shard_vars=True),
     ((DATA_AXIS, 4), (VAR_AXIS, 2))),
)


@pytest.mark.parametrize("plan,axes", COV_EXPORT_PLANS)
@pytest.mark.parametrize("overlap", (False, True))
def test_covariance_blocks_sharded_bitequal(plan, axes, overlap):
    """Sharded block export == single-device export, bit for bit, on both
    solver paths (same program, same reduction order — the contraction
    axis m is never sharded by these plans), including the partial tail
    block (p=64, block=24 → the last block is the tail slice of a
    full-size one)."""
    kw = dict(discourage_overlap=not overlap)
    if overlap:
        kw["max_iter"] = 300
    x, cm, cs = _fresh_pair(**kw)
    mesh = make_mesh(axes)
    ref = list(cs.covariance_blocks(24))
    got = list(cm.covariance_blocks(24, mesh=mesh, sharding_plan=plan))
    assert [s for s, _ in got] == [s for s, _ in ref]
    for (_, rg), (_, rr) in zip(got, ref):
        assert rg.shape == rr.shape
        assert np.array_equal(np.asarray(rg), np.asarray(rr))
    # the yielded blocks are GLOBAL arrays still sharded over VAR_AXIS —
    # the property that lets a p-beyond-one-chip export be consumed
    # on-device per shard instead of gathered
    assert not got[0][1].sharding.is_fully_replicated


def test_covariance_blocks_mesh_no_context_leak():
    """The generator must not hold jax.set_mesh open across yields —
    consumer code between blocks runs OUTSIDE the mesh scope."""
    from jax._src import mesh as mesh_lib

    x, cm, _ = _fresh_pair()
    mesh = make_mesh(((VAR_AXIS, 8),))
    plan = ShardingPlan(shard_samples=False, shard_vars=True)
    for _, _rows in cm.covariance_blocks(24, mesh=mesh,
                                         sharding_plan=plan):
        assert mesh_lib.get_concrete_mesh().empty, (
            "covariance_blocks leaked the jax.set_mesh scope into "
            "consumer code between blocks")


def test_get_covariance_raises_on_var_sharded_state():
    """Pinned behavior of the dense export on mesh-committed state:
    var-sharded → raises by name pointing at the sharded exports;
    dp-only-sharded → still exports, equal to the pre-mesh dense Σ̂
    (state stays replicated under that plan)."""
    x, cm, cs = _fresh_pair()
    ref = np.asarray(cs.get_covariance())
    mesh = make_mesh(((VAR_AXIS, 8),))
    cm.transform(x, mesh=mesh,
                 sharding_plan=ShardingPlan(shard_samples=False,
                                            shard_vars=True))
    with pytest.raises(ValueError, match="var-sharded"):
        cm.get_covariance()
    # covariance_blocks(mesh=) is the documented way out — and a fresh
    # single-device refit resets the plan, re-enabling the dense export
    blocks = dict(cm.covariance_blocks(64, mesh=mesh))
    assert np.allclose(np.asarray(blocks[0]), ref, atol=1e-9)
    cm.fit(x, init_ws=np.asarray(cs.ws))
    assert cm.get_covariance().shape == (64, 64)
    # dp-only serving keeps the dense export (state replicated)
    x2, cd, cd_ref = _fresh_pair()
    dp_mesh = make_mesh(((DATA_AXIS, 8),))
    cd.transform(x2, mesh=dp_mesh, sharding_plan=ShardingPlan())
    assert np.array_equal(np.asarray(cd.get_covariance()),
                          np.asarray(cd_ref.get_covariance()))


@pytest.mark.parametrize("overlap", (False, True))
def test_warmup_serving_covers_sharded_cov_blocks(monkeypatch, overlap):
    """warmup_serving(cov_block=..., mesh=...) lowers EXACTLY the module
    covariance_blocks(mesh=...) dispatches (the module-text identity
    rule), on BOTH solver paths: the NS path's eager z = f(state) lands
    on rhoinvrho's spec natively; the overlap path's solve_triangular
    output commits REPLICATED and relies on the dispatch's explicit
    re-commit — without it this test fails with two different modules
    (caught by round-5 review)."""
    import linearcorex_tpu.models.corex as C
    from linearcorex_tpu.utils.compile_cache import warmup_serving
    from tests.conftest import module_text_probe

    texts = []
    monkeypatch.setattr(C, "_cov_rows_program",
                        module_text_probe(C._cov_rows_program, texts))
    kw = dict(discourage_overlap=not overlap)
    if overlap:
        kw["max_iter"] = 300
    x, cm, _ = _fresh_pair(**kw)
    mesh = make_mesh(((VAR_AXIS, 8),))
    plan = ShardingPlan(shard_samples=False, shard_vars=True)
    warmup_serving(cm, batch_rows=512, mesh=mesh, sharding_plan=plan,
                   cov_block=24)
    next(iter(cm.covariance_blocks(24, mesh=mesh, sharding_plan=plan)))
    assert len(texts) == 2 and texts[0] == texts[1], (
        "warmup_serving(mesh=..., cov_block=...) lowered a different "
        "covariance-rows module than the real sharded export")

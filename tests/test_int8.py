"""matmul_dtype='int8' — quantized samples-path GEMMs (ops/moments.py ::
QuantizedData). At cfg5 the int8 fit reached the same TC as bf16 (204361 vs
204386; int8 x int8 → int32 GEMMs); the accept/reject solver absorbs the
quantization noise."""

import numpy as np
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.ops import moments as M
from tests.conftest import block_data


def _data(n=1500, p=48, m=6, seed=2):
    x = block_data(n=n, p=p, m=m, seed=seed)
    return (x - x.mean(0)) / x.std(0)


def _same_partition(a, b):
    """Cluster labels up to factor relabeling: quantization noise can swap
    the order of near-equal-TC factors, permuting every label while the
    variable partition is identical."""
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all((a[:, None] == a[None, :])
                       == (b[:, None] == b[None, :])))


def test_apply_sigma_int8_accuracy():
    """Two-GEMM int8 Σ-application tracks the f32 one to ~1% relative
    (per-tensor X scale + per-column operand scales; standardized data)."""
    import jax.numpy as jnp

    x = jnp.asarray(_data(), jnp.float32)
    qd = M.quantize_samples(x)
    v = jnp.asarray(np.random.RandomState(0).normal(
        size=(x.shape[1], 6)) * 0.1, jnp.float32)
    ref = np.asarray(x.T @ (x @ v) / x.shape[0], np.float64)
    got = np.asarray(M._apply_sigma_int8(qd, v), np.float64)
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 0.02, rel


def test_int8_fit_matches_f32_quality():
    """End-to-end int8 fit recovers the same clusters and TC (to ~2%) as
    the f32 fit — the measured-at-cfg5 result, CI-sized."""
    x = _data()
    w0 = np.random.RandomState(42).normal(scale=1.0 / np.sqrt(48),
                                          size=(6, 48))
    f32 = lc.Corex(n_hidden=6, moment_strategy="samples",
                   tol=1e-4).fit(x, init_ws=w0)
    i8 = lc.Corex(n_hidden=6, matmul_dtype="int8",
                  tol=1e-4).fit(x, init_ws=w0)
    assert i8.resolved_optimizer_ == f32.resolved_optimizer_
    assert abs(float(i8.tc) - float(f32.tc)) / float(f32.tc) < 0.02
    assert _same_partition(i8.clusters, f32.clusters)
    # inference surface works off the quantized fit
    y = i8.transform(x)
    assert np.isfinite(np.asarray(i8.get_covariance())).all()
    assert y.shape == (x.shape[0], 6)


def test_int8_fixed_point_path():
    """optimizer='auto' resolves fixed_point on fully-sampled data and the
    fp update runs through the int8 applications."""
    x = _data()
    m = lc.Corex(n_hidden=6, matmul_dtype="int8", optimizer="auto",
                 tol=1e-4).fit(x)
    assert m.resolved_optimizer_ == "fixed_point"
    assert np.isfinite(float(m.tc))


def test_int8_config_validation():
    # config validation fires at first use, not construction (sklearn
    # deferred-validation contract)
    with pytest.raises(ValueError, match="int8"):
        lc.Corex(n_hidden=4, matmul_dtype="int8", dtype="float64").config
    with pytest.raises(ValueError, match="int8"):
        lc.Corex(n_hidden=4, matmul_dtype="int8",
                 discourage_overlap=False).config
    with pytest.raises(ValueError, match="matmul_dtype"):
        lc.Corex(n_hidden=4, matmul_dtype="float16").config


def test_int8_gram_strategy_quality():
    """int8 also quantizes the GRAM operand (one int8 GEMM per
    application; measured 0.98 vs 1.71 ms/iter at the north-star shape
    with TC 11888 vs 11902) — same clusters as the f32 gram fit."""
    x = _data()
    w0 = np.random.RandomState(42).normal(scale=1.0 / np.sqrt(48),
                                          size=(6, 48))
    f32 = lc.Corex(n_hidden=6, moment_strategy="gram",
                   tol=1e-4).fit(x, init_ws=w0)
    i8 = lc.Corex(n_hidden=6, moment_strategy="gram",
                  matmul_dtype="int8", tol=1e-4).fit(x, init_ws=w0)
    assert abs(float(i8.tc) - float(f32.tc)) / float(f32.tc) < 0.02
    assert _same_partition(i8.clusters, f32.clusters)


def test_int8_mesh_matches_single_device():
    """int8 under the GSPMD sample-sharded path: the quantized math is
    shape-global, so the mesh fit reproduces the single-device int8 fit."""
    import jax
    from jax.sharding import Mesh

    x = _data(n=1504, p=48, m=6)
    w0 = np.random.RandomState(42).normal(scale=1.0 / np.sqrt(48),
                                          size=(6, 48))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("data",))
    single = lc.Corex(n_hidden=6, matmul_dtype="int8",
                      moment_strategy="samples",
                      tol=1e-4).fit(x, init_ws=w0)
    meshed = lc.Corex(n_hidden=6, matmul_dtype="int8",
                      moment_strategy="samples", tol=1e-4)
    meshed.fit(x, init_ws=w0, mesh=mesh)
    assert abs(float(meshed.tc) - float(single.tc)) \
        / abs(float(single.tc)) < 1e-3
    assert _same_partition(meshed.clusters, single.clusters)


def test_int8_streaming_supported():
    """Streaming/covariance fits quantize the accumulated Gram."""
    from linearcorex_tpu.utils.streaming import GramAccumulator

    x = _data(n=900, p=32, m=4)
    acc = GramAccumulator(32).update(x)
    i8 = acc.fit(4, matmul_dtype="int8", tol=1e-4, seed=0)
    f32 = acc.fit(4, tol=1e-4, seed=0)
    assert abs(float(i8.tc) - float(f32.tc)) / float(f32.tc) < 0.03
    assert _same_partition(i8.clusters, f32.clusters)


def test_int8_obj_grad_guard():
    """A plain f32 operand with an int8 config must raise, not silently
    run f32 (the int8 mode is carried by the operand type)."""
    import jax.numpy as jnp

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.models.corex import _make_obj_grad

    with pytest.raises(ValueError, match="quantized"):
        _make_obj_grad(jnp.zeros((16, 8)),
                       CorexConfig(n_hidden=4, matmul_dtype="int8"),
                       "samples")


def test_int8_pick_n_hidden():
    x = _data(n=800, p=32, m=4)
    best, scores = lc.pick_n_hidden(x, repeat=2, max_n_hidden=6,
                                    matmul_dtype="int8", seed=0,
                                    tol=1e-4)
    assert 3 <= best <= 6
    assert np.isfinite(scores).all()


def test_int8_shard_map_rejected():
    """fit_shard_map spells out f32/bf16 collectives; int8 must point the
    user at the GSPMD path instead of failing obscurely."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.parallel.sharding import fit_shard_map

    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2), ("data",))
    x = jnp.zeros((16, 8), jnp.float32)
    w = jnp.zeros((2, 8), jnp.float32)
    with pytest.raises(ValueError, match="fit_sharded"):
        fit_shard_map(x, w, CorexConfig(n_hidden=2, matmul_dtype="int8"),
                      mesh)


# ---------------------------------------------------------------------------
# int32 accumulator-wrap guard (quantize-time)
# ---------------------------------------------------------------------------

def test_int8_overflow_guard_raises_on_aligned_wrap():
    """Adversarially rank-1-aligned operand whose real int8 GEMM wraps
    int32 (127² x 140k contraction > 2³¹): before the guard this returned
    silently-wrong moments; now quantize_samples raises."""
    import jax.numpy as jnp
    x = jnp.asarray(np.ones((2, 140_000), np.float32))
    with pytest.raises(ValueError, match="overflow"):
        M.quantize_samples(x)


def test_int8_overflow_guard_warns_when_possible_but_unwrapped():
    """Random-sign data with the same long axis: the guaranteed-safe bound
    fails but sign cancellation keeps actual accumulation ~√p below the
    wrap point — the guard warns instead of raising, and the quantized
    operand still computes correct products."""
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    x = jnp.asarray(
        rng.choice([-1.0, 1.0], size=(2, 140_000)).astype(np.float32))
    with pytest.warns(UserWarning, match="COULD overflow"):
        qd = M.quantize_samples(x)
    v = jnp.asarray(rng.normal(size=(140_000, 2)).astype(np.float32))
    ref = np.asarray(x).T @ (np.asarray(x) @ np.asarray(v)) / 2
    got = np.asarray(M._apply_sigma_int8(qd, v))
    denom = np.abs(ref).max()
    assert np.abs(got - ref).max() / denom < 0.05


def test_int8_overflow_guard_silent_on_standard_data(recwarn):
    """The certificate passes on ordinary standardized data — no warning,
    no probe, no behavior change."""
    import jax.numpy as jnp
    qd = M.quantize_samples(jnp.asarray(_data(), np.float32))
    assert qd.q.dtype == np.int8
    assert not [w for w in recwarn.list
                if "overflow" in str(w.message)]


def test_int8_overflow_guard_overridable_and_jit_transparent():
    """check_overflow=False skips the guard; under jit tracing the guard
    is skipped automatically (it needs host control flow)."""
    import jax
    import jax.numpy as jnp
    x = jnp.asarray(np.ones((2, 140_000), np.float32))
    qd = M.quantize_samples(x, check_overflow=False)   # no raise
    assert qd.q.shape == (2, 140_000)

    @jax.jit
    def quantize_traced(x):
        return M.quantize_samples(x).q

    assert quantize_traced(x).dtype == np.int8         # no raise


def test_sharded_boundaries_guard_caller_quantized_operand():
    """fit_sharded / fit_restarts_sharded re-guard a caller-built
    QuantizedData: the public sharded entry points
    are exactly where pre-quantized operands arrive without having gone
    through quantize_samples' eager guard. check_overflow=False is the
    documented escape hatch (proved by reaching the NEXT validation
    error instead of the wrap error)."""
    import jax
    import jax.numpy as jnp

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.parallel.restarts import fit_restarts_sharded
    from linearcorex_tpu.parallel.sharding import fit_sharded, make_mesh

    # adversarially rank-1-aligned operand whose int8 GEMM wraps int32
    # (127^2 x 140k > 2^31) — same recipe as the quantize-time guard test
    wrapping = M.quantize_samples(
        jnp.asarray(np.ones((2, 140_000), np.float32)),
        check_overflow=False)
    mesh = make_mesh(devices=jax.devices()[:2])
    cfg = CorexConfig(n_hidden=2, matmul_dtype="int8")
    w0 = jnp.zeros((2, 140_000), jnp.float32)
    with pytest.raises(ValueError, match="overflow"):
        fit_sharded(wrapping, w0, cfg, mesh)
    with pytest.raises(ValueError, match="overflow"):
        fit_restarts_sharded(wrapping, w0[None], cfg, "samples",
                             make_mesh((("restarts", 2),),
                                       jax.devices()[:2]))
    # escape hatch: the guard is skipped, so the call proceeds to the
    # shape validation (2 rows over a 2-device axis is fine for
    # fit_sharded -> use an odd batch for the restarts divisibility error)
    with pytest.raises(ValueError, match="divide"):
        fit_restarts_sharded(wrapping, jnp.zeros((3, 2, 140_000)),
                             cfg, "samples",
                             make_mesh((("restarts", 2),),
                                       jax.devices()[:2]),
                             check_overflow=False)

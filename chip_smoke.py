"""Smoke run of the Corex main path on NVIDIA GPUs, at real widths.

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: sample-sharded cfg5 path only

One process holds the card(s); nothing here starts a second JAX process.
Each phase prints one JSON line with the card's name and power limit
(`nvidia-smi`) beside its numbers; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Phases (one GPU):
  device     platform, device_kind, count and nvidia-smi; raises without a
             GPU (there is no CPU fallback).
  northstar  n=10k, p=10k, m=512 block data made on the device:
             Corex(n_hidden=512, seed=0).fit (f32, annealed, auto → gram),
             then transform / predict / score / get_covariance /
             covariance_blocks, then Corex(preset="throughput").fit (int8).
  cfg5       n=10k, p=100k, m=512 (BASELINE config 5's per-fit shape) on
             the samples strategy, heavy-ball, f32 and int8.
  correct    one objective/gradient/TC evaluation of the GPU path against
             a plain reference from the same data and W: the float64 NumPy
             oracle at northstar, the float64 evaluation on the card at
             cfg5, and the int8 operand mode against f32 at both; plus a
             record (not a check) of the int8 throughput fit against the
             f32 fit of the same recipe and seed.
  gpu_checks the check functions the `gpu`-marked tests call, at their
             test sizes.

`--four` fits n=40k, p=100k, m=512 sample-sharded over four GPUs (GSPMD
`Corex.fit(mesh=...)` and explicit-psum `fit_shard_map`), each step-matched
against the one-GPU fit of the same data, then runs the combined
('restarts', 2) x ('data', 2) sweep with as many of 32 lanes as fit.

Any failed phase or comparison exits non-zero, and the final line is then
not printed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

RHO_CLIP = 1.0 - 1e-6

# Tolerances (relative; gradients against their max-abs):
#  'highest' f32: f32 accumulation over n=10k ≈ √n·2⁻²⁴ ≈ 1e-5 expected;
#  'default' lets XLA:GPU use TF32 (10-bit mantissa) for f32 dots.
#  int8 operands: X (or Σ) quantized per tensor and the application
#  operand per column, each to 1/127 of its max — ~1e-3 on the objective
#  and TC and a few % on the gradient's largest entries (measured on the
#  CPU at p=64..4000; two chained requantizations on the samples path).
TOL = {"highest": {"obj": 1e-4, "tc": 1e-4, "grad": 1e-3},
       "default": {"obj": 1e-2, "tc": 1e-2, "grad": 1e-2},
       "int8": {"obj": 1e-2, "tc": 1e-2, "grad": 5e-2}}
F32_PRECISIONS = ("highest", "default")
FOUR_TC_REL = 2e-3        # 4-GPU fits vs the one-GPU fit, step-matched


class SmokeFailure(AssertionError):
    """A comparison fell outside its tolerance."""


def card_line() -> str:
    """`nvidia-smi` name and power limit, read by a child that does not
    import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


def device_phase(expect_count: int | None = None) -> dict:
    """The device JAX reports; raises unless it is a GPU."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs an NVIDIA GPU; JAX found platform "
            f"{d.platform!r} ({d.device_kind})")
    if expect_count is not None and len(devs) < expect_count:
        raise RuntimeError(
            f"--four needs {expect_count} GPUs; JAX found {len(devs)}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs), "card": card_line()}


def make_block_data(n: int, p: int, n_blocks: int, seed: int = 0,
                    device=None):
    """(n, p) float32 block data made on the device: each of n_blocks
    equal blocks of columns shares one latent factor (loading 0.9)."""
    import jax
    import jax.numpy as jnp

    k = -(-p // n_blocks)

    @jax.jit
    def make(key):
        kz, ke = jax.random.split(key)
        z = jax.random.normal(kz, (n, n_blocks), jnp.float32)
        e = jax.random.normal(ke, (n, p), jnp.float32)
        return jnp.repeat(z, k, axis=1)[:, :p] * 0.9 + 0.436 * e

    key = jax.random.PRNGKey(seed)
    if device is not None:
        key = jax.device_put(key, device)
    return make(key)


def peak_bytes(device=None):
    import jax

    stats = (device or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def fit_memory(model, n: int, p: int) -> dict | None:
    """compiled.memory_analysis() of the single-device fit program
    `model.fit` runs for an (n, p) input."""
    import jax
    import jax.numpy as jnp

    from linearcorex_tpu.models import corex as C
    from linearcorex_tpu.ops.moments import QuantizedData

    cfg = C.resolve_config(model.config, p, n_samples=n)
    strategy = C.pick_fit_strategy(model.config, n, p)
    shape = (p, p) if strategy == "gram" else (n, p)
    sds = jax.ShapeDtypeStruct
    if cfg.matmul_dtype == "int8":
        data = QuantizedData(q=sds(shape, jnp.int8),
                             scale=sds((), jnp.float32))
    elif cfg.matmul_dtype == "bfloat16":
        data = sds(shape, jnp.bfloat16)
    else:
        data = sds(shape, jnp.dtype(cfg.dtype))
    w0 = sds((model.m, p), jnp.dtype(cfg.dtype))
    mem = C._fit_program.lower(data, w0, cfg,
                               strategy).compile().memory_analysis()
    if mem is None:
        return None
    return {k: int(getattr(mem, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, k)}


def timed_fit(make_model, x) -> tuple:
    """Fit a fresh model cold (compile included), then once more warm.
    Returns (model, record)."""
    import numpy as np

    from linearcorex_tpu.models.corex import pick_fit_strategy

    walls = []
    model = None
    for _ in range(2):
        model = make_model()
        t0 = time.perf_counter()
        model.fit(x)
        tc = float(model.tc)  # waits for the device
        walls.append(time.perf_counter() - t0)
    n, p = x.shape
    cfg = model.config
    rec = {
        "wall_cold_s": walls[0],
        "wall_warm_s": walls[1],
        "iterations": int(np.asarray(
            model.diagnostics.iters_per_stage).sum()),
        "tc": tc,
        "strategy": pick_fit_strategy(cfg, n, p),
        "optimizer": model.resolved_optimizer_,
        "matmul_dtype": cfg.matmul_dtype,
        "matmul_precision": cfg.matmul_precision,
        "anneal": cfg.anneal, "tol": cfg.tol, "init": cfg.init,
    }
    if not np.isfinite(tc):
        raise SmokeFailure(f"non-finite TC {tc}")
    return model, rec


def northstar_phase(n=10_000, p=10_000, m=512, n_blocks=100,
                    cov_block=1000) -> tuple:
    """f32 annealed fit + the serving surface + the int8 throughput fit.
    Returns (record, x, int8_model)."""
    import jax.numpy as jnp
    import numpy as np

    import linearcorex_tpu as lc

    x = make_block_data(n, p, n_blocks, seed=0)
    f32, rec_f32 = timed_fit(lambda: lc.Corex(n_hidden=m, seed=0), x)
    rec_f32["memory_analysis"] = fit_memory(f32, n, p)
    rec_f32["peak_bytes_in_use"] = peak_bytes()

    # the serving surface on the fitted model
    t0 = time.perf_counter()
    y = f32.transform(x)
    xh = f32.predict(y)
    score = float(f32.score(x))
    cov = f32.get_covariance()
    worst = 0.0
    for start, rows in f32.covariance_blocks(cov_block):
        worst = max(worst, float(jnp.max(jnp.abs(
            rows - cov[start:start + rows.shape[0]]))))
    serve_wall = time.perf_counter() - t0
    if y.shape != (n, m) or xh.shape != (n, p) or cov.shape != (p, p):
        raise SmokeFailure(f"serving shapes {y.shape} {xh.shape} "
                           f"{cov.shape}")
    finite = all(bool(jnp.all(jnp.isfinite(a))) for a in (y, xh, cov))
    if not (finite and np.isfinite(score)):
        raise SmokeFailure("non-finite serving output")
    # blocks are rows of the same factorization as the dense matrix
    scale = float(jnp.max(jnp.abs(cov)))
    if worst > 1e-5 * scale:
        raise SmokeFailure(f"covariance_blocks differ from get_covariance "
                           f"by {worst:.3g} (scale {scale:.3g})")
    serving = {"wall_s": serve_wall, "score": score,
               "cov_blocks_max_abs_diff": worst}

    int8, rec_int8 = timed_fit(
        lambda: lc.Corex(n_hidden=m, seed=0, preset="throughput"), x)
    rec_int8["memory_analysis"] = fit_memory(int8, n, p)
    rec_int8["peak_bytes_in_use"] = peak_bytes()
    return ({"shape": [n, p, m], "f32": rec_f32, "serving": serving,
             "int8_throughput": rec_int8}, x, int8)


def cfg5_phase(n=10_000, p=100_000, m=512, n_blocks=500) -> dict:
    """Samples-strategy heavy-ball fits, f32 and int8."""
    import linearcorex_tpu as lc

    x = make_block_data(n, p, n_blocks, seed=5)
    common = dict(n_hidden=m, seed=0, moment_strategy="samples",
                  optimizer="momentum")
    f32, rec_f32 = timed_fit(lambda: lc.Corex(**common), x)
    rec_f32["memory_analysis"] = fit_memory(f32, n, p)
    rec_f32["peak_bytes_in_use"] = peak_bytes()
    del f32
    int8, rec_int8 = timed_fit(
        lambda: lc.Corex(matmul_dtype="int8", tol=1e-4, **common), x)
    rec_int8["memory_analysis"] = fit_memory(int8, n, p)
    rec_int8["peak_bytes_in_use"] = peak_bytes()
    return {"shape": [n, p, m], "f32": rec_f32, "int8": rec_int8}


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _grad_err(g, g_ref):
    import numpy as np

    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    return float(np.max(np.abs(g - g_ref)) / max(np.max(np.abs(g_ref)),
                                                 1e-30))


def _standardize(x):
    from linearcorex_tpu.ops import preprocessing as P

    xp, _ = P.fit_preprocess(x, "standard")
    return xp


def _evaluate(ws, data, strategy: str, precision: str):
    """One objective/gradient/TC evaluation of the fit's own path, in the
    dtype of `ws` and `data`."""
    import jax

    from linearcorex_tpu.ops import moments as M

    fn = M.ns_obj_grad_gram if strategy == "gram" else M.ns_obj_grad_samples
    with jax.default_matmul_precision(precision):
        out = jax.jit(lambda w, d: fn(w, d, 0.0, 1.0, RHO_CLIP))(ws, data)
        return jax.block_until_ready(out)


def _compare(got, ref, what: str) -> dict:
    """Errors of each evaluation (keyed by its TOL entry) against the
    reference; raises SmokeFailure outside TOL."""
    errs = {}
    for prec, (f, g, tc) in got.items():
        e = {"obj": _rel(f, ref[0]), "tc": _rel(tc, ref[2]),
             "grad": _grad_err(g, ref[1])}
        errs[prec] = e
        bad = {k: v for k, v in e.items() if not v <= TOL[prec][k]}
        if bad:
            raise SmokeFailure(f"{what} at matmul_precision={prec!r}: "
                               f"{bad} above {TOL[prec]}")
    return errs


def seeded_w0(m: int, p: int, seed: int = 0):
    """The seeded N(0, 1/sqrt(p)) init `Corex(seed=...)` draws."""
    import numpy as np

    return np.random.RandomState(seed).normal(scale=1.0 / np.sqrt(p),
                                              size=(m, p))


def check_oracle_parity(x=None, n=2000, p=1000, m=64, n_blocks=20,
                        strategy="gram") -> dict:
    """The f32 GPU evaluation (gram or samples path, at 'highest' and
    'default' precision) against the float64 NumPy oracle, from the same
    standardized data and the same seeded W."""
    import jax.numpy as jnp
    import numpy as np

    from linearcorex_tpu.oracle import oracle as O
    from linearcorex_tpu.ops import moments as M

    if x is None:
        x = make_block_data(n, p, n_blocks, seed=1)
    n, p = x.shape
    xp = _standardize(x)
    w = seeded_w0(m, p)
    data = M.compute_gram(xp) if strategy == "gram" else xp
    wj = jnp.asarray(w, jnp.float32)
    got = {prec: _evaluate(wj, data, strategy, prec)
           for prec in F32_PRECISIONS}
    xh = np.asarray(xp, np.float64)
    mom = O.calculate_moments(xh, w, eps=0.0)
    ref = (mom["objective"], O.ns_gradient(mom, xh, w, 0.0), mom["TC"])
    return {"reference": "float64 NumPy oracle", "strategy": strategy,
            "shape": [n, p, m],
            "errors": _compare(got, ref, f"oracle parity ({strategy})")}


def check_f64_parity(x=None, n=2000, p=3000, m=64, n_blocks=30) -> dict:
    """The f32 samples-path evaluation against the same evaluation in
    float64 on the device (whose step parity with the oracle is pinned by
    tests/test_parity.py)."""
    import jax.numpy as jnp

    if x is None:
        x = make_block_data(n, p, n_blocks, seed=2)
    n, p = x.shape
    xp = _standardize(x)
    w = seeded_w0(m, p)
    wj = jnp.asarray(w, jnp.float32)
    got = {prec: _evaluate(wj, xp, "samples", prec) for prec in F32_PRECISIONS}
    ref = _evaluate(jnp.asarray(w, jnp.float64), xp.astype(jnp.float64),
                    "samples", "highest")
    del xp
    return {"reference": "float64 evaluation on the device",
            "strategy": "samples", "shape": [n, p, m],
            "errors": _compare(got, ref, "float64 parity (samples)")}


def label_agreement(a, b) -> float:
    """Share of variables whose cluster label in `a`, renamed to the
    label of `b` it overlaps most, equals the label in `b` (factor order
    is a TC sort, so near-equal factors may swap places)."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)

    def one_way(u, v):
        return sum(np.unique(v[u == lab], return_counts=True)[1].max()
                   for lab in np.unique(u)) / u.size

    # both ways, so that merging two clusters into one is not agreement
    return float(min(one_way(a, b), one_way(b, a)))


def check_int8_parity(x=None, n=2000, p=1000, m=64, n_blocks=16,
                      strategy="gram") -> dict:
    """The int8-operand evaluation (`matmul_dtype='int8'`: quantized Σ or
    X) against the f32 evaluation at 'highest' precision, from the same
    standardized data and the same seeded W, within TOL['int8']."""
    import jax.numpy as jnp

    from linearcorex_tpu.ops import moments as M

    if x is None:
        x = make_block_data(n, p, n_blocks, seed=1)
    n, p = x.shape
    xp = _standardize(x)
    data = M.compute_gram(xp) if strategy == "gram" else xp
    w = jnp.asarray(seeded_w0(m, p), jnp.float32)
    ref = _evaluate(w, data, strategy, "highest")
    q = M.quantize_gram(data) if strategy == "gram" \
        else M.quantize_samples(data)
    got = {"int8": _evaluate(w, q, strategy, "default")}
    return {"reference": "f32 evaluation at 'highest' on the device",
            "strategy": strategy, "shape": [n, p, m],
            "errors": _compare(got, ref, f"int8 parity ({strategy})")}


def compare_int8_fit(x, int8_model) -> dict:
    """Record (not a check) of the int8 throughput fit against the f32
    fit of the same recipe and seed: final TC and the share of cluster
    labels equal up to renaming. The no-anneal recipe is a basin lottery,
    so the two fits may converge to different optima."""
    import linearcorex_tpu as lc
    from linearcorex_tpu.config import PRESETS

    m = int8_model.n_hidden
    # the throughput recipe spelled out with f32 operands: under
    # preset='throughput' an explicit matmul_dtype='float32' equals the
    # constructor default and would be overridden by the preset's int8
    recipe = {k: v for k, v in PRESETS["throughput"].items()
              if k != "matmul_dtype"}
    f32 = lc.Corex(n_hidden=m, seed=0, **recipe).fit(x)
    return {"shape": [x.shape[0], x.shape[1], m],
            "matmul_dtypes": [int8_model.config.matmul_dtype,
                              f32.config.matmul_dtype],
            "tc_int8": float(int8_model.tc), "tc_f32": float(f32.tc),
            "tc_rel": _rel(int8_model.tc, f32.tc),
            "labels_equal": label_agreement(int8_model.clusters,
                                            f32.clusters)}


# The checks the `gpu`-marked tests run (tests/test_chip_smoke.py), at the
# sizes they run them; the gpu_checks phase runs the same list.
GPU_CHECKS = {
    "oracle_parity_gram": (check_oracle_parity, {"strategy": "gram"}),
    "oracle_parity_samples": (check_oracle_parity,
                              {"strategy": "samples"}),
    "f64_parity_samples": (check_f64_parity, {}),
    "int8_parity_gram": (check_int8_parity, {"strategy": "gram"}),
    "int8_parity_samples": (check_int8_parity, {"strategy": "samples"}),
}


def correct_phase(ns_x, ns_int8, cfg5_shape=(10_000, 100_000, 512, 500)):
    """Full-width comparisons: northstar against the NumPy oracle, cfg5
    against float64 on the card, the int8 evaluations against f32 on
    both; plus the record of the int8 throughput fit against f32."""
    n, p, m, n_blocks = cfg5_shape
    m_ns = ns_int8.n_hidden
    out = {"northstar_oracle": check_oracle_parity(ns_x, m=m_ns,
                                                   strategy="gram"),
           "northstar_int8": check_int8_parity(ns_x, m=m_ns,
                                               strategy="gram"),
           "northstar_int8_fit_vs_f32": compare_int8_fit(ns_x, ns_int8)}
    x5 = make_block_data(n, p, n_blocks, seed=5)
    out["cfg5_f64"] = check_f64_parity(x5, m=m)
    out["cfg5_int8"] = check_int8_parity(x5, m=m, strategy="samples")
    return out


def gpu_checks_phase() -> dict:
    return {name: fn(**kw) for name, (fn, kw) in GPU_CHECKS.items()}


def four_phase(devices, n=40_000, p=100_000, m=512, iters=30,
               sweep_n=10_000, sweep_lanes=32, sweep_iters=10,
               n_blocks=500) -> dict:
    """Sample-sharded fits over `devices` (GSPMD and shard_map), each
    step-matched against the one-device fit of the same data, and the
    combined restarts x data sweep."""
    import jax

    import linearcorex_tpu as lc
    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.models import corex as C
    from linearcorex_tpu.parallel.sharding import (DATA_AXIS, fit_shard_map,
                                                   make_mesh)

    d = len(devices)
    mesh = make_mesh(((DATA_AXIS, d),), devices=devices)
    x = make_block_data(n, p, n_blocks, seed=7, device=devices[0])
    kw = dict(n_hidden=m, seed=0, anneal=False, tol=0.0, max_iter=iters,
              moment_strategy="samples", optimizer="momentum",
              record_history=False)
    out = {"shape": [n, p, m], "iterations": iters, "devices": d}

    def run(label, fn):
        t0 = time.perf_counter()
        tc = float(fn())
        out[label] = {"tc": tc, "wall_s": time.perf_counter() - t0}
        return tc

    with jax.default_device(devices[0]):
        tc1 = run("one_device", lambda: lc.Corex(**kw).fit(x).tc)
    tcg = run("gspmd", lambda: lc.Corex(**kw).fit(x, mesh=mesh).tc)
    out["gspmd"]["tc_rel"] = _rel(tcg, tc1)

    # explicit-psum shard_map on the standardized operand, against the
    # one-device fit program on the same operand and W
    import jax.numpy as jnp
    cfg = C.resolve_config(CorexConfig(**{k: v for k, v in kw.items()
                                          if k != "seed"}),
                           p, n_samples=n)
    with jax.default_device(devices[0]):
        xp = _standardize(x)
        del x
        w0 = jnp.asarray(seeded_w0(m, p), jnp.float32)
        tcr = run("one_device_program",
                  lambda: C._fit_program(xp, w0, cfg, "samples")[1].tc)
    tcs = run("shard_map", lambda: fit_shard_map(xp, w0, cfg, mesh)[1].tc)
    out["shard_map"]["tc_rel"] = _rel(tcs, tcr)
    del xp
    for label in ("gspmd", "shard_map"):
        if not out[label]["tc_rel"] <= FOUR_TC_REL:
            raise SmokeFailure(f"{label} vs one device: {out[label]}")

    # restarts x data sweep (BASELINE config 5's layout), as many of
    # `sweep_lanes` lanes as fit in device memory
    mesh2 = make_mesh((("restarts", 2), (DATA_AXIS, d // 2)),
                      devices=devices)
    x5 = make_block_data(sweep_n, p, n_blocks, seed=5, device=devices[0])
    lanes = sweep_lanes
    while True:
        try:
            t0 = time.perf_counter()
            sw = lc.Corex(n_hidden=m, seed=0, anneal=False, tol=0.0,
                          max_iter=sweep_iters, moment_strategy="samples",
                          optimizer="momentum", record_history=False,
                          n_restarts=lanes).fit(x5, mesh=mesh2)
            tc = float(sw.tc)
            break
        except Exception as e:  # noqa: BLE001 — only OOM steps down
            if "RESOURCE_EXHAUSTED" not in str(e) or lanes <= 2:
                raise
            lanes //= 2
    out["sweep"] = {"lanes": lanes, "asked_lanes": sweep_lanes,
                    "shape": [sweep_n, p, m], "iterations": sweep_iters,
                    "tc_best": tc, "best_lane": sw.best_restart_,
                    "wall_s": time.perf_counter() - t0,
                    "peak_bytes_in_use": [peak_bytes(dv) for dv in devices]}
    return out


def emit(phase: str, card: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": card, **fields},
                     default=float), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sample-sharded path")
    args = ap.parse_args(argv)

    import jax

    import linearcorex_tpu  # noqa: F401 — fail before printing anything

    jax.config.update("jax_enable_x64", True)  # float64 references
    dev = device_phase(4 if args.four else None)
    card = dev.pop("card")
    print(card, flush=True)
    emit("device", card, **dev)
    if args.four:
        devices = jax.devices()[:4]
        emit("four", card, **four_phase(devices))
    else:
        rec, ns_x, ns_int8 = northstar_phase()
        emit("northstar", card, **rec)
        emit("cfg5", card, **cfg5_phase())
        emit("correct", card, **correct_phase(ns_x, ns_int8))
        del ns_x, ns_int8
        emit("gpu_checks", card, **gpu_checks_phase())
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark suite over the BASELINE.json config sizes.

Measures steady-state solver iterations/sec for each BASELINE.json config
size plus the north-star metric size, on the current default device. Every
timed region is one compiled program; timing closes with a scalar fetch,
which waits for the device.

Usage:
    python benchmarks/run_benchmarks.py            # all configs
    python benchmarks/run_benchmarks.py --small    # CI-sized subset

Prints results as a markdown table to stdout.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# (name, n, p, m, strategy, matmul_dtype, numpy_baseline_s_per_iter[, optimizer])
# NumPy baselines measured this machine (BASELINE.md §2; None = not measured).
# The *_fixed_point rows time the reference-style closed-form update
# (optimizer='fixed_point'): ~half the GEMMs per iteration, ~1.5-2x the
# iterations to converge — per-iteration rates are not directly comparable
# to the gradient rows (see the e2e rows for time-to-convergence).
CONFIGS = [
    ("cfg1_p128_m8_n1k", 1000, 128, 8, "samples", "float32", 0.00033),
    ("cfg2_p2k_m32_n10k", 10_000, 2048, 32, "gram", "float32", 0.161),
    ("cfg3_p10k_m64_n200", 200, 10_000, 64, "samples", "float32", 0.0326),
    ("northstar_p10k_m512_n10k", 10_000, 10_000, 512, "gram", "float32",
     12.72),
    # like-for-like row: same two-GEMM samples-path
    # iteration structure as the NumPy baseline, so the hardware-vs-
    # algorithm split stays visible (the gram rows also change the
    # algorithm: ~20x fewer FLOPs/iter at this size)
    ("northstar_p10k_m512_n10k_samples_likeforlike", 10_000, 10_000, 512,
     "samples", "float32", 12.72),
    ("northstar_p10k_m512_n10k_bf16", 10_000, 10_000, 512, "gram",
     "bfloat16", 12.72),
    ("cfg5_p100k_m512_n10k_1chip", 10_000, 100_000, 512, "samples",
     "bfloat16", 130.7),
    ("northstar_p10k_m512_fixed_point", 10_000, 10_000, 512, "gram",
     "float32", None, "fixed_point"),
    ("cfg5_p100k_m512_fixed_point", 10_000, 100_000, 512, "samples",
     "bfloat16", None, "fixed_point"),
    # the production config bench.py measures: optimizer='auto' resolves
    # to fixed_point at this fully-sampled shape (n = p)
    ("northstar_p10k_m512_auto_production", 10_000, 10_000, 512, "gram",
     "float32", 12.72, "auto"),
    # int8 quantized samples path (matmul_dtype='int8'): twice the bf16
    # tensor-core rate; identical converged TC at this shape (RESULTS e2e)
    ("cfg5_p100k_m512_int8", 10_000, 100_000, 512, "samples",
     "int8", 130.7),
    ("northstar_p10k_m512_int8_gram", 10_000, 10_000, 512, "gram",
     "int8", 12.72),
    # bench.py's headline: the recommended throughput config at this
    # shape — int8 gram + optimizer='auto' (→ fixed_point at n = p)
    ("northstar_p10k_m512_int8_gram_fp", 10_000, 10_000, 512, "gram",
     "int8", 12.72, "auto"),
]

SMALL = {"cfg1_p128_m8_n1k", "cfg3_p10k_m64_n200"}


def run_one(name, n, p, m, strategy, mm_dtype, iters, optimizer="momentum"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.core.solver import fit_core
    from linearcorex_tpu.models.corex import _make_obj_grad, resolve_config
    from linearcorex_tpu.ops import moments as M
    from linearcorex_tpu.utils.profiling import iteration_rate

    key_z, key_e = jax.random.split(jax.random.PRNGKey(0))
    n_blocks = min(m, 100)
    k = p // n_blocks

    @jax.jit
    def make_data():
        z = jax.random.normal(key_z, (n, n_blocks), jnp.float32)
        e = jax.random.normal(key_e, (n, p), jnp.float32)
        blocks = jnp.repeat(z, k, axis=1)           # n_blocks*k columns
        rem = p - n_blocks * k                       # leftover: pure noise
        signal = jnp.concatenate(
            [blocks, jnp.zeros((n, rem), jnp.float32)], axis=1) \
            if rem else blocks
        x = signal * 0.9 + 0.436 * e
        return (x - x.mean(0)) / x.std(0)

    x = make_data()
    x.block_until_ready()
    data = x
    if strategy == "gram":
        data = jax.jit(M.compute_gram)(x)
    if mm_dtype == "bfloat16":
        data = data.astype(jnp.bfloat16)   # halve the per-iter memory traffic
        data.block_until_ready()
    elif mm_dtype == "int8":
        # quantize the strategy's operand: X (samples) or Σ (gram)
        data = jax.jit(M.quantize_samples)(data)
        data.q.block_until_ready()
    else:
        data.block_until_ready()

    # the production resolution (single source of truth: resolve_config)
    # for BOTH 'auto' knobs — rows measure exactly what Corex.fit would run
    cfg = resolve_config(
        CorexConfig(n_hidden=m, max_iter=iters, tol=0.0, anneal=False,
                    record_history=False, dtype="float32",
                    matmul_dtype=mm_dtype, optimizer=optimizer),
        p, n_samples=n)

    @functools.partial(jax.jit, static_argnums=(2, 3))
    def run(d, w0, cfg, strat):
        return fit_core(_make_obj_grad(d, cfg, strat), w0, cfg)

    w0 = jnp.asarray(np.random.RandomState(1).normal(
        scale=1.0 / np.sqrt(p), size=(m, p)), jnp.float32)
    ips, total, dt = iteration_rate(
        functools.partial(run, data, w0, cfg, strategy))
    return ips, dt


def run_e2e_northstar():
    """End-to-end annealed fit to tol=1e-5 at the north-star size, for both
    optimizers (momentum = default; fixed_point = the reference-style
    closed-form update, half the GEMMs per iteration): wall time +
    iterations, vs the NumPy-estimated time (iterations x 12.72 s/iter,
    BASELINE.md §2)."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.core.solver import fit_core
    from linearcorex_tpu.models.corex import _make_obj_grad
    from linearcorex_tpu.ops import moments as M

    n, p, m = 10_000, 10_000, 512
    key_z, key_e = jax.random.split(jax.random.PRNGKey(0))

    @jax.jit
    def make_data():
        z = jax.random.normal(key_z, (n, 100), jnp.float32)
        e = jax.random.normal(key_e, (n, p), jnp.float32)
        x = jnp.repeat(z, p // 100, axis=1) * 0.9 + 0.436 * e
        return (x - x.mean(0)) / x.std(0)

    x = make_data()
    gram = jax.jit(M.compute_gram)(x)
    gram.block_until_ready()
    cfg = CorexConfig(n_hidden=m, max_iter=2000, tol=1e-5, anneal=True,
                      record_history=False, dtype="float32")

    @functools.partial(jax.jit, static_argnums=(2, 3))
    def run(d, w0, cfg, strat):
        return fit_core(_make_obj_grad(d, cfg, strat), w0, cfg)

    w0 = jnp.asarray(np.random.RandomState(1).normal(
        scale=1.0 / np.sqrt(p), size=(m, p)), jnp.float32)
    gq = jax.jit(M.quantize_gram)(gram)
    gq.q.block_until_ready()
    rows = []
    # int8 pairs with tol=1e-4 (quantization noise floor); label shows it
    for label, opt, mmd, tol in (
            ("momentum", "momentum", "float32", 1e-5),
            ("fixed_point", "fixed_point", "float32", 1e-5),
            ("int8+auto", "auto", "int8", 1e-4)):
        cfg_o = dataclasses.replace(cfg, optimizer=opt, matmul_dtype=mmd,
                                    tol=tol)
        if opt == "auto":
            from linearcorex_tpu.models.corex import resolve_config
            cfg_o = resolve_config(cfg_o, p, n_samples=n)
        d = gq if mmd == "int8" else gram
        run(d, w0, cfg_o, "gram")[1].tc_per_stage.block_until_ready()
        dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            ws, diag = run(d, w0, cfg_o, "gram")
            tc = float(diag.tc_per_stage[-1])
            dt = min(dt, time.perf_counter() - t0)
        total = int(np.asarray(diag.iters_per_stage).sum())
        numpy_est = total * 12.72
        tol_s = f"{tol:g}"
        rows.append(
            f"| e2e annealed fit p=10k m=512 tol={tol_s} ({label}) | "
            f"{total} iters in {dt:.2f}s (TC={tc:.1f}) | "
            f"{dt*1000/max(total,1):.2f} | {numpy_est/dt:,.0f}x "
            f"(NumPy est. {numpy_est/3600:.1f} h) |")
    return "\n".join(rows)


def run_e2e_cfg5():
    """End-to-end annealed cfg5 fit (p=100k, m=512, n=10k, bf16 samples
    path, one chip) to tol=1e-4 — the north-star time-to-TC-convergence
    shape, both optimizers. NumPy estimate: iterations x 130.7 s/iter
    (BASELINE.md §2)."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.core.solver import fit_core
    from linearcorex_tpu.models.corex import _make_obj_grad, resolve_config

    n, p, m = 10_000, 100_000, 512
    key_z, key_e = jax.random.split(jax.random.PRNGKey(0))

    @jax.jit
    def make_data():
        z = jax.random.normal(key_z, (n, 100), jnp.float32)
        e = jax.random.normal(key_e, (n, p), jnp.float32)
        x = jnp.repeat(z, p // 100, axis=1) * 0.9 + 0.436 * e
        return ((x - x.mean(0)) / x.std(0)).astype(jnp.bfloat16)

    x = make_data()
    x.block_until_ready()
    # bf16 GEMM noise floor ~1e-3 relative => tol=1e-4 (config.py note)
    cfg = CorexConfig(n_hidden=m, max_iter=1000, tol=1e-4, anneal=True,
                      record_history=False, matmul_dtype="bfloat16")
    cfg = resolve_config(cfg, p)

    @functools.partial(jax.jit, static_argnums=(2, 3))
    def run(d, w0, cfg, strat):
        return fit_core(_make_obj_grad(d, cfg, strat), w0, cfg)

    w0 = jnp.asarray(np.random.RandomState(1).normal(
        scale=1.0 / np.sqrt(p), size=(m, p)), jnp.float32)
    from linearcorex_tpu.ops.moments import quantize_samples
    xq = jax.jit(quantize_samples)(x.astype(jnp.float32))
    xq.q.block_until_ready()
    # spectral init (round 3): W0 = Q^T from QR(Σ̂·Ω) — same draw the
    # library's _spectral_init_program makes (samples backend, f32)
    omega = jax.random.normal(jax.random.PRNGKey(101), (p, m), jnp.float32)

    @jax.jit
    def spectral_w0(xf, omega):
        z = jnp.matmul(xf.T, jnp.matmul(xf, omega,
                       preferred_element_type=jnp.float32),
                       preferred_element_type=jnp.float32) / xf.shape[0]
        q, _ = jnp.linalg.qr(z)
        return q.T

    w0_spec = spectral_w0(x.astype(jnp.float32), omega)
    w0_spec.block_until_ready()
    rows = []
    # (label, optimizer, matmul_dtype): int8 is the fastest measured cfg5
    # config at identical converged TC (see the int8 rows' TC)
    for label, opt, mmd, anneal, stage_tol in (
            ("momentum", "momentum", "bfloat16", True, 1.0),
            ("fixed_point", "fixed_point", "bfloat16", True, 1.0),
            ("momentum+int8", "momentum", "int8", True, 1.0),
            # round-4 annealed-path knob: non-final stages at tol x 10
            # (RESULTS.md stage-tol study; final stage still at tol)
            ("momentum+int8, stage_tol_factor=10", "momentum", "int8",
             True, 10.0),
            # the strong-structure throughput knob (DESIGN.md): measured
            # equal-or-better TC on every seed at this data's block
            # strength, 4x fewer iterations
            ("momentum+int8, anneal=False", "momentum", "int8", False,
             1.0),
            # the round-3 best config (init study in this file's footer);
            # this row IS Corex(preset='throughput') resolved at cfg5
            # shapes — pinned in lockstep by
            # tests/test_api.py::test_throughput_preset_matches_maintained_e2e_row
            ("momentum+int8, anneal=False, init=spectral"
             " [= preset='throughput']", "momentum", "int8", False, 1.0)):
        cfg_o = dataclasses.replace(cfg, optimizer=opt, matmul_dtype=mmd,
                                    anneal=anneal,
                                    stage_tol_factor=stage_tol)
        d = xq if mmd == "int8" else x
        w0_row = w0_spec if "spectral" in label else w0
        run(d, w0_row, cfg_o, "samples")[1].tc_per_stage.block_until_ready()
        dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            ws, diag = run(d, w0_row, cfg_o, "samples")
            tc = float(diag.tc_per_stage[-1])
            dt = min(dt, time.perf_counter() - t0)
        total = int(np.asarray(diag.iters_per_stage).sum())
        numpy_est = total * 130.7
        rows.append(
            f"| e2e annealed cfg5 p=100k tol=1e-4 ({label}) | {total} "
            f"iters in {dt:.1f}s (TC={tc:.0f}) | "
            f"{dt*1000/max(total,1):.1f} | "
            f"{numpy_est/dt:,.0f}x (NumPy est. {numpy_est/3600:.0f} h) |")
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    # 200 matches bench.py so the shared rows report ONE number: timed
    # programs carry a fixed overhead (dispatch + scalar-fetch sync), so
    # per-iteration rates depend on the program's iteration count
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--e2e", action="store_true",
                    help="also run the end-to-end annealed north-star fit")
    ap.add_argument("--e2e-cfg5", action="store_true",
                    help="also run the end-to-end annealed cfg5 (p=100k) "
                         "fit, both optimizers (slow compiles)")
    args = ap.parse_args()

    import jax

    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache
    ensure_compile_cache()
    rows = []
    dev = jax.devices()[0]
    print(f"device: {dev}", flush=True)
    for name, n, p, m, strategy, mm_dtype, base, *rest in CONFIGS:
        if args.small and name not in SMALL:
            continue
        optimizer = rest[0] if rest else "momentum"
        print(f"running {name} ...", flush=True)
        try:
            ips, dt = run_one(name, n, p, m, strategy, mm_dtype, args.iters,
                              optimizer)
            speedup = ips * base if base else float("nan")
            # sub-0.5 ms/iter rows sit on the dispatch latency floor,
            # not compute — a speedup ratio from them would present
            # noise as fact
            if base and 1000.0 / ips < 0.5:
                ratio = "(latency floor — ratio is noise)*"
            else:
                ratio = f"{speedup:,.0f}x" if base else "n/a"
            rows.append((name, f"{ips:.1f}", f"{1000.0/ips:.2f}", ratio))
            print(f"  {ips:.1f} it/s", flush=True)
        except Exception as e:  # record failures, keep going
            rows.append((name, "FAIL", "-", str(e)[:60]))
            print(f"  FAILED: {e}", flush=True)

    header = ("| config | iters/sec | ms/iter | speedup vs 1-core NumPy |\n"
              "|---|---|---|---|\n")
    table = header + "\n".join(
        f"| {a} | {b} | {c} | {d} |" for a, b, c, d in rows)
    if args.e2e and not args.small:
        print("running e2e annealed north-star fit ...", flush=True)
        try:
            table += "\n" + run_e2e_northstar()
        except Exception as e:
            table += f"\n| e2e annealed fit | FAIL | - | {str(e)[:60]} |"
    if args.e2e_cfg5 and not args.small:
        print("running e2e annealed cfg5 fit ...", flush=True)
        try:
            table += "\n" + run_e2e_cfg5()
        except Exception as e:
            table += f"\n| e2e annealed cfg5 | FAIL | - | {str(e)[:60]} |"
    print(f"\ndevice: {dev}\n\n{table}")


if __name__ == "__main__":
    main()

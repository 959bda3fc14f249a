"""Serving-path measurement: blocked covariance export at cfg5 scale
(p=100k, m=512) on one chip — the `covariance_matmat` / `covariance_blocks`
row of RESULTS.md.

Timings are ON-DEVICE production rates (each block closed by a scalar
fetch): what the export costs before any device→host transfer. Pulling
blocks to host is bounded by the device→host path and is reported
separately for one block.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import linearcorex_tpu as lc
    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache

    ensure_compile_cache()
    n, p, m = 10_000, 100_000, 512
    key_z, key_e = jax.random.split(jax.random.PRNGKey(0))

    @jax.jit
    def make_data():
        z = jax.random.normal(key_z, (n, 100), jnp.float32)
        e = jax.random.normal(key_e, (n, p), jnp.float32)
        x = jnp.repeat(z, p // 100, axis=1) * 0.9 + 0.436 * e
        return (x - x.mean(0)) / x.std(0)

    x = make_data()
    x.block_until_ready()
    model = lc.Corex(n_hidden=m, max_iter=200, tol=1e-4, anneal=False,
                     matmul_dtype="int8", record_history=False)
    model.fit(x)
    print(json.dumps({"fit_tc": round(float(model.tc), 0)}), flush=True)

    # covariance_matmat: one (p, 128) block application
    v = jax.random.normal(jax.random.PRNGKey(1), (p, 128), jnp.float32)
    out = model.covariance_matmat(v)
    float(out[0, 0])                      # warm (compile excluded)
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = model.covariance_matmat(v)
        float(out[0, 0])
        dt = min(dt, time.perf_counter() - t0)
    print(json.dumps({"matmat_p100k_k128_ms": round(dt * 1e3, 1)}),
          flush=True)

    # covariance_blocks: full on-device pass (25 blocks of 4096 rows =
    # 40 GB of Σ̂ produced block-wise; each block closed by a scalar)
    bs = 4096
    t0 = time.perf_counter()
    nblocks = 0
    for start, rows in model.covariance_blocks(bs):
        float(rows[0, 0])
        nblocks += 1
    dt_all = time.perf_counter() - t0
    # warm passes: median of 3 repeats
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        for start, rows in model.covariance_blocks(bs):
            float(rows[0, 0])
        warm.append(time.perf_counter() - t0)
    dt_warm = sorted(warm)[1]
    gb = p * p * 4 / 1e9
    print(json.dumps({
        "blocks": nblocks, "block_rows": bs,
        "full_export_on_device_s_first": round(dt_all, 2),
        "full_export_on_device_s_warm": round(dt_warm, 2),
        "effective_GBps": round(gb / dt_warm, 1)}), flush=True)

    # host pull of ONE block (the D2H-bound part, reported separately)
    start, rows = next(iter(model.covariance_blocks(bs)))
    t0 = time.perf_counter()
    _ = np.asarray(rows)
    dt_pull = time.perf_counter() - t0
    print(json.dumps({
        "one_block_to_host_s": round(dt_pull, 2),
        "block_MB": round(rows.size * 4 / 1e6, 0)}), flush=True)


if __name__ == "__main__":
    main()

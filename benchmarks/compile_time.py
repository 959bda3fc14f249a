"""First-call wall-time measurement: cold vs persistent-cache vs AOT.

A first fit pays XLA's compile (and GEMM autotuning) before any work. This
script measures what the library's wiring (utils/compile_cache.py) buys,
at the cfg5 production shape (p=100k, m=512, n=10k, int8+auto), through
the REAL user surface `Corex.fit(X)`:

  cold  — fresh empty cache dir: first fit pays the full compile;
  warm  — new process, same cache dir: first fit deserializes the cached
          executable instead of compiling;
  aot   — fresh cache dir, but `Corex.warmup(n, p)` runs first (the
          deploy-time step): warmup pays the compile, the first fit then
          hits the cache written moments earlier.

Each mode must run in its OWN process (the in-process jit dispatch cache
would hide the effect), so run each in its own process:

    python benchmarks/compile_time.py --mode cold --cache-dir /tmp/cc1
    python benchmarks/compile_time.py --mode warm --cache-dir /tmp/cc1
    python benchmarks/compile_time.py --mode aot  --cache-dir /tmp/cc2

Prints one JSON line per run; measured results land in RESULTS.md's
compile-time table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["cold", "warm", "aot"],
                    required=True)
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--size", choices=["cfg5", "northstar"],
                    default="cfg5")
    args = ap.parse_args()
    os.environ["LINEARCOREX_TPU_CACHE_DIR"] = args.cache_dir

    import jax
    import jax.numpy as jnp

    import linearcorex_tpu as lc

    if args.size == "cfg5":
        n, p, m = 10_000, 100_000, 512
    else:
        n, p, m = 10_000, 10_000, 512
    key_z, key_e = jax.random.split(jax.random.PRNGKey(0))

    @jax.jit
    def make_data():
        z = jax.random.normal(key_z, (n, 100), jnp.float32)
        e = jax.random.normal(key_e, (n, p), jnp.float32)
        x = jnp.repeat(z, p // 100, axis=1) * 0.9 + 0.436 * e
        return (x - x.mean(0)) / x.std(0)

    x = make_data()
    x.block_until_ready()

    model = lc.Corex(n_hidden=m, max_iter=1000, tol=1e-4, anneal=True,
                     matmul_dtype="int8", optimizer="auto",
                     record_history=False)
    t_warmup = None
    if args.mode == "aot":
        t0 = time.perf_counter()
        model.warmup(n, p)
        t_warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.fit(x)
    tc = float(model.tc)        # scalar fetch closes the timing
    t_fit = time.perf_counter() - t0
    print(json.dumps({
        "mode": args.mode, "size": args.size,
        "first_fit_s": round(t_fit, 2),
        "warmup_s": round(t_warmup, 2) if t_warmup is not None else None,
        "tc": round(tc, 1),
        "cache_dir": args.cache_dir,
    }))


if __name__ == "__main__":
    main()

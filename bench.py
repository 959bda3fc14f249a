"""Solver throughput: fit iterations/sec at p=10k, m=512 (BASELINE.json).

Configuration: the throughput recipe at this shape — matmul_dtype='int8'
(per-tensor-quantized Σ, int8 x int8 → int32 GEMMs) with
optimizer='auto', which at n=p=10k resolves to the damped closed-form
fixed-point update (the reference's own `_update_ws` iteration style:
`[U] linearcorex/linearcorex.py :: _update_ws`) on the precomputed-Gram
strategy. One iteration = one int8 Σ·Wᵀ GEMM + the moment chain + the
m x m fixed-point solve + the damped accept/reject update.

Protocol:
- the whole K-iteration loop runs as ONE compiled program (a fit_core call
  with tol=0), so there are zero host round-trips inside the timed region;
- timing is closed by fetching a scalar (TC), which waits for the device;
- compile is excluded (untimed warmup call on the same shapes);
- the median of 3 timed repeats is reported.

Prints the device (platform, device_kind, count) on one line, then one
JSON line {"metric": ..., "value": ..., "unit": ...}. Exits non-zero,
printing no result, when JAX finds no GPU: a CPU number is not a
measurement of this system. `--quick` runs a small shape.
"""

import json
import sys

import numpy as np


def main():
    quick = "--quick" in sys.argv
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}))

    from linearcorex_tpu.utils.compile_cache import ensure_compile_cache
    ensure_compile_cache()
    import jax.numpy as jnp

    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.core.solver import fit_core
    from linearcorex_tpu.models.corex import _make_obj_grad, resolve_config
    from linearcorex_tpu.ops import moments as M
    from linearcorex_tpu.utils.profiling import iteration_rate

    if quick:
        n, p, m, iters = 1024, 512, 32, 50
    else:
        n, p, m, iters = 10_000, 10_000, 512, 200

    # synthetic block data generated on the device
    n_blocks = 100 if p % 100 == 0 else 8
    k = p // n_blocks
    key_z, key_e = jax.random.split(jax.random.PRNGKey(0))

    @jax.jit
    def make_data():
        z = jax.random.normal(key_z, (n, n_blocks), jnp.float32)
        e = jax.random.normal(key_e, (n, p), jnp.float32)
        x = jnp.repeat(z, k, axis=1) * 0.9 + 0.436 * e
        return (x - x.mean(0)) / x.std(0)

    x = make_data()
    gram = M.quantize_gram(M.compute_gram(x))
    gram.q.block_until_ready()

    # every 'auto' knob resolved exactly as Corex.fit would
    cfg = resolve_config(
        CorexConfig(n_hidden=m, max_iter=iters, tol=0.0, anneal=False,
                    record_history=False, dtype="float32",
                    matmul_dtype="int8", optimizer="auto"),
        p, n_samples=n)

    import functools

    # data is a jit ARGUMENT, not a closure: a closed-over array would be
    # baked into the program as a constant
    @functools.partial(jax.jit, static_argnums=(2, 3))
    def run(data, w0, cfg, strategy):
        return fit_core(_make_obj_grad(data, cfg, strategy), w0, cfg)

    w0 = jnp.asarray(
        np.random.RandomState(1).normal(scale=1.0 / np.sqrt(p),
                                        size=(m, p)), jnp.float32)
    ips, n_iter, dt = iteration_rate(
        functools.partial(run, gram, w0, cfg, "gram"))
    print(json.dumps({
        "metric": "fit_iterations_per_sec_p10k_m512"
        if not quick else "fit_iterations_per_sec_quick",
        "value": ips,
        "unit": "iter/s",
    }))


if __name__ == "__main__":
    main()

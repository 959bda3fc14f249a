"""Scaling workflows: multi-restart sweeps, device-mesh sharding, stacking.

Run on any JAX backend; on a multi-GPU host the meshes map onto the real
cards (here they run on whatever devices are visible).

Run: python examples/scaling.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import linearcorex_tpu as lc
from linearcorex_tpu.config import CorexConfig
from linearcorex_tpu.ops import preprocessing as P
from linearcorex_tpu.parallel.restarts import (best_restart, fit_restarts,
                                               init_restarts)
from linearcorex_tpu.parallel.sharding import (DATA_AXIS, ShardingPlan,
                                               fit_sharded, make_mesh)


def make_data(n=2048, p=128, m=8, seed=0):
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    k = p // m
    x = np.repeat(z, k, axis=1) * 0.9 + 0.436 * rng.normal(size=(n, p))
    return x


def main():
    x = make_data()
    n, p = x.shape
    dtype = jnp.float32

    # --- 1. vmapped multi-restart sweep: 8 fits, one compiled program ----
    xp, _ = P.fit_preprocess(jnp.asarray(x, dtype), "standard")
    cfg = CorexConfig(n_hidden=8, dtype="float32", record_history=False)
    w0 = init_restarts(8, 8, p, seed=0, dtype=dtype)
    ws_b, mom_b, diag_b = fit_restarts(xp, w0, cfg, "samples")
    ws, mom, diag, idx = best_restart(ws_b, mom_b, diag_b)
    print(f"restart sweep: best TC {float(mom.tc):.3f} (restart {int(idx)}; "
          f"all: {np.asarray(mom_b.tc).round(2)})")

    # --- 2. sample-sharded fit over a device mesh ------------------------
    n_dev = len(jax.devices())
    if n % n_dev == 0:
        mesh = make_mesh(((DATA_AXIS, n_dev),))
        ws_sh, mom_sh, _ = fit_sharded(xp, w0[0], cfg, mesh, ShardingPlan())
        print(f"sharded fit over {n_dev} device(s): TC {float(mom_sh.tc):.3f}")

    # --- 2b. the same from the estimator surface: restart lanes sharded
    # over a 'restarts' mesh axis (+ sample rows over 'data' — the
    # combined restarts x data layout of BASELINE config 5), one call
    if n_dev % 2 == 0 and n % (n_dev // 2 or 1) == 0:
        mesh_rd = make_mesh((("restarts", 2), (DATA_AXIS, n_dev // 2)))
        est = lc.Corex(n_hidden=8, n_restarts=4, seed=0,
                       record_history=False,
                       moment_strategy="samples").fit(x, mesh=mesh_rd)
        print(f"estimator restart sweep on the mesh: best TC "
              f"{float(est.tc):.3f} (lane {est.best_restart_})")

    # --- 3. stacked 2-layer CorEx ---------------------------------------
    stack = lc.StackedCorex([8, 2], seed=0).fit(x)
    print(f"stacked: layer TCs = "
          f"{[round(float(np.sum(np.asarray(t))), 2) for t in stack.tcs]}")


def streaming_demo():
    """Streaming + summary-statistics workflows (no X in memory)."""
    import numpy as np
    from linearcorex_tpu import GramAccumulator, fit_from_covariance

    x = make_data(n=4096, p=128, m=8, seed=1)
    acc = GramAccumulator(p=128)
    for i in range(0, 4096, 512):           # batches stream through
        acc.update(x[i:i + 512])
    model = acc.fit(n_hidden=8, seed=0)
    print(f"streaming fit from {acc.n_samples} samples: TC {model.tc:.3f}")

    sigma = np.cov(x.T)                      # or shared summary statistics
    model2 = fit_from_covariance(sigma, n_samples=4096, n_hidden=8, seed=0)
    print(f"fit from covariance matrix:     TC {model2.tc:.3f}")


def int8_demo():
    """Quantized operand mode: int8 x int8 -> int32 GEMMs against the
    f32 fit of the same seed (pair with tol >= 1e-4)."""
    import linearcorex_tpu as lc

    x = make_data(n=4096, p=256, m=8, seed=2)
    i8 = lc.Corex(n_hidden=8, seed=0, matmul_dtype="int8",
                  tol=1e-4).fit(x)
    f32 = lc.Corex(n_hidden=8, seed=0, tol=1e-4).fit(x)
    print(f"int8 fit: TC {float(i8.tc):.3f} "
          f"(f32: {float(f32.tc):.3f}; optimizer ran: "
          f"{i8.resolved_optimizer_})")


def production_demo():
    """Round-3 production workflow: AOT warmup (compile at deploy time,
    not first-request time), a 2-level multi-host mesh, stage-boundary
    checkpointing on that mesh, and blocked covariance export."""
    import tempfile

    import jax
    import numpy as np

    import linearcorex_tpu as lc
    from linearcorex_tpu.parallel.sharding import (DATA_AXIS, SLICE_AXIS,
                                                   ShardingPlan, make_mesh)
    from linearcorex_tpu.utils.checkpoint import fit_with_checkpoints

    x = make_data(n=2048, p=128, m=8, seed=3)
    n_dev = len(jax.devices())
    model = lc.Corex(n_hidden=8, seed=0, record_history=False)
    if n_dev % 2 == 0:
        # 2-level host x device mesh: the DP psum reduces hierarchically
        # (NVLink within a host, the network between hosts)
        mesh = make_mesh(((SLICE_AXIS, 2), (DATA_AXIS, n_dev // 2)))
        plan = ShardingPlan(shard_samples=True, shard_slices=True)
        # AOT: warm THE PROGRAM THE FIT RUNS — the sharded one here (a
        # single-device warmup would compile a different cache key).
        # Note warmup covers `fit`'s one-program schedule; the
        # checkpointed driver below runs per-stage programs instead
        # (preemption recovery trades one compile for per-stage ones).
        model.warmup(*x.shape, mesh=mesh, sharding_plan=plan)
        model.fit(x, mesh=mesh, sharding_plan=plan)
        print(f"multi-host fit (AOT-warmed): TC {model.tc:.3f}")
        # sharded SERVING: the inference surface takes the same mesh/plan
        # pair (round 4) — here the p-sized state + incoming X never need
        # one device's memory (use shard_vars plans for p beyond one device);
        # sharding_plan=None on later calls reuses the state's plan
        y = model.transform(x, mesh=mesh, sharding_plan=plan)
        ll = model.score(x, mesh=mesh)
        print(f"sharded serving: factors {y.shape}, "
              f"log-likelihood {float(ll):.3f}")
        with tempfile.TemporaryDirectory() as ck:
            fit_with_checkpoints(model, x, ck, mesh=mesh,
                                 sharding_plan=plan)
        print(f"multi-host checkpointed fit: TC {model.tc:.3f}")
    else:
        model.warmup(*x.shape)
        model.fit(x)
    # blocked export: dense rows of the 128 x 128 covariance without the
    # p x p materialization step (the path that matters at p=100k+)
    rows = np.vstack([np.asarray(r) for _, r in
                      model.covariance_blocks(block_size=48)])
    full = np.asarray(model.get_covariance())
    print(f"blocked covariance export: {rows.shape}, max|Δ| vs dense = "
          f"{np.abs(rows - full).max():.2e}")


if __name__ == "__main__":
    main()
    streaming_demo()
    int8_demo()
    production_demo()

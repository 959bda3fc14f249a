"""Device-time share of the moment chain in one solver iteration (GPU).

The moment chain is everything between the C_xy GEMM and the gradient GEMM:
`moments_from_cxy` + `_ns_gradient_terms`, run under the `moment_chain`
named scope in ops/moments.py. For each shape this script

  - traces a few steady iterations of the fit program (fit_core with tol=0
    and a fixed iteration count) with jax.profiler, and sums the device
    time of the kernels whose HLO instruction carries that scope, against
    all device kernel time in the window;
  - times, as a cross-check, the chain alone (given C_xy, repeated in one
    program) against a whole iteration, on the host clock around
    block_until_ready.

    python benchmarks/chain_share.py [--out DIR] [--iters N]

Shapes: northstar n=10k, p=10k, m=512 (gram strategy) and cfg5 n=10k,
p=100k, m=512 (samples strategy), f32 heavy-ball at the default matmul
precision. Prints one JSON line per shape with the card's name and power
limit and the XLA_FLAGS it ran under; writes each trace and its top
kernels under DIR. Exits non-zero without a GPU.

XLA:GPU runs the loop body as CUDA graphs (command buffers), whose
kernels carry no HLO instruction in the trace; fusions are still
attributed by kernel name, but library GEMMs are not. Run a second time
with XLA_FLAGS=--xla_gpu_enable_command_buffer= for a full attribution
(kernel times are the same kernels; only launch gaps change).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SCOPE = "moment_chain"
_GEMM = re.compile(r"gemm|xmma|cutlass|cublas", re.I)
_OP_NAME = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"', re.M)


def _key(name: str) -> str:
    # GPU kernels are named after their HLO instruction with '.' -> '_'
    return name.replace(".", "_")


def hlo_op_names(hlo_text: str) -> dict:
    """HLO instruction name -> its op_name metadata (the named-scope
    path), from a compiled module's text."""
    return {_key(k): v for k, v in _OP_NAME.findall(hlo_text)}


def device_kernels(trace_dir: str) -> list:
    """(name, hlo_op, duration_ns) of every kernel event on the GPU
    planes of the newest trace under `trace_dir`."""
    import jax

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    out = []
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name in ("XLA Modules", "XLA Ops", "Steps",
                             "Source code"):
                continue
            for ev in line.events:
                stats = dict(ev.stats)
                out.append((ev.name, str(stats.get("hlo_op", ev.name)),
                            ev.duration_ns))
    return out


def attribute(kernels: list, op_names: dict) -> dict:
    """Chain share of the kernel time in a window, and the top kernels."""
    total = chain = unknown = 0
    by_name: dict = {}
    for name, hlo_op, dur in kernels:
        op = op_names.get(_key(hlo_op), op_names.get(_key(name)))
        total += dur
        if op is None:
            unknown += dur
        elif SCOPE in op:
            chain += dur
        rec = by_name.setdefault(name, {"hlo_op": hlo_op, "op_name": op,
                                        "ns": 0, "count": 0})
        rec["ns"] += dur
        rec["count"] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ns"])[:25]
    return {"kernel_ns": total, "chain_ns": chain, "unattributed_ns": unknown,
            "gemm_ns": sum(v["ns"] for k, v in by_name.items()
                           if _GEMM.search(k)),
            "chain_share_of_kernel_time": chain / total if total else None,
            "top_kernels": [{"name": k, **v} for k, v in top]}


def measure(label, n, p, m, strategy, iters, out_dir, reps=20):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke as S
    from linearcorex_tpu.config import CorexConfig
    from linearcorex_tpu.core.solver import fit_core
    from linearcorex_tpu.models.corex import _make_obj_grad
    from linearcorex_tpu.ops import moments as M

    xp = S._standardize(S.make_block_data(n, p, 100, seed=0))
    data = M.compute_gram(xp) if strategy == "gram" else xp
    w0 = jnp.asarray(S.seeded_w0(m, p), jnp.float32)
    cfg = CorexConfig(n_hidden=m, max_iter=iters, tol=0.0, anneal=False,
                      record_history=False, optimizer="momentum")

    @partial(jax.jit, static_argnums=(2,))
    def run(d, w, cfg):
        return fit_core(_make_obj_grad(d, cfg, strategy), w, cfg)

    jax.block_until_ready(run(data, w0, cfg))  # compile + warm
    t0 = time.perf_counter()
    _, diag = jax.block_until_ready(run(data, w0, cfg))
    wall = time.perf_counter() - t0
    done = int(np.asarray(diag.iters_per_stage).sum())

    tdir = os.path.join(out_dir, label)
    with jax.profiler.trace(tdir):
        jax.block_until_ready(run(data, w0, cfg))
    op_names = hlo_op_names(run.lower(data, w0, cfg).compile().as_text())
    traced = attribute(device_kernels(tdir), op_names)

    # cross-check: the chain alone, `reps` times in one program
    c_xy = M.cxy_gram(data, w0, 0.0) if strategy == "gram" \
        else M.cxy_samples(data, w0, 0.0)

    @jax.jit
    def chain_only(ws, c):
        def body(i, acc):
            mom = M.moments_from_cxy(ws, c + acc, 1.0, 1.0 - 1e-6)
            aa, hmat, coef, _ = M._ns_gradient_terms(mom)
            return acc + 1e-30 * (aa[0, 0] + hmat[0, 0] + coef[0])
        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    jax.block_until_ready(chain_only(w0, c_xy))
    t0 = time.perf_counter()
    jax.block_until_ready(chain_only(w0, c_xy))
    chain_s = (time.perf_counter() - t0) / reps
    iter_s = wall / max(done, 1)
    top = traced.pop("top_kernels")
    with open(os.path.join(out_dir, f"{label}_top_kernels.json"), "w") as f:
        json.dump({"top_kernels": top}, f, indent=1)
    return {"shape": [n, p, m], "strategy": strategy, "iterations": done,
            "iter_ms": iter_s * 1e3, "chain_alone_ms": chain_s * 1e3,
            "chain_share_isolated": chain_s / iter_s, **traced}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/chain_share")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import chip_smoke as S

    dev = S.device_phase()
    os.makedirs(args.out, exist_ok=True)
    for label, n, p, m, strategy in (
            ("northstar_gram", 10_000, 10_000, 512, "gram"),
            ("cfg5_samples", 10_000, 100_000, 512, "samples")):
        rec = measure(label, n, p, m, strategy, args.iters, args.out)
        print(json.dumps({"cell": label, "card": dev["card"],
                          "kind": dev["kind"],
                          "xla_flags": os.environ.get("XLA_FLAGS", ""),
                          **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Re-measure pick_n_hidden padded-vs-sequential WITH the persistent
compile cache (the round-2 1.33x padded win was
entirely compile-bound and was measured cache-off; the two knobs must be
judged together).

Protocol: same shape as the round-2 row (p=1024, max_n=8, repeat=4,
max_iter=2000, seed=0). Pass --cache-dir for a FRESH dir to measure the
cold (first-ever) wall time, or reuse a dir for the warm time. Runs one
mode per process (in-process jit caches would contaminate the second
mode):

    python benchmarks/selection_bench.py --mode padded     --cache-dir D
    python benchmarks/selection_bench.py --mode sequential --cache-dir D
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["padded", "sequential"],
                    required=True)
    ap.add_argument("--cache-dir", required=True)
    args = ap.parse_args()
    os.environ["LINEARCOREX_TPU_CACHE_DIR"] = args.cache_dir

    import numpy as np

    import linearcorex_tpu as lc

    rng = np.random.RandomState(0)
    n, p, m_true = 2000, 1024, 4
    z = rng.normal(size=(n, m_true))
    x = np.repeat(z, p // m_true, axis=1) * 0.9 \
        + 0.44 * rng.normal(size=(n, p))

    t0 = time.perf_counter()
    best, scores = lc.pick_n_hidden(
        x, repeat=4, max_n_hidden=8, max_iter=2000, seed=0,
        padded_sweep=args.mode == "padded")
    dt = time.perf_counter() - t0
    print(json.dumps({"mode": args.mode, "wall_s": round(dt, 2),
                      "best_n": int(best),
                      "scores": [round(float(s), 2) for s in scores]}))


if __name__ == "__main__":
    main()

"""Tracing / profiling helpers (SURVEY.md §5).

The reference's only observability is `verbose` prints with wall-time. Here:
- `trace(logdir)` wraps `jax.profiler.trace` so a fit can be captured for
  TensorBoard/XProf without code changes;
- `fit_report` turns the on-device FitDiagnostics into a human-readable
  per-stage summary (host sync happens once, here, by explicit request);
- `iteration_rate` measures steady-state solver throughput of one compiled
  fit program (compile excluded, each timed call closed by a scalar
  fetch, which waits for the device).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np

__all__ = ["trace", "fit_report", "iteration_rate"]


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a device trace of the enclosed block for TensorBoard."""
    import jax
    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def fit_report(diagnostics, schedule=None) -> str:
    """Per-stage convergence table from FitDiagnostics. `schedule`
    defaults to the fit-time snapshot the diagnostics carry
    (`eps_schedule`) — pass it explicitly only to override the labels."""
    iters = np.asarray(diagnostics.iters_per_stage)
    tcs = np.asarray(diagnostics.tc_per_stage)
    deltas = np.asarray(diagnostics.delta_per_stage)
    if schedule is None:
        schedule = np.asarray(diagnostics.eps_schedule).tolist()
    lines = ["stage  eps      iters   TC           max|dW|"]
    for s in range(len(iters)):
        eps = schedule[s] if schedule is not None else float("nan")
        lines.append(f"{s:>5}  {eps:7.4f}  {iters[s]:>5}   "
                     f"{tcs[s]:<12.6f} {deltas[s]:.3e}")
    lines.append(f"total iterations: {int(iters.sum())}")
    return "\n".join(lines)


def iteration_rate(run_fn, *args, warmup: bool = True,
                   n_timed: Optional[int] = None, reps: int = 3):
    """Time a compiled fit program.

    run_fn(*args) must return (ws, diagnostics) and be jitted; each timed
    region is one call (one host sync via a scalar fetch), repeated `reps`
    times taking the median. Returns (iterations_per_second,
    total_iterations, seconds).
    """
    if warmup:
        ws, diag = run_fn(*args)
        float(np.asarray(diag.tc_per_stage)[-1])
    times = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        ws, diag = run_fn(*args)
        float(np.asarray(diag.tc_per_stage)[-1])
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    total = int(np.asarray(diag.iters_per_stage).sum())
    if n_timed is not None:
        total = n_timed
    return total / dt, total, dt

"""The annealed fixed-point/GD solver as one compiled XLA program.

This is layer L4 of the reference (`[U] linearcorex/linearcorex.py ::
Corex.fit`, SURVEY.md §3.1) re-designed for accelerator execution:

- The reference runs a Python `for` loop with a per-iteration convergence
  check on the host; on an accelerator each such check is a host round
  trip and a separate dispatch. Here the whole anneal schedule compiles
  to ONE device program: `lax.scan` over the eps schedule,
  `lax.while_loop` for the inner iteration, convergence predicate traced
  on device. One host sync per `fit()` (SURVEY.md §7.3 item 0).
- Diagnostics (TC trajectory, iteration counts) are carried as fixed-size
  on-device arrays and returned once, never streamed.
- The optimizer is deterministic adaptive gradient descent with step
  halving, mirroring the float64 oracle step-for-step so seed-matched parity
  checks are exact (SURVEY.md §4.2 item 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from linearcorex_tpu.config import CorexConfig

ObjGrad = Callable[[jax.Array, jax.Array], Tuple[jax.Array, jax.Array,
                                                 jax.Array]]


class FitDiagnostics(NamedTuple):
    """Structured replacement for the reference's `verbose` prints and
    `history` dict (SURVEY.md §5): everything is a device array produced by
    the single compiled fit program."""

    iters_per_stage: jax.Array   # (n_stages,) int32
    tc_per_stage: jax.Array      # (n_stages,)
    delta_per_stage: jax.Array   # (n_stages,)
    objective_per_stage: jax.Array  # (n_stages,)
    tc_history: jax.Array        # (n_stages, max_iter) or (n_stages, 0)
    # The eps schedule the fit actually ran, snapshotted AT FIT TIME:
    # `history`/`_print_verbose`/`fit_report` label stages from here, so a
    # post-fit set_params(anneal=...) cannot silently mislabel the
    # recorded trajectory.
    eps_schedule: jax.Array      # (n_stages,)


class _Carry(NamedTuple):
    ws: jax.Array
    f: jax.Array
    g: jax.Array
    v: jax.Array        # heavy-ball momentum buffer
    tc: jax.Array
    lr: jax.Array
    it: jax.Array
    delta: jax.Array
    hist: jax.Array


def _stage(obj_grad: ObjGrad, cfg: CorexConfig, ws0: jax.Array,
           eps: jax.Array, tol: jax.Array):
    """Run one annealing stage to convergence (traced while_loop).
    `tol` is the stage's convergence tolerance (cfg.tol_schedule():
    non-final stages may run looser via cfg.stage_tol_factor).

    Optimizer: deterministic step-halving line search over plain GD,
    heavy-ball momentum (v ← β·v − lr·g, reset to 0 on a rejected step), or
    the damped fixed-point ('fixed_point': obj_grad returns ws − Ŵ, the
    plain-GD step becomes (1−γ)·ws + γ·Ŵ with γ ∈ (0, 1]). Momentum is the
    default — measured ~3x fewer iterations to the same TC — and the
    float64 oracle implements the identical rules, so seed-matched runs
    stay step-for-step comparable."""
    dt = ws0.dtype
    momentum = cfg.optimizer == "momentum"
    fixed_point = cfg.optimizer == "fixed_point"
    # the fixed-point damping γ lives in (0, 1] and has its own config
    # fields (defaults mirrored by the oracle)
    lr_init = cfg.fp_gamma_init if fixed_point else cfg.lr_init
    lr_cap = cfg.fp_gamma_cap if fixed_point else cfg.lr_cap
    hist_len = cfg.max_iter if cfg.record_history else 0
    f0, g0, tc0 = obj_grad(ws0, eps)

    def cond(c: _Carry):
        return ((c.it < cfg.max_iter) & (c.delta >= tol)
                & (c.lr >= cfg.lr_min))

    def body(c: _Carry):
        if momentum:
            v_new = cfg.momentum_beta * c.v - c.lr * c.g
            ws_new = c.ws + v_new
        else:
            v_new = c.v
            ws_new = c.ws - c.lr * c.g
        f_new, g_new, tc_new = obj_grad(ws_new, eps)
        accept = f_new <= c.f
        delta = jnp.where(accept, jnp.max(jnp.abs(ws_new - c.ws)),
                          jnp.asarray(jnp.inf, dt))
        ws = jnp.where(accept, ws_new, c.ws)
        f = jnp.where(accept, f_new, c.f)
        g = jnp.where(accept, g_new, c.g)
        v = jnp.where(accept, v_new, jnp.zeros_like(c.v)) if momentum \
            else c.v
        tc = jnp.where(accept, tc_new, c.tc)
        lr = jnp.where(accept, jnp.minimum(c.lr * cfg.lr_growth, lr_cap),
                       c.lr * cfg.lr_halve)
        hist = c.hist
        if cfg.record_history:
            hist = jax.lax.dynamic_update_index_in_dim(hist, tc, c.it, 0)
        return _Carry(ws=ws, f=f, g=g, v=v, tc=tc, lr=lr, it=c.it + 1,
                      delta=delta, hist=hist)

    init = _Carry(
        ws=ws0, f=f0, g=g0, v=jnp.zeros_like(ws0), tc=tc0,
        lr=jnp.asarray(lr_init, dt),
        it=jnp.asarray(0, jnp.int32),
        delta=jnp.asarray(jnp.inf, dt),
        hist=jnp.zeros((hist_len,), dt),
    )
    out = jax.lax.while_loop(cond, body, init)
    return out.ws, (out.it, out.tc, out.delta, out.f, out.hist)


def fit_core(obj_grad: ObjGrad, w0: jax.Array, cfg: CorexConfig):
    """Full annealed fit: scan over the eps schedule (SURVEY.md §2.4) with a
    while_loop per stage. Returns (ws, FitDiagnostics). Pure and jittable;
    callers close `obj_grad` over the data (samples or Gram matrix)."""
    schedule = jnp.asarray(cfg.anneal_schedule(), dtype=w0.dtype)
    tols = jnp.asarray(cfg.tol_schedule(), dtype=w0.dtype)

    def scan_body(ws, eps_tol):
        eps, tol = eps_tol
        ws_new, stats = _stage(obj_grad, cfg, ws, eps, tol)
        return ws_new, stats

    ws, (iters, tcs, deltas, objs, hists) = jax.lax.scan(
        scan_body, w0, (schedule, tols))
    diag = FitDiagnostics(iters_per_stage=iters, tc_per_stage=tcs,
                          delta_per_stage=deltas, objective_per_stage=objs,
                          tc_history=hists, eps_schedule=schedule)
    return ws, diag


def sort_by_tcs(ws: jax.Array, tcs: jax.Array):
    """Reorder factors by decreasing per-factor TC (`[U] :: Corex.fit`
    post-processing, SURVEY.md §2.6 [MED])."""
    order = jnp.argsort(-tcs)
    return ws[order], order

"""The Linear CorEx moment system as pure JAX functions (the compute path).

This is layer L3 of the reference (`[U] linearcorex/linearcorex.py ::
Corex._calculate_moments*`, SURVEY.md §2.3) re-designed for XLA:

- The p x p covariance is never materialized on the 'samples' path: the two
  skinny GEMMs X·Wᵀ and Xᵀ·Y/n dominate and go straight to the GEMM
  units.
- A 'gram' path precomputes Sigma = XᵀX/n ONCE and replaces both per-iteration
  GEMMs with a single Sigma·Wᵀ product — at the primary benchmark size
  (p=10k, m=512, n=10k) that is ~20x fewer FLOPs per iteration than the
  reference's two-GEMM structure. The reference cannot do this because its
  fit loop is glued to the sample matrix; under jit the strategy is a static
  choice.
- All matmuls request an explicit accumulation dtype: >=float32 always (so a
  bf16 fast path keeps fp32 moment precision), float64 preserved when running
  oracle-parity checks.
- Everything is shape-static and control-flow-free, so the whole fit compiles
  to one XLA program (SURVEY.md §7.3 item 0: one host sync per fit).

Annealing enters analytically (never sampled): the moment blend
C_xy ← (1−eps²)·⟨x·y⟩ + eps²·Wᵀ (SURVEY.md §2.4, numerically verified).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_F32 = jnp.float32


def _acc(t):
    """GEMM accumulation dtype: >=float32 always (bf16 inputs accumulate in
    fp32), float64 preserved for oracle-parity runs."""
    return jnp.promote_types(t, _F32)


def _mm(a, b):
    """Matmul with explicit accumulation dtype, cast back to operand dtype."""
    return jnp.matmul(a, b, preferred_element_type=_acc(a.dtype)).astype(
        jnp.promote_types(a.dtype, b.dtype))


def _mm_bf16(a, b, out_dtype):
    """Throughput-mode matmul: bf16 operands (tensor-core rate, half the
    memory traffic), float32 accumulation, float32/out_dtype result."""
    return jnp.matmul(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                      preferred_element_type=_F32).astype(out_dtype)


# ---------------------------------------------------------------------------
# int8 quantized samples operand (matmul_dtype='int8')
# ---------------------------------------------------------------------------

class QuantizedData(NamedTuple):
    """int8-quantized data operand: X (or Σ) ≈ scale · q, per-tensor scale.

    The GEMMs run int8 x int8 → int32 (the H100's tensor cores take int8
    at twice the bf16 rate), and the int8 operand halves bf16's memory
    footprint again. A per-tensor scale suffices for both operand kinds:
    the solver standardizes X column-wise (unit variance ⇒ homogeneous
    range) and
    the Gram matrix is a correlation matrix (entries in [−1, 1]).

    End-to-end quality (annealed to tol=1e-4; recorded before the move to
    the H100, where chip_smoke.py re-checks int8 against f32 at full width):
    cfg5 samples path TC 204361 vs bf16's 204386 in the same 133
    iterations; north-star gram path (p=10k, heavy-ball) TC 11888 vs
    f32's 11902. The accept/reject line search plus
    annealing absorb the quantization noise (gradient cosine vs f32 is
    0.9999 far from the optimum and ~0.89 near it — the noise floor is
    why tol must stay >= 1e-4 and int8 is excluded from the f64 parity
    surface).

    Accumulation-range note: products accumulate in int32, so a p-axis
    contraction has a hard worst case of 127²·p (wraps beyond p≈133k).
    For the standardized operands this mode quantizes, accumulands are
    zero-mean with RMS ~23 — a p=500k run sat ~5e3 standard
    deviations below the wrap point — but adversarially rank-1-aligned
    inputs could overflow. `quantize_samples` GUARDS this at quantize
    time (eager callers — Corex.fit, pick_n_hidden, the restart drivers):
    when the guaranteed-safe certificate 127·max(row/col |q| sums) ≤
    int32 max fails, a random-vector probe compares int32 vs float
    accumulation of the same int8 operands and RAISES on an actual wrap,
    warns on a merely-possible one (tests/test_int8.py); use 'bfloat16'
    when the data is not approximately standardized-Gaussian-like."""

    q: jax.Array       # (n, p) samples or (p, p) Gram, int8
    scale: jax.Array   # () float32


_INT32_MAX = float(2 ** 31 - 1)


@jax.jit
def _int8_abs_sum_bound(q):
    """Guaranteed-safe int32 accumulation certificate: every contraction
    the int8 paths run (q @ vq over axis 1, qᵀ @ tq over axis 0, both
    against |operand| ≤ 127) is bounded in magnitude by
    127 · max(row |q| sums, col |q| sums). If that is ≤ int32 max, NO
    application vector can wrap. f32 sums are exact to ~1e-7 relative —
    irrelevant against the bound's own slack."""
    a = jnp.abs(q).astype(_F32)
    return 127.0 * jnp.maximum(jnp.max(jnp.sum(a, axis=0)),
                               jnp.max(jnp.sum(a, axis=1)))


@jax.jit
def _int8_wrap_probe(q, u):
    """Max relative disagreement between int32 and float32 accumulation of
    the SAME int8 operands over both contraction axes. int32 wrap shows as
    O(1) relative error (the wrapped value is off by a multiple of 2³²);
    f32 accumulation rounding is ~1e-6 — cleanly separable.

    Probe vectors: random columns AND data-aligned columns (one power-
    iteration step, v = qᵀ·u). The aligned columns model the solver's real
    late-fit operands — near convergence the columns of Wᵀ/AAᵀ align with
    the data's principal structure, which is exactly when rank-1-aligned
    inputs wrap (a plain random probe misses this: sign cancellation keeps
    it ~√p below the worst case)."""
    def one(a, b):
        r32 = jnp.matmul(a, b, preferred_element_type=jnp.int32).astype(
            _F32)
        rf = jnp.matmul(a.astype(_F32), b.astype(_F32),
                        preferred_element_type=_F32)
        return jnp.max(jnp.abs(r32 - rf)) / jnp.maximum(
            jnp.max(jnp.abs(rf)), 1.0)
    qf = q.astype(_F32)
    v = jnp.concatenate([u[: q.shape[1]],
                         jnp.matmul(qf.T, u[: q.shape[0]],
                                    preferred_element_type=_F32)], axis=1)
    vq, _ = _quant_cols(v)
    t = jnp.matmul(qf, vq.astype(_F32), preferred_element_type=_F32)
    tq, _ = _quant_cols(t)
    return jnp.maximum(one(q, vq), one(q.T, tq))


def _check_int8_wrap(qd: "QuantizedData") -> None:
    """Runtime guard against silent int32 accumulator wrap (see the
    `QuantizedData` accumulation-range note). Certificate first (free);
    only when it fails, probe the actual int8 GEMMs with a random
    application vector: raise on a demonstrated wrap, warn on a
    merely-possible one."""
    import warnings

    import numpy as np
    q = qd.q
    if q.ndim != 2:
        return
    if float(_int8_abs_sum_bound(q)) <= _INT32_MAX:
        return
    u = jnp.asarray(np.random.RandomState(0).normal(
        size=(max(q.shape), 4)), _F32)
    err = float(_int8_wrap_probe(q, u))
    if err > 0.1:
        raise ValueError(
            f"int8 accumulation overflow: the quantized operand wraps the "
            f"int32 accumulator on a data-aligned application vector "
            f"(relative error {err:.2f} vs float accumulation) — int8 "
            f"results on this data would be silently wrong. Use "
            f"matmul_dtype='bfloat16' (or 'float32'). (Advanced: callers "
            f"of the low-level drivers can pre-quantize with "
            f"quantize_samples(x, check_overflow=False), but the wrap is "
            f"demonstrated, not hypothetical.)")
    warnings.warn(
        f"int8 accumulation COULD overflow: the guaranteed-safe bound "
        f"127*max(|q| row/col sums) = {float(_int8_abs_sum_bound(q)):.3g} "
        f"exceeds int32 max ({_INT32_MAX:.3g}). A random-vector probe "
        f"found no wrap (relative error {err:.2g}), which is expected for "
        f"standardized zero-mean data, but adversarially aligned "
        f"application vectors could still wrap silently — prefer "
        f"matmul_dtype='bfloat16' if the data is not approximately "
        f"standardized-Gaussian-like")


@jax.jit
def _quantize_program(x):
    """abs-max scale + clip/round/cast as ONE fused program: the eager
    op-by-op chain materializes ~3 operand-sized f32 temporaries between
    dispatches (at p=100k that is ~12 GB of transient device memory; the
    fit path's
    `models.corex._prepare_program` fuses for the same reason). Inlined
    as a no-op when `quantize_samples` is itself called under a trace."""
    s = jnp.maximum(jnp.max(jnp.abs(x)).astype(_F32) / 127.0, 1e-30)
    q = jnp.clip(jnp.round(x.astype(_F32) / s), -127, 127).astype(jnp.int8)
    return q, s


def quantize_samples(x, check_overflow: bool = True) -> QuantizedData:
    """Quantize a standardized samples matrix (or a correlation-scaled
    Gram matrix — see `quantize_gram`) to int8 with one global scale.

    check_overflow=True (default) runs the int32 accumulator-wrap guard
    (`_check_int8_wrap`) when called eagerly; inside a jit trace the guard
    is skipped (it needs host control flow) — quantize eagerly, as every
    library driver does, to keep the guard."""
    q, s = _quantize_program(x)
    qd = QuantizedData(q=q, scale=s)
    if check_overflow and not isinstance(q, jax.core.Tracer):
        _check_int8_wrap(qd)
    return qd


def quantize_gram(g, check_overflow: bool = True) -> QuantizedData:
    """Quantize a Gram/correlation matrix to int8 (per-tensor scale —
    correlation entries live in [−1, 1], so the range is homogeneous)."""
    return quantize_samples(g, check_overflow=check_overflow)


def _quant_cols(v):
    """Per-column dynamic int8 quantization of an application operand
    (columns of Wᵀ/AAᵀ span very different magnitudes, unlike X's)."""
    s = jnp.maximum(jnp.max(jnp.abs(v), axis=0) / 127.0, 1e-30)
    q = jnp.clip(jnp.round(v / s), -127, 127).astype(jnp.int8)
    return q, s


def _apply_sigma_int8(qd: QuantizedData, v):
    """v (p, k) f32 ↦ Σ_emp·v via two int8 GEMMs (int32 accumulation),
    samples operand.

    Scales factor out of the contractions: X ≈ sx·q (per-tensor) and
    v ≈ q_v·diag(s_v) (per-column) give X·v ≈ sx·(q @ q_v)·diag(s_v); the
    intermediate is re-quantized per-column for the second GEMM."""
    vq, sv = _quant_cols(v)
    t = jnp.matmul(qd.q, vq, preferred_element_type=jnp.int32)
    t = t.astype(_F32) * (qd.scale * sv)[None, :]
    tq, st = _quant_cols(t)
    r = jnp.matmul(qd.q.T, tq, preferred_element_type=jnp.int32)
    return r.astype(_F32) * (qd.scale * st)[None, :] / qd.q.shape[0]


def _apply_gram_int8(qd: QuantizedData, v):
    """v (p, k) f32 ↦ Σ·v via ONE int8 GEMM (Gram operand)."""
    vq, sv = _quant_cols(v)
    r = jnp.matmul(qd.q, vq, preferred_element_type=jnp.int32)
    return r.astype(_F32) * (qd.scale * sv)[None, :]


def _apply_int8(qd: QuantizedData, v, gram: bool):
    return _apply_gram_int8(qd, v) if gram else _apply_sigma_int8(qd, v)


def _dequantized(x):
    """f32 view of a quantized operand (one-time exact-GEMM paths: final
    moments, transform details — XLA fuses the convert+scale into the
    consuming matmul). No-op for plain arrays."""
    if isinstance(x, QuantizedData):
        return x.q.astype(_F32) * x.scale
    return x


class Moments(NamedTuple):
    """Moment pytree — field names map 1:1 to the reference's moment dict
    keys (SURVEY.md §2.3): c_xy="X_i Y_j", cy="cy", z2="Y_j^2", ry="ry",
    rho="rho", invrho="invrho", rhoinvrho="rhoinvrho", qij="Qij", si="Si",
    qi="Qi", vi="X_i^2 | Y", mi="MI", tcs="TCs", tc="TC"."""

    c_xy: jax.Array     # p x m
    cy: jax.Array       # m x m
    z2: jax.Array       # m
    ry: jax.Array       # m x m
    rho: jax.Array      # m x p
    invrho: jax.Array   # m x p
    rhoinvrho: jax.Array  # m x p
    qij: jax.Array      # m x p
    si: jax.Array       # p
    qi: jax.Array       # p
    vi: jax.Array       # p   <x_i^2 | Y>
    mi: jax.Array       # m x p
    i_y_x: jax.Array    # m
    tcs: jax.Array      # m
    tc: jax.Array       # scalar
    objective: jax.Array  # scalar

    def asdict(self):
        """Reference-keyed dict (`transform(details=True)` parity,
        SURVEY.md §2.6), including the full-moments extras: "X_i Z_j"
        (reconstruction weights, SURVEY.md §3.3) and the per-variable
        "additivity" diagnostic Σ_i (Σ_j I(x_i;y_j) − I(x_i;Y))."""
        xz = reconstruction_weights(self)
        i_xi_y = -0.5 * jnp.log(jnp.maximum(self.vi, 1e-30))
        additivity = jnp.sum(jnp.sum(self.mi, axis=0) - i_xi_y)
        return {
            "X_i Y_j": self.c_xy, "cy": self.cy, "Y_j^2": self.z2,
            "ry": self.ry, "rho": self.rho, "invrho": self.invrho,
            "rhoinvrho": self.rhoinvrho, "Qij": self.qij, "Si": self.si,
            "Qi": self.qi, "X_i^2 | Y": self.vi, "MI": self.mi,
            "I_y_x": self.i_y_x, "TCs": self.tcs, "TC": self.tc,
            "objective": self.objective, "X_i Z_j": xz,
            "additivity": additivity,
        }


def cxy_samples(x, ws: jax.Array, eps) -> jax.Array:
    """C_xy = Xᵀ(X·Wᵀ)/n, annealed. Two O(n·p·m) GEMMs; the p x p
    covariance is never formed (SURVEY.md §2.3 key architectural fact).
    A QuantizedData operand is dequantized here — this is the one-time
    exact path (final moments), not the per-iteration one."""
    x = _dequantized(x)
    n = x.shape[0]
    y = _mm(x, ws.T)                                              # n x m
    c_xy = _mm(x.T, y) / n                                        # p x m
    return (1.0 - eps ** 2) * c_xy + (eps ** 2) * ws.T


def cxy_gram(gram, ws: jax.Array, eps) -> jax.Array:
    """C_xy = Sigma·Wᵀ, annealed — single O(p²·m) GEMM against the
    precomputed Gram matrix (a fast path with no reference analog).
    A QuantizedData operand is dequantized here (one-time exact path)."""
    gram = _dequantized(gram)
    c_xy = _mm(gram, ws.T)
    return (1.0 - eps ** 2) * c_xy + (eps ** 2) * ws.T


def compute_gram(x: jax.Array) -> jax.Array:
    """Sigma = XᵀX/n (one-time O(n·p²) GEMM, amortized over the fit loop).

    Runs at 'highest' matmul precision regardless of the session default:
    on the GPU the default lets XLA run f32 matmuls in TF32 (10-bit
    mantissa, ~1e-3 relative error), which is fine per-iteration but not
    for the moment matrix every iteration consumes — and the cost is
    one-time."""
    n = x.shape[0]
    with jax.default_matmul_precision("highest"):
        return _mm(x.T, x) / n


def moments_from_cxy(ws: jax.Array, c_xy: jax.Array, y_scale: float,
                     rho_clip: float) -> Moments:
    """All second-moment quantities + TC/MI given C_xy (SURVEY.md §2.3,
    [HIGH], numerically verified). Elementwise algebra + one m x m and
    one m x p GEMM; XLA fuses the elementwise work around the GEMMs."""
    m = ws.shape[0]
    dt = ws.dtype
    cy = _mm(ws, c_xy) + (y_scale ** 2) * jnp.eye(m, dtype=dt)
    z2 = jnp.diagonal(cy)
    sqz = jnp.sqrt(z2)
    ry = cy / jnp.outer(sqz, sqz)
    rho = (c_xy / sqz[jnp.newaxis, :]).T
    rho = jnp.clip(rho, -rho_clip, rho_clip)
    invrho = 1.0 / (1.0 - rho ** 2)
    rhoinvrho = rho * invrho
    qij = _mm(ry, rhoinvrho)
    si = jnp.sum(rho * rhoinvrho, axis=0)
    qi = jnp.sum(rhoinvrho * qij, axis=0)
    # <x_i^2|Y> = mean sq. residual of the product-of-experts reconstruction,
    # (1 + Q_i − S_i²)/(1 + S_i)²; reduces to the ansatz 1/(1+S_i) for
    # uncorrelated factors. The Q_i term discourages overlapping factors.
    vi = (1.0 + qi - si ** 2) / (1.0 + si) ** 2
    mi = -0.5 * jnp.log1p(-rho ** 2)
    i_y_x = 0.5 * jnp.log(z2) - jnp.log(jnp.asarray(y_scale, dtype=dt))
    tcs = jnp.sum(mi, axis=1) - i_y_x
    tc = jnp.sum(tcs)
    objective = 0.5 * jnp.sum(jnp.log(jnp.maximum(vi, 1e-30))) \
        + 0.5 * jnp.sum(jnp.log(z2))
    return Moments(c_xy=c_xy, cy=cy, z2=z2, ry=ry, rho=rho, invrho=invrho,
                   rhoinvrho=rhoinvrho, qij=qij, si=si, qi=qi, vi=vi, mi=mi,
                   i_y_x=i_y_x, tcs=tcs, tc=tc, objective=objective)


def permute_moments(mom: Moments, order: jax.Array) -> Moments:
    """Reindex the factor axis of every moment after the post-fit sort by
    decreasing TCs (per-variable quantities are factor-sums and unchanged)."""
    return Moments(
        c_xy=mom.c_xy[:, order], cy=mom.cy[order][:, order],
        z2=mom.z2[order], ry=mom.ry[order][:, order], rho=mom.rho[order],
        invrho=mom.invrho[order], rhoinvrho=mom.rhoinvrho[order],
        qij=mom.qij[order], si=mom.si, qi=mom.qi, vi=mom.vi,
        mi=mom.mi[order], i_y_x=mom.i_y_x[order], tcs=mom.tcs[order],
        tc=mom.tc, objective=mom.objective,
    )


def reconstruction_weights(mom: Moments) -> jax.Array:
    """R (p x m): E[x_i|y] = Σ_j R_ij y_j — the product-of-experts posterior
    mean R_ij = rhoinvrho_ji/((1+S_i)·sqrt(z2_j)) (SURVEY.md §3.3, verified;
    reference moment key "X_i Z_j")."""
    return (mom.rhoinvrho.T / (1.0 + mom.si)[:, None]
            / jnp.sqrt(mom.z2)[jnp.newaxis, :])


def _ns_gradient_terms(mom: Moments):
    """Shared algebra of the non-overlap gradient (see the float64 oracle
    `linearcorex_tpu/oracle/oracle.py :: _ns_gradient_terms` for the full
    derivation; this is the same closed form in JAX). Returns (AA, H, coef,
    sqz) with sqrt(z2)·∂F/∂W = AA·Σ_eff + H·rho − coef[:,None]·rho."""
    rho, invrho, rr = mom.rho, mom.invrho, mom.rhoinvrho
    alpha = 1.0 / (1.0 + mom.qi - mom.si ** 2)
    beta = 1.0 / (1.0 + mom.si)
    h_fac = (1.0 + rho ** 2) * invrho ** 2
    aa = alpha[None, :] * h_fac * mom.qij \
        - 2.0 * (alpha * mom.si + beta)[None, :] * rho * invrho ** 2
    hmat = _mm(rr * alpha[None, :], rr.T)
    kappa = jnp.sum(aa * rho, axis=1)
    mu = jnp.sum(alpha[None, :] * rr * mom.qij, axis=1)
    coef = kappa + mu - 1.0
    return aa, hmat, coef, jnp.sqrt(mom.z2)


def _cxy_eff(data, ws, eps, bf16, gram):
    """Annealed effective cross-moment C_xy = Σ_eff·Wᵀ from X (samples),
    Σ (gram), or int8-quantized X — the one definition every objective /
    fixed-point entry point shares."""
    if isinstance(data, QuantizedData):
        c0 = _apply_int8(data, ws.T, gram).astype(ws.dtype)
        return (1.0 - eps ** 2) * c0 + (eps ** 2) * ws.T
    if not bf16:
        return cxy_gram(data, ws, eps) if gram else cxy_samples(data, ws,
                                                                eps)
    if gram:
        c0 = _mm_bf16(data, ws.T, ws.dtype)
    else:
        y = _mm_bf16(data, ws.T, ws.dtype)
        c0 = _mm_bf16(data.T, y, ws.dtype) / data.shape[0]
    return (1.0 - eps ** 2) * c0 + (eps ** 2) * ws.T


def _apply_sigma_t(data, bf16, gram, dtype):
    """v (p, k) ↦ Σ_emp·v for the active backend (un-annealed; callers
    blend eps themselves)."""
    if isinstance(data, QuantizedData):
        return lambda v: _apply_int8(data, v, gram).astype(dtype)
    if gram:
        if bf16:
            return lambda v: _mm_bf16(data, v, dtype)
        return lambda v: _mm(data, v)
    n = data.shape[0]
    if bf16:
        return lambda v: _mm_bf16(data.T, _mm_bf16(data, v, dtype),
                                  dtype) / n
    return lambda v: _mm(data.T, _mm(data, v)) / n


def ns_obj_grad_samples(ws, x, eps, y_scale, rho_clip, bf16=False):
    """(objective, gradient, TC) of the non-overlap objective, sample path.

    Cost: 4 skinny GEMMs (2 for moments, 2 for AA·Σ_eff); O(np+pm)
    memory. Matches the oracle's `ns_gradient` bit-for-bit in float64.
    bf16=True runs the four big GEMMs with bfloat16 operands (f32 accum)."""
    return _ns_obj_grad(ws, x, eps, y_scale, rho_clip, bf16, gram=False)


def ns_obj_grad_gram(ws, gram, eps, y_scale, rho_clip, bf16=False):
    """Same as `ns_obj_grad_samples` on the precomputed-Gram fast path:
    2 O(p²·m) GEMMs per evaluation, independent of n.

    With bf16=True the two big GEMMs run with bfloat16 operands (store the
    Gram matrix in bf16 to also halve its memory traffic); the moment chain
    stays float32 — use a looser tol (~1e-4)."""
    return _ns_obj_grad(ws, gram, eps, y_scale, rho_clip, bf16, gram=True)


def _ns_obj_grad(ws, data, eps, y_scale, rho_clip, bf16, gram):
    c_xy = _cxy_eff(data, ws, eps, bf16, gram)
    # the elementwise moment chain between the C_xy GEMM and the
    # gradient GEMM; the scope names its kernels in a profiler trace
    # (benchmarks/chain_share.py)
    with jax.named_scope("moment_chain"):
        mom = moments_from_cxy(ws, c_xy, y_scale, rho_clip)
        aa, hmat, coef, sqz = _ns_gradient_terms(mom)
    if isinstance(data, QuantizedData):
        aas = _apply_int8(data, aa.T, gram).T.astype(ws.dtype)
    elif gram:
        aas = _mm_bf16(aa, data, ws.dtype) if bf16 else _mm(aa, data)
    elif bf16:
        aas = _mm_bf16(_mm_bf16(aa, data.T, ws.dtype), data,
                       ws.dtype) / data.shape[0]
    else:
        aas = _mm(_mm(aa, data.T), data) / data.shape[0]
    aas = (1.0 - eps ** 2) * aas + (eps ** 2) * aa
    grad = (aas + _mm(hmat, mom.rho)
            - coef[:, None] * mom.rho) / sqz[:, None]
    return mom.objective, grad, mom.tc


# ---------------------------------------------------------------------------
# Damped fixed-point update (`optimizer='fixed_point'`) — the reference's
# closed-form iteration style (`[U] :: _update_ws`, SURVEY.md §2.5/§7.0)
# ---------------------------------------------------------------------------

def ns_fp_parts(ws, data, eps, y_scale, rho_clip, bf16=False,
                gram=False):
    """Pieces of the closed-form fixed-point target, before the m x m solve.

    Setting the exact gradient to zero and substituting
    rho = diag(1/sqz)·W·Σ_eff gives (for invertible Σ_eff)

        (diag(coef) − H)·diag(1/sqz)·Ŵ = AA
        Ŵ = diag(sqz)·(diag(coef) − H)⁻¹·AA,

    an m x m solve + elementwise algebra — NO Σ-sized GEMMs, so a
    fixed-point iteration costs 2 big GEMMs (the C_xy pair) instead of the
    gradient step's 4. The iterate W ← (1−γ)W + γŴ with the shared
    accept/reject damping is the JAX rendering of the reference's damped
    `_update_ws` fixed point (`[U] :: _update_ws`; mirrored exactly by the
    float64 oracle). Measured convergence quality vs heavy-ball is
    regime-dependent — see DESIGN.md's table (better on overcomplete m,
    worse for n ≪ p).

    Returns (objective, tc, a_mat (m, m), aa_t (p, m), sqz (m,)); the
    target is assembled by `fp_target_from_parts`. NOTE a measured dead
    end, for future optimizers: a_mat is NEAR-SINGULAR whenever surplus
    factors have died (the overcomplete regime fixed_point is best at) —
    estimated Frobenius condition ~1e18 in f32 at p=10k/m=512/100 blocks.
    The damped accept/reject iteration tolerates the resulting inaccurate
    f32 LU inverse, but iteratively TRACKING the inverse (Newton–Schulz,
    2 steps/iter; prototyped round 2) diverges immediately — ‖I−AM‖_F ≈
    2.6e4 one step after an exact inverse — so the LU inverse stays."""
    c_xy = _cxy_eff(data, ws, eps, bf16, gram)
    return fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip)


def fp_parts_from_cxy(ws, c_xy, y_scale, rho_clip):
    """`ns_fp_parts` given an already-annealed C_xy (the explicit-psum
    shard_map path reduces C_xy itself before calling this)."""
    with jax.named_scope("moment_chain"):
        mom = moments_from_cxy(ws, c_xy, y_scale, rho_clip)
        aa, hmat, coef, sqz = _ns_gradient_terms(mom)
    a_mat = jnp.diag(coef) - hmat
    return mom.objective, mom.tc, a_mat, aa.T, sqz


def ns_fp_from_cxy(ws, c_xy, y_scale, rho_clip):
    """Fixed-point (objective, ws − Ŵ, TC) from an already-annealed C_xy."""
    obj, tc, a_mat, aa_t, sqz = fp_parts_from_cxy(ws, c_xy, y_scale,
                                                  rho_clip)
    return obj, fp_target_from_parts(ws, jnp.linalg.inv(a_mat), aa_t,
                                     sqz), tc


def fp_target_from_parts(ws, a_mat_inv, aa_t, sqz):
    """Ŵ and the solver direction ws − Ŵ from `ns_fp_parts` pieces and the
    inverse of a_mat.

    The m x m system is applied as an explicit inverse followed by a
    GEMM rather than jnp.linalg.solve: a triangular solve with p right-
    hand sides runs far slower than inv + GEMM (its H100 cost is not
    measured yet)."""
    target = _mm(a_mat_inv, aa_t.T) * sqz[:, None]
    return ws - target


def ns_fp_samples(ws, x, eps, y_scale, rho_clip, bf16=False):
    """(objective, ws − Ŵ, TC) for the damped fixed-point update, samples
    path. The returned direction plugs into the solver's plain-GD step:
    ws − γ·(ws − Ŵ) = (1−γ)·ws + γ·Ŵ. Cost: 2 skinny GEMMs — half the
    gradient step's 4."""
    return _ns_fp(ws, x, eps, y_scale, rho_clip, bf16, gram=False)


def ns_fp_gram(ws, gram, eps, y_scale, rho_clip, bf16=False):
    """Gram-path fixed-point update: ONE O(p²·m) GEMM per iteration."""
    return _ns_fp(ws, gram, eps, y_scale, rho_clip, bf16, gram=True)


def _ns_fp(ws, data, eps, y_scale, rho_clip, bf16, gram):
    obj, tc, a_mat, aa_t, sqz = ns_fp_parts(
        ws, data, eps, y_scale, rho_clip, bf16, gram)
    return obj, fp_target_from_parts(ws, jnp.linalg.inv(a_mat), aa_t,
                                     sqz), tc


# ---------------------------------------------------------------------------
# Overlapping (discourage_overlap=False) objective: exact Gaussian bound
# (SURVEY.md §2.5 — m x m solves, still never p x p)
# ---------------------------------------------------------------------------

def _overlap_core(ws, b, cy_chol, y_scale):
    """F and shared terms given B = Σ_eff·Wᵀ and chol(C_y)."""
    m = ws.shape[0]
    bm = jax.scipy.linalg.cho_solve((cy_chol, True), b.T).T     # p x m
    v = jnp.maximum(1.0 - jnp.sum(bm * b, axis=1), 1e-12)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(cy_chol)))
    f = 0.5 * jnp.sum(jnp.log(v)) + 0.5 * logdet \
        - m * jnp.log(jnp.asarray(y_scale, dtype=ws.dtype))
    return f, bm, v


def overlap_obj_grad_samples(ws, x, eps, y_scale):
    """(objective, gradient, TC_proxy) for the exact Gaussian objective.

    ∇F = −(M Bᵀ V)·Σ_eff + (M Bᵀ V B M)·Bᵀ + M·Bᵀ with M = C_y⁻¹,
    V = diag(1/v) (derivation in the oracle; finite-difference verified)."""
    n = x.shape[0]
    mdim = ws.shape[0]
    b = _mm(x.T, _mm(x, ws.T)) / n
    b = (1.0 - eps ** 2) * b + (eps ** 2) * ws.T
    cy = _mm(ws, b) + (y_scale ** 2) * jnp.eye(mdim, dtype=ws.dtype)
    chol = jnp.linalg.cholesky(cy)
    f, bm, v = _overlap_core(ws, b, chol, y_scale)
    g_lhs = (bm / v[:, None]).T                                  # m x p
    gs = _mm(_mm(g_lhs, x.T), x) / n
    gs = (1.0 - eps ** 2) * gs + (eps ** 2) * g_lhs
    k = _mm(g_lhs, b)
    mbt = jax.scipy.linalg.cho_solve((chol, True), b.T)          # m x p
    grad = -gs + _mm(k, mbt) + mbt
    return f, grad, -f


def overlap_obj_grad_gram(ws, gram, eps, y_scale):
    """Gram-path variant of `overlap_obj_grad_samples`."""
    mdim = ws.shape[0]
    b = jnp.matmul(gram, ws.T, preferred_element_type=_F32).astype(ws.dtype)
    b = (1.0 - eps ** 2) * b + (eps ** 2) * ws.T
    cy = _mm(ws, b) + (y_scale ** 2) * jnp.eye(mdim, dtype=ws.dtype)
    chol = jnp.linalg.cholesky(cy)
    f, bm, v = _overlap_core(ws, b, chol, y_scale)
    g_lhs = (bm / v[:, None]).T
    gs = _mm(g_lhs, gram)
    gs = (1.0 - eps ** 2) * gs + (eps ** 2) * g_lhs
    k = _mm(g_lhs, b)
    mbt = jax.scipy.linalg.cho_solve((chol, True), b.T)
    grad = -gs + _mm(k, mbt) + mbt
    return f, grad, -f

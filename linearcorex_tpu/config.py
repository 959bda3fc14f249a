"""Static configuration for the TPU Linear CorEx solver.

The reference configures everything through `Corex.__init__` kwargs
(`[U] linearcorex/linearcorex.py :: Corex.__init__`; SURVEY.md §5 "Config").
Here those kwargs become a frozen dataclass: it is hashable, so it can be a
`static_argnum` of jitted solvers, and every numeric field that participates
in tracing stays out of the Python-level control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# Named hyperparameter bundles for `Corex(preset=...)`:
# each maps constructor parameters to the preset's DEFAULT values; a
# parameter the user sets to any non-default value wins over the preset
# (resolution lives in models.corex.Corex.config — the single config
# policy — so warmup/AOT, sharded fits, and checkpointing all see the
# resolved values with no forked logic).
#
# 'reference': the reference's recipe — every default unchanged (random
#   init, annealed 0.6^k schedule, float32). The implicit preset of a
#   bare Corex().
# 'throughput': the fast production recipe at cfg5 scale (p=100k, m=512;
#   benchmarks/RESULTS.md init study): int8 operands + spectral init +
#   anneal=False + tol=1e-4 (the int8 gradient noise floor) + the regime
#   policy for the optimizer. Quality (recorded before the move to the
#   H100; its speed there is not measured yet): best TC of any config on
#   strong structure (206231-206246 vs annealed-random's 204835-205296)
#   and it rescues the no-anneal collapse on weak structure (6961-6975 vs
#   4623, within the annealed seed spread). CAVEAT: single fits land in
#   a visibly worse basin often (~12% of unseeded fits at cfg5; 3 of 4
#   SEEDED throughput fits sat 6-9% below the best basin) — pair with
#   restarts when the TC matters: `Corex(preset='throughput',
#   n_restarts=k)` runs k spectral lanes, each with its own random
#   projection (benchmarks/RESULTS.md multi-restart note).
PRESETS = {
    "reference": {},
    "throughput": {
        "matmul_dtype": "int8",
        "init": "spectral",
        "anneal": False,
        "tol": 1e-4,
        "optimizer": "auto",
    },
}


def apply_preset(preset: str, user_set: dict) -> dict:
    """Merge `user_set` (parameters the caller explicitly chose) over the
    preset's values — the ONE definition of preset precedence
    (`Corex.config` resolves through here; any future preset-aware
    driver must too, so presets can never mean different things in
    different entry points). Returns a dict covering the preset's keys
    plus everything in `user_set`; raises the named error on an unknown
    preset. Presets are an estimator-level knob on purpose: the
    lower-level sweep drivers (`pick_n_hidden`, `fit_restarts*`) take
    individual kwargs. Estimator restart sweeps compose: with
    init='spectral' each lane draws its own random projection
    (`Corex._spectral_restart_inits`), so
    Corex(preset='throughput', n_restarts=k) runs k genuinely distinct
    lanes."""
    try:
        overrides = PRESETS[preset]
    except (KeyError, TypeError):
        raise ValueError(
            f"unknown preset: {preset!r} (expected one of "
            f"{tuple(PRESETS)})") from None
    out = dict(user_set)
    for k, v in overrides.items():
        out.setdefault(k, v)
    return out


@dataclasses.dataclass(frozen=True)
class CorexConfig:
    """Hyperparameters of one Linear CorEx solve (jit-static).

    Mirrors the reference constructor surface (SURVEY.md §1 L5):
    n_hidden, max_iter, tol, anneal, discourage_overlap, y_scale plus
    knobs the reference lacks (dtype, moment strategy, operand precision).
    """

    n_hidden: int = 10
    max_iter: int = 10000
    tol: float = 1e-5
    anneal: bool = True
    discourage_overlap: bool = True
    y_scale: float = 1.0

    # --- knobs with no reference analog ---
    # Compute dtype: float32 for fits; float64 for oracle-parity runs
    # (on the CPU, or natively on the GPU).
    dtype: str = "float32"
    # Throughput mode for the big moment GEMMs: 'bfloat16' runs them with
    # bf16 operands (halves Σ/X memory traffic; f32 accumulation and a f32
    # elementwise chain). The gradient noise floor rises to ~1e-3 relative —
    # pair with tol>=1e-4. 'int8' (non-overlap path only) quantizes the
    # data operand once to int8 — X on the samples strategy, Σ on the gram
    # strategy (per-tensor scale: standardized columns / correlation
    # entries are range-homogeneous) — and the application operands
    # per-column, running the big GEMMs as int8 x int8 → int32 (twice the
    # bf16 tensor-core rate on the H100) with another 2x off the memory
    # footprint. Quality (annealed to tol=1e-4, recorded before the move
    # to the H100): cfg5 samples path TC 204361 vs bf16's 204386;
    # north-star gram path TC 11888 vs f32's 11902. The accept/reject solver
    # absorbs the quantization noise; keep tol >= 1e-4 (the gradient
    # noise floor is above bf16's). 'float32' is the accuracy default.
    matmul_dtype: str = "float32"
    # XLA matmul precision for f32 operands. On the H100, 'default' lets
    # XLA run f32 dots in TF32 (10-bit mantissa, ~1e-3 relative error per
    # product); 'highest' runs true f32. Set 'highest' when moment
    # precision matters more than throughput. The default is kept until
    # the ledger measures what TF32 costs in TC and buys in time.
    matmul_precision: str = "default"
    # Moment strategy: 'samples' = X^T(XW^T)/n (never materializes p x p,
    # memory O(np+pm)); 'gram' = precompute Sigma = X^T X / n once and use
    # Sigma W^T per iteration (wins when n > p/2); 'auto' picks per
    # shapes, using the gram path up to p = gram_max_p (an H100 bound is
    # not measured yet).
    moment_strategy: str = "auto"
    gram_max_p: int = 20000
    # Deterministic first-order solver (mirrored exactly by the oracle):
    # 'momentum' = heavy-ball with momentum reset on rejected steps
    # (measured ~3x fewer iterations to the same TC than plain 'gd');
    # 'gd' = plain adaptive gradient descent; 'fixed_point' = the
    # reference-style damped closed-form update W ← (1−γ)W + γŴ with
    # Ŵ = diag(sqz)·(diag(coef)−H)⁻¹·AA from stationarity of F
    # (`[U] :: _update_ws`) — 2 big GEMMs/iter instead of 4; measured
    # better optima in fewer iterations on overcomplete/large-m fits,
    # worse in the n<<p regime (DESIGN.md table); non-overlap path only.
    # 'auto' = the measured regime policy: fixed_point when n >= p (full-
    # rank Σ̂) on the non-overlap path, momentum otherwise — resolved
    # against the data shapes by models.corex.resolve_config. 'momentum'
    # stays the constructor default (regime-independent robustness).
    optimizer: str = "momentum"
    momentum_beta: float = 0.9
    # Initial weights: 'random' = the reference's seeded N(0, 1/sqrt(p))
    # draw; 'spectral' = randomized range-finder init (one Σ-application
    # of a random (p, m) block + thin QR; rows of W start spanning the
    # top-m subspace of Σ̂). Quality at cfg5 scale (benchmarks/RESULTS.md
    # "init" note, recorded before the move to the H100): with
    # anneal=False, spectral is the BEST measured config on both
    # structure regimes — weak structure: TC 6961-6975, matching the
    # annealed-random TC (6989-7178) where no-anneal random COLLAPSES to
    # 4623; strong structure: TC 206231-206246, beating every other
    # config. WARNING (measured): combining init='spectral'
    # WITH anneal=True is harmful on strong structure — the early
    # high-eps stages scramble the aligned init and commit to a
    # catastrophically worse basin (TC 96-97k vs 205k) — pair spectral
    # with anneal=False (config validation warns). Default stays
    # 'random' (reference parity).
    init: str = "random"
    # Convergence tolerance multiplier for the NON-FINAL anneal stages
    # (the final eps=0 stage always converges at `tol` exactly, so the
    # returned optimum's convergence guarantee is unchanged). The eps>0
    # stages only need to park W in the right basin, not polish it to
    # max|dW| < tol — measured (2026-08-18, benchmarks/RESULTS.md
    # "stage-tol study", p=2048/m=64/n=4096, momentum f32):
    # stage_tol_factor=10 cuts total annealed iterations 1.9-2.4x on
    # weak structure and 1.2-1.3x on strong structure at final TC
    # identical to ~0.01; at cfg5 scale (p=100k, float32 tol=1e-5) TC
    # held at factor 10 and 30 (recorded before the move to the H100; the
    # wall saving there is not measured yet). CAVEAT (scale-dependent): do NOT
    # combine the factor with matmul_dtype='int8' at scale — under
    # int8 moment noise a loosened stage tol truncates annealing and
    # COLLAPSES TC (cfg5: -24% on BOTH regimes at factor=10; strong
    # collapses already at factor=3, while float32 holds TC at the
    # same composed tols). models.corex.resolve_config warns when
    # tol*factor*sqrt(p) >= 0.05 on the int8 path; small-scale int8
    # (p~2k, below the threshold) measured only mild drift. 1.0
    # (default) = reference-parity per-stage convergence. Inert when
    # annealing is off (schedule length 1 = final stage).
    stage_tol_factor: float = 1.0
    # Row-subsample fraction for the NON-FINAL anneal stages on the
    # SAMPLES moment strategy (the final eps=0 stage always runs on the
    # FULL data at `tol`, so the returned optimum's guarantee is
    # unchanged — the same contract shape as stage_tol_factor). The
    # high-eps stages exist to smooth the landscape and only need a
    # coarse W, and samples-path iteration cost is linear in n — early
    # stages on n x stage_subsample rows cost proportionally less.
    # Rows are taken by STRIDE (x[::k], k = round(1/fraction)): order-
    # robust (sorted inputs keep their spread) and deterministic (no
    # RNG state; seed-matched runs stay reproducible). Measured
    # (benchmarks/RESULTS.md "stage-subsample study"): a WEAK-STRUCTURE
    # knob — 1.6-2.7x fewer weighted iterations (n/4-n/16) at TC within
    # ±0.1% on weak structure; on STRONG structure the subsampled
    # prefix commits to worse basins (drift to −4%) — keep 1.0 there
    # (anneal=False dominates that regime anyway). Inert (1.0) by
    # default = reference parity; inert on the gram strategy (the p x p
    # operand carries no sample axis — models.corex.stage_subsample_active
    # warns and ignores), when annealing is off, and when the fraction
    # rounds to stride 1 (> 2/3 — no rows would actually be dropped, so
    # the two-program split would cost a sync/compile for nothing;
    # stage_subsample_active warns and runs the one-program fit).
    stage_subsample: float = 1.0
    lr_init: float = 0.05
    lr_growth: float = 1.1
    lr_cap: float = 2.0
    lr_halve: float = 0.5
    lr_min: float = 1e-14
    # fixed_point damping γ ∈ (0, 1]: W ← (1−γ)W + γŴ. Starts at
    # fp_gamma_init, grows by lr_growth to fp_gamma_cap (1.0 = undamped),
    # halves by lr_halve on a rejected step. Separate from lr_init/lr_cap
    # because γ is a convex-combination weight, not a step size.
    fp_gamma_init: float = 0.5
    fp_gamma_cap: float = 1.0
    rho_clip: float = 1.0 - 1e-6
    # Record the TC trajectory per (stage, iteration). Costs a
    # (n_stages x max_iter) carry; disable for large batched sweeps.
    record_history: bool = True

    # When set, the fit runs exactly this eps schedule instead of the
    # config-derived one. A scalar = a single stage (the stage-boundary
    # checkpointing driver, utils/checkpoint.py :: fit_with_checkpoints,
    # runs the schedule one compiled stage at a time with a resume point
    # between); a tuple = a multi-stage prefix program (the
    # stage-subsample driver runs anneal_schedule()[:-1] as ONE program
    # on the subsampled rows, then the final stage on the full data).
    # Drivers pre-bake the stage tols into `tol` (tol_schedule()'s
    # non-final/final rule applies WITHIN the override like any other
    # schedule, so bake stage_tol_factor=1.0 alongside).
    eps_override: Optional[float] = None

    def __post_init__(self):
        # Type validation FIRST: this config is jit-static (hashable) by
        # contract. An array-valued field (e.g. tol=np.array([1e-5]) via
        # sklearn set_params) would otherwise surface later as an
        # unhashable-static-argument error deep inside jit — or as an
        # ambiguous-truth ValueError from the comparisons below.
        import numbers
        for name in ("tol", "y_scale", "momentum_beta", "lr_init",
                     "lr_growth", "lr_cap", "lr_halve", "lr_min",
                     "fp_gamma_init", "fp_gamma_cap", "rho_clip",
                     "stage_tol_factor", "stage_subsample"):
            v = getattr(self, name)
            if not isinstance(v, numbers.Real):
                raise TypeError(
                    f"{name} must be a real scalar, got "
                    f"{type(v).__name__} ({v!r}) — CorexConfig is "
                    f"jit-static and every field must stay hashable")
        for name in ("n_hidden", "max_iter", "gram_max_p"):
            v = getattr(self, name)
            if not isinstance(v, numbers.Integral):
                raise TypeError(
                    f"{name} must be an integer, got {type(v).__name__} "
                    f"({v!r})")
        if self.eps_override is not None:
            ok_scalar = isinstance(self.eps_override, numbers.Real)
            ok_tuple = (isinstance(self.eps_override, tuple)
                        and len(self.eps_override) >= 1
                        and all(isinstance(e, numbers.Real)
                                for e in self.eps_override))
            if not (ok_scalar or ok_tuple):
                raise TypeError(
                    f"eps_override must be a real scalar, a non-empty "
                    f"tuple of real scalars, or None (lists/arrays are "
                    f"unhashable — the config is jit-static), got "
                    f"{type(self.eps_override).__name__}")
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if self.stage_tol_factor < 1.0:
            raise ValueError(
                f"stage_tol_factor must be >= 1.0 (it LOOSENS the "
                f"non-final anneal stages; 1.0 = reference-parity "
                f"per-stage convergence), got {self.stage_tol_factor}")
        if not (0.0 < self.stage_subsample <= 1.0):
            raise ValueError(
                f"stage_subsample must be in (0, 1] (the fraction of "
                f"sample rows the non-final anneal stages run on; 1.0 = "
                f"reference-parity full-data stages), got "
                f"{self.stage_subsample}")
        if self.n_hidden < 1:
            raise ValueError(f"n_hidden must be >= 1, got {self.n_hidden}")
        if self.moment_strategy not in ("auto", "samples", "gram"):
            raise ValueError(
                f"unknown moment_strategy: {self.moment_strategy!r} "
                f"(expected 'auto', 'samples' or 'gram')")
        if self.optimizer not in ("auto", "momentum", "gd", "fixed_point"):
            raise ValueError(
                f"unknown optimizer: {self.optimizer!r} (expected 'auto', "
                f"'momentum', 'gd' or 'fixed_point')")
        if self.optimizer == "fixed_point" and not self.discourage_overlap:
            raise ValueError(
                "optimizer='fixed_point' implements the non-overlap "
                "closed-form update; use 'momentum'/'gd' with "
                "discourage_overlap=False")
        if self.init not in ("random", "spectral"):
            raise ValueError(
                f"unknown init: {self.init!r} (expected 'random' or "
                f"'spectral')")
        if self.init == "spectral" and self.anneal and self.n_hidden > 1 \
                and self.discourage_overlap:
            import warnings
            warnings.warn(
                "init='spectral' with anneal=True: measured HARMFUL on "
                "strong-structure data at scale (the early high-eps "
                "stages scramble the aligned init; TC 96k vs 205k at "
                "cfg5) — pair spectral with anneal=False "
                "(benchmarks/RESULTS.md)")
        if self.matmul_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(
                f"unknown matmul_dtype: {self.matmul_dtype!r} (expected "
                f"'float32', 'bfloat16' or 'int8')")
        if self.matmul_dtype == "int8":
            if not self.discourage_overlap:
                raise ValueError(
                    "matmul_dtype='int8' supports the non-overlap solver "
                    "path only")
            if self.dtype != "float32":
                raise ValueError(
                    "matmul_dtype='int8' requires dtype='float32' (the "
                    "quantization noise floor is far above float64 "
                    "parity tolerances)")

    def anneal_schedule(self) -> Tuple[float, ...]:
        """Annealing eps schedule (SURVEY.md §2.4): geometric 0.6**k ending
        in exact 0; only for the multi-factor non-overlap solver."""
        if self.eps_override is not None:
            if isinstance(self.eps_override, tuple):
                return tuple(float(e) for e in self.eps_override)
            return (self.eps_override,)
        if self.anneal and self.n_hidden > 1 and self.discourage_overlap:
            return tuple(0.6 ** k for k in range(1, 7)) + (0.0,)
        return (0.0,)

    def tol_schedule(self) -> Tuple[float, ...]:
        """Per-stage convergence tolerances, aligned with
        `anneal_schedule()`: every stage but the last runs at
        tol x stage_tol_factor; the final stage always runs at `tol`
        exactly (so an eps_override single-stage program — the
        checkpoint driver's unit, which pre-bakes its stage's tol into
        `tol` — sees a length-1 schedule and uses `tol` unchanged)."""
        n_stages = len(self.anneal_schedule())
        return ((self.tol * self.stage_tol_factor,) * (n_stages - 1)
                + (self.tol,))

    def pick_strategy(self, n: int, p: int) -> str:
        if self.moment_strategy != "auto":
            return self.moment_strategy
        if p <= self.gram_max_p and 2 * n >= p:
            return "gram"
        return "samples"


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Preprocessing options (SURVEY.md §2.2): gaussianize mode + missing
    value sentinel. Parity anchor `[U] :: Corex.preprocess`."""

    gaussianize: str = "standard"
    missing_values: Optional[float] = None

    def __post_init__(self):
        if self.gaussianize not in ("none", "standard", "outliers",
                                    "empirical"):
            raise ValueError(
                f"unknown gaussianize mode: {self.gaussianize!r}")

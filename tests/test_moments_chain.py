"""The XLA moment chain and gradient against the float64 oracle, in
float32, at unaligned and aligned (p, m) shapes: `moments_from_cxy` +
`_ns_gradient_terms`, and both `ns_obj_grad_*` entry points, with and
without annealing."""

import jax.numpy as jnp
import numpy as np
import pytest

from linearcorex_tpu.oracle import oracle as O
from linearcorex_tpu.ops import moments as M
from tests.conftest import block_data

SHAPES = [(400, 100), (999, 7), (257, 130), (400, 128)]


def _setup(p, m, eps, n=600):
    x = block_data(n=n, p=p, m=max(1, min(m, 8)), seed=1)
    x = (x - x.mean(0)) / x.std(0)
    w = np.random.RandomState(2).normal(scale=1.0 / np.sqrt(p),
                                        size=(m, p))
    mom = O.calculate_moments(x, w, eps=eps)
    return x, w, mom


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


@pytest.mark.parametrize("eps", [0.0, 0.36])
@pytest.mark.parametrize("p,m", SHAPES)
def test_xla_chain_matches_oracle(p, m, eps):
    x, w, mom = _setup(p, m, eps)
    f32 = jnp.float32
    c_xy = jnp.asarray(mom["X_i Y_j"], f32)
    got = M.moments_from_cxy(jnp.asarray(w, f32), c_xy, 1.0, 1.0 - 1e-6)
    for key, field in (("Qij", "qij"), ("Si", "si"), ("Qi", "qi"),
                       ("X_i^2 | Y", "vi"), ("TCs", "tcs")):
        assert _rel_max(getattr(got, field), mom[key]) < 1e-4, key
    aa, hmat, coef, sqz = M._ns_gradient_terms(got)
    aa_o, hmat_o, coef_o, sqz_o = O._ns_gradient_terms(mom)
    for g, o in ((aa, aa_o), (hmat, hmat_o), (coef, coef_o),
                 (sqz, sqz_o)):
        assert _rel_max(g, o) < 1e-4

    # the full evaluations, both operand strategies
    grad_o = O.ns_gradient(mom, x, w, eps)
    xj, wj = jnp.asarray(x, f32), jnp.asarray(w, f32)
    gram = jnp.asarray(x.T @ x / x.shape[0], f32)
    for fn, data in ((M.ns_obj_grad_samples, xj),
                     (M.ns_obj_grad_gram, gram)):
        f, g, tc = fn(wj, data, eps, 1.0, 1.0 - 1e-6)
        assert abs(float(f) - mom["objective"]) \
            <= 1e-4 * abs(mom["objective"])
        assert abs(float(tc) - mom["TC"]) <= 1e-4 * max(abs(mom["TC"]), 1.0)
        assert _rel_max(g, grad_o) < 1e-3

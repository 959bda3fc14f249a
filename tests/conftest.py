"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU (`JAX_PLATFORMS=cpu`, the default set here) with
8 virtual devices, so the sharded code paths run on a CPU mesh (SURVEY.md
§4.2 item 3). Tests that need an NVIDIA GPU take the `gpu` fixture and
skip without one; run them on the card with
`JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/ -n 0`, or through
`python chip_smoke.py`, whose gpu_checks phase runs the same checks.
"""

import os

os.environ.setdefault("JAX_ENABLE_X64", "1")
# A dev shell exporting the library's cache env vars must not change
# suite behavior:
# ensure_compile_cache() would otherwise enable the persistent cache on
# CPU for every fit — XLA:CPU cache writes have segfaulted here, and the
# cache-binding order guard in tests/test_compile_cache.py would read
# the legitimate global enablement as a fixture leak.
os.environ.pop("LINEARCOREX_TPU_CACHE_DIR", None)
os.environ.pop("LINEARCOREX_TPU_NO_COMPILE_CACHE", None)

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_num_cpu_devices", 8)
# Allow float64: oracle-parity tests run the identical algorithm in f64
# (SURVEY.md §4.2 item 1). Library code passes dtypes explicitly, so float32
# paths stay float32.
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


def block_data(n=1000, p=64, m=8, seed=0, strength=0.9):
    """Synthetic block-diagonal Gaussian data: p variables in m equal blocks,
    each driven by one latent factor with loading `strength` (the north-star
    synthetic recovery setup, BASELINE.json configs 1-2)."""
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, m))
    k = p // m
    x = np.empty((n, p))
    for j in range(m):
        for i in range(k):
            x[:, j * k + i] = strength * z[:, j] + np.sqrt(
                1.0 - strength ** 2) * rng.normal(size=n)
    if p > m * k:
        # remainder columns (when m doesn't divide p) are pure noise —
        # np.empty garbage here can contain NaN/inf
        x[:, m * k:] = rng.normal(size=(n, p - m * k))
    return x


@pytest.fixture
def gpu():
    """The first GPU JAX reports; skips the test with a reason when there
    is none. Decided here, at run time, never at import or collection."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is "
                    f"{d.platform!r} (run with JAX_PLATFORMS=cuda,cpu "
                    f"-m gpu on the card)")
    return d


@pytest.fixture
def small_block_data():
    return block_data(n=500, p=32, m=4, seed=3)


@pytest.fixture
def med_block_data():
    return block_data(n=1000, p=64, m=8, seed=0)


def module_text_probe(orig, recorded):
    """Probe standing in for a jitted program object: records the FULL
    lowered module text both when a warmup lowers it and when the real
    driver dispatches it (lowering again with the real call's concrete
    args, under the real call's ambient context). Module-text identity
    is the strongest available proxy for persistent-cache-key identity —
    it catches context drift (e.g. lowering outside the driver's
    jax.set_mesh(mesh) scope, which changes the module and the key even
    with identical arg shardings) that arg-spec comparison cannot."""

    class Probe:
        def __call__(self, *args):
            recorded.append(orig.lower(*args).as_text())
            return orig(*args)

        def lower(self, *args):
            low = orig.lower(*args)
            recorded.append(low.as_text())
            return low

    return Probe()


def run_python_subprocess(code: str, env_extra=None, timeout=600):
    """Run `code` in a FRESH python process (CPU jax preamble included)
    and return (returncode, combined_output). Process isolation for
    tests that must enable jax's persistent compile cache: the cache
    object binds at most once per process and XLA:CPU cache writes
    (executable.serialize()) have segfaulted when accumulated in the
    suite process (round-4 segfault class) — a
    subprocess confines both the binding and any crash to the test
    that opted in, so the suite's health no longer depends on worker
    topology or test order."""
    import subprocess
    import sys

    preamble = (
        "import os\n"
        "os.environ.setdefault('JAX_ENABLE_X64', '1')\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n")
    env = dict(os.environ)
    env.pop("LINEARCOREX_TPU_CACHE_DIR", None)
    env.pop("LINEARCOREX_TPU_NO_COMPILE_CACHE", None)
    if env_extra:
        env.update(env_extra)
    proc = subprocess.run(
        [sys.executable, "-c", preamble + code],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return proc.returncode, proc.stdout + proc.stderr

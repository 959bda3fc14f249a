"""Persistent compile cache + AOT warmup (utils/compile_cache.py).

The library entry points (not
just bench.py) wire JAX's persistent compilation cache, and `warmup_fit`
ahead-of-time compiles the fit program from declared shapes so the first
real fit hits the cache. Measured first-call wall times (cold vs cache vs
AOT) live in benchmarks/RESULTS.md.
"""

import jax
import numpy as np
import pytest

import linearcorex_tpu as lc
from linearcorex_tpu.utils.compile_cache import (ensure_compile_cache,
                                                 warmup_fit)
from tests.conftest import block_data


@pytest.fixture
def clean_cache_config(monkeypatch, tmp_path):
    """Reset the process-global cache state around a test. Restoring
    jax.config alone is NOT enough: jax's compilation_cache module binds
    a global `_cache` object at most ONCE per process, and `_get_cache`
    ignores the config after that — a leaked binding makes EVERY later
    slow compile in the suite write cache entries to a pytest tmp dir
    with the config off (found when an XLA:CPU executable.serialize()
    inside such a stray write SEGFAULTED the suite at 90%, in a test
    file that never touches the cache). reset_cache() on both sides
    confines persistent-cache writes to the tests that opted in."""
    from jax._src import compilation_cache as jcc

    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("LINEARCOREX_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("LINEARCOREX_TPU_CACHE_DIR", str(tmp_path / "jc"))
    jax.config.update("jax_compilation_cache_dir", None)
    jcc.reset_cache()
    yield str(tmp_path / "jc")
    jax.config.update("jax_compilation_cache_dir", prev)
    jcc.reset_cache()


def test_ensure_sets_cache_dir_and_is_idempotent(clean_cache_config):
    d = ensure_compile_cache()
    assert d == clean_cache_config
    assert jax.config.jax_compilation_cache_dir == d
    assert ensure_compile_cache() == d  # second call: no-op, same dir


def test_ensure_respects_existing_config(clean_cache_config, tmp_path):
    explicit = str(tmp_path / "user_dir")
    jax.config.update("jax_compilation_cache_dir", explicit)
    assert ensure_compile_cache() == explicit  # user's choice untouched
    assert jax.config.jax_compilation_cache_dir == explicit


def test_ensure_opt_out(clean_cache_config, monkeypatch):
    monkeypatch.setenv("LINEARCOREX_TPU_NO_COMPILE_CACHE", "1")
    assert ensure_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


def test_ensure_default_off_on_cpu(clean_cache_config, monkeypatch):
    """Without an explicit dir the cache stays OFF on the CPU backend:
    XLA:CPU AOT artifacts are machine-feature-flag sensitive across
    processes (SIGILL-risk on reload) and local CPU compiles are fast —
    the default-on behavior targets accelerator compiles."""
    monkeypatch.delenv("LINEARCOREX_TPU_CACHE_DIR", raising=False)
    assert jax.default_backend() == "cpu"
    assert ensure_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir is None


def test_fit_enables_cache(tmp_path):
    """A fit with LINEARCOREX_TPU_CACHE_DIR set enables the persistent
    cache and WRITES entries — run in a SUBPROCESS (round 5):
    jax binds its cache object at most once per process, and
    XLA:CPU cache writes have segfaulted when accumulated in the suite
    process. Isolation makes the suite's health independent of worker
    topology and test order; the in-suite guard below
    (test_cache_binding_is_clear_without_fixture) now asserts the suite
    process NEVER binds the cache."""
    from tests.conftest import run_python_subprocess

    cache_dir = str(tmp_path / "jc")
    # NOTE: tests/conftest.py pops LINEARCOREX_TPU_CACHE_DIR from
    # os.environ at import (so a dev shell's export can't flip suite
    # behavior) — import it FIRST, then set the env var in-process, so
    # the fit's ensure_compile_cache() sees it like a user process would
    rc, out = run_python_subprocess(
        "import os, numpy as np\n"
        "from tests.conftest import block_data\n"
        f"os.environ['LINEARCOREX_TPU_CACHE_DIR'] = {cache_dir!r}\n"
        "import linearcorex_tpu as lc\n"
        "x = block_data(n=200, p=16, m=2, seed=0)\n"
        "lc.Corex(n_hidden=2, max_iter=5, record_history=False).fit(x)\n"
        f"assert jax.config.jax_compilation_cache_dir == {cache_dir!r}\n"
        "from jax._src import compilation_cache as jcc\n"
        "assert jcc._cache is not None  # bound by the fit's compiles\n")
    assert rc == 0, out
    import os
    assert os.path.isdir(cache_dir) and os.listdir(cache_dir), (
        "the cache-enabled fit wrote no persistent-cache entries")


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16", "int8"])
def test_warmup_then_fit(matmul_dtype):
    """warmup_fit compiles from declared shapes only (no data) for every
    operand dtype, and the subsequent real fit runs unchanged."""
    n, p = 300, 24
    model = lc.Corex(n_hidden=3, max_iter=10, record_history=False,
                     matmul_dtype=matmul_dtype, tol=1e-4,
                     optimizer="momentum")
    assert model.warmup(n, p) is model
    x = block_data(n=n, p=p, m=3, seed=1)
    model.fit(x)
    assert np.isfinite(model.tc)


def test_warmup_matches_fit_program_shapes():
    """The warmed lowering must be the very program fit dispatches: fitting
    after warmup reuses the jit entry (no error, correct strategy at both
    gram and samples shapes)."""
    for n, p in ((300, 24), (30, 80)):   # gram strategy; samples strategy
        model = lc.Corex(n_hidden=3, max_iter=5, record_history=False)
        model.warmup(n, p)
        model.fit(block_data(n=n, p=p, m=3, seed=0))
        assert np.isfinite(model.tc)


def test_warmup_sharded():
    from linearcorex_tpu.parallel.sharding import (DATA_AXIS, FACTOR_AXIS,
                                                   ShardingPlan, make_mesh)
    mesh = make_mesh(((DATA_AXIS, 4), (FACTOR_AXIS, 2)))
    plan = ShardingPlan(shard_samples=True, shard_factors=True)
    n, p = 64, 32
    model = lc.Corex(n_hidden=4, max_iter=3, record_history=False)
    model.warmup(n, p, mesh=mesh, sharding_plan=plan)
    x = block_data(n=n, p=p, m=4, seed=2)
    model.fit(x, mesh=mesh, sharding_plan=plan)
    assert np.isfinite(model.tc)


@pytest.mark.parametrize("overlap", [False, True])
def test_warmup_serving_then_serve(overlap):
    """warmup_serving compiles transform/predict/score/matmat/blocks from
    declared shapes for both solver paths; real serving calls then run
    unchanged and correctly."""
    from linearcorex_tpu.utils.compile_cache import warmup_serving

    n, p, m = 300, 24, 3
    model = lc.Corex(n_hidden=m, max_iter=50, record_history=False,
                     discourage_overlap=not overlap, seed=0)
    warmup_serving(model, batch_rows=64, n_variables=p, matmat_k=5,
                   cov_block=10)
    x = block_data(n=n, p=p, m=m, seed=1)
    model.fit(x)
    y = model.transform(x[:64])
    assert y.shape == (64, m)
    assert model.predict(y).shape == (64, p)
    assert np.isfinite(float(model.score(x[:64])))
    assert model.covariance_matmat(np.zeros((p, 5))).shape == (p, 5)
    out = np.vstack([np.asarray(r) for _, r in
                     model.covariance_blocks(10)])
    assert np.abs(out - np.asarray(model.get_covariance())).max() < 1e-5


def test_warmup_serving_requires_width():
    from linearcorex_tpu.utils.compile_cache import warmup_serving
    with pytest.raises(ValueError, match="n_variables"):
        warmup_serving(lc.Corex(n_hidden=2), batch_rows=8)


def test_warmup_sharded_is_module_identical_to_real_fit(monkeypatch):
    """warmup_fit(mesh=...) must lower EXACTLY the modules fit(mesh=...)
    dispatches — for the fit program (compiled INSIDE jax.set_mesh(mesh)
    by fit_sharded; a module lowered outside that scope differs, and so
    does its persistent-cache key) and for the spectral-init program
    (whose omega arrives UNCOMMITTED from _resolve_w0 — declaring it
    with a replicated sharding annotates the module and misses the
    cache). Module-text identity is the proxy for cache-key identity;
    the probes lower again with the real call's concrete args under its
    ambient context."""
    import linearcorex_tpu.models.corex as C
    import linearcorex_tpu.parallel.sharding as S
    from linearcorex_tpu.parallel.sharding import make_mesh

    from tests.conftest import module_text_probe

    fit_texts, spec_texts = [], []
    monkeypatch.setattr(S, "_fit_program_sharded",
                        module_text_probe(S._fit_program_sharded,
                                          fit_texts))
    monkeypatch.setattr(C, "_spectral_init_program",
                        module_text_probe(C._spectral_init_program,
                                          spec_texts))
    mesh = make_mesh()
    x = block_data(n=480, p=32, m=4, seed=0)
    model = lc.Corex(n_hidden=4, seed=0, init="spectral", anneal=False,
                     max_iter=50, record_history=False)
    model.warmup(480, 32, mesh=mesh)
    model.fit(x, mesh=mesh)
    assert len(fit_texts) == 2 and fit_texts[0] == fit_texts[1], \
        "warmup_fit lowered a different sharded fit module than fit"
    assert len(spec_texts) == 2 and spec_texts[0] == spec_texts[1], \
        "warmup_fit lowered a different spectral-init module than fit"


def test_cache_roundtrip_in_subprocess(tmp_path):
    """Regression for the round-4 suite segfault, subprocess-isolated
    (round 5): a process that enables the cache binds jcc._cache and
    writes entries; a SECOND fresh process pointed at the same dir READS
    them (cache hits, no new writes needed for the same program) — the
    persistent-cache round trip, with neither process being the suite."""
    from tests.conftest import run_python_subprocess

    cache_dir = str(tmp_path / "jc")
    # conftest pops LINEARCOREX_TPU_CACHE_DIR at import — pass the dir
    # as the explicit argument (the library API spelling), which the
    # env-pop cannot affect
    body = (
        "import numpy as np\n"
        "import linearcorex_tpu as lc\n"
        "from linearcorex_tpu.utils.compile_cache import "
        "ensure_compile_cache\n"
        "from tests.conftest import block_data\n"
        f"d = ensure_compile_cache({cache_dir!r})\n"
        "assert d is not None\n"
        # zero the 0.5 s min-compile-time write threshold for the test:
        # a program whose compile time straddles it on a loaded box could
        # be written by one process and not the other, failing the
        # listing-equality below with no real regression (round-5 review)
        "import jax\n"
        "jax.config.update("
        "'jax_persistent_cache_min_compile_time_secs', 0.0)\n"
        "lc.Corex(n_hidden=2, max_iter=3, record_history=False,"
        " seed=0).fit(block_data(n=60, p=8, m=2, seed=0))\n"
        "from jax._src import compilation_cache as jcc\n"
        "assert jcc._cache is not None\n")
    rc, out = run_python_subprocess(body)
    assert rc == 0, out
    import os
    entries = set(os.listdir(cache_dir))
    assert entries, "first process wrote no cache entries"
    rc, out = run_python_subprocess(body)
    assert rc == 0, out
    assert set(os.listdir(cache_dir)) == entries, (
        "second process missed the cache for the identical program")


def test_cache_binding_is_clear_without_fixture():
    """Runs WITHOUT clean_cache_config: if a prior test leaked the
    binding, this fails — the suite-order guard for the segfault class.
    (Test order puts this after every fixture user in this file.)"""
    from jax._src import compilation_cache as jcc

    assert jcc._cache is None, (
        "a test leaked jax's compilation-cache binding; every later "
        "slow compile would write cache entries with the config off")


def test_warmup_serving_mesh_is_module_identical_to_real_calls(monkeypatch):
    """warmup_serving(mesh=...) must lower EXACTLY the modules
    transform/predict/score(mesh=...) dispatch: operands declared with
    the shardings `Corex._serving_mesh` commits (state axis roles,
    x/y_spec inputs), lowered inside jax.set_mesh — the same module-text
    identity rule as the fit warmup (a drifted sharding or scope changes
    the persistent-cache key and silently defeats AOT warmup)."""
    import linearcorex_tpu.models.corex as C
    from linearcorex_tpu.parallel.sharding import ShardingPlan, make_mesh
    from linearcorex_tpu.utils.compile_cache import warmup_serving

    from tests.conftest import module_text_probe

    t_texts, p_texts, s_texts, m_texts = [], [], [], []
    monkeypatch.setattr(C, "_transform_program",
                        module_text_probe(C._transform_program, t_texts))
    monkeypatch.setattr(C, "_predict_ns_program",
                        module_text_probe(C._predict_ns_program, p_texts))
    monkeypatch.setattr(C, "_score_ns_program",
                        module_text_probe(C._score_ns_program, s_texts))
    monkeypatch.setattr(C, "_matmat_ns_program",
                        module_text_probe(C._matmat_ns_program, m_texts))
    mesh = make_mesh((("data", 4), ("var", 2)))
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    x = block_data(n=480, p=32, m=4, seed=0)
    model = lc.Corex(n_hidden=4, seed=0, max_iter=50,
                     record_history=False).fit(x)
    warmup_serving(model, batch_rows=480, mesh=mesh, sharding_plan=plan,
                   matmat_k=3)
    y = model.transform(x, mesh=mesh, sharding_plan=plan)
    model.predict(np.asarray(y), mesh=mesh, sharding_plan=plan)
    model.score(x, mesh=mesh, sharding_plan=plan)
    model.covariance_matmat(np.ones((32, 3), np.float32), mesh=mesh,
                            sharding_plan=plan)
    for name, texts in (("transform", t_texts), ("predict", p_texts),
                        ("score", s_texts), ("matmat", m_texts)):
        assert len(texts) == 2 and texts[0] == texts[1], (
            f"warmup_serving(mesh=...) lowered a different {name} module "
            f"than the real sharded call")


def test_warmup_serving_mesh_overlap_branch_identity(monkeypatch):
    """Same module-text identity pin for the OVERLAP serving programs —
    a spec drift in the warmup's cy/c_xy declarations would silently
    defeat AOT warmup for discourage_overlap=False deployments."""
    import linearcorex_tpu.models.corex as C
    from linearcorex_tpu.parallel.sharding import ShardingPlan, make_mesh
    from linearcorex_tpu.utils.compile_cache import warmup_serving

    from tests.conftest import module_text_probe

    p_texts, s_texts, m_texts = [], [], []
    monkeypatch.setattr(C, "_predict_overlap_program",
                        module_text_probe(C._predict_overlap_program,
                                          p_texts))
    monkeypatch.setattr(C, "_score_overlap_program",
                        module_text_probe(C._score_overlap_program,
                                          s_texts))
    monkeypatch.setattr(C, "_matmat_overlap_program",
                        module_text_probe(C._matmat_overlap_program,
                                          m_texts))
    mesh = make_mesh((("data", 4), ("var", 2)))
    plan = ShardingPlan(shard_samples=True, shard_vars=True)
    x = block_data(n=480, p=32, m=4, seed=0)
    model = lc.Corex(n_hidden=4, seed=0, max_iter=50,
                     discourage_overlap=False,
                     record_history=False).fit(x)
    warmup_serving(model, batch_rows=480, mesh=mesh, sharding_plan=plan,
                   matmat_k=3)
    y = model.transform(x, mesh=mesh, sharding_plan=plan)
    model.predict(np.asarray(y), mesh=mesh, sharding_plan=plan)
    model.score(x, mesh=mesh, sharding_plan=plan)
    model.covariance_matmat(np.ones((32, 3), np.float32), mesh=mesh,
                            sharding_plan=plan)
    for name, texts in (("predict", p_texts), ("score", s_texts),
                        ("matmat", m_texts)):
        assert len(texts) == 2 and texts[0] == texts[1], (
            f"warmup_serving(mesh=...) lowered a different overlap "
            f"{name} module than the real sharded call")


# (round 5: warmup_serving(cov_block=..., mesh=...) is now SUPPORTED —
# it warms the sharded covariance_blocks row program; module-identity
# with the real sharded export is pinned in tests/test_sharding.py ::
# test_warmup_serving_covers_sharded_cov_blocks.)


def test_jax_compilation_cache_dir_env_wins(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the one cache location:
    ensure_compile_cache() returns it and sets no other, even with the
    library's own location variable set too. Subprocess-isolated like
    the other cache-enabling tests."""
    from tests.conftest import run_python_subprocess

    jax_dir = str(tmp_path / "jax_env")
    lib_dir = str(tmp_path / "lib_env")
    rc, out = run_python_subprocess(
        "import os\n"
        f"os.environ['LINEARCOREX_TPU_CACHE_DIR'] = {lib_dir!r}\n"
        "from linearcorex_tpu.utils.compile_cache import "
        "ensure_compile_cache\n"
        f"assert ensure_compile_cache() == {jax_dir!r}\n"
        f"assert jax.config.jax_compilation_cache_dir == {jax_dir!r}\n"
        f"assert not os.path.exists({lib_dir!r})\n",
        env_extra={"JAX_COMPILATION_CACHE_DIR": jax_dir})
    assert rc == 0, out


def test_ensure_explicit_unusable_dir_raises(clean_cache_config, tmp_path):
    """A cache location the caller asked for by name that cannot be
    created raises instead of silently running uncached."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(OSError):
        ensure_compile_cache(str(blocker / "cache"))
    assert jax.config.jax_compilation_cache_dir is None

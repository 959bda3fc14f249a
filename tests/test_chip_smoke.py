"""chip_smoke.py: its phases at tiny sizes on the CPU, its refusal to run
without a GPU, and (marked `gpu`) its correctness checks on the card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as S

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run_script(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_device_phase_raises_without_gpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        S.device_phase()


def test_script_exits_nonzero_without_gpu():
    proc = _run_script(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


def test_script_alone_fails_and_prints_nothing(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo:
    the package import fails before any output."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_northstar_phase_tiny():
    rec, x, int8 = S.northstar_phase(n=400, p=64, m=8, n_blocks=8,
                                     cov_block=16)
    assert x.shape == (400, 64)
    assert rec["f32"]["strategy"] == "gram"
    assert rec["f32"]["matmul_precision"] == "default"
    assert rec["int8_throughput"]["matmul_dtype"] == "int8"
    assert rec["f32"]["iterations"] > 0
    assert rec["f32"]["wall_warm_s"] is not None
    assert rec["serving"]["cov_blocks_max_abs_diff"] < 1e-5
    assert int8.n_hidden == 8
    json.dumps(rec, default=float)  # what emit() prints


def test_cfg5_phase_tiny():
    rec = S.cfg5_phase(n=200, p=96, m=6, n_blocks=6)
    assert rec["f32"]["strategy"] == rec["int8"]["strategy"] == "samples"
    assert rec["f32"]["optimizer"] == "momentum"
    assert rec["int8"]["tol"] == 1e-4
    assert np.isfinite(rec["f32"]["tc"]) and np.isfinite(rec["int8"]["tc"])


@pytest.mark.parametrize("strategy", ["gram", "samples"])
def test_check_oracle_parity_tiny(strategy):
    rec = S.check_oracle_parity(n=300, p=48, m=6, n_blocks=6,
                                strategy=strategy)
    for prec, errs in rec["errors"].items():
        assert all(v <= S.TOL[prec][k] for k, v in errs.items())


def test_check_f64_parity_tiny():
    rec = S.check_f64_parity(n=300, p=80, m=6, n_blocks=8)
    assert set(rec["errors"]) == {"highest", "default"}


@pytest.mark.parametrize("strategy", ["gram", "samples"])
def test_check_int8_parity_tiny(strategy):
    rec = S.check_int8_parity(n=400, p=64, m=6, n_blocks=8,
                              strategy=strategy)
    errs = rec["errors"]["int8"]
    assert all(v <= S.TOL["int8"][k] for k, v in errs.items())
    assert errs["grad"] > 0  # the quantized path really ran


def test_compare_int8_fit_records_both_dtypes():
    import linearcorex_tpu as lc

    x = S.make_block_data(600, 64, 4, seed=3)
    int8 = lc.Corex(n_hidden=4, seed=0, preset="throughput").fit(x)
    rec = S.compare_int8_fit(x, int8)
    assert rec["matmul_dtypes"] == ["int8", "float32"]
    assert np.isfinite(rec["tc_f32"]) and 0.0 <= rec["labels_equal"] <= 1.0


def test_correct_phase_tiny():
    import linearcorex_tpu as lc

    x = S.make_block_data(600, 64, 4, seed=3)
    int8 = lc.Corex(n_hidden=4, seed=0, preset="throughput").fit(x)
    out = S.correct_phase(x, int8, cfg5_shape=(300, 96, 6, 6))
    assert set(out) == {"northstar_oracle", "northstar_int8",
                        "northstar_int8_fit_vs_f32", "cfg5_f64",
                        "cfg5_int8"}


def test_compare_raises_outside_tolerance():
    ref = (1.0, np.ones((2, 3)), 2.0)
    ok = {"highest": (1.0 + 1e-6, np.ones((2, 3)), 2.0)}
    assert S._compare(ok, ref, "x")["highest"]["obj"] < 1e-5
    bad = {"highest": (1.0, np.ones((2, 3)) * 1.01, 2.0)}
    with pytest.raises(S.SmokeFailure, match="grad"):
        S._compare(bad, ref, "x")


def test_label_agreement_renaming_and_merging():
    a = np.array([0, 0, 1, 1, 2, 2])
    assert S.label_agreement(a, np.array([5, 5, 3, 3, 4, 4])) == 1.0
    # merging two clusters into one is not agreement
    assert S.label_agreement(a, np.array([0, 0, 0, 0, 2, 2])) < 1.0


def test_four_phase_on_cpu_mesh():
    """The --four path on 4 virtual CPU devices at a tiny size: GSPMD and
    shard_map fits match the one-device fit, and the combined sweep
    runs."""
    out = S.four_phase(jax.devices()[:4], n=160, p=48, m=4, iters=8,
                       sweep_n=80, sweep_lanes=4, sweep_iters=3,
                       n_blocks=4)
    assert out["gspmd"]["tc_rel"] <= S.FOUR_TC_REL
    assert out["shard_map"]["tc_rel"] <= S.FOUR_TC_REL
    assert out["sweep"]["lanes"] == 4
    assert out["sweep"]["best_lane"] in range(4)


def test_fit_memory_matches_fit_program():
    import linearcorex_tpu as lc

    mem = S.fit_memory(lc.Corex(n_hidden=4, seed=0), 100, 32)
    assert mem is None or mem["argument_size_in_bytes"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(S.GPU_CHECKS))
def test_gpu_check(gpu, name):
    """The chip_smoke correctness checks at their test sizes, on the card
    (the gpu_checks phase runs the same list)."""
    jax.config.update("jax_enable_x64", True)
    fn, kw = S.GPU_CHECKS[name]
    fn(**kw)

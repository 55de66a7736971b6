"""chip_smoke.py, the compile-cache helper and the bench harness refuse
to report a result without a GPU, and their checks mean what they say."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_fails_on_cpu():
    out = _run([os.path.join(REPO, "chip_smoke.py")], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    import jax
    from mpp_tpu.config import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    import jax
    from mpp_tpu.config import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        cache = enable_compile_cache()
        assert cache == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == cache
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.fixture
def smoke():
    import jax
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke.Smoke(jax)


def test_smoke_close_band(smoke):
    x0 = np.zeros(4)
    ref = np.array([0.0, 1.0, 2.0, 100.0])
    smoke.close("inside", ref + 1.9, ref, x0, 2e-2, "f32")
    assert smoke.failed == []
    smoke.close("outside", ref + 2.1, ref, x0, 2e-2, "f32")
    smoke.close("nan", ref * np.nan, ref, x0, 2e-2, "f32")
    assert smoke.failed == ["outside", "nan"]


def test_smoke_close_f32_slack(smoke):
    """An f32 result may sit as far from f64 as the CPU's own f32 run
    (plus the band), and must sit that close to the CPU f32 run."""
    x0 = np.zeros(3)
    ref = np.array([0.0, 10.0, 100.0])
    cpu32 = ref + 5.0
    smoke.close("like cpu f32", ref + 6.0, ref, x0, 2e-2, "f32",
                f32_ref=cpu32)
    assert smoke.failed == []
    smoke.close("beyond", ref - 6.0, ref, x0, 2e-2, "f32", f32_ref=cpu32)
    assert smoke.failed == ["beyond (vs cpu f32)"]


def test_bench_peaks_reject_unknown_device():
    import jax
    sys.path.insert(0, REPO)
    import bench
    assert "NVIDIA H100 80GB HBM3" in bench.PEAKS
    with pytest.raises(KeyError, match="no published peaks"):
        bench.hbm_bandwidth_gbs(jax)


def test_bench_section_fails_loudly_without_gpu():
    sys.path.insert(0, REPO)
    import bench
    with pytest.raises(RuntimeError, match="needs a GPU"):
        bench._run_section("thomas", 120)

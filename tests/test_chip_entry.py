"""The compile-cache helper and the GPU entry points' refusal to run
anywhere else (chip_smoke.py, bench.py)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from dart_planner_tpu.common import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    keys = (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
    )
    before = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


def test_cache_helper_honours_env_and_sets_nothing(
    monkeypatch, tmp_path, restore_cache_config
):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_helper_default_is_fixed_checkout_path(
    monkeypatch, restore_cache_config
):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.setup_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run(script_dir, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(script_dir, args[0]), *args[1:]],
        capture_output=True, text=True, timeout=240, env=env, cwd=script_dir,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_chip_smoke_without_gpu_exits_before_compiling(args):
    out = _run(REPO, "chip_smoke.py", *args)
    assert out.returncode == 2, out.stdout + out.stderr
    assert "no GPU" in out.stdout
    assert '"ok": true' not in out.stdout
    assert "setup" not in out.stdout  # nothing compiled


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_without_gpu_exits_2():
    out = _run(REPO, "bench.py")
    assert out.returncode == 2, out.stdout + out.stderr
    assert "needs a GPU" in out.stderr
    assert out.stdout == ""

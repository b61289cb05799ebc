"""Where JAX's persistent compilation cache lands (runtime/compile_cache.py)."""

import os

import jax
import pytest

from lbm_tpu.runtime import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_env_var(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing: JAX
    reads the variable itself."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_defaults_to_fixed_dir_in_checkout(monkeypatch, restore_cache_dir):
    """Without the variable the cache is ``.jax_cache/`` at the checkout's
    root: a fixed path, never built from a temporary name, pid or time."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable_compile_cache() == path  # stable across calls


def test_cli_and_api_enable_the_cache(monkeypatch, tmp_path, restore_cache_dir):
    """The entry points call the helper before their first compile."""
    from lbm_tpu.api import Simulation
    from lbm_tpu.cli import main
    from lbm_tpu.utils.geometry import box, write_obstacle_file, write_params_file

    calls = []
    real = compile_cache.enable_compile_cache

    def spy():
        calls.append(1)
        return real()

    monkeypatch.setattr(compile_cache, "enable_compile_cache", spy)
    monkeypatch.setattr("lbm_tpu.api.enable_compile_cache", spy)
    params, obstacles = tmp_path / "p.params", tmp_path / "o.dat"
    write_params_file(params, 8, 8, 2, 10, 0.1, 0.005, 1.85)
    write_obstacle_file(obstacles, box(8, 8))
    assert main([str(params), str(obstacles), "--out-dir", str(tmp_path / "o")]) == 0
    assert len(calls) == 1
    from lbm_tpu.io import read_params

    Simulation(read_params(params), box(8, 8))
    assert len(calls) == 2

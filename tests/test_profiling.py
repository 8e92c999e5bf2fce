"""Compile-cache directory rules (utils/profiling.enable_compile_cache)."""
import os

import jax
import pytest

from autobzcore_tpu.utils import profiling


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_follows_env(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert profiling.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_cache_dir_repeat_call_is_stable(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    first = profiling.enable_compile_cache()
    assert profiling.enable_compile_cache() == first == profiling.compile_cache_dir()

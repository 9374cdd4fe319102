"""utils/compile_cache.py: the env var wins; otherwise the in-checkout
directory (gitignored) is used. Nothing else is set."""

import os

import jax
import pytest

from offline_raytracer_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # untouched


def test_default_is_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert d == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == d
    with open(os.path.join(root, ".gitignore")) as f:
        assert "/.jax_cache/" in f.read().split()

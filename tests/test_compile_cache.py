"""The persistent compile cache helper (raytracingrust_tpu.compile_cache)."""

import os

import jax

from raytracingrust_tpu.compile_cache import CHECKOUT, enable_compile_cache


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = enable_compile_cache()
    assert path == os.path.join(CHECKOUT, ".cache", "jax")
    assert os.path.isdir(path)
    assert calls["jax_compilation_cache_dir"] == path
    assert os.path.exists(os.path.join(CHECKOUT, "raytracingrust_tpu"))


def test_cache_env_var_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and the helper sets
    no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls

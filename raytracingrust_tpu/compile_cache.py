"""The persistent XLA compile cache shared by the CLI, bench.py and
chip_smoke.py."""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache -> the directory it uses.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other directory is set here.  Otherwise the cache lives in
    ``<checkout>/.cache/jax`` (git-ignored), a fixed path, so a rerun from
    the same checkout finds its compiled programs again.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".cache", "jax")
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path

"""Persistent XLA compilation cache.

Entry points call :func:`enable_persistent_cache` before the first jit so that
later processes load compiled executables from disk instead of compiling the
map-build and registration graphs again.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing. Otherwise the cache lives in ``.jax_cache/`` at the root
of the checkout: a fixed path, because the path is part of the cache key.
"""
from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache() -> None:
    """Idempotent; safe to call from every entry point before the first jit."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))

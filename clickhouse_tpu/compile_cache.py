"""Persistent compilation cache for the XLA programs the engine compiles.

Each query body compiles into one XLA program, and the first run of a
query shape pays that compile.  Keeping compiled programs on disk lets the
next process with the same code and shapes skip it.
"""
from __future__ import annotations

import os

import jax

__all__ = ["CACHE_DIR", "enable_compile_cache"]

# One fixed path inside the checkout (listed in .gitignore): a cache
# directory that moves between runs never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives at `CACHE_DIR`.
    Every program is cached, however small or quick to compile.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path

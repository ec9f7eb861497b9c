"""Persistent XLA compilation cache (compile once per spec bucket, reuse
across processes).  The wavefront while-loop is a large program and every
(B, W, S_CAP, LT, LQ, mode) bucket is its own compile; the cache makes
every later CLI/bench invocation on the same machine start hot.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, so no directory is set in code), otherwise
``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os

_DONE = False


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        os.path.join(repo_root(), ".jax_cache")


def enable_compile_cache() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

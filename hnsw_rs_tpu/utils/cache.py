"""Persistent XLA compile cache: one location for every entry point.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set. Otherwise the cache
lives at ``<repo>/.jax_cache`` (listed in ``.gitignore``): a fixed path,
because the path is part of the cache key and a moving directory never
hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """The directory the compile cache uses (env var, else repo-local)."""
    return os.environ.get(ENV_VAR) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    and cache every program that took at least half a second to compile.
    Call before the first compile. Returns the directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path

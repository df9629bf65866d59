"""The persistent XLA compile cache's one location.

``JAX_COMPILATION_CACHE_DIR``, where it is set, names the directory and
nothing overrides it. Otherwise the cache lives at the fixed ``.jax_cache/``
of the checkout (git-ignored), so one checkout's runs find each other's
programs: the path is part of the cache key, so it never moves.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``cache_dir()``; returns
    the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

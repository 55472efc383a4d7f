"""Where the persistent XLA compile cache lives.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` from the environment itself; when
it is set, :func:`setup_compile_cache` sets nothing. Otherwise the cache
goes to one fixed directory inside the checkout (``<repo>/.jax_cache``,
listed in ``.gitignore``): the path is part of the cache key, so it must
not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR

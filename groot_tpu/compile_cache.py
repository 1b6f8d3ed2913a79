"""Where JAX's persistent compilation cache lives.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no path of its own. Otherwise the cache goes to one fixed
directory inside the checkout (``<repo>/.jax_cache``, gitignored): the path
is part of what the cache is keyed on, so it never moves between runs."""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable() -> str:
    """Point JAX's persistent cache at its directory; returns that path."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

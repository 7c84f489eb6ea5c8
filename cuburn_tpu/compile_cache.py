"""Where JAX keeps this program's persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache
lives in `.jax_cache` at the root of the checkout (listed in
.gitignore).  The path is fixed, not temporary or per process: it is
part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir() and
    return that path."""
    import jax
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

"""
Persistent XLA compilation cache, shared by the CLI, chip_smoke.py and
the bench scripts so that a second process reuses compiled kernels.
"""

from __future__ import annotations

import os

# the checkout (or install prefix) that holds the package
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory:
    `$JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads it itself, and
    no other directory is set here), else the fixed path
    `<checkout>/.jax_cache` (fixed, because the cache directory is part
    of each entry's key)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    path = os.path.join(_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

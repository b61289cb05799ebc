"""JAX's persistent compilation cache, kept at a fixed place.

A compile of the run loop takes seconds; the persistent cache lets a later
process reuse it. The cache's key includes its path, so the directory must
not move between runs: it is ``$JAX_COMPILATION_CACHE_DIR`` when that is set
(JAX reads the variable itself), and otherwise ``.jax_cache/`` at the root of
the checkout. Nothing else in the program sets a cache.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use. Call before the first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

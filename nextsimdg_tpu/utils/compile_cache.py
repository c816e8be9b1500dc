"""Where JAX keeps its persistent compilation cache.

Every entry point calls :func:`enable_compile_cache` before it compiles.
The cache key includes the directory, so the directory must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it
(JAX reads it itself), otherwise one fixed directory inside the checkout,
which ``.gitignore`` lists.
"""

from __future__ import annotations

import os
from pathlib import Path

#: The checkout's own cache directory (used when the environment sets none).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)

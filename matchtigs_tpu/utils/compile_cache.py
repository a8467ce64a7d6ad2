"""JAX persistent compilation cache location.

One rule for every entry point (the CLI, ``bench.py``, ``chip_smoke.py``):
when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and
nothing is set in code; otherwise the cache lives at the fixed path
``<checkout>/.jax_cache``.  The path is part of the cache key, so a fixed
directory is what lets a second process reuse the first one's compiles.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at its directory.

    Returns the directory in use, or None when the default directory
    cannot be created (the program then compiles without a cache)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    try:
        DEFAULT_DIR.mkdir(exist_ok=True)
    except OSError as e:
        logger.warning("compile cache disabled: cannot create %s (%s)",
                       DEFAULT_DIR, e)
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)

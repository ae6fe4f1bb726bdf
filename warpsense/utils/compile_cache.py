"""Persistent XLA compilation cache for the command-line entry points.

The full-window fusion and registration steps take seconds to compile on
a GPU; a persistent cache turns every later cold start into a load.
Called by ``chip_smoke.py``, ``bench.py`` and the ``python -m`` entry
points — never at package import, so library users and the test suite
keep JAX's own default (no cache).
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here.  Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (the path is part of the cache key, so it
    must not move between runs)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)

"""Persistent XLA compile cache for the GPU entry points.

``chip_smoke.py``, ``bench.py`` and ``examples/*.py`` call ``enable()``
before their first compilation.  Where ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX already reads it and nothing else is set here.  Otherwise the
cache lives at one fixed path inside the checkout (``.jax_cache/``, listed
in ``.gitignore``): the path is part of the cache key, so it never depends
on a temporary name, a process id or the time.  The CPU test suite keeps
no persistent cache (tests/conftest.py).
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

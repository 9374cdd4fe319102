"""Where XLA's persistent compilation cache lives.

A compile of the full render step takes tens of seconds, so entry points
(the CLI, ``bench.py``, ``chip_smoke.py``) keep compiled programs across
processes. The cache key includes the directory, so it has to be a fixed
path: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself,
and nothing here overrides it), else ``.jax_cache`` at the root of the
checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Point the persistent compilation cache at its directory; returns it."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_DIR)
    return CHECKOUT_DIR

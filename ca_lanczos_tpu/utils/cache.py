"""JAX's persistent compilation cache for every entry point.

``enable_compile_cache`` is called by the CLI, ``bench.py``,
``chip_smoke.py`` and ``__graft_entry__.py``.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
else is set here.  Otherwise the cache lives in ``<checkout>/.jax_cache``
(listed in ``.gitignore``), a fixed path, so later processes of the same
checkout find what earlier ones compiled.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

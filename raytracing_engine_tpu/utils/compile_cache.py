"""Persistent XLA compile cache for the program's entry points.

Called from `cli.main`, `bench.py` and `chip_smoke.py` — never at import,
so library users and the test suite keep control of JAX's configuration.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Use `$JAX_COMPILATION_CACHE_DIR` when the variable is set (JAX reads
    it itself; an empty value keeps the cache off, as the test suite
    wants) and set nothing else. Otherwise keep the cache in the fixed
    directory `<repo>/.jax_cache`, so that the next run finds what this one
    compiled. Returns the directory in use ('' = off)."""
    if ENV in os.environ:
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

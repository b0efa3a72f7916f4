"""Persistent XLA compilation cache (SURVEY.md §6 throughput harness).

A cold compile of a trainer's update costs tens of seconds of host CPU,
and every process would pay it again. JAX's persistent compilation
cache is keyed on (HLO, compile options, device, cache path), so it only
hits from a directory that does not move:

- ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and no other.
- Otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``), so a
  checkout keeps its own cache wherever it is unpacked.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at the directory the
    module docstring names; returns it."""
    import jax

    cache_dir = os.environ.get(ENV_VAR) or CHECKOUT_CACHE_DIR
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir

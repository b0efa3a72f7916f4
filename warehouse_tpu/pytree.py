"""Frozen dataclasses that are JAX pytrees.

Every field is a pytree child (arrays or nested pytrees), flattened in
declaration order, so instances pass through ``jit``, ``vmap``,
``lax.scan`` and ``shard_map`` and carry key paths (``GetAttrKey``) for
checkpointing. ``.replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Decorator: frozen dataclass + pytree registration + ``replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    cls.replace = replace
    return jax.tree_util.register_dataclass(cls)

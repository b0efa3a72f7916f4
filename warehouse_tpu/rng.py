"""Canonical random-draw streams (docs/SEMANTICS.md §9).

These functions ARE the spec of the environment's randomness: the JAX
engine calls them inside ``jit``; the NumPy oracle's ``JaxDrawSource``
calls them eagerly on CPU and feeds the resulting scalars into the pure
NumPy dynamics — which is what makes oracle ≡ engine bit-exact parity
possible (SURVEY.md §7 "pluggable RNG from day 1").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import EnvConfig


class ResetDraws(NamedTuple):
    carry_key: jax.Array   # becomes state.key
    agent_cells: jax.Array  # int32[A] row-major cell ids, distinct
    req_pick: jax.Array     # int32[init_requests]
    req_drop: jax.Array     # int32[init_requests]


class StepDraws(NamedTuple):
    next_key: jax.Array    # becomes state.key
    reset_key: jax.Array   # used iff this tick auto-resets
    spawn_u: jax.Array     # float32 in [0, 1)
    spawn_pick: jax.Array  # int32 cell id
    spawn_drop: jax.Array  # int32 cell id


def _free_cells(cfg: EnvConfig) -> jax.Array:
    """Row-major free-cell ids as a trace-time constant (§1a)."""
    import numpy as np

    return jnp.asarray(np.array(cfg.free_cells, dtype=np.int32))


def reset_draws(key: jax.Array, cfg: EnvConfig) -> ResetDraws:
    """Draws for ``reset`` (docs/SEMANTICS.md §9). All cell draws index
    into ``free_cells`` — identity when there are no walls."""
    free = _free_cells(cfg)
    carry_key, pos_key, req_key = jax.random.split(key, 3)
    perm = jax.random.permutation(pos_key, cfg.num_free)
    agent_cells = free[perm[: cfg.num_agents]].astype(jnp.int32)
    n = max(cfg.init_requests, 1)  # avoid zero-size vmap; sliced below
    slots = jnp.arange(n)
    pick = jax.vmap(
        lambda s: jax.random.randint(
            jax.random.fold_in(req_key, 2 * s), (), 0, cfg.num_free
        )
    )(slots)
    drop = jax.vmap(
        lambda s: jax.random.randint(
            jax.random.fold_in(req_key, 2 * s + 1), (), 0, cfg.num_free
        )
    )(slots)
    k = cfg.init_requests
    return ResetDraws(
        carry_key,
        agent_cells,
        free[pick[:k]].astype(jnp.int32),
        free[drop[:k]].astype(jnp.int32),
    )


def step_draws(key: jax.Array, cfg: EnvConfig) -> StepDraws:
    """Draws for one ``step`` tick (docs/SEMANTICS.md §9). Spawn cells
    are drawn over free cells and returned as actual cell ids."""
    free = _free_cells(cfg)
    next_key, sk, reset_key = jax.random.split(key, 3)
    u = jax.random.uniform(jax.random.fold_in(sk, 0))
    pick = free[jax.random.randint(
        jax.random.fold_in(sk, 1), (), 0, cfg.num_free
    )].astype(jnp.int32)
    drop = free[jax.random.randint(
        jax.random.fold_in(sk, 2), (), 0, cfg.num_free
    )].astype(jnp.int32)
    return StepDraws(next_key, reset_key, u, pick, drop)


def batched_step_draws(keys: jax.Array, cfg: EnvConfig, T: int):
    """T steps of per-env draws, batched: returns ``(final_keys,
    u float32[T, B], pick int32[T, B], drop int32[T, B],
    reset_keys uint32[T, B, 2])``.

    BIT-IDENTICAL to ``lax.scan``ning ``vmap(step_draws)`` over T (the
    per-key draw functions are the same code on the same keys), but the
    only sequential work left is the key-advance chain — the T·B scalar
    draws run as ONE batched program.
    """
    def chain(ks, _):
        trip = jax.vmap(lambda k: jax.random.split(k, 3))(ks)  # [B, 3, 2]
        return trip[:, 0], (trip[:, 1], trip[:, 2])

    final_keys, (sks, rks) = jax.lax.scan(chain, keys, None, length=T)
    free = _free_cells(cfg)
    B = keys.shape[0]
    flat = sks.reshape(T * B, 2)
    u = jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, 0))
    )(flat).reshape(T, B)
    pick = jax.vmap(
        lambda k: free[jax.random.randint(
            jax.random.fold_in(k, 1), (), 0, cfg.num_free
        )].astype(jnp.int32)
    )(flat).reshape(T, B)
    drop = jax.vmap(
        lambda k: free[jax.random.randint(
            jax.random.fold_in(k, 2), (), 0, cfg.num_free
        )].astype(jnp.int32)
    )(flat).reshape(T, B)
    return final_keys, u, pick, drop, rks


def batched_gumbel_stream(key: jax.Array, T: int, shape: tuple):
    """(next_key, g float32[T, *shape]) — bit-identical to the per-step
    ``key, ak = split(key); gumbel(ak, shape)`` chain, with all T
    gumbel draws generated in one batched call."""
    def chain(k, _):
        k, ak = jax.random.split(k)
        return k, ak

    next_key, aks = jax.lax.scan(chain, key, None, length=T)
    g = jax.vmap(
        lambda ak: jax.random.gumbel(ak, shape, jnp.float32)
    )(aks)
    return next_key, g

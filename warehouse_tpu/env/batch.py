"""Batched env API: vmap+jit over the pure single-env functions.

The on-device replacement for the reference stack's N rollout-worker
processes each stepping its own env copies (SURVEY.md §2.3 DP row): one
jitted program steps the whole batch in lockstep on-device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import rng as _rng
from ..config import EnvConfig
from . import engine
from .state import EnvState, TimeStep


@partial(jax.jit, static_argnums=0)
def reset_batch(cfg: EnvConfig, keys: jax.Array) -> tuple[EnvState, jax.Array]:
    """Reset a batch of envs from int32/uint32 keys[B, 2]."""
    return jax.vmap(lambda k: engine.reset(cfg, k))(keys)


@partial(jax.jit, static_argnums=0)
def step_batch(
    cfg: EnvConfig, state: EnvState, actions: jax.Array
) -> tuple[EnvState, TimeStep]:
    """Step a batch: state pytree with leading B axis, actions int32[B, A]."""
    return jax.vmap(lambda s, a: engine.step(cfg, s, a))(state, actions)


@partial(jax.jit, static_argnums=0)
def step_autoreset_batch(
    cfg: EnvConfig, state: EnvState, actions: jax.Array
) -> tuple[EnvState, TimeStep]:
    """Batched step with the auto-reset cond-gated at the BATCH level.

    Bit-exact twin of ``step_batch`` with ``cfg.auto_reset=True`` — the
    reset consumes ``StepDraws.reset_key``, a pure function of the
    pre-step ``state.key``, so recomputing it here reproduces the
    in-step reset draw-for-draw. The difference is purely schedule: the
    per-env in-step reset pays ``reset_draws``'s num_free-element
    permutation plus a second ``observe`` EVERY tick for EVERY env,
    while episodes only truncate every ``max_steps`` ticks. Here the whole
    reset branch sits under one ``lax.cond`` on ``truncated.any()`` and
    executes only on ticks where some env actually truncates (1 in
    max_steps for the synchronized-episode batches every trainer
    builds). This is the canonical rollout step for all trainers.
    """
    cfg_step = cfg.replace(auto_reset=False)
    pre_keys = state.key  # [B, 2] — the keys engine.step derives from
    new_state, ts = jax.vmap(
        lambda s, a: engine.step(cfg_step, s, a)
    )(state, actions)
    done = ts.truncated  # bool[B]

    def with_reset(op):
        new_state, ts = op
        d = jax.vmap(lambda k: _rng.step_draws(k, cfg_step))(pre_keys)
        reset_state, reset_obs = jax.vmap(
            lambda k: engine.reset(cfg_step, k)
        )(d.reset_key)

        def merge(r, s):
            mask = done.reshape(done.shape + (1,) * (r.ndim - 1))
            return jnp.where(mask, r, s)

        merged = jax.tree.map(merge, reset_state, new_state)
        obs = jnp.where(done[:, None, None], reset_obs, ts.obs)
        return merged, ts.replace(obs=obs)

    return jax.lax.cond(done.any(), with_reset, lambda op: op,
                        (new_state, ts))

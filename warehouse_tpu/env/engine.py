"""The JAX warehouse engine: pure ``reset`` / ``step`` (docs/SEMANTICS.md).

Accelerator-native core (BASELINE.json:5): ``step(cfg, state, actions) ->
(EnvState, TimeStep)`` is a pure function of fixed-shape arrays —
``jax.vmap`` batches thousands of warehouse instances in lockstep,
``lax.scan`` rolls time on-device, ``shard_map`` shards the batch over a
mesh. Bit-exact twin of the NumPy oracle (``warehouse_tpu/oracle/env.py``)
under the shared draw streams of :mod:`warehouse_tpu.rng`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import rng as _rng
from ..config import EnvConfig
from ..ops.assign import assign_requests
from ..ops.move import resolve_moves
from ..ops.obs import observe
from .state import EMPTY, IN_TRANSIT, PENDING, EnvState, TimeStep

def _cell_to_rc(cell: jax.Array, width: int) -> jax.Array:
    return jnp.stack([cell // width, cell % width], axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnums=0)
def reset(cfg: EnvConfig, key: jax.Array) -> tuple[EnvState, jax.Array]:
    """Fresh episode state + initial observation (docs/SEMANTICS.md §9)."""
    A, R = cfg.num_agents, cfg.queue_capacity
    d = _rng.reset_draws(key, cfg)
    agent_pos = _cell_to_rc(d.agent_cells, cfg.width)
    req_pickup = jnp.zeros((R, 2), jnp.int32)
    req_drop = jnp.zeros((R, 2), jnp.int32)
    req_status = jnp.zeros(R, jnp.int32)
    if cfg.init_requests > 0:
        sl = slice(0, cfg.init_requests)
        req_pickup = req_pickup.at[sl].set(_cell_to_rc(d.req_pick, cfg.width))
        req_drop = req_drop.at[sl].set(_cell_to_rc(d.req_drop, cfg.width))
        req_status = req_status.at[sl].set(PENDING)
    state = EnvState(
        agent_pos=agent_pos,
        agent_req=jnp.full(A, -1, jnp.int32),
        carrying=jnp.zeros(A, bool),
        req_pickup=req_pickup,
        req_drop=req_drop,
        req_status=req_status,
        req_agent=jnp.full(R, -1, jnp.int32),
        t=jnp.int32(0),
        key=d.carry_key,
    )
    obs = observe(
        cfg, state.agent_pos, state.agent_req, state.carrying,
        state.req_pickup, state.req_drop, state.req_status,
    )
    return state, obs


@partial(jax.jit, static_argnums=0)
def step(
    cfg: EnvConfig, state: EnvState, actions: jax.Array
) -> tuple[EnvState, TimeStep]:
    """One tick, sub-steps in the exact order of docs/SEMANTICS.md §4."""
    A, R = cfg.num_agents, cfg.queue_capacity
    actions = actions.astype(jnp.int32)
    draws = _rng.step_draws(state.key, cfg)

    # 1. Movement & collision (§4.1).
    agent_pos, collided = resolve_moves(cfg, state.agent_pos, actions)

    # NOTE: every queue-slot READ and WRITE below goes through the [A, R]
    # one-hot matrix `oh` — dense compares + masked sums/selects — never
    # through `tbl[idx]` gathers or `.at[idx].set` scatters. This form
    # was chosen for an accelerator whose scatters serialize; whether it
    # beats native gathers/scatters on the GPU is unmeasured (ROADMAP
    # 1.5).
    slot_ids = jnp.arange(R, dtype=jnp.int32)

    # 2. Pickup (§5). Only the assigned agent can pick up.
    safe_req = jnp.clip(state.agent_req, 0, R - 1)
    has_req = state.agent_req >= 0
    oh = (safe_req[:, None] == slot_ids[None, :]) & has_req[:, None]
    my_pickup = (oh[:, :, None] * state.req_pickup[None]).sum(1)
    my_drop = (oh[:, :, None] * state.req_drop[None]).sum(1)
    my_status = (oh * state.req_status[None]).sum(1)
    at_pickup = (agent_pos == my_pickup).all(-1)
    picked = (
        has_req
        & ~state.carrying
        & (my_status == PENDING)
        & at_pickup
    )
    carrying = state.carrying | picked
    slot_picked = (oh & picked[:, None]).any(0)
    req_status = jnp.where(slot_picked, IN_TRANSIT, state.req_status)

    # 3. Delivery (§5) — after pickup, so pickup==drop completes same tick.
    at_drop = (agent_pos == my_drop).all(-1)
    delivered = has_req & carrying & at_drop
    slot_delivered = (oh & delivered[:, None]).any(0)
    req_status = jnp.where(slot_delivered, EMPTY, req_status)
    req_agent = jnp.where(slot_delivered, -1, state.req_agent)
    req_pickup = jnp.where(slot_delivered[:, None], 0, state.req_pickup)
    req_drop = jnp.where(slot_delivered[:, None], 0, state.req_drop)
    agent_req = jnp.where(delivered, -1, state.agent_req)
    carrying = carrying & ~delivered

    # 4. Spawn (§6): lowest-index EMPTY slot; draws consumed regardless.
    is_empty = req_status == EMPTY
    ok = (draws.spawn_u < cfg.spawn_prob) & is_empty.any()
    first_empty = is_empty & (jnp.cumsum(is_empty) == 1)
    w = first_empty & ok
    req_pickup = jnp.where(
        w[:, None], _cell_to_rc(draws.spawn_pick, cfg.width), req_pickup
    )
    req_drop = jnp.where(
        w[:, None], _cell_to_rc(draws.spawn_drop, cfg.width), req_drop
    )
    req_status = jnp.where(w, PENDING, req_status)
    req_agent = jnp.where(w, -1, req_agent)

    # 5. Assignment (§7).
    agent_req, req_agent = assign_requests(
        cfg, agent_pos, agent_req, req_pickup, req_status, req_agent
    )

    # 6. Rewards (§8) — float32 throughout.
    reward = (
        cfg.step_penalty
        + cfg.pickup_reward * picked.astype(jnp.float32)
        + cfg.delivery_reward * delivered.astype(jnp.float32)
        + cfg.collision_penalty * collided.astype(jnp.float32)
    ).astype(jnp.float32)

    # 7. Time & termination.
    t = state.t + 1
    truncated = t >= cfg.max_steps

    new_state = EnvState(
        agent_pos=agent_pos,
        agent_req=agent_req,
        carrying=carrying,
        req_pickup=req_pickup,
        req_drop=req_drop,
        req_status=req_status,
        req_agent=req_agent,
        t=t,
        key=draws.next_key,
    )

    # 8. Observation (§10).
    obs = observe(
        cfg, agent_pos, agent_req, carrying, req_pickup, req_drop, req_status
    )

    # 9. Auto-reset (§4.9): replace done envs with a fresh episode.
    final_obs = obs  # pre-reset obs: the V(s_T) input for truncation
    #                  bootstrapping (aliases obs when no reset fires)
    if cfg.auto_reset:
        reset_state, reset_obs = reset(cfg, draws.reset_key)
        done = truncated
        new_state = jax.tree.map(
            lambda r, s: jnp.where(
                jnp.reshape(done, (1,) * r.ndim), r, s
            ),
            reset_state,
            new_state,
        )
        obs = jnp.where(done, reset_obs, obs)

    ts = TimeStep(
        obs=obs,
        final_obs=final_obs,
        reward=reward,
        terminated=jnp.bool_(False),
        truncated=truncated,
        picked=picked,
        delivered=delivered,
        collided=collided,
    )
    return new_state, ts

"""Jitted batched greedy nearest-request policy (docs/SEMANTICS.md §12).

The reference's greedy baseline solver re-expressed as vectorized array
ops so baseline rollouts run fully on-device (BASELINE.json:5 "reimplement
the greedy nearest-request baseline solver as a jitted batched policy").
Bit-exact twin of ``warehouse_tpu/oracle/greedy.py``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import EnvConfig
from ..env.state import EnvState

STAY, UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3, 4


def greedy_actions(cfg: EnvConfig, state: EnvState) -> jnp.ndarray:
    """int32[A] actions from privileged state; vmap over batch for free."""
    # One-hot read of each agent's request cells (see engine.py note).
    safe = jnp.clip(state.agent_req, 0, cfg.queue_capacity - 1)
    has = state.agent_req >= 0
    slot_ids = jnp.arange(cfg.queue_capacity, dtype=jnp.int32)
    oh = (safe[:, None] == slot_ids[None, :]) & has[:, None]
    my_pickup = (oh[:, :, None] * state.req_pickup[None]).sum(1)
    my_drop = (oh[:, :, None] * state.req_drop[None]).sum(1)
    target = jnp.where(state.carrying[:, None], my_drop, my_pickup)
    d = target - state.agent_pos
    vert = jnp.where(d[:, 0] < 0, UP, DOWN)
    horiz = jnp.where(d[:, 1] < 0, LEFT, RIGHT)
    act = jnp.where(
        d[:, 0] != 0, vert, jnp.where(d[:, 1] != 0, horiz, STAY)
    )
    return jnp.where(has, act, STAY).astype(jnp.int32)


def target_cells(cfg: EnvConfig, state: EnvState):
    """(target_cell int32[A], has_task bool[A]): each agent's current
    navigation target — assigned pickup cell, or drop cell once carrying
    (docs/SEMANTICS.md §12). One-hot queue reads, gather-free."""
    safe = jnp.clip(state.agent_req, 0, cfg.queue_capacity - 1)
    has = state.agent_req >= 0
    slot_ids = jnp.arange(cfg.queue_capacity, dtype=jnp.int32)
    oh = (safe[:, None] == slot_ids[None, :]) & has[:, None]
    my_pickup = (oh[:, :, None] * state.req_pickup[None]).sum(1)
    my_drop = (oh[:, :, None] * state.req_drop[None]).sum(1)
    target = jnp.where(state.carrying[:, None], my_drop, my_pickup)
    return (target[:, 0] * cfg.width + target[:, 1]).astype(jnp.int32), has


def greedy_bfs_actions(cfg: EnvConfig, state: EnvState) -> jnp.ndarray:
    """Obstacle-aware greedy via the BFS table (docs/SEMANTICS.md §12a).

    Bit-exact twin of ``oracle/greedy.greedy_bfs_actions``. The all-pairs
    distance table is a trace-time constant of the frozen config
    (ops/pathing.py); table reads are one-hot matmuls, not gathers.
    """
    from ..ops.pathing import UNREACHABLE, dist_rows, distance_table

    table = distance_table(cfg)
    H, W = cfg.height, cfg.width
    target_cell, has = target_cells(cfg, state)                 # [A]

    rows = dist_rows(cfg, table, target_cell, xp=jnp)           # [A, C]

    deltas = jnp.array(
        [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)], jnp.int32
    )  # §3 action order
    prop = state.agent_pos[:, None, :] + deltas[None]           # [A, 5, 2]
    in_grid = (
        (prop[..., 0] >= 0) & (prop[..., 0] < H)
        & (prop[..., 1] >= 0) & (prop[..., 1] < W)
    )
    prop_cell = jnp.clip(prop[..., 0], 0, H - 1) * W + jnp.clip(
        prop[..., 1], 0, W - 1
    )                                                           # [A, 5]
    cell_ids = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    oh_prop = (prop_cell[..., None] == cell_ids).astype(jnp.float32)
    cand = (oh_prop * rows[:, None, :]).sum(-1)                 # [A, 5]
    cand = jnp.where(in_grid, cand, 2.0 * float(UNREACHABLE))
    act = jnp.argmin(cand, axis=-1).astype(jnp.int32)  # ties → lowest index
    return jnp.where(has, act, STAY)

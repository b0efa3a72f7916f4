"""Movement & collision resolution as masked array ops.

Implements docs/SEMANTICS.md §4.1 exactly (the oracle twin is
``OracleEnv._move``). Array-native shape: no data-dependent Python control
flow — rules 1–3 are A×A boolean matrices, rule 4 is a statically unrolled
monotone fixed point (A iterations always suffice because each iteration
only ever invalidates moves). A is small (≤ 8 in all driver configs,
BASELINE.md), so A×A work is cheap elementwise work and ``vmap``s over the
env batch for free.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import EnvConfig

# STAY, UP, DOWN, LEFT, RIGHT (docs/SEMANTICS.md §3).
ACTION_DELTAS = jnp.array(
    [[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]], dtype=jnp.int32
)


def resolve_moves(cfg: EnvConfig, pos: jnp.ndarray, actions: jnp.ndarray):
    """Resolve simultaneous moves.

    Args:
      pos: int32[A, 2] current cells.
      actions: int32[A] in [0, 5).

    Returns:
      (new_pos int32[A, 2], collided bool[A]) — ``collided[i]`` iff agent i
      proposed a move (action != STAY) that was reverted.
    """
    A = cfg.num_agents
    proposed = actions != 0
    prop = pos + ACTION_DELTAS[actions]

    # Rule 1: bounds + static walls (docs/SEMANTICS.md §1a). Wall checks
    # are unrolled compares against the (static) wall cell ids — no
    # gather. Out-of-bounds proposals may alias a wall id after
    # row-major flattening, but `inb` already vetoes them.
    inb = (
        (prop[:, 0] >= 0)
        & (prop[:, 0] < cfg.height)
        & (prop[:, 1] >= 0)
        & (prop[:, 1] < cfg.width)
    )
    if cfg.walls:
        cell = prop[:, 0] * cfg.width + prop[:, 1]
        is_wall = jnp.zeros_like(inb)
        for w in cfg.walls:
            is_wall = is_wall | (cell == w)
        inb = inb & ~is_wall
    moving = proposed & inb
    prop = jnp.where(moving[:, None], prop, pos)

    # Rule 2: same-target — lowest agent index wins.
    tgt = prop[:, 0] * cfg.width + prop[:, 1]
    both_moving = moving[:, None] & moving[None, :]
    same_tgt = (tgt[:, None] == tgt[None, :]) & both_moving
    lower = jnp.tril(jnp.ones((A, A), dtype=bool), k=-1)  # [i, j]: j < i
    lost = (same_tgt & lower).any(axis=1)
    moving = moving & ~lost
    prop = jnp.where(moving[:, None], prop, pos)

    # Rule 3: swaps — both revert.
    both_moving = moving[:, None] & moving[None, :]
    i_to_j = (prop[:, None, :] == pos[None, :, :]).all(-1)  # prop[i]==pos[j]
    swap = (i_to_j & i_to_j.T & both_moving
            & ~jnp.eye(A, dtype=bool)).any(axis=1)
    moving = moving & ~swap
    prop = jnp.where(moving[:, None], prop, pos)

    # Rule 4: blocked-cell fixed point, statically unrolled A times.
    not_self = ~jnp.eye(A, dtype=bool)
    for _ in range(A):
        # prop[j] == pos[j] for every non-moving j, so comparing against
        # prop rows of non-movers equals comparing against their cells.
        hits_static = (prop[:, None, :] == prop[None, :, :]).all(-1)
        blocked = (hits_static & (~moving)[None, :] & not_self).any(axis=1)
        moving = moving & ~blocked
        prop = jnp.where(moving[:, None], prop, pos)

    collided = proposed & ~moving
    return prop, collided


def valid_action_mask(cfg: EnvConfig, pos: jnp.ndarray) -> jnp.ndarray:
    """bool[A, 5]: action doesn't walk out of the grid or into a wall.

    The static (bounds + walls) part of §4.1 rule 1 only — agent-agent
    conflicts stay dynamic. Used for policy action masking
    (``TrainConfig.mask_actions``): invalid logits are floored so the
    policy never samples a guaranteed collision with the layout.
    """
    prop = pos[:, None, :] + ACTION_DELTAS[None]  # [A, 5, 2]
    ok = (
        (prop[..., 0] >= 0)
        & (prop[..., 0] < cfg.height)
        & (prop[..., 1] >= 0)
        & (prop[..., 1] < cfg.width)
    )
    if cfg.walls:
        cell = prop[..., 0] * cfg.width + prop[..., 1]
        is_wall = jnp.zeros_like(ok)
        for w in cfg.walls:
            is_wall = is_wall | (cell == w)
        ok = ok & ~is_wall
    return ok

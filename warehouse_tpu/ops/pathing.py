"""All-pairs BFS shortest-path distance fields over the static layout.

The wall/shelf layout is a compile-time constant (``EnvConfig.walls`` is
frozen config — SURVEY.md §5.6 "grid size … are SHAPES"), so the full
all-pairs grid-distance table is computed ONCE on host in NumPy and
folded into every jitted program that uses it as a literal constant. No
on-device search ever runs: path planning is a table read (expressed as
a one-hot matmul so the hot path stays gather-free, see the engine.py
layout note).

Used by:

- the obstacle-aware greedy baseline (``baselines/greedy.greedy_bfs_actions``
  and its oracle twin, docs/SEMANTICS.md §12a), and
- potential-based reward shaping for PPO on walled layouts
  (``train/ppo.py``; Ng et al. 1999 — policy-invariant shaping
  ``r + γ·φ(s') − φ(s)`` with ``φ = −BFS distance to current target``).

With no walls the table equals Manhattan distance, so open-floor
behavior is unchanged.
"""

from __future__ import annotations

import functools

import numpy as np

from ..config import EnvConfig

# Unreachable/wall sentinel. Finite so int arithmetic can't overflow and
# comparisons stay well-defined inside jit; far larger than any real
# grid distance (grids are ≤ ~32x32 here).
UNREACHABLE = np.int32(1 << 14)


@functools.lru_cache(maxsize=None)
def distance_table(cfg: EnvConfig) -> np.ndarray:
    """int32[C, C] BFS distances between all cell pairs; row-major ids.

    ``table[a, b]`` = length of the shortest 4-neighbor path from cell
    ``a`` to cell ``b`` through non-wall cells, or ``UNREACHABLE`` if
    either endpoint is a wall or no path exists. Symmetric.
    """
    H, W, C = cfg.height, cfg.width, cfg.num_cells
    wall = np.zeros(C, dtype=bool)
    wall[list(cfg.walls)] = True

    table = np.full((C, C), UNREACHABLE, dtype=np.int32)
    for src in range(C):
        if wall[src]:
            continue
        dist = np.full(C, UNREACHABLE, dtype=np.int32)
        dist[src] = 0
        frontier = [src]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for c in frontier:
                r, col = divmod(c, W)
                for nc in (
                    c - W if r > 0 else -1,
                    c + W if r < H - 1 else -1,
                    c - 1 if col > 0 else -1,
                    c + 1 if col < W - 1 else -1,
                ):
                    if nc >= 0 and not wall[nc] and dist[nc] == UNREACHABLE:
                        dist[nc] = d
                        nxt.append(nc)
            frontier = nxt
        table[src] = dist
    return table


def dist_rows(cfg: EnvConfig, table, target_cell, xp=np):
    """float32[A, C]: BFS distance from EVERY cell to each target.

    ``rows[i, c] = table[c, target_cell[i]]`` without gathers: the
    target index is one-hot-encoded and contracted against the table by
    a matmul inside jit instead of a gather (engine.py layout note).
    Distances are
    ≤ UNREACHABLE < 2^24 so float32 is exact. ``xp`` is the array
    namespace (``numpy`` for the oracle, ``jax.numpy`` inside jit).
    """
    C = cfg.num_cells
    ids = xp.arange(C, dtype=xp.int32)
    oh_tgt = (target_cell[:, None] == ids[None, :]).astype(xp.float32)
    return oh_tgt @ xp.asarray(table, dtype=xp.float32).T  # [A, C]


def dist_to_targets(cfg: EnvConfig, table, cell, target_cell, xp=np):
    """float32[A]: ``table[cell[i], target_cell[i]]`` without gathers."""
    C = cfg.num_cells
    ids = xp.arange(C, dtype=xp.int32)
    rows = dist_rows(cfg, table, target_cell, xp)       # [A, C]
    oh_src = (cell[:, None] == ids[None, :]).astype(xp.float32)
    return (rows * oh_src).sum(-1)                      # [A]


def potential(cfg: EnvConfig, state) -> "jax.Array":  # noqa: F821
    """float32[A] shaping potential φ(s) = −BFS_dist(pos, target), 0 if
    the agent has no task or the target is unreachable.

    Potential-based reward shaping (Ng, Harada & Russell 1999): adding
    ``γ·φ(s') − φ(s)`` to the reward leaves the optimal policy unchanged
    because φ is a function of the state alone. Used by train/ppo.py when
    ``TrainConfig.shaping_coef > 0`` — it densifies the sparse
    pickup/delivery signal that collapses vanilla PPO on walled layouts.
    """
    import jax.numpy as jnp

    from ..baselines.greedy import target_cells

    table = distance_table(cfg)
    target_cell, has = target_cells(cfg, state)
    pos_cell = state.agent_pos[:, 0] * cfg.width + state.agent_pos[:, 1]
    d = dist_to_targets(cfg, table, pos_cell, target_cell, xp=jnp)
    ok = has & (d < float(UNREACHABLE))
    return jnp.where(ok, -d, 0.0).astype(jnp.float32)

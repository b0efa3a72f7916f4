"""Observation construction fused into the step (docs/SEMANTICS.md §10).

Fully comparison-based: window/global channels are built by comparing
window-cell coordinates against entity positions ([A, S², A]/[A, S², R]
boolean tensors reduced with `any`) — no grids, no scatters, no
dynamic_slice, so the whole construction is elementwise work that XLA
fuses (whether a scatter-built grid is cheaper on the GPU is ROADMAP
1.5/2.2). Out-of-grid window cells fall out as zeros automatically
because out-of-bounds coordinates never equal any in-bounds entity
position. Oracle twin: ``OracleEnv._observe``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import EnvConfig

PENDING = 1


def _targets(cfg, agent_pos, agent_req, carrying, req_pickup, req_drop):
    """(has_task bool[A], target int32[A, 2]) per docs/SEMANTICS.md §10.

    One-hot reads instead of gathers (see the engine.py NOTE)."""
    has_task = agent_req >= 0
    safe = jnp.clip(agent_req, 0, cfg.queue_capacity - 1)
    slot_ids = jnp.arange(cfg.queue_capacity, dtype=jnp.int32)
    oh = (safe[:, None] == slot_ids[None, :]) & has_task[:, None]
    my_pickup = (oh[:, :, None] * req_pickup[None]).sum(1)
    my_drop = (oh[:, :, None] * req_drop[None]).sum(1)
    tgt = jnp.where(carrying[:, None], my_drop, my_pickup)
    tgt = jnp.where(has_task[:, None], tgt, agent_pos)
    return has_task, tgt


def _feats(cfg, agent_pos, carrying, has_task, tgt):
    """Self features [row/H, col/W, carrying, has_task, drow/H, dcol/W].

    Normalization is EXPLICIT multiplication by the float32 reciprocal
    (docs/SEMANTICS.md §10): under jit XLA strength-reduces division by
    a constant into reciprocal multiplication anyway, which differs from
    true division by 1 ulp for some values (found by hypothesis at W=6)
    — so the spec pins the multiply and the oracle does the same.
    """
    import numpy as _np

    inv_h = float(_np.float32(1.0) / _np.float32(cfg.height))
    inv_w = float(_np.float32(1.0) / _np.float32(cfg.width))
    delta = jnp.where(has_task[:, None], tgt - agent_pos, 0)
    return jnp.stack(
        [
            agent_pos[:, 0].astype(jnp.float32) * inv_h,
            agent_pos[:, 1].astype(jnp.float32) * inv_w,
            carrying.astype(jnp.float32),
            has_task.astype(jnp.float32),
            delta[:, 0].astype(jnp.float32) * inv_h,
            delta[:, 1].astype(jnp.float32) * inv_w,
        ],
        axis=-1,
    ).astype(jnp.float32)


def observe(
    cfg: EnvConfig,
    agent_pos: jnp.ndarray,
    agent_req: jnp.ndarray,
    carrying: jnp.ndarray,
    req_pickup: jnp.ndarray,
    req_drop: jnp.ndarray,
    req_status: jnp.ndarray,
) -> jnp.ndarray:
    """Per-agent flat observations, float32[A, obs_dim]."""
    H, W = cfg.height, cfg.width
    has_task, tgt = _targets(
        cfg, agent_pos, agent_req, carrying, req_pickup, req_drop
    )
    feats = _feats(cfg, agent_pos, carrying, has_task, tgt)
    pending = req_status == PENDING

    if cfg.global_obs:
        # Channels over the full grid. Same lane discipline as the ego
        # branch below: every compare keeps the H·W grid axis MINOR
        # ([E, H·W] shapes), channels stack [5, A, H·W], one transpose
        # restores the spec's channel-last [H, W, 5] ravel.
        A = agent_pos.shape[0]
        rows = (jnp.arange(H * W) // W).astype(jnp.int32)
        cols = (jnp.arange(H * W) % W).astype(jnp.int32)
        # [A, H*W]: cell == my position
        self_oh = (
            (rows[None, :] == agent_pos[:, 0:1])
            & (cols[None, :] == agent_pos[:, 1:2])
        )
        # [H*W]: any agent on the cell (then mask out self per agent)
        any_agent = self_oh.any(0)
        others = any_agent[None, :] & ~self_oh
        pend_cells = (
            (rows[None, :] == req_pickup[:, 0:1])
            & (cols[None, :] == req_pickup[:, 1:2])
            & pending[:, None]
        ).any(0)
        tgt_oh = (
            (rows[None, :] == tgt[:, 0:1])
            & (cols[None, :] == tgt[:, 1:2])
            & has_task[:, None]
        )
        # ch4: traversable (not a wall) — ego ch3 semantics over the full
        # grid (docs/SEMANTICS.md §1a/§10). Static per config.
        free = jnp.ones(H * W, bool)
        for w in cfg.walls:
            free = free & (jnp.arange(H * W) != w)
        # [5, A, H*W] → [A, H*W, 5]: spec layout [H, W, 5] ravel.
        grid = jnp.stack(
            [
                self_oh,
                others,
                jnp.broadcast_to(pend_cells[None, :], self_oh.shape),
                tgt_oh,
                jnp.broadcast_to(free[None, :], self_oh.shape),
            ],
            axis=0,
        ).astype(jnp.float32)
        grid = jnp.transpose(grid, (1, 2, 0))
        return jnp.concatenate([grid.reshape(A, -1), feats], axis=-1)

    k, S = cfg.obs_radius, cfg.window_size
    A = agent_pos.shape[0]
    n = A * S * S
    # Layout: under vmap these arrays get a leading [B] batch axis. The
    # natural [A, S², E] compare would put E = num_entities (4–16) on
    # the minor axis; everything below keeps the fused window axis
    # (A·S² ≈ 100–200) MINOR instead: compares are [E, A·S²], the
    # channel stack is [4, A·S²], and a single transpose at the end
    # restores the spec's channel-last [S, S, 4] ravel. Same booleans,
    # bit-exact vs the oracle.
    offs_r = (jnp.arange(S * S) // S).astype(jnp.int32) - k
    offs_c = (jnp.arange(S * S) % S).astype(jnp.int32) - k
    # Window cell coordinates, fused [A·S²].
    wr = (agent_pos[:, 0:1] + offs_r[None, :]).reshape(n)
    wc = (agent_pos[:, 1:2] + offs_c[None, :]).reshape(n)

    # ch0: any agent on the cell ([A', A·S²] compare).
    ch0 = (
        (wr[None, :] == agent_pos[:, 0:1])
        & (wc[None, :] == agent_pos[:, 1:2])
    ).any(0)
    # ch1: pending pickup on the cell ([R, A·S²] compare).
    ch1 = (
        (wr[None, :] == req_pickup[:, 0:1])
        & (wc[None, :] == req_pickup[:, 1:2])
        & pending[:, None]
    ).any(0)
    # ch2: own target on the cell (per-agent values broadcast over S²).
    def per_agent(v):
        return jnp.broadcast_to(v[:, None], (A, S * S)).reshape(n)

    ch2 = (
        (wr == per_agent(tgt[:, 0])) & (wc == per_agent(tgt[:, 1]))
        & per_agent(has_task)
    )
    # ch3: cell inside the grid and not a wall (docs/SEMANTICS.md §1a).
    ch3 = (wr >= 0) & (wr < H) & (wc >= 0) & (wc < W)
    if cfg.walls:
        wcell = wr * W + wc
        walls = jnp.array(cfg.walls, jnp.int32)
        ch3 = ch3 & ~(wcell[None, :] == walls[:, None]).any(0)

    win = jnp.stack([ch0, ch1, ch2, ch3], axis=0).astype(jnp.float32)
    # [4, A·S²] → [A, S², 4]: one transpose restores the channel-last
    # spec order ([S, S, 4] ravel per agent, docs/SEMANTICS.md §10).
    win = jnp.transpose(win.reshape(4, A, S * S), (1, 2, 0))
    return jnp.concatenate([win.reshape(A, -1), feats], axis=-1)

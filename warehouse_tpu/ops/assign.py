"""Request-to-agent assignment (docs/SEMANTICS.md §7).

Sequential-in-agent-index greedy argmin over a masked A×R Manhattan
distance matrix. Exclusivity (one agent per request) forces sequential
resolution; A is tiny and static, so the loop is unrolled at trace time
into A masked argmin/scatter steps — fully ``vmap``-able over the env
batch (SURVEY.md §7 hard part 3). Oracle twin: ``OracleEnv._assign``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import EnvConfig

PENDING = 1
_BIG = jnp.int32(1 << 30)


def assign_requests(
    cfg: EnvConfig,
    agent_pos: jnp.ndarray,   # int32[A, 2]
    agent_req: jnp.ndarray,   # int32[A]
    req_pickup: jnp.ndarray,  # int32[R, 2]
    req_status: jnp.ndarray,  # int32[R]
    req_agent: jnp.ndarray,   # int32[R]
):
    """Sticky nearest-pending assignment; ties → lowest request index."""
    # dist[i, r] = |agent_pos[i] - req_pickup[r]|_1
    # All writes are one-hot masked selects, not traced-index
    # `.at[r].set` scatters: `where(slot_ids == r, ...)` fuses into the
    # surrounding elementwise work (engine.py NOTE; ROADMAP 1.5).
    dist = jnp.abs(agent_pos[:, None, :] - req_pickup[None, :, :]).sum(-1)
    slot_ids = jnp.arange(cfg.queue_capacity, dtype=jnp.int32)
    for i in range(cfg.num_agents):
        need = agent_req[i] < 0
        avail = (req_status == PENDING) & (req_agent < 0)
        masked = jnp.where(avail, dist[i], _BIG)
        r = jnp.argmin(masked).astype(jnp.int32)
        # argmin hits an available slot iff any slot is available, so
        # `avail.any()` avoids the per-env `masked[r]` gather.
        take = need & avail.any()
        agent_req = agent_req.at[i].set(
            jnp.where(take, r, agent_req[i])
        )
        req_agent = jnp.where(
            take & (slot_ids == r), jnp.int32(i), req_agent
        )
    return agent_req, req_agent

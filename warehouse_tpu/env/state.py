"""EnvState / TimeStep pytrees (docs/SEMANTICS.md §2).

Fixed-shape arrays only: every dynamic structure in the reference (Python
request lists, agent dicts — SURVEY.md C1–C3) is array + status mask here,
so the whole state ``vmap``s over the env batch and shards over the mesh.
"""

from __future__ import annotations

import jax

from ..pytree import pytree_dataclass

EMPTY, PENDING, IN_TRANSIT = 0, 1, 2


@pytree_dataclass
class EnvState:
    agent_pos: jax.Array   # int32[A, 2]
    agent_req: jax.Array   # int32[A]; -1 = unassigned
    carrying: jax.Array    # bool[A]
    req_pickup: jax.Array  # int32[R, 2]
    req_drop: jax.Array    # int32[R, 2]
    req_status: jax.Array  # int32[R]; EMPTY/PENDING/IN_TRANSIT
    req_agent: jax.Array   # int32[R]; -1 = unassigned
    t: jax.Array           # int32
    key: jax.Array         # PRNG key


@pytree_dataclass
class TimeStep:
    obs: jax.Array         # float32[A, obs_dim] (post-auto-reset when it fires)
    final_obs: jax.Array   # float32[A, obs_dim] — pre-auto-reset obs (== obs
    #                        unless this step truncated with auto_reset on);
    #                        the V(s_T) input for truncation bootstrapping
    #                        (ops/gae.py / ops/vtrace.py bootstrap_values)
    reward: jax.Array      # float32[A]
    terminated: jax.Array  # bool (scalar; always False, SEMANTICS §4.7)
    truncated: jax.Array   # bool (scalar)
    picked: jax.Array      # bool[A]
    delivered: jax.Array   # bool[A]
    collided: jax.Array    # bool[A]

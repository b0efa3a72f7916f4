"""BFS distance fields + obstacle-aware greedy baseline
(docs/SEMANTICS.md §12a, warehouse_tpu/ops/pathing.py)."""

import numpy as np
import pytest

from warehouse_tpu import EnvConfig, medium_config, shelves_config
from warehouse_tpu.ops.pathing import (
    UNREACHABLE, dist_to_targets, distance_table,
)

# 5x5, wall bar through the middle row with a gap at (2,2)=cell 12
# (same layout as tests/test_walls.py).
WALLED = EnvConfig(height=5, width=5, num_agents=2, queue_capacity=4,
                   init_requests=2, spawn_prob=0.5, max_steps=64,
                   walls=(10, 11, 13, 14))
# 4x3 with a full wall column sealing the right edge region off.
SEALED = EnvConfig(height=4, width=3, num_agents=1, queue_capacity=2,
                   init_requests=1, walls=(1, 4, 7, 10))


def manhattan(cfg):
    C = cfg.num_cells
    r = np.arange(C) // cfg.width
    c = np.arange(C) % cfg.width
    return (np.abs(r[:, None] - r[None, :])
            + np.abs(c[:, None] - c[None, :])).astype(np.int32)


def test_open_floor_equals_manhattan():
    cfg = medium_config()
    assert np.array_equal(distance_table(cfg), manhattan(cfg))


def test_table_walls_and_detours():
    t = distance_table(WALLED)
    # Wall rows/cols are UNREACHABLE, diagonal of free cells is 0.
    assert (t[10] == UNREACHABLE).all() and (t[:, 10] == UNREACHABLE).all()
    for f in WALLED.free_cells:
        assert t[f, f] == 0
    assert np.array_equal(t, t.T)
    # (2,0)-side detour: from (1,0)=5 to (3,0)=15 must route through the
    # gap (2,2)=12: 5→6→7→12→17→16→15 = 6 steps (Manhattan would be 2).
    assert t[5, 15] == 6


def test_table_unreachable_region():
    t = distance_table(SEALED)
    # Column 1 is all wall: left col (0) and right col (2) are sealed off.
    assert t[0, 2] == UNREACHABLE
    assert t[0, 9] == 3  # same column: straight down


def test_dist_to_targets_matches_indexing():
    import jax.numpy as jnp

    cfg = WALLED
    t = distance_table(cfg)
    rng = np.random.default_rng(0)
    free = np.array(cfg.free_cells)
    src = rng.choice(free, size=8).astype(np.int32)
    tgt = rng.choice(free, size=8).astype(np.int32)
    want = t[src, tgt].astype(np.float32)
    got_np = dist_to_targets(cfg, t, src, tgt, xp=np)
    got_jx = dist_to_targets(cfg, t, jnp.asarray(src), jnp.asarray(tgt),
                             xp=jnp)
    np.testing.assert_array_equal(want, np.asarray(got_np))
    np.testing.assert_array_equal(want, np.asarray(got_jx))


def rollout_bfs_parity(cfg, seed, steps):
    """Oracle greedy_bfs ≡ engine greedy_bfs, bit-exact, full episode."""
    import jax

    from warehouse_tpu.baselines.greedy import (
        greedy_bfs_actions as jx_bfs,
    )
    from warehouse_tpu.env import engine
    from warehouse_tpu.oracle import (
        JaxDrawSource, OracleEnv, greedy_bfs_actions as np_bfs,
    )

    key = jax.random.PRNGKey(seed)
    oenv = OracleEnv(cfg, JaxDrawSource(key))
    oenv.reset()
    jstate, _ = engine.reset(cfg, key)
    deliveries = 0
    for t in range(steps):
        oa = np_bfs(cfg, oenv.state)
        ja = jx_bfs(cfg, jstate)
        np.testing.assert_array_equal(oa, np.asarray(ja), err_msg=f"t={t}")
        _, _, _, _, oinfo = oenv.step(oa)
        jstate, ts = engine.step(cfg, jstate, np.asarray(ja))
        np.testing.assert_array_equal(
            oenv.state.agent_pos, np.asarray(jstate.agent_pos),
            err_msg=f"pos t={t}",
        )
        deliveries += int(np.asarray(ts.delivered).sum())
    return deliveries


@pytest.mark.parametrize("seed", [0, 1])
def test_bfs_parity_walled(seed):
    rollout_bfs_parity(WALLED, seed, 64)


def test_bfs_parity_shelves():
    rollout_bfs_parity(shelves_config(max_steps=64), 3, 64)


def test_bfs_equals_plain_greedy_on_open_floor():
    """SEMANTICS §12a: with no walls, greedy_bfs ≡ §12 greedy, bit-exact."""
    import jax

    from warehouse_tpu.baselines.greedy import (
        greedy_actions, greedy_bfs_actions,
    )
    from warehouse_tpu.env import engine

    cfg = medium_config(max_steps=64)
    key = jax.random.PRNGKey(7)
    state, _ = engine.reset(cfg, key)
    for t in range(64):
        a_plain = np.asarray(greedy_actions(cfg, state))
        a_bfs = np.asarray(greedy_bfs_actions(cfg, state))
        np.testing.assert_array_equal(a_plain, a_bfs, err_msg=f"t={t}")
        state, _ = engine.step(cfg, state, a_plain)


@pytest.mark.slow
def test_bfs_beats_plain_greedy_on_shelves():
    """The whole point: plain greedy grinds into racks,
    greedy_bfs routes around them."""
    import jax

    from warehouse_tpu.baselines.greedy import (
        greedy_actions, greedy_bfs_actions,
    )
    from warehouse_tpu.env import engine

    cfg = shelves_config()
    B = 16

    def run(policy):
        keys = jax.vmap(
            lambda i: jax.random.fold_in(jax.random.PRNGKey(11), i)
        )(np.arange(B))
        state, _ = jax.vmap(lambda k: engine.reset(cfg, k))(keys)
        total = 0
        for _ in range(cfg.max_steps):
            acts = jax.vmap(lambda s: policy(cfg, s))(state)
            state, ts = jax.vmap(
                lambda s, a: engine.step(cfg, s, a)
            )(state, acts)
            total += int(np.asarray(ts.delivered).sum())
        return total / B

    d_bfs = run(greedy_bfs_actions)
    d_plain = run(greedy_actions)
    assert d_bfs > 2 * d_plain, (d_bfs, d_plain)
    assert d_bfs > 5.0, d_bfs

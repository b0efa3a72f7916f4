"""Static wall/shelf layout tests (docs/SEMANTICS.md §1a) across all
four implementations."""

import numpy as np
import pytest

from warehouse_tpu import EnvConfig

# 5x5 with a wall bar through the middle row (one gap at (2,2)=cell 12).
WALLED = EnvConfig(height=5, width=5, num_agents=2, queue_capacity=4,
                   init_requests=2, spawn_prob=0.5, max_steps=64,
                   walls=(10, 11, 13, 14))


def test_config_free_cells():
    assert len(WALLED.free_cells) == 21
    assert 12 in WALLED.free_cells
    assert 10 not in WALLED.free_cells
    with pytest.raises(ValueError, match="duplicate"):
        EnvConfig(walls=(3, 3))
    with pytest.raises(ValueError, match="out of range"):
        EnvConfig(walls=(81,))
    with pytest.raises(ValueError, match="free cells"):
        EnvConfig(height=2, width=2, num_agents=3, walls=(0, 1))


def test_move_blocked_by_wall():
    import jax.numpy as jnp

    from warehouse_tpu.ops.move import resolve_moves

    # Agent at (1, 0) tries DOWN into wall cell 10 = (2, 0).
    pos = jnp.array([[1, 0], [0, 4]], jnp.int32)
    new_pos, collided = resolve_moves(WALLED, pos, jnp.array([2, 0]))
    assert np.array_equal(np.asarray(new_pos)[0], [1, 0])
    assert bool(collided[0]) and not bool(collided[1])
    # Through the gap is fine: (1,2) DOWN to (2,2)=cell 12.
    pos = jnp.array([[1, 2], [0, 4]], jnp.int32)
    new_pos, collided = resolve_moves(WALLED, pos, jnp.array([2, 0]))
    assert np.array_equal(np.asarray(new_pos)[0], [2, 2])
    assert not bool(collided[0])


def never_on_walls(cfg, pos_history):
    wall_rc = {(w // cfg.width, w % cfg.width) for w in cfg.walls}
    for pos in pos_history:
        for p in np.asarray(pos).reshape(-1, 2):
            assert tuple(p) not in wall_rc, f"agent on wall {p}"


def test_parity_and_no_wall_entry():
    """Oracle ≡ engine with walls; nobody (agents or requests) on walls."""
    import jax

    from warehouse_tpu.env import engine
    from warehouse_tpu.oracle import JaxDrawSource, OracleEnv

    cfg = WALLED
    key = jax.random.PRNGKey(2)
    oenv = OracleEnv(cfg, JaxDrawSource(key))
    oobs = oenv.reset()
    jstate, jobs = engine.reset(cfg, key)
    np.testing.assert_array_equal(oobs, np.asarray(jobs))
    rng = np.random.default_rng(0)
    wall_rc = {(w // cfg.width, w % cfg.width) for w in cfg.walls}
    for t in range(50):
        a = rng.integers(0, 5, cfg.num_agents)
        oobs, orew, _, _, _ = oenv.step(a)
        jstate, ts = engine.step(cfg, jstate, a.astype(np.int32))
        np.testing.assert_array_equal(
            oenv.state.agent_pos, np.asarray(jstate.agent_pos),
            err_msg=f"t={t}",
        )
        np.testing.assert_array_equal(oobs, np.asarray(ts.obs))
        np.testing.assert_array_equal(orew, np.asarray(ts.reward))
        never_on_walls(cfg, [jstate.agent_pos])
        # Requests never on walls.
        st = np.asarray(jstate.req_status)
        for r in range(cfg.queue_capacity):
            if st[r] != 0:
                rp = tuple(np.asarray(jstate.req_pickup)[r])
                rd = tuple(np.asarray(jstate.req_drop)[r])
                assert rp not in wall_rc and rd not in wall_rc


def test_native_parity_with_walls():
    from tests.test_native import run_parity

    cfg = WALLED.replace(max_steps=1 << 30)
    run_parity(cfg, B=8, T=20, policy="random", seed=5)


def test_render_walls():
    import jax

    from warehouse_tpu.env import engine
    from warehouse_tpu.env.render import render_ascii

    state, _ = engine.reset(WALLED, jax.random.PRNGKey(0))
    s = render_ascii(WALLED, state)
    assert s.count("#") == 4


def test_no_walls_stream_unchanged():
    """Open-floor draw stream is bit-identical to the pre-walls spec
    (free_cells mapping is the identity)."""
    import jax

    from warehouse_tpu import small_config
    from warehouse_tpu import rng as _rng

    cfg = small_config()
    key = jax.random.PRNGKey(0)
    d = _rng.reset_draws(key, cfg)
    # Identity mapping: draws equal raw permutation/randint over num_cells.
    import jax.numpy as jnp

    _, pos_key, req_key = jax.random.split(key, 3)
    perm = jax.random.permutation(pos_key, cfg.num_cells)
    np.testing.assert_array_equal(
        np.asarray(d.agent_cells), np.asarray(perm[: cfg.num_agents])
    )

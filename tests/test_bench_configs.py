"""Throughput benches as pytest-marked tests for the five driver configs
(SURVEY.md §4.6, BASELINE.md). These run on whatever backend is active
(CPU in CI — numbers are NOT device numbers; bench.py on the GPU is)
and mainly assert the pipelines run end-to-end at each config shape."""

import numpy as np
import pytest

from warehouse_tpu import (
    TrainConfig,
    large_config,
    medium_config,
    small_config,
)


def rollout_steps_per_sec(cfg, B, T, policy="greedy"):
    import time

    import jax
    import jax.numpy as jnp

    from warehouse_tpu.baselines.greedy import greedy_actions
    from warehouse_tpu.baselines.random import random_actions
    from warehouse_tpu.env import engine

    keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i)
    )(jnp.arange(B))
    state, _ = jax.jit(jax.vmap(lambda k: engine.reset(cfg, k)))(keys)

    def body(carry, _):
        state, key = carry
        key, ak = jax.random.split(key)
        if policy == "greedy":
            a = jax.vmap(lambda s: greedy_actions(cfg, s))(state)
        else:
            a = random_actions(cfg, ak, (B,)).astype(jnp.int32)
        state, ts = jax.vmap(
            lambda s, aa: engine.step(cfg, s, aa)
        )(state, a)
        return (state, key), ts.delivered.sum(dtype=jnp.int32)

    @jax.jit
    def rollout(state):
        (state, _), dels = jax.lax.scan(
            body, (state, jax.random.PRNGKey(1)), None, length=T
        )
        return state, dels.sum()

    state, d = rollout(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    state, d = rollout(state)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    return B * T / dt, int(d)


@pytest.mark.slow
def test_config1_single_small_greedy():
    """Config 1: single 5x5/2-agent env, greedy (parity rig shape)."""
    sps, _ = rollout_steps_per_sec(
        small_config(auto_reset=True), B=1, T=128
    )
    print(f"\nconfig1: {sps:,.0f} env-steps/s (B=1)")
    assert sps > 0


@pytest.mark.slow
def test_config2_batched_medium_greedy():
    """Config 2: 1024 envs, 9x9/4 agents, greedy fully jitted."""
    sps, dels = rollout_steps_per_sec(
        medium_config(auto_reset=True), B=1024, T=64
    )
    print(f"\nconfig2: {sps:,.0f} env-steps/s, deliveries={dels}")
    assert dels > 0


@pytest.mark.slow
def test_config3_stress_large_random():
    """Config 3: 8192 envs, 15x15/8 agents, random policy stress."""
    sps, _ = rollout_steps_per_sec(
        large_config(auto_reset=True), B=8192, T=32, policy="random"
    )
    print(f"\nconfig3: {sps:,.0f} env-steps/s")
    assert sps > 0


@pytest.mark.slow
def test_config4_ppo_shape():
    """Config 4 shape: PPO on 4096 envs / 9x9 / 4 agents (few updates)."""
    import jax

    from warehouse_tpu.train.ppo import make_train

    trainer = make_train(
        medium_config(),
        TrainConfig(num_envs=256, unroll_length=8, num_minibatches=4,
                    ppo_epochs=2, hidden_dim=64),
    )
    rs = trainer.init(jax.random.PRNGKey(0))
    rs, m = trainer.train_step(rs)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.slow
def test_config5_multihost_shape():
    """Config 5 shape: sharded PPO over the fake 8-device mesh."""
    import jax

    from warehouse_tpu.parallel.mesh import make_mesh
    from warehouse_tpu.train.ppo import make_train

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 fake devices")
    trainer = make_train(
        medium_config(),
        TrainConfig(num_envs=64, unroll_length=4, num_minibatches=2,
                    ppo_epochs=1, hidden_dim=32),
        mesh=make_mesh(jax.devices()[:8]),
    )
    rs = trainer.init_global(jax.random.PRNGKey(0))
    rs, m = trainer.train_step(rs)
    assert np.isfinite(float(m["loss"]))

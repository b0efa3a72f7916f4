"""utils/: profiling + debug helpers."""

import pytest
import os

import numpy as np


def test_steps_per_second_meter():
    import time

    from warehouse_tpu.utils import StepsPerSecond

    m = StepsPerSecond()
    assert m.update(100) == 0.0  # first call establishes t0
    time.sleep(0.01)
    r = m.update(100)
    assert r > 0


@pytest.mark.slow
def test_trace_writes_files(tmp_path):
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.utils import annotate, trace

    d = str(tmp_path / "trace")
    with trace(d):
        with annotate("smoke"):
            jnp.ones(8).sum().block_until_ready()
    found = any(files for _, _, files in os.walk(d))
    assert found, "no trace files written"


def test_check_state_invariants_flags_corruption():
    import jax
    import jax.numpy as jnp

    from warehouse_tpu import small_config
    from warehouse_tpu.env import engine
    from warehouse_tpu.utils.debug import check_state_invariants

    cfg = small_config()
    state, _ = engine.reset(cfg, jax.random.PRNGKey(0))
    assert bool(check_state_invariants(cfg, state))
    # Corrupt: both agents on the same cell.
    bad = state.replace(
        agent_pos=jnp.zeros_like(state.agent_pos)
    )
    assert not bool(check_state_invariants(cfg, bad))
    # Corrupt: carrying without a request.
    bad2 = state.replace(carrying=jnp.ones_like(state.carrying))
    assert not bool(check_state_invariants(cfg, bad2))


def test_assert_replicated_in_sync():
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.utils.debug import assert_replicated_in_sync

    x = jnp.ones((8, 8))
    assert_replicated_in_sync({"a": x})  # single shard: trivially in sync


def test_roofline_cost_models():
    """Analytic FLOP models (utils/roofline.py): positive costs, sane
    relative ordering, and report arithmetic against the H100 peaks."""
    from warehouse_tpu import TrainConfig, medium_config
    from warehouse_tpu.utils import roofline as rl

    cfg = medium_config()
    tcfg = TrainConfig(num_envs=4096, unroll_length=16)

    costs = {f: rl.family_cost(f, cfg, tcfg)
             for f in ("ppo", "impala", "gru", "lstm", "cnn")}
    for c in costs.values():
        assert c.flops > 0
        assert c.unit_env_steps == 4096 * 16
    # CNN torso (convs + dense trunk) > plain MLP.
    assert costs["cnn"].flops > costs["ppo"].flops
    # LSTM (4 gates) > GRU (3 gates) > PPO MLP; IMPALA (1 pass) < PPO
    # (4 epochs).
    assert costs["lstm"].flops > costs["gru"].flops > costs["ppo"].flops
    assert costs["impala"].flops < costs["ppo"].flops
    # Learner FLOPs scale linearly in epochs.
    l4 = rl.learner_flops(cfg, tcfg)
    l8 = rl.learner_flops(cfg, tcfg.replace(ppo_epochs=8))
    assert abs(l8 - 2 * l4) < 1e-6 * l8
    with pytest.raises(ValueError):
        rl.family_cost("nope", cfg, tcfg)

    # A measured time equal to flops / peak is a peak share of 1.0.
    kind = "NVIDIA H100 80GB HBM3"
    c = costs["ppo"]
    for precision in ("bf16", "tf32", "fp32"):
        t = c.flops / rl.PEAKS[kind][precision]
        rep = rl.report(c, t, kind, precision)
        assert abs(rep["peak_share"] - 1.0) < 1e-9
        assert rep["peak"] == precision
    assert rl.PEAKS[kind]["bf16"] == 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_roofline_unknown_device_raises(kind):
    from warehouse_tpu.utils import roofline as rl

    with pytest.raises(ValueError, match="device_kind"):
        rl.peaks(kind)
    with pytest.raises(ValueError):
        rl.report(rl.Cost("x", 1.0, 1), 1.0, kind, "bf16")


def _cache_dir_after(monkeypatch, tmp_path, env_value):
    import jax

    from warehouse_tpu.utils import cache

    checkout = tmp_path / "checkout_cache"
    monkeypatch.setattr(cache, "CHECKOUT_CACHE_DIR", str(checkout))
    if env_value is None:
        monkeypatch.delenv(cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(cache.ENV_VAR, env_value)
    before = jax.config.jax_compilation_cache_dir
    try:
        used = cache.enable_compilation_cache()
        return used, jax.config.jax_compilation_cache_dir, checkout
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_from_env_var_and_nowhere_else(monkeypatch, tmp_path):
    target = str(tmp_path / "from_env")
    used, configured, checkout = _cache_dir_after(monkeypatch, tmp_path,
                                                  target)
    assert used == configured == target
    assert os.path.isdir(target)
    assert not checkout.exists()


def test_cache_dir_defaults_to_checkout(monkeypatch, tmp_path):
    used, configured, checkout = _cache_dir_after(monkeypatch, tmp_path,
                                                  None)
    assert used == configured == str(checkout)
    assert checkout.is_dir()


def test_checkout_cache_dir_is_inside_the_repo_and_ignored():
    from warehouse_tpu.utils import cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.CHECKOUT_CACHE_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

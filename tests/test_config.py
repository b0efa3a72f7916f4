import pytest

from warehouse_tpu import EnvConfig, small_config, medium_config, large_config


def test_defaults_match_spec():
    cfg = EnvConfig()
    assert (cfg.height, cfg.width, cfg.num_agents) == (9, 9, 4)
    assert cfg.queue_capacity == 8
    assert cfg.max_steps == 128


def test_obs_dim():
    cfg = EnvConfig(obs_radius=2)
    assert cfg.window_size == 5
    assert cfg.obs_dim == 4 * 25 + 6
    g = EnvConfig(global_obs=True)
    assert g.obs_dim == 5 * 81 + 6


def test_driver_configs():
    s, m, l = small_config(), medium_config(), large_config()
    assert (s.height, s.num_agents) == (5, 2)
    assert (m.height, m.num_agents) == (9, 4)
    assert (l.height, l.num_agents) == (15, 8)
    for c in (s, m, l):
        assert c.queue_capacity == 2 * c.num_agents
        assert c.init_requests == c.num_agents


def test_validation():
    with pytest.raises(ValueError):
        EnvConfig(num_agents=0)
    with pytest.raises(ValueError):
        EnvConfig(height=2, width=2, num_agents=5)
    with pytest.raises(ValueError):
        EnvConfig(init_requests=99)
    with pytest.raises(ValueError):
        EnvConfig(spawn_prob=1.5)


def test_roundtrip_json():
    cfg = medium_config(spawn_prob=0.5)
    import json

    assert EnvConfig.from_dict(json.loads(cfg.to_json())) == cfg


REMOVED_KNOBS = ("rollout_backend", "grad_backend", "pallas_block",
                 "pallas_interpret", "sgd_block_envs", "sgd_rows_per_block",
                 "sgd_rnn_block_envs", "impala_block_envs")


@pytest.mark.parametrize("knob", REMOVED_KNOBS)
def test_removed_kernel_knobs_are_rejected(knob):
    """The kernel-selection fields are gone: passing one (directly or
    from a saved config dict) is an error, not a silent no-op."""
    from warehouse_tpu import TrainConfig

    with pytest.raises(TypeError, match=knob):
        TrainConfig(**{knob: 1})
    with pytest.raises(TypeError, match=knob):
        TrainConfig.from_dict({"num_envs": 8, knob: 1})

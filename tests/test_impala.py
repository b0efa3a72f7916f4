"""IMPALA / V-trace learner tests (SURVEY.md §4.4; train/impala.py)."""

import numpy as np
import pytest

from warehouse_tpu import TrainConfig, small_config


def make_tiny_trainer(mesh=None, **tkw):
    from warehouse_tpu.train.impala import make_train_impala

    cfg = small_config(max_steps=16)
    t = dict(num_envs=16, unroll_length=4, num_minibatches=2,
             hidden_dim=32)
    t.update(tkw)
    return make_train_impala(cfg, TrainConfig(**t), mesh=mesh)


def _numpy_vtrace(blp, tlp, rew, val, done, last_v, gamma, rho_bar, c_bar):
    """Step-for-step NumPy transcription of Espeholt et al. 2018 eq. (1)."""
    T = rew.shape[0]
    rho = np.minimum(np.exp(tlp - blp), rho_bar)
    cs = np.minimum(np.exp(tlp - blp), c_bar)
    nd = 1.0 - done.astype(np.float64)
    v_next = np.concatenate([val[1:], last_v[None]], axis=0)
    deltas = rho * (rew + gamma * v_next * nd - val)
    acc = np.zeros_like(last_v)
    out = np.zeros_like(val)
    for t in reversed(range(T)):
        acc = deltas[t] + gamma * nd[t] * cs[t] * acc
        out[t] = acc
    vs = val + out
    vs_next = np.concatenate([vs[1:], last_v[None]], axis=0)
    pg_adv = rho * (rew + gamma * vs_next * nd - val)
    return vs, pg_adv


def test_vtrace_matches_numpy_reference():
    import jax

    from warehouse_tpu.ops.vtrace import vtrace

    rng = np.random.default_rng(0)
    T, B = 7, 5
    blp = rng.normal(size=(T, B)).astype(np.float32)
    tlp = blp + rng.normal(scale=0.3, size=(T, B)).astype(np.float32)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    val = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random(size=(T, B)) < 0.2
    last_v = rng.normal(size=(B,)).astype(np.float32)

    vs, pg = jax.jit(
        lambda *a: vtrace(*a, gamma=0.97, rho_clip=1.0, c_clip=1.0)
    )(blp, tlp, rew, val, done, last_v)
    vs_np, pg_np = _numpy_vtrace(
        blp.astype(np.float64), tlp.astype(np.float64),
        rew.astype(np.float64), val.astype(np.float64), done,
        last_v.astype(np.float64), 0.97, 1.0, 1.0)
    np.testing.assert_allclose(np.asarray(vs), vs_np, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(pg), pg_np, rtol=1e-5, atol=1e-5)


def test_vtrace_onpolicy_reduces_to_mc_return():
    """behavior == target, ρ̄ = c̄ = 1 ⇒ vs ≡ λ=1 GAE targets."""
    from warehouse_tpu.ops.gae import gae
    from warehouse_tpu.ops.vtrace import vtrace

    rng = np.random.default_rng(1)
    T, B = 9, 4
    lp = rng.normal(size=(T, B)).astype(np.float32)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    val = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random(size=(T, B)) < 0.25
    last_v = rng.normal(size=(B,)).astype(np.float32)

    vs, _ = vtrace(lp, lp, rew, val, done, last_v, gamma=0.99)
    _, targets = gae(rew, val, done, last_v, gamma=0.99, lam=1.0)
    np.testing.assert_allclose(np.asarray(vs), np.asarray(targets),
                               rtol=1e-5, atol=1e-5)


def test_vtrace_truncation_bootstrap_matches_gae():
    """On-policy V-trace with bootstrap_values ≡ λ=1 GAE with the same
    bootstrap values; and bootstrap_values are inert with no boundaries."""
    from warehouse_tpu.ops.gae import gae
    from warehouse_tpu.ops.vtrace import vtrace

    rng = np.random.default_rng(5)
    T, B = 9, 4
    lp = rng.normal(size=(T, B)).astype(np.float32)
    rew = rng.normal(size=(T, B)).astype(np.float32)
    val = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random(size=(T, B)) < 0.3
    boot = rng.normal(size=(T, B)).astype(np.float32)
    last_v = rng.normal(size=(B,)).astype(np.float32)

    vs, _ = vtrace(lp, lp, rew, val, done, last_v, gamma=0.99,
                   bootstrap_values=boot)
    _, targets = gae(rew, val, done, last_v, gamma=0.99, lam=1.0,
                     bootstrap_values=boot)
    np.testing.assert_allclose(np.asarray(vs), np.asarray(targets),
                               rtol=1e-5, atol=1e-5)

    no_d = np.zeros((T, B), bool)
    v1, p1 = vtrace(lp, lp, rew, val, no_d, last_v, gamma=0.99)
    v2, p2 = vtrace(lp, lp, rew, val, no_d, last_v, gamma=0.99,
                    bootstrap_values=boot)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_train_step_smoke_and_reproducible():
    import jax

    trainer = make_tiny_trainer()
    rs1 = trainer.init(jax.random.PRNGKey(7))
    rs2 = trainer.init(jax.random.PRNGKey(7))
    for _ in range(2):
        rs1, m1 = trainer.train_step(rs1)
        rs2, m2 = trainer.train_step(rs2)
    assert int(rs1.update_idx) == 2
    for k, v in m1.items():
        assert np.isfinite(float(v)), f"{k} not finite"
    assert float(m1["entropy"]) > 0
    for a, b in zip(jax.tree.leaves(rs1.params), jax.tree.leaves(rs2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(m1["loss"]) == float(m2["loss"])


def test_multi_pass_replay_changes_params_more():
    """impala_passes=2 replays the rollout: must differ from 1 pass but
    stay finite (V-trace handles the staleness)."""
    import jax

    t1 = make_tiny_trainer(impala_passes=1)
    t2 = make_tiny_trainer(impala_passes=2)
    rs1 = t1.init(jax.random.PRNGKey(5))
    rs2 = t2.init(jax.random.PRNGKey(5))
    rs1, _ = t1.train_step(rs1)
    rs2, m2 = t2.train_step(rs2)
    for v in m2.values():
        assert np.isfinite(float(v))
    same = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(rs1.params),
                        jax.tree.leaves(rs2.params))
    )
    assert not same


@pytest.mark.slow
def test_impala_learns_tiny_env():
    """Deliveries/env-step must improve vs the untrained policy."""
    import jax

    trainer = make_tiny_trainer(
        num_envs=64, unroll_length=16, num_updates=60,
        learning_rate=3e-3, entropy_coef=0.003, impala_rmsprop=False,
    )
    rs = trainer.init(jax.random.PRNGKey(0))
    rs, m0 = trainer.train_step(rs)
    first = float(m0["deliveries_per_env_step"])
    rs, ms = trainer.train_many(rs, 59)
    last = float(np.mean(np.asarray(ms["deliveries_per_env_step"])[-10:]))
    assert last > first * 1.3, (first, last)


def test_meshed_train_step_runs():
    import jax

    from warehouse_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:4])
    trainer = make_tiny_trainer(mesh=mesh, num_envs=16)
    rs = trainer.init_global(jax.random.PRNGKey(2))
    rs, m = trainer.train_step(rs)
    for k, v in m.items():
        assert np.isfinite(float(v)), f"{k} not finite"
    # Params stay replicated across shards after the pmean'd update.
    p0 = jax.tree.leaves(rs.params)[0]
    assert p0.sharding.is_fully_replicated


def test_impala_micro_batches_match():
    """Env-axis micro-grad accumulation == the full minibatch grad
    (exact for V-trace; TrainConfig.micro_batches)."""
    import jax
    import numpy as np

    from warehouse_tpu import TrainConfig, small_config
    from warehouse_tpu.train.impala import make_train_impala

    cfg = small_config(max_steps=16)
    base = TrainConfig(num_envs=16, unroll_length=4, num_minibatches=2,
                       hidden_dim=32)
    t1 = make_train_impala(cfg, base)
    t4 = make_train_impala(cfg, base.replace(micro_batches=4))
    r1 = t1.init(jax.random.PRNGKey(3))
    r4 = t4.init(jax.random.PRNGKey(3))
    for _ in range(2):
        r1, m1 = t1.train_step(r1)
        r4, m4 = t4.train_step(r4)
    for a, b in zip(jax.tree.leaves(r1.params), jax.tree.leaves(r4.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-6)
    for k in m1:
        assert abs(float(m1[k]) - float(m4[k])) < 1e-4, k


def test_impala_rmsprop_default_warns_at_build(caplog):
    """The canonical-RMSProp default is measured NOT to learn this env
    at few-hundred-update horizons (r4 curves) — building with it must
    WARN and point at --impala-adam; the Adam
    variant must stay silent."""
    import logging

    with caplog.at_level(logging.WARNING, logger="warehouse_tpu"):
        make_tiny_trainer(impala_rmsprop=True)
    assert any("impala-adam" in r.message for r in caplog.records
               if r.levelno == logging.WARNING)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="warehouse_tpu"):
        make_tiny_trainer(impala_rmsprop=False)
    assert not any("impala-adam" in r.message for r in caplog.records)

"""Policy model shape/dtype tests."""

import numpy as np
import pytest

from warehouse_tpu import medium_config
from warehouse_tpu.models import make_model


def test_mlp_shapes():
    import jax
    import jax.numpy as jnp

    cfg = medium_config()
    model = make_model(cfg, arch="mlp", hidden_dim=32)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, cfg.obs_dim)))
    obs = jnp.zeros((7, cfg.num_agents, cfg.obs_dim))
    logits, value = model.apply(params, obs)
    assert logits.shape == (7, cfg.num_agents, 5)
    assert value.shape == (7, cfg.num_agents)
    assert logits.dtype == jnp.float32


def test_cnn_shapes():
    import jax
    import jax.numpy as jnp

    cfg = medium_config()
    model = make_model(cfg, arch="cnn", hidden_dim=32)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, cfg.obs_dim)))
    obs = jnp.zeros((3, cfg.obs_dim))
    logits, value = model.apply(params, obs)
    assert logits.shape == (3, 5)
    assert value.shape == (3,)


def test_cnn_global_obs():
    import jax
    import jax.numpy as jnp

    cfg = medium_config(global_obs=True)
    model = make_model(cfg, arch="cnn", hidden_dim=32)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, cfg.obs_dim)))
    logits, value = model.apply(params, jnp.zeros((2, cfg.obs_dim)))
    assert logits.shape == (2, 5)


def test_model_on_real_obs():
    import jax

    from warehouse_tpu.env import reset

    cfg = medium_config()
    state, obs = reset(cfg, jax.random.PRNGKey(0))
    model = make_model(cfg)
    params = model.init(jax.random.PRNGKey(1), obs)
    logits, value = model.apply(params, obs)
    assert np.isfinite(np.asarray(logits)).all()
    assert np.isfinite(np.asarray(value)).all()


def test_attn_shapes():
    import jax
    import jax.numpy as jnp

    cfg = medium_config()
    model = make_model(cfg, arch="attn", hidden_dim=64, num_layers=2)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, cfg.obs_dim)))
    obs = jnp.zeros((7, cfg.num_agents, cfg.obs_dim))
    logits, value = model.apply(params, obs)
    assert logits.shape == (7, cfg.num_agents, 5)
    assert value.shape == (7, cfg.num_agents)
    assert logits.dtype == jnp.float32


def test_attn_global_obs_and_jit():
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.env import reset

    cfg = medium_config(global_obs=True)
    state, obs = reset(cfg, jax.random.PRNGKey(0))
    model = make_model(cfg, arch="attn", hidden_dim=64)
    params = model.init(jax.random.PRNGKey(1), obs)
    logits, value = jax.jit(model.apply)(params, obs)
    assert np.isfinite(np.asarray(logits)).all()
    assert np.isfinite(np.asarray(value)).all()


def test_attn_ppo_train_step():
    import jax

    from warehouse_tpu import TrainConfig, small_config
    from warehouse_tpu.train.ppo import make_train

    cfg = small_config(max_steps=8)
    t = TrainConfig(num_envs=8, unroll_length=4, num_updates=2,
                    num_minibatches=2, ppo_epochs=1, hidden_dim=32,
                    num_layers=1)
    trainer = make_train(cfg, t, arch="attn")
    rs = trainer.init(jax.random.PRNGKey(0))
    rs, metrics = trainer.train_step(rs)
    assert int(rs.update_idx) == 1
    assert np.isfinite(float(metrics["loss"]))


ARCHS = ["mlp", "cnn", "attn", "gru", "lstm"]


def _model_and_inputs(arch, dtype, hidden=32, global_obs=False, seed=0):
    """A model, its params, real env observations [B, A, D] and, for the
    recurrent archs, a non-zero carry."""
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.env.batch import reset_batch

    cfg = medium_config(global_obs=global_obs)
    model = make_model(cfg, arch=arch, hidden_dim=hidden, dtype=dtype)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed), i))(jnp.arange(6))
    _, obs = reset_batch(cfg, keys)
    extra = ()
    init_extra = ()
    if arch in ("gru", "lstm"):
        init_extra = (model.initial_carry((1,)),)
        extra = (jax.tree.map(
            lambda c: (0.5 * jax.random.normal(
                jax.random.PRNGKey(seed + 1), c.shape)).astype(c.dtype),
            model.initial_carry(obs.shape[:2])),)
    params = model.init(jax.random.PRNGKey(seed + 2), obs[0], *init_extra)
    return model, params, obs, extra, init_extra


def _max_rel_err(got, ref):
    import jax

    errs = []
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        g = np.asarray(g, np.float64)
        r = np.asarray(r, np.float64)
        assert g.shape == r.shape
        errs.append(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
    return max(errs)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 5e-2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_matches_float64_reference(arch, dtype, rtol):
    """Each plain-JAX policy against the independent NumPy float64
    forward (models/reference.py); float32 at "highest" precision."""
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.models.reference import reference_apply

    model, params, obs, extra, _ = _model_and_inputs(
        arch, getattr(jnp, dtype))
    with jax.default_matmul_precision("highest"):
        got = jax.jit(model.apply)(params, obs, *extra)
    ref = reference_apply(model, params, obs, *extra)
    assert _max_rel_err(got, ref) <= rtol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_matches_flax_modules(arch, dtype):
    """Same parameter tree (names, shapes, dtypes and init values from
    the same key) and the same outputs on identical params as the
    flax.linen modules the models replace."""
    pytest.importorskip("flax")
    import jax
    import jax.numpy as jnp

    from tests import _flax_policy as fp

    dt = getattr(jnp, dtype)
    model, params, obs, extra, init_extra = _model_and_inputs(arch, dt)
    old = fp.make_model(medium_config(), arch=arch, hidden_dim=32, dtype=dt)
    old_params = old.init(jax.random.PRNGKey(2), obs[0], *init_extra)
    assert (jax.tree.structure(old_params)
            == jax.tree.structure(params))
    for a, b in zip(jax.tree.leaves(old_params), jax.tree.leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with jax.default_matmul_precision("highest"):
        got = model.apply(params, obs, *extra)
        want = old.apply(params, obs, *extra)
    # attention differs only in where the 1/sqrt(d) scale and the
    # softmax's precision sit (jax.nn.dot_product_attention).
    tol = {"float32": 1e-5, "bfloat16": 5e-2}[dtype]
    assert _max_rel_err(got, want) <= (tol if arch == "attn" else 1e-6)


def test_multi_policy_matches_reference():
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.models import make_multi_policy_model
    from warehouse_tpu.models.reference import reference_apply

    cfg = medium_config()
    model = make_multi_policy_model(cfg, (0, 1, 1, 0), hidden_dim=32)
    obs = jax.random.uniform(jax.random.PRNGKey(0), (5, 4, cfg.obs_dim))
    params = model.init(jax.random.PRNGKey(1), obs[0],
                        jnp.zeros(1, jnp.int32))
    assert set(params["params"]) == {"policies_0", "policies_1"}
    gids = jnp.broadcast_to(jnp.array([0, 1, 1, 0]), (5, 4))
    with jax.default_matmul_precision("highest"):
        got = model.apply(params, obs, gids)
    assert _max_rel_err(got, reference_apply(model, params, obs,
                                             gids)) <= 1e-5


@pytest.mark.parametrize("module", [
    "warehouse_tpu.train.ppo", "warehouse_tpu.train.checkpoint",
    "warehouse_tpu.train.ppo_rnn", "warehouse_tpu.train.impala",
])
def test_main_path_imports_without_flax_or_orbax(module):
    """flax and orbax are optional: with both blocked, the main path
    imports and a policy initializes and runs."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('flax', 'orbax', 'orbax.checkpoint'):\n"
        "    sys.modules[m] = None\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        f"import {module}\n"
        "from warehouse_tpu import small_config\n"
        "from warehouse_tpu.models import make_model\n"
        "cfg = small_config()\n"
        "m = make_model(cfg, hidden_dim=8)\n"
        "p = m.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, cfg.obs_dim)))\n"
        "print(m.apply(p, jax.numpy.zeros((2, cfg.obs_dim)))[0].shape)\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("(2, 5)")

"""Recurrent PPO actor-learner (GRU/LSTM policies, SURVEY.md C12).

Capability parity with RLlib's ``use_lstm`` training path [API]: the
policy's recurrent carry is threaded through the on-device rollout scan,
zeroed at episode boundaries, and the PPO loss replays each minibatch
SEQUENCE-wise (scan over T from the stored rollout-start carry) instead
of flattening transitions — the standard recurrent-PPO recipe. Same
Anakin single-program architecture and shard_map data parallelism as the
feedforward trainer (``train/ppo.py``); minibatches are slices of the
env axis so sequences stay contiguous in time.

Shares TrainConfig: ``mask_actions``, ``shaping_coef``,
``entropy_coef_final``, adaptive KL and LR annealing all work here too.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS, EnvConfig, TrainConfig
from ..env import engine
from ..env.batch import step_autoreset_batch
from ..models import make_model
from ..ops.gae import gae
from ..ops.move import valid_action_mask
from ..ops.pathing import potential
from ..ops.ppo_update import (
    NEG_INF,
    adaptive_kl_coeff,
    entropy_coef_at,
    minibatch_epochs,
    ppo_losses,
    sample_action,
)
from ..parallel.mesh import DATA_AXIS
from ..pytree import pytree_dataclass
from .ppo import PPOTrainer, Transition


@pytree_dataclass
class RunnerStateRNN:
    params: Any
    opt_state: Any
    env_state: Any
    obs: jax.Array          # float32[B_local, A, obs_dim]
    carry: Any              # recurrent carry pytree, leaves [B_local, A, H]
    key: jax.Array          # uint32[n_shards, 2]
    update_idx: jax.Array
    kl_coeff: jax.Array


def make_train_rnn(
    env_cfg: EnvConfig,
    tcfg: TrainConfig,
    arch: str = "gru",
    mesh=None,
):
    """Recurrent twin of ``ppo.make_train``; arch is "gru" or "lstm"."""
    env_cfg = env_cfg.replace(auto_reset=True)
    model_dtype = (
        jnp.bfloat16 if tcfg.model_dtype == "bfloat16" else jnp.float32
    )
    model = make_model(env_cfg, arch=arch, hidden_dim=tcfg.hidden_dim,
                       num_layers=tcfg.num_layers, dtype=model_dtype)

    n_shards = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if tcfg.num_envs % max(n_shards, 1):
        raise ValueError(
            f"num_envs={tcfg.num_envs} not divisible by {n_shards} shards"
        )
    b_local = tcfg.num_envs // n_shards
    if b_local % tcfg.num_minibatches:
        raise ValueError(
            "recurrent PPO minibatches slice the env axis: B_local="
            f"{b_local} must divide into {tcfg.num_minibatches} minibatches"
        )
    mb_envs = b_local // tcfg.num_minibatches

    # epoch_shuffle="once" is implemented as a pre-rollout env-STATE
    # permutation + contiguous env-slice minibatches (same trick as the
    # feed-forward trainer): composition distribution is identical to
    # the post-rollout env-axis gather, but the gather of the full
    # [T, B, A, D] trajectory (the RNN path's biggest layout cost)
    # disappears entirely.
    use_state_shuffle = tcfg.epoch_shuffle == "once"

    if tcfg.anneal_lr:
        total_steps = (
            tcfg.num_updates * tcfg.ppo_epochs * tcfg.num_minibatches
        )
        lr = optax.linear_schedule(tcfg.learning_rate, 0.0, total_steps)
    else:
        lr = tcfg.learning_rate
    tx = optax.chain(
        optax.clip_by_global_norm(tcfg.max_grad_norm),
        optax.adam(lr, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS),
    )
    if tcfg.flat_optimizer:
        tx = optax.flatten(tx)

    A = env_cfg.num_agents

    # ---------------------------------------------------------------- init
    def init(key: jax.Array) -> RunnerStateRNN:
        pkey, ekey, skey = jax.random.split(key, 3)
        dummy_obs = jnp.zeros((1, env_cfg.obs_dim), jnp.float32)
        dummy_carry = model.initial_carry((1,))
        params = model.init(pkey, dummy_obs, dummy_carry)
        opt_state = tx.init(params)
        env_keys = jax.vmap(
            lambda i: jax.random.fold_in(ekey, i)
        )(jnp.arange(tcfg.num_envs))
        env_state, obs = jax.vmap(lambda k: engine.reset(env_cfg, k))(env_keys)
        carry = model.initial_carry((tcfg.num_envs, A))
        shard_keys = jax.vmap(
            lambda i: jax.random.fold_in(skey, i)
        )(jnp.arange(max(n_shards, 1)))
        return RunnerStateRNN(
            params=params, opt_state=opt_state, env_state=env_state,
            obs=obs, carry=carry, key=shard_keys,
            update_idx=jnp.int32(0), kl_coeff=jnp.float32(tcfg.kl_coeff),
        )

    def _apply_mask(env_state, logits):
        mask = jax.vmap(
            lambda p: valid_action_mask(env_cfg, p)
        )(env_state.agent_pos)
        return mask, jnp.where(mask, logits, -1e9)

    # -------------------------------------------------------- one update
    def _train_step_local(rs: RunnerStateRNN):
        params = rs.params
        key = rs.key.reshape(2)
        h0 = rs.carry  # rollout-start carry, saved for the loss replay

        env_state_in, obs_in = rs.env_state, rs.obs
        if use_state_shuffle:
            # Shuffle the envs, not the data (see make_train_rnn note).
            pkey = jax.random.fold_in(key, 0x5EED)
            perm = jax.random.permutation(pkey, b_local)
            env_state_in = jax.tree.map(lambda x: x[perm], env_state_in)
            obs_in = obs_in[perm]
            h0 = jax.tree.map(lambda x: x[perm], h0)

        def env_step(cr, _):
            env_state, obs, h, key = cr
            key, akey = jax.random.split(key)
            logits, value, h_new = model.apply(params, obs, h)
            if tcfg.mask_actions:
                mask, logits = _apply_mask(env_state, logits)
            else:
                mask = jnp.ones(logits.shape, bool)
            action, log_prob = sample_action(akey, logits)
            if tcfg.shaping_coef > 0.0:
                phi = jax.vmap(lambda s: potential(env_cfg, s))(env_state)
            env_state, ts = step_autoreset_batch(
                env_cfg, env_state, action.astype(jnp.int32)
            )
            done = jnp.broadcast_to(ts.truncated[:, None], ts.reward.shape)
            reward = ts.reward
            if tcfg.shaping_coef > 0.0:
                phi_next = jax.vmap(
                    lambda s: potential(env_cfg, s)
                )(env_state)
                reward = reward + tcfg.shaping_coef * (
                    tcfg.gamma * phi_next * (1.0 - done) - phi
                )
            if tcfg.bootstrap_truncated:
                # V of the true successor state, with the PRE-reset carry
                # (the recurrent state that actually saw the episode).
                _, boot_value, _ = model.apply(params, ts.final_obs, h_new)
            else:
                boot_value = jnp.zeros_like(value)
            # Episode boundary: next step starts a fresh episode (the
            # engine auto-reset), so the recurrent carry resets with it.
            h_new = jax.tree.map(
                lambda x: jnp.where(done[..., None], 0.0, x), h_new
            )
            tr = Transition(obs, action, log_prob, value, reward, done,
                            mask, boot_value)
            return (env_state, ts.obs, h_new, key), (tr, ts.delivered,
                                                     ts.reward.mean())

        (env_state, last_obs, last_h, key), (traj, delivered, raw_rew) = (
            jax.lax.scan(
                env_step, (env_state_in, obs_in, h0, key), None,
                length=tcfg.unroll_length,
            )
        )
        return _learn(rs, params, key, env_state, last_obs, last_h, h0,
                      traj, delivered, raw_rew)

    # ---------------------------------------------- learn phase (shared)
    def _learn(rs, params, key, env_state, last_obs, last_h, h0, traj,
               delivered, raw_rew):
        _, last_value, _ = model.apply(params, last_obs, last_h)
        advantages, targets = gae(
            traj.reward, traj.value, traj.done, last_value,
            tcfg.gamma, tcfg.gae_lambda,
            bootstrap_values=(
                traj.boot_value if tcfg.bootstrap_truncated else None
            ),
        )

        ent_coef = entropy_coef_at(tcfg, rs.update_idx)

        # Sequence batch: [T, B_local, A, ...]; h0 is per-sequence
        # [B_local, ...] and minibatched separately (different env axis).
        seq_batch = (traj.obs, traj.action, traj.log_prob, traj.value,
                     advantages, targets, traj.mask, traj.done)

        def loss_fn(params, mb):
            (obs, action, old_lp, old_v, adv, tgt, mask, done), h_init = mb

            def cell_step(h, xs):
                obs_t, mask_t, done_t = xs
                logits, value, h_new = model.apply(params, obs_t, h)
                if tcfg.mask_actions:
                    logits = jnp.where(mask_t, logits, NEG_INF)
                h_new = jax.tree.map(
                    lambda x: jnp.where(done_t[..., None], 0.0, x), h_new
                )
                return h_new, (logits, value)

            _, (logits, value) = jax.lax.scan(
                cell_step, h_init, (obs, mask, done)
            )
            return ppo_losses(
                logits, value, action, old_lp, old_v, adv, tgt,
                clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
                ent_coef=ent_coef, kl_coeff=rs.kl_coeff,
            )

        def make_minibatches(pkey):
            """Sequence minibatches: slice the ENV axis so each sequence
            stays contiguous in time; h0 is minibatched along with it.
            With state-shuffle (epoch_shuffle='once'), composition was
            already randomized by the pre-rollout env permutation and
            the slices are CONTIGUOUS — no trajectory gather at all."""
            if use_state_shuffle:
                perm = None
            else:
                perm = jax.random.permutation(pkey, b_local)

            def split_seq(x):        # [T, B, ...] → [M, T, B/M, ...]
                xp = x if perm is None else x[:, perm]
                sh = xp.reshape(
                    x.shape[0], tcfg.num_minibatches, mb_envs, *x.shape[2:]
                )
                return jnp.moveaxis(sh, 1, 0)

            def split_h0(x):         # [B, ...] → [M, B/M, ...]
                xp = x if perm is None else x[perm]
                return xp.reshape(
                    tcfg.num_minibatches, mb_envs, *x.shape[1:]
                )

            return (
                jax.tree.map(split_seq, seq_batch),
                jax.tree.map(split_h0, h0),
            )

        params, opt_state, key, losses = minibatch_epochs(
            params, rs.opt_state, key,
            loss_fn=loss_fn,
            make_minibatches=make_minibatches,
            num_epochs=tcfg.ppo_epochs,
            tx=tx,
            pmean_axis=DATA_AXIS if mesh is not None else None,
            reshuffle_each_epoch=(tcfg.epoch_shuffle == "each"),
        )
        return _metrics_tail(rs, params, opt_state, key, env_state,
                             last_obs, last_h, losses, delivered,
                             raw_rew)

    # ------------------------------------- metrics + new state (shared)
    def _metrics_tail(rs, params, opt_state, key, env_state, last_obs,
                      last_h, losses, delivered, raw_rew):
        mean_kl = losses[4].mean()
        if mesh is not None:
            mean_kl = jax.lax.pmean(mean_kl, DATA_AXIS)
        kl_coeff = adaptive_kl_coeff(tcfg, rs.kl_coeff, mean_kl)

        mean_reward = raw_rew.mean()
        deliveries = delivered.sum(dtype=jnp.float32) / (
            tcfg.unroll_length * b_local
        )
        if mesh is not None:
            mean_reward = jax.lax.pmean(mean_reward, DATA_AXIS)
            deliveries = jax.lax.pmean(deliveries, DATA_AXIS)
        metrics = {
            "loss": losses[0].mean(),
            "pg_loss": losses[1].mean(),
            "v_loss": losses[2].mean(),
            "entropy": losses[3].mean(),
            "kl": mean_kl,
            "kl_coeff": kl_coeff,
            "reward_per_step": mean_reward,
            "deliveries_per_env_step": deliveries,
        }
        new_rs = RunnerStateRNN(
            params=params, opt_state=opt_state, env_state=env_state,
            obs=last_obs, carry=last_h, key=key.reshape(1, 2),
            update_idx=rs.update_idx + 1, kl_coeff=kl_coeff,
        )
        return new_rs, metrics

    # -------------------------------------------------- jit / shard_map
    init_global = init
    if mesh is None:
        train_step = jax.jit(_train_step_local)
    else:
        state_spec = RunnerStateRNN(
            params=P(), opt_state=P(), env_state=P(DATA_AXIS),
            obs=P(DATA_AXIS), carry=P(DATA_AXIS), key=P(DATA_AXIS),
            update_idx=P(), kl_coeff=P(),
        )
        metric_spec = {
            "loss": P(), "pg_loss": P(), "v_loss": P(), "entropy": P(),
            "kl": P(), "kl_coeff": P(),
            "reward_per_step": P(), "deliveries_per_env_step": P(),
        }
        train_step = jax.jit(
            jax.shard_map(
                _train_step_local, mesh=mesh,
                in_specs=(state_spec,), out_specs=(state_spec, metric_spec),
                check_vma=False,
            )
        )
        from jax.sharding import NamedSharding

        out_shardings = jax.tree.map(
            lambda spec: NamedSharding(mesh, spec),
            state_spec,
            is_leaf=lambda x: isinstance(x, P),
        )
        init_global = jax.jit(init, out_shardings=out_shardings)

    def shard_runner_state(rs: RunnerStateRNN) -> RunnerStateRNN:
        if mesh is None:
            return rs
        from jax.sharding import NamedSharding

        def put(x, spec):
            return jax.device_put(x, NamedSharding(mesh, spec))

        return RunnerStateRNN(
            params=put(rs.params, P()),
            opt_state=put(rs.opt_state, P()),
            env_state=jax.tree.map(
                lambda x: put(x, P(DATA_AXIS)), rs.env_state
            ),
            obs=put(rs.obs, P(DATA_AXIS)),
            carry=jax.tree.map(lambda x: put(x, P(DATA_AXIS)), rs.carry),
            key=put(rs.key, P(DATA_AXIS)),
            update_idx=put(rs.update_idx, P()),
            kl_coeff=put(rs.kl_coeff, P()),
        )

    @partial(jax.jit, static_argnums=1)
    def train_many(rs: RunnerStateRNN, n: int):
        return jax.lax.scan(lambda r, _: train_step(r), rs, None, length=n)

    return PPOTrainer(
        init=init, init_global=init_global, train_step=train_step,
        train_many=train_many, shard_runner_state=shard_runner_state,
        model=model, tx=tx, env_cfg=env_cfg, tcfg=tcfg, mesh=mesh,
    )

"""On-device PPO actor-learner (SURVEY.md §3.4, §7 PR4).

Anakin-style architecture (cf. PAPERS.md "Large Batch Simulation for Deep
RL"): the same chips alternate acting — a ``lax.scan`` of (policy forward,
env step) over the unroll length — and learning — GAE + clipped-PPO
minibatch epochs — inside ONE jitted program. This collapses the
reference stack's RolloutWorker-actors/learner-driver split (SURVEY.md
§3.1) and removes every host↔device trajectory transfer.

Multi-device: the whole train step runs under ``shard_map`` over the
``data`` mesh axis — env batch sharded, params replicated, one grad
``pmean`` per update (SURVEY.md §2.4). One shared policy acts for all
agents (parameter sharing over the agent axis, SURVEY.md C12).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

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
    flat_minibatches,
    minibatch_epochs,
    ppo_losses,
    sample_action,
)
from ..parallel.mesh import DATA_AXIS
from ..pytree import pytree_dataclass


@pytree_dataclass
class RunnerState:
    params: Any
    opt_state: Any
    env_state: Any          # EnvState with leading [B_local] (sharded)
    obs: jax.Array          # float32[B_local, A, obs_dim] (sharded)
    key: jax.Array          # uint32[n_shards, 2] (sharded: one key/shard)
    update_idx: jax.Array   # int32 (replicated)
    kl_coeff: jax.Array     # float32 (replicated; adaptive KL penalty)


class Transition(NamedTuple):
    obs: jax.Array
    action: jax.Array
    log_prob: jax.Array
    value: jax.Array
    reward: jax.Array      # shaped reward when shaping_coef > 0 (GAE input)
    done: jax.Array
    mask: jax.Array        # bool[..., 5] valid-action mask (all-True if off)
    boot_value: jax.Array  # V(final_obs): truncation bootstrap (0 if off)


def make_train(
    env_cfg: EnvConfig,
    tcfg: TrainConfig,
    arch: str = "mlp",
    mesh=None,
    policy_groups: tuple | None = None,
):
    """Build (init_fn, train_step_fn, model, tx).

    With ``mesh``: ``init(key)`` returns a sharded RunnerState and
    ``train_step`` is a jitted shard_map over the ``data`` axis.
    Without: single-device jit. ``num_envs`` is the GLOBAL batch.

    ``policy_groups``: optional tuple of length num_agents mapping each
    agent to a policy group 0..K-1 — trains K independent policies
    (RLlib policy_mapping_fn capability). Default: one shared policy.
    """
    env_cfg = env_cfg.replace(auto_reset=True)
    model_dtype = (
        jnp.bfloat16 if tcfg.model_dtype == "bfloat16" else jnp.float32
    )
    if policy_groups is not None:
        from ..models import make_multi_policy_model

        model = make_multi_policy_model(
            env_cfg, policy_groups, arch=arch,
            hidden_dim=tcfg.hidden_dim, num_layers=tcfg.num_layers,
            dtype=model_dtype,
        )
        groups_arr = jnp.array(policy_groups, jnp.int32)

        def apply_model(params, obs, gids):
            return model.apply(params, obs, gids)

    else:
        model = make_model(env_cfg, arch=arch, hidden_dim=tcfg.hidden_dim,
                           num_layers=tcfg.num_layers, dtype=model_dtype)
        groups_arr = jnp.zeros(env_cfg.num_agents, jnp.int32)

        def apply_model(params, obs, gids):
            return model.apply(params, obs)

    n_shards = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if tcfg.num_envs % max(n_shards, 1):
        raise ValueError(
            f"num_envs={tcfg.num_envs} not divisible by {n_shards} shards"
        )
    b_local = tcfg.num_envs // n_shards
    batch_per_shard = tcfg.unroll_length * b_local * env_cfg.num_agents
    if batch_per_shard % tcfg.num_minibatches:
        raise ValueError("T*B_local*A must divide into num_minibatches")
    if tcfg.minibatch_mode not in ("flat", "env"):
        raise ValueError(
            f"minibatch_mode must be 'flat' or 'env', got "
            f"{tcfg.minibatch_mode!r}")
    if tcfg.epoch_shuffle not in ("each", "once"):
        raise ValueError(
            f"epoch_shuffle must be 'each' or 'once', got "
            f"{tcfg.epoch_shuffle!r}")
    if tcfg.minibatch_mode == "env" and b_local % tcfg.num_minibatches:
        raise ValueError(
            f"minibatch_mode='env' needs B_local={b_local} divisible by "
            f"num_minibatches={tcfg.num_minibatches}")
    mb_samples = batch_per_shard // tcfg.num_minibatches
    if tcfg.micro_batches < 1 or mb_samples % tcfg.micro_batches:
        raise ValueError(
            f"micro_batches={tcfg.micro_batches} must divide the "
            f"minibatch sample count {mb_samples}")

    # env/once minibatching is implemented as a pre-rollout env-STATE
    # permutation + contiguous minibatch ranges (see _train_step_local);
    # identical composition distribution to the post-rollout gather,
    # with the gather's read+write traffic gone entirely.
    use_state_shuffle = (
        tcfg.minibatch_mode == "env" and tcfg.epoch_shuffle == "once"
    )

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

    # ---------------------------------------------------------------- init
    def init(key: jax.Array) -> RunnerState:
        pkey, ekey, skey = jax.random.split(key, 3)
        dummy = jnp.zeros((1, env_cfg.obs_dim), jnp.float32)
        if policy_groups is not None:
            params = model.init(pkey, dummy, jnp.zeros(1, jnp.int32))
        else:
            params = model.init(pkey, dummy)
        opt_state = tx.init(params)
        env_keys = jax.vmap(
            lambda i: jax.random.fold_in(ekey, i)
        )(jnp.arange(tcfg.num_envs))
        env_state, obs = jax.vmap(lambda k: engine.reset(env_cfg, k))(env_keys)
        shard_keys = jax.vmap(
            lambda i: jax.random.fold_in(skey, i)
        )(jnp.arange(max(n_shards, 1)))
        return RunnerState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=obs,
            key=shard_keys,
            update_idx=jnp.int32(0),
            kl_coeff=jnp.float32(tcfg.kl_coeff),
        )

    # -------------------------------------------------------- one update
    def _train_step_local(rs: RunnerState):
        """One PPO update on this shard's slice; pmean over `data` if meshed."""
        params = rs.params
        key = rs.key.reshape(2)  # this shard's key (uint32[1, 2] block)

        env_state_in, obs_in = rs.env_state, rs.obs
        if use_state_shuffle:
            # "Shuffle the envs, not the data": permute the env axis of
            # the STATE once per update, then take minibatches as
            # CONTIGUOUS env ranges — random env sets with the same
            # composition distribution as the env-mode permutation
            # gather (env slots are exchangeable; each env's trajectory
            # rides its own state key), at ~1000x less gathered bytes.
            # This is how minibatch_mode="env" + epoch_shuffle="once"
            # is implemented for this trainer.
            # fold_in (not split): the main draw stream is unadvanced.
            pkey = jax.random.fold_in(key, 0x5EED)
            perm = jax.random.permutation(pkey, b_local)
            env_state_in = jax.tree.map(lambda x: x[perm], env_state_in)
            obs_in = obs_in[perm]

        # Per-sample policy-group ids, broadcast over the env batch.
        gids_ba = jnp.broadcast_to(
            groups_arr[None, :], (b_local, env_cfg.num_agents)
        )

        def env_step(carry, _):
            env_state, obs, key = carry
            key, akey = jax.random.split(key)
            logits, value = apply_model(params, obs, gids_ba)
            if tcfg.mask_actions:
                mask = jax.vmap(
                    lambda p: valid_action_mask(env_cfg, p)
                )(env_state.agent_pos)                        # [B, A, 5]
                logits = jnp.where(mask, logits, NEG_INF)
            else:
                mask = jnp.ones(logits.shape, bool)
            action, log_prob = sample_action(akey, logits)  # [B, A]
            if tcfg.shaping_coef > 0.0:
                phi = jax.vmap(lambda s: potential(env_cfg, s))(env_state)
            env_state, ts = step_autoreset_batch(
                env_cfg, env_state, action.astype(jnp.int32)
            )
            done = jnp.broadcast_to(
                ts.truncated[:, None], ts.reward.shape
            )  # [B, A]
            reward = ts.reward
            if tcfg.shaping_coef > 0.0:
                # γ·φ(s')·(1−done) − φ(s): on auto-reset ticks the next
                # state belongs to a fresh episode, so its potential is
                # cut (standard terminal handling).
                phi_next = jax.vmap(
                    lambda s: potential(env_cfg, s)
                )(env_state)
                reward = reward + tcfg.shaping_coef * (
                    tcfg.gamma * phi_next * (1.0 - done) - phi
                )
            if tcfg.bootstrap_truncated:
                # V of the TRUE successor (pre-auto-reset) state, used by
                # GAE as the next-state value at truncation boundaries.
                _, boot_value = apply_model(params, ts.final_obs, gids_ba)
            else:
                boot_value = jnp.zeros_like(value)
            tr = Transition(obs, action, log_prob, value, reward, done,
                            mask, boot_value)
            return (env_state, ts.obs, key), (tr, ts.delivered,
                                              ts.reward.mean())

        (env_state, last_obs, key), (traj, delivered, raw_rew) = jax.lax.scan(
            env_step, (env_state_in, obs_in, key), None,
            length=tcfg.unroll_length,
        )
        return _learn(rs, params, key, env_state, last_obs, traj,
                      delivered, raw_rew)

    # ---------------------------------------------- learn phase (shared)
    def _learn(rs, params, key, env_state, last_obs, traj, delivered,
               raw_rew):
        gids_ba = jnp.broadcast_to(
            groups_arr[None, :], (b_local, env_cfg.num_agents)
        )
        _, last_value = apply_model(params, last_obs, gids_ba)
        advantages, targets = gae(
            traj.reward, traj.value, traj.done, last_value,
            tcfg.gamma, tcfg.gae_lambda,
            bootstrap_values=(
                traj.boot_value if tcfg.bootstrap_truncated else None
            ),
        )

        gids_tba = jnp.broadcast_to(
            gids_ba[None], (tcfg.unroll_length, *gids_ba.shape)
        )
        fields = (
            traj.obs, traj.action, traj.log_prob, traj.value,
            advantages, targets, gids_tba, traj.mask,
        )
        if tcfg.minibatch_mode == "env":
            # Env-major layout [B, T·A, ...]: the epoch shuffle becomes a
            # B-row gather (~64x fewer rows than the flat T·B·A gather;
            # see TrainConfig.minibatch_mode).
            ta = tcfg.unroll_length * env_cfg.num_agents
            mb_envs = b_local // tcfg.num_minibatches

            def envmajor(x):
                x = jnp.moveaxis(x, 1, 0)  # [B, T, A, ...]
                return x.reshape(b_local, ta, *x.shape[3:])

            batch = tuple(envmajor(x) for x in fields)

            if use_state_shuffle:
                # Composition was already randomized by the env-STATE
                # permutation before the rollout: minibatches are plain
                # contiguous env ranges — no gather at all. (The pkey
                # minibatch_epochs hands us is unused by construction.)
                def make_minibatches(k):
                    return jax.tree.map(
                        lambda x: x.reshape(
                            tcfg.num_minibatches, mb_envs * ta,
                            *x.shape[2:]
                        ),
                        batch,
                    )

            else:
                def make_minibatches(k):
                    perm = jax.random.permutation(k, b_local)
                    return jax.tree.map(
                        lambda x: x[perm].reshape(
                            tcfg.num_minibatches, mb_envs * ta,
                            *x.shape[2:]
                        ),
                        batch,
                    )

        else:
            # Flatten [T, B, A] → [N]; epochs re-permute all samples.
            def flat(x):
                return x.reshape(batch_per_shard, *x.shape[3:])

            batch = tuple(flat(x) for x in fields)

            def make_minibatches(k):
                return flat_minibatches(k, batch, tcfg.num_minibatches)

        ent_coef = entropy_coef_at(tcfg, rs.update_idx)

        if tcfg.micro_batches > 1:
            # Hoist advantage normalization to per-minibatch so micro
            # grads average to exactly the minibatch grad (see
            # TrainConfig.micro_batches / minibatch_epochs).
            inner_minibatches = make_minibatches

            def make_minibatches(k):  # noqa: F811
                mbs = inner_minibatches(k)
                adv = mbs[4]
                ax = tuple(range(1, adv.ndim))
                mean = adv.mean(axis=ax, keepdims=True)
                std = adv.std(axis=ax, keepdims=True)
                return (*mbs[:4], (adv - mean) / (std + 1e-8), *mbs[5:])

        def loss_fn(params, mb):
            obs, action, old_lp, old_v, adv, tgt, gids, mask = mb
            logits, value = apply_model(params, obs, gids)
            if tcfg.mask_actions:
                logits = jnp.where(mask, logits, NEG_INF)
            return ppo_losses(
                logits, value, action, old_lp, old_v, adv, tgt,
                clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
                ent_coef=ent_coef, kl_coeff=rs.kl_coeff,
                normalize_adv=(tcfg.micro_batches == 1),
            )

        params, opt_state, key, losses = minibatch_epochs(
            params, rs.opt_state, key,
            loss_fn=loss_fn,
            make_minibatches=make_minibatches,
            num_epochs=tcfg.ppo_epochs,
            tx=tx,
            pmean_axis=DATA_AXIS if mesh is not None else None,
            micro_batches=tcfg.micro_batches,
            reshuffle_each_epoch=(tcfg.epoch_shuffle == "each"),
        )
        return _finish(rs, params, opt_state, key, env_state, last_obs,
                       losses, delivered, raw_rew)

    # ------------------------------------- metrics + new state (shared)
    def _finish(rs, params, opt_state, key, env_state, last_obs,
                losses, delivered, raw_rew):
        mean_kl = losses[4].mean()
        if mesh is not None:
            mean_kl = jax.lax.pmean(mean_kl, DATA_AXIS)
        kl_coeff = adaptive_kl_coeff(tcfg, rs.kl_coeff, mean_kl)

        mean_reward = raw_rew.mean()  # raw env reward (pre-shaping)
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
        new_rs = RunnerState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=last_obs,
            key=key.reshape(1, 2),
            update_idx=rs.update_idx + 1,
            kl_coeff=kl_coeff,
        )
        return new_rs, metrics

    # -------------------------------------------------- jit / shard_map
    init_global = init
    if mesh is None:
        train_step = jax.jit(_train_step_local)
    else:
        state_spec = RunnerState(
            params=P(),
            opt_state=P(),
            env_state=P(DATA_AXIS),
            obs=P(DATA_AXIS),
            key=P(DATA_AXIS),
            update_idx=P(),
            kl_coeff=P(),
        )
        metric_spec = {
            "loss": P(), "pg_loss": P(), "v_loss": P(), "entropy": P(),
            "kl": P(), "kl_coeff": P(),
            "reward_per_step": P(), "deliveries_per_env_step": P(),
        }
        train_step = jax.jit(
            jax.shard_map(
                _train_step_local,
                mesh=mesh,
                in_specs=(state_spec,),
                out_specs=(state_spec, metric_spec),
                check_vma=False,
            )
        )
        # Multi-process-safe init: computed under jit with global output
        # shardings, so every host materializes only its addressable
        # shards (host device_put of a global array would fail).
        from jax.sharding import NamedSharding

        out_shardings = jax.tree.map(
            lambda spec: NamedSharding(mesh, spec),
            state_spec,
            is_leaf=lambda x: isinstance(x, P),
        )
        init_global = jax.jit(init, out_shardings=out_shardings)

    def shard_runner_state(rs: RunnerState) -> RunnerState:
        """Place an (unsharded) RunnerState onto the mesh."""
        if mesh is None:
            return rs
        from jax.sharding import NamedSharding

        def put(x, spec):
            return jax.device_put(x, NamedSharding(mesh, spec))

        return RunnerState(
            params=put(rs.params, P()),
            opt_state=put(rs.opt_state, P()),
            env_state=jax.tree.map(
                lambda x: put(x, P(DATA_AXIS)), rs.env_state
            ),
            obs=put(rs.obs, P(DATA_AXIS)),
            key=put(rs.key, P(DATA_AXIS)),
            update_idx=put(rs.update_idx, P()),
            kl_coeff=put(rs.kl_coeff, P()),
        )

    @partial(jax.jit, static_argnums=1)
    def train_many(rs: RunnerState, n: int):
        """Run n updates in one compiled scan; metrics stacked [n]."""
        return jax.lax.scan(lambda r, _: train_step(r), rs, None, length=n)

    return PPOTrainer(
        init=init,
        init_global=init_global,
        train_step=train_step,
        train_many=train_many,
        shard_runner_state=shard_runner_state,
        model=model,
        tx=tx,
        env_cfg=env_cfg,
        tcfg=tcfg,
        mesh=mesh,
        train_step_local=_train_step_local,
    )


class PPOTrainer(NamedTuple):
    init: Callable
    init_global: Callable   # jit-sharded init (multi-process safe)
    train_step: Callable
    train_many: Callable
    shard_runner_state: Callable
    model: Any
    tx: Any
    env_cfg: EnvConfig
    tcfg: TrainConfig
    mesh: Any
    # The per-shard update, un-jitted (make_train only): under
    # ``jax.vmap(..., axis_name=DATA_AXIS)`` over a leading shard axis
    # it reproduces the meshed ``train_step`` on one device.
    train_step_local: Callable | None = None

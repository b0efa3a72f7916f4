"""On-device IMPALA (V-trace) actor-learner — second algorithm family.

RLlib, the stack under the reference (SURVEY.md §1 L1, §3.1), ships
IMPALA alongside PPO; this is its on-device counterpart, sharing the
Anakin collapse of train/ppo.py: rollout (``lax.scan`` of policy+env)
and learning run inside ONE jitted program, sharded over the ``data``
mesh axis with a single grad ``pmean`` per update.

Differences from PPO here mirror the algorithms themselves:

- Off-policy correction is V-trace (ops/vtrace.py) instead of the
  clipped surrogate: importance ratios π/μ against the stored behavior
  log-probs, clipped at ρ̄/c̄.
- The loss is one pass of policy-gradient + 0.5·MSE(V, vs) + entropy —
  no PPO epochs/ratio clipping. ``impala_passes > 1`` replays the same
  rollout (then the data is genuinely stale and V-trace earns its keep).
- Minibatches split the ENV axis and keep the full unroll length T
  intact, because the V-trace trace runs along T (PPO can shuffle
  flattened [T·B·A] samples; V-trace cannot).
"""

from __future__ import annotations

import logging
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
from ..ops.move import valid_action_mask
from ..ops.ppo_update import action_log_prob_entropy, sample_action
from ..ops.vtrace import vtrace
from ..parallel.mesh import DATA_AXIS
from ..pytree import pytree_dataclass


@pytree_dataclass
class ImpalaRunnerState:
    params: Any
    opt_state: Any
    env_state: Any          # EnvState with leading [B_local] (sharded)
    obs: jax.Array          # float32[B_local, A, obs_dim] (sharded)
    key: jax.Array          # uint32[n_shards, 2] (sharded: one key/shard)
    update_idx: jax.Array   # int32 (replicated)


class ImpalaTransition(NamedTuple):
    obs: jax.Array
    action: jax.Array
    behavior_log_prob: jax.Array
    reward: jax.Array
    done: jax.Array
    mask: jax.Array         # bool[..., 5] valid-action mask (all-True if off)
    boot_value: jax.Array   # V(final_obs) under the BEHAVIOR params —
    #                         truncation bootstrap (0 when off). Evaluated
    #                         at act time: V-trace already tolerates
    #                         behavior/target lag, and storing the scalar
    #                         beats storing final_obs [T,B,A,obs_dim].


def make_train_impala(
    env_cfg: EnvConfig,
    tcfg: TrainConfig,
    arch: str = "mlp",
    mesh=None,
):
    """Build an ImpalaTrainer (same surface as train/ppo.py's PPOTrainer:
    init / init_global / train_step / train_many / shard_runner_state)."""
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
            f"B_local={b_local} must divide into num_minibatches="
            f"{tcfg.num_minibatches} (IMPALA minibatches split the env "
            "axis, keeping T intact)"
        )
    mb_envs_chk = b_local // tcfg.num_minibatches
    if tcfg.micro_batches < 1 or mb_envs_chk % tcfg.micro_batches:
        raise ValueError(
            f"micro_batches={tcfg.micro_batches} must divide the "
            f"per-minibatch env count {mb_envs_chk}")

    if tcfg.anneal_lr:
        total_steps = (
            tcfg.num_updates * tcfg.impala_passes * tcfg.num_minibatches
        )
        lr = optax.linear_schedule(tcfg.learning_rate, 0.0, total_steps)
    else:
        lr = tcfg.learning_rate
    # IMPALA's canonical optimizer is RMSProp (Espeholt et al. 2018 §4).
    # Kept as the default for paper parity, but it does NOT learn THIS
    # env at few-hundred-update horizons: eps=0.1 damps its small
    # gradients to a flat deliveries curve at BASELINE config 4, while
    # Adam reaches PPO's level. Warn at build so a short run is never
    # silently un-learning.
    if tcfg.impala_rmsprop:
        logging.getLogger("warehouse_tpu").warning(
            "IMPALA is using its canonical RMSProp (eps=0.1), which "
            "stays flat at few-hundred-update horizons on this env — "
            "pass --impala-adam / impala_rmsprop=False unless you are "
            "running the paper's long-horizon budget")
    tx = optax.chain(
        optax.clip_by_global_norm(tcfg.max_grad_norm),
        optax.rmsprop(lr, decay=0.99, eps=0.1)
        if tcfg.impala_rmsprop else optax.adam(
            lr, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS),
    )
    if tcfg.flat_optimizer:
        tx = optax.flatten(tx)

    # ---------------------------------------------------------------- init
    def init(key: jax.Array) -> ImpalaRunnerState:
        pkey, ekey, skey = jax.random.split(key, 3)
        dummy = jnp.zeros((1, env_cfg.obs_dim), jnp.float32)
        params = model.init(pkey, dummy)
        opt_state = tx.init(params)
        env_keys = jax.vmap(
            lambda i: jax.random.fold_in(ekey, i)
        )(jnp.arange(tcfg.num_envs))
        env_state, obs = jax.vmap(lambda k: engine.reset(env_cfg, k))(env_keys)
        shard_keys = jax.vmap(
            lambda i: jax.random.fold_in(skey, i)
        )(jnp.arange(max(n_shards, 1)))
        return ImpalaRunnerState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=obs,
            key=shard_keys,
            update_idx=jnp.int32(0),
        )

    # -------------------------------------------------------- one update
    def _train_step_local(rs: ImpalaRunnerState):
        params = rs.params
        key = rs.key.reshape(2)

        def env_step(carry, _):
            env_state, obs, key = carry
            key, akey = jax.random.split(key)
            logits, _ = model.apply(params, obs)
            if tcfg.mask_actions:
                mask = jax.vmap(
                    lambda p: valid_action_mask(env_cfg, p)
                )(env_state.agent_pos)
                logits = jnp.where(mask, logits, -1e9)
            else:
                mask = jnp.ones(logits.shape, bool)
            action, log_prob = sample_action(akey, logits)  # [B, A]
            env_state, ts = step_autoreset_batch(
                env_cfg, env_state, action.astype(jnp.int32)
            )
            done = jnp.broadcast_to(
                ts.truncated[:, None], ts.reward.shape
            )  # [B, A]
            if tcfg.bootstrap_truncated:
                _, boot_value = model.apply(params, ts.final_obs)
            else:
                boot_value = jnp.zeros_like(ts.reward)
            tr = ImpalaTransition(obs, action, log_prob, ts.reward,
                                  done, mask, boot_value)
            return (env_state, ts.obs, key), (tr, ts.delivered,
                                              ts.reward.mean())

        (env_state, last_obs, key), (traj, delivered, raw_rew) = (
            jax.lax.scan(
                env_step, (rs.env_state, rs.obs, key), None,
                length=tcfg.unroll_length,
            ))

        def loss_fn(params, mb, last_obs_mb):
            # mb leaves are [T, Bmb, A, ...]; the V-trace scan runs on T.
            T, Bmb = mb.reward.shape[0], mb.reward.shape[1]
            obs_flat = mb.obs.reshape(T * Bmb * env_cfg.num_agents, -1)
            logits, value = model.apply(params, obs_flat)
            logits = logits.reshape(T, Bmb, env_cfg.num_agents, -1)
            value = value.reshape(T, Bmb, env_cfg.num_agents)
            if tcfg.mask_actions:
                logits = jnp.where(mb.mask, logits, -1e9)
            # Lane-efficient [n_act, N] log-prob/entropy (ops/ppo_update).
            lp, entropy = action_log_prob_entropy(logits, mb.action)
            _, last_value = model.apply(
                params, last_obs_mb.reshape(Bmb * env_cfg.num_agents, -1)
            )
            last_value = last_value.reshape(Bmb, env_cfg.num_agents)
            vs, pg_adv = vtrace(
                mb.behavior_log_prob, lp, mb.reward, value, mb.done,
                last_value, tcfg.gamma,
                rho_clip=tcfg.rho_clip, c_clip=tcfg.c_clip,
                bootstrap_values=(
                    mb.boot_value if tcfg.bootstrap_truncated else None
                ),
            )
            pg_loss = -(lp * pg_adv).mean()
            v_loss = 0.5 * ((value - vs) ** 2).mean()
            total = (
                pg_loss + tcfg.value_coef * v_loss
                - tcfg.entropy_coef * entropy
            )
            return total, (pg_loss, v_loss, entropy)

        # Minibatch over the env axis (axis 1 of [T, B, A]); T intact.
        mb_envs = b_local // tcfg.num_minibatches
        minibatches = jax.tree.map(
            lambda x: x.reshape(
                x.shape[0], tcfg.num_minibatches, mb_envs, *x.shape[2:]
            ).swapaxes(0, 1),
            traj,
        )  # leaves [num_minibatches, T, mb_envs, A, ...]
        last_obs_mbs = last_obs.reshape(
            tcfg.num_minibatches, mb_envs, *last_obs.shape[1:]
        )

        def one_pass(carry, _):
            params, opt_state = carry

            def mb_update(carry, mb_and_last):
                params, opt_state = carry
                mb, last_obs_mb = mb_and_last
                if tcfg.micro_batches == 1:
                    (loss, aux), grads = jax.value_and_grad(
                        loss_fn, has_aux=True
                    )(params, mb, last_obs_mb)
                else:
                    # Gradient accumulation over env-axis micro chunks —
                    # EXACT for V-trace (the trace runs per env along T;
                    # no cross-env normalization): mean of equal-size
                    # micro grads == the minibatch grad, f32 order aside
                    # (TrainConfig.micro_batches).
                    k = tcfg.micro_batches
                    micros = jax.tree.map(
                        lambda x: x.reshape(
                            x.shape[0], k, x.shape[1] // k, *x.shape[2:]
                        ).swapaxes(0, 1),
                        mb,
                    )  # leaves [k, T, mb_envs/k, A, ...]
                    last_micros = last_obs_mb.reshape(
                        k, last_obs_mb.shape[0] // k,
                        *last_obs_mb.shape[1:])

                    def acc(g, ml):
                        mi, lo = ml
                        (loss, aux), gr = jax.value_and_grad(
                            loss_fn, has_aux=True)(params, mi, lo)
                        return (jax.tree.map(jnp.add, g, gr),
                                (loss, aux))

                    zero = jax.tree.map(jnp.zeros_like, params)
                    grads, (losses_k, aux_k) = jax.lax.scan(
                        acc, zero, (micros, last_micros))
                    grads = jax.tree.map(lambda g: g / k, grads)
                    loss = losses_k.mean()
                    aux = jax.tree.map(lambda a: a.mean(), aux_k)
                if mesh is not None:
                    grads = jax.lax.pmean(grads, DATA_AXIS)
                    loss = jax.lax.pmean(loss, DATA_AXIS)
                    aux = jax.lax.pmean(aux, DATA_AXIS)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), (loss, *aux)

            (params, opt_state), losses = jax.lax.scan(
                mb_update, (params, opt_state), (minibatches, last_obs_mbs)
            )
            return (params, opt_state), losses

        (params, opt_state), losses = jax.lax.scan(
            one_pass, (params, rs.opt_state), None,
            length=tcfg.impala_passes,
        )
        return _metrics_tail(rs, params, opt_state, env_state,
                             last_obs, key, losses, delivered, raw_rew)

    # ------------------------------------- metrics + new state (shared)
    def _metrics_tail(rs, params, opt_state, env_state, last_obs, key,
                      losses, delivered, raw_rew):
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
            "reward_per_step": mean_reward,
            "deliveries_per_env_step": deliveries,
        }
        new_rs = ImpalaRunnerState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=last_obs,
            key=key.reshape(1, 2),
            update_idx=rs.update_idx + 1,
        )
        return new_rs, metrics

    # -------------------------------------------------- jit / shard_map
    init_global = init
    if mesh is None:
        train_step = jax.jit(_train_step_local)
    else:
        state_spec = ImpalaRunnerState(
            params=P(),
            opt_state=P(),
            env_state=P(DATA_AXIS),
            obs=P(DATA_AXIS),
            key=P(DATA_AXIS),
            update_idx=P(),
        )
        metric_spec = {
            "loss": P(), "pg_loss": P(), "v_loss": P(), "entropy": P(),
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
        from jax.sharding import NamedSharding

        out_shardings = jax.tree.map(
            lambda spec: NamedSharding(mesh, spec),
            state_spec,
            is_leaf=lambda x: isinstance(x, P),
        )
        init_global = jax.jit(init, out_shardings=out_shardings)

    def shard_runner_state(rs: ImpalaRunnerState) -> ImpalaRunnerState:
        if mesh is None:
            return rs
        from jax.sharding import NamedSharding

        def put(x, spec):
            return jax.device_put(x, NamedSharding(mesh, spec))

        return ImpalaRunnerState(
            params=put(rs.params, P()),
            opt_state=put(rs.opt_state, P()),
            env_state=jax.tree.map(
                lambda x: put(x, P(DATA_AXIS)), rs.env_state
            ),
            obs=put(rs.obs, P(DATA_AXIS)),
            key=put(rs.key, P(DATA_AXIS)),
            update_idx=put(rs.update_idx, P()),
        )

    @partial(jax.jit, static_argnums=1)
    def train_many(rs: ImpalaRunnerState, n: int):
        return jax.lax.scan(lambda r, _: train_step(r), rs, None, length=n)

    return ImpalaTrainer(
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
    )


class ImpalaTrainer(NamedTuple):
    init: Callable
    init_global: Callable
    train_step: Callable
    train_many: Callable
    shard_runner_state: Callable
    model: Any
    tx: Any
    env_cfg: EnvConfig
    tcfg: TrainConfig
    mesh: Any

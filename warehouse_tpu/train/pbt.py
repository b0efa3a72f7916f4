"""Population Based Training — Ray Tune PBT scheduler parity, on-device.

Tune's PBT (Jaderberg et al. 2017) runs each population member as a
separate actor process, pausing trials to checkpoint/restore weights on
exploit and editing their config on explore. The on-device design
removes every process/checkpoint boundary:

- **The population is a vmap axis.** All members train in ONE compiled
  program; member policies/optimizers batch into single large matmuls
  (same Podracer pattern as train/sweep.py's seed axis).
- **Mutable hyperparameters are runtime arrays, not compile-time
  constants.** The member's learning rate rides inside the optimizer
  state via ``optax.inject_hyperparams`` and the entropy coefficient is
  an input to the loss, so exploit/explore edits are pure array updates
  — zero recompiles across the whole PBT run (Tune pays a restart;
  sweep.py's grid pays a retrace per point).
- **Exploit = gather.** Bottom-quantile members copy the full
  (params, opt_state) pytree from a sampled top-quantile member with a
  single ``jnp.take`` along the population axis; explore then perturbs
  their hyperparameters (×1.2 / ÷1.2, or resample with prob 0.25 —
  Tune's default rule).
- **Mesh-aware.** With a 2-D ``(pop, data)`` mesh
  (``parallel.mesh.make_pop_mesh``) the population axis shards over
  ``pop`` devices and each member's env batch over ``data`` devices
  (grads ``pmean``'d within a member, exactly train/ppo.py's data
  parallelism); either axis may be 1. Exploit's cross-member gather is
  the only cross-``pop`` communication, once per interval.

Runs the shared-policy feed-forward PPO path (the flagship config) with
the full TrainConfig knob set — action masking, reward shaping,
adaptive KL (per-member state), truncation bootstrapping — via the
shared update core (ops/ppo_update.py); policy-groups stay with
train/ppo.py.
"""

from __future__ import annotations

import json
from typing import Any, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

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
    flat_minibatches,
    minibatch_epochs,
    ppo_losses,
    sample_action,
)
from ..pytree import pytree_dataclass


@pytree_dataclass
class MemberState:
    """One population member's training state (vmapped to [P, ...])."""
    params: Any
    opt_state: Any
    env_state: Any
    obs: jax.Array
    key: jax.Array          # uint32[n_data_shards, 2] (one key per shard)
    entropy_coef: jax.Array  # float32 — runtime-mutable (PBT explore)
    kl_coeff: jax.Array      # float32 — adaptive KL penalty state


class PBTResult(NamedTuple):
    rows: list
    best: dict
    member: MemberState     # final population (vmapped)


_MUTABLE = ("learning_rate", "entropy_coef")


def _sample_hp(space: dict[str, Any], rng: np.random.Generator) -> float:
    if isinstance(space, (list, tuple)):
        return float(space[int(rng.integers(len(space)))])
    if "uniform" in space:
        lo, hi = space["uniform"]
        return float(rng.uniform(lo, hi))
    if "loguniform" in space:
        lo, hi = space["loguniform"]
        return float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
    raise ValueError(f"bad hyperparam space: {space!r}")


def make_pbt_trainer(env_cfg: EnvConfig, tcfg: TrainConfig,
                     arch: str = "mlp", mesh=None):
    """Build (init_members, train_chunk) with runtime lr/entropy_coef.

    ``init_members(key, lrs, ents) -> MemberState`` (leading [P] axis);
    ``train_chunk(member, n) -> (member, metrics[P, n])`` — n updates
    for every member in one jitted vmap.

    ``mesh``: optional 2-D ``(pop, data)`` mesh from
    ``parallel.mesh.make_pop_mesh`` — population sharded over ``pop``
    (P must divide into pop shards), each member's env batch sharded
    over ``data`` (num_envs must divide into data shards).
    """
    from ..parallel.mesh import DATA_AXIS, POP_AXIS

    env_cfg = env_cfg.replace(auto_reset=True)
    model = make_model(env_cfg, arch=arch, hidden_dim=tcfg.hidden_dim,
                       num_layers=tcfg.num_layers)
    n_data = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if tcfg.num_envs % n_data:
        raise ValueError(
            f"num_envs={tcfg.num_envs} not divisible by {n_data} data shards")
    b_local = tcfg.num_envs // n_data
    batch = tcfg.unroll_length * b_local * env_cfg.num_agents
    if batch % tcfg.num_minibatches:
        raise ValueError("T*B_local*A must divide into num_minibatches")

    # inject_hyperparams makes learning_rate a leaf of opt_state →
    # vmappable per member and mutable between chunks without retrace.
    tx = optax.chain(
        optax.clip_by_global_norm(tcfg.max_grad_norm),
        optax.inject_hyperparams(optax.adam)(
            learning_rate=tcfg.learning_rate,
            b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS),
    )
    if tcfg.flat_optimizer:
        # optax.flatten runs the chain on the raveled param vector; its
        # state IS the inner (clip, inject) tuple, so set_lr below and
        # the PBT exploit/explore state copies are layout-agnostic.
        tx = optax.flatten(tx)

    def init_one(key: jax.Array, lr: jax.Array,
                 ent: jax.Array) -> MemberState:
        pkey, ekey, skey = jax.random.split(key, 3)
        params = model.init(pkey, jnp.zeros((1, env_cfg.obs_dim),
                                            jnp.float32))
        opt_state = tx.init(params)
        opt_state = set_lr(opt_state, lr)
        # Per-env keys derived from GLOBAL env index → reshard-invariant
        # (SURVEY.md §7 hard part 6); per-data-shard sampling keys like
        # train/ppo.py's RunnerState.key.
        env_keys = jax.vmap(
            lambda i: jax.random.fold_in(ekey, i)
        )(jnp.arange(tcfg.num_envs))
        env_state, obs = jax.vmap(
            lambda k: engine.reset(env_cfg, k)
        )(env_keys)
        shard_keys = jax.vmap(
            lambda i: jax.random.fold_in(skey, i)
        )(jnp.arange(n_data))
        return MemberState(params, opt_state, env_state, obs, shard_keys,
                           jnp.float32(ent), jnp.float32(tcfg.kl_coeff))

    def set_lr(opt_state, lr):
        return _set_lr_impl(opt_state, lr)

    def _set_lr_impl(opt_state, lr):
        # optax.chain state: tuple(clip_state, inject_state); the inject
        # state carries .hyperparams["learning_rate"].
        clip_state, inj = opt_state
        hp = dict(inj.hyperparams)
        hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
        return (clip_state, inj._replace(hyperparams=hp))

    def _update_one(member: MemberState):
        params = member.params
        key = member.key.reshape(2)  # this data shard's key block

        def env_step(carry, _):
            env_state, obs, key = carry
            key, akey = jax.random.split(key)
            logits, value = model.apply(params, obs)
            if tcfg.mask_actions:
                mask = jax.vmap(
                    lambda p: valid_action_mask(env_cfg, p)
                )(env_state.agent_pos)
                logits = jnp.where(mask, logits, NEG_INF)
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
                _, boot_value = model.apply(params, ts.final_obs)
            else:
                boot_value = jnp.zeros_like(value)
            return (env_state, ts.obs, key), (
                (obs, action, log_prob, value, reward, done, mask,
                 boot_value),
                ts.delivered, ts.reward.mean())

        (env_state, last_obs, key), (traj, delivered, raw_rew) = (
            jax.lax.scan(
                env_step, (member.env_state, member.obs, key), None,
                length=tcfg.unroll_length))
        (obs_t, action_t, lp_t, val_t, rew_t, done_t, mask_t,
         boot_t) = traj
        _, last_value = model.apply(params, last_obs)
        advantages, targets = gae(
            rew_t, val_t, done_t, last_value,
            tcfg.gamma, tcfg.gae_lambda,
            bootstrap_values=boot_t if tcfg.bootstrap_truncated else None)

        def flat(x):
            return x.reshape(batch, *x.shape[3:])

        data = (flat(obs_t), flat(action_t), flat(lp_t), flat(val_t),
                flat(advantages), flat(targets), flat(mask_t))

        def loss_fn(params, mb):
            obs, action, old_lp, old_v, adv, tgt, mask = mb
            logits, value = model.apply(params, obs)
            if tcfg.mask_actions:
                logits = jnp.where(mask, logits, NEG_INF)
            return ppo_losses(
                logits, value, action, old_lp, old_v, adv, tgt,
                clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
                ent_coef=member.entropy_coef, kl_coeff=member.kl_coeff,
            )

        params, opt_state, key, losses = minibatch_epochs(
            params, member.opt_state, key,
            loss_fn=loss_fn,
            make_minibatches=lambda k: flat_minibatches(
                k, data, tcfg.num_minibatches),
            num_epochs=tcfg.ppo_epochs,
            tx=tx,
            pmean_axis=None if mesh is None else DATA_AXIS,
            reshuffle_each_epoch=(tcfg.epoch_shuffle == "each"),
        )
        mean_kl = losses[4].mean()
        kl_coeff = adaptive_kl_coeff(tcfg, member.kl_coeff, mean_kl)
        deliveries = delivered.sum(
            dtype=jnp.float32) / (tcfg.unroll_length * b_local)
        mean_reward = raw_rew.mean()
        if mesh is not None:
            deliveries = jax.lax.pmean(deliveries, DATA_AXIS)
            mean_reward = jax.lax.pmean(mean_reward, DATA_AXIS)
        metrics = {
            "loss": losses[0].mean(),
            "entropy": losses[3].mean(),
            "kl": mean_kl,
            "deliveries_per_env_step": deliveries,
            "reward_per_step": mean_reward,
        }
        return MemberState(params, opt_state, env_state, last_obs,
                           key.reshape(1, 2),
                           member.entropy_coef, kl_coeff), metrics

    # Sharding layout over the (pop, data) mesh: params/opt/hyperparams
    # shard only over pop; env batch + per-shard keys additionally over
    # data (the member axis is ALWAYS leading).
    if mesh is not None:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as PS

        member_spec = MemberState(
            params=PS(POP_AXIS),
            opt_state=PS(POP_AXIS),
            env_state=PS(POP_AXIS, DATA_AXIS),
            obs=PS(POP_AXIS, DATA_AXIS),
            key=PS(POP_AXIS, DATA_AXIS),
            entropy_coef=PS(POP_AXIS),
            kl_coeff=PS(POP_AXIS),
        )
        metric_spec = {
            k: PS(POP_AXIS)
            for k in ("loss", "entropy", "kl",
                      "deliveries_per_env_step", "reward_per_step")
        }
        member_shardings = jax.tree.map(
            lambda spec: NamedSharding(mesh, spec), member_spec,
            is_leaf=lambda x: isinstance(x, PS))

    def init_members(key: jax.Array, lrs: np.ndarray,
                     ents: np.ndarray) -> MemberState:
        P = len(lrs)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(P))
        fn = jax.vmap(init_one)
        if mesh is not None:
            if P % mesh.shape[POP_AXIS]:
                raise ValueError(
                    f"population {P} not divisible by "
                    f"{mesh.shape[POP_AXIS]} pop shards")
            fn = jax.jit(fn, out_shardings=member_shardings)
        else:
            fn = jax.jit(fn)
        return fn(keys, jnp.asarray(lrs, jnp.float32),
                  jnp.asarray(ents, jnp.float32))

    def _chunk(member: MemberState, n: int):
        def one(m):
            return jax.lax.scan(lambda mm, _: _update_one(mm), m, None,
                                length=n)
        return jax.vmap(one)(member)

    if mesh is None:
        train_chunk = jax.jit(_chunk, static_argnums=1)
    else:
        from functools import partial

        def _chunk_meshed(member: MemberState, n: int):
            return jax.shard_map(
                lambda m: _chunk(m, n),
                mesh=mesh,
                in_specs=(member_spec,),
                out_specs=(member_spec, metric_spec),
                check_vma=False,
            )(member)

        train_chunk = jax.jit(_chunk_meshed, static_argnums=1)

    def get_lr(member: MemberState) -> np.ndarray:
        return np.asarray(
            member.opt_state[1].hyperparams["learning_rate"])

    def with_hp(member: MemberState, lrs: np.ndarray,
                ents: np.ndarray) -> MemberState:
        opt_state = _set_lr_impl(
            member.opt_state, jnp.asarray(lrs, jnp.float32))
        return member.replace(opt_state=opt_state,
                              entropy_coef=jnp.asarray(ents, jnp.float32))

    return init_members, train_chunk, get_lr, with_hp


def run_pbt(
    env_cfg: EnvConfig,
    base_tcfg: TrainConfig,
    hyper_space: dict[str, Any],
    population_size: int = 8,
    perturb_interval: int = 10,
    num_intervals: int = 5,
    quantile: float = 0.25,
    resample_prob: float = 0.25,
    arch: str = "mlp",
    select_metric: str = "deliveries_per_env_step",
    mode: str = "max",
    seed: int = 0,
    out_path: str | None = None,
    mesh=None,
) -> PBTResult:
    """Run PBT; returns (rows, best, final population).

    ``hyper_space`` maps a subset of {"learning_rate", "entropy_coef"}
    to a sample spec (list = choice, {"uniform"|"loguniform": [lo,hi]}).
    Score per interval = mean of ``select_metric`` over the interval's
    updates (seed axis not used here — the population IS the spread).
    ``mesh``: optional (pop, data) mesh — see ``make_pbt_trainer``.
    """
    for k in hyper_space:
        if k not in _MUTABLE:
            raise ValueError(
                f"PBT mutates {_MUTABLE}; got {k!r} (fixed fields are "
                "compile-time constants — sweep them with train/sweep.py)")
    if mode not in ("max", "min"):
        raise ValueError("mode must be 'max' or 'min'")
    sign = 1.0 if mode == "max" else -1.0
    rng = np.random.default_rng(seed)
    P = population_size

    lrs = np.array([
        _sample_hp(hyper_space["learning_rate"], rng)
        if "learning_rate" in hyper_space else base_tcfg.learning_rate
        for _ in range(P)])
    ents = np.array([
        _sample_hp(hyper_space["entropy_coef"], rng)
        if "entropy_coef" in hyper_space else base_tcfg.entropy_coef
        for _ in range(P)])

    tcfg = base_tcfg.replace(anneal_lr=False)
    init_members, train_chunk, get_lr, with_hp = make_pbt_trainer(
        env_cfg, tcfg, arch=arch, mesh=mesh)
    member = init_members(jax.random.PRNGKey(seed), lrs, ents)

    rows: list[dict[str, Any]] = []
    scores = np.zeros(P)
    for interval in range(num_intervals):
        member, metrics = train_chunk(member, perturb_interval)
        curve = np.asarray(metrics[select_metric])       # [P, n]
        scores = curve.mean(axis=1)
        lrs = get_lr(member)
        ents = np.asarray(member.entropy_coef)
        for p in range(P):
            rows.append({
                "member": p, "interval": interval,
                "updates_so_far": (interval + 1) * perturb_interval,
                "score": float(scores[p]),
                "learning_rate": float(lrs[p]),
                "entropy_coef": float(ents[p]),
            })
        if interval == num_intervals - 1:
            break
        # ---- exploit/explore (Tune's default PBT rule) --------------
        ranked = np.argsort(sign * scores)[::-1]         # best first
        n_q = max(1, int(np.ceil(P * quantile)))
        top, bottom = ranked[:n_q], ranked[P - n_q:]
        src = np.arange(P)
        src[bottom] = rng.choice(top, size=len(bottom))
        # Gather the full training state along the population axis.
        src_dev = jnp.asarray(src)
        member = jax.tree.map(lambda x: jnp.take(x, src_dev, axis=0),
                              member)
        new_lrs, new_ents = lrs[src].copy(), ents[src].copy()
        for i in bottom:
            for name, arr in (("learning_rate", new_lrs),
                              ("entropy_coef", new_ents)):
                if name not in hyper_space:
                    continue
                if rng.random() < resample_prob:
                    arr[i] = _sample_hp(hyper_space[name], rng)
                else:
                    arr[i] *= 1.2 if rng.random() < 0.5 else 1 / 1.2
        member = with_hp(member, new_lrs, new_ents)

    best_i = int(np.argmax(sign * scores))
    best = {
        "summary": True, "scheduler": "pbt", "select_metric": select_metric,
        "mode": mode, "population_size": P,
        "perturb_interval": perturb_interval,
        "num_intervals": num_intervals,
        "best_member": best_i, "best_score": float(scores[best_i]),
        "best_hyperparams": {"learning_rate": float(get_lr(member)[best_i]),
                             "entropy_coef": float(
                                 np.asarray(member.entropy_coef)[best_i])},
    }
    rows.append(best)
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return PBTResult(rows, best, member)

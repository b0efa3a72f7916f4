"""Train CLI: ``python -m warehouse_tpu.train`` (SURVEY.md §3.4).

Capability parity with the reference's ``train.py`` entry (SURVEY.md L5,
§3.1), replacing ray.init + RLlib PPO with the on-device actor-learner:
every host runs this same program; the mesh spans all global devices.
"""

from __future__ import annotations

import argparse
import logging
import time

from ..config import TrainConfig
from ..configs_cli import add_env_args, apply_backend_args, env_config_from_args


def main(argv=None) -> None:
    p = argparse.ArgumentParser("warehouse_tpu.train")
    add_env_args(p)
    p.add_argument("--algo", choices=["ppo", "impala"], default="ppo",
                   help="impala = V-trace actor-learner (train/impala.py; "
                        "RLlib ships IMPALA alongside PPO)")
    p.add_argument("--rho-clip", type=float, default=1.0,
                   help="V-trace ρ̄ importance clip (impala only)")
    p.add_argument("--c-clip", type=float, default=1.0,
                   help="V-trace c̄ trace clip (impala only)")
    p.add_argument("--impala-passes", type=int, default=1,
                   help="replays of each rollout per update (impala only)")
    p.add_argument("--impala-adam", action="store_true",
                   help="Adam instead of IMPALA's canonical RMSProp "
                        "(impala only). RMSProp's eps=0.1 heavily damps "
                        "the small gradients this env produces — Adam "
                        "learns it in a few hundred updates where "
                        "RMSProp needs the paper's long-horizon budget")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--unroll-length", type=int, default=16)
    p.add_argument("--num-updates", type=int, default=200)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ppo-epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=4)
    p.add_argument("--entropy-coef", type=float, default=0.01)
    p.add_argument("--entropy-coef-final", type=float, default=-1.0,
                   help="linear entropy anneal target over num_updates "
                        "(negative = constant --entropy-coef)")
    p.add_argument("--shaping-coef", type=float, default=0.0,
                   help="potential-based reward shaping coefficient "
                        "(BFS distance-to-target potential; 0 = off)")
    p.add_argument("--mask-actions", action="store_true",
                   help="mask wall/out-of-grid moves at the policy logits")
    p.add_argument("--minibatch-mode", choices=["flat", "env"],
                   default="env",
                   help="PPO epoch shuffle granularity: 'env' (default) "
                        "= permute env-trajectories (B-row gather, "
                        "curve-equivalent), 'flat' = fresh per-sample "
                        "permutation (RLlib-style)")
    p.add_argument("--epoch-shuffle", choices=["each", "once"],
                   default="once",
                   help="'once' (default) draws one minibatch "
                        "permutation per update and reuses it across "
                        "ppo_epochs epochs (drops the per-epoch "
                        "full-batch gather; curve-equivalent on "
                        "config 4); 'each' = RLlib's per-epoch reshuffle")
    p.add_argument("--rllib-cadence", action="store_true",
                   help="restore the reference stack's SGD cadence: "
                        "--minibatch-mode flat --epoch-shuffle each "
                        "(statistically cleanest; gathers the whole "
                        "trajectory every epoch)")
    p.add_argument("--bootstrap-truncated", action="store_true",
                   help="bootstrap value targets through time-limit "
                        "truncations (RLlib behavior) instead of treating "
                        "them as terminals")
    p.add_argument("--kl-coeff", type=float, default=0.0,
                   help="initial adaptive-KL penalty coefficient (0 = off)")
    p.add_argument("--kl-target", type=float, default=0.01)
    p.add_argument("--hidden-dim", type=int, default=128)
    p.add_argument("--model-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="policy compute dtype; bfloat16 runs the torso "
                        "matmuls in bf16 (params and loss stay float32)")
    p.add_argument("--arch", choices=["mlp", "cnn", "attn", "gru", "lstm"],
                   default="mlp",
                   help="gru/lstm train a recurrent policy (RLlib "
                        "use_lstm parity; see train/ppo_rnn.py)")
    p.add_argument("--policy-groups", default=None,
                   help="comma-separated policy group per agent, e.g. "
                        "'0,0,1,1' trains 2 policies (RLlib "
                        "policy_mapping_fn parity); default: shared")
    p.add_argument("--micro-batches", type=int, default=1,
                   help="split each minibatch grad into K averaged "
                        "micro-grads (same SGD trajectory; see "
                        "TrainConfig.micro_batches)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics-path", default="metrics.jsonl")
    p.add_argument("--tensorboard-dir", default=None)
    p.add_argument("--single-device", action="store_true",
                   help="skip mesh/shard_map even with multiple devices")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax profiler trace of updates 3-5 here")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run a greedy-argmax evaluation every N updates "
                        "(0 = off); RLlib evaluation_interval parity")
    p.add_argument("--eval-episodes", type=int, default=128)
    args = p.parse_args(argv)
    if args.rllib_cadence:
        args.minibatch_mode = "flat"
        args.epoch_shuffle = "each"

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )
    log = logging.getLogger("warehouse_tpu")

    apply_backend_args(args)

    from ..parallel import maybe_initialize_distributed

    maybe_initialize_distributed()

    import jax

    from ..parallel.mesh import make_mesh
    from .checkpoint import restore_latest, save
    from .metrics import MetricsLogger
    from .ppo import make_train

    env_cfg = env_config_from_args(args)
    tcfg = TrainConfig(
        num_envs=args.num_envs,
        unroll_length=args.unroll_length,
        num_updates=args.num_updates,
        learning_rate=args.lr,
        ppo_epochs=args.ppo_epochs,
        num_minibatches=args.num_minibatches,
        entropy_coef=args.entropy_coef,
        entropy_coef_final=args.entropy_coef_final,
        shaping_coef=args.shaping_coef,
        mask_actions=args.mask_actions,
        minibatch_mode=args.minibatch_mode,
        epoch_shuffle=args.epoch_shuffle,
        bootstrap_truncated=args.bootstrap_truncated,
        kl_coeff=args.kl_coeff,
        kl_target=args.kl_target,
        hidden_dim=args.hidden_dim,
        model_dtype=args.model_dtype,
        micro_batches=args.micro_batches,
        seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        metrics_path=args.metrics_path,
        rho_clip=args.rho_clip,
        c_clip=args.c_clip,
        impala_passes=args.impala_passes,
        impala_rmsprop=not args.impala_adam,
    )

    devices = jax.devices()
    mesh = None
    if len(devices) > 1 and not args.single_device:
        mesh = make_mesh(devices)
        log.info("mesh: %s", mesh)
    log.info("devices: %d  env: %s", len(devices), env_cfg.to_json())

    policy_groups = None
    if args.policy_groups:
        policy_groups = tuple(
            int(x) for x in args.policy_groups.split(",")
        )
    if args.algo == "impala":
        if args.arch in ("gru", "lstm") or policy_groups is not None:
            raise SystemExit("--algo impala supports feed-forward archs "
                             "with a shared policy")
        from .impala import make_train_impala

        trainer = make_train_impala(env_cfg, tcfg, arch=args.arch,
                                    mesh=mesh)
    elif args.arch in ("gru", "lstm"):
        if policy_groups is not None:
            raise SystemExit("--policy-groups is not supported with "
                             "recurrent archs")
        from .ppo_rnn import make_train_rnn

        trainer = make_train_rnn(env_cfg, tcfg, arch=args.arch, mesh=mesh)
    else:
        trainer = make_train(env_cfg, tcfg, arch=args.arch, mesh=mesh,
                             policy_groups=policy_groups)
    if args.checkpoint_every:
        # Self-describing checkpoints: serving (warehouse_tpu.serve)
        # rebuilds the model from this metadata alone.
        from ..serve import write_policy_meta

        write_policy_meta(args.checkpoint_dir, env_cfg, tcfg,
                          arch=args.arch, policy_groups=policy_groups)

    rs = trainer.init_global(jax.random.PRNGKey(args.seed))

    start_update = 0
    if args.resume:
        restored = restore_latest(args.checkpoint_dir, rs)
        if restored is not None:
            start_update, rs = restored
            log.info("resumed from update %d", start_update)

    metrics = MetricsLogger(args.metrics_path, args.tensorboard_dir)
    # The metrics file names the devices that produced its numbers.
    metrics.log_meta({"algo": args.algo, "arch": args.arch,
                      "device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)}})
    steps_per_update = tcfg.num_envs * tcfg.unroll_length
    t_last = time.time()
    for u in range(start_update, tcfg.num_updates, args.log_every):
        n = min(args.log_every, tcfg.num_updates - u)
        if args.profile_dir and u == args.log_every:
            jax.profiler.start_trace(args.profile_dir)
        rs, ms = trainer.train_many(rs, n)
        jax.block_until_ready(rs.params)
        if args.profile_dir and u == args.log_every:
            jax.profiler.stop_trace()
            log.info("profiler trace written to %s", args.profile_dir)
        dt = time.time() - t_last
        t_last = time.time()
        scalars = {k: float(v[-1]) for k, v in ms.items()}
        scalars["env_steps_per_sec"] = steps_per_update * n / dt
        metrics.log(u + n, scalars)
        if args.checkpoint_every and (u + n) % args.checkpoint_every == 0:
            path = save(args.checkpoint_dir, u + n, rs)
            log.info("checkpoint: %s", path)
        if args.eval_every and (u + n) % args.eval_every == 0:
            import jax.numpy as jnp

            from ..evaluate import evaluate_policy

            params = rs.params

            if args.arch in ("gru", "lstm"):
                def policy_fn(state, obs, key, carry):
                    logits, _, carry = trainer.model.apply(
                        params, obs, carry
                    )
                    return (jnp.argmax(logits, axis=-1).astype(jnp.int32),
                            carry)

                def init_carry(B):
                    return trainer.model.initial_carry(
                        (B, env_cfg.num_agents)
                    )
            else:
                def policy_fn(state, obs, key):
                    logits, _ = trainer.model.apply(params, obs)
                    return jnp.argmax(logits, axis=-1).astype(jnp.int32)

                init_carry = None

            ev = evaluate_policy(env_cfg, policy_fn, args.eval_episodes,
                                 seed=args.seed + u, init_carry=init_carry)
            metrics.log(u + n, {f"eval_{k}": v for k, v in ev.items()
                                if k != "episodes"})
    metrics.close()
    log.info("done: %d updates, %d env steps", tcfg.num_updates,
             tcfg.num_updates * steps_per_update)


if __name__ == "__main__":
    main()

"""Demo CLI: ``python -m warehouse_tpu.demo`` (SURVEY.md §3.3, C13).

Rolls a greedy-baseline (or random) episode and prints per-step ASCII
renders and the episode summary — the reference's demo script capability,
running on whatever backend JAX picks (the GPU if present).
"""

from __future__ import annotations

import argparse

import numpy as np

from .configs_cli import add_env_args, apply_backend_args, env_config_from_args


def main(argv=None) -> None:
    p = argparse.ArgumentParser("warehouse_tpu.demo")
    add_env_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=None,
                   help="default: env max_steps")
    p.add_argument("--policy",
                   choices=["greedy", "greedy_bfs", "random", "checkpoint"],
                   default="greedy")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--arch", choices=["mlp", "cnn", "attn"], default="mlp")
    p.add_argument("--hidden-dim", type=int, default=128)
    p.add_argument("--render", action="store_true")
    p.add_argument("--gif", default=None, metavar="PATH",
                   help="write the episode as an animated GIF "
                        "(rgb_array rendering)")
    p.add_argument("--backend", choices=["jax", "oracle"], default="jax")
    args = p.parse_args(argv)

    apply_backend_args(args)
    cfg = env_config_from_args(args)
    steps = args.steps or cfg.max_steps

    from .env.wrapper import WarehouseMultiAgentEnv

    env = WarehouseMultiAgentEnv(cfg, backend=args.backend)
    obs, _ = env.reset(seed=args.seed)
    rng = np.random.default_rng(args.seed)

    ckpt_apply = None
    ckpt_policy = None
    ckpt_carry = None
    if args.policy == "checkpoint":
        # Prefer the self-describing serving path: policy_meta.json (written
        # by the train CLI) rebuilds the exact arch/masking/groups, and
        # serve.Policy threads the recurrent carry — so GRU/LSTM and
        # mask-trained checkpoints replay correctly here.
        from .serve import Policy

        try:
            ckpt_policy = Policy.from_checkpoint(args.checkpoint_dir)
            ckpt_carry = ckpt_policy.initial_state(1)
        except FileNotFoundError:
            # Legacy checkpoint without metadata: feed-forward manual
            # rebuild from --arch/--hidden-dim (argmax, no masking).
            import jax
            import jax.numpy as jnp

            from .evaluate import load_checkpoint_params
            from .models import make_model

            model = make_model(
                cfg, arch=args.arch, hidden_dim=args.hidden_dim
            )
            params = load_checkpoint_params(
                cfg, model, args.checkpoint_dir
            )
            ckpt_apply = jax.jit(
                lambda o: jnp.argmax(model.apply(params, o)[0], axis=-1)
            )

    returns = {a: 0.0 for a in env.possible_agents}
    deliveries = 0
    frames = []
    if args.render:
        print(env.render())
    if args.gif:
        frames.append(env.render(mode="rgb_array"))
    for t in range(steps):
        if args.policy in ("greedy", "greedy_bfs"):
            if args.backend == "oracle":
                from .oracle import greedy_actions, greedy_bfs_actions
            else:
                from .baselines.greedy import (
                    greedy_actions, greedy_bfs_actions,
                )
            fn = (greedy_bfs_actions if args.policy == "greedy_bfs"
                  else greedy_actions)
            acts = np.asarray(fn(cfg, env.state))
            action_dict = {
                a: int(acts[i]) for i, a in enumerate(env.possible_agents)
            }
        elif args.policy == "checkpoint":
            if ckpt_policy is not None:
                action_dict, ckpt_carry = ckpt_policy.compute_actions_dict(
                    env, obs, state=ckpt_carry
                )
            else:
                import numpy as _np

                stacked = _np.stack([obs[a] for a in env.possible_agents])
                acts = _np.asarray(ckpt_apply(stacked))
                action_dict = {
                    a: int(acts[i])
                    for i, a in enumerate(env.possible_agents)
                }
        else:
            action_dict = {
                a: int(rng.integers(0, cfg.num_actions))
                for a in env.possible_agents
            }
        obs, rew, term, trunc, info = env.step(action_dict)
        deliveries += sum(info[a]["delivered"] for a in env.possible_agents)
        for a in env.possible_agents:
            returns[a] += rew[a]
        if args.render:
            print(env.render())
        if args.gif:
            frames.append(env.render(mode="rgb_array"))
        if trunc["__all__"] or term["__all__"]:
            break
    if args.gif:
        from .env.render import save_gif

        save_gif(frames, args.gif)
        print(f"gif written: {args.gif} ({len(frames)} frames)")
    print(f"episode finished after {t + 1} steps")
    print(f"deliveries: {deliveries}")
    for a, r in returns.items():
        print(f"  {a}: return {r:.3f}")
    print(f"mean return: {np.mean(list(returns.values())):.3f}")


if __name__ == "__main__":
    main()

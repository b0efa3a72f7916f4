"""Evaluation CLI: ``python -m warehouse_tpu.evaluate`` (SURVEY.md C13).

Batched on-device evaluation of the greedy baseline, a random policy, or
a trained PPO checkpoint: B envs × full episodes, fully jitted, reporting
mean episode return and deliveries/episode — the reference's
evaluate-script capability without the per-step Python loop.
"""

from __future__ import annotations

import argparse

import numpy as np

from .configs_cli import add_env_args, apply_backend_args, env_config_from_args


def evaluate_policy(cfg, policy_fn, num_episodes: int, seed: int = 0,
                    init_carry=None):
    """policy_fn(state, obs, key) -> int32[B, A] actions. Returns metrics.

    Runs B=num_episodes envs for exactly max_steps (one episode each;
    auto_reset off) in one jitted scan.

    Recurrent policies: pass ``init_carry(B) -> carry`` and a
    ``policy_fn(state, obs, key, carry) -> (actions, carry)`` — the
    carry is threaded through the episode scan (RLlib use_lstm
    evaluation parity).
    """
    import jax
    import jax.numpy as jnp

    from .env import engine

    cfg = cfg.replace(auto_reset=False)
    B = num_episodes
    keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i)
    )(jnp.arange(B))
    state, obs = jax.jit(jax.vmap(lambda k: engine.reset(cfg, k)))(keys)
    pc0 = init_carry(B) if init_carry is not None else ()

    def body(carry, _):
        state, obs, key, pc = carry
        key, ak = jax.random.split(key)
        if init_carry is not None:
            actions, pc = policy_fn(state, obs, ak, pc)
        else:
            actions = policy_fn(state, obs, ak)
        state, ts = jax.vmap(
            lambda s, a: engine.step(cfg, s, a)
        )(state, actions)
        return (state, ts.obs, key, pc), (ts.reward, ts.delivered)

    @jax.jit
    def run(state, obs):
        (_, _, _, _), (rews, dels) = jax.lax.scan(
            body, (state, obs, jax.random.PRNGKey(seed + 1), pc0), None,
            length=cfg.max_steps,
        )
        return rews, dels

    rews, dels = run(state, obs)  # [T, B, A]
    ep_return = np.asarray(rews.sum(0))        # [B, A]
    ep_deliv = np.asarray(dels.sum(0))         # [B, A]
    return {
        "episodes": B,
        "mean_agent_return": float(ep_return.mean()),
        "mean_episode_return": float(ep_return.sum(-1).mean()),
        "mean_deliveries_per_episode": float(ep_deliv.sum(-1).mean()),
        "std_episode_return": float(ep_return.sum(-1).std()),
    }


def load_checkpoint_params(cfg, model, checkpoint_dir: str):
    """Restore the latest checkpoint's params for ``model`` (see
    train.checkpoint.restore_params for the device-portability notes)."""
    from .train.checkpoint import restore_params

    try:
        return restore_params(checkpoint_dir)
    except FileNotFoundError as e:
        raise SystemExit(str(e))


def main(argv=None) -> None:
    p = argparse.ArgumentParser("warehouse_tpu.evaluate")
    add_env_args(p)
    p.add_argument("--policy",
                   choices=["greedy", "greedy_bfs", "random", "checkpoint"],
                   default="greedy")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--arch", choices=["mlp", "cnn", "attn", "gru", "lstm"],
                   default=None,
                   help="default: the checkpoint's policy_meta.json "
                        "(falls back to mlp)")
    p.add_argument("--hidden-dim", type=int, default=None)
    p.add_argument("--episodes", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample", action="store_true",
                   help="sample checkpoint-policy actions from the "
                        "categorical instead of argmax")
    p.add_argument("--mask-actions", action="store_true",
                   help="mask wall/out-of-grid moves at the logits "
                        "(use when the checkpoint was trained with "
                        "--mask-actions)")
    args = p.parse_args(argv)

    import jax

    apply_backend_args(args)
    cfg = env_config_from_args(args)

    if args.policy in ("greedy", "greedy_bfs"):
        from .baselines.greedy import greedy_actions, greedy_bfs_actions

        fn = (greedy_bfs_actions if args.policy == "greedy_bfs"
              else greedy_actions)

        def policy_fn(state, obs, key):
            return jax.vmap(lambda s: fn(cfg, s))(state)

    elif args.policy == "random":
        from .baselines.random import random_actions

        def policy_fn(state, obs, key):
            B = obs.shape[0]
            return random_actions(cfg, key, (B,)).astype("int32")

    else:
        import json
        import os

        import jax.numpy as jnp

        from .models import make_model
        from .ops.move import valid_action_mask
        from .serve import META_NAME

        # Self-describing checkpoints (train CLI writes policy_meta.json):
        # default arch/hidden_dim/num_layers/mask_actions from the
        # metadata so flags only exist as overrides — evaluating a
        # mask-trained checkpoint without re-applying the mask scores
        # near-zero, so the meta default removes that
        # footgun for legacy-flag users.
        meta = {}
        meta_path = os.path.join(args.checkpoint_dir, META_NAME)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        arch = args.arch or meta.get("arch", "mlp")
        hidden_dim = args.hidden_dim or meta.get("hidden_dim", 128)
        num_layers = meta.get("num_layers", 2)
        if meta.get("mask_actions") and not args.mask_actions:
            args.mask_actions = True

        model = make_model(cfg, arch=arch, hidden_dim=hidden_dim,
                           num_layers=num_layers)
        params = load_checkpoint_params(cfg, model, args.checkpoint_dir)
        recurrent = arch in ("gru", "lstm")

        def maybe_mask(state, logits):
            if not args.mask_actions:
                return logits
            mask = jax.vmap(
                lambda p: valid_action_mask(cfg, p)
            )(state.agent_pos)
            return jnp.where(mask, logits, -1e9)

        def pick(logits, key):
            if args.sample:
                return jax.random.categorical(key, logits).astype(jnp.int32)
            return jnp.argmax(logits, axis=-1).astype(jnp.int32)

        if recurrent:
            def policy_fn(state, obs, key, carry):
                logits, _, carry = model.apply(params, obs, carry)
                return pick(maybe_mask(state, logits), key), carry

            def init_carry(B):
                return model.initial_carry((B, cfg.num_agents))
        else:
            def policy_fn(state, obs, key):
                logits, _ = model.apply(params, obs)
                return pick(maybe_mask(state, logits), key)

            init_carry = None

    if args.policy != "checkpoint":
        init_carry = None
    metrics = evaluate_policy(cfg, policy_fn, args.episodes, args.seed,
                              init_carry=init_carry)
    for k, v in metrics.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

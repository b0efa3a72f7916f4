"""Policy serving: self-describing checkpoints + inference API.

Capability parity with the reference stack's deployment path —
``Algorithm.from_checkpoint()`` / ``Policy.from_checkpoint()`` +
``compute_single_action()`` / ``compute_actions()`` (SURVEY.md L4/C13,
[API] tier; the reference mount is empty, so the RLlib public contract
is the parity surface). The train CLI drops a ``policy_meta.json`` next
to the step dirs, making a checkpoint directory self-describing:
``Policy.from_checkpoint(dir)`` rebuilds the env config and model
without any re-specified flags.

Notes: the forward pass is one jitted function closed over
the params; batched serving (``compute_actions`` on [B, A, obs_dim])
is the intended hot path — single-obs serving reuses the same compiled
program with B=1. Recurrent policies expose ``initial_state()`` and
thread the carry exactly like RLlib's ``state_outs``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from .config import EnvConfig, TrainConfig

META_NAME = "policy_meta.json"


def write_policy_meta(
    checkpoint_dir: str,
    env_cfg: EnvConfig,
    tcfg: TrainConfig,
    arch: str = "mlp",
    policy_groups: tuple | None = None,
) -> str:
    """Write the serving metadata the train CLI knows at save time."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    meta = {
        "env_config": json.loads(env_cfg.to_json()),
        "arch": arch,
        "hidden_dim": tcfg.hidden_dim,
        "num_layers": tcfg.num_layers,
        "model_dtype": tcfg.model_dtype,
        "mask_actions": tcfg.mask_actions,
        "policy_groups": (
            list(policy_groups) if policy_groups is not None else None
        ),
    }
    path = os.path.join(checkpoint_dir, META_NAME)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


class Policy:
    """A trained policy ready for inference.

    ``compute_actions`` takes obs of shape [B, A, obs_dim] (or
    [A, obs_dim], auto-promoted) and returns int32 actions [B, A].
    ``explore=True`` samples the categorical head (RLlib
    ``explore=True`` parity); default is greedy argmax. If the policy
    was trained with ``--mask-actions``, pass ``agent_pos`` ([B, A, 2])
    so invalid-move logits are floored exactly as in training — the
    dict-API helper does this automatically from the wrapper state.
    """

    def __init__(
        self,
        env_cfg: EnvConfig,
        model: Any,
        params: Any,
        arch: str = "mlp",
        mask_actions: bool = False,
        policy_groups: tuple | None = None,
    ):
        import jax
        import jax.numpy as jnp

        from .ops.move import valid_action_mask

        self.env_cfg = env_cfg
        self.model = model
        self.params = params
        self.arch = arch
        self.mask_actions = mask_actions
        self.recurrent = arch in ("gru", "lstm")
        groups = (
            jnp.asarray(policy_groups, jnp.int32)
            if policy_groups is not None else None
        )
        A = env_cfg.num_agents

        def fwd(params, obs, carry, agent_pos, key, explore):
            if groups is not None:
                gids = jnp.broadcast_to(
                    groups[None], (obs.shape[0], A)
                )
                logits, _ = model.apply(params, obs, gids)
            elif self.recurrent:
                logits, _, carry = model.apply(params, obs, carry)
            else:
                logits, _ = model.apply(params, obs)
            if mask_actions and agent_pos is not None:
                mask = jax.vmap(
                    lambda p: valid_action_mask(env_cfg, p)
                )(agent_pos)
                logits = jnp.where(mask, logits, -1e9)
            if explore:
                action = jax.random.categorical(key, logits)
            else:
                action = jnp.argmax(logits, axis=-1)
            return action.astype(jnp.int32), carry

        # Two jitted variants (explore is a python bool -> static).
        self._fwd = {
            e: jax.jit(lambda p, o, c, ap, k, _e=e: fwd(p, o, c, ap, k, _e))
            for e in (False, True)
        }
        self._key = jax.random.PRNGKey(0)

    # ------------------------------------------------------------- API
    @classmethod
    def from_checkpoint(
        cls, checkpoint_dir: str, step: int | None = None
    ) -> "Policy":
        """Rebuild model + params from a self-describing checkpoint dir."""
        import jax.numpy as jnp

        from .models import make_model, make_multi_policy_model
        from .train.checkpoint import restore_params

        meta_path = os.path.join(checkpoint_dir, META_NAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found — checkpoint predates the serving "
                "metadata; rebuild the model manually and use Policy(...)"
            )
        with open(meta_path) as f:
            meta = json.load(f)
        env_cfg = EnvConfig.from_dict(meta["env_config"])
        dtype = (
            jnp.bfloat16 if meta.get("model_dtype") == "bfloat16"
            else jnp.float32
        )
        groups = meta.get("policy_groups")
        if groups is not None:
            model = make_multi_policy_model(
                env_cfg, tuple(groups), arch=meta["arch"],
                hidden_dim=meta["hidden_dim"],
                num_layers=meta["num_layers"], dtype=dtype,
            )
        else:
            model = make_model(
                env_cfg, arch=meta["arch"], hidden_dim=meta["hidden_dim"],
                num_layers=meta["num_layers"], dtype=dtype,
            )
        params = restore_params(checkpoint_dir, step)
        return cls(
            env_cfg, model, params, arch=meta["arch"],
            mask_actions=meta.get("mask_actions", False),
            policy_groups=tuple(groups) if groups is not None else None,
        )

    def initial_state(self, batch_size: int = 1):
        """Initial recurrent carry (RLlib ``get_initial_state`` parity);
        None for feed-forward policies."""
        if not self.recurrent:
            return None
        return self.model.initial_carry(
            (batch_size, self.env_cfg.num_agents)
        )

    def compute_actions(
        self,
        obs,
        state=None,
        explore: bool = False,
        seed: int | None = None,
        agent_pos=None,
    ):
        """obs float32[B, A, obs_dim] → (int32[B, A] actions, next carry)."""
        import jax
        import jax.numpy as jnp

        obs = jnp.asarray(obs, jnp.float32)
        if obs.ndim == 2:  # [A, obs_dim] convenience
            acts, carry = self.compute_actions(
                obs[None], state, explore, seed,
                None if agent_pos is None else jnp.asarray(agent_pos)[None],
            )
            return acts[0], carry
        if self.recurrent and state is None:
            state = self.initial_state(obs.shape[0])
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._key, key = jax.random.split(self._key)
        if agent_pos is not None:
            agent_pos = jnp.asarray(agent_pos, jnp.int32)
        actions, carry = self._fwd[bool(explore)](
            self.params, obs, state, agent_pos, key
        )
        return actions, carry

    def compute_single_action(
        self, obs, state=None, explore: bool = False,
        seed: int | None = None, agent_pos=None,
    ):
        """One env's obs [A, obs_dim] → int actions [A] (+ carry)."""
        actions, carry = self.compute_actions(
            obs, state, explore, seed, agent_pos
        )
        return np.asarray(actions), carry

    def compute_actions_dict(
        self, env, obs_dict: dict, state=None, explore: bool = False,
        seed: int | None = None,
    ) -> tuple[dict, Any]:
        """Dict-API serving against a ``WarehouseMultiAgentEnv``:
        {agent_i: obs} → {agent_i: int action}. Reads agent positions
        from the wrapper's state so mask-trained policies are masked."""
        import jax.numpy as jnp

        A = self.env_cfg.num_agents
        obs = jnp.stack(
            [jnp.asarray(obs_dict[f"agent_{i}"]) for i in range(A)]
        )
        agent_pos = None
        if self.mask_actions:
            agent_pos = np.asarray(env.state.agent_pos)
        actions, carry = self.compute_single_action(
            obs, state, explore, seed, agent_pos
        )
        return (
            {f"agent_{i}": int(actions[i]) for i in range(A)},
            carry,
        )

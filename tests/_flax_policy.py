"""The policy models as flax.linen modules — the layout and math that
``warehouse_tpu.models.policy`` reproduces in plain JAX. Imported only by
tests/test_model.py, under ``pytest.importorskip("flax")``.
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from warehouse_tpu.config import EnvConfig


class ActorCriticMLP(nn.Module):
    num_actions: int
    hidden_dims: Sequence[int] = (128, 128)
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, obs: jax.Array):
        x = obs.astype(self.dtype)
        for h in self.hidden_dims:
            x = nn.Dense(h, dtype=self.dtype,
                         kernel_init=nn.initializers.orthogonal(jnp.sqrt(2)))(x)
            x = nn.tanh(x)
        logits = nn.Dense(
            self.num_actions, dtype=self.dtype,
            kernel_init=nn.initializers.orthogonal(0.01),
        )(x)
        value = nn.Dense(
            1, dtype=self.dtype, kernel_init=nn.initializers.orthogonal(1.0)
        )(x)
        return logits.astype(jnp.float32), value.squeeze(-1).astype(jnp.float32)


class ActorCriticCNN(nn.Module):
    """Conv torso over the obs window channels + feature fusion."""

    num_actions: int
    window_size: int          # S: spatial side of the window/global grid
    in_channels: int = 4      # 4 ego / 5 global (docs/SEMANTICS.md §10)
    channels: Sequence[int] = (16, 32)
    hidden: int = 128
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, obs: jax.Array):
        S, C = self.window_size, self.in_channels
        grid_len = S * S * C
        grid = obs[..., :grid_len].reshape(*obs.shape[:-1], S, S, C)
        feats = obs[..., grid_len:]
        x = grid.astype(self.dtype)
        for ch in self.channels:
            x = nn.Conv(ch, (3, 3), padding="SAME", dtype=self.dtype)(x)
            x = nn.relu(x)
        x = x.reshape(*obs.shape[:-1], -1)
        x = jnp.concatenate([x, feats.astype(self.dtype)], axis=-1)
        x = nn.Dense(self.hidden, dtype=self.dtype)(x)
        x = nn.tanh(x)
        logits = nn.Dense(
            self.num_actions, dtype=self.dtype,
            kernel_init=nn.initializers.orthogonal(0.01),
        )(x)
        value = nn.Dense(
            1, dtype=self.dtype, kernel_init=nn.initializers.orthogonal(1.0)
        )(x)
        return logits.astype(jnp.float32), value.squeeze(-1).astype(jnp.float32)


class ActorCriticAttn(nn.Module):
    """Self-attention torso over the obs-window cells."""

    num_actions: int
    window_size: int              # S: spatial side of the window/grid
    in_channels: int = 4          # 4 ego / 5 global (docs/SEMANTICS.md §10)
    d_model: int = 64
    num_heads: int = 4
    num_blocks: int = 2
    dtype: jnp.dtype = jnp.float32

    @nn.compact
    def __call__(self, obs: jax.Array):
        S, C = self.window_size, self.in_channels
        grid_len = S * S * C
        cells = obs[..., :grid_len].reshape(*obs.shape[:-1], S * S, C)
        feats = obs[..., grid_len:]

        x = nn.Dense(self.d_model, dtype=self.dtype)(cells.astype(self.dtype))
        pos = self.param(
            "pos_embed", nn.initializers.normal(0.02),
            (S * S, self.d_model), self.dtype,
        )
        x = x + pos
        task = nn.Dense(self.d_model, dtype=self.dtype)(
            feats.astype(self.dtype)
        )[..., None, :]                                   # [..., 1, d]
        x = jnp.concatenate([task, x], axis=-2)           # [..., 1+S*S, d]

        for _ in range(self.num_blocks):
            y = nn.LayerNorm(dtype=self.dtype)(x)
            y = nn.MultiHeadDotProductAttention(
                num_heads=self.num_heads, dtype=self.dtype,
                qkv_features=self.d_model,
            )(y, y)
            x = x + y
            y = nn.LayerNorm(dtype=self.dtype)(x)
            y = nn.Dense(4 * self.d_model, dtype=self.dtype)(y)
            y = nn.gelu(y)
            y = nn.Dense(self.d_model, dtype=self.dtype)(y)
            x = x + y

        h = nn.LayerNorm(dtype=self.dtype)(x[..., 0, :])  # [task] token out
        logits = nn.Dense(
            self.num_actions, dtype=self.dtype,
            kernel_init=nn.initializers.orthogonal(0.01),
        )(h)
        value = nn.Dense(
            1, dtype=self.dtype, kernel_init=nn.initializers.orthogonal(1.0)
        )(h)
        return logits.astype(jnp.float32), value.squeeze(-1).astype(jnp.float32)


class ActorCriticRNN(nn.Module):
    """Recurrent actor-critic: MLP encoder → GRU/LSTM cell → heads."""

    num_actions: int
    cell_type: str = "gru"            # "gru" | "lstm"
    hidden_dims: Sequence[int] = (128,)
    rnn_hidden: int = 128
    dtype: jnp.dtype = jnp.float32

    def _cell(self):
        if self.cell_type == "gru":
            return nn.GRUCell(features=self.rnn_hidden, dtype=self.dtype)
        if self.cell_type == "lstm":
            return nn.OptimizedLSTMCell(features=self.rnn_hidden,
                                        dtype=self.dtype)
        raise ValueError(f"unknown cell_type {self.cell_type!r}")

    @nn.compact
    def __call__(self, obs: jax.Array, carry):
        x = obs.astype(self.dtype)
        for h in self.hidden_dims:
            x = nn.Dense(h, dtype=self.dtype,
                         kernel_init=nn.initializers.orthogonal(jnp.sqrt(2)))(x)
            x = nn.tanh(x)
        carry, y = self._cell()(carry, x)
        logits = nn.Dense(
            self.num_actions, dtype=self.dtype,
            kernel_init=nn.initializers.orthogonal(0.01),
        )(y)
        value = nn.Dense(
            1, dtype=self.dtype, kernel_init=nn.initializers.orthogonal(1.0)
        )(y)
        return (logits.astype(jnp.float32),
                value.squeeze(-1).astype(jnp.float32), carry)

    def initial_carry(self, batch_shape: tuple):
        """Zero carry for a batch (deterministic; episode-start state)."""
        h = jnp.zeros((*batch_shape, self.rnn_hidden), self.dtype)
        if self.cell_type == "lstm":
            return (h, h)
        return h


def make_model(cfg: EnvConfig, arch: str = "mlp", hidden_dim: int = 128,
               num_layers: int = 2, dtype=jnp.float32) -> nn.Module:
    if arch == "mlp":
        return ActorCriticMLP(
            num_actions=cfg.num_actions,
            hidden_dims=(hidden_dim,) * num_layers,
            dtype=dtype,
        )
    if arch == "cnn":
        side = cfg.height if cfg.global_obs else cfg.window_size
        if cfg.global_obs and cfg.height != cfg.width:
            raise ValueError("cnn+global_obs requires a square grid")
        return ActorCriticCNN(
            num_actions=cfg.num_actions, window_size=side,
            in_channels=cfg.num_obs_channels,
            hidden=hidden_dim, dtype=dtype,
        )
    if arch == "attn":
        side = cfg.height if cfg.global_obs else cfg.window_size
        if cfg.global_obs and cfg.height != cfg.width:
            raise ValueError("attn+global_obs requires a square grid")
        return ActorCriticAttn(
            num_actions=cfg.num_actions, window_size=side,
            in_channels=cfg.num_obs_channels,
            d_model=hidden_dim // 2, num_blocks=num_layers, dtype=dtype,
        )
    if arch in ("gru", "lstm"):
        return ActorCriticRNN(
            num_actions=cfg.num_actions, cell_type=arch,
            hidden_dims=(hidden_dim,) * max(num_layers - 1, 1),
            rnn_hidden=hidden_dim, dtype=dtype,
        )
    raise ValueError(f"unknown arch {arch!r}")


class MultiPolicyActorCritic(nn.Module):
    """K independent policies with a static agent→policy mapping."""

    policies: Sequence[nn.Module]

    @nn.compact
    def __call__(self, obs: jax.Array, group_ids: jax.Array):
        outs = [p(obs) for p in self.policies]
        logits = jnp.stack([o[0] for o in outs], axis=0)  # [K, ..., 5]
        values = jnp.stack([o[1] for o in outs], axis=0)  # [K, ...]
        k = len(self.policies)
        sel = jax.nn.one_hot(group_ids, k, dtype=logits.dtype)  # [..., K]
        sel_t = jnp.moveaxis(sel, -1, 0)                        # [K, ...]
        logits = (logits * sel_t[..., None]).sum(0)
        values = (values * sel_t).sum(0)
        return logits, values


def make_multi_policy_model(cfg: EnvConfig, policy_groups, arch="mlp",
                            hidden_dim=128, num_layers=2,
                            dtype=jnp.float32):
    """policy_groups: tuple len num_agents of group indices 0..K-1."""
    if len(policy_groups) != cfg.num_agents:
        raise ValueError("policy_groups must have one entry per agent")
    k = max(policy_groups) + 1
    if sorted(set(policy_groups)) != list(range(k)):
        raise ValueError("group ids must be 0..K-1 with no gaps")
    subs = [
        make_model(cfg, arch=arch, hidden_dim=hidden_dim,
                   num_layers=num_layers, dtype=dtype)
        for _ in range(k)
    ]
    return MultiPolicyActorCritic(policies=subs)

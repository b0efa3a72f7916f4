"""Actor-critic policy models in plain ``jax.numpy`` / ``lax``.

The counterpart of the reference stack's Torch/TF policy nets (SURVEY.md
§2.2 row 2): a shared-parameter per-agent actor-critic, XLA compiled,
applied to the flattened (batch·agents) axis so the matmuls stay large.
Torsos:

- ``mlp``: Dense stack over the flat observation (default — windows are
  tiny, a conv adds latency without accuracy here).
- ``cnn``: splits the flat obs back into the (S, S, C) window + 6 features
  (docs/SEMANTICS.md §10) and runs a small conv torso — the "small
  conv/MLP" family the reference trains (SURVEY.md C12 [I]).
- ``attn``: pre-LN transformer blocks over the window cells.
- ``gru`` / ``lstm``: MLP encoder → recurrent cell → heads.

Every model exposes ``init(key, obs[, carry | group_ids]) -> params`` and
``apply(params, obs[, carry | group_ids])``. The parameter tree is the
layout flax.linen gives the same modules — ``{"params": {"Dense_0":
{"kernel", "bias"}, ...}}`` with the same names, shapes and
initialisers, and each leaf drawn from the same key (a SHA-1 fold of its
module path, :func:`_leaf_key`) — so checkpoints written by either load
in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import EnvConfig

_init = jax.nn.initializers
_LECUN = _init.lecun_normal()
_ORTHO_HIDDEN = _init.orthogonal(np.sqrt(2.0))
_ORTHO_LOGITS = _init.orthogonal(0.01)
_ORTHO_VALUE = _init.orthogonal(1.0)
_ORTHO_RECURRENT = _init.orthogonal()
_LN_EPS = 1e-6


def _leaf_key(key: jax.Array, *path) -> jax.Array:
    """The key of one parameter: ``key`` folded with the SHA-1 of its
    module path and its 1-based index within its module (strings as
    UTF-8, ints big-endian) — flax.linen's derivation, so both inits
    draw identical values."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def _dense_init(key, path, fan_in, features, kernel_init=_LECUN,
                use_bias=True):
    p = {"kernel": kernel_init(_leaf_key(key, *path, 1),
                               (fan_in, features), jnp.float32)}
    if use_bias:
        p["bias"] = jnp.zeros((features,), jnp.float32)
    return p


def _dense(p, x, dtype):
    """``x @ kernel + bias``, all cast to the compute dtype."""
    x = x.astype(dtype)
    y = lax.dot_general(x, p["kernel"].astype(dtype),
                        (((x.ndim - 1,), (0,)), ((), ())))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def _heads_init(key, path, p, n, fan_in, num_actions):
    """Policy head ``Dense_n`` and value head ``Dense_{n+1}``."""
    p[f"Dense_{n}"] = _dense_init(key, (*path, f"Dense_{n}"), fan_in,
                                  num_actions, _ORTHO_LOGITS)
    p[f"Dense_{n + 1}"] = _dense_init(key, (*path, f"Dense_{n + 1}"),
                                      fan_in, 1, _ORTHO_VALUE)


def _heads(p, n, x, dtype):
    logits = _dense(p[f"Dense_{n}"], x, dtype)
    value = _dense(p[f"Dense_{n + 1}"], x, dtype)
    return logits.astype(jnp.float32), value[..., 0].astype(jnp.float32)


def _layer_norm(p, x, dtype):
    """LayerNorm over the last axis; statistics in at least float32
    (E[x²] − E[x]², clipped at 0), ε = 1e-6."""
    xf = x.astype(jnp.promote_types(dtype, jnp.float32))
    mu = xf.mean(-1, keepdims=True)
    var = jnp.maximum(0.0, (xf * xf).mean(-1, keepdims=True) - mu * mu)
    y = (x - mu) * (lax.rsqrt(var + _LN_EPS) * p["scale"]) + p["bias"]
    return y.astype(dtype)


class _Model:
    """``init``/``apply`` around a subclass's ``_init``/``_apply`` on
    the inner parameter dict (module path prefix ``path``)."""

    def init(self, key: jax.Array, obs: jax.Array, *args) -> dict:
        return {"params": self._init(key, (), obs.shape[-1])}

    def apply(self, params: dict, obs: jax.Array, *args):
        return self._apply(params["params"], obs, *args)


@dataclasses.dataclass(frozen=True)
class ActorCriticMLP(_Model):
    num_actions: int
    hidden_dims: Sequence[int] = (128, 128)
    dtype: Any = jnp.float32

    def _init(self, key, path, obs_dim):
        p, fan_in = {}, obs_dim
        for i, h in enumerate(self.hidden_dims):
            p[f"Dense_{i}"] = _dense_init(key, (*path, f"Dense_{i}"),
                                          fan_in, h, _ORTHO_HIDDEN)
            fan_in = h
        _heads_init(key, path, p, len(self.hidden_dims), fan_in,
                    self.num_actions)
        return p

    def _apply(self, p, obs):
        x = obs.astype(self.dtype)
        for i in range(len(self.hidden_dims)):
            x = jnp.tanh(_dense(p[f"Dense_{i}"], x, self.dtype))
        return _heads(p, len(self.hidden_dims), x, self.dtype)


@dataclasses.dataclass(frozen=True)
class ActorCriticCNN(_Model):
    """Conv torso over the obs window channels + feature fusion."""

    num_actions: int
    window_size: int          # S: spatial side of the window/global grid
    in_channels: int = 4      # 4 ego / 5 global (docs/SEMANTICS.md §10)
    channels: Sequence[int] = (16, 32)
    hidden: int = 128
    dtype: Any = jnp.float32

    def _init(self, key, path, obs_dim):
        S, C = self.window_size, self.in_channels
        p, cin = {}, C
        for i, ch in enumerate(self.channels):
            p[f"Conv_{i}"] = {
                "kernel": _LECUN(_leaf_key(key, *path, f"Conv_{i}", 1),
                                 (3, 3, cin, ch), jnp.float32),
                "bias": jnp.zeros((ch,), jnp.float32),
            }
            cin = ch
        fan_in = S * S * cin + obs_dim - S * S * C
        p["Dense_0"] = _dense_init(key, (*path, "Dense_0"), fan_in,
                                   self.hidden)
        _heads_init(key, path, p, 1, self.hidden, self.num_actions)
        return p

    def _apply(self, p, obs):
        S, C = self.window_size, self.in_channels
        batch = obs.shape[:-1]
        grid_len = S * S * C
        x = obs[..., :grid_len].reshape(-1, S, S, C).astype(self.dtype)
        for i in range(len(self.channels)):
            conv = p[f"Conv_{i}"]
            x = lax.conv_general_dilated(
                x, conv["kernel"].astype(self.dtype), (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            x = jax.nn.relu(x + conv["bias"].astype(self.dtype))
        x = x.reshape(*batch, -1)
        x = jnp.concatenate(
            [x, obs[..., grid_len:].astype(self.dtype)], axis=-1)
        x = jnp.tanh(_dense(p["Dense_0"], x, self.dtype))
        return _heads(p, 1, x, self.dtype)


@dataclasses.dataclass(frozen=True)
class ActorCriticAttn(_Model):
    """Self-attention torso over the obs-window cells.

    Capability parity with RLlib's ``use_attention`` model option
    (SURVEY.md C12 [API] — RLlib wires a GTrXL attention net when the
    flag is set). The S*S window cells become tokens (cell channels →
    d_model with a learned positional embedding), the 6 scalar task
    features become one extra [task] token, and ``num_blocks`` pre-LN
    transformer encoder blocks attend over them through
    ``jax.nn.dot_product_attention``; the [task] token's output feeds
    the policy/value heads. Token count is static (S*S + 1 ≤ 122 for the
    large preset): no masking, no KV cache (episode memory is the RNN
    family's job; this is the spatial-attention family).
    """

    num_actions: int
    window_size: int              # S: spatial side of the window/grid
    in_channels: int = 4          # 4 ego / 5 global (docs/SEMANTICS.md §10)
    d_model: int = 64
    num_heads: int = 4
    num_blocks: int = 2
    dtype: Any = jnp.float32

    def _init(self, key, path, obs_dim):
        S, C, d = self.window_size, self.in_channels, self.d_model
        nh, hd = self.num_heads, self.d_model // self.num_heads
        p = {
            "Dense_0": _dense_init(key, (*path, "Dense_0"), C, d),
            # The one parameter owned by the torso itself (index 1).
            "pos_embed": _init.normal(0.02)(
                _leaf_key(key, *path, 1), (S * S, d), self.dtype),
            "Dense_1": _dense_init(key, (*path, "Dense_1"),
                                   obs_dim - S * S * C, d),
        }
        for b in range(self.num_blocks):
            mha = f"MultiHeadDotProductAttention_{b}"
            p[mha] = {}
            for name in ("query", "key", "value"):
                k = _LECUN(_leaf_key(key, *path, mha, name, 1),
                           (d, nh * hd), jnp.float32)
                p[mha][name] = {"kernel": k.reshape(d, nh, hd),
                                "bias": jnp.zeros((nh, hd), jnp.float32)}
            k = _LECUN(_leaf_key(key, *path, mha, "out", 1),
                       (nh * hd, d), jnp.float32)
            p[mha]["out"] = {"kernel": k.reshape(nh, hd, d),
                             "bias": jnp.zeros((d,), jnp.float32)}
            for i in (2 * b, 2 * b + 1):
                p[f"LayerNorm_{i}"] = {"scale": jnp.ones((d,), jnp.float32),
                                       "bias": jnp.zeros((d,), jnp.float32)}
            p[f"Dense_{2 + 2 * b}"] = _dense_init(
                key, (*path, f"Dense_{2 + 2 * b}"), d, 4 * d)
            p[f"Dense_{3 + 2 * b}"] = _dense_init(
                key, (*path, f"Dense_{3 + 2 * b}"), 4 * d, d)
        nb = self.num_blocks
        p[f"LayerNorm_{2 * nb}"] = {"scale": jnp.ones((d,), jnp.float32),
                                    "bias": jnp.zeros((d,), jnp.float32)}
        _heads_init(key, path, p, 2 + 2 * nb, d, self.num_actions)
        return p

    def _attention(self, p, y):
        dt = self.dtype

        def proj(name):
            w = p[name]
            return (jnp.einsum("...td,dnh->...tnh", y, w["kernel"].astype(dt))
                    + w["bias"].astype(dt))

        q, k, v = proj("query"), proj("key"), proj("value")
        lead, tail = q.shape[:-3], q.shape[-3:]
        x = jax.nn.dot_product_attention(
            q.reshape(-1, *tail), k.reshape(-1, *tail),
            v.reshape(-1, *tail)).reshape(*lead, *tail)
        out = p["out"]
        return (jnp.einsum("...tnh,nhd->...td", x, out["kernel"].astype(dt))
                + out["bias"].astype(dt))

    def _apply(self, p, obs):
        S, C, dt = self.window_size, self.in_channels, self.dtype
        grid_len = S * S * C
        cells = obs[..., :grid_len].reshape(*obs.shape[:-1], S * S, C)
        x = _dense(p["Dense_0"], cells, dt) + p["pos_embed"]
        task = _dense(p["Dense_1"], obs[..., grid_len:], dt)[..., None, :]
        x = jnp.concatenate([task, x], axis=-2)           # [..., 1+S*S, d]
        for b in range(self.num_blocks):
            y = _layer_norm(p[f"LayerNorm_{2 * b}"], x, dt)
            x = x + self._attention(
                p[f"MultiHeadDotProductAttention_{b}"], y)
            y = _layer_norm(p[f"LayerNorm_{2 * b + 1}"], x, dt)
            y = jax.nn.gelu(_dense(p[f"Dense_{2 + 2 * b}"], y, dt))
            x = x + _dense(p[f"Dense_{3 + 2 * b}"], y, dt)
        nb = self.num_blocks
        h = _layer_norm(p[f"LayerNorm_{2 * nb}"], x[..., 0, :], dt)
        return _heads(p, 2 + 2 * nb, h, dt)


@dataclasses.dataclass(frozen=True)
class ActorCriticRNN(_Model):
    """Recurrent actor-critic: MLP encoder → GRU/LSTM cell → heads.

    Capability parity with RLlib's ``use_lstm`` model option (SURVEY.md
    C12 [API]): the policy carries per-agent recurrent state across env
    steps, reset to zeros at episode boundaries. Same shared-parameter
    per-agent application as the feedforward models; the carry is part
    of the caller's loop state (``train/ppo_rnn.py`` threads it through
    the rollout scan and replays it sequence-wise in the loss).

    ``apply(params, obs, carry) -> (logits, value, new_carry)`` — one
    step. GRU: ``r = σ(W_ir x + b_ir + W_hr h)``, ``z = σ(W_iz x + b_iz
    + W_hz h)``, ``n = tanh(W_in x + b_in + r·(W_hn h + b_hn))``,
    ``h' = (1 − z)·n + z·h``. LSTM (carry ``(c, h)``): gates
    ``i, f, o = σ(W_h· h + b_h· + W_i· x)``, ``g = tanh(...)``,
    ``c' = f·c + i·g``, ``h' = o·tanh(c')``.
    """

    num_actions: int
    cell_type: str = "gru"            # "gru" | "lstm"
    hidden_dims: Sequence[int] = (128,)
    rnn_hidden: int = 128
    dtype: Any = jnp.float32

    def __post_init__(self):
        if self.cell_type not in ("gru", "lstm"):
            raise ValueError(f"unknown cell_type {self.cell_type!r}")

    @property
    def _cell_name(self):
        return "GRUCell_0" if self.cell_type == "gru" else "OptimizedLSTMCell_0"

    def _init(self, key, path, obs_dim):
        p, fan_in = {}, obs_dim
        for i, h in enumerate(self.hidden_dims):
            p[f"Dense_{i}"] = _dense_init(key, (*path, f"Dense_{i}"),
                                          fan_in, h, _ORTHO_HIDDEN)
            fan_in = h
        H, cp = self.rnn_hidden, (*path, self._cell_name)
        if self.cell_type == "gru":
            # (name, kernel init, bias) in creation order.
            layers = (("ir", _LECUN, True), ("hr", _ORTHO_RECURRENT, False),
                      ("iz", _LECUN, True), ("hz", _ORTHO_RECURRENT, False),
                      ("in", _LECUN, True), ("hn", _ORTHO_RECURRENT, True))
        else:
            layers = tuple(
                x for g in "ifgo"
                for x in ((f"i{g}", _LECUN, False),
                          (f"h{g}", _ORTHO_RECURRENT, True)))
        p[self._cell_name] = {
            name: _dense_init(key, (*cp, name),
                              fan_in if name[0] == "i" else H, H, init, bias)
            for name, init, bias in layers
        }
        _heads_init(key, path, p, len(self.hidden_dims), H,
                    self.num_actions)
        return p

    def _cell(self, p, carry, x):
        dt = self.dtype
        if self.cell_type == "gru":
            h = carry
            r = jax.nn.sigmoid(_dense(p["ir"], x, dt) + _dense(p["hr"], h, dt))
            z = jax.nn.sigmoid(_dense(p["iz"], x, dt) + _dense(p["hz"], h, dt))
            n = jnp.tanh(_dense(p["in"], x, dt)
                         + r * _dense(p["hn"], h, dt))
            new_h = (1.0 - z) * n + z * h
            return new_h, new_h
        c, h = carry
        g = {k: _dense(p[f"h{k}"], h, dt) + _dense(p[f"i{k}"], x, dt)
             for k in "ifgo"}
        new_c = (jax.nn.sigmoid(g["f"]) * c
                 + jax.nn.sigmoid(g["i"]) * jnp.tanh(g["g"]))
        new_h = jax.nn.sigmoid(g["o"]) * jnp.tanh(new_c)
        return (new_c, new_h), new_h

    def _apply(self, p, obs, carry):
        x = obs.astype(self.dtype)
        for i in range(len(self.hidden_dims)):
            x = jnp.tanh(_dense(p[f"Dense_{i}"], x, self.dtype))
        carry, y = self._cell(p[self._cell_name], carry, x)
        logits, value = _heads(p, len(self.hidden_dims), y, self.dtype)
        return logits, value, carry

    def initial_carry(self, batch_shape: tuple):
        """Zero carry for a batch (deterministic; episode-start state)."""
        h = jnp.zeros((*batch_shape, self.rnn_hidden), self.dtype)
        if self.cell_type == "lstm":
            return (h, h)
        return h


def make_model(cfg: EnvConfig, arch: str = "mlp", hidden_dim: int = 128,
               num_layers: int = 2, dtype=jnp.float32) -> _Model:
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


@dataclasses.dataclass(frozen=True)
class MultiPolicyActorCritic(_Model):
    """K independent policies with a static agent→policy mapping.

    Capability parity with RLlib's multi-agent ``policies`` +
    ``policy_mapping_fn`` (SURVEY.md C12/[API]): heterogeneous policies
    per agent group, one parameter tree per group (``policies_k``),
    dispatched by a per-sample group id. All K forwards are computed and
    selected per sample — exact, vmap/shard-friendly, and cheap for the
    small K this workload uses.
    """

    policies: Sequence[_Model]

    def _init(self, key, path, obs_dim):
        return {f"policies_{k}": m._init(key, (*path, f"policies_{k}"),
                                         obs_dim)
                for k, m in enumerate(self.policies)}

    def _apply(self, p, obs, group_ids):
        outs = [m._apply(p[f"policies_{k}"], obs)
                for k, m in enumerate(self.policies)]
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
    subs = tuple(
        make_model(cfg, arch=arch, hidden_dim=hidden_dim,
                   num_layers=num_layers, dtype=dtype)
        for _ in range(k)
    )
    return MultiPolicyActorCritic(policies=subs)

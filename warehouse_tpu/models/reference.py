"""NumPy float64 forward passes of the policy models — the reference the
JAX models are compared against (tests/test_model.py, chip_smoke.py).

Independent of ``policy.py``'s code: plain loops and ``numpy`` in float64
over the same parameter tree, with the textbook formulas (exact
LayerNorm variance, explicit softmax attention, GRU/LSTM gate
equations as documented on ``ActorCriticRNN``).
"""

from __future__ import annotations

import numpy as np

from .policy import (ActorCriticAttn, ActorCriticCNN, ActorCriticMLP,
                     ActorCriticRNN, MultiPolicyActorCritic)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def _dense(p, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _gelu(x):
    return 0.5 * x * (1.0 + np.tanh(
        np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


def _layer_norm(p, x, eps=1e-6):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * p["scale"] + p["bias"]


def _conv3x3_same(x, kernel, bias):
    """[N, S, S, Cin] x [3, 3, Cin, Cout] cross-correlation, zero pad 1."""
    n, s, _, _ = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((n, s, s, kernel.shape[-1]))
    for di in range(3):
        for dj in range(3):
            out += xp[:, di:di + s, dj:dj + s, :] @ kernel[di, dj]
    return out + bias


def _heads(p, n, x):
    return _dense(p[f"Dense_{n}"], x), _dense(p[f"Dense_{n + 1}"], x)[..., 0]


def _mlp(m, p, obs):
    x = obs
    for i in range(len(m.hidden_dims)):
        x = np.tanh(_dense(p[f"Dense_{i}"], x))
    return _heads(p, len(m.hidden_dims), x)


def _cnn(m, p, obs):
    S, C = m.window_size, m.in_channels
    grid_len = S * S * C
    x = obs[..., :grid_len].reshape(-1, S, S, C)
    for i in range(len(m.channels)):
        conv = p[f"Conv_{i}"]
        x = np.maximum(_conv3x3_same(x, conv["kernel"], conv["bias"]), 0.0)
    x = np.concatenate(
        [x.reshape(*obs.shape[:-1], -1), obs[..., grid_len:]], axis=-1)
    return _heads(p, 1, np.tanh(_dense(p["Dense_0"], x)))


def _attention(m, p, y):
    hd = m.d_model // m.num_heads
    q, k, v = (np.einsum("...td,dnh->...nth", y, p[name]["kernel"])
               + p[name]["bias"][:, None, :]
               for name in ("query", "key", "value"))
    s = q @ np.swapaxes(k, -1, -2) / np.sqrt(hd)        # [..., n, t, t]
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    x = w @ v                                          # [..., n, t, h]
    return (np.einsum("...nth,nhd->...td", x, p["out"]["kernel"])
            + p["out"]["bias"])


def _attn(m, p, obs):
    S, C = m.window_size, m.in_channels
    grid_len = S * S * C
    cells = obs[..., :grid_len].reshape(*obs.shape[:-1], S * S, C)
    x = _dense(p["Dense_0"], cells) + p["pos_embed"]
    task = _dense(p["Dense_1"], obs[..., grid_len:])[..., None, :]
    x = np.concatenate([task, x], axis=-2)
    for b in range(m.num_blocks):
        y = _layer_norm(p[f"LayerNorm_{2 * b}"], x)
        x = x + _attention(m, p[f"MultiHeadDotProductAttention_{b}"], y)
        y = _layer_norm(p[f"LayerNorm_{2 * b + 1}"], x)
        x = x + _dense(p[f"Dense_{3 + 2 * b}"],
                       _gelu(_dense(p[f"Dense_{2 + 2 * b}"], y)))
    nb = m.num_blocks
    h = _layer_norm(p[f"LayerNorm_{2 * nb}"], x[..., 0, :])
    return _heads(p, 2 + 2 * nb, h)


def _rnn(m, p, obs, carry):
    x = obs
    for i in range(len(m.hidden_dims)):
        x = np.tanh(_dense(p[f"Dense_{i}"], x))
    n = len(m.hidden_dims)
    if m.cell_type == "gru":
        c = p["GRUCell_0"]
        h = carry
        r = _sigmoid(_dense(c["ir"], x) + _dense(c["hr"], h))
        z = _sigmoid(_dense(c["iz"], x) + _dense(c["hz"], h))
        nn = np.tanh(_dense(c["in"], x) + r * _dense(c["hn"], h))
        h = (1.0 - z) * nn + z * h
        logits, value = _heads(p, n, h)
        return logits, value, h
    c = p["OptimizedLSTMCell_0"]
    cell, h = carry
    gate = {k: _dense(c[f"i{k}"], x) + _dense(c[f"h{k}"], h) for k in "ifgo"}
    cell = (_sigmoid(gate["f"]) * cell
            + _sigmoid(gate["i"]) * np.tanh(gate["g"]))
    h = _sigmoid(gate["o"]) * np.tanh(cell)
    logits, value = _heads(p, n, h)
    return logits, value, (cell, h)


def _inner(m, p, obs, extra):
    if isinstance(m, ActorCriticMLP):
        return _mlp(m, p, obs)
    if isinstance(m, ActorCriticCNN):
        return _cnn(m, p, obs)
    if isinstance(m, ActorCriticAttn):
        return _attn(m, p, obs)
    if isinstance(m, ActorCriticRNN):
        return _rnn(m, p, obs, extra)
    if isinstance(m, MultiPolicyActorCritic):
        outs = [_inner(sub, p[f"policies_{k}"], obs, None)
                for k, sub in enumerate(m.policies)]
        gid = np.asarray(extra)
        logits = np.choose(gid[..., None], [o[0] for o in outs])
        values = np.choose(gid, [o[1] for o in outs])
        return logits, values
    raise TypeError(f"no reference for {type(m).__name__}")


def reference_apply(model, params, obs, extra=None):
    """float64 twin of ``model.apply(params, obs[, extra])``: ``extra``
    is the recurrent carry or the per-sample policy-group ids."""
    if isinstance(extra, tuple):
        extra = tuple(np.asarray(e, np.float64) for e in extra)
    elif extra is not None and not isinstance(model, MultiPolicyActorCritic):
        extra = np.asarray(extra, np.float64)
    return _inner(model, _f64(params["params"]),
                  np.asarray(obs, np.float64), extra)

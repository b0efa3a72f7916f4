"""Shared PPO update machinery (loss, epoch/minibatch scan, schedules).

One implementation of the clipped-surrogate loss and the epoch/minibatch
SGD scaffolding, used by every PPO-family trainer — ``train/ppo.py``
(feed-forward, flat [T·B·A] minibatches), ``train/ppo_rnn.py``
(sequence minibatches over the env axis), and ``train/pbt.py`` (vmapped
population members). Extracted per round-1 review: four hand-rolled
copies had already drifted (PBT silently lacked masking/shaping/KL).

Everything here is shape-polymorphic over trailing axes and pure, so it
jits, vmaps (PBT population axis), and runs under ``shard_map``
unchanged — the caller decides where the grad ``pmean`` axis lives via
``pmean_axis``.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import optax

NEG_INF = -1e9  # logits floor for masked (invalid) actions


def sample_action(key: jax.Array, logits: jax.Array):
    """Categorical sample + its log-prob from (already masked) logits.

    Returns ``(action int32[...], log_prob float32[...])``.

    Layout: the gumbel noise, argmax, and log-softmax all run on the
    ``[n_act, N]`` transpose, with the long axis minor (same discipline
    as ``action_log_prob_entropy``). The explicit-gumbel form pins the
    draw stream: ``gumbel(key, [n_act, N])``.
    """
    n_act = logits.shape[-1]
    lt = logits.reshape(-1, n_act).T                    # [n_act, N]
    g = jax.random.gumbel(key, lt.shape, lt.dtype)
    action = jnp.argmax(lt + g, axis=0).astype(jnp.int32)
    logp = jax.nn.log_softmax(lt, axis=0)
    onehot = jax.nn.one_hot(action, n_act, dtype=logp.dtype).T
    lp = (logp * onehot).sum(0)
    shape = logits.shape[:-1]
    return action.reshape(shape), lp.reshape(shape)


def ppo_losses(
    logits: jax.Array,      # float32[..., num_actions] — post-mask
    value: jax.Array,       # float32[...]
    action: jax.Array,      # int32[...]
    old_log_prob: jax.Array,
    old_value: jax.Array,
    advantages: jax.Array,
    targets: jax.Array,
    *,
    clip_eps: float,
    value_coef: float,
    ent_coef,               # float or traced scalar (anneal / PBT member)
    kl_coeff,               # float or traced scalar (adaptive KL state)
    normalize_adv: bool = True,  # False: advantages arrive pre-normalized
    #                              (micro-batch mode normalizes once per
    #                              minibatch so micro grads sum exactly)
):
    """Clipped-surrogate PPO loss with clipped value loss, entropy bonus
    and RLlib-style KL penalty (zero-cost when ``kl_coeff == 0``).

    Returns ``(total, (pg_loss, v_loss, entropy, kl))`` — the aux tuple
    order every trainer's metrics dict relies on.

    Layout: the softmax/entropy chain runs on logits TRANSPOSED to
    ``[num_actions, N]`` so the long axis is minor rather than the
    5-wide action axis. Same math, one [5, N] transpose each for logits
    and the action one-hot.
    """
    lp, entropy = action_log_prob_entropy(logits, action)
    ratio = jnp.exp(lp - old_log_prob)
    if normalize_adv:
        adv_n = (advantages - advantages.mean()) / (
            advantages.std() + 1e-8)
    else:
        adv_n = advantages
    pg1 = ratio * adv_n
    pg2 = jnp.clip(ratio, 1 - clip_eps, 1 + clip_eps) * adv_n
    pg_loss = -jnp.minimum(pg1, pg2).mean()
    v_clip = old_value + jnp.clip(value - old_value, -clip_eps, clip_eps)
    v_loss = 0.5 * jnp.maximum(
        (value - targets) ** 2, (v_clip - targets) ** 2
    ).mean()
    # Approx KL(old || new), RLlib-style penalty term.
    kl = (old_log_prob - lp).mean()
    total = pg_loss + value_coef * v_loss - ent_coef * entropy + kl_coeff * kl
    return total, (pg_loss, v_loss, entropy, kl)


def action_log_prob_entropy(logits: jax.Array, action: jax.Array):
    """(log π(a|s) with action's shape, mean entropy) from logits
    ``[..., n_act]`` — computed on the ``[n_act, N]`` transpose (see
    ppo_losses' layout note). Shared by the PPO loss and IMPALA's
    V-trace loss.
    """
    n_act = logits.shape[-1]
    lt = logits.reshape(-1, n_act).T                    # [n_act, N]
    logp = jax.nn.log_softmax(lt, axis=0)
    onehot = jax.nn.one_hot(
        action.reshape(-1), n_act, dtype=logp.dtype
    ).T
    lp = (logp * onehot).sum(0).reshape(action.shape)
    entropy = -(jnp.exp(logp) * logp).sum(0).mean()
    return lp, entropy


def entropy_coef_at(tcfg, update_idx: jax.Array):
    """Linear entropy-coefficient anneal (TrainConfig.entropy_coef_final;
    negative = disabled → constant coefficient)."""
    if tcfg.entropy_coef_final >= 0.0:
        frac = update_idx.astype(jnp.float32) / max(tcfg.num_updates, 1)
        return tcfg.entropy_coef + frac * (
            tcfg.entropy_coef_final - tcfg.entropy_coef
        )
    return jnp.float32(tcfg.entropy_coef)


def adaptive_kl_coeff(tcfg, kl_coeff: jax.Array, mean_kl: jax.Array):
    """RLlib's adaptive KL rule: ×1.5 above 2× target, ×0.5 below 0.5×.
    Identity when the penalty is disabled."""
    if tcfg.kl_coeff > 0.0 and tcfg.adaptive_kl:
        return jnp.where(
            mean_kl > 2.0 * tcfg.kl_target, kl_coeff * 1.5,
            jnp.where(
                mean_kl < 0.5 * tcfg.kl_target, kl_coeff * 0.5, kl_coeff
            ),
        )
    return kl_coeff


def flat_minibatches(key: jax.Array, batch, num_minibatches: int):
    """Shuffle a tuple of [N, ...] arrays and split the leading axis into
    ``[num_minibatches, N/num_minibatches, ...]`` (feed-forward PPO's
    epoch shuffle)."""
    n = jax.tree.leaves(batch)[0].shape[0]
    perm = jax.random.permutation(key, n)
    mb_size = n // num_minibatches
    return jax.tree.map(
        lambda x: x[perm].reshape(num_minibatches, mb_size, *x.shape[1:]),
        batch,
    )


def minibatch_epochs(
    params,
    opt_state,
    key: jax.Array,
    *,
    loss_fn: Callable,            # (params, minibatch) -> (loss, aux)
    make_minibatches: Callable,   # key -> pytree with leading [M, ...] axis
    num_epochs: int,
    tx: optax.GradientTransformation,
    pmean_axis: str | None = None,
    micro_batches: int = 1,
    reshuffle_each_epoch: bool = True,
):
    """The PPO epoch/minibatch SGD scaffold as two nested ``lax.scan``s.

    Each epoch draws a fresh shuffle via ``make_minibatches`` and scans
    gradient updates over the minibatch axis
    (``reshuffle_each_epoch=False`` draws ONE shuffle per call instead
    — ``TrainConfig.epoch_shuffle="once"``); ``pmean_axis`` (under
    ``shard_map``) syncs grads/metrics across data shards. Returns
    ``(params, opt_state, key, losses)`` with losses stacked
    ``[num_epochs, M, 1 + len(aux)]``-style (tuple of arrays).

    ``micro_batches > 1`` splits each minibatch's gradient into K
    equal-size micro-batch grads, averaged before ONE optimizer step —
    the same gradient up to f32 summation order, so it bounds the
    per-grad working set without changing the SGD trajectory. The caller
    must make its loss micro-size-invariant: means only, and advantage
    normalization hoisted to per-minibatch (``ppo_losses``'s
    ``normalize_adv=False`` path).
    """

    vg = jax.value_and_grad(loss_fn, has_aux=True)

    fixed_minibatches = None
    if not reshuffle_each_epoch:
        # "once" mode: one permutation per update; every epoch revisits
        # the same minibatch partition. Removes ppo_epochs-1 full-batch
        # permutation gathers. With num_epochs == 1 this is draw-for-draw identical to
        # reshuffling (tests/test_ppo.py).
        key, pkey = jax.random.split(key)
        fixed_minibatches = make_minibatches(pkey)

    def epoch(carry, _):
        params, opt_state, key = carry
        if fixed_minibatches is None:
            key, pkey = jax.random.split(key)
            minibatches = make_minibatches(pkey)
        else:
            minibatches = fixed_minibatches

        def mb_update(c, mb):
            params, opt_state = c
            if micro_batches == 1:
                (loss, aux), grads = vg(params, mb)
            else:
                micros = jax.tree.map(
                    lambda x: x.reshape(
                        micro_batches, x.shape[0] // micro_batches,
                        *x.shape[1:]),
                    mb,
                )

                def acc(g, mi):
                    (loss, aux), gr = vg(params, mi)
                    return jax.tree.map(jnp.add, g, gr), (loss, aux)

                zero = jax.tree.map(jnp.zeros_like, params)
                grads, (losses_k, aux_k) = jax.lax.scan(
                    acc, zero, micros)
                grads = jax.tree.map(
                    lambda g: g / micro_batches, grads)
                loss = losses_k.mean()
                aux = jax.tree.map(lambda a: a.mean(), aux_k)
            if pmean_axis is not None:
                grads = jax.lax.pmean(grads, pmean_axis)
                loss = jax.lax.pmean(loss, pmean_axis)
                aux = jax.lax.pmean(aux, pmean_axis)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), (loss, *aux)

        (params, opt_state), losses = jax.lax.scan(
            mb_update, (params, opt_state), minibatches
        )
        return (params, opt_state, key), losses

    (params, opt_state, key), losses = jax.lax.scan(
        epoch, (params, opt_state, key), None, length=num_epochs
    )
    return params, opt_state, key, losses

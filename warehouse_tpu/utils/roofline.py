"""Analytic matmul-FLOP models of the trained families, and device peaks.

Closed-form per-update FLOP counts derived from the CONFIG SHAPES (no
tracing), turned into achieved TFLOP/s and a share of the device's
published peak given a measured time.

Counting conventions (every consumer of these numbers inherits them):

- One multiply-add = 2 FLOPs; only matmul/conv FLOPs are counted.
- A matmul's backward = 2x its forward (dgrad + wgrad); recurrent
  replay is counted as forward + backward through the stored
  sequence (3x forward).
- One update = the T-step act phase (policy forward per env-step) plus
  the learner phase (epochs x minibatches of forward + backward).

Peaks: one table keyed by ``jax.Device.device_kind``. A device that is
not in it is an error, not a default.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet: dense rates (no sparsity) at the 700 W
# power limit. A card set below that limit cannot hold these clocks
# under a matrix-heavy load — report its power limit beside any share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,
        "tf32": 495e12,
        "fp32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table row of ``device_kind``; raises on an unknown one."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device_kind {device_kind!r} "
            f"(known: {sorted(PEAKS)})") from None


class Cost(NamedTuple):
    """Analytic matmul FLOPs of one trainer update."""

    name: str
    flops: float
    unit_env_steps: int     # env-steps per update (for steps/s cross-check)


_HEAD = 6               # logits (5) + value (1) output columns


def mlp_fwd_flops(D: int, H: int, L: int) -> float:
    """Forward FLOPs of one agent-slot through the MLP: D->H,
    (L-1) x H->H, heads."""
    return 2.0 * (D * H + (L - 1) * H * H + H * _HEAD)


def cnn_fwd_flops(cfg, H: int, channels=(16, 32)) -> float:
    """Forward FLOPs of one agent-slot through the CNN torso (3x3 SAME
    convs: 2*9*S²*IC*OC each), dense trunk, heads."""
    S = cfg.height if cfg.global_obs else cfg.window_size
    C = cfg.num_obs_channels
    chans = (C, *channels)
    conv = sum(2.0 * 9 * S * S * chans[i] * chans[i + 1]
               for i in range(len(chans) - 1))
    dense = 2.0 * (S * S * chans[-1] + 6) * H
    return conv + dense + 2.0 * H * _HEAD


def rnn_fwd_flops(D: int, H: int, cell: str) -> float:
    """Forward FLOPs of one agent-slot-step through the recurrent
    policy: encoder D->H, cell (GRU 3 gates / LSTM 4, each H->H from x
    and H->H from h), heads."""
    gates = 3 if cell == "gru" else 4
    return 2.0 * (D * H + gates * 2 * H * H + H * _HEAD)


def _fwd_flops(cfg, tcfg, arch: str) -> float:
    D, H, L = cfg.obs_dim, tcfg.hidden_dim, tcfg.num_layers
    if arch in ("gru", "lstm"):
        return rnn_fwd_flops(D, H, arch)
    if arch == "cnn":
        return cnn_fwd_flops(cfg, H)
    return mlp_fwd_flops(D, H, L)


def act_phase_flops(cfg, tcfg, arch: str = "mlp") -> float:
    """T-step rollout at B envs: one policy forward per agent-step."""
    return (tcfg.unroll_length * tcfg.num_envs * cfg.num_agents
            * _fwd_flops(cfg, tcfg, arch))


def learner_flops(cfg, tcfg, arch: str = "mlp",
                  algo: str = "ppo") -> float:
    """Learner phase: forward + backward (3x forward) over every stored
    sample, once per epoch (PPO) or pass (IMPALA, plus the last-obs
    value forward+backward per minibatch)."""
    samples = tcfg.unroll_length * tcfg.num_envs * cfg.num_agents
    fwd = _fwd_flops(cfg, tcfg, arch)
    if algo == "impala":
        last = tcfg.num_envs * cfg.num_agents
        return tcfg.impala_passes * (samples + last) * 3.0 * fwd
    return tcfg.ppo_epochs * samples * 3.0 * fwd


def family_cost(family: str, cfg, tcfg) -> Cost:
    """Whole-UPDATE cost of a trained family (act + learner phases, the
    composition ``train_many`` runs)."""
    arch = {"ppo": "mlp", "impala": "mlp", "ppo_rnn": "gru",
            "gru": "gru", "lstm": "lstm", "cnn": "cnn"}.get(family)
    if arch is None:
        raise ValueError(f"no FLOP model for family {family!r}")
    algo = "impala" if family == "impala" else "ppo"
    flops = act_phase_flops(cfg, tcfg, arch) + learner_flops(
        cfg, tcfg, arch, algo)
    return Cost(family, flops, tcfg.unroll_length * tcfg.num_envs)


def report(cost: Cost, seconds: float, device_kind: str,
           precision: str) -> dict:
    """Achieved matmul rate of a measured per-update time and its share
    of the device's published ``precision`` peak ("bf16" | "tf32" |
    "fp32")."""
    peak = peaks(device_kind)[precision]
    rate = cost.flops / seconds
    return {
        "name": cost.name,
        "ms": seconds * 1e3,
        "tflops": rate / 1e12,
        "peak": precision,
        "peak_share": rate / peak,
    }

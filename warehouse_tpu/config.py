"""Frozen configuration dataclasses.

Static fields (grid size, agent count, queue capacity, obs radius) are
SHAPES: they feed ``jit`` as compile-time constants, and changing them
triggers recompilation (SURVEY.md §5.6). Capability parity with the
reference's ``env_config`` dict + RLlib ``AlgorithmConfig`` (reference
unreadable this round — see SURVEY.md §0; spec in docs/SEMANTICS.md §12).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Warehouse environment configuration (docs/SEMANTICS.md §12)."""

    height: int = 9
    width: int = 9
    num_agents: int = 4
    queue_capacity: int = 8
    spawn_prob: float = 0.25
    init_requests: int = 4
    max_steps: int = 128
    obs_radius: int = 2
    global_obs: bool = False
    # Static obstacle layout: row-major cell ids of wall/shelf cells
    # (docs/SEMANTICS.md §1a). Empty = open floor. A frozen tuple so the
    # config stays hashable (layout is a SHAPE-like compile-time constant).
    walls: tuple = ()
    # Rewards (docs/SEMANTICS.md §8). Penalties are negative values.
    delivery_reward: float = 1.0
    pickup_reward: float = 0.1
    step_penalty: float = -0.01
    collision_penalty: float = -0.1
    auto_reset: bool = False

    def __post_init__(self) -> None:
        if self.height < 1 or self.width < 1:
            raise ValueError("grid must be at least 1x1")
        if self.num_agents < 1 or self.num_agents > self.height * self.width:
            raise ValueError("num_agents must fit on the grid")
        if self.init_requests > self.queue_capacity:
            raise ValueError("init_requests exceeds queue_capacity")
        if self.obs_radius < 0:
            raise ValueError("obs_radius must be >= 0")
        if not 0.0 <= self.spawn_prob <= 1.0:
            raise ValueError("spawn_prob must be in [0, 1]")
        walls = tuple(self.walls)
        object.__setattr__(self, "walls", walls)
        if len(set(walls)) != len(walls):
            raise ValueError("duplicate wall cells")
        if any(not 0 <= w < self.num_cells for w in walls):
            raise ValueError("wall cell out of range")
        if self.num_agents > self.num_cells - len(walls):
            raise ValueError("num_agents must fit on free cells")

    # ---- derived shapes -------------------------------------------------
    @property
    def num_cells(self) -> int:
        return self.height * self.width

    @property
    def window_size(self) -> int:
        return 2 * self.obs_radius + 1

    @property
    def num_obs_channels(self) -> int:
        """Grid channels per obs cell (docs/SEMANTICS.md §10): global view
        carries an extra traversability channel (ch4, walls)."""
        return 5 if self.global_obs else 4

    @property
    def obs_dim(self) -> int:
        """Flat per-agent observation length (docs/SEMANTICS.md §10)."""
        if self.global_obs:
            return 5 * self.height * self.width + 6
        return 4 * self.window_size * self.window_size + 6

    @property
    def num_actions(self) -> int:
        return 5

    @property
    def free_cells(self) -> tuple:
        """Row-major cell ids that are NOT walls (docs/SEMANTICS.md §9:
        random cell draws index into this list)."""
        wall_set = set(self.walls)
        return tuple(c for c in range(self.num_cells)
                     if c not in wall_set)

    @property
    def num_free(self) -> int:
        return self.num_cells - len(self.walls)

    # ---- (de)serialization ---------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "EnvConfig":
        d = dict(d)
        if "walls" in d:
            d["walls"] = tuple(d["walls"])
        return cls(**d)

    def replace(self, **kw: Any) -> "EnvConfig":
        return dataclasses.replace(self, **kw)


# Driver benchmark configs (BASELINE.md; queue_capacity = 2*A,
# init_requests = A per docs/SEMANTICS.md §12).
def small_config(**kw: Any) -> EnvConfig:
    """5x5, 2 agents — BASELINE.json config 1 (PR1 parity rig)."""
    base = dict(height=5, width=5, num_agents=2, queue_capacity=4,
                init_requests=2)
    base.update(kw)
    return EnvConfig(**base)


def medium_config(**kw: Any) -> EnvConfig:
    """9x9, 4 agents — BASELINE.json configs 2 & 4."""
    base = dict(height=9, width=9, num_agents=4, queue_capacity=8,
                init_requests=4)
    base.update(kw)
    return EnvConfig(**base)


def large_config(**kw: Any) -> EnvConfig:
    """15x15, 8 agents — BASELINE.json config 3 (stress)."""
    base = dict(height=15, width=15, num_agents=8, queue_capacity=16,
                init_requests=8)
    base.update(kw)
    return EnvConfig(**base)


def shelves_config(**kw: Any) -> EnvConfig:
    """11x11 with four 3-cell shelf racks — a classic warehouse aisle
    layout (docs/SEMANTICS.md §1a)."""

    def cells(rc_list):
        return tuple(r * 11 + c for r, c in rc_list)

    racks = []
    for r in (2, 5, 8):
        for c0 in (2, 7):
            racks += [(r, c0), (r, c0 + 1), (r, c0 + 2)]
    base = dict(height=11, width=11, num_agents=6, queue_capacity=12,
                init_requests=6, walls=cells(racks))
    base.update(kw)
    return EnvConfig(**base)


# Adam hyperparameters, defined ONCE: every trainer's
# optax.chain(clip_by_global_norm, adam(lr, ...)) reads these.
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """PPO actor-learner configuration (SURVEY.md §7 PR4)."""

    num_envs: int = 4096          # global env batch (sharded over `data` axis)
    unroll_length: int = 16       # T: lax.scan rollout length per update
    num_updates: int = 200
    # PPO
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    ppo_epochs: int = 4
    num_minibatches: int = 4
    # RLlib-style adaptive KL penalty (off by default; clipped surrogate
    # alone is the PureJaxRL-standard loss).
    kl_coeff: float = 0.0
    kl_target: float = 0.01
    adaptive_kl: bool = True
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    anneal_lr: bool = True
    # Run the optimizer on the raveled parameter vector (optax.flatten):
    # fuses the ~10 per-tensor Adam/global-norm ops into single vector
    # ops. Off by default to keep the opt_state checkpoint structure
    # stable; it exists for configs that multiply tiny-op count (vmapped
    # PBT populations, many-layer torsos). Same math (global-norm
    # reduction order aside).
    flat_optimizer: bool = False
    # Linear entropy-coefficient anneal: entropy_coef → entropy_coef_final
    # over num_updates. Negative = disabled (constant entropy_coef).
    entropy_coef_final: float = -1.0
    # Minibatch construction for feed-forward PPO ("env" | "flat").
    # "env" (default, and what bench.py measures): permute the ENV axis
    # per shuffle (B-row gather) so each minibatch is a random set of
    # env-trajectories — the same composition IMPALA/recurrent-PPO use;
    # learning curves matched "flat" at BASELINE config 4.
    # "flat": RLlib/PureJaxRL-style fresh permutation of all T·B·A
    # samples — statistically cleanest, but a 262k-row random gather
    # per epoch at BASELINE config 4. Use ``--rllib-cadence`` to restore
    # the reference stack's behavior.
    minibatch_mode: str = "env"
    # Epoch shuffle cadence ("once" | "each"). "once" (default, and
    # what bench.py measures): one permutation per update; the
    # ppo_epochs epochs revisit the same minibatch partition
    # (composition is still re-randomized every update); learning
    # curves matched "each" at BASELINE config 4. "each": a fresh
    # permutation gather every epoch (RLlib's behavior;
    # ``--rllib-cadence``).
    epoch_shuffle: str = "once"
    # Split each minibatch gradient into K equal micro-batch grads,
    # averaged before ONE optimizer step — the same SGD trajectory up
    # to f32 summation order (advantage normalization is hoisted to
    # per-minibatch). Bounds the per-grad working set at big global
    # batches. 1 = off.
    micro_batches: int = 1
    # Bootstrap value targets through time-limit truncations (RLlib's
    # behavior): at a truncation boundary GAE/V-trace use V of the TRUE
    # final state (the engine's TimeStep.final_obs) as the next-state
    # value instead of 0. Off = treat truncation as termination.
    bootstrap_truncated: bool = False
    # Potential-based reward shaping coefficient (Ng et al. 1999;
    # ops/pathing.py potential()). 0 = off. Policy-invariant; densifies
    # the sparse delivery signal on walled layouts.
    shaping_coef: float = 0.0
    # Mask actions that walk into walls / off the grid at the policy
    # logits (RLlib action-masking capability; ops/move.py
    # valid_action_mask). Off-policy-safe: the mask is stored with the
    # trajectory and re-applied in the loss.
    mask_actions: bool = False
    # IMPALA / V-trace (train/impala.py; used only when algo="impala").
    rho_clip: float = 1.0         # ρ̄: V-trace IS clip for targets & pg
    c_clip: float = 1.0           # c̄: V-trace IS clip for trace cutting
    impala_passes: int = 1        # replays of each rollout (>1 = stale data,
                                  # exercised by the V-trace correction)
    impala_rmsprop: bool = True   # IMPALA's canonical optimizer; False = adam
    # Model
    hidden_dim: int = 128
    num_layers: int = 2
    # Compute dtype for the policy torso ("float32" | "bfloat16").
    # bfloat16 runs the torso's matmuls in bf16; parameters and the loss
    # stay float32 (models cast logits/values back), so this is a pure
    # activation/matmul precision knob.
    model_dtype: str = "float32"
    # Infra
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    metrics_path: str = "metrics.jsonl"

    def __post_init__(self) -> None:
        # Central validation: every trainer family (ppo, ppo_rnn, pbt,
        # impala) consumes these fields, so a typo'd value must fail at
        # construction, not silently select a fallback branch deep in
        # one family's make_train (round-2 advisor finding).
        checks = {
            "minibatch_mode": ("flat", "env"),
            "epoch_shuffle": ("each", "once"),
            "model_dtype": ("float32", "bfloat16"),
        }
        for field, allowed in checks.items():
            val = getattr(self, field)
            if val not in allowed:
                raise ValueError(
                    f"{field} must be one of {allowed}, got {val!r}")
        if self.micro_batches < 1:
            raise ValueError("micro_batches must be >= 1")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainConfig":
        return cls(**d)

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

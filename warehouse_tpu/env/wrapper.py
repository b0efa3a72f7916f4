"""RLlib/gymnasium-style multi-agent dict API (docs/SEMANTICS.md §11).

The compatibility surface of the reference's ``MultiAgentEnv`` contract
(SURVEY.md C8, [API]): dict-in/dict-out ``reset``/``step`` keyed by
``"agent_i"`` strings with ``"__all__"`` in terminated/truncated. This is
a thin adapter over the batched engine at B=1 (or the NumPy oracle) —
the on-device API is the array-axis one in ``warehouse_tpu.env``; this
wrapper exists for CPU-side interop, demos, and the parity harness.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np

from ..config import EnvConfig
from .render import render_ascii


class WarehouseMultiAgentEnv:
    """Dict-API adapter. ``backend``: "jax" (engine, B=1) or "oracle"."""

    metadata = {"render_modes": ["ansi", "rgb_array"]}

    def __init__(self, cfg: EnvConfig | None = None,
                 backend: str = "jax", seed: int = 0) -> None:
        self.cfg = cfg or EnvConfig()
        if backend not in ("jax", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self._seed = seed
        self._state = None
        self.possible_agents = [
            f"agent_{i}" for i in range(self.cfg.num_agents)
        ]
        self.agents = list(self.possible_agents)

    # ------------------------------------------------------------ spaces
    # lru_cache: consumers (pettingzoo API test) require the SAME space
    # object per agent across calls.
    @functools.lru_cache(maxsize=None)
    def observation_space(self, agent: str):
        import gymnasium as gym

        return gym.spaces.Box(-np.inf, np.inf, (self.cfg.obs_dim,),
                              np.float32)

    @functools.lru_cache(maxsize=None)
    def action_space(self, agent: str):
        import gymnasium as gym

        return gym.spaces.Discrete(self.cfg.num_actions)

    # --------------------------------------------------------------- api
    def reset(self, seed: int | None = None, options: Any = None):
        if seed is not None:
            self._seed = seed
        if self.backend == "oracle":
            from ..oracle import JaxDrawSource, OracleEnv

            import jax

            self._env = OracleEnv(
                self.cfg, JaxDrawSource(jax.random.PRNGKey(self._seed))
            )
            obs = self._env.reset()
        else:
            import jax

            from . import engine

            self._key = jax.random.PRNGKey(self._seed)
            self._state, obs = engine.reset(self.cfg, self._key)
            obs = np.asarray(obs)
        self.agents = list(self.possible_agents)
        return self._obs_dict(obs), {a: {} for a in self.possible_agents}

    def step(self, action_dict: dict[str, int]):
        actions = np.zeros(self.cfg.num_agents, dtype=np.int32)
        for i, a in enumerate(self.possible_agents):
            act = int(action_dict.get(a, 0))
            if not 0 <= act < self.cfg.num_actions:
                raise ValueError(
                    f"invalid action {act} for {a}; expected 0..4"
                )
            actions[i] = act
        if self.backend == "oracle":
            obs, rew, term, trunc, info = self._env.step(actions)
        else:
            from . import engine

            self._state, ts = engine.step(self.cfg, self._state, actions)
            obs = np.asarray(ts.obs)
            rew = np.asarray(ts.reward)
            term, trunc = bool(ts.terminated), bool(ts.truncated)
            info = {
                "picked": np.asarray(ts.picked),
                "delivered": np.asarray(ts.delivered),
                "collided": np.asarray(ts.collided),
            }
        obs_d = self._obs_dict(obs)
        rew_d = {a: float(rew[i]) for i, a in enumerate(self.possible_agents)}
        term_d = {a: bool(term) for a in self.possible_agents}
        term_d["__all__"] = bool(term)
        trunc_d = {a: bool(trunc) for a in self.possible_agents}
        trunc_d["__all__"] = bool(trunc)
        info_d = {
            a: {k: bool(v[i]) for k, v in info.items()}
            for i, a in enumerate(self.possible_agents)
        }
        if trunc:
            self.agents = []
        return obs_d, rew_d, term_d, trunc_d, info_d

    def render(self, mode: str = "ansi"):
        """mode "ansi" → str; "rgb_array" → uint8[H·px, W·px, 3]."""
        state = self._env.state if self.backend == "oracle" else self._state
        if mode == "rgb_array":
            from .render import render_rgb

            return render_rgb(self.cfg, state)
        return render_ascii(self.cfg, state)

    # ----------------------------------------------------------- helpers
    @property
    def state(self):
        return self._env.state if self.backend == "oracle" else self._state

    def _obs_dict(self, obs: np.ndarray) -> dict[str, np.ndarray]:
        return {
            a: np.asarray(obs[i], dtype=np.float32)
            for i, a in enumerate(self.possible_agents)
        }

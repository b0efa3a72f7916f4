"""On-device actor-learner training (SURVEY.md §3.4): PPO, recurrent
PPO, and IMPALA/V-trace.

Lazy re-exports: importing this package must NOT touch jax, so that
``python -m warehouse_tpu.train --cpu`` can pick the backend from argv
before the first backend-initializing array op.
"""

from typing import Any

__all__ = ["make_train", "PPOTrainer", "RunnerState", "make_train_rnn",
           "make_train_impala", "ImpalaTrainer"]


def __getattr__(name: str) -> Any:
    if name in ("make_train", "PPOTrainer", "RunnerState"):
        from . import ppo

        return getattr(ppo, name)
    if name == "make_train_rnn":
        from .ppo_rnn import make_train_rnn

        return make_train_rnn
    if name in ("make_train_impala", "ImpalaTrainer"):
        from . import impala

        return getattr(impala, name)
    raise AttributeError(name)

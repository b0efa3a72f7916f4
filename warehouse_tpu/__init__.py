"""warehouse_tpu — an accelerator-native multi-agent warehouse environment engine.

Built from scratch with the capabilities of ``ffahleraz/rllib-warehouse``
(see SURVEY.md), as pure-functional JAX: the env step is a pure function on
pytrees of fixed-shape arrays, ``vmap``-batched, ``lax.scan``-rolled, and
``shard_map``-sharded over a device mesh. The NumPy oracle under
``warehouse_tpu.oracle`` is the readable executable spec used for parity.
"""

from .config import (EnvConfig, TrainConfig, small_config, medium_config,
                     large_config, shelves_config)

__version__ = "0.1.0"

__all__ = [
    "EnvConfig",
    "TrainConfig",
    "small_config",
    "medium_config",
    "large_config",
    "shelves_config",
    "__version__",
]

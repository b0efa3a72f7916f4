"""Device mesh + sharding helpers (SURVEY.md §2.4).

The reference scales by spawning Ray rollout-worker actors and shipping
sample batches over gRPC/plasma; here the same capability is a 1-D
``data`` mesh over all devices: env batches shard along it, params
replicate, and the one collective per update (grad psum) rides the
cards' interconnect (NVLink within one host). The
axis set is ``(data, model)`` with ``model=1`` so tensor parallelism is a
config change, not a rewrite (SURVEY.md §2.3).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"
POP_AXIS = "pop"  # population axis (PBT members / sweep seed replicas)


def make_mesh(devices=None, model_parallel: int = 1) -> Mesh:
    """1-D (or 2-D with model>1) mesh over the given / all devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model={model_parallel}")
    arr = np.array(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def make_pop_mesh(pop_shards: int, devices=None) -> Mesh:
    """2-D ``(pop, data)`` mesh: population members (PBT) shard over
    ``pop``; each member's env batch shards over ``data``. Either axis
    may be 1, so this subsumes pure population- and pure data-parallel
    layouts (train/pbt.py)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % pop_shards:
        raise ValueError(f"{n} devices not divisible by pop={pop_shards}")
    arr = np.array(devices).reshape(pop_shards, n // pop_shards)
    return Mesh(arr, (POP_AXIS, DATA_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis batch sharding over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, tree):
    """Device_put a host pytree with its leading axis over `data`."""
    return jax.device_put(tree, data_sharding(mesh))

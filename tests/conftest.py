"""Test conftest: force the CPU backend with 8 fake devices.

Multi-host code paths (shard_map/psum over a `data` mesh axis) are
exercised on a virtual 8-device CPU mesh (SURVEY.md §4.5) — the XLA flag
must be set before backend init. The platform is pinned through
jax.config as well as JAX_PLATFORMS, so the suite stays on the CPU on a
machine that has a GPU.
"""

import os

_flag = "--xla_force_host_platform_device_count=8"
if _flag not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite recompiles dozens of jitted
# programs per run — warm-starting reruns matters.
from warehouse_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

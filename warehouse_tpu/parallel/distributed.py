"""Multi-host process-group formation (SURVEY.md §2.4, §5.8).

Replaces the reference stack's Ray GCS/raylet service world: every host
runs the SAME program; ``jax.distributed.initialize`` (coordination
service over DCN) assembles the global device mesh, and all cross-host
data movement is XLA collectives on named mesh axes.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger("warehouse_tpu")


def maybe_initialize_distributed() -> bool:
    """Initialize jax.distributed when launcher env vars are present.

    Honors the JAX coordination variables
    (``JAX_COORDINATOR_ADDRESS``/``COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``) and, when the launcher
    runs several processes on one host, ``JAX_LOCAL_DEVICE_IDS`` (comma
    separated, e.g. ``"0,1"``): the cards this process owns. Without it
    every process on the host would open every card. Returns True if
    multi-process mode was initialized.
    """
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    local = os.environ.get("JAX_LOCAL_DEVICE_IDS")
    if addr and nproc and pid is not None:
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=int(nproc),
            process_id=int(pid),
            local_device_ids=(
                [int(i) for i in local.split(",")] if local else None
            ),
        )
        logger.info(
            "jax.distributed initialized: process %s/%s via %s",
            pid, nproc, addr,
        )
        return True
    return False

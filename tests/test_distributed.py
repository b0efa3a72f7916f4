"""Real multi-process jax.distributed test on localhost (SURVEY.md §4.5):
two OS processes form a global 2-device CPU mesh and run sharded PPO
updates — exercising the same process-group + collective code paths as a
multi-host pod, without a cluster."""

import os
import re
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_training():
    port = free_port()
    n = 2
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one local device per process
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_dist_worker.py"),
             str(i), str(n), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        for i in range(n)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"
    losses = []
    for out in outs:
        m = re.search(r"DIST_OK pid=\d+ update=2 loss=([-\d.]+)", out)
        assert m, f"no DIST_OK line:\n{out[-2000:]}"
        losses.append(float(m.group(1)))
    assert losses[0] == losses[1], "replicated loss diverged across processes"


@pytest.mark.parametrize("local,expected", [(None, None), ("1", [1]),
                                            ("0,2", [0, 2])])
def test_launcher_env_vars_reach_initialize(monkeypatch, local, expected):
    """maybe_initialize_distributed forwards the launcher's coordinator,
    process count/index and, when given, this process's cards."""
    import jax

    from warehouse_tpu.parallel import maybe_initialize_distributed

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    if local is None:
        monkeypatch.delenv("JAX_LOCAL_DEVICE_IDS", raising=False)
    else:
        monkeypatch.setenv("JAX_LOCAL_DEVICE_IDS", local)
    assert maybe_initialize_distributed()
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 2, "process_id": 1,
                    "local_device_ids": expected}


def test_no_launcher_env_means_single_process(monkeypatch):
    from warehouse_tpu.parallel import maybe_initialize_distributed

    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert not maybe_initialize_distributed()

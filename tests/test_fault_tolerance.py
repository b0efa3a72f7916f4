"""Failure detection / recovery (SURVEY.md §5.3): SIGKILL a training
process mid-run, restart from the latest checkpoint, and assert the run
completes with a continuous metric history."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys; sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from warehouse_tpu.train.__main__ import main
main([
    "--env", "small", "--num-envs", "32", "--unroll-length", "4",
    "--num-updates", {updates!r}, "--log-every", "2", "--checkpoint-every", "4",
    "--hidden-dim", "16", "--single-device",
    "--checkpoint-dir", {ckpt!r}, "--metrics-path", {metrics!r},
    {resume}
])
"""


def launch(tmp, resume, updates):
    code = SCRIPT.format(
        repo=REPO,
        ckpt=str(tmp / "ckpt"),
        metrics=str(tmp / "metrics.jsonl"),
        resume='"--resume",' if resume else "",
        updates=str(updates),
    )
    return subprocess.Popen(
        [sys.executable, "-c", code],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )


@pytest.mark.slow
def test_kill_and_resume(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    # Start training with an effectively unbounded budget so the kill
    # always lands mid-run; SIGKILL once the first checkpoints exist.
    p = launch(tmp_path, resume=False, updates=1000000)
    deadline = time.time() + 300
    try:
        while time.time() < deadline:
            if ckpt_dir.is_dir() and any(
                d.startswith("step_") for d in os.listdir(ckpt_dir)
            ):
                break
            if p.poll() is not None:
                pytest.fail("training process exited before checkpointing")
            time.sleep(0.5)
        else:
            pytest.fail("no checkpoint appeared within deadline")
        time.sleep(1.0)  # let it get mid-flight past the checkpoint
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()

    # Only finalized checkpoints count; a save cut by the kill leaves a
    # temporary directory that latest_step skips.
    from warehouse_tpu.train.checkpoint import latest_step

    killed_at = latest_step(str(ckpt_dir))
    assert killed_at >= 4

    # Relaunch with --resume and a reachable budget; must complete.
    target = killed_at + 8
    p2 = launch(tmp_path, resume=True, updates=target)
    assert p2.wait(timeout=420) == 0

    steps = [
        rec["step"]
        for line in open(tmp_path / "metrics.jsonl")
        if "step" in (rec := json.loads(line))  # skip run-meta records
    ]
    assert max(steps) == target
    # Metric history covers post-kill updates (resume actually continued).
    assert any(s > killed_at for s in steps)

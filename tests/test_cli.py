"""CLI end-to-end tests: demo, evaluate (incl. checkpoint policy), train."""

import json
import os

import numpy as np
import pytest


def test_demo_runs(capsys):
    from warehouse_tpu.demo import main

    main(["--env", "small", "--steps", "10", "--backend", "oracle"])
    out = capsys.readouterr().out
    assert "episode finished after 10 steps" in out
    assert "mean return:" in out


def test_demo_render_random(capsys):
    from warehouse_tpu.demo import main

    main(["--env", "small", "--steps", "3", "--render", "--policy",
          "random", "--backend", "jax"])
    out = capsys.readouterr().out
    assert "t=0" in out and "t=3" in out


def test_evaluate_greedy(capsys):
    from warehouse_tpu.evaluate import main

    main(["--env", "small", "--policy", "greedy", "--episodes", "8"])
    out = capsys.readouterr().out
    assert "mean_episode_return" in out


def test_train_and_evaluate_checkpoint(tmp_path, capsys):
    from warehouse_tpu.evaluate import main as eval_main
    from warehouse_tpu.train.__main__ import main as train_main

    ckpt = str(tmp_path / "ck")
    train_main([
        "--env", "small", "--num-envs", "16", "--unroll-length", "4",
        "--num-updates", "2", "--log-every", "2", "--checkpoint-every", "2",
        "--hidden-dim", "16", "--single-device", "--checkpoint-dir", ckpt,
        "--metrics-path", str(tmp_path / "m.jsonl"),
    ])
    assert os.path.isdir(os.path.join(ckpt, "step_00000002"))
    # Metrics JSONL well-formed.
    recs = [json.loads(l) for l in open(tmp_path / "m.jsonl")]
    assert recs and recs[-1]["step"] == 2
    assert np.isfinite(recs[-1]["loss"])
    # Run-meta record: the devices that produced the numbers.
    assert recs[0].get("meta")
    import jax

    assert recs[0]["device"] == {"platform": "cpu", "kind": "cpu",
                                 "count": len(jax.devices())}

    eval_main([
        "--env", "small", "--policy", "checkpoint",
        "--checkpoint-dir", ckpt, "--hidden-dim", "16", "--episodes", "4",
    ])
    out = capsys.readouterr().out
    assert "mean_episode_return" in out


def test_evaluate_checkpoint_missing_dir(tmp_path):
    from warehouse_tpu.evaluate import main

    with pytest.raises(SystemExit, match="no checkpoints"):
        main(["--env", "small", "--policy", "checkpoint",
              "--checkpoint-dir", str(tmp_path / "nope")])


def test_recurrent_masked_checkpoint_roundtrip(tmp_path, capsys):
    """Self-describing checkpoints: train a GRU with --mask-actions, then
    evaluate with NO model flags (arch/hidden_dim/mask from
    policy_meta.json) and replay it in demo (serve.Policy path threads
    the recurrent carry)."""
    from warehouse_tpu.demo import main as demo_main
    from warehouse_tpu.evaluate import main as eval_main
    from warehouse_tpu.train.__main__ import main as train_main

    ckpt = str(tmp_path / "ck")
    train_main([
        "--env", "small", "--num-envs", "8", "--unroll-length", "4",
        "--num-updates", "2", "--log-every", "2", "--checkpoint-every", "2",
        "--arch", "gru", "--hidden-dim", "16", "--mask-actions",
        "--single-device", "--checkpoint-dir", ckpt,
        "--metrics-path", str(tmp_path / "m.jsonl"),
    ])
    assert os.path.exists(os.path.join(ckpt, "policy_meta.json"))

    eval_main([
        "--env", "small", "--policy", "checkpoint",
        "--checkpoint-dir", ckpt, "--episodes", "2",
    ])
    out = capsys.readouterr().out
    assert "mean_episode_return" in out

    demo_main([
        "--env", "small", "--steps", "6", "--policy", "checkpoint",
        "--checkpoint-dir", ckpt,
    ])
    out = capsys.readouterr().out
    assert "episode finished after 6 steps" in out

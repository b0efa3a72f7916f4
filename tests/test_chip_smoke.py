"""chip_smoke.py at tiny shapes on the CPU: every phase's checks run
here, and the script refuses to report a result without a GPU."""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_require_gpu_exits_on_cpu(smoke):
    import jax

    with pytest.raises(SystemExit, match="no GPU") as e:
        smoke.require_gpu(jax)
    assert e.value.code  # a message: exit status 1


def test_child_exits_on_cpu(smoke):
    with pytest.raises(SystemExit, match="no GPU"):
        smoke.child(False, "card")


def test_main_fails_without_gpu_and_prints_no_result(smoke, capsys):
    assert smoke.main([]) == 1
    assert '"ok": true' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding only chip_smoke.py it exits non-zero and
    prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_engine_vs_oracle_phase(smoke):
    res = smoke.phase_engine_vs_oracle(n_envs=2, steps=24)
    assert res == {"env_steps_checked": 2 * 2 * 2 * 24, "tolerance": 0}


def test_greedy_rollout_phase(smoke):
    res = smoke.phase_greedy_rollout(B=32, T=40)
    assert res["deliveries"] > 0 and res["env_steps_per_s"] > 0


def test_policy_math_phase(smoke):
    res = smoke.phase_policy_math(n_envs=3, hidden=16)
    errs = res["max_rel_err"]
    assert len(errs) == 3 * len(smoke.ARCHS)
    assert max(v for k, v in errs.items()
               if k.endswith("/highest")) <= smoke.RTOL_HIGHEST


def test_ppo_grad_phase(smoke):
    res = smoke.phase_ppo_grad(n_samples=128, hidden=16)
    assert res["max_rel_err"] <= smoke.RTOL_GRAD


def test_trained_phase(smoke):
    from warehouse_tpu import small_config

    res = smoke.phase_trained(num_envs=8, unroll=4, hidden=8, updates=2,
                              env=small_config(max_steps=8))
    assert set(res) == {"ppo/mlp", "ppo/cnn", "ppo/attn",
                        "impala/mlp-adam", "ppo_rnn/gru", "ppo_rnn/lstm"}
    assert all(r["max_param_change"] > 0 for r in res.values())


def test_mesh_phase_matches_vmapped_emulation(smoke):
    res = smoke.phase_mesh(n_dev=4, envs_per_dev=8, unroll=4, hidden=16)
    assert res["devices"] == 4 and res["global_envs"] == 32
    assert res["max_rel_param_diff"] <= smoke.RTOL_MESH


def test_pbt_phase(smoke):
    res = smoke.phase_pbt(envs_per_member=8, unroll=4, hidden=8)
    assert res["mesh"] == {"pop": 2, "data": 2}


def test_cli_phase(smoke, tmp_path):
    res = smoke.phase_cli(
        workdir=str(tmp_path / "cli"),
        train_args=("--env", "small", "--num-envs", "16",
                    "--unroll-length", "4", "--hidden-dim", "8",
                    "--single-device", "--cpu"),
        eval_args=("--env", "small", "--episodes", "4", "--cpu"))
    assert res["device"]["platform"] == "cpu"
    assert res["loss"] == res["loss"]

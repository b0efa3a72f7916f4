"""bench.py's harness: each path in its own process with a budget; a
hung or failed path is reported as failed and the bench exits non-zero."""

from __future__ import annotations

import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_bench():
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_run(returncode, stdout):
    def fake_run(cmd, **kw):
        class P:
            pass
        p = P()
        p.returncode, p.stdout, p.stderr = returncode, stdout, ""
        return p
    return fake_run


def test_timed_out_path_degrades_to_null(monkeypatch, tmp_path):
    bench = _load_bench()
    monkeypatch.setitem(bench.PATH_BUDGET_S, "engine", 1)
    # The child would spin up jax on this host; with a 1 s budget it is
    # guaranteed to hit TimeoutExpired and must return None, not hang.
    assert bench._run_isolated("engine") is None


def test_crashed_path_degrades_to_null(monkeypatch):
    bench = _load_bench()
    monkeypatch.setattr(bench.subprocess, "run",
                        _fake_run(3, "no result line here\n"))
    assert bench._run_isolated("ppo") is None


def test_result_line_parsed(monkeypatch):
    bench = _load_bench()
    payload = {"sps": 123.0, "spread": 1.0, "compile_s": 2.0}
    monkeypatch.setattr(bench.subprocess, "run", _fake_run(
        0, "noise\nRESULT " + json.dumps(payload) + "\n"))
    assert bench._run_isolated("engine") == payload


def test_main_emits_json_with_all_paths_null(monkeypatch, capsys):
    """With every path unavailable the bench still prints ONE valid JSON
    line with null fields and value 0, lists every path as failed, and
    exits non-zero."""
    bench = _load_bench()
    monkeypatch.setattr(bench, "_run_isolated", lambda p: None)
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code == 1
    out = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(out)
    assert d["metric"] == "env_steps_per_sec_per_chip"
    assert d["value"] == 0
    assert d["ppo_trained_steps_per_s"] is None
    assert d["engine_path_steps_per_s"] is None
    assert d["lstm_steps_per_s"] is None
    assert d["failed"] == list(bench.PATHS)


def test_main_names_device_and_fails_on_one_failed_path(monkeypatch,
                                                        capsys):
    bench = _load_bench()
    dev = {"platform": "gpu", "kind": "K", "count": 1}
    ok = {"sps": 5.0, "spread": 1.0, "compile_s": 1.0, "device": dev,
          "roofline": {"peak_share": 0.1}}
    monkeypatch.setattr(bench, "_run_isolated",
                        lambda p: None if p == "impala" else dict(ok))
    monkeypatch.setattr(bench, "card_info",
                        lambda: {"name": "K", "power_limit": "1 W"})
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code == 1
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["failed"] == ["impala"]
    assert d["impala_steps_per_s"] is None
    assert d["ppo_trained_steps_per_s"] == 5.0
    assert d["device"] == dev
    assert d["card"] == {"name": "K", "power_limit": "1 W"}


def test_main_exits_zero_when_every_path_runs(monkeypatch, capsys):
    bench = _load_bench()
    monkeypatch.setattr(bench, "_run_isolated", lambda p: {
        "sps": 7.0, "spread": 1.0, "compile_s": 1.0, "roofline": None,
        "device": {"platform": "gpu", "kind": "K", "count": 1}})
    monkeypatch.setattr(bench, "card_info", lambda: None)
    bench.main()
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["failed"] == [] and d["value"] == 7.0


def test_bench_path_refuses_a_non_gpu_device():
    """No CPU fallback: a child on the CPU exits without a result."""
    bench = _load_bench()
    with pytest.raises(SystemExit, match="no GPU"):
        bench.run_path("engine")

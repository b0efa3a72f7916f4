"""Throughput benchmark on 1 GPU, five paths, ONE JSON line.

Paths reported (BASELINE.json configs 2 & 4):

- ``engine``  — XLA engine + jitted greedy policy, auto-reset gated at the
  batch level (the general-policy rollout path), B=8192, T=256. Its rate
  is the headline ``value``.
- ``ppo``     — the TRAINED path: full Anakin PPO update (rollout + GAE +
  4 epochs x 4 minibatches) at BASELINE config 4 (4096 envs, 9x9, 4
  agents) with the DEFAULT TrainConfig, i.e. what a default
  ``python -m warehouse_tpu.train`` run gets.
- ``impala``  — trained V-trace actor-learner, same shapes, with Adam
  (``impala_rmsprop=False``, the optimizer the trainer tells users to
  run on this env).
- ``ppo_rnn`` — trained recurrent (GRU) PPO, same shapes.
- ``lstm``    — trained recurrent (LSTM) PPO, same shapes.

Each path times ``block_until_ready`` around whole compiled calls, after
a warm-up call that compiles (reported as ``compile_s``). The JSON names
the device (JAX platform, ``device_kind``, count) and the card's name
and power limit from ``nvidia-smi``. A path that fails is listed under
``failed`` with a null rate, and the process exits non-zero.

Every path runs in a child process, one after another, and this parent
never imports jax: a JAX process reserves most of the card's memory when
it first touches it, so two live JAX processes on one card would starve
each other. The per-path time budget bounds a hung path.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 1)[0])

PATHS = ("engine", "ppo", "impala", "ppo_rnn", "lstm")
PATH_BUDGET_S = {"engine": 600, "ppo": 900, "impala": 900,
                 "ppo_rnn": 900, "lstm": 900}
REPEATS = 3


def _progress(msg: str) -> None:
    """Progress marker on stderr (stdout carries ONLY the JSON line)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def card_info() -> dict | None:
    """{"name", "power_limit"} of the first card per ``nvidia-smi``;
    None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    name, limit = (x.strip() for x in out.splitlines()[0].split(","))
    return {"name": name, "power_limit": limit}


def _timed(jax, fn, *args):
    """(seconds per call for REPEATS calls, compile seconds)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times, compile_s


def bench_engine(jax, jnp):
    from warehouse_tpu import medium_config
    from warehouse_tpu.baselines.greedy import greedy_actions
    from warehouse_tpu.env import engine
    from warehouse_tpu.env.batch import step_autoreset_batch

    cfg = medium_config(auto_reset=True)
    B, T = 8192, 256

    keys = jax.vmap(
        lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i)
    )(jnp.arange(B))
    state, _ = jax.jit(jax.vmap(lambda k: engine.reset(cfg, k)))(keys)

    @jax.jit
    def rollout(state):
        def body(s, _):
            a = jax.vmap(lambda ss: greedy_actions(cfg, ss))(s)
            s, ts = step_autoreset_batch(cfg, s, a)
            return s, ts.delivered.sum()

        s, dels = jax.lax.scan(body, state, None, length=T)
        return s, dels.sum()

    _progress(f"engine: compiling greedy rollout (B={B}, T={T}) …")
    times, compile_s = _timed(jax, rollout, state)
    deliveries = int(rollout(state)[1])
    if deliveries <= 0:
        raise RuntimeError("no deliveries — engine dynamics look broken")
    return {"sps": B * T / min(times), "spread": max(times) / min(times),
            "compile_s": compile_s, "deliveries": deliveries}


def bench_trained(jax, jnp, family: str):
    """Trained-path throughput for one trainer family at BASELINE
    config 4 shapes, DEFAULT TrainConfig SGD cadence."""
    from warehouse_tpu.config import TrainConfig, medium_config
    from warehouse_tpu.utils import roofline as rl

    tcfg = TrainConfig(num_envs=4096, unroll_length=16)
    if family == "ppo":
        from warehouse_tpu.train.ppo import make_train

        trainer = make_train(medium_config(), tcfg)
    elif family == "impala":
        from warehouse_tpu.train.impala import make_train_impala

        tcfg = tcfg.replace(impala_rmsprop=False)
        trainer = make_train_impala(medium_config(), tcfg)
    elif family in ("ppo_rnn", "lstm"):
        from warehouse_tpu.train.ppo_rnn import make_train_rnn

        cell = "lstm" if family == "lstm" else "gru"
        trainer = make_train_rnn(medium_config(), tcfg, arch=cell)
    else:
        raise SystemExit(f"unknown trained family {family!r}")
    _progress(f"{family}: compiling train_many (config 4) …")
    n = 50
    rs = trainer.init(jax.random.PRNGKey(0))

    def run(rs):
        return trainer.train_many(rs, n)

    times, compile_s = _timed(jax, run, rs)
    _, m = run(rs)
    loss = float(m["loss"][-1])
    if loss != loss:
        raise RuntimeError(f"{family}: loss is NaN")
    best = min(times)
    # float32 matmuls at JAX's default precision may run as TF32.
    roof = rl.report(rl.family_cost(family, medium_config(), tcfg),
                     best / n, jax.devices()[0].device_kind, "tf32")
    return {"sps": n * tcfg.num_envs * tcfg.unroll_length / best,
            "spread": max(times) / best, "compile_s": compile_s,
            "roofline": roof}


def run_path(path: str) -> None:
    """Child-process entry: run ONE bench path, print its JSON result."""
    import jax
    import jax.numpy as jnp

    from warehouse_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform}")
    enable_compilation_cache()
    if path == "engine":
        out = bench_engine(jax, jnp)
    elif path in PATHS:
        out = bench_trained(jax, jnp, path)
    else:
        raise SystemExit(f"unknown path {path!r}")
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": jax.device_count()}
    print("RESULT " + json.dumps(out))


def _run_isolated(path: str):
    """Run one bench path in a subprocess with a budget; None on
    hang/crash (see PATH_BUDGET_S)."""
    _progress(f"{path}: starting (budget {PATH_BUDGET_S[path]}s) …")
    try:
        proc = subprocess.run(
            [sys.executable, __file__, "--path", path],
            capture_output=True, text=True,
            timeout=PATH_BUDGET_S[path],
        )
    except subprocess.TimeoutExpired:
        _progress(f"{path} path TIMED OUT")
        return None
    sys.stderr.write(proc.stderr)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    _progress(f"{path} path FAILED (rc={proc.returncode})")
    return None


def main() -> None:
    results = {p: _run_isolated(p) for p in PATHS}
    failed = [p for p, r in results.items() if r is None]

    def field(path, key):
        r = results[path]
        return r[key] if r else None

    engine_sps = field("engine", "sps")
    device = next((r["device"] for r in results.values() if r), None)
    print(json.dumps({
        "metric": "env_steps_per_sec_per_chip",
        "value": engine_sps or 0,
        "unit": ("env-steps/s/chip (9x9 grid, 4 agents, greedy baseline,"
                 " XLA engine, B=8192, T=256 with auto-reset)"),
        "device": device,
        "card": card_info(),
        "engine_path_steps_per_s": engine_sps,
        "engine_spread": field("engine", "spread"),
        "ppo_trained_steps_per_s": field("ppo", "sps"),
        "ppo_spread": field("ppo", "spread"),
        "impala_steps_per_s": field("impala", "sps"),
        "impala_spread": field("impala", "spread"),
        "ppo_rnn_steps_per_s": field("ppo_rnn", "sps"),
        "ppo_rnn_spread": field("ppo_rnn", "spread"),
        "lstm_steps_per_s": field("lstm", "sps"),
        "lstm_spread": field("lstm", "spread"),
        "compile_s": {p: field(p, "compile_s") for p in PATHS},
        "roofline": {p: field(p, "roofline") for p in PATHS[1:]},
        "failed": failed,
    }))
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--path":
        run_path(sys.argv[2])
    else:
        main()

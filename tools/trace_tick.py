"""Device-side cost of one env tick on the GPU, from a profiler trace.

    python tools/trace_tick.py [--out chiprun_out/trace_tick] [--num-envs B]

At BASELINE config 4 shapes (``medium``, 4096 envs, unroll 16, MLP
128x2) it traces, each after a warm-up call:

- ``greedy``: a T=16 greedy rollout through ``step_autoreset_batch``;
- ``act``: the PPO act phase alone — T=16 ticks of policy forward,
  sampling and ``step_autoreset_batch`` (the XLA body of
  ``train/ppo.py``'s rollout scan);
- ``update``: three full PPO updates (``train_many``).

For each it reports device kernels and device busy time per tick (act,
greedy) or per update, and the device's idle share: 1 - (union of
device-op intervals) / (first op start .. last op end), alongside the
host wall time of the traced call. Results go to ``<out>/summary.json``;
the per-kernel table of each window to ``<out>/<name>_kernels.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

_COPY_WORDS = ("memcpy", "memset")


def device_events(xplane_path: str, plane_prefix: str = "/device:GPU"):
    """([(name, start_ns, duration_ns)] of every op on the matching
    planes' stream lines, {"plane/line": event count} of every line
    seen). Derived "XLA ..." lines and "Steps" are skipped: they repeat
    the stream lines' ops grouped by module and step."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    events, lines = [], {}
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}/{line.name}"] = len(evs)
            if line.name.startswith("XLA") or line.name == "Steps":
                continue
            events += [(ev.name, ev.start_ns, ev.duration_ns) for ev in evs]
    if not events:
        raise RuntimeError(f"no events on {plane_prefix!r} planes in "
                           f"{xplane_path}")
    return events, lines


def reduce_events(events, units: int) -> dict:
    """Kernel count, busy time and idle share of one traced window;
    ``units`` = ticks or updates the window holds."""
    kernels = [e for e in events
               if not any(w in e[0].lower() for w in _COPY_WORDS)]
    spans = sorted((s, s + d) for _, s, d in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return {
        "units": units,
        "kernels_per_unit": len(kernels) / units,
        "copies_per_unit": (len(events) - len(kernels)) / units,
        "device_busy_us_per_unit": busy / units / 1e3,
        "device_window_us": window / 1e3,
        "idle_share": 1.0 - busy / window,
    }


def kernel_table(events, units: int, top: int = 25) -> list:
    by = {}
    for name, _, d in events:
        n, t = by.get(name, (0, 0))
        by[name] = (n + 1, t + d)
    rows = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
    return [{"name": k, "calls_per_unit": n / units,
             "us_per_unit": t / units / 1e3} for k, (n, t) in rows]


def trace_call(jax, fn, args, out_dir: str, name: str):
    """Trace one call of ``fn(*args)`` (already compiled); returns the
    events and the host wall seconds of the call."""
    d = os.path.join(out_dir, name)
    jax.profiler.start_trace(d)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    return path, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/trace_tick")
    ap.add_argument("--plane", default="/device:GPU",
                    help="trace plane prefix holding the device ops")
    ap.add_argument("--num-envs", type=int, default=4096)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from warehouse_tpu import TrainConfig, medium_config
    from warehouse_tpu.baselines.greedy import greedy_actions
    from warehouse_tpu.env.batch import reset_batch, step_autoreset_batch
    from warehouse_tpu.models import make_model
    from warehouse_tpu.ops.ppo_update import sample_action
    from warehouse_tpu.train.ppo import make_train

    dev = jax.devices()[0]
    B, T = args.num_envs, 16
    cfg = medium_config(auto_reset=True)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(0), i))(jnp.arange(B))
    state, obs = reset_batch(cfg, keys)

    @jax.jit
    def greedy(state):
        def body(s, _):
            a = jax.vmap(lambda ss: greedy_actions(cfg, ss))(s)
            s, ts = step_autoreset_batch(cfg, s, a)
            return s, ts.delivered.sum()
        return jax.lax.scan(body, state, None, length=T)

    model = make_model(cfg)
    params = model.init(jax.random.PRNGKey(1), obs[0])

    @jax.jit
    def act(params, state, obs, key):
        def body(carry, _):
            s, o, k = carry
            k, ak = jax.random.split(k)
            logits, value = model.apply(params, o)
            action, log_prob = sample_action(ak, logits)
            s, ts = step_autoreset_batch(cfg, s, action)
            return (s, ts.obs, k), (o, action, log_prob, value, ts.reward)
        return jax.lax.scan(body, (state, obs, key), None, length=T)

    trainer = make_train(medium_config(), TrainConfig(num_envs=B,
                                                      unroll_length=T))
    rs = trainer.init(jax.random.PRNGKey(2))

    def update3(rs):
        return trainer.train_many(rs, 3)

    windows = (("greedy", greedy, (state,), T),
               ("act", act, (params, state, obs, jax.random.PRNGKey(3)), T),
               ("update", update3, (rs,), 3))
    os.makedirs(args.out, exist_ok=True)
    summary = {"device": {"platform": dev.platform,
                          "kind": dev.device_kind,
                          "count": jax.device_count()},
               "B": B, "T": T}
    for name, fn, fargs, units in windows:
        jax.block_until_ready(fn(*fargs))             # compile + warm up
        path, wall = trace_call(jax, fn, fargs, args.out, name)
        events, lines = device_events(path, args.plane)
        res = reduce_events(events, units)
        res["host_wall_us_per_unit"] = wall / units * 1e6
        res["trace_lines"] = lines
        summary[name] = res
        with open(os.path.join(args.out, f"{name}_kernels.json"), "w") as f:
            json.dump(kernel_table(events, units), f, indent=1)
        print(name, json.dumps(res), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

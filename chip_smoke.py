"""Smoke test of the warehouse engine and its trainers on one NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the mesh phases only

One card:

1. ``engine_vs_oracle`` — full 128-step episodes of 16 envs at ``medium``
   and 16 at ``shelves``, greedy and random actions, run on the GPU and
   checked BIT-EXACT (state, obs, reward, flags, greedy actions) against
   the NumPy oracle fed the same draw stream.
2. ``greedy_rollout`` — ``medium_config(auto_reset=True)``, B=8192,
   T=256 through ``step_autoreset_batch``; deliveries must be > 0.
3. ``policy_math`` — every arch at BASELINE config 4 obs width against a
   NumPy float64 forward of the same params (tolerances below).
4. ``ppo_grad`` — one PPO minibatch loss and gradient at ``highest``
   precision on the GPU against the same computation on the CPU.
5. ``trained`` — BASELINE config 4 (``medium``, 4096 envs, unroll 16,
   hidden 128x2, default cadence) through the normal factories: PPO
   (mlp, cnn, attn), IMPALA with Adam, recurrent PPO (gru, lstm); 3
   updates each, finite metrics, params must move.
6. ``cli`` — ``python -m warehouse_tpu.train --num-updates 3`` with its
   defaults (saving a checkpoint), then ``python -m warehouse_tpu.evaluate
   --policy checkpoint`` on it.

Four cards (``--four``): ``mesh`` (``make_train`` over ``make_mesh`` at
4x4096 envs, one update, against the same global batch on one card with
the data axis emulated by ``vmap``) and ``pbt`` (one ``make_pbt_trainer``
chunk on the ``(pop=2, data=2)`` mesh), then the train CLI, which must
shard over all four cards.

Phases 1-5 run in one child process; this parent never imports jax, and
the CLI processes start only after that child has exited: a JAX process
reserves most of a card's memory when it first touches it, so two live
JAX processes on one card starve each other. There is no CPU fallback:
without a GPU the child exits non-zero and no result line is printed.
The last line of stdout is the result:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
WORKDIR = os.path.join(REPO, "chiprun_out", "chip_smoke")

# Policy math: the error measure is max|out - ref| / max|ref| per output
# (logits, value, carry), against a float64 NumPy forward.
RTOL_HIGHEST = 1e-5   # float32 under default_matmul_precision("highest")
RTOL_DEFAULT = 2e-2   # float32 at default precision (may run as TF32)
RTOL_BF16 = 5e-2      # model_dtype="bfloat16"
# PPO loss and each gradient leaf, GPU vs CPU, both at "highest".
RTOL_GRAD = 1e-4
# Meshed params vs the one-card emulation, both at "highest":
# |a - b| <= RTOL_MESH * |b| + ATOL_MESH elementwise.
RTOL_MESH = 1e-4
ATOL_MESH = 1e-6

ARCHS = ("mlp", "cnn", "attn", "gru", "lstm")


def card_info() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def require_gpu(jax, count: int = 1):
    """The first ``count`` devices, which must be GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU — JAX's first device is "
            f"{devs[0].platform!r} ({devs[0].device_kind})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: need {count} GPUs, JAX sees "
                         f"{len(devs)}")
    return devs[:count]


def _rel_err(out, ref) -> float:
    import numpy as np

    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


# ------------------------------------------------------------------ phases
def _engine_trajectory(cfg, policy, fields):
    """Jitted (keys, actions) -> (reset obs, per-step record) on the
    default device; ``policy="greedy"`` ignores the given actions."""
    import jax

    from warehouse_tpu.baselines.greedy import greedy_actions
    from warehouse_tpu.env.batch import reset_batch, step_batch

    @jax.jit
    def run(keys, rand):
        state, obs0 = reset_batch(cfg, keys)

        def body(s, a_rand):
            a = (jax.vmap(lambda ss: greedy_actions(cfg, ss))(s)
                 if policy == "greedy" else a_rand)
            s, ts = step_batch(cfg, s, a)
            rec = {f: getattr(s, f) for f in fields}
            rec.update(action=a, obs=ts.obs, reward=ts.reward,
                       picked=ts.picked, delivered=ts.delivered,
                       collided=ts.collided, truncated=ts.truncated)
            return s, rec

        _, traj = jax.lax.scan(body, state, rand)
        return obs0, traj

    return run


def phase_engine_vs_oracle(n_envs=16, steps=128,
                           presets=("medium", "shelves")) -> dict:
    """GPU engine trajectories vs the NumPy oracle, bit-exact."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from warehouse_tpu.config import medium_config, shelves_config
    from warehouse_tpu.oracle import JaxDrawSource, OracleEnv
    from warehouse_tpu.oracle import greedy_actions as np_greedy

    makers = {"medium": medium_config, "shelves": shelves_config}
    fields = ("agent_pos", "agent_req", "carrying", "req_pickup",
              "req_drop", "req_status", "req_agent")
    cpu = jax.devices("cpu")[0]
    checked = 0
    for pi, preset in enumerate(presets):
        cfg = makers[preset](max_steps=steps)
        for policy in ("greedy", "random"):
            seed = 1000 * pi + (0 if policy == "greedy" else 500)
            keys = jnp.stack([jax.random.PRNGKey(seed + b)
                              for b in range(n_envs)])
            rand = np.random.default_rng(seed).integers(
                0, cfg.num_actions, (steps, n_envs, cfg.num_agents),
                dtype=np.int32)

            obs0, traj = jax.device_get(
                _engine_trajectory(cfg, policy, fields)(keys, rand))
            with jax.default_device(cpu):
                for b in range(n_envs):
                    env = OracleEnv(cfg, JaxDrawSource(np.asarray(keys[b])))
                    o = env.reset()
                    np.testing.assert_array_equal(o, obs0[b])
                    for t in range(steps):
                        a = (np_greedy(cfg, env.state) if policy == "greedy"
                             else rand[t, b])
                        o, r, _, trunc, info = env.step(a)
                        where = f"{preset}/{policy} env {b} t={t}"
                        np.testing.assert_array_equal(
                            a, traj["action"][t, b], err_msg=where)
                        for f in fields:
                            np.testing.assert_array_equal(
                                getattr(env.state, f), traj[f][t, b],
                                err_msg=f"{f} {where}")
                        for f, v in (("obs", o), ("reward", r),
                                     ("picked", info["picked"]),
                                     ("delivered", info["delivered"]),
                                     ("collided", info["collided"]),
                                     ("truncated", trunc)):
                            np.testing.assert_array_equal(
                                v, traj[f][t, b], err_msg=f"{f} {where}")
                        checked += 1
    return {"env_steps_checked": checked, "tolerance": 0}


def phase_greedy_rollout(B=8192, T=256) -> dict:
    import jax
    import jax.numpy as jnp

    from warehouse_tpu import medium_config
    from warehouse_tpu.baselines.greedy import greedy_actions
    from warehouse_tpu.env.batch import reset_batch, step_autoreset_batch

    cfg = medium_config(auto_reset=True)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(0), i))(jnp.arange(B))
    state, _ = reset_batch(cfg, keys)

    @jax.jit
    def rollout(state):
        def body(s, _):
            a = jax.vmap(lambda ss: greedy_actions(cfg, ss))(s)
            s, ts = step_autoreset_batch(cfg, s, a)
            return s, ts.delivered.sum()

        s, dels = jax.lax.scan(body, state, None, length=T)
        return s, dels.sum()

    jax.block_until_ready(rollout(state))          # compile + warm up
    t0 = time.perf_counter()
    _, dels = jax.block_until_ready(rollout(state))
    dt = time.perf_counter() - t0
    deliveries = int(dels)
    if deliveries <= 0:
        raise AssertionError("greedy rollout made no deliveries")
    return {"B": B, "T": T, "deliveries": deliveries,
            "env_steps_per_s": B * T / dt}


def phase_policy_math(n_envs=64, hidden=128, layers=2) -> dict:
    """Each arch, three precisions, against the float64 reference."""
    import jax
    import jax.numpy as jnp

    from warehouse_tpu import medium_config
    from warehouse_tpu.env.batch import reset_batch
    from warehouse_tpu.models import make_model
    from warehouse_tpu.models.reference import reference_apply

    cfg = medium_config()
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(7), i))(jnp.arange(n_envs))
    _, obs = reset_batch(cfg, keys)                      # [B, A, obs_dim]
    modes = (("highest", jnp.float32, "highest", RTOL_HIGHEST),
             ("default", jnp.float32, None, RTOL_DEFAULT),
             ("bfloat16", jnp.bfloat16, None, RTOL_BF16))
    out = {}
    for arch in ARCHS:
        for mode, dtype, precision, rtol in modes:
            model = make_model(cfg, arch=arch, hidden_dim=hidden,
                               num_layers=layers, dtype=dtype)
            extra = ()
            if arch in ("gru", "lstm"):
                carry = model.initial_carry(obs.shape[:2])
                extra = (jax.tree.map(
                    lambda c: (0.5 * jax.random.normal(
                        jax.random.PRNGKey(3), c.shape)).astype(c.dtype),
                    carry),)
            params = model.init(jax.random.PRNGKey(1), obs[0], *(
                (model.initial_carry((1,)),) if extra else ()))
            with jax.default_matmul_precision(precision):
                got = jax.jit(model.apply)(params, obs, *extra)
            ref = reference_apply(model, params, obs, *extra)
            err = max(_rel_err(g, r) for g, r in
                      zip(jax.tree.leaves(got), jax.tree.leaves(ref)))
            if not err <= rtol:
                raise AssertionError(
                    f"{arch}/{mode}: error {err:.3g} > {rtol}")
            out[f"{arch}/{mode}"] = err
    return {"max_rel_err": out}


def phase_ppo_grad(n_samples=4096, hidden=128) -> dict:
    """PPO loss + grads at "highest": default device vs the CPU."""
    import jax
    import jax.numpy as jnp

    from warehouse_tpu import medium_config
    from warehouse_tpu.models import make_model
    from warehouse_tpu.ops.ppo_update import ppo_losses

    cfg = medium_config()
    model = make_model(cfg, hidden_dim=hidden)
    ks = jax.random.split(jax.random.PRNGKey(11), 7)
    mb = (
        (jax.random.uniform(ks[0], (n_samples, cfg.obs_dim)) < 0.2
         ).astype(jnp.float32),
        jax.random.randint(ks[1], (n_samples,), 0, cfg.num_actions),
        jnp.log(jax.random.uniform(ks[2], (n_samples,), minval=0.1,
                                   maxval=0.5)),
        jax.random.normal(ks[3], (n_samples,)),
        jax.random.normal(ks[4], (n_samples,)),
        jax.random.normal(ks[5], (n_samples,)),
    )
    params = model.init(ks[6], mb[0][:1])

    def loss_fn(params, mb):
        obs, action, old_lp, old_v, adv, tgt = mb
        logits, value = model.apply(params, obs)
        return ppo_losses(logits, value, action, old_lp, old_v, adv, tgt,
                          clip_eps=0.2, value_coef=0.5, ent_coef=0.01,
                          kl_coeff=0.0)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        (loss, _), grads = vg(params, mb)
        (loss_c, _), grads_c = vg(jax.device_put(params, cpu),
                                  jax.device_put(mb, cpu))
    errs = {"loss": _rel_err(loss, loss_c)}
    for (path, g), gc in zip(jax.tree_util.tree_leaves_with_path(grads),
                             jax.tree.leaves(grads_c)):
        errs[jax.tree_util.keystr(path)] = _rel_err(g, gc)
    worst = max(errs.values())
    if not worst <= RTOL_GRAD:
        raise AssertionError(f"PPO loss/grad GPU vs CPU error {worst:.3g}")
    return {"max_rel_err": worst, "loss": float(loss)}


def _config4_tcfg(num_envs=4096, unroll=16, hidden=128, **kw):
    from warehouse_tpu import TrainConfig

    return TrainConfig(num_envs=num_envs, unroll_length=unroll,
                       hidden_dim=hidden, **kw)


def phase_trained(num_envs=4096, unroll=16, hidden=128, updates=3,
                  env=None) -> dict:
    """Each trainer family at config 4 through the normal factories."""
    import jax
    import numpy as np

    from warehouse_tpu import medium_config
    from warehouse_tpu.train.impala import make_train_impala
    from warehouse_tpu.train.ppo import make_train
    from warehouse_tpu.train.ppo_rnn import make_train_rnn

    env = env or medium_config()
    # num_updates matches the CLI phase so its first compile can be a
    # persistent-cache hit.
    tcfg = _config4_tcfg(num_envs, unroll, hidden, num_updates=updates)
    runs = [(f"ppo/{a}", lambda a=a: make_train(env, tcfg, arch=a))
            for a in ("mlp", "cnn", "attn")]
    runs.append(("impala/mlp-adam", lambda: make_train_impala(
        env, tcfg.replace(impala_rmsprop=False))))
    runs += [(f"ppo_rnn/{a}", lambda a=a: make_train_rnn(env, tcfg, arch=a))
             for a in ("gru", "lstm")]
    out = {}
    for name, factory in runs:
        t0 = time.perf_counter()
        trainer = factory()
        rs = trainer.init(jax.random.PRNGKey(tcfg.seed))
        p0 = jax.device_get(rs.params)
        rs, m = jax.block_until_ready(trainer.train_many(rs, updates))
        m = {k: np.asarray(v) for k, v in m.items()}
        bad = [k for k, v in m.items() if not np.isfinite(v).all()]
        if bad:
            raise AssertionError(f"{name}: non-finite {bad}")
        moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in
                    zip(jax.tree.leaves(rs.params), jax.tree.leaves(p0)))
        if not moved > 0:
            raise AssertionError(f"{name}: params did not change")
        out[name] = {"loss": float(m["loss"][-1]),
                     "deliveries_per_env_step":
                         float(m["deliveries_per_env_step"][-1]),
                     "max_param_change": moved,
                     "seconds_incl_compile": time.perf_counter() - t0}
    return out


def phase_mesh(n_dev=4, envs_per_dev=4096, unroll=16, hidden=128) -> dict:
    """One meshed PPO update vs the same global batch on one device."""
    import jax
    import numpy as np

    from warehouse_tpu import medium_config
    from warehouse_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from warehouse_tpu.train.ppo import RunnerState, make_train

    devs = jax.devices()[:n_dev]
    tcfg = _config4_tcfg(n_dev * envs_per_dev, unroll, hidden)
    trainer = make_train(medium_config(), tcfg, mesh=make_mesh(devs))
    key = jax.random.PRNGKey(0)
    with jax.default_matmul_precision("highest"):
        rs_mesh, m_mesh = trainer.train_step(trainer.init_global(key))
        p_mesh = jax.device_get(rs_mesh.params)

        # One device: the per-shard step vmapped over a leading shard
        # axis, whose pmean then runs over that axis.
        with jax.default_device(devs[0]):
            rs = trainer.init(key)

            def split(x):
                return x.reshape(n_dev, x.shape[0] // n_dev, *x.shape[1:])

            rs = rs.replace(env_state=jax.tree.map(split, rs.env_state),
                            obs=split(rs.obs),
                            key=rs.key.reshape(n_dev, 1, 2))
            axes = RunnerState(params=None, opt_state=None, env_state=0,
                               obs=0, key=0, update_idx=None, kl_coeff=None)
            step = jax.jit(jax.vmap(trainer.train_step_local,
                                    in_axes=(axes,), axis_name=DATA_AXIS))
            rs_one, m_one = step(rs)
            p_one = jax.device_get(jax.tree.map(lambda x: x[0],
                                                rs_one.params))
    worst = 0.0
    for a, b in zip(jax.tree.leaves(p_mesh), jax.tree.leaves(p_one)):
        np.testing.assert_allclose(a, b, rtol=RTOL_MESH, atol=ATOL_MESH)
        worst = max(worst, _rel_err(a, b))
    return {"devices": n_dev, "global_envs": tcfg.num_envs,
            "loss_mesh": float(m_mesh["loss"]),
            "loss_one": float(np.asarray(m_one["loss"])[0]),
            "max_rel_param_diff": worst}


def phase_pbt(envs_per_member=4096, unroll=16, hidden=128) -> dict:
    """One PBT chunk on the (pop=2, data=2) mesh."""
    import jax
    import numpy as np

    from warehouse_tpu import medium_config
    from warehouse_tpu.parallel.mesh import make_pop_mesh
    from warehouse_tpu.train.pbt import make_pbt_trainer

    mesh = make_pop_mesh(2, jax.devices()[:4])
    tcfg = _config4_tcfg(envs_per_member, unroll, hidden)
    init_members, train_chunk, _, _ = make_pbt_trainer(
        medium_config(), tcfg, mesh=mesh)
    member = init_members(jax.random.PRNGKey(1), np.full(2, 3e-4),
                          np.full(2, 0.01))
    member, m = jax.block_until_ready(train_chunk(member, 1))
    m = {k: np.asarray(v) for k, v in m.items()}
    if not all(np.isfinite(v).all() for v in m.values()):
        raise AssertionError("PBT metrics not finite")
    return {"mesh": dict(mesh.shape), "loss": m["loss"].tolist()}


def phase_cli(workdir=WORKDIR, train_args=(), eval_args=()) -> dict:
    """Train CLI (3 updates, checkpoint) then evaluate the checkpoint,
    each in its own process."""
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ckpt = os.path.join(workdir, "ckpt")
    metrics = os.path.join(workdir, "metrics.jsonl")
    train = subprocess.run(
        [sys.executable, "-m", "warehouse_tpu.train", "--num-updates", "3",
         "--log-every", "3", "--checkpoint-every", "3",
         "--checkpoint-dir", ckpt, "--metrics-path", metrics, *train_args],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    if train.returncode:
        raise AssertionError(f"train CLI rc={train.returncode}:\n"
                             f"{train.stderr[-3000:]}")
    recs = [json.loads(line) for line in open(metrics)]
    last = recs[-1]
    if last.get("step") != 3 or last["loss"] != last["loss"]:
        raise AssertionError(f"train CLI metrics: {last}")
    if not os.path.isdir(os.path.join(ckpt, "step_00000003")):
        raise AssertionError("train CLI wrote no checkpoint")
    ev = subprocess.run(
        [sys.executable, "-m", "warehouse_tpu.evaluate", "--policy",
         "checkpoint", "--checkpoint-dir", ckpt, *eval_args],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    if ev.returncode or "mean_episode_return" not in ev.stdout:
        raise AssertionError(f"evaluate CLI rc={ev.returncode}:\n"
                             f"{ev.stdout[-2000:]}{ev.stderr[-2000:]}")
    evals = dict(line.split(": ", 1) for line in ev.stdout.splitlines()
                 if ": " in line)
    return {"device": recs[0]["device"], "loss": last["loss"],
            "env_steps_per_sec": last["env_steps_per_sec"],
            "mean_episode_return": float(evals["mean_episode_return"]),
            "log_tail": train.stderr.strip().splitlines()[-3:]}


def phase_cli_four(workdir=WORKDIR) -> dict:
    """The train CLI with its defaults shards over every visible card."""
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    metrics = os.path.join(workdir, "metrics.jsonl")
    train = subprocess.run(
        [sys.executable, "-m", "warehouse_tpu.train", "--num-updates", "1",
         "--num-envs", "16384", "--checkpoint-every", "0",
         "--metrics-path", metrics],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    if train.returncode:
        raise AssertionError(f"train CLI rc={train.returncode}:\n"
                             f"{train.stderr[-3000:]}")
    recs = [json.loads(line) for line in open(metrics)]
    if recs[0]["device"]["count"] != 4 or "mesh:" not in train.stderr:
        raise AssertionError(f"train CLI did not shard over 4 cards: "
                             f"{recs[0]}")
    return {"device": recs[0]["device"], "loss": recs[-1]["loss"],
            "mesh_log": [ln for ln in train.stderr.splitlines()
                         if "mesh:" in ln][:1]}


# ------------------------------------------------------------- drivers
def _run_phase(name, fn, card, results):
    t0 = time.perf_counter()
    try:
        res = fn()
    except Exception:  # a failed phase is reported, the others still run
        print(f"PHASE {name} FAILED ({card}):\n{traceback.format_exc()}",
              flush=True)
        results[name] = None
        return
    res["seconds"] = time.perf_counter() - t0
    print(f"PHASE {name} ok ({card}): {json.dumps(res)}", flush=True)
    results[name] = res


def child(four: bool, card: str) -> None:
    """The in-process phases; last line ``CHILD <json>``."""
    import jax

    devs = require_gpu(jax, 4 if four else 1)
    from warehouse_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    if four:
        phases = (("mesh", phase_mesh), ("pbt", phase_pbt))
    else:
        phases = (("engine_vs_oracle", phase_engine_vs_oracle),
                  ("greedy_rollout", phase_greedy_rollout),
                  ("policy_math", phase_policy_math),
                  ("ppo_grad", phase_ppo_grad),
                  ("trained", phase_trained))
    results = {}
    for name, fn in phases:
        _run_phase(name, fn, card, results)
    print("CHILD " + json.dumps({
        "ok": all(r is not None for r in results.values()),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card mesh phases only")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--card", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.four, args.card)
        return 0

    try:
        card = card_info()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: no GPU (nvidia-smi: {e})", file=sys.stderr)
        return 1
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", "--card",
         card, *(["--four"] if args.four else [])],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    summary = None
    for line in proc.stdout.splitlines():
        if line.startswith("CHILD "):
            summary = json.loads(line[len("CHILD "):])
        else:
            print(line, flush=True)
    if proc.returncode or summary is None:
        print(f"chip_smoke: phase process failed (rc={proc.returncode})",
              file=sys.stderr)
        return 1
    results = {}
    _run_phase("cli", phase_cli_four if args.four else phase_cli, card,
               results)
    print(card, flush=True)           # name, power limit (nvidia-smi)
    if not (summary["ok"] and results["cli"] is not None):
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": summary["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

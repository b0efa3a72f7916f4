"""Hyperparameter sweep harness — Ray Tune capability parity, on-device.

The reference stack launches hyperparameter trials as separate Ray Tune
process trials (`tune.run(PPO, config={"lr": tune.grid_search([...])})`
— SURVEY.md §3.1 [API]). The on-device equivalent keeps the whole
sweep on-device:

- **Seeds are a vmap axis.** Each grid point trains `num_seeds`
  independent replicas *in one compiled program*: `jax.vmap` over the
  full `train_many` update scan batches all per-seed policies, env
  shards, and optimizer states into single large matmuls — the
  Podracer/"one chip, many experiments" pattern. This also yields the
  seed-variance band that BASELINE.json:10's learning-curve criterion
  is defined against, for free.
- **Grid points are sequential compiles.** TrainConfig fields are
  compile-time constants (shapes/fused scalars), so each grid point is
  one retrace — amortized by the vmapped seed axis inside it.

Results stream to a JSONL file (one row per (trial, seed) plus a final
summary row — `tune.ResultGrid` equivalent) and the best trial is
selected by the mean of `select_metric` over the last `last_k` updates,
averaged over seeds.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Any, Sequence

import jax
import numpy as np

from ..config import EnvConfig, TrainConfig
from .ppo import make_train


def _grid_points(grid: dict[str, Sequence[Any]]) -> list[dict[str, Any]]:
    """Cartesian product of the grid, key-sorted for determinism."""
    keys = sorted(grid)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(grid[k] for k in keys))]


def _random_points(space: dict[str, Any], num_samples: int,
                   seed: int) -> list[dict[str, Any]]:
    """Random search (`tune.uniform`/`loguniform`/`choice` analogue).

    Each field's spec is either a list (uniform choice) or a dict with
    one of: {"uniform": [lo, hi]}, {"loguniform": [lo, hi]},
    {"randint": [lo, hi]}. Draw order is key-sorted → deterministic for
    a given seed.
    """
    rng = np.random.default_rng(seed)
    points = []
    for _ in range(num_samples):
        p: dict[str, Any] = {}
        for k in sorted(space):
            spec = space[k]
            if isinstance(spec, (list, tuple)):
                p[k] = spec[int(rng.integers(len(spec)))]
            elif isinstance(spec, dict) and "uniform" in spec:
                lo, hi = spec["uniform"]
                p[k] = float(rng.uniform(lo, hi))
            elif isinstance(spec, dict) and "loguniform" in spec:
                lo, hi = spec["loguniform"]
                p[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
            elif isinstance(spec, dict) and "randint" in spec:
                lo, hi = spec["randint"]
                p[k] = int(rng.integers(lo, hi))
            else:
                raise ValueError(f"bad search spec for {k!r}: {spec!r}")
        points.append(p)
    return points


def run_trial(env_cfg: EnvConfig, tcfg: TrainConfig, num_seeds: int,
              arch: str = "mlp", seed_mesh=None):
    """Train `num_seeds` replicas of one config in one vmapped program.

    Returns `metrics`: dict of arrays [num_seeds, num_updates].

    ``seed_mesh``: optional mesh with a ``pop`` axis
    (``parallel.mesh.make_pop_mesh``) — the seed-replica axis is sharded
    across its ``pop`` devices (replicas are independent, so GSPMD
    partitions the vmapped program with zero collectives; linear
    scaling over devices for free).
    """
    trainer = make_train(env_cfg, tcfg, arch=arch)
    keys = jax.vmap(
        lambda s: jax.random.fold_in(jax.random.PRNGKey(tcfg.seed), s)
    )(np.arange(num_seeds))
    init = jax.vmap(trainer.init)
    if seed_mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import POP_AXIS

        if num_seeds % seed_mesh.shape[POP_AXIS]:
            raise ValueError(
                f"num_seeds={num_seeds} not divisible by "
                f"{seed_mesh.shape[POP_AXIS]} pop shards")
        init = jax.jit(
            init, out_shardings=NamedSharding(seed_mesh, P(POP_AXIS)))
    rs = init(keys)
    n = tcfg.num_updates
    rs, metrics = jax.jit(
        jax.vmap(lambda r: trainer.train_many(r, n))
    )(rs)
    metrics = {k: np.asarray(v) for k, v in metrics.items()}
    return rs, metrics


def run_sweep(
    env_cfg: EnvConfig,
    base_tcfg: TrainConfig,
    grid: dict[str, Sequence[Any]],
    num_seeds: int = 1,
    arch: str = "mlp",
    select_metric: str = "deliveries_per_env_step",
    last_k: int = 10,
    out_path: str | None = None,
    mode: str = "max",
    search: str = "grid",
    num_samples: int = 8,
    search_seed: int = 0,
    seed_mesh=None,
):
    """Hyperparameter sweep. `search="grid"` takes the cartesian product
    of `grid`'s value lists; `search="random"` draws `num_samples`
    points from `grid` treated as a distribution spec (`_random_points`).
    Returns (rows, best) where `rows` is the JSONL payload (one dict per
    (trial, seed) + summary) and `best` is the winning trial summary."""
    if mode not in ("max", "min"):
        raise ValueError("mode must be 'max' or 'min'")
    if search == "grid":
        points = _grid_points(grid)
    elif search == "random":
        points = _random_points(grid, num_samples, search_seed)
    else:
        raise ValueError("search must be 'grid' or 'random'")
    if not points:
        raise ValueError("empty grid")
    rows: list[dict[str, Any]] = []
    trial_scores: list[float] = []
    for i, point in enumerate(points):
        tcfg = base_tcfg.replace(**point)
        _, metrics = run_trial(env_cfg, tcfg, num_seeds, arch=arch,
                               seed_mesh=seed_mesh)
        curve = metrics[select_metric]                 # [S, n]
        k = min(last_k, curve.shape[1])
        per_seed = curve[:, -k:].mean(axis=1)          # [S]
        for s in range(num_seeds):
            rows.append({
                "trial": i,
                "overrides": point,
                "seed": s,
                "score": float(per_seed[s]),
                "final": {m: float(v[s, -1]) for m, v in metrics.items()},
            })
        trial_scores.append(float(per_seed.mean()))
    sign = 1.0 if mode == "max" else -1.0
    best_i = int(np.argmax([sign * s for s in trial_scores]))
    seed_scores = [r["score"] for r in rows if r["trial"] == best_i]
    best = {
        "summary": True,
        "select_metric": select_metric,
        "mode": mode,
        "num_trials": len(points),
        "num_seeds": num_seeds,
        "best_trial": best_i,
        "best_overrides": points[best_i],
        "best_score_mean": trial_scores[best_i],
        "best_score_std": float(np.std(seed_scores)),
        "all_scores": trial_scores,
    }
    rows.append(best)
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows, best


def run_asha(
    env_cfg: EnvConfig,
    base_tcfg: TrainConfig,
    grid: dict[str, Sequence[Any]],
    rung_updates: Sequence[int] = (10, 20, 40),
    eta: int = 2,
    num_seeds: int = 1,
    arch: str = "mlp",
    select_metric: str = "deliveries_per_env_step",
    last_k: int = 5,
    out_path: str | None = None,
    mode: str = "max",
    search: str = "grid",
    num_samples: int = 8,
    search_seed: int = 0,
    seed_mesh=None,
):
    """Successive-halving scheduler (Ray Tune ASHA/HyperBand parity).

    All trials train `rung_updates[0]` updates, then only the top
    `1/eta` fraction (by `select_metric`, seed-averaged over the last
    `last_k` updates of the rung) continue into the next rung, and so
    on. Each trial's jitted `train_many` and RunnerState persist across
    rungs, so promotion is a plain continuation — no checkpoint
    round-trip (the Tune equivalent pauses/restores actor processes);
    a rung length compiles once per distinct length. Returns
    (rows, best); rows include one record per (trial, rung) with the
    rung score and survival flag.
    """
    if mode not in ("max", "min"):
        raise ValueError("mode must be 'max' or 'min'")
    if search == "grid":
        points = _grid_points(grid)
    elif search == "random":
        points = _random_points(grid, num_samples, search_seed)
    else:
        raise ValueError("search must be 'grid' or 'random'")
    if not points:
        raise ValueError("empty search space")
    sign = 1.0 if mode == "max" else -1.0

    trials = []
    for point in points:
        overrides = {**point, "num_updates": int(sum(rung_updates))}
        tcfg = base_tcfg.replace(**overrides)
        trainer = make_train(env_cfg, tcfg, arch=arch)
        keys = jax.vmap(
            lambda s: jax.random.fold_in(jax.random.PRNGKey(tcfg.seed), s)
        )(np.arange(num_seeds))
        init = jax.vmap(trainer.init)
        if seed_mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import POP_AXIS

            if num_seeds % seed_mesh.shape[POP_AXIS]:
                raise ValueError(
                    f"num_seeds={num_seeds} not divisible by "
                    f"{seed_mesh.shape[POP_AXIS]} pop shards")
            init = jax.jit(
                init, out_shardings=NamedSharding(seed_mesh, P(POP_AXIS)))
        rs = init(keys)
        trials.append({"trainer": trainer, "rs": rs, "point": point})

    rows: list[dict[str, Any]] = []
    alive = list(range(len(trials)))
    scores: dict[int, float] = {}
    for rung, n in enumerate(rung_updates):
        for i in alive:
            t = trials[i]
            t["rs"], metrics = jax.jit(
                jax.vmap(lambda r: t["trainer"].train_many(r, n))
            )(t["rs"])
            curve = np.asarray(metrics[select_metric])   # [S, n]
            k = min(last_k, curve.shape[1])
            scores[i] = float(curve[:, -k:].mean(axis=1).mean())
        ranked = sorted(alive, key=lambda i: sign * scores[i], reverse=True)
        keep = max(1, len(alive) // eta) if rung < len(rung_updates) - 1 \
            else len(alive)
        survivors = set(ranked[:keep])
        for i in alive:
            rows.append({
                "trial": i, "rung": rung, "overrides": trials[i]["point"],
                "updates_so_far": int(sum(rung_updates[:rung + 1])),
                "score": scores[i], "promoted": i in survivors,
            })
        alive = [i for i in ranked if i in survivors]
    best_i = alive[0]
    best = {
        "summary": True, "scheduler": "asha", "select_metric": select_metric,
        "mode": mode, "eta": eta, "rung_updates": list(rung_updates),
        "num_trials": len(points), "num_seeds": num_seeds,
        "best_trial": best_i, "best_overrides": points[best_i],
        "best_score": scores[best_i],
    }
    rows.append(best)
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows, best


def main(argv: Sequence[str] | None = None) -> None:
    from ..configs_cli import (add_env_args, apply_backend_args,
                               env_config_from_args)

    p = argparse.ArgumentParser(
        prog="python -m warehouse_tpu.train.sweep",
        description="Grid hyperparameter sweep with vmapped parallel seeds",
    )
    add_env_args(p)
    p.add_argument("--grid", required=True,
                   help='JSON, e.g. \'{"learning_rate": [3e-4, 1e-3]}\'')
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--unroll", type=int, default=16)
    p.add_argument("--arch", default="mlp",
                   choices=["mlp", "cnn", "attn"])
    p.add_argument("--select", default="deliveries_per_env_step")
    p.add_argument("--mode", default="max", choices=["max", "min"])
    p.add_argument("--search", default="grid", choices=["grid", "random"])
    p.add_argument("--samples", type=int, default=8,
                   help="trial count for --search random")
    p.add_argument("--search-seed", type=int, default=0)
    p.add_argument("--scheduler", default="fifo", choices=["fifo", "asha"],
                   help="asha = successive halving: trials share "
                        "--updates across --rungs, bottom 1-1/eta "
                        "dropped at each rung")
    p.add_argument("--rungs", default="10,20,40",
                   help="comma-separated updates per ASHA rung")
    p.add_argument("--eta", type=int, default=2)
    p.add_argument("--last-k", type=int, default=10)
    p.add_argument("--out", default="sweep.jsonl")
    args = p.parse_args(argv)
    apply_backend_args(args)

    grid = json.loads(args.grid)
    env_cfg = env_config_from_args(args)
    tcfg = TrainConfig(num_envs=args.num_envs, unroll_length=args.unroll,
                       num_updates=args.updates)
    common = dict(
        num_seeds=args.seeds, arch=args.arch, select_metric=args.select,
        last_k=args.last_k, out_path=args.out, mode=args.mode,
        search=args.search, num_samples=args.samples,
        search_seed=args.search_seed,
    )
    if args.scheduler == "asha":
        rungs = tuple(int(x) for x in args.rungs.split(","))
        rows, best = run_asha(env_cfg, tcfg, grid,
                              rung_updates=rungs, eta=args.eta, **common)
    else:
        rows, best = run_sweep(env_cfg, tcfg, grid, **common)
    print(json.dumps(best, indent=2))


if __name__ == "__main__":
    main()

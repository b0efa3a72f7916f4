"""Worker for the multi-process distributed test (SURVEY.md §4.5):
run `python tests/_dist_worker.py <pid> <nproc> <port>` in N processes;
each forms the global mesh via jax.distributed and runs 2 sharded PPO
updates, printing the final loss (must match across processes)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    from warehouse_tpu import TrainConfig, small_config
    from warehouse_tpu.parallel.mesh import make_mesh
    from warehouse_tpu.train.ppo import make_train

    assert jax.device_count() == nproc
    mesh = make_mesh(jax.devices())
    tcfg = TrainConfig(num_envs=4 * nproc, unroll_length=4,
                       num_minibatches=2, ppo_epochs=1, hidden_dim=16)
    trainer = make_train(
        small_config(max_steps=8),
        tcfg,
        mesh=mesh,
    )
    rs = trainer.init_global(jax.random.PRNGKey(0))
    loss = None
    for _ in range(2):
        rs, m = trainer.train_step(rs)
        loss = float(m["loss"])
    print(f"DIST_OK pid={pid} update={int(rs.update_idx)} loss={loss:.6f}",
          flush=True)


if __name__ == "__main__":
    main()

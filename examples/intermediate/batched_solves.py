"""Intermediate: one batched call solves thousands of MPC
problems.

No reference counterpart — the reference plans one trajectory at a time;
here 2048 randomized scenarios (starts, goals, obstacle fields) are one
batched call into the same solver the single-vehicle path uses. On the
GPU this dispatches the fused Pallas kernel; on CPU the pure-XLA path.

    python examples/intermediate/batched_solves.py
"""

import time

import numpy as np

from dart_planner_tpu.planning import se3_mpc


def main() -> None:
    config = se3_mpc.SE3MPCConfig()  # horizon N=20
    rng = np.random.default_rng(0)
    B = 2048

    obstacles = np.concatenate(
        [rng.normal(0, 4, (B, 4, 3)), rng.uniform(0.3, 1.2, (B, 4, 1))],
        axis=-1,
    ).astype(np.float32)
    prob = se3_mpc.make_problem(
        rng.normal(0, 2, (B, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (B, 3)).astype(np.float32),
        rng.normal(0, 5, (B, 3)).astype(np.float32) + [0, 0, 5],
        obstacles=obstacles,
        config=config,
    )

    result = se3_mpc.solve(config, prob)  # compile + solve
    t0 = time.perf_counter()
    result = se3_mpc.solve(config, prob)
    np.asarray(result.cost)  # block
    dt = time.perf_counter() - t0

    conv = float(np.mean(np.asarray(result.converged)))
    print(f"{B} scenarios in {dt*1e3:.1f} ms -> {B/dt:,.0f} solves/s")
    print(f"converged: {conv:.1%}   mean cost: {float(np.mean(np.asarray(result.cost))):,.0f}")
    print(f"worst terminal miss: "
          f"{float(np.max(np.linalg.norm(np.asarray(result.positions)[:, -1] - np.asarray(prob.goal), axis=-1))):.2f} m")


if __name__ == "__main__":
    main()

"""Advanced: shard a scenario fleet over a device mesh.

No reference counterpart. Runs a Monte-Carlo fleet across every visible
device via a ("hosts", "devices") mesh: scenarios shard over the mesh,
the solve is communication-free, and fleet statistics psum-reduce.
Works on the GPUs of one host or a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/advanced/fleet_sharding.py
"""

import jax
import numpy as np

from dart_planner_tpu.parallel import scenario
from dart_planner_tpu.planning import se3_mpc


def main() -> None:
    mesh = scenario.make_fleet_mesh()
    n_dev = mesh.devices.size
    print(f"mesh: {dict(mesh.shape)} ({n_dev} devices)")

    config = se3_mpc.SE3MPCConfig(prediction_horizon=12, max_iterations=8)
    B = 64 * n_dev
    rng = np.random.default_rng(0)
    prob = se3_mpc.make_problem(
        rng.normal(0, 2, (B, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (B, 3)).astype(np.float32),
        rng.normal(0, 5, (B, 3)).astype(np.float32) + [0, 0, 5],
        config=config,
    )
    prob = scenario.shard_scenarios(prob, mesh)

    result, stats = scenario.solve_fleet(
        config, mesh, prob, use_obstacles=False
    )
    jax.block_until_ready(result.thrusts)
    print(
        f"fleet of {int(stats.total)}: "
        f"{int(stats.converged)} converged, "
        f"mean cost {float(stats.mean_cost):,.0f}, "
        f"max grad norm {float(stats.max_grad_norm):.3f}"
    )
    shard_shapes = {s.data.shape for s in result.thrusts.addressable_shards}
    print(f"per-device shard shapes: {shard_shapes}")


if __name__ == "__main__":
    main()

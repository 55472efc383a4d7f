"""DART-Planner: a batched, accelerator-native SE(3) MPC autonomy stack.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
``Pasqui1010/DART-Planner`` (reference mounted at /root/reference):

- L1 global mission planning        -> :mod:`dart_planner_tpu.planning.global_mission`
- L2 SE(3) MPC trajectory optimizer -> :mod:`dart_planner_tpu.planning.se3_mpc`
- L3 geometric SE(3) control        -> :mod:`dart_planner_tpu.control.geometric`
- Perception / voxel mapping        -> :mod:`dart_planner_tpu.perception`
- Scenario-batch + multi-host       -> :mod:`dart_planner_tpu.parallel`
- Simulation / Monte-Carlo fleets   -> :mod:`dart_planner_tpu.sim`

Design principles (see SURVEY.md section 7):

1. Everything numerical is a pure, jittable function over pytrees; state is
   explicit (no mutable controller/planner objects in hot paths).
2. Static shapes everywhere: obstacle sets are padded to a max count, horizons
   are compile-time constants, convergence is tracked by masks not early exit.
3. The scenario batch is the scaling axis: ``vmap`` on one device,
   ``shard_map`` over a ("hosts", "devices") mesh for fleets.
4. The hot solve is a condensed projected-Newton QP (decision variables =
   thrust vectors only; dynamics eliminated through a linear rollout), so a
   horizon-20 solve is a 60-variable QP that batches across scenarios.
"""

__version__ = "0.1.0"

from dart_planner_tpu.common.types import (
    ControlCommand,
    BodyRateCommand,
    DroneState,
    Trajectory,
)

__all__ = [
    "ControlCommand",
    "BodyRateCommand",
    "DroneState",
    "Trajectory",
    "__version__",
]

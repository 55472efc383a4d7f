"""Scenario-batch parallelism: vmap on one device, shard_map over a mesh.

The reference's only distribution is an edge<->cloud ZMQ split
(/root/reference/src/dart_planner/communication/, SURVEY.md section 2.7).
Here the scaling axis is the *scenario batch*: thousands of
independent MPC solves batched per device and sharded over a
("hosts", "devices") mesh, with collectives only for fleet-level
reductions (success rates, cost statistics), never on the per-scenario
solve path.
"""

from dart_planner_tpu.parallel.scenario import (
    FleetStats,
    make_fleet_mesh,
    shard_scenarios,
    solve_fleet,
    fleet_statistics,
)

__all__ = [
    "FleetStats",
    "make_fleet_mesh",
    "shard_scenarios",
    "solve_fleet",
    "fleet_statistics",
]

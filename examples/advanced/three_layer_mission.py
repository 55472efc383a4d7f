"""Advanced: the full three-layer stack in one closed loop.

Mirrors the reference examples/advanced/advanced_mission_example.py:
L1 mission planner feeds semantic waypoints, L2 SE(3) MPC plans around
mapper-sourced obstacles, L3 geometric control tracks the plan on the
simulated plant.

    python examples/advanced/three_layer_mission.py
"""

import numpy as np

from dart_planner_tpu.common.types import DroneState
from dart_planner_tpu.perception import GeometricMapper
from dart_planner_tpu.planning.global_mission import (
    GlobalMissionPlanner,
    SemanticWaypoint,
)
from dart_planner_tpu.planning.se3_mpc import SE3MPCConfig, SE3MPCPlanner


def main() -> None:
    mission = GlobalMissionPlanner()
    mission.set_mission_waypoints(
        [
            SemanticWaypoint((0.0, 0.0, 3.0), "takeoff_point"),
            SemanticWaypoint((6.0, 2.0, 3.0), "survey_corner"),
            SemanticWaypoint((10.0, -2.0, 4.0), "goal_pad"),
        ]
    )

    mapper = GeometricMapper(resolution=0.5)
    mapper.add_obstacle((5.0, 0.0, 3.0), 0.8)

    planner = SE3MPCPlanner(SE3MPCConfig(prediction_horizon=12))
    # L2 obstacle source: spheres extracted from the occupancy map
    obstacles, mask = mapper.extract_obstacles(center=(5.0, 0.0, 3.0))
    for row, ok in zip(obstacles, mask):
        if ok:
            planner.add_obstacle(row[:3], float(row[3]))

    pos = np.float32([0.0, 0.0, 0.5])  # on a raised pad (plans below
    vel = np.zeros(3, np.float32)      # 0.1 m altitude are rejected)
    t = 0.0
    for step in range(40):  # 10 Hz replan for 4 s
        state = DroneState.create(timestamp=t, position=pos, velocity=vel)
        goal = mission.get_current_goal(state)
        traj = planner.plan_trajectory(state, goal)
        # perfect-tracking plant: integrate the plan's first acceleration
        acc = np.asarray(traj.accelerations)[1]
        vel = vel + acc * 0.1
        pos = pos + vel * 0.1
        t += 0.1
        if step % 10 == 0:
            print(
                f"t={t:4.1f}s phase={mission.current_phase.value:<12} "
                f"pos=({pos[0]:5.2f},{pos[1]:5.2f},{pos[2]:4.2f}) "
                f"goal=({goal[0]:.1f},{goal[1]:.1f},{goal[2]:.1f})"
            )
    print("mission stats:", planner.get_planning_stats())


if __name__ == "__main__":
    main()

"""Advanced: the hardware mission orchestrator over a VehicleIO.

Mirrors the reference's ``PixhawkInterface.start_mission`` call stack
(pixhawk_interface.py:297-314): one call gathers the 400 Hz control
loop, the 50 Hz SE(3) MPC planning loop, 10 Hz telemetry, and the
safety monitor (velocity/altitude envelope, heartbeat, motor-saturation
watchdog) against any vehicle. Here the vehicle is the pure-software
``SimulatedVehicleIO``; swap in ``VehicleIOFactory.create("pixhawk")``
on a machine with pymavlink and a flight controller.

    python examples/advanced/hardware_mission.py
"""

import asyncio

import numpy as np

from dart_planner_tpu.hardware import (
    MissionConfig,
    MissionRunner,
    SimulatedVehicleIO,
)


async def main() -> None:
    vehicle = SimulatedVehicleIO(
        {"initial_position": (0.0, 0.0, 2.0), "control_dt": 0.01}
    )
    await vehicle.connect()
    await vehicle.arm()
    vehicle.step()  # pre-warm the control-path compiles

    runner = MissionRunner(
        vehicle,
        MissionConfig(
            control_frequency=100.0,  # 400 on flight hardware
            planning_frequency=10.0,  # 50 on flight hardware
            waypoint_tolerance=0.8,
        ),
    )
    waypoints = [(3.0, 0.0, 3.0), (3.0, 3.0, 3.5), (0.0, 0.0, 2.5)]
    print(f"flying {len(waypoints)} waypoints ...")
    report = await runner.start_mission(waypoints)

    print(f"mission complete: {report['mission_complete']}")
    print(
        f"waypoints reached: {report['waypoints_reached']}"
        f"/{report['waypoints_total']}"
    )
    print(f"avg planning time: {report.get('avg_planning_time_ms', 0):.1f} ms")
    print(f"commands sent: {report['commands_sent']}")
    print(f"final position: {np.asarray(vehicle.get_state().position)}")
    if report["failsafe_reason"]:
        print(f"failsafe: {report['failsafe_reason']}")


if __name__ == "__main__":
    asyncio.run(main())

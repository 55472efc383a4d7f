"""Beginner: arm -> takeoff -> hover -> land on the simulated vehicle.

Mirrors the reference examples/beginner/minimal_takeoff.py; the flight
logic lives in :mod:`dart_planner_tpu.apps.minimal_takeoff`.

    python examples/beginner/minimal_takeoff.py
"""

import asyncio

from dart_planner_tpu.apps.minimal_takeoff import minimal_takeoff


def main() -> None:
    out = asyncio.run(minimal_takeoff(altitude=3.0, hover_s=2.0))
    print(
        f"peak {out['peak_altitude']:.2f} m | "
        f"hover {out['hover_altitude']:.2f} m | "
        f"landed {out['final_altitude']:.2f} m "
        f"(target {out['target_altitude']:.1f} m)"
    )


if __name__ == "__main__":
    main()

"""Command-line interface.

Port of the reference ``dart_planner_cli.py`` (:10-43): ``run
--mode=cloud|edge`` dispatch after loading + validating the frozen
config, extended with ``sim`` (minimal takeoff), ``bench`` (the repo
benchmark), and ``demo`` (websocket web demo).
"""

from __future__ import annotations

import argparse
import asyncio
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dart-planner-tpu",
        description="Batched SE(3) MPC drone autonomy stack",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    run_p = sub.add_parser("run", help="run a stack component")
    run_p.add_argument(
        "--mode",
        choices=["cloud", "edge", "sim"],
        required=True,
        help="cloud: three-layer planning service; edge: control loop; "
        "sim: minimal takeoff demo",
    )
    run_p.add_argument("--port", type=int, default=5555)
    run_p.add_argument("--duration", type=float, default=None)

    sub.add_parser("bench", help="run the headline benchmark")
    demo_p = sub.add_parser("demo", help="run the websocket web demo")
    demo_p.add_argument("--port", type=int, default=8080)
    demo_p.add_argument("--duration", type=float, default=None)

    args = parser.parse_args(argv)
    if args.command == "run" and args.mode == "edge":
        # placement: the edge process runs its per-tick controller on the
        # CPU, so on a one-GPU host the cloud planner (a second JAX
        # process) keeps the card; JAX never opens the GPU here
        import jax

        jax.config.update("jax_platforms", "cpu")

    # load + validate frozen config before anything runs (reference :25-32)
    from dart_planner_tpu.config import get_frozen_config

    config = get_frozen_config()

    # optional ops endpoint for ANY mode: DART_METRICS_PORT serves the
    # Prometheus exposition the deploy/ stack scrapes (deploy/README.md)
    import os

    metrics_server = None
    if os.environ.get("DART_METRICS_PORT") and args.command != "demo":
        # (the demo starts its own endpoint from the same env var)
        from dart_planner_tpu.common.metrics import get_metrics

        metrics_server = get_metrics().serve(
            int(os.environ["DART_METRICS_PORT"]),
            host=os.environ.get("DART_METRICS_HOST", "127.0.0.1"),
        )

    if args.command == "run":
        if args.mode == "cloud":
            from dart_planner_tpu.apps import cloud

            asyncio.run(cloud.main(port=args.port, duration=args.duration))
        elif args.mode == "edge":
            from dart_planner_tpu.apps import edge

            stats = asyncio.run(edge.main(duration=args.duration or 10.0))
            print(stats)
        else:
            from dart_planner_tpu.apps import minimal_takeoff

            minimal_takeoff.main()
    elif args.command == "bench":
        import pathlib
        import runpy

        bench = pathlib.Path(__file__).resolve().parents[2] / "bench.py"
        runpy.run_path(str(bench), run_name="__main__")
    elif args.command == "demo":
        from dart_planner_tpu.apps import web_demo

        asyncio.run(web_demo.main(port=args.port, duration=args.duration))
    if metrics_server is not None:
        metrics_server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

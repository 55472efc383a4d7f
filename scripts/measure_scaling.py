"""Weak-scaling efficiency measurement across real processes (CPU).

Runs the distributed worker at 1, 2, 4 (and optionally 8) processes with
a FIXED per-device scenario load, and reports solves/s/device at each
mesh size. Efficiency(N) = rate_per_device(N) / rate_per_device(1);
the north-star bar is >=85% at N>=2 hosts. Results go into
docs/scaling.md.

Usage: python scripts/measure_scaling.py [--per-device 256] [--max-procs 8]
"""

import argparse
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "scripts", "distributed_worker.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh(num_processes, local_devices, per_device, reps,
             pin_cores=False, tail_iterations=0):
    batch = per_device * num_processes * local_devices
    port = free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    ncores = os.cpu_count() or 1

    def prefix(i):
        # one core per process: without pinning, XLA's intra-op thread
        # pool lets a 1-process run use EVERY core, which under-reports
        # multi-process efficiency as core contention, not network cost
        return (
            ["taskset", "-c", str(i % ncores)] if pin_cores else []
        )

    procs = [
        subprocess.Popen(
            [
                *prefix(i),
                sys.executable, WORKER,
                "--coordinator", f"localhost:{port}",
                "--num-processes", str(num_processes),
                "--process-id", str(i),
                "--local-devices", str(local_devices),
                "--global-batch", str(batch),
                "--measure", "--reps", str(reps),
                "--tail-iterations", str(tail_iterations),
            ],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT,
        )
        for i in range(num_processes)
    ]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    for i, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {i} failed:\n{o[-3000:]}")
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(outs[0][-2000:])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=256)
    ap.add_argument("--max-procs", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--pin-cores", action="store_true")
    ap.add_argument("--tail-iterations", type=int, default=0,
                    help="measure with the two-phase adaptive tail "
                         "(VERDICT r4 item 6: the shipping config is 8)")
    args = ap.parse_args()

    rows = []
    n = 1
    while n <= args.max_procs:
        r = run_mesh(n, 1, args.per_device, args.reps,
                     pin_cores=args.pin_cores,
                     tail_iterations=args.tail_iterations)
        t = r["throughput"]
        rows.append(t)
        print(
            f"procs={n:2d} devices={t['devices']:2d} "
            f"batch={t['global_batch']:5d} "
            f"solves/s={t['solves_per_s']:6.0f} "
            f"per-device={t['solves_per_s_per_device']:6.0f}",
            flush=True,
        )
        n *= 2

    base = rows[0]["solves_per_s_per_device"]
    print("\n| processes | devices | global batch | solves/s | "
          "solves/s/device | efficiency |")
    print("|---|---|---|---|---|---|")
    for t in rows:
        eff = t["solves_per_s_per_device"] / base
        print(
            f"| {t['processes']} | {t['devices']} | {t['global_batch']} "
            f"| {t['solves_per_s']:.0f} | "
            f"{t['solves_per_s_per_device']:.0f} | {eff:.1%} |"
        )


if __name__ == "__main__":
    main()

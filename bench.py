"""Headline benchmark: batched SE(3) MPC throughput (solves/s/device, N=20).

Prints a cumulative JSON line after EVERY completed section; the LAST
line printed is always the most complete result. ``vs_baseline`` is
measured throughput over the north-star target of 1,000 solves/s/device
(BASELINE.md); extra fields record the single-solve latency and the
planner->actuator dispatch path against the reference's CI gates
(/root/reference/tests/test_real_time_latency.py:109-120).

Runs on the GPU only: with no GPU it exits 2 before compiling anything.
Every line names the device (platform, ``device_kind``, count, and the
``nvidia-smi`` name and power limit). Sections run in priority order;
an error in one is recorded and the rest still run, but the process then
exits 3. A watchdog enforces a global wall-clock budget
(``BENCH_BUDGET_S``, default 900 s): on expiry it prints the cumulative
JSON with ``"truncated": true`` and exits 3 (1 if a latency gate had
already failed). A failed latency gate exits 1. The same JSON is
mirrored to ``BENCH_PARTIAL.json`` after each section.

Timing: host clock around work that ends in ``jax.block_until_ready``;
each measurement is a data-dependent chain of R solves (the warm-start
output of solve k feeds solve k+1), min over passes. The first call of
each section compiles; its time is reported as set-up (``setup_s``).
Every section runs ``method="auto"``: the fused kernels on the GPU.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
_PARTIAL = os.path.join(_ROOT, "BENCH_PARTIAL.json")


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit of the cards, one per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class _Report:
    """Cumulative result store + watchdog.

    Every ``update``/``error`` rewrites ``BENCH_PARTIAL.json`` and prints
    the full cumulative JSON line, so an external kill in section k can
    never erase sections 1..k-1 from the captured tail.
    """

    def __init__(self, budget_s: float):
        self.t0 = time.monotonic()
        self.budget = budget_s
        self.lock = threading.Lock()
        self.gate_failures = []
        self.data = {
            "metric": "batched SE(3) MPC throughput (N=20, 4096 scenarios)",
            "value": None,
            "unit": "solves/s/device",
            "vs_baseline": None,
            "sections": [],
            "setup_s": {},
            "truncated": False,
        }
        self._watchdog = threading.Timer(budget_s, self._on_deadline)
        self._watchdog.daemon = True
        self._watchdog.start()

    def remaining(self) -> float:
        return self.budget - (time.monotonic() - self.t0)

    def update(self, section: str, **fields) -> None:
        with self.lock:
            self.data.update(fields)
            self.data["sections"].append(section)
            self._dump()

    def setup(self, section: str, seconds: float) -> None:
        with self.lock:
            self.data["setup_s"][section] = round(seconds, 3)

    def error(self, section: str, exc: BaseException) -> None:
        with self.lock:
            msg = f"{section}: {type(exc).__name__}: {exc}"
            self.data.setdefault("section_errors", []).append(msg[:500])
            self._dump()

    def _dump(self) -> None:
        self.data["elapsed_s"] = round(time.monotonic() - self.t0, 1)
        line = json.dumps(self.data)
        try:
            with open(_PARTIAL, "w") as f:
                f.write(line + "\n")
        except OSError:
            pass
        print(line, flush=True)

    def _on_deadline(self) -> None:
        # a section overran the global budget: ship what we have, and
        # say so in the exit code. os._exit because the main thread may
        # be blocked in C.
        with self.lock:
            self.data["truncated"] = True
            self._dump()
        os._exit(1 if self.gate_failures else 3)

    def finish(self) -> None:
        self._watchdog.cancel()


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2

    from dart_planner_tpu.common.compile_cache import setup_compile_cache

    cache_dir = setup_compile_cache()
    rep = _Report(float(os.environ.get("BENCH_BUDGET_S", "900")))
    rep.data.update(
        device={
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        gpu=gpu_name_and_power_limit(),
        jax_version=jax.__version__,
        compile_cache=cache_dir,
    )

    import jax.numpy as jnp

    from dart_planner_tpu.planning import se3_mpc
    from dart_planner_tpu.sim.scenarios import random_obstacle_problem

    method = "auto"
    config = se3_mpc.SE3MPCConfig()  # N=20, two-phase adaptive tail
    config_p1 = config._replace(tail_iterations=0)
    rng = np.random.default_rng(0)

    def problem(batch):
        return random_obstacle_problem(config, batch, rng)

    def solve(prob, u):
        return se3_mpc.solve(config, prob, u, method=method)

    def solve_p1(prob, u):
        return se3_mpc.solve(config_p1, prob, u, method=method)

    def first_call(section, fn, *a):
        """The section's first (compiling) call, timed as set-up."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*a))
        rep.setup(section, time.perf_counter() - t0)
        return out

    def chain(fn, prob, u, reps):
        """Seconds per call of a warm-started chain of ``reps`` solves."""
        t0 = time.perf_counter()
        for _ in range(reps):
            u = fn(prob, u).thrusts
        jax.block_until_ready(u)
        return (time.perf_counter() - t0) / reps, u

    def timed_chain(section, fn, prob, u0, reps, passes=3):
        u = first_call(section, fn, prob, u0).thrusts
        best = float("inf")
        for _ in range(passes):
            t, u = chain(fn, prob, u, reps)
            best = min(best, t)
        return best

    # ------------------------------------------------------------------
    # Section 1 (headline): batched throughput, 4096 scenarios.
    # headline = the SHIPPING two-phase config (12 Newton rounds + the
    # adaptive tail-refinement pass); the single-phase rate
    # (tail_iterations=0) is reported alongside, the gap being the tail
    # pass's price. The two are timed in interleaved passes so both see
    # the same clocks.
    # ------------------------------------------------------------------
    def sec_throughput():
        batch = 4096
        prob = jax.device_put(problem(batch))
        u0 = se3_mpc.initialize_thrusts(config, prob)
        u_ship = first_call("throughput", solve, prob, u0).thrusts
        u_p1 = first_call("throughput_phase1", solve_p1, prob, u0).thrusts
        per_call = per_call_p1 = float("inf")
        for _ in range(3):
            t, u_ship = chain(solve, prob, u_ship, 30)
            per_call = min(per_call, t)
            t, u_p1 = chain(solve_p1, prob, u_p1, 30)
            per_call_p1 = min(per_call_p1, t)
        rep.update(
            "throughput",
            value=batch / per_call,
            vs_baseline=batch / per_call / 1000.0,
            phase1_solves_per_s=batch / per_call_p1,
            batch_step_ms=per_call * 1e3,
        )

    # ------------------------------------------------------------------
    # Section 2: single-solve latency (reference budget: 50 ms).
    # ------------------------------------------------------------------
    def sec_single():
        prob1 = jax.device_put(problem(1))
        u1 = se3_mpc.initialize_thrusts(config, prob1)
        lat_s = timed_chain("single", solve, prob1, u1, reps=100)
        rep.update(
            "single",
            single_solve_device_ms=lat_s * 1e3,
            single_solve_budget_ms=50.0,
        )

    # ------------------------------------------------------------------
    # Section 3: planner-to-actuator dispatch path — precompiled single
    # solve with donated on-device warm start -> one setpoint fetch ->
    # C++ 400 Hz RT executor tick (native/rt_executor.cpp). This is the
    # reference's CI latency gate
    # (/root/reference/tests/test_real_time_latency.py:109-120: total
    # p95 < 50 ms).
    # ------------------------------------------------------------------
    def sec_fastpath():
        from dart_planner_tpu.runtime import rt_executor
        from dart_planner_tpu.runtime.fast_path import (
            PlannerFastPath,
            measure_latency,
        )

        fp = PlannerFastPath(config, method=method)
        loop = rt_executor.create_control_loop(frequency_hz=400.0)
        loop.set_gains(
            kp_pos=[7.0, 7.0, 8.5], ki_pos=[0.5] * 3, kd_pos=[4.0] * 3,
            kp_att=[10.0] * 3, ki_att=[0.1] * 3, kd_att=[1.0] * 3,
        )
        t0 = time.perf_counter()
        fp.replan([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [5.0, 3.0, 4.0])
        rep.setup("fastpath", time.perf_counter() - t0)
        loop.start()
        try:
            rt = measure_latency(fp, loop, n_replans=150)
        finally:
            loop.stop()
        gates = {
            "planning_host_p95_ms": (rt["planning_host_p95_ms"], 50.0),
            "control_tick_p95_ms": (rt["control_tick_p95_ms"], 5.0),
            "planner_to_actuator_p95_ms": (
                rt["planner_to_actuator_p95_ms"], 50.0
            ),
        }
        rep.gate_failures.extend(
            f"{k}={v:.3f} >= {lim}"
            for k, (v, lim) in gates.items() if v >= lim
        )
        rep.update(
            "fastpath",
            planner_to_actuator_p95_ms=rt["planner_to_actuator_p95_ms"],
            planning_host_p50_ms=rt["planning_host_p50_ms"],
            planning_host_p95_ms=rt["planning_host_p95_ms"],
            control_tick_p95_ms=rt["control_tick_p95_ms"],
            control_loop=type(loop).__name__,
            latency_gate_ok=not rep.gate_failures,
        )

    # ------------------------------------------------------------------
    # Section 4: 100k+ fleet (BASELINE config 5, one device's share).
    # ------------------------------------------------------------------
    def sec_fleet():
        fleet = 131072
        prob_f = jax.device_put(problem(fleet))
        u_f = se3_mpc.initialize_thrusts(config, prob_f)
        per_fleet = timed_chain("fleet", solve, prob_f, u_f, reps=6, passes=2)
        rep.update("fleet", fleet_131072_solves_per_s=fleet / per_fleet)

    # ------------------------------------------------------------------
    # Section 5: closed-loop Monte-Carlo (BASELINE config 4): 6 s
    # episodes, randomized starts + wind + sensor noise + per-episode
    # obstacle fields perceived through the explicit mapper; 10 Hz
    # replans, 400 Hz control+physics tick blocks. Reports QUALITY
    # (success/crash/RMSE vs the reference's >=80% Monte-Carlo
    # criterion, /root/reference/tests/test_monte_carlo_sim.py:75-81)
    # alongside throughput.
    # ------------------------------------------------------------------
    def sec_mc():
        from dart_planner_tpu.sim import closed_loop
        from dart_planner_tpu.sim.scenarios import bench_monte_carlo

        setup = bench_monte_carlo(2048)

        def run_mc():
            return closed_loop.simulate_episode(*setup.args, method=method,
                                                **setup.kwargs)

        res = first_call("mc", run_mc)
        mc_best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            res = jax.block_until_ready(run_mc())
            mc_best = min(mc_best, time.perf_counter() - t0)
        rep.update(
            "mc",
            closed_loop_episodes_per_s=setup.n / mc_best,
            mc_success_rate=float(jnp.mean(res.success)),
            mc_crash_rate=float(jnp.mean(res.crashed)),
            tracking_rmse_m=float(jnp.mean(res.tracking_rmse)),
            mean_min_obstacle_clearance_m=float(
                jnp.mean(res.min_obstacle_clearance)
            ),
        )

    sections = [
        ("throughput", sec_throughput),
        ("single", sec_single),
        ("fastpath", sec_fastpath),
        ("fleet", sec_fleet),
        ("mc", sec_mc),
    ]
    failed = False
    for name, fn in sections:
        if rep.remaining() < 15.0:
            rep.error(name, TimeoutError("skipped: global budget spent"))
            failed = True
            continue
        try:
            fn()
        except Exception as e:  # isolate: one bad section loses itself only
            rep.error(name, e)
            failed = True

    rep.finish()
    with rep.lock:
        rep._dump()  # final (most complete) line is the last printed
    if rep.gate_failures:
        print("LATENCY GATE FAILED: " + "; ".join(rep.gate_failures),
              file=sys.stderr)
        return 1
    return 3 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

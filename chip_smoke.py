"""Chip smoke test: the SE(3) MPC main path on the GPU, at real sizes.

    python chip_smoke.py               # phases 0-4 on one GPU
    python chip_smoke.py --four-cards  # the sharded fleet over four GPUs

Phases (each prints its lines and its time; a first, compiling call is
reported on its own ``setup`` line):

0. device: platform must be ``gpu`` (else exit 2 before compiling);
   JAX version, device kind, ``nvidia-smi`` name and power limit, and
   where the compile cache is;
1. batched solve, 4096 scenarios (the bench's randomized obstacle batch,
   seed 0), shipping two-phase config and single-phase, ``method="auto"``
   against the plain reference: the XLA path at ``Precision.HIGHEST``;
   a convex batch (hinge weights 0, no obstacles) for the tight check;
   and the GPU's XLA path against the CPU's on the same batch (the CPU
   side runs in a child process that never opens the GPU);
2. single replan: ``PlannerFastPath`` feeding the 400 Hz control loop
   (``make -C native`` first), 100 replans;
3. fleet, 131,072 scenarios through ``solve_fleet`` on a one-device mesh;
4. closed loop, 2048 episodes of the bench's Monte-Carlo setup, against
   the reference's 80% success criterion; timed with the tick kernel,
   with the scan under the same solve kernel, and on the XLA path; the
   tick kernel against the scan;
5. ``--four-cards`` only (and nothing else): 4 x 131,072 scenarios
   sharded over a (1, 4) mesh, against each shard solved alone.

Any failed check raises: the process exits non-zero and never prints
the final ``{"ok": true, ...}`` line, which is the last line of a
passing run.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_BATCH = 4096
N_FLEET = 131072
N_EPISODES = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Times a phase and prints its wall time when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== phase {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name}: {time.perf_counter() - self.t0:.2f} s")
        return False


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def timed(label, fn, reps):
    """First call (compile + run) on a setup line, then the best of three
    passes of ``reps`` back-to-back calls on the same inputs, each pass
    ending in block_until_ready: per-call dispatch overlaps the device
    work before it, as in a stream of solves."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    log(f"  setup {label}: {time.perf_counter() - t0:.2f} s (compile + first run)")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / reps)
    log(f"  time {label}: {best * 1e3:.3f} ms per call")
    return out, best


def aggregate_parity(name, res, ref, cold_cost, converged_pts=0.02):
    """The aggregate contract for obstacle problems, where per-scenario
    paths may branch at line-search near-ties: mean cost <= 1.05 x the
    reference, every solve at or below its cold-start cost + 1e-3, and
    the converged share within 2 points of the reference."""
    c, cr = np.asarray(res.cost, np.float64), np.asarray(ref.cost, np.float64)
    conv, conv_r = float(np.mean(res.converged)), float(np.mean(ref.converged))
    log(f"  {name}: mean cost {c.mean():.6g} vs ref {cr.mean():.6g} "
        f"(ratio {c.mean() / cr.mean():.6f}); converged {conv:.4f} vs "
        f"{conv_r:.4f}")
    check(bool(np.isfinite(c).all()), f"{name}: finite costs, shape {c.shape}")
    check(c.mean() <= 1.05 * cr.mean(), f"{name}: mean cost <= 1.05 x reference")
    worst = float(np.max(c - np.asarray(cold_cost, np.float64)))
    check(worst <= 1e-3,
          f"{name}: every solve <= its cold-start cost + 1e-3 (worst {worst:.3g})")
    check(abs(conv - conv_r) <= converged_pts,
          f"{name}: converged share within {converged_pts * 100:.0f} points")


def gpu_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed (rc {out.returncode}): {out.stderr}")
    return out.stdout.strip()


def cpu_reference(batch: int) -> None:
    """Child mode: the single-phase XLA solve of the phase-1 batch on the
    CPU; prints one JSON line."""
    import jax

    from dart_planner_tpu.planning import se3_mpc
    from dart_planner_tpu.sim.scenarios import random_obstacle_problem

    if jax.devices()[0].platform != "cpu":
        raise RuntimeError("the CPU reference must not open the GPU")
    config = se3_mpc.SE3MPCConfig(tail_iterations=0)
    prob = random_obstacle_problem(config, batch, np.random.default_rng(SEED))
    res = se3_mpc.solve(config, prob, method="xla")
    print(json.dumps({
        "cost": np.asarray(res.cost).tolist(),
        "converged": np.asarray(res.converged).tolist(),
    }))


def start_cpu_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference",
         str(N_BATCH)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT,
    )


def phase_batched(cpu_child):
    import jax

    from dart_planner_tpu.planning import se3_mpc
    from dart_planner_tpu.sim.scenarios import random_obstacle_problem

    ship = se3_mpc.SE3MPCConfig()
    single = ship._replace(tail_iterations=0)
    prob = jax.device_put(
        random_obstacle_problem(ship, N_BATCH, np.random.default_rng(SEED))
    )
    u0 = se3_mpc.initialize_thrusts(ship, prob)
    cold = se3_mpc._finalize(ship, prob, u0).cost
    log(f"  auto resolves to {se3_mpc.resolve_method('auto')!r}")
    xla = {}
    for name, cfg in (("two-phase", ship), ("single-phase", single)):
        ref, t_ref = timed(f"{name} xla", lambda: se3_mpc.solve(cfg, prob, u0, method="xla"), 20)
        xla[name] = ref
        res, t = timed(f"{name} auto", lambda: se3_mpc.solve(cfg, prob, u0, method="auto"), 20)
        log(f"  {name}: auto {N_BATCH / t:.1f} solves/s, xla {N_BATCH / t_ref:.1f} solves/s")
        aggregate_parity(f"{name} auto vs xla", res, ref, cold)

    # convex problems (hinge weights 0, no obstacles). The tight thrust
    # check runs on the convex case of tests/test_pallas_mpc.py (4
    # problems, N=8, 4 rounds). On thousands of problems two fp32
    # implementations part in the flat directions of a converged solve
    # (the fp32 cost, ~1e5, cannot resolve ~0.1 N of the last thrusts;
    # on the CPU the XLA path and the interpreted kernel part by 0.07 N
    # over 1024 such problems), so there the costs are checked and the
    # thrust gap is reported.
    convex = single._replace(
        ground_weight=0.0, velocity_bound_weight=0.0, tilt_weight=0.0,
        thrust_norm_weight=0.0,
    )
    small = convex._replace(prediction_horizon=8, max_iterations=4)
    rng = np.random.default_rng(SEED)
    for name, cfg, probc in (
        ("convex (4, N=8)", small, se3_mpc.make_problem(
            rng.normal(0, 2, (4, 3)).astype(np.float32) + [0, 0, 5],
            rng.normal(0, 1, (4, 3)).astype(np.float32),
            rng.normal(0, 3, (4, 3)).astype(np.float32) + [0, 0, 5],
            config=small,
        )),
        (f"convex ({N_BATCH}, N=20)", convex, random_obstacle_problem(
            convex, N_BATCH, np.random.default_rng(SEED), with_obstacles=False
        )),
    ):
        uc = se3_mpc.initialize_thrusts(cfg, probc)
        ref = se3_mpc.solve(cfg, probc, uc, use_obstacles=False, method="xla")
        res = se3_mpc.solve(cfg, probc, uc, use_obstacles=False, method="auto")
        du = float(np.max(np.abs(np.asarray(res.thrusts) - np.asarray(ref.thrusts))))
        dc = float(np.max(np.abs(np.asarray(res.cost) / np.asarray(ref.cost) - 1.0)))
        log(f"  {name}: max |thrust diff| {du:.3g} N, max cost rel diff {dc:.3g}")
        check(dc <= 1e-5, f"{name}: costs within rtol 1e-5 of xla")
        if cfg is small:
            check(du <= 2e-3, f"{name}: thrusts within 2e-3 of xla")

    # GPU XLA vs CPU XLA, single-phase (the tail pass picks its cohort
    # per batch and device). The whole batch: the ftol flag (1e-6, at the
    # resolution of an fp32 cost) flips for a few per cent of scenarios
    # between any two fp32 implementations, so a share over 256 moves by
    # a few points on its own. Unpinned products are caught exactly by
    # tests/test_precision_pins.py; this checks the GPU build end to end.
    out, err = cpu_child.communicate(timeout=900)
    if cpu_child.returncode != 0:
        raise RuntimeError(f"CPU reference failed:\n{err[-3000:]}")
    cpu = types.SimpleNamespace(**json.loads(out.strip().splitlines()[-1]))
    aggregate_parity("gpu xla vs cpu xla", xla["single-phase"], cpu, cold)


def phase_single_replan():
    from dart_planner_tpu.runtime import rt_executor
    from dart_planner_tpu.runtime.fast_path import PlannerFastPath, measure_latency

    make = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                          capture_output=True, text=True)
    log(f"  make -C native: rc {make.returncode}")
    loop = rt_executor.create_control_loop(frequency_hz=400.0)
    log(f"  control loop: {type(loop).__name__}"
        f" (native library {'loaded' if rt_executor.native_available() else 'missing'})")
    loop.set_gains(
        kp_pos=[7.0, 7.0, 8.5], ki_pos=[0.5] * 3, kd_pos=[4.0] * 3,
        kp_att=[10.0] * 3, ki_att=[0.1] * 3, kd_att=[1.0] * 3,
    )
    start, goal = np.array([0.0, 0.0, 3.0]), np.array([5.0, 3.0, 4.0])
    loop.start()
    try:
        for method in ("auto", "xla"):
            fp = PlannerFastPath(method=method)
            t0 = time.perf_counter()
            sp = fp.replan(start, np.zeros(3), goal)
            log(f"  setup fast path {method}: {time.perf_counter() - t0:.2f} s "
                "(compile + first replan)")
            check(bool(np.isfinite(sp).all()) and sp.shape == (13,),
                  f"{method}: finite (13,) setpoint")
            fp.reset()
            for _ in range(5):
                sp = fp.replan(start, np.zeros(3), goal)
            check(np.linalg.norm(sp[:3] - goal) < np.linalg.norm(start - goal),
                  f"{method}: planned setpoint moves toward the goal")
            rt = measure_latency(fp, loop, n_replans=100)
            log(f"  {method}: replan p50 {rt['planning_host_p50_ms']:.3f} ms, p95 "
                f"{rt['planning_host_p95_ms']:.3f} ms; control tick p95 "
                f"{rt['control_tick_p95_ms']:.4f} ms; planner->actuator p95 "
                f"{rt['planner_to_actuator_p95_ms']:.3f} ms")
    finally:
        loop.stop()
    check(rt["rt_loop_iterations"] > 0, "control loop ticked")
    cmd = loop.get_command()
    check(cmd is not None and bool(np.isfinite(cmd["thrust"])), "finite actuator command")


def phase_fleet():
    import jax

    from dart_planner_tpu.parallel import scenario
    from dart_planner_tpu.planning import se3_mpc
    from dart_planner_tpu.sim.scenarios import random_obstacle_problem

    config = se3_mpc.SE3MPCConfig()
    mesh = scenario.make_fleet_mesh(jax.devices()[:1], hosts=1)
    prob = scenario.shard_scenarios(
        random_obstacle_problem(config, N_FLEET, np.random.default_rng(SEED + 1)),
        mesh,
    )
    for method in ("xla", "auto"):
        (res, stats), t = timed(
            f"fleet 131072 {method}",
            lambda: scenario.solve_fleet(config, mesh, prob, method=method), 3,
        )
        log(f"  fleet {method}: {N_FLEET / t:.1f} solves/s; converged "
            f"{float(stats.converged) / N_FLEET:.4f}; mean cost "
            f"{float(stats.mean_cost):.6g}")
    hover = se3_mpc.initialize_thrusts(config, prob, mode="hover")
    hover_cost = float(np.mean(np.asarray(se3_mpc._finalize(config, prob, hover).cost)))
    check(int(stats.total) == N_FLEET, f"stats.total == {N_FLEET}")
    check(bool(np.isfinite(np.asarray(res.cost)).all()), "finite fleet costs")
    check(float(stats.mean_cost) < 0.9 * hover_cost,
          f"mean cost {float(stats.mean_cost):.6g} < 0.9 x hover cold start {hover_cost:.6g}")


def phase_closed_loop():
    import jax
    import jax.numpy as jnp

    from dart_planner_tpu.control import geometric
    from dart_planner_tpu.ops import costs
    from dart_planner_tpu.planning import se3_mpc
    from dart_planner_tpu.sim import closed_loop, physics
    from dart_planner_tpu.sim.scenarios import bench_monte_carlo

    setup = bench_monte_carlo(N_EPISODES, seed=SEED)

    def rates(r):
        return (float(jnp.mean(r.success)), float(jnp.mean(r.crashed)),
                float(jnp.mean(r.tracking_rmse)))

    # auto: solve kernel + tick kernel; "auto, scan ticks": the same
    # solve kernel with the lax.scan tick path, so the two tick paths
    # differ in nothing else; xla: the plain path (XLA solve + scan)
    runs, times = {}, {}
    for name, method, tick_kernel, reps in (
        ("auto", "auto", True, 3),
        ("auto, scan ticks", "auto", False, 3),
        ("xla", "xla", True, 1),
    ):
        res, times[name] = timed(
            f"closed loop {name}",
            lambda: closed_loop.simulate_episode(
                *setup.args, method=method, tick_kernel=tick_kernel, **setup.kwargs
            ),
            reps,
        )
        runs[name] = rates(res)
        s, c, rmse = runs[name]
        timeout = 1.0 - s - float(jnp.mean(res.crashed & ~res.success))
        log(f"  {name}: {N_EPISODES / times[name]:.1f} episodes/s; success {s:.4f} "
            f"crash {c:.4f} timeout {timeout:.4f} tracking rmse {rmse:.4f} m")
    log(f"  tick kernel vs scan under the solve kernel: {times['auto'] * 1e3:.3f} vs "
        f"{times['auto, scan ticks'] * 1e3:.3f} ms per {N_EPISODES} episodes")
    check(runs["auto"][0] >= 0.8, "success >= 0.8 (reference Monte-Carlo criterion)")
    for other in ("auto, scan ticks", "xla"):
        for i, what in ((0, "success"), (1, "crash")):
            d = abs(runs["auto"][i] - runs[other][i])
            check(d <= 0.005, f"{what} rate within 0.5 points of {other} ({d:.4f})")

    # noise-free 1 s obstacle-free batch: the tick kernel against the
    # scan. Each replan's plan (XLA solver, from the scan side's state)
    # drives both, so only the tick blocks differ: a solve from a state
    # that differs in the last bits can move ~0.1 N along the flat
    # directions of a converged plan, which is not what is tested here.
    cfg = setup.args[0]
    mpc = cfg.mpc
    states, goals = setup.args[2], setup.args[3]
    no_obs = dict(
        obstacles=jnp.zeros((mpc.max_obstacles, 4)),
        obstacle_mask=jnp.zeros((mpc.max_obstacles,), bool),
    )

    def fly():
        def block(carry, _):
            scan_side, kernel_side, u = carry
            prob = costs.Problem(
                p0=scan_side[0].position, v0=scan_side[0].velocity,
                goal=goals, **no_obs,
            )
            res = se3_mpc.solve(
                mpc, prob, se3_mpc.shift_warm_start(mpc, u),
                use_obstacles=False, method="xla",
            )
            sides = [
                closed_loop.tick_block(
                    cfg, use_kernel, False, *side, res, goals,
                    jnp.zeros(3),
                )[:3]
                for side, use_kernel in ((scan_side, False), (kernel_side, True))
            ]
            return (*sides, res.thrusts), None

        side0 = (
            physics.RigidBodyState.from_drone_state(states),
            geometric.ControllerState.zeros(
                cfg.control, batch_shape=(N_EPISODES,), dtype=jnp.float32
            ),
            states.timestamp,
        )
        u0 = se3_mpc.initialize_thrusts(mpc, costs.Problem(
            p0=states.position, v0=states.velocity, goal=goals, **no_obs
        ))
        (scan_side, kernel_side, _), _ = jax.lax.scan(
            block, (side0, side0, u0), jnp.arange(10)
        )
        return scan_side[0].position, kernel_side[0].position

    pos_scan, pos_kernel = (np.asarray(x) for x in jax.jit(fly)())
    dp = float(np.max(np.abs(pos_kernel - pos_scan)))
    check(dp <= 1e-3,
          f"noise-free 1 s: tick kernel final positions within 1e-3 m of the scan ({dp:.3g})")


def phase_four_cards():
    import jax

    from dart_planner_tpu.parallel import scenario
    from dart_planner_tpu.planning import se3_mpc
    from dart_planner_tpu.sim.scenarios import random_obstacle_problem

    devs = jax.devices()
    check(len(devs) >= 4, f"four devices visible ({len(devs)})")
    devs = devs[:4]
    mesh = scenario.make_fleet_mesh(devs, hosts=1)
    log(f"  mesh {dict(mesh.shape)} over {[d.id for d in devs]}")
    single = se3_mpc.SE3MPCConfig(tail_iterations=0)
    n = 4 * N_FLEET
    host_prob = random_obstacle_problem(single, n, np.random.default_rng(SEED + 2))
    prob = scenario.shard_scenarios(host_prob, mesh)
    # one cold start for both sides, so they differ only in the solve
    u0 = np.asarray(se3_mpc.initialize_thrusts(single, host_prob))
    u0_sharded = jax.device_put(u0, scenario.batch_sharding(mesh))
    (res, stats), t = timed(
        "4-card fleet single-phase",
        lambda: scenario.solve_fleet(single, mesh, prob, u0_sharded), 3,
    )
    log(f"  4 cards: {n / t:.1f} solves/s ({N_FLEET / t:.1f} per card)")
    placed = {s.device for s in res.thrusts.addressable_shards}
    shapes = {tuple(s.data.shape) for s in res.thrusts.addressable_shards}
    check(placed == set(devs), f"result shards on the four devices {sorted(d.id for d in placed)}")
    check(shapes == {(N_FLEET, single.prediction_horizon, 3)}, f"shard shapes {shapes}")

    # each shard solved alone on one card (the first), one after another
    thrusts = np.asarray(res.thrusts)
    worst = 0.0
    for i in range(len(devs)):
        sl = slice(i * N_FLEET, (i + 1) * N_FLEET)
        shard = jax.device_put(
            jax.tree_util.tree_map(lambda x: x[sl], host_prob), devs[0]
        )
        u0_shard = jax.device_put(u0[sl], devs[0])
        alone = se3_mpc.solve(single, shard, u0_shard)
        worst = max(worst, float(np.max(np.abs(np.asarray(alone.thrusts) - thrusts[sl]))))
    _, t1 = timed("one shard alone", lambda: se3_mpc.solve(single, shard, u0_shard), 3)
    log(f"  one card alone: {N_FLEET / t1:.1f} solves/s; 4-card weak-scaling "
        f"efficiency {t1 / t:.4f}")
    check(worst <= 1e-5, f"each shard matches its solve alone (max |du| {worst:.3g})")

    host = {
        "total": float(n),
        "converged": float(np.sum(np.asarray(res.converged), dtype=np.float64)),
        "mean_cost": float(np.mean(np.asarray(res.cost, np.float64))),
        "max_grad_norm": float(np.max(np.asarray(res.grad_norm))),
    }
    for k, v in host.items():
        got = float(getattr(stats, k))
        check(abs(got - v) <= 1e-6 * max(abs(v), 1.0),
              f"psum'd {k} {got:.9g} == host {v:.9g} (rel 1e-6)")

    ship = se3_mpc.SE3MPCConfig()
    (res2, stats2), t2 = timed(
        "4-card fleet two-phase",
        lambda: scenario.solve_fleet(ship, mesh, prob, u0_sharded), 3,
    )
    log(f"  4 cards two-phase: {n / t2:.1f} solves/s; converged "
        f"{float(stats2.converged) / n:.4f}")
    check(int(stats2.total) == n and bool(np.isfinite(float(stats2.mean_cost))),
          "two-phase stats total and finite mean cost")
    check(float(stats2.mean_cost) <= float(stats.mean_cost) * 1.0001,
          "two-phase mean cost <= single-phase")


def main() -> int:
    ap = argparse.ArgumentParser(description="SE(3) MPC main path on the GPU.")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded fleet over four GPUs")
    ap.add_argument("--cpu-reference", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return 0

    import jax

    t_start = time.perf_counter()
    with Phase("0 device"):
        devs = jax.devices()
        dev = devs[0]
        if dev.platform != "gpu":
            log(f"no GPU: JAX found {dev.platform!r}")
            return 2
        from dart_planner_tpu.common.compile_cache import setup_compile_cache

        log(f"  jax {jax.__version__}; {len(devs)} x {dev.device_kind}")
        log(f"  gpu: {gpu_name_and_power_limit()}")
        log(f"  compile cache: {setup_compile_cache()}")
    if args.four_cards:
        with Phase("5 four cards"):
            phase_four_cards()
        count = 4
    else:
        cpu_child = start_cpu_reference()
        try:
            with Phase("1 batched solve"):
                phase_batched(cpu_child)
        finally:
            if cpu_child.poll() is None:
                cpu_child.kill()
                cpu_child.wait()
        with Phase("2 single replan"):
            phase_single_replan()
        with Phase("3 fleet"):
            phase_fleet()
        with Phase("4 closed loop"):
            phase_closed_loop()
        count = 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"gpu: {gpu_name_and_power_limit()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

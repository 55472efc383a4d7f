"""Diagnose the quiet-failure (timeout) cohort (VERDICT r4, Weak #5).

The Monte-Carlo fleet at the shipping config reports ~0.97 success /
~0.005 crash; the remaining ~2.6% neither crash nor reach the goal
within the 6 s episode. This census answers, per the round-4 verdict:

  1. Who are they? (initial distance, closest approach, final distance,
     unknown-corridor exposure, obstacle clearance)
  2. Would they succeed with more time? (8 s / 10 s episode budgets —
     the cap-slowed hypothesis: 2 m/s through unknown space needs
     longer to cover the same corridor)
  3. Is the unknown-space cap causal? (same fleet, cap off)

Usage: python scripts/diag_timeouts.py [--episodes 2048]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def census(tag, res, d0, unk_any):
    import jax.numpy as jnp

    succ = np.asarray(res.success)
    crash = np.asarray(res.crashed)
    tout = ~succ & ~crash
    print(
        f"{tag}: success={succ.mean():.4f} crash={crash.mean():.4f} "
        f"timeout={tout.mean():.4f}"
    )
    if tout.any():
        fd = np.asarray(res.final_distance)[tout]
        md = np.asarray(res.min_distance)[tout]
        cl = np.asarray(res.min_obstacle_clearance)[tout]
        print(
            f"  timeouts: n={tout.sum()}  initial dist "
            f"p50={np.percentile(d0[tout], 50):.2f} "
            f"p90={np.percentile(d0[tout], 90):.2f} "
            f"(fleet p50={np.percentile(d0, 50):.2f})"
        )
        print(
            f"  final dist p50={np.percentile(fd, 50):.2f} "
            f"p90={np.percentile(fd, 90):.2f}  "
            f"closest approach p50={np.percentile(md, 50):.2f}  "
            f"near-goal (min_d<2m)={np.mean(md < 2.0):.3f}  "
            f"goal-touch (min_d<1m)={np.mean(md < 1.0):.3f}"
        )
        print(
            f"  unknown-corridor episodes={unk_any[tout].mean():.3f} "
            f"(fleet base rate {unk_any.mean():.3f})  "
            f"min clearance p10={np.percentile(cl, 10):.2f}"
        )
    return tout


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=2048)
    ap.add_argument("--method", type=str, default="auto")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from dart_planner_tpu.sim import ClosedLoopConfig, WorldConfig
    from dart_planner_tpu.sim import closed_loop, sample_worlds
    from dart_planner_tpu.sim.worlds import perceive_worlds

    from dart_planner_tpu.common.compile_cache import setup_compile_cache

    setup_compile_cache()
    print(f"platform={jax.devices()[0].platform} episodes={args.episodes}")

    wc = WorldConfig()
    n = args.episodes
    key = jax.random.PRNGKey(args.seed)
    start = jnp.asarray([0.0, 0.0, 3.0])
    goal = jnp.asarray([6.0, 3.0, 4.0])
    k_fleet, k_world = jax.random.split(key)
    ep_key, states, goals = closed_loop.sample_fleet(k_fleet, n, start, goal)
    tobs, tmask = sample_worlds(wc, k_world, n, states.position, goals)
    pobs, pmask, cov = perceive_worlds(
        wc, tobs, tmask, states.position, goals,
        max_obstacles=8, corridor_samples=wc.corridor_samples,
    )
    d0 = np.linalg.norm(
        np.asarray(states.position) - np.asarray(goals), axis=-1
    )
    base = ClosedLoopConfig(
        wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02, sense_radius=3.0,
        unknown_speed_cap=2.0,
    )
    unk_any = (np.asarray(cov) < base.unknown_coverage).any(axis=1)

    def run(cfg, use_cov=True):
        t0 = time.perf_counter()
        res = closed_loop.simulate_episode(
            cfg, ep_key, states, goals, obstacles=pobs, obstacle_mask=pmask,
            method=args.method, true_obstacles=tobs, true_obstacle_mask=tmask,
            corridor_observed=cov if use_cov else None,
        )
        jax.block_until_ready(res.final_distance)
        print(f"  ({time.perf_counter() - t0:.0f}s)")
        return res

    res6 = run(base)
    t6 = census("6s shipping (cap 2.0)", res6, d0, unk_any)

    res8 = run(base._replace(num_replans=80))
    t8 = census("8s shipping (cap 2.0)", res8, d0, unk_any)
    conv = t6 & np.asarray(res8.success)
    print(f"  6s-timeouts that SUCCEED at 8s: {conv.sum()}/{t6.sum()}")

    res10 = run(base._replace(num_replans=100))
    census("10s shipping (cap 2.0)", res10, d0, unk_any)
    conv10 = t6 & np.asarray(res10.success)
    print(f"  6s-timeouts that SUCCEED at 10s: {conv10.sum()}/{t6.sum()}")

    res0 = run(base._replace(unknown_speed_cap=0.0), use_cov=False)
    t0c = census("6s cap OFF", res0, d0, unk_any)
    both = t6 & t0c
    print(
        f"  timeout overlap cap-on/cap-off: {both.sum()} "
        f"(cap-on-only {np.sum(t6 & ~t0c)}, cap-off-only "
        f"{np.sum(~t6 & t0c)})"
    )


if __name__ == "__main__":
    main()

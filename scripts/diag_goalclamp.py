"""Sweep the goal-adjacent margin clamp (VERDICT r4 item 5 mitigation).

The clamp kills the goal-standoff timeout cohort but lets plans pass
closer to goal-blocking obstacles; this sweeps (clamp, floor) on the
2048-episode bench fleet and reports the success/crash trade, plus
whether the marginal crashes happen on margin-blocked-goal episodes.

Usage: python scripts/diag_goalclamp.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from dart_planner_tpu.common.compile_cache import setup_compile_cache

    setup_compile_cache()
    from dart_planner_tpu.sim import (ClosedLoopConfig, WorldConfig,
                                      closed_loop, sample_worlds)
    from dart_planner_tpu.sim.worlds import perceive_worlds

    wc = WorldConfig()
    n = 2048
    key = jax.random.PRNGKey(0)
    start = jnp.asarray([0.0, 0.0, 3.0])
    goal = jnp.asarray([6.0, 3.0, 4.0])
    k_fleet, k_world = jax.random.split(key)
    ep_key, states, goals = closed_loop.sample_fleet(k_fleet, n, start, goal)
    tobs, tmask = sample_worlds(wc, k_world, n, states.position, goals)
    pobs, pmask, cov = perceive_worlds(
        wc, tobs, tmask, states.position, goals,
        max_obstacles=8, corridor_samples=wc.corridor_samples,
    )
    g = np.asarray(goals)
    to, tm = np.asarray(tobs), np.asarray(tmask)
    d_surf = np.linalg.norm(g[:, None, :] - to[..., :3], axis=-1) - to[..., 3]
    d_surf = np.where(tm, d_surf, np.inf).min(axis=1)

    base = ClosedLoopConfig(
        wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02,
        sense_radius=3.0, unknown_speed_cap=2.0,
    )
    print(f"platform={jax.devices()[0].platform} episodes={n}")
    print(f"{'clamp':>6s} {'floor':>6s} {'success':>8s} {'crash':>7s} "
          f"{'timeout':>8s} {'crash@blocked':>13s} {'wall':>5s}")
    for clamp, floor in [(0.0, 0.1), (0.5, 0.1), (0.5, 0.3), (0.5, 0.45),
                         (0.3, 0.3), (0.7, 0.3)]:
        mpc = base.mpc._replace(goal_margin_clamp=clamp,
                                goal_margin_floor=floor)
        cfg = base._replace(mpc=mpc)
        blocked = d_surf < mpc.safety_margin
        t0 = time.perf_counter()
        res = closed_loop.simulate_episode(
            cfg, ep_key, states, goals, obstacles=pobs, obstacle_mask=pmask,
            method="auto", true_obstacles=tobs, true_obstacle_mask=tmask,
            corridor_observed=cov,
        )
        jax.block_until_ready(res.final_distance)
        succ = np.asarray(res.success)
        crash = np.asarray(res.crashed)
        print(f"{clamp:6.2f} {floor:6.2f} {succ.mean():8.4f} "
              f"{crash.mean():7.4f} {np.mean(~succ & ~crash):8.4f} "
              f"{crash[blocked].mean():13.4f} "
              f"{time.perf_counter() - t0:5.0f}", flush=True)


if __name__ == "__main__":
    main()

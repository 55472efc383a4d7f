"""Closed-loop plan->control->physics episodes as one jitted scan.

The reference runs its closed loop as Python processes exchanging ZMQ
messages at 10 Hz / 1 kHz (edge/main_improved.py:86-192) and its Monte
Carlo as 20 sequential seeded runs (tests/test_monte_carlo_sim.py). Here
one episode is a ``lax.scan`` over replan blocks — SE(3) MPC solve, then
an inner scan of geometric-controller ticks driving rigid-body physics —
and the Monte-Carlo fleet is a single ``vmap`` of that episode over
randomized starts, winds, and obstacle fields (BASELINE.json config 4).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from dart_planner_tpu.common.types import DroneState
from dart_planner_tpu.control import geometric
from dart_planner_tpu.ops import costs
from dart_planner_tpu.planning import se3_mpc
from dart_planner_tpu.sim import physics as phys

Array = jnp.ndarray


class ClosedLoopConfig(NamedTuple):
    """Static episode configuration."""

    # tail refinement off in-loop: a 10 Hz replanning loop absorbs the
    # per-solve convergence tail (the warm start carries progress across
    # replans), so the adaptive phase-2 pass would spend ~15% more solve
    # time for no measurable closed-loop quality gain. Per-solve API
    # consumers get it via the SE3MPCConfig default.
    # goal_margin_clamp on in-loop (0.5 m, floor 0.6): 94% of quiet
    # episode failures were goal-adjacent hover standoffs where an
    # obstacle's inflated margin ball swallowed the goal (success 0.815
    # margin-blocked vs 0.994 clear, scripts/diag_timeouts.py). With
    # the clamp: success 0.9688 -> 0.9937, timeout 0.0264 -> 0.0015,
    # crash unchanged at 0.0049 (scripts/diag_goalclamp.py sweep).
    mpc: se3_mpc.SE3MPCConfig = se3_mpc.SE3MPCConfig(
        tail_iterations=0, goal_margin_clamp=0.5
    )
    # thrust ceilings aligned with the planner's 25 N (the reference ships
    # mismatched defaults: planner 25 N, controller/sim 20 N)
    physics: phys.PhysicsConfig = phys.PhysicsConfig(max_thrust=25.0)
    control: geometric.GeometricConfig = geometric.GeometricConfig(
        mass=1.5, max_thrust=25.0
    )
    # 400 Hz control (reference rate): with saturated torque authority of
    # ~270 rad/s^2 the attitude loop limit-cycles at coarser control rates
    control_dt: float = 0.0025
    physics_substeps: int = 1  # integration substeps per control tick
    substeps_per_plan: int = 40  # -> replans at 10 Hz
    num_replans: int = 60  # 6 s episode
    goal_tolerance: float = 1.0  # m (test_monte_carlo_sim.py criterion)
    sensor_noise_std: float = 0.0  # m / m s^-1 position/velocity noise
    wind_mean: float = 0.0
    wind_std: float = 0.0
    min_altitude: float = 0.05  # below this = crash
    # in-flight proximity sensing: at every replan, TRUE spheres whose
    # surface is within this range of the vehicle join the planner's
    # obstacle set (dynamic mask over a static concat — jit-friendly).
    # Models the reference's continuous 10 Hz mapper refresh during
    # flight (cloud/main_improved_threelayer.py:206-209) / a short-range
    # depth sensor; the pre-episode scans model the long-range survey.
    # 0.0 disables (pre-episode perception only).
    sense_radius: float = 0.0
    # Unknown-space conservatism: cap planned speed while the vehicle is
    # near corridor regions the mapper never observed (the reference
    # surfaces unknown voxels as prior 0.5, EGM:154-169; the planner
    # here additionally *acts* on the signal). Requires the
    # ``corridor_observed`` argument of :func:`simulate_episode` (from
    # ``worlds.perceive_worlds(corridor_samples=...)``). The cap ramps
    # from ``unknown_speed_cap`` (fully inside/adjacent to unknown
    # space) back to ``mpc.max_velocity`` over ``unknown_ramp`` metres
    # beyond ``unknown_margin``. Rationale: dodging a sphere first seen
    # at sense_radius=3 m needs ~0.6 s (lateral ~1.3 m at ~13 m/s^2 +
    # a couple of 10 Hz replans), so speed through unscanned regions
    # must stay ~<= 4-5 m/s. 0.0 disables.
    # defaults tuned on the 2048-episode bench fleet (scripts/
    # diag_unknown.py): cap 2.0 / margin 1.5 / coverage 0.6 measures
    # success 0.9688, crash 0.0049 vs 0.9546 / 0.0107 uncapped
    unknown_speed_cap: float = 0.0
    unknown_coverage: float = 0.6  # observed fraction below = unknown
    unknown_margin: float = 1.5  # m: cap fully applies within this range
    unknown_ramp: float = 3.0  # m: cap -> max_velocity over this range
    # Endgame radius for the goal-adjacent margin clamp
    # (mpc.goal_margin_clamp): clamped margins apply only while the
    # vehicle is within this distance of the goal, so transit keeps the
    # full safety margin and the reduced clearance is only risked at
    # low terminal-approach speeds. Measured sweep: docs/quality.md.
    goal_clamp_radius: float = 3.0


class EpisodeResult(NamedTuple):
    final_position: Array  # (..., 3)
    final_distance: Array  # (...,)
    min_distance: Array  # (...,) closest approach to goal
    tracking_rmse: Array  # (...,) plan-vs-actual position RMSE
    min_obstacle_clearance: Array  # (...,) surface clearance to TRUE world
    crashed: Array  # (...,) bool (ground or obstacle strike)
    success: Array  # (...,) bool


@functools.partial(jax.jit, static_argnames=("config", "method", "tick_kernel"))
def simulate_episode(
    config: ClosedLoopConfig,
    key: Array,
    state0: DroneState,
    goal: Array,
    obstacles: Optional[Array] = None,
    obstacle_mask: Optional[Array] = None,
    method: str = "xla",
    true_obstacles: Optional[Array] = None,
    true_obstacle_mask: Optional[Array] = None,
    corridor_observed: Optional[Array] = None,
    tick_kernel: bool = True,
) -> EpisodeResult:
    """Closed-loop episode(s): natively batched over any leading dims of
    ``state0``/``goal`` (also composes with vmap when ``method="xla"``).
    ``method`` picks the MPC solver per replan (see
    :func:`se3_mpc.resolve_method`); ``"fused"`` (``"auto"`` on the GPU)
    and ``"interpret"`` also run each 400 Hz tick block as one fused
    Pallas kernel (``ops/pallas_rollout.py``) instead of a scan;
    ``tick_kernel=False`` keeps the scan with those solvers, so the two
    tick paths can be compared under one solver.

    ``obstacles`` is what the PLANNER sees (e.g. the mapper's perceived
    set; safety margin added here as ``make_problem`` does).
    ``true_obstacles`` is the world the plant can strike — defaults to
    the planner set without margin. Flying inside a true sphere marks
    the episode crashed (reference analog: the mapper feed,
    cloud/main_improved_threelayer.py:381-398, which only ever planned
    against perceived voxels).

    ``corridor_observed`` (..., M): per-episode observed-fraction
    profile along the start->goal corridor (from
    ``worlds.perceive_worlds(corridor_samples=M)``). With
    ``config.unknown_speed_cap`` > 0 the planner's per-scenario velocity
    cap (``Problem.v_cap``) tightens near unknown corridor samples —
    unknown space is no longer treated as free at full speed."""
    mpc = config.mpc
    dtype = state0.position.dtype
    batch_shape = state0.position.shape[:-1]
    method = se3_mpc.resolve_method(method)
    # the fused tick-block kernel handles the standard sim configuration
    # over a single batch axis; anything else runs the scan
    use_tick_kernel = (
        tick_kernel
        and method in ("fused", "interpret")
        and config.control.anti_windup_method == "clamping"
        and config.control.yaw_convention == "lee"
        and len(batch_shape) == 1
    )
    K = mpc.max_obstacles
    if obstacles is None:
        obstacles = jnp.zeros((K, 4), dtype)
        obstacle_mask = jnp.zeros((K,), bool)
    else:
        obstacles = jnp.asarray(obstacles, dtype)
        if obstacle_mask is None:
            obstacle_mask = jnp.ones(obstacles.shape[:-1], bool)
        if true_obstacles is None:
            # default TRUE world = the planner set, without safety margin
            true_obstacles, true_obstacle_mask = obstacles, obstacle_mask
    track_collisions = true_obstacles is not None
    if track_collisions:
        true_obstacles = jnp.asarray(true_obstacles, dtype)
        if true_obstacle_mask is None:
            true_obstacle_mask = jnp.ones(true_obstacles.shape[:-1], bool)
    # pre-add safety margin as make_problem does. With
    # mpc.goal_margin_clamp > 0 an ENDGAME variant is also built:
    # obstacles whose inflated ball would swallow the goal shrink
    # their ADDED margin so the success ring stays reachable — 94% of
    # quiet episode failures were margin-blocked-goal hover standoffs
    # (scripts/diag_timeouts.py). The clamped margins apply only while
    # the vehicle is within config.goal_clamp_radius of the goal
    # (selected per replan below): transit keeps the full margin, and
    # crash exposure is confined to the low-speed terminal approach.
    gate_clamp = mpc.goal_margin_clamp > 0.0

    def with_margins(obs, mask, clamped):
        cfg_m = mpc if clamped else mpc._replace(goal_margin_clamp=0.0)
        return obs.at[..., 3].add(
            jnp.where(
                mask, se3_mpc.effective_margins(cfg_m, obs, goal), 0.0
            )
        )

    obstacles_clamped = (
        with_margins(obstacles, obstacle_mask, True) if gate_clamp else None
    )
    obstacles = with_margins(obstacles, obstacle_mask, False)

    # in-flight proximity sensing: the planner's obstacle array is the
    # STATIC concat [perceived | true]; the true part's mask is computed
    # per replan from the vehicle's current distance (dynamic values,
    # fixed shapes). A sphere once sensed stays planned-against only
    # while in range — matching a live 10 Hz mapper refresh.
    use_sensing = config.sense_radius > 0.0 and track_collisions
    if use_sensing:
        def sensed_concat(obs_perceived, clamped):
            sensed = with_margins(
                true_obstacles, true_obstacle_mask, clamped
            )
            return jnp.concatenate(
                [
                    jnp.broadcast_to(
                        obs_perceived, batch_shape + obs_perceived.shape[-2:]
                    ),
                    jnp.broadcast_to(
                        sensed, batch_shape + sensed.shape[-2:]
                    ),
                ],
                axis=-2,
            )

        plan_obs = sensed_concat(obstacles, False)
        plan_obs_clamped = (
            sensed_concat(obstacles_clamped, True) if gate_clamp else None
        )
        perceived_mask_b = jnp.broadcast_to(
            obstacle_mask, batch_shape + obstacle_mask.shape[-1:]
        )

    # unknown-space speed cap: corridor sample points are derived from
    # the episode's own start/goal (the geometry perceive_worlds probed)
    use_vcap = (
        config.unknown_speed_cap > 0.0 and corridor_observed is not None
    )
    if use_vcap:
        M = corridor_observed.shape[-1]
        tgrid = jnp.linspace(0.0, 1.0, M, dtype=dtype)
        start0 = state0.position
        corr_pts = (
            start0[..., None, :]
            + tgrid[:, None] * (goal - start0)[..., None, :]
        )  # (..., M, 3)
        corr_unknown = corridor_observed < config.unknown_coverage

    k_wind, k_noise = jax.random.split(key)
    wind = phys.sample_wind(
        k_wind, batch_shape, config.wind_mean, config.wind_std, dtype
    )

    rb0 = phys.RigidBodyState.from_drone_state(state0)
    ctrl0 = geometric.ControllerState.zeros(
        config.control, batch_shape=batch_shape, dtype=dtype
    )
    u0 = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, mpc.hover_thrust], dtype),
        batch_shape + (mpc.prediction_horizon, 3),
    )

    n_sub = config.substeps_per_plan
    plan_span = mpc.dt * mpc.prediction_horizon

    def replan_block(carry, block_idx):
        rb, ctrl_state, u_warm, t = carry
        kb = jax.random.fold_in(k_noise, block_idx)
        noise = config.sensor_noise_std * jax.random.normal(
            kb, batch_shape + (6,), dtype
        )
        v_cap = None
        if use_vcap:
            # distance to the nearest UNKNOWN corridor sample; the cap
            # ramps from unknown_speed_cap (adjacent) to max_velocity
            # (unknown_margin + unknown_ramp away). inf-safe: with no
            # unknown samples the ramp clips to 1 -> cap = max_velocity.
            d = jnp.linalg.norm(
                rb.position[..., None, :] - corr_pts, axis=-1
            )  # (..., M)
            d_unk = jnp.min(
                jnp.where(corr_unknown, d, jnp.inf), axis=-1
            )
            ramp = jnp.clip(
                (d_unk - config.unknown_margin) / config.unknown_ramp,
                0.0,
                1.0,
            )
            v_cap = (
                config.unknown_speed_cap
                + (mpc.max_velocity - config.unknown_speed_cap) * ramp
            ).astype(dtype)
        def endgame_select(full, clamped):
            """Clamped margins only inside the endgame ball around the
            goal (per episode, per replan)."""
            if not gate_clamp:
                return full
            near = (
                jnp.linalg.norm(rb.position - goal, axis=-1)
                < config.goal_clamp_radius
            )
            return jnp.where(near[..., None, None], clamped, full)

        if use_sensing:
            gap = jnp.linalg.norm(
                rb.position[..., None, :] - true_obstacles[..., :3], axis=-1
            ) - true_obstacles[..., 3]
            sensed = true_obstacle_mask & (gap <= config.sense_radius)
            plan_mask = jnp.concatenate([perceived_mask_b, sensed], axis=-1)
            prob = costs.Problem(
                p0=rb.position + noise[..., :3],
                v0=rb.velocity + noise[..., 3:],
                goal=goal,
                obstacles=endgame_select(plan_obs, plan_obs_clamped),
                obstacle_mask=plan_mask,
                v_cap=v_cap,
            )
        else:
            prob = costs.Problem(
                p0=rb.position + noise[..., :3],
                v0=rb.velocity + noise[..., 3:],
                goal=goal,
                obstacles=endgame_select(obstacles, obstacles_clamped),
                obstacle_mask=obstacle_mask,
                v_cap=v_cap,
            )
        res = se3_mpc.solve(
            mpc, prob, se3_mpc.shift_warm_start(mpc, u_warm), method=method
        )

        rb, ctrl_state, t, metrics = tick_block(
            config, use_tick_kernel, method == "interpret", rb, ctrl_state,
            t, res, goal, wind, true_obstacles, true_obstacle_mask,
        )
        return (rb, ctrl_state, res.thrusts, t), metrics

    init = (rb0, ctrl0, u0, state0.timestamp.astype(dtype))
    (rb, _, _, _), (min_dists, terr_sums, min_alts, min_clears) = (
        jax.lax.scan(replan_block, init, jnp.arange(config.num_replans))
    )

    final_dist = jnp.linalg.norm(rb.position - goal, axis=-1)
    min_dist = jnp.minimum(jnp.min(min_dists, axis=0), final_dist)
    total_ticks = config.num_replans * n_sub
    rmse = jnp.sqrt(jnp.sum(terr_sums, axis=0) / total_ticks)
    min_clear = jnp.min(min_clears, axis=0)
    crashed = (jnp.min(min_alts, axis=0) < config.min_altitude) | (
        min_clear < 0.0
    )
    return EpisodeResult(
        final_position=rb.position,
        final_distance=final_dist,
        min_distance=min_dist,
        tracking_rmse=rmse,
        min_obstacle_clearance=min_clear,
        crashed=crashed,
        success=(final_dist < config.goal_tolerance) & ~crashed,
    )


def tick_block(
    config: ClosedLoopConfig,
    use_kernel: bool,
    interpret: bool,
    rb: phys.RigidBodyState,
    ctrl_state: geometric.ControllerState,
    t: Array,
    plan: se3_mpc.SolveResult,
    goal: Array,
    wind: Array,
    true_obstacles: Optional[Array] = None,
    true_obstacle_mask: Optional[Array] = None,
):
    """One replan block: ``config.substeps_per_plan`` 400 Hz ticks of the
    geometric controller tracking ``plan`` (linearly interpolated) and
    the rigid-body plant. ``use_kernel`` runs the block as one fused
    Pallas kernel (``ops/pallas_rollout.py``; ``interpret`` for the CPU
    tests), otherwise as a ``lax.scan`` over ticks. Returns ``(rb,
    ctrl_state, t, (min goal distance, summed squared tracking error,
    min altitude, min true-obstacle surface clearance))``, the clearance
    1e30 without ``true_obstacles``."""
    mpc = config.mpc
    dtype = rb.position.dtype
    n_sub = config.substeps_per_plan
    track_collisions = true_obstacles is not None
    if use_kernel:
        from dart_planner_tpu.ops import pallas_rollout

        S = pallas_rollout.pack_state(rb, ctrl_state)
        spp, spv, spa = pallas_rollout.setpoints_from_plan(
            plan.positions, plan.velocities, plan.accelerations,
            n_sub, config.control_dt, mpc.dt,
        )
        B = S.shape[1]
        gw = jnp.concatenate(
            [
                jnp.broadcast_to(goal, (B, 3)).T,
                jnp.broadcast_to(wind, (B, 3)).T,
                jnp.zeros((2, B), dtype),
            ],
            axis=0,
        )
        obs_rows = None
        if track_collisions:
            tobs = jnp.broadcast_to(
                true_obstacles, (B,) + true_obstacles.shape[-2:]
            )
            tmask = jnp.broadcast_to(true_obstacle_mask, tobs.shape[:-1])
            obs_rows = pallas_rollout.pack_obstacles(tobs, tmask).astype(dtype)
        S2, acc = pallas_rollout.run_tick_block(
            config.control, config.physics, config.control_dt,
            n_sub, config.physics_substeps,
            S, spp, spv, spa, gw, obs_rows, interpret=interpret,
        )
        rb2, cs2 = pallas_rollout.unpack_state(S2, rb, ctrl_state)
        return rb2, cs2, t + n_sub * config.control_dt, (
            acc[0], acc[1], acc[2], acc[3],
        )

    def control_tick(carry2, sub_idx):
        rb2, cs2, t2 = carry2
        tau = (sub_idx.astype(dtype) + 1.0) * config.control_dt
        # linear interpolation of the plan at time tau
        x = jnp.clip(tau / mpc.dt, 0.0, mpc.prediction_horizon - 1.001)
        i0 = jnp.floor(x).astype(jnp.int32)
        frac = x - i0.astype(dtype)

        def lerp(arr):
            # index the horizon axis (second-to-last): works unbatched
            # and with leading episode dims alike
            lo = arr[..., i0, :]
            hi = arr[..., i0 + 1, :]
            return lo + frac * (hi - lo)

        sp = geometric.ControlSetpoint(
            position=lerp(plan.positions),
            velocity=lerp(plan.velocities),
            acceleration=lerp(plan.accelerations),
            yaw=jnp.zeros((), dtype),
            yaw_rate=jnp.zeros((), dtype),
        )
        ds = rb2.to_drone_state(t2)
        cmd, cs3 = geometric.compute_control(
            config.control, cs2, ds, sp, config.control_dt
        )
        # sub-step the plant: the attitude loop is fast (~21 rad/s at
        # hardware.yaml inertia); one Euler step per control tick is
        # numerically unstable
        h = config.control_dt / config.physics_substeps
        rb3 = rb2
        for _ in range(config.physics_substeps):
            rb3 = phys.rigid_body_step(config.physics, rb3, cmd, h, wind)
        dist = jnp.linalg.norm(rb3.position - goal, axis=-1)
        track_err = jnp.sum((rb3.position - sp.position) ** 2, axis=-1)
        if track_collisions:
            diff = rb3.position[..., None, :] - true_obstacles[..., :3]
            clear_k = jnp.linalg.norm(diff, axis=-1) - true_obstacles[..., 3]
            clear = jnp.min(
                jnp.where(true_obstacle_mask, clear_k, jnp.inf), axis=-1
            )
        else:
            clear = jnp.full(dist.shape, 1e30, dtype)
        return (rb3, cs3, t2 + config.control_dt), (
            dist, track_err, rb3.position[..., 2], clear,
        )

    (rb, ctrl_state, t), (dists, terrs, alts, clears) = jax.lax.scan(
        control_tick, (rb, ctrl_state, t), jnp.arange(n_sub)
    )
    return rb, ctrl_state, t, (
        jnp.min(dists, axis=0),
        jnp.sum(terrs, axis=0),
        jnp.min(alts, axis=0),
        jnp.min(clears, axis=0),
    )


@functools.partial(jax.jit, static_argnames=("num_episodes",))
def sample_fleet(
    key: Array,
    num_episodes: int,
    start_center: Array,
    goal_center: Array,
    start_spread: float = 2.0,
    goal_spread: float = 2.0,
) -> tuple[Array, DroneState, Array]:
    """Randomized fleet initial conditions: (episode_key, states, goals).

    Exposed so world randomization (sim.worlds) can place obstacle fields
    on the *actual* per-episode start->goal corridors."""
    dtype = jnp.asarray(start_center).dtype
    keys = jax.random.split(key, 3)
    ep_key, k_start, k_goal = keys[0], keys[1], keys[2]
    starts = start_center + start_spread * jax.random.normal(
        k_start, (num_episodes, 3), dtype
    )
    starts = starts.at[:, 2].set(jnp.maximum(starts[:, 2], 1.0))
    goals = goal_center + goal_spread * jax.random.normal(
        k_goal, (num_episodes, 3), dtype
    )
    goals = goals.at[:, 2].set(jnp.maximum(goals[:, 2], 1.0))
    states = DroneState.create(
        timestamp=jnp.zeros(num_episodes, dtype),
        position=starts,
        velocity=jnp.zeros((num_episodes, 3), dtype),
        attitude=jnp.zeros((num_episodes, 3), dtype),
        angular_velocity=jnp.zeros((num_episodes, 3), dtype),
    )
    return ep_key, states, goals


@functools.partial(
    jax.jit, static_argnames=("config", "num_episodes", "method")
)
def monte_carlo(
    config: ClosedLoopConfig,
    key: Array,
    num_episodes: int,
    start_center: Array,
    goal_center: Array,
    start_spread: float = 2.0,
    goal_spread: float = 2.0,
    obstacles: Optional[Array] = None,
    obstacle_mask: Optional[Array] = None,
    method: str = "auto",
    true_obstacles: Optional[Array] = None,
    true_obstacle_mask: Optional[Array] = None,
) -> EpisodeResult:
    """Randomized fleet as ONE natively-batched episode call (reference
    test_monte_carlo_sim.py: 20 seeded runs, >=80%% goal-reach; here the
    whole fleet is one executable and scales to thousands of episodes per
    device)."""
    ep_key, states, goals = sample_fleet(
        key, num_episodes, start_center, goal_center, start_spread,
        goal_spread,
    )
    return simulate_episode(
        config, ep_key, states, goals, obstacles, obstacle_mask,
        method=method, true_obstacles=true_obstacles,
        true_obstacle_mask=true_obstacle_mask,
    )

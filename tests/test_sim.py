"""Physics + closed-loop Monte Carlo tests (reference
test_monte_carlo_sim.py / drone_simulator semantics)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dart_planner_tpu.common.types import ControlCommand, DroneState
from dart_planner_tpu.control import geometric
from dart_planner_tpu.planning import se3_mpc
from dart_planner_tpu.sim import (
    ClosedLoopConfig,
    PhysicsConfig,
    RigidBodyState,
    monte_carlo,
    point_mass_step,
    rigid_body_step,
    simulate_episode,
)

FAST = ClosedLoopConfig(
    mpc=se3_mpc.SE3MPCConfig(prediction_horizon=10, max_iterations=6),
    num_replans=40,
)


def test_point_mass_hover():
    cfg = PhysicsConfig()
    s = DroneState.create(position=(0.0, 0.0, 5.0))
    cmd = ControlCommand(
        thrust=jnp.asarray(cfg.mass * cfg.gravity), torque=jnp.zeros(3)
    )
    for _ in range(100):
        s = point_mass_step(cfg, s, cmd, 0.01)
    np.testing.assert_allclose(np.asarray(s.position), [0, 0, 5], atol=1e-4)
    assert np.isclose(float(s.timestamp), 1.0, atol=1e-5)


def test_point_mass_freefall():
    cfg = PhysicsConfig()
    s = DroneState.create(position=(0.0, 0.0, 100.0))
    cmd = ControlCommand(thrust=jnp.asarray(0.0), torque=jnp.zeros(3))
    for _ in range(100):
        s = point_mass_step(cfg, s, cmd, 0.01)
    # ~ -g t^2 / 2 = -4.905 m after 1 s (semi-implicit slightly more)
    assert -5.1 < float(s.position[2]) - 100.0 < -4.8


def test_rigid_body_rotation_consistency():
    cfg = PhysicsConfig()
    rb = RigidBodyState.from_drone_state(DroneState.create(position=(0, 0, 5)))
    cmd = ControlCommand(
        thrust=jnp.asarray(cfg.mass * cfg.gravity),
        torque=jnp.asarray([0.0, 0.0, 0.2]),
    )
    for _ in range(50):
        rb = rigid_body_step(cfg, rb, cmd, 0.01)
    R = np.asarray(rb.rotation)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)  # stays SO(3)
    assert float(rb.angular_velocity[2]) > 0.4  # yaw spun up


def test_episode_reaches_goal():
    key = jax.random.PRNGKey(0)
    s0 = DroneState.create(position=(0.0, 0.0, 3.0))
    goal = jnp.asarray([4.0, 2.0, 5.0])
    r = simulate_episode(FAST, key, s0, goal)
    assert bool(r.success), (
        float(r.final_distance),
        np.asarray(r.final_position),
    )
    assert float(r.tracking_rmse) < 1.0
    assert not bool(r.crashed)


def test_episode_with_wind_noise():
    cfg = FAST._replace(wind_mean=1.0, wind_std=0.5, sensor_noise_std=0.02)
    key = jax.random.PRNGKey(1)
    s0 = DroneState.create(position=(0.0, 0.0, 3.0))
    goal = jnp.asarray([4.0, 2.0, 5.0])
    r = simulate_episode(cfg, key, s0, goal)
    assert float(r.final_distance) < 2.0
    assert not bool(r.crashed)


@pytest.mark.slow
def test_monte_carlo_success_rate():
    """Reference criterion: >=80% goal reach over randomized episodes
    (test_monte_carlo_sim.py:75-81, xfail there; required to pass here)."""
    cfg = FAST._replace(
        wind_mean=0.5, wind_std=0.3, sensor_noise_std=0.01, num_replans=80
    )
    res = monte_carlo(
        cfg,
        jax.random.PRNGKey(2),
        num_episodes=16,
        start_center=jnp.asarray([0.0, 0.0, 3.0]),
        goal_center=jnp.asarray([4.0, 0.0, 5.0]),
        start_spread=1.0,
        goal_spread=1.0,
    )
    rate = float(jnp.mean(res.success))
    assert rate >= 0.8, rate


def test_episode_avoids_obstacle():
    key = jax.random.PRNGKey(3)
    s0 = DroneState.create(position=(0.0, 0.0, 3.0))
    goal = jnp.asarray([6.0, 0.0, 3.0])
    obstacles = jnp.asarray([[3.0, 0.0, 3.0, 0.5]])
    r = simulate_episode(FAST, key, s0, goal, obstacles)
    assert float(r.final_distance) < 1.5
    assert not bool(r.crashed)


def test_batched_episodes_match_vmapped():
    """Natively-batched episodes must equal vmapped per-episode runs in
    the noise-free default config (same deterministic dynamics)."""
    import jax

    # tail refinement must be OFF here: its compaction selects the
    # worst ceil(tail_capacity * B) scenarios PER BATCH, so a batched
    # run refines a different cohort than B independent single-scenario
    # runs — adaptive phase 2 deliberately trades this invariance for
    # tail quality (ClosedLoopConfig ships with it off in-loop).
    config = ClosedLoopConfig(
        mpc=se3_mpc.SE3MPCConfig(
            prediction_horizon=8, max_iterations=4, tail_iterations=0
        ),
        num_replans=5,
    )
    B = 4
    rng = np.random.default_rng(0)
    starts = jnp.asarray(rng.normal(0, 1, (B, 3)) + [0, 0, 4], jnp.float32)
    goals = jnp.asarray(rng.normal(0, 2, (B, 3)) + [0, 0, 4], jnp.float32)
    states = DroneState.create(
        timestamp=jnp.zeros(B),
        position=starts,
        velocity=jnp.zeros((B, 3)),
        attitude=jnp.zeros((B, 3)),
        angular_velocity=jnp.zeros((B, 3)),
    )
    key = jax.random.PRNGKey(1)
    batched = simulate_episode(config, key, states, goals)
    single = jax.vmap(
        lambda s, g: simulate_episode(config, key, s, g)
    )(states, goals)
    np.testing.assert_allclose(
        np.asarray(batched.final_position),
        np.asarray(single.final_position),
        atol=5e-4,
    )
    np.testing.assert_allclose(
        np.asarray(batched.tracking_rmse),
        np.asarray(single.tracking_rmse),
        atol=1e-3,
    )


def test_fused_tick_kernel_matches_scan():
    """The fused Pallas tick-block kernel (ops/pallas_rollout.py) must
    reproduce the scan path's controller+plant chain (Pallas interpret
    mode on the CPU; chip_smoke.py compares the compiled kernel on the
    GPU)."""
    import jax

    config = ClosedLoopConfig(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=3),
        num_replans=4,
    )
    B = 3
    rng = np.random.default_rng(0)
    states = DroneState.create(
        timestamp=jnp.zeros(B),
        position=jnp.asarray(rng.normal(0, 1, (B, 3)) + [0, 0, 4], jnp.float32),
        velocity=jnp.zeros((B, 3)),
        attitude=jnp.zeros((B, 3)),
        angular_velocity=jnp.zeros((B, 3)),
    )
    goals = jnp.asarray(rng.normal(0, 2, (B, 3)) + [0, 0, 4], jnp.float32)
    key = jax.random.PRNGKey(0)
    r_scan = simulate_episode(config, key, states, goals, method="xla")
    r_fused = simulate_episode(config, key, states, goals, method="interpret")
    np.testing.assert_allclose(
        np.asarray(r_fused.final_position),
        np.asarray(r_scan.final_position),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(r_fused.tracking_rmse),
        np.asarray(r_scan.tracking_rmse),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(r_fused.min_distance),
        np.asarray(r_scan.min_distance),
        atol=1e-4,
    )


def test_tick_kernel_switch_keeps_the_solver():
    """``tick_kernel=False`` swaps only the tick blocks: under one
    (interpreted) kernel solver the scan and the tick kernel agree."""
    import jax

    config = ClosedLoopConfig(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=3),
        num_replans=3,
    )
    B = 2
    states = DroneState.create(
        timestamp=jnp.zeros(B),
        position=jnp.asarray([[0, 0, 3.0], [1, -1, 4.0]], jnp.float32),
        velocity=jnp.zeros((B, 3)),
        attitude=jnp.zeros((B, 3)),
        angular_velocity=jnp.zeros((B, 3)),
    )
    goals = jnp.asarray([[3.0, 1.0, 3.5], [2.0, 2.0, 3.0]], jnp.float32)
    key = jax.random.PRNGKey(1)
    r_kernel = simulate_episode(config, key, states, goals, method="interpret")
    r_scan = simulate_episode(
        config, key, states, goals, method="interpret", tick_kernel=False
    )
    np.testing.assert_allclose(
        np.asarray(r_kernel.final_position),
        np.asarray(r_scan.final_position),
        atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(r_kernel.tracking_rmse),
        np.asarray(r_scan.tracking_rmse),
        atol=1e-4,
    )


def test_fused_tick_kernel_failsafe_branch_parity():
    """Force the failsafe branch (huge tracking error) and check the
    kernel matches the scan path through count-up, latch, and zeroed
    torque dynamics."""
    import jax

    config = ClosedLoopConfig(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=2),
        control=geometric.GeometricConfig(
            mass=1.5, max_thrust=25.0, failsafe_trigger_count=10
        ),
        num_replans=3,
    )
    B = 2
    # start 60 m from any plannable goal with high speed: bad tracking
    states = DroneState.create(
        timestamp=jnp.zeros(B),
        position=jnp.asarray([[60.0, 0, 30.0], [0, 60.0, 30.0]], jnp.float32),
        velocity=jnp.asarray([[-8.0, 0, 0], [0, -8.0, 0]], jnp.float32),
        attitude=jnp.zeros((B, 3)),
        angular_velocity=jnp.zeros((B, 3)),
    )
    goals = jnp.asarray([[0, 0, 3.0], [0, 0, 3.0]], jnp.float32)
    key = jax.random.PRNGKey(0)
    r_scan = simulate_episode(config, key, states, goals, method="xla")
    r_fused = simulate_episode(config, key, states, goals, method="interpret")
    np.testing.assert_allclose(
        np.asarray(r_fused.final_position),
        np.asarray(r_scan.final_position),
        rtol=1e-4, atol=1e-3,
    )


def test_fused_tick_kernel_substeps_and_horizon_parity():
    """Kernel parity must hold with physics substeps > 1 and a different
    horizon/replan-rate combination (exercises the static lerp matrix)."""
    import jax

    config = ClosedLoopConfig(
        mpc=se3_mpc.SE3MPCConfig(
            prediction_horizon=12, dt=0.08, max_iterations=3
        ),
        physics_substeps=2,
        substeps_per_plan=25,
        num_replans=3,
    )
    B = 2
    states = DroneState.create(
        timestamp=jnp.zeros(B),
        position=jnp.asarray([[0, 0, 3.0], [1, -1, 4.0]], jnp.float32),
        velocity=jnp.asarray([[0.5, 0, 0], [0, 0.5, 0]], jnp.float32),
        attitude=jnp.zeros((B, 3)),
        angular_velocity=jnp.zeros((B, 3)),
    )
    goals = jnp.asarray([[3.0, 1.0, 3.5], [2.0, 2.0, 3.0]], jnp.float32)
    key = jax.random.PRNGKey(2)
    r_scan = simulate_episode(config, key, states, goals, method="xla")
    r_fused = simulate_episode(config, key, states, goals, method="interpret")
    np.testing.assert_allclose(
        np.asarray(r_fused.final_position),
        np.asarray(r_scan.final_position),
        atol=1e-4,
    )


def test_proximity_sensing_reveals_blind_obstacle():
    """In-flight sensing (ClosedLoopConfig.sense_radius): a TRUE sphere
    the pre-episode perception completely missed joins the planner's
    obstacle set once the vehicle gets within range, and the flown path
    keeps materially more surface clearance than the blind flight.
    Models the reference's 10 Hz in-flight mapper refresh
    (/root/reference/src/dart_planner/cloud/main_improved_threelayer.py:
    206-209)."""
    cfg = ClosedLoopConfig(
        mpc=se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=6),
        substeps_per_plan=40,
        num_replans=30,
        sense_radius=3.0,
    )
    B = 2
    st = DroneState.create(
        timestamp=jnp.zeros(B),
        position=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 3.0]), (B, 3)),
        velocity=jnp.zeros((B, 3)),
        attitude=jnp.zeros((B, 3)),
        angular_velocity=jnp.zeros((B, 3)),
    )
    goals = jnp.broadcast_to(jnp.asarray([6.0, 0.0, 3.0]), (B, 3))
    # perceived set EMPTY; one true sphere dead on the corridor
    pobs = jnp.zeros((B, 2, 4), jnp.float32)
    pmask = jnp.zeros((B, 2), bool)
    tobs = jnp.broadcast_to(jnp.asarray([[3.0, 0.0, 3.0, 0.6]]), (B, 1, 4))
    tmask = jnp.ones((B, 1), bool)
    key = jax.random.PRNGKey(0)
    kw = dict(obstacles=pobs, obstacle_mask=pmask, method="xla",
              true_obstacles=tobs, true_obstacle_mask=tmask)
    r_sense = simulate_episode(cfg, key, st, goals, **kw)
    r_blind = simulate_episode(cfg._replace(sense_radius=0.0), key, st,
                               goals, **kw)
    clear_s = float(np.asarray(r_sense.min_obstacle_clearance)[0])
    clear_b = float(np.asarray(r_blind.min_obstacle_clearance)[0])
    assert not bool(np.asarray(r_sense.crashed)[0])
    # sensed flight clears the sphere by a real margin; blind flight
    # skims it (measured: 0.98 m vs 0.47 m)
    assert clear_s > 0.75
    assert clear_s > clear_b + 0.3


def test_unknown_speed_cap_slows_through_unknown_region():
    """Unknown-space conservatism (ClosedLoopConfig.unknown_speed_cap):
    with the corridor coverage profile reporting unobserved space, the
    planner's per-scenario velocity cap binds and the vehicle covers
    materially less ground in fixed time; a fully-observed corridor is
    bit-identical to the uncapped flight (the cap ramps to max_velocity
    away from unknown samples). The planner-side answer to the
    reference's unknown-voxel prior-0.5 signal (EGM:154-169)."""
    B = 2
    st = DroneState.create(
        timestamp=jnp.zeros(B),
        position=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 3.0]), (B, 3)),
        velocity=jnp.zeros((B, 3)),
        attitude=jnp.zeros((B, 3)),
        angular_velocity=jnp.zeros((B, 3)),
    )
    goals = jnp.broadcast_to(jnp.asarray([20.0, 0.0, 3.0]), (B, 3))
    cfg = ClosedLoopConfig(
        mpc=se3_mpc.SE3MPCConfig(
            prediction_horizon=8, max_iterations=6, tail_iterations=0
        ),
        substeps_per_plan=40,
        num_replans=15,
    )
    key = jax.random.PRNGKey(0)
    cov_unknown = jnp.zeros((B, 12), jnp.float32)  # nothing ever observed
    cov_known = jnp.ones((B, 12), jnp.float32)  # fully scanned corridor
    r_fast = simulate_episode(cfg, key, st, goals)
    capped = cfg._replace(unknown_speed_cap=3.0)
    r_slow = simulate_episode(
        capped, key, st, goals, corridor_observed=cov_unknown
    )
    r_same = simulate_episode(
        capped, key, st, goals, corridor_observed=cov_known
    )
    d_fast = float(np.asarray(r_fast.final_distance)[0])
    d_slow = float(np.asarray(r_slow.final_distance)[0])
    # capped flight through unknown space covers materially less ground
    # in the same 1.5 s (measured: 13.7 m vs 11.3 m remaining)
    assert d_slow > d_fast + 1.0
    # fully-observed corridor: the cap never binds — identical flight
    np.testing.assert_array_equal(
        np.asarray(r_same.final_position), np.asarray(r_fast.final_position)
    )

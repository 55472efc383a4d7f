"""Per-episode obstacle worlds + mapper perception + collision tracking
(BASELINE config 4: randomized starts, wind, obstacle fields from the
explicit mapper; reference mapper feed
cloud/main_improved_threelayer.py:381-398)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dart_planner_tpu.planning import se3_mpc
from dart_planner_tpu.sim import (
    ClosedLoopConfig,
    WorldConfig,
    monte_carlo,
    perceive_worlds,
    sample_worlds,
    simulate_episode,
)

START = jnp.asarray([0.0, 0.0, 3.0], jnp.float32)
GOAL = jnp.asarray([6.0, 3.0, 4.0], jnp.float32)
FAST = ClosedLoopConfig(
    mpc=se3_mpc.SE3MPCConfig(
        prediction_horizon=8, max_iterations=4, cg_iterations=8
    ),
    substeps_per_plan=20,
    num_replans=12,
)


def test_sample_worlds_geometry():
    wc = WorldConfig()
    obs, mask = sample_worlds(wc, jax.random.PRNGKey(1), 64, START, GOAL)
    assert obs.shape == (64, wc.num_obstacles, 4)
    assert bool(mask.all())
    r = np.asarray(obs[..., 3])
    assert (r >= wc.radius_min - 1e-6).all() and (r <= wc.radius_max + 1e-6).all()
    # keepout: no sphere surface inside the start/goal balls
    for anchor in (START, GOAL):
        gap = np.linalg.norm(
            np.asarray(obs[..., :3]) - np.asarray(anchor), axis=-1
        ) - r
        assert (gap > wc.keepout - wc.radius_max - 1e-5).all()
    assert (np.asarray(obs[..., 2]) >= 0.5 - 1e-6).all()  # above ground


def test_perceive_worlds_sees_spheres():
    """The mapper pipeline must perceive voxels near every true sphere
    that intersects a scan plane."""
    wc = WorldConfig(perceive_chunk=4)
    n = 8
    tobs, tmask = sample_worlds(wc, jax.random.PRNGKey(2), n, START, GOAL)
    pobs, pmask = perceive_worlds(wc, tobs, tmask, START, GOAL, max_obstacles=8)
    assert pobs.shape == (n, 8, 4) and pmask.shape == (n, 8)
    assert int(pmask.sum()) > 0
    # every perceived voxel-sphere center lies within one voxel diagonal
    # of some true sphere surface (no hallucinated obstacles)
    res = wc.mapper.resolution
    centers = np.asarray(pobs[..., :3])  # (n, 8, 3)
    dist_true = np.linalg.norm(
        centers[:, :, None, :] - np.asarray(tobs[..., None, :, :3])[:, None, :, :].squeeze(1),
        axis=-1,
    ) - np.asarray(tobs[..., 3])[:, None, :]
    near_any = (np.abs(dist_true) < 2.0 * res).any(axis=-1)
    assert near_any[np.asarray(pmask)].all()


def test_head_on_collision_is_crash():
    """A sphere dead on the corridor that the planner cannot see must
    produce a collision crash (min clearance < 0)."""
    key = jax.random.PRNGKey(0)
    from dart_planner_tpu.common.types import DroneState

    s0 = DroneState.create(position=(0.0, 0.0, 3.0))
    goal = jnp.asarray([6.0, 0.0, 3.0])
    wall = jnp.asarray([[3.0, 0.0, 3.0, 1.2]])  # big sphere on the line
    cfg = FAST._replace(num_replans=40)
    r = simulate_episode(
        cfg, key, s0, goal,
        true_obstacles=wall,  # planner is blind: no `obstacles` given
        method="xla",
    )
    assert float(r.min_obstacle_clearance) < 0.0
    assert bool(r.crashed)
    assert not bool(r.success)


def test_planner_avoids_perceived_sphere():
    """Same world, but the planner SEES the sphere: clearance stays
    positive."""
    key = jax.random.PRNGKey(0)
    from dart_planner_tpu.common.types import DroneState

    s0 = DroneState.create(position=(0.0, 0.0, 3.0))
    goal = jnp.asarray([6.0, 0.0, 3.0])
    wall = jnp.asarray([[3.0, 0.0, 3.0, 1.2]])
    cfg = FAST._replace(num_replans=40)
    r = simulate_episode(
        cfg, key, s0, goal, obstacles=wall, method="xla"
    )
    assert float(r.min_obstacle_clearance) > 0.0
    assert not bool(r.crashed)


def test_clearance_parity_scan_vs_kernel():
    """Scan path and fused tick kernel agree on min clearance (CPU
    interpreter)."""
    wc = WorldConfig(perceive_chunk=4)
    n = 4
    key = jax.random.PRNGKey(3)
    tobs, tmask = sample_worlds(wc, key, n, START, GOAL)
    r1 = monte_carlo(
        FAST, key, n, START, GOAL, obstacles=tobs, obstacle_mask=tmask,
        method="xla",
    )
    r2 = monte_carlo(
        FAST, key, n, START, GOAL, obstacles=tobs, obstacle_mask=tmask,
        method="interpret",
    )
    np.testing.assert_allclose(
        np.asarray(r1.min_obstacle_clearance),
        np.asarray(r2.min_obstacle_clearance),
        atol=5e-2,
    )
    np.testing.assert_allclose(
        np.asarray(r1.final_position), np.asarray(r2.final_position),
        atol=5e-2,
    )


def test_no_obstacles_reports_inf_clearance():
    key = jax.random.PRNGKey(0)
    r = monte_carlo(FAST, key, 2, START, GOAL, method="xla")
    assert float(jnp.min(r.min_obstacle_clearance)) > 1e29


def test_corridor_coverage_pipeline_and_speed_cap():
    """perceive_worlds(corridor_samples=M) emits a sane coverage profile
    (scanned corridors mostly observed; values in [0,1]) and the full
    monte_carlo_with_worlds pipeline runs with the unknown-space speed
    cap enabled — unknown-adjacent episodes plan under a tightened
    per-scenario velocity cap (Problem.v_cap), everything else is
    bit-compatible plumbing."""
    from dart_planner_tpu.sim.worlds import monte_carlo_with_worlds

    wc = WorldConfig(perceive_chunk=4, corridor_samples=12)
    n = 4
    key = jax.random.PRNGKey(5)
    tobs, tmask = sample_worlds(wc, key, n, START, GOAL)
    pobs, pmask, cov = perceive_worlds(
        wc, tobs, tmask, START, GOAL, max_obstacles=8, corridor_samples=12
    )
    cov = np.asarray(cov)
    assert cov.shape == (n, 12)
    assert (cov >= 0.0).all() and (cov <= 1.0).all()
    # the scan walk covers the corridor: its average coverage is real
    assert cov.mean() > 0.3

    capped = FAST._replace(unknown_speed_cap=2.0)
    res, _, _ = monte_carlo_with_worlds(
        capped, wc, key, n, START, GOAL, method="xla"
    )
    assert np.isfinite(np.asarray(res.final_distance)).all()
    assert np.asarray(res.tracking_rmse).max() < 1.0

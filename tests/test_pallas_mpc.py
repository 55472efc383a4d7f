"""Fused Pallas solver vs the pure-XLA solver (Pallas interpret mode).

The fused kernel (ops/pallas_mpc.py) must run the identical algorithm as
planning.se3_mpc.solve_se3_mpc. On convex problem instances (no hinge
penalties active) the two must agree to float32 tolerance; on hard
obstacle-dense instances individual unconverged scenarios may branch at
line-search near-ties, so the contract is aggregate solution quality.
"""

import numpy as np
import pytest

from dart_planner_tpu.planning import se3_mpc

# fast configuration for the interpreter (the full config runs compiled
# on the GPU in chip_smoke.py). Tail refinement off: its compaction picks the worst
# ceil(tail_capacity * B) scenarios per batch, so two-phase results are
# deliberately batch-size dependent — the parity/padding contracts here
# are about the CORE kernel (the two-phase pipeline gets its own tests
# in test_se3_mpc.py).
CFG = se3_mpc.SE3MPCConfig(
    prediction_horizon=8, max_iterations=4, cg_iterations=10,
    tail_iterations=0,
)


def _problem(rng, batch, config, with_obstacles=True):
    if with_obstacles:
        obs = np.concatenate(
            [
                rng.normal(0, 4, (batch, 3, 3)),
                rng.uniform(0.3, 1.2, (batch, 3, 1)),
            ],
            axis=-1,
        ).astype(np.float32)
    else:
        obs = None
    return se3_mpc.make_problem(
        rng.normal(0, 2, (batch, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (batch, 3)).astype(np.float32),
        rng.normal(0, 3, (batch, 3)).astype(np.float32) + [0, 0, 5],
        obstacles=obs,
        config=config,
    )


def _solve_both(config, prob, **kw):
    u0 = se3_mpc.initialize_thrusts(config, prob)
    rx = se3_mpc.solve(config, prob, u0, method="xla", **kw)
    rf = se3_mpc.solve(config, prob, u0, method="interpret", block_b=16, **kw)
    return rx, rf


def test_convex_parity(rng):
    """No obstacles, hinges inactive: identical Newton path, tight match."""
    config = CFG._replace(
        ground_weight=0.0, velocity_bound_weight=0.0,
        tilt_weight=0.0, thrust_norm_weight=0.0,
    )
    prob = _problem(rng, 4, config, with_obstacles=False)
    rx, rf = _solve_both(config, prob, use_obstacles=False)
    np.testing.assert_allclose(
        np.asarray(rf.thrusts), np.asarray(rx.thrusts), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(rf.cost), np.asarray(rx.cost), rtol=1e-5
    )


def test_obstacle_aggregate_quality(rng):
    """With obstacle/ground/velocity hinges: per-scenario paths may branch
    at near-ties, but aggregate cost and convergence must match."""
    prob = _problem(rng, 16, CFG)
    rx, rf = _solve_both(CFG, prob)
    cx = np.asarray(rx.cost)
    cf = np.asarray(rf.cost)
    assert np.mean(cf) <= np.mean(cx) * 1.05
    # every fused solve descends from the cold-start cost
    u0 = se3_mpc.initialize_thrusts(CFG, prob)
    r0 = se3_mpc._finalize(CFG, prob, u0)
    assert np.all(cf <= np.asarray(r0.cost) + 1e-3)
    # thrust iterates agree on the (majority) non-branching scenarios
    close = np.abs(np.asarray(rf.thrusts) - np.asarray(rx.thrusts)) < 0.05
    assert close.all(axis=(-1, -2)).mean() >= 0.5


def test_unbatched_and_shapes(rng):
    """Single unbatched scenario: (N, 3) in, (N, 3) out."""
    prob = _problem(rng, 1, CFG)
    prob1 = type(prob)(
        *[None if x is None else np.asarray(x)[0] for x in prob]
    )
    u0 = se3_mpc.initialize_thrusts(CFG, prob1)
    assert u0.shape == (CFG.prediction_horizon, 3)
    rf = se3_mpc.solve(CFG, prob1, u0, method="interpret", block_b=16)
    assert rf.thrusts.shape == (CFG.prediction_horizon, 3)
    assert rf.cost.shape == ()
    assert np.isfinite(np.asarray(rf.cost))


def test_per_step_goal_reference(rng):
    """Tracking mode: goal of shape (B, N, 3) (beyond the reference planner)."""
    config = CFG
    B, N = 2, config.prediction_horizon
    goal = np.cumsum(
        rng.normal(0, 0.3, (B, N, 3)).astype(np.float32), axis=1
    ) + np.float32([0, 0, 5])
    prob = se3_mpc.make_problem(
        goal[:, 0] + rng.normal(0, 0.1, (B, 3)).astype(np.float32),
        np.zeros((B, 3), np.float32),
        goal,
        config=config,
    )
    rx, rf = _solve_both(config, prob, use_obstacles=False)
    np.testing.assert_allclose(
        np.asarray(rf.cost), np.asarray(rx.cost), rtol=1e-3
    )


def test_bounds_respected(rng):
    """Fused iterates stay inside the reference thrust box
    (se3_mpc_planner.py:390-401)."""
    prob = _problem(rng, 8, CFG)
    u0 = se3_mpc.initialize_thrusts(CFG, prob)
    rf = se3_mpc.solve(CFG, prob, u0, method="interpret", block_b=16)
    lb, ub = CFG.thrust_bounds()
    u = np.asarray(rf.thrusts)
    assert (u >= np.asarray(lb) - 1e-5).all()
    assert (u <= np.asarray(ub) + 1e-5).all()


def test_dispatcher_auto_is_xla_on_cpu():
    import jax

    assert jax.default_backend() == "cpu"
    prob = _problem(np.random.default_rng(0), 2, CFG)
    r = se3_mpc.solve(CFG, prob)  # must not require Pallas on CPU
    assert np.isfinite(np.asarray(r.cost)).all()


def test_block_size_choice_and_results_independent_of_block(rng):
    """The wrapper's scenario block: a power of two >= 16, cut to the
    batch's own power of two; results do not depend on it (each scenario
    is one column of its program's arrays)."""
    from dart_planner_tpu.ops import pallas_mpc

    assert pallas_mpc.block_size(1, 32) == 16
    assert pallas_mpc.block_size(20, 64) == 32
    assert pallas_mpc.block_size(4096, 32) == 32
    for bad in (8, 24):
        with pytest.raises(ValueError):
            pallas_mpc.block_size(64, bad)

    convex = CFG._replace(
        ground_weight=0.0, velocity_bound_weight=0.0,
        tilt_weight=0.0, thrust_norm_weight=0.0,
    )
    probc = _problem(rng, 20, convex, with_obstacles=False)
    u0 = se3_mpc.initialize_thrusts(convex, probc)
    u1, *_ = pallas_mpc.solve_thrusts_fused(
        convex, probc, u0, block_b=16, interpret=True, use_obstacles=False,
    )
    u2, *_ = pallas_mpc.solve_thrusts_fused(
        convex, probc, u0, block_b=32, interpret=True, use_obstacles=False,
    )
    assert u1.shape == u2.shape == (20, CFG.prediction_horizon, 3)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u1), atol=1e-4)

    prob = _problem(rng, 20, CFG)
    u0 = se3_mpc.initialize_thrusts(CFG, prob)
    c1 = np.asarray(pallas_mpc.solve_thrusts_fused(
        CFG, prob, u0, block_b=16, interpret=True)[4])
    c2 = np.asarray(pallas_mpc.solve_thrusts_fused(
        CFG, prob, u0, block_b=32, interpret=True)[4])
    assert np.mean(c2) <= np.mean(c1) * 1.05
    assert np.mean(c1) <= np.mean(c2) * 1.05


def test_fused_without_compiled_kernel_raises():
    """Off the GPU there is no compiled kernel: ``method="fused"`` raises
    instead of silently running the interpreter, and ``"auto"`` takes the
    XLA path."""
    import jax

    assert jax.default_backend() == "cpu"
    assert se3_mpc.resolve_method("auto") == "xla"
    assert se3_mpc.resolve_method("interpret") == "interpret"
    prob = _problem(np.random.default_rng(0), 2, CFG)
    with pytest.raises(ValueError, match="needs a GPU"):
        se3_mpc.solve(CFG, prob, method="fused")
    with pytest.raises(ValueError, match="unknown solver method"):
        se3_mpc.solve(CFG, prob, method="pallas")


def test_block_padding_paths(rng):
    """Batch not divisible by block: padded lanes must not leak into the
    real scenarios."""
    prob5 = _problem(rng, 21, CFG)
    u0 = se3_mpc.initialize_thrusts(CFG, prob5)
    r5 = se3_mpc.solve(CFG, prob5, u0, method="interpret", block_b=16)
    prob4 = type(prob5)(
        *[None if x is None else np.asarray(x)[:16] for x in prob5]
    )
    r4 = se3_mpc.solve(
        CFG, prob4, u0[:16], method="interpret", block_b=16
    )
    np.testing.assert_allclose(
        np.asarray(r5.thrusts)[:16], np.asarray(r4.thrusts), atol=1e-4
    )


def test_full_curvature_stage_with_padding_rows(rng):
    """Stage-2 (full-curvature Newton) parity at a horizon that is NOT a
    power of two (N=12 -> 4 padding rows in the kernel's 16-row layout).

    Regression guard: the stage-2 Jacobi clamp had no absolute floor, so
    padding rows (diag == diag_quad == 0) produced minv = inf and one
    NaN silently froze the whole stage — every line-search comparison
    went false, min_improvement reported 0 (= "converged"), and the
    fused path quietly returned stage-1-quality iterates. Horizons with
    no padding rows can never catch it."""
    config = se3_mpc.SE3MPCConfig(
        prediction_horizon=12, max_iterations=10,
        gn_warmup_iterations=4, cg_iterations=10,
    )
    N = config.prediction_horizon
    assert N & (N - 1) != 0  # padding rows exist
    assert config.newton_full_curvature  # stage 2 actually runs
    prob = _problem(rng, 8, config)
    u0 = se3_mpc.initialize_thrusts(config, prob)
    rx = se3_mpc.solve(config, prob, u0, method="xla")
    rf = se3_mpc.solve(config, prob, u0, method="interpret", block_b=16)
    np.testing.assert_allclose(
        np.asarray(rf.cost), np.asarray(rx.cost), rtol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(rf.converged), np.asarray(rx.converged)
    )
    # pre-fix signature: fused cost sat ~4e-2 above XLA (stage-1-quality
    # iterates), which the rtol=1e-4 cost parity above fails loudly


def test_dynamic_vcap_uniform_cap_matches_static_kernel():
    """Problem.v_cap == max_velocity must reproduce the static-kernel
    result EXACTLY on both paths (the dynamic-vmax kernel variant only
    replaces a constant by an input row)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    prob = _problem(rng, 16, CFG)
    vcap = jnp.full((16,), CFG.max_velocity, jnp.float32)
    for method in ("xla", "interpret"):
        r0 = se3_mpc.solve(CFG, prob, method=method)
        r1 = se3_mpc.solve(CFG, prob._replace(v_cap=vcap), method=method)
        np.testing.assert_array_equal(
            np.asarray(r0.thrusts), np.asarray(r1.thrusts)
        )
        np.testing.assert_array_equal(
            np.asarray(r0.converged), np.asarray(r1.converged)
        )


def test_dynamic_vcap_binds_and_paths_agree():
    """A tight per-scenario cap lowers planned peak speed on both paths.
    Tight caps make the velocity hinge strongly active, so individual
    scenarios may branch at line-search near-ties (the documented
    aggregate-parity contract — the same divergence appears with a
    uniformly tight STATIC max_velocity); the paths must agree in
    aggregate cost."""
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    B = 16
    prob = _problem(rng, B, CFG, with_obstacles=False)
    vcap = jnp.asarray(rng.uniform(1.5, 3.0, (B,)).astype(np.float32))
    probc = prob._replace(v_cap=vcap)
    r_x = se3_mpc.solve(CFG, probc, method="xla", use_obstacles=False)
    r_f = se3_mpc.solve(
        CFG, probc, method="interpret", use_obstacles=False
    )
    cx, cf = np.asarray(r_x.cost), np.asarray(r_f.cost)
    assert np.mean(cf) <= np.mean(cx) * 1.05
    assert np.mean(cx) <= np.mean(cf) * 1.05
    # the hinge binds: capped plans are materially slower than uncapped
    r_u = se3_mpc.solve(CFG, prob, method="xla", use_obstacles=False)
    for r in (r_x, r_f):
        sp_c = np.asarray(jnp.max(jnp.abs(r.velocities), axis=(1, 2)))
        sp_u = np.asarray(jnp.max(jnp.abs(r_u.velocities), axis=(1, 2)))
        fast = sp_u > np.asarray(vcap) + 1.0  # scenarios that wanted speed
        assert fast.any()
        assert np.all(sp_c[fast] < sp_u[fast])
        # and peak speed respects the cap up to hinge softness
        assert np.all(sp_c <= np.asarray(vcap) + 1.5)


def test_generalizes_to_larger_horizon_and_obstacle_count():
    """N=40 / K=16: the kernel's horizon rows grow to 64 and the
    obstacle loops run 16 live spheres. Fused path must descend and match the XLA path's
    aggregate cost at the same budget."""
    rng = np.random.default_rng(21)
    B = 8
    cfg = se3_mpc.SE3MPCConfig(
        prediction_horizon=40, max_iterations=3, cg_iterations=8,
        max_obstacles=16, tail_iterations=0,
    )
    obs = np.concatenate(
        [rng.normal(0, 5, (B, 16, 3)), rng.uniform(0.3, 1.0, (B, 16, 1))],
        axis=-1,
    ).astype(np.float32)
    prob = se3_mpc.make_problem(
        rng.normal(0, 2, (B, 3)).astype(np.float32) + [0, 0, 6],
        rng.normal(0, 1, (B, 3)).astype(np.float32),
        rng.normal(0, 6, (B, 3)).astype(np.float32) + [0, 0, 6],
        obstacles=obs,
        config=cfg,
    )
    u0 = se3_mpc.initialize_thrusts(cfg, prob)
    rx = se3_mpc.solve(cfg, prob, u0, method="xla")
    rf = se3_mpc.solve(cfg, prob, u0, method="interpret")
    cx, cf = np.asarray(rx.cost), np.asarray(rf.cost)
    c0 = np.asarray(se3_mpc._finalize(cfg, prob, u0).cost)
    assert np.all(np.isfinite(cf))
    assert np.all(cf <= c0 + 1e-3)  # every scenario descends
    assert np.mean(cf) <= np.mean(cx) * 1.05
    assert np.mean(cx) <= np.mean(cf) * 1.05

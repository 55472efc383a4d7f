"""Multi-chip scaling structure (SURVEY.md section 4 "rebuild mapping":
1 chip / 1 host / N>=2 hosts runnable on CPU virtual devices).

Wall-clock efficiency cannot be measured on virtual CPU devices (they
share one host), so these tests pin down the *structural* properties that
determine scaling: identical results at every mesh size (weak + strong
scaling correctness) and a communication-free solve — the only collective
in the compiled fleet step must be the O(1) FleetStats reduction, so
per-chip work is independent and scaling efficiency is bounded by the
tiny stats psum, not by the solve.
"""

import jax
import numpy as np
import pytest

from dart_planner_tpu.parallel import scenario
from dart_planner_tpu.planning import se3_mpc

# tail refinement off: its compaction picks the worst ceil(capacity * B)
# scenarios PER SHARD, so the refined cohort (and thus bitwise results)
# legitimately depends on the mesh split — the invariance contract below
# applies to the single-phase core solve. See parallel/scenario.py for
# the per-shard refinement semantics.
CFG = se3_mpc.SE3MPCConfig(
    prediction_horizon=8, max_iterations=3, cg_iterations=8,
    tail_iterations=0,
)


def _problem(batch):
    rng = np.random.default_rng(7)
    obs = np.concatenate(
        [rng.normal(0, 4, (batch, 2, 3)), rng.uniform(0.4, 1.0, (batch, 2, 1))],
        axis=-1,
    ).astype(np.float32)
    return se3_mpc.make_problem(
        rng.normal(0, 2, (batch, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (batch, 3)).astype(np.float32),
        rng.normal(0, 4, (batch, 3)).astype(np.float32) + [0, 0, 5],
        obstacles=obs,
        config=CFG,
    )


@pytest.mark.parametrize("n_dev,hosts", [(1, 1), (2, 1), (4, 2), (8, 2)])
def test_results_invariant_across_mesh_sizes(n_dev, hosts):
    """The fleet solve must be bitwise-independent of how scenarios are
    sharded: 1 chip, 1 host x N devices, and N hosts x M devices all
    produce the single-device answer."""
    prob = _problem(16)
    mesh1 = scenario.make_fleet_mesh(jax.devices()[:1], hosts=1)
    ref, ref_stats = scenario.solve_fleet(CFG, mesh1, prob)

    mesh = scenario.make_fleet_mesh(jax.devices()[:n_dev], hosts=hosts)
    probs = scenario.shard_scenarios(prob, mesh)
    res, stats = scenario.solve_fleet(CFG, mesh, probs)
    np.testing.assert_allclose(
        np.asarray(res.thrusts), np.asarray(ref.thrusts), atol=1e-5
    )
    assert int(stats.total) == 16
    assert int(stats.converged) == int(ref_stats.converged)


def test_solve_is_communication_free():
    """Compile the sharded fleet step and check the only collectives are
    the FleetStats reductions over scalars — nothing in the per-scenario
    solve crosses the mesh, which is what makes >=85% multi-host scaling
    achievable (the interconnect carries O(1) bytes per step)."""
    mesh = scenario.make_fleet_mesh(jax.devices()[:8], hosts=2)
    prob = scenario.shard_scenarios(_problem(16), mesh)
    lowered = scenario.solve_fleet.lower(CFG, mesh, prob)
    hlo = lowered.compile().as_text()
    # collect all-reduce ops and their operand shapes
    import re

    reduces = [
        line for line in hlo.splitlines() if "all-reduce" in line and "=" in line
    ]
    for line in reduces:
        # every all-reduce operand must be scalar-shaped (f32[] / pred[])
        shapes = re.findall(r"f32\[([0-9,]*)\]", line)
        assert all(s == "" for s in shapes), f"non-scalar collective: {line}"
    # and there must BE a stats reduction (psum of the 4 fleet stats)
    assert reduces, "expected the FleetStats psum to appear"


def test_weak_scaling_batch_grows_with_mesh():
    """Weak scaling shape check: per-device batch stays constant as the
    mesh grows; results stay finite and stats see the global fleet."""
    for n_dev in (2, 8):
        mesh = scenario.make_fleet_mesh(jax.devices()[:n_dev])
        batch = 4 * n_dev
        prob = scenario.shard_scenarios(_problem(batch), mesh)
        res, stats = scenario.solve_fleet(CFG, mesh, prob)
        assert int(stats.total) == batch
        assert np.isfinite(np.asarray(res.cost)).all()
        shard_shapes = {
            tuple(s.data.shape)
            for s in res.thrusts.addressable_shards
        }
        assert shard_shapes == {(4, CFG.prediction_horizon, 3)}


def test_fused_path_invariant_under_shard_map():
    """The fused Pallas solver inside shard_map (the fleet path on the
    GPU) must produce the same answer as the same fused solver on a
    single device. Runs the kernel in interpret mode on the CPU mesh,
    where its arithmetic is deterministic; chip_smoke.py --four-cards
    checks the compiled kernel across four GPUs."""
    prob = _problem(16)
    mesh1 = scenario.make_fleet_mesh(jax.devices()[:1], hosts=1)
    ref, ref_stats = scenario.solve_fleet(CFG, mesh1, prob, method="interpret")

    mesh = scenario.make_fleet_mesh(jax.devices()[:8], hosts=2)
    probs = scenario.shard_scenarios(prob, mesh)
    res, stats = scenario.solve_fleet(CFG, mesh, probs, method="interpret")
    np.testing.assert_allclose(
        np.asarray(res.thrusts), np.asarray(ref.thrusts), atol=1e-5
    )
    assert int(stats.total) == 16
    assert int(stats.converged) == int(ref_stats.converged)

    # and the fused path agrees with the XLA path through the same mesh
    res_x, _ = scenario.solve_fleet(CFG, mesh, probs, method="xla")
    np.testing.assert_allclose(
        np.asarray(res.cost), np.asarray(res_x.cost), rtol=1e-4
    )

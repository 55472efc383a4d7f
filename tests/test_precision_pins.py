"""Every matrix product on the solve and closed-loop paths is pinned at
``Precision.HIGHEST``.

On the GPU an unpinned float32 product may run in TF32 (~3 decimal
digits); a 400 Hz loop of ~2,400 rotation products per episode, or a CG
matvec feeding an ftol test at 1e-6, does not survive that. The check
walks the traced program, so a new unpinned ``@``/``dot``/``einsum``
fails here on the CPU rather than as drift on the card.
"""

import jax
import numpy as np
import pytest
from jax.extend import core as jcore

from dart_planner_tpu.planning import se3_mpc
from dart_planner_tpu.sim import closed_loop
from dart_planner_tpu.sim.scenarios import bench_monte_carlo, random_obstacle_problem

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for param in eqn.params.values():
            for sub in param if isinstance(param, (list, tuple)) else [param]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    _dot_precisions(sub.jaxpr, out)
                elif isinstance(sub, jcore.Jaxpr):
                    _dot_precisions(sub, out)
    return out


def _solve_two_phase():
    cfg = se3_mpc.SE3MPCConfig(prediction_horizon=8, restart_iterations=2)
    prob = random_obstacle_problem(cfg, 8, np.random.default_rng(0))
    return jax.make_jaxpr(
        lambda p: se3_mpc.extract_trajectory(
            cfg, se3_mpc.solve(cfg, p, method="xla"), 0.0
        )
    )(prob)


def _closed_loop():
    setup = bench_monte_carlo(8)
    cfg = setup.args[0]._replace(
        mpc=setup.args[0].mpc._replace(prediction_horizon=8), num_replans=2
    )
    return jax.make_jaxpr(
        lambda: closed_loop.simulate_episode(
            cfg, *setup.args[1:], method="xla", **setup.kwargs
        )
    )()


@pytest.mark.parametrize("trace", [_solve_two_phase, _closed_loop])
def test_every_product_is_pinned_highest(trace):
    precisions = _dot_precisions(trace().jaxpr, [])
    assert precisions, "expected matrix products on this path"
    unpinned = [p for p in precisions if p != HIGHEST]
    assert not unpinned, f"{len(unpinned)} of {len(precisions)} unpinned: {unpinned[:5]}"

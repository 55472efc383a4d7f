"""Anatomy of a basin-stuck scenario (docs/quality.md, "Solver
convergence").

One scenario of the 4096-bench batch landed at cost excess 1.08 on the
XLA path at every budget, and the round-5 perturbed-restart phase did
not dislodge it. This probe answers, reusing already-compiled
executables (the full batch is tiled with the stuck scenario):

  1. which scenario is it, and does the restart's suspicion ranking
     (cost / quadratic floor) actually select it at capacity 1/32?
  2. from jittered QP starts at several noise scales, what fraction of
     starts reach the good basin under the SHIPPING staged config —
     i.e. can any restart policy fix it, and with what noise/budget?

Usage: python scripts/diag_stuck.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.ops import costs
from dart_planner_tpu.planning import se3_mpc
from diag_convergence import make_batch


def main():
    from dart_planner_tpu.common.compile_cache import setup_compile_cache

    setup_compile_cache()
    config, prob = make_batch(4096)
    print(f"platform={jax.devices()[0].platform}")

    gt = se3_mpc.solve(
        config._replace(max_iterations=60, cg_iterations=25,
                        tail_iterations=0),
        prob, se3_mpc.initialize_thrusts(config, prob), method="xla",
    )
    gt_cost = np.asarray(gt.cost, np.float64)

    u0 = se3_mpc.initialize_thrusts(config, prob)
    res = se3_mpc.solve(config, prob, u0, method="xla")
    cost = np.asarray(res.cost, np.float64)
    excess = (cost - gt_cost) / np.maximum(np.abs(gt_cost), 1e-9)
    i = int(np.argmax(excess))
    print(f"stuck scenario #{i}: excess={excess[i]:.3f} "
          f"cost={cost[i]:.1f} gt={gt_cost[i]:.1f} "
          f"converged={bool(np.asarray(res.converged)[i])}")
    po = np.asarray(prob.obstacles)[i]
    pm = np.asarray(prob.obstacle_mask)[i]
    print(f"  p0={np.asarray(prob.p0)[i]} goal={np.asarray(prob.goal)[i]}")
    print(f"  obstacles (masked r_safe): "
          f"{[list(np.round(o, 2)) for o, m in zip(po, pm) if m]}")

    # 1. restart-cohort membership under the suspicion ranking
    w_quad = config.weights._replace(
        obstacle=0.0, ground=0.0, velocity_bound=0.0, tilt=0.0,
        thrust_norm=0.0,
    )
    from dart_planner_tpu.common import frames

    gvec = frames.gravity_vector(
        frames.WorldFrame.ENU, config.gravity
    ).astype(np.float32)
    quad = np.asarray(costs.condensed_cost(
        u0, prob, w_quad, config.dt, config.mass, gvec
    ), np.float64)
    ratio = cost / np.maximum(quad, 1e-3)
    rank = int(np.sum(ratio > ratio[i]))  # 0 = most suspicious
    C = int(np.ceil(4096 / 32.0))
    print(f"  suspicion ratio={ratio[i]:.3f} rank={rank} "
          f"(cohort size {C}; {'IN' if rank < C else 'NOT IN'} cohort)  "
          f"ratio p50={np.median(ratio):.3f} p99={np.percentile(ratio, 99):.3f}")

    # 2. jittered-start basin census under the SHIPPING config (reuses
    # the compiled 4096 two-phase executable: full batch = tiled copies)
    B = 4096
    tile = lambda x: jnp.broadcast_to(  # noqa: E731
        jnp.asarray(x)[i][None], (B,) + np.asarray(x)[i].shape
    )
    prob_t = costs.Problem(
        p0=tile(prob.p0), v0=tile(prob.v0), goal=tile(prob.goal),
        obstacles=tile(prob.obstacles),
        obstacle_mask=tile(prob.obstacle_mask), v_cap=None,
    )
    u_qp = se3_mpc.initialize_thrusts(config, prob_t)
    key = jax.random.PRNGKey(1)
    scales = np.repeat([0.0, 1.0, 2.0, 4.0, 8.0], B // 5)
    scales = np.pad(scales, (0, B - scales.size), mode="edge")
    noise = jax.random.normal(key, u_qp.shape) * jnp.asarray(
        scales, jnp.float32
    )[:, None, None]
    res_j = se3_mpc.solve(config, prob_t, u_qp + noise, method="xla")
    cj = np.asarray(res_j.cost, np.float64)
    good = cj <= gt_cost[i] * 1.05
    print(f"  jittered starts reaching within 5% of gt "
          f"(gt={gt_cost[i]:.1f}): {good.mean():.3f} overall")
    for s in [0.0, 1.0, 2.0, 4.0, 8.0]:
        m = scales == s
        print(f"    noise std {s:4.1f} N: good={good[m].mean():.3f} "
              f"best={cj[m].min():.1f} median={np.median(cj[m]):.1f}")


if __name__ == "__main__":
    main()

"""Diagnose the unconverged solver tail (VERDICT round-1 weak item 3).

Measures, on the bench.py batch (4096 randomized obstacle scenarios,
N=20): convergence fraction and p95 cost-vs-ground-truth as a function
of Newton/CG budget, for both the XLA path and (on the GPU) the fused
Pallas kernel; plus the projected-gradient-norm distribution of the
surviving tail. Ground truth = 60-iteration CG-25 XLA solve.

Usage: python scripts/diag_convergence.py [--xla-only]
"""

import argparse
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.common.compile_cache import setup_compile_cache
from dart_planner_tpu.planning import se3_mpc


def make_batch(batch=4096, seed=0):
    rng = np.random.default_rng(seed)
    config = se3_mpc.SE3MPCConfig()
    obs = np.concatenate(
        [
            rng.normal(0, 4, (batch, 4, 3)),
            rng.uniform(0.3, 1.2, (batch, 4, 1)),
        ],
        axis=-1,
    ).astype(np.float32)
    prob = se3_mpc.make_problem(
        rng.normal(0, 2, (batch, 3)).astype(np.float32) + [0, 0, 5],
        rng.normal(0, 1, (batch, 3)).astype(np.float32),
        rng.normal(0, 5, (batch, 3)).astype(np.float32) + [0, 0, 5],
        obstacles=obs,
        config=config,
    )
    return config, jax.device_put(prob)


def run(config, prob, method, **overrides):
    cfg = config._replace(**overrides)
    u0 = se3_mpc.initialize_thrusts(cfg, prob)
    res = se3_mpc.solve(cfg, prob, u0, method=method)
    jax.block_until_ready(res.cost)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--xla-only", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--quick", action="store_true",
                    help="skip the uniform-budget rows (ship rows only)")
    args = ap.parse_args()

    config, prob = make_batch(args.batch)
    setup_compile_cache()
    print(f"platform={jax.devices()[0].platform} batch={args.batch}")

    # ground truth: long fp32 XLA solve (single-phase)
    gt = run(
        config, prob, "xla", max_iterations=60, cg_iterations=25,
        tail_iterations=0,
    )
    gt_cost = np.asarray(gt.cost, np.float64)
    print(
        f"ground truth: conv={float(gt.converged.mean()):.4f} "
        f"median cost={np.median(gt_cost):.3f}"
    )

    methods = ["xla"] if args.xla_only else ["xla", "fused"]
    header = (
        f"{'method':8s} {'budget':>16s} {'conv':>7s} "
        f"{'p95 excess':>11s} {'max excess':>11s} "
        f"{'conv-cohort p95':>15s}"
    )
    print(header)

    def report(method, label, res):
        cost = np.asarray(res.cost, np.float64)
        excess = (cost - gt_cost) / np.maximum(np.abs(gt_cost), 1e-9)
        conv = np.asarray(res.converged)
        # honesty of the ftol gate: excess of the converged cohort
        conv_p95 = (
            np.percentile(excess[conv], 95) if conv.any() else float("nan")
        )
        print(
            f"{method:8s} {label:>16s} "
            f"{float(conv.mean()):7.4f} "
            f"{np.percentile(excess, 95):11.2e} "
            f"{excess.max():11.2e} {conv_p95:15.2e}"
        )

    for method in methods:
        if method == "fused" and jax.devices()[0].platform != "gpu":
            continue
        # fixed uniform budgets (single-phase, for the budget->quality
        # curve; tail refinement disabled so rows stay comparable)
        for newton, cg in ([] if args.quick else [
            (12, 10),
            (16, 10),
            (20, 10),
            (24, 10),
        ]):
            try:
                res = run(
                    config, prob, method,
                    max_iterations=newton, cg_iterations=cg,
                    tail_iterations=0,
                )
            except Exception as e:  # report a failing budget, keep going
                print(f"{method:8s} {newton:6d}/{cg:<4d}  FAILED: {e}")
                continue
            report(method, f"uniform {newton}/{cg}", res)
        # the SHIPPING config: phase-1 budget + adaptive compacted tail
        # refinement (SE3MPCConfig defaults)
        res = run(config, prob, method)
        report(
            method,
            f"ship 12+{config.tail_iterations}@{config.tail_cg_iterations}",
            res,
        )
        # ship + perturbed restart (phase 3, VERDICT r4 item 7): re-solve
        # still-stuck scenarios from a jittered cold start, keep the
        # cheaper result — basin escape for the nonconvex obstacle hinge
        res = run(config, prob, method, restart_iterations=20)
        report(method, "ship+restart 20", res)


if __name__ == "__main__":
    main()

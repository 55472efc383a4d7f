"""Planner→actuator fast path: one precompiled single-solve executable
feeding the C++ real-time executor.

This is the measured end-to-end dispatch path the reference gates in CI
(/root/reference/tests/test_real_time_latency.py:109-120: planning p95
< 50 ms, control p95 < 5 ms, total p95 < 50 ms) and the accelerator
analog of its Cython fast loop (rt_control_extension.pyx:28-31): the
10–50 Hz replanner dispatches a persistent pre-compiled executable (the
fused solve kernel on the GPU) whose warm-start buffer is donated and
lives on device, fetches ONE small setpoint vector back, and hands it to
the C++ 400 Hz loop (native/rt_executor.cpp), which runs the inner
tracking PID with zero Python/GIL work per tick.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.planning import se3_mpc

Array = jnp.ndarray

# Setpoint handed to the RT loop = horizon step 1 (the first FUTURE
# state; step 0 is the current-time knot). The reference edge loop
# interpolates the smoothed trajectory per tick (edge/main_improved.py:
# 127-131); the C++ loop's PID plays that role here at 400 Hz between
# 10-50 Hz replans.
_SETPOINT_STEP = 1


class PlannerFastPath:
    """Persistent single-solve dispatch with on-device warm start.

    One jitted step = warm-start shift → solve (``method``, see
    :func:`se3_mpc.resolve_method`) →
    trajectory extraction → 13-float setpoint [pos, vel, att(rpy),
    body_rates, thrust]. The warm-start thrust plan never leaves the
    device; its buffer is donated every call.
    """

    def __init__(
        self,
        config: Optional[se3_mpc.SE3MPCConfig] = None,
        method: str = "auto",
    ):
        self.config = config or se3_mpc.SE3MPCConfig()
        self._method = method

        def step(prob, u_prev):
            cfg = self.config
            u0 = se3_mpc.shift_warm_start(cfg, u_prev)
            res = se3_mpc.solve(cfg, prob, u0, method=self._method)
            traj = se3_mpc.extract_trajectory(cfg, res, 0.0)
            i = _SETPOINT_STEP
            sp = jnp.concatenate(
                [
                    traj.positions[..., i, :],
                    traj.velocities[..., i, :],
                    traj.attitudes[..., i, :],
                    traj.body_rates[..., i, :],
                    traj.thrusts[..., i : i + 1],
                ],
                axis=-1,
            )  # (..., 13)
            return res.thrusts, sp

        self._step = jax.jit(step, donate_argnums=(1,))
        self._u: Optional[Array] = None

    def reset(self) -> None:
        self._u = None

    def replan(self, position, velocity, goal, obstacles=None) -> np.ndarray:
        """One replan: returns the fetched (13,) setpoint (numpy).

        Blocking by design — the fetch IS the dispatch-path latency being
        measured; production would pipeline the next state upload under it.
        """
        prob = se3_mpc.make_problem(
            np.asarray(position, np.float32)[None],
            np.asarray(velocity, np.float32)[None],
            np.asarray(goal, np.float32)[None],
            obstacles=obstacles,
            config=self.config,
        )
        if self._u is None:
            self._u = se3_mpc.initialize_thrusts(self.config, prob)
        self._u, sp = self._step(prob, self._u)
        return np.asarray(sp)[0]

    def push_setpoint(self, loop, setpoint13: np.ndarray) -> None:
        """Hand a replan result to an RT control loop
        (runtime.rt_executor.RealTimeControlLoop or PythonControlLoop)."""
        loop.set_setpoint(
            setpoint13[0:3],
            setpoint13[3:6],
            setpoint13[6:9],
            setpoint13[9:12],
            thrust_ff=float(setpoint13[12]),
        )


def measure_latency(
    fast_path: PlannerFastPath,
    loop,
    n_replans: int = 200,
    goal=(5.0, 3.0, 4.0),
    seed: int = 0,
) -> dict:
    """Measure the full planner→actuator dispatch path.

    Per replan: state → device → precompiled solve → setpoint fetch →
    ``set_setpoint`` on the running RT loop. The RT loop's own per-tick
    execution times (state+setpoint → actuator command, C++ PID) come
    from its circular buffer. Returns p50/p95 for the planning path
    (host clock around replan + setpoint fetch), the control tick, and
    their sum (the planner-to-actuator figure the reference gates at
    50 ms).
    """
    rng = np.random.default_rng(seed)
    goal = np.asarray(goal, np.float64)

    # representative randomized states around a hover corridor
    positions = rng.normal(0.0, 1.0, (n_replans, 3)) + [0.0, 0.0, 3.0]
    velocities = rng.normal(0.0, 0.5, (n_replans, 3))

    # warm-up: compile + first dispatch
    sp = fast_path.replan(positions[0], velocities[0], goal)
    fast_path.push_setpoint(loop, sp)

    planning = np.empty(n_replans)
    for i in range(n_replans):
        loop.set_state(positions[i], velocities[i], np.zeros(3), np.zeros(3))
        t0 = time.perf_counter()
        sp = fast_path.replan(positions[i], velocities[i], goal)
        fast_path.push_setpoint(loop, sp)
        planning[i] = time.perf_counter() - t0

    exec_times = np.asarray(loop.get_execution_times())
    if exec_times.size == 0:
        exec_times = np.zeros(1)
    stats = loop.get_stats()

    def p(v, q):
        return float(np.percentile(v, q) * 1e3)

    return {
        "planning_host_p50_ms": p(planning, 50),
        "planning_host_p95_ms": p(planning, 95),
        "control_tick_p95_ms": p(exec_times, 95),
        "control_tick_max_ms": float(exec_times.max() * 1e3),
        "planner_to_actuator_p95_ms": p(planning, 95) + p(exec_times, 95),
        "rt_loop_missed_deadlines": stats["missed_deadlines"],
        "rt_loop_iterations": stats["iteration_count"],
        "n_replans": n_replans,
    }

"""Planner→actuator fast path (runtime/fast_path.py).

CPU-mesh tests: the dispatch machinery (precompiled step with donated
warm start, setpoint extraction/handoff, latency accounting) is
platform-independent; the actual p95 numbers are measured on the GPU by
bench.py and chip_smoke.py. Reference gate being modeled:
/root/reference/tests/test_real_time_latency.py:109-120.
"""

import numpy as np
import pytest

from dart_planner_tpu.planning import se3_mpc
from dart_planner_tpu.runtime import rt_executor
from dart_planner_tpu.runtime.fast_path import (
    PlannerFastPath,
    measure_latency,
)


@pytest.fixture(scope="module")
def fast_path():
    # small horizon keeps CPU compile quick; the path is shape-generic
    cfg = se3_mpc.SE3MPCConfig(prediction_horizon=8, max_iterations=4)
    return PlannerFastPath(cfg)


def test_replan_produces_finite_setpoint(fast_path):
    sp = fast_path.replan([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [4.0, 2.0, 4.0])
    assert sp.shape == (13,)
    assert np.all(np.isfinite(sp))
    # thrust setpoint is positive (vehicle must hold altitude)
    assert sp[12] > 0.0
    # position setpoint moves toward the goal from the start
    assert np.linalg.norm(sp[0:3] - np.asarray([4.0, 2.0, 4.0])) < np.linalg.norm(
        np.asarray([0.0, 0.0, 3.0]) - np.asarray([4.0, 2.0, 4.0])
    )


def test_warm_start_persists_on_device(fast_path):
    fast_path.reset()
    assert fast_path._u is None
    fast_path.replan([0.0, 0.0, 3.0], [0.0, 0.0, 0.0], [4.0, 2.0, 4.0])
    u1 = np.asarray(fast_path._u)
    fast_path.replan([0.1, 0.0, 3.0], [0.0, 0.0, 0.0], [4.0, 2.0, 4.0])
    u2 = np.asarray(fast_path._u)
    assert u1.shape == u2.shape
    assert not np.allclose(u1, u2)  # the plan actually advanced


def test_measure_latency_through_rt_loop(fast_path):
    loop = rt_executor.create_control_loop(frequency_hz=200.0)
    loop.set_gains(
        kp_pos=[2.0, 2.0, 4.0], ki_pos=[0.0] * 3, kd_pos=[1.0] * 3,
        kp_att=[4.0] * 3, ki_att=[0.0] * 3, kd_att=[0.5] * 3,
    )
    loop.start()
    try:
        stats = measure_latency(fast_path, loop, n_replans=10)
    finally:
        loop.stop()
    for key in (
        "planning_host_p50_ms",
        "planning_host_p95_ms",
        "control_tick_p95_ms",
        "planner_to_actuator_p95_ms",
    ):
        assert stats[key] >= 0.0, key
    # one latency per field: no raw/corrected pairs, no link round trip
    assert not any("raw" in k or "rtt" in k for k in stats)
    assert stats["planning_host_p50_ms"] <= stats["planning_host_p95_ms"]
    assert stats["planner_to_actuator_p95_ms"] >= stats["planning_host_p95_ms"]
    assert stats["rt_loop_iterations"] > 0
    # the RT loop actually produced an actuator command from the setpoints
    cmd = loop.get_command()
    assert cmd is not None
    assert np.isfinite(cmd["thrust"])


@pytest.mark.flaky  # wall-clock rate assertions on a shared box
def test_exec_times_export():
    loop = rt_executor.create_control_loop(frequency_hz=500.0)
    loop.set_gains(
        kp_pos=[1.0] * 3, ki_pos=[0.0] * 3, kd_pos=[0.0] * 3,
        kp_att=[1.0] * 3, ki_att=[0.0] * 3, kd_att=[0.0] * 3,
    )
    loop.set_state([0, 0, 1], [0, 0, 0], [0, 0, 0], [0, 0, 0])
    loop.set_setpoint([0, 0, 2], [0, 0, 0], [0, 0, 0], [0, 0, 0], 10.0)
    loop.start()
    import time

    time.sleep(0.2)
    loop.stop()
    et = loop.get_execution_times()
    assert et.size > 0
    assert np.all(et >= 0.0)
    assert float(np.percentile(et, 95)) < 0.1  # a tick is far under 100 ms

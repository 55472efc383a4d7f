"""Multi-process (multi-host) fleet execution over ``jax.distributed``.

The reference scales across machines by hand-rolled ZMQ process pairs
(/root/reference/src/dart_planner/edge/main_improved.py:96-147). Here
every host runs THE SAME program; ``jax.distributed``
stitches their local devices into one global mesh, ``solve_fleet``'s
``shard_map`` runs communication-free per-scenario solves, and only the
psum'd :class:`~dart_planner_tpu.parallel.scenario.FleetStats` cross
between hosts.

This module is the thin host-topology layer:

- :func:`initialize` — bring the process into the cluster;
- :func:`global_fleet_mesh` — the ("hosts", "devices") mesh over ALL
  processes' devices;
- :func:`host_local_problem` — build a globally-sharded Problem from
  per-process local shards (no host ever materializes the full fleet);
- :func:`measure_throughput` — chained-solve timing with a psum barrier,
  for weak-scaling efficiency numbers (docs/scaling.md).

Validated by a real 2/4-process CPU harness launched from pytest
(tests/test_distributed.py) and ``scripts/measure_scaling.py``.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from dart_planner_tpu.ops import costs
from dart_planner_tpu.parallel import scenario
from dart_planner_tpu.planning import se3_mpc

Array = jnp.ndarray

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the ``jax.distributed`` cluster (idempotent).

    With no arguments, relies on JAX's cluster autodetection; where
    there is none (a plain GPU host), pass ``coordinator_address``,
    ``num_processes`` and ``process_id`` explicitly, as the CPU test
    harness does.
    """
    global _initialized
    if _initialized:
        return
    kw = {}
    if coordinator_address is not None:
        kw = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:  # already initialized by the launcher
        if "already" not in str(e):
            raise
    _initialized = True


def global_fleet_mesh() -> Mesh:
    """("hosts", "devices") mesh over every process's devices.

    ``jax.devices()`` orders devices by process; reshaping to
    (process_count, local) puts each process's devices on one "hosts"
    row, so the "devices" axis is intra-host (NVLink between GPUs) and
    the "hosts" axis is inter-host (the network) — collectives ride the
    right fabric by construction.
    """
    procs = jax.process_count()
    devs = jax.devices()
    local = len(devs) // procs
    arr = np.array(devs).reshape(procs, local)
    return Mesh(arr, scenario.BATCH_AXES)


def host_local_problem(
    prob_local: costs.Problem, mesh: Mesh
) -> costs.Problem:
    """Assemble a globally-sharded Problem from per-process shards.

    ``prob_local`` holds THIS process's scenarios (leading axis =
    global_batch / process_count). Uses
    ``jax.make_array_from_process_local_data`` so no host gathers the
    full fleet — the global array exists only as metadata + local
    shards.
    """
    sh = scenario.batch_sharding(mesh)
    procs = max(jax.process_count(), 1)

    def to_global(x):
        x = np.asarray(x)
        global_shape = (x.shape[0] * procs,) + x.shape[1:]
        return jax.make_array_from_process_local_data(sh, x, global_shape)

    return jax.tree_util.tree_map(to_global, prob_local)


def measure_throughput(
    config,
    mesh: Mesh,
    prob: costs.Problem,
    reps: int = 5,
    passes: int = 3,
    method: str = "auto",
    per_call_stats: bool = False,
) -> dict:
    """Weak-scaling measurement: chained fleet solves, barrier-timed.

    Returns solves/s aggregate and per-device — the quantity whose
    mesh-size invariance IS weak-scaling efficiency (north star: >=85%
    at N>=2 hosts).

    ``per_call_stats=False`` (the production cadence) chains solves with
    NO cross-host collectives — scenarios are independent, so nothing
    needs to cross the fabric per solve round; one stats reduction runs
    after the timed chain as the global barrier. ``per_call_stats=True``
    measures the worst-case variant where every call pays the psum —
    on an oversubscribed loopback fabric that sync alone costs tens of
    percent (docs/scaling.md has both numbers).
    """
    u0 = se3_mpc.initialize_thrusts(config, prob)
    res, stats = scenario.solve_fleet(config, mesh, prob, u0, method=method)
    jax.block_until_ready(res.thrusts)
    batch = int(stats.total.addressable_shards[0].data)  # psum'd => global

    best = float("inf")
    for _ in range(passes):
        u = u0
        t0 = time.perf_counter()
        for _ in range(reps):
            res, st = scenario.solve_fleet(
                config, mesh, prob, u, method=method,
                with_stats=per_call_stats,
            )
            u = res.thrusts  # data dependence: solves run serially
        if per_call_stats:
            # st.total is fully replicated; fetching it is a global barrier
            float(np.asarray(st.mean_cost.addressable_shards[0].data))
        # no collectives in the chain => processes are independent, so
        # each one's local completion time IS its weak-scaling number
        jax.block_until_ready(res.thrusts)
        best = min(best, (time.perf_counter() - t0) / reps)
    n_dev = mesh.devices.size
    return {
        "global_batch": batch,
        "devices": n_dev,
        "processes": max(jax.process_count(), 1),
        "per_call_stats": per_call_stats,
        "seconds_per_solve_call": best,
        "solves_per_s": batch / best,
        "solves_per_s_per_device": batch / best / n_dev,
    }

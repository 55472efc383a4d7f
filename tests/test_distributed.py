"""REAL multi-process ``jax.distributed`` fleet execution (SURVEY §4:
1-chip / 1-host / N-host scaling tests runnable on CPU).

Launches N separate Python processes, each a ``jax.distributed``
participant with its own virtual CPU devices, building one global
("hosts", "devices") mesh. Unlike tests/test_scaling.py (single-process
virtual mesh), the psum'd FleetStats here cross actual process
boundaries over gRPC/Gloo — this is the reference's edge<->cloud
process split (edge/main_improved.py:96-147) re-done as one program over
a multi-process mesh."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "scripts", "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(num_processes: int, local_devices: int, batch: int,
            extra=(), timeout=240):
    """Run the worker N times; return process-0's parsed RESULT JSON."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for i in range(num_processes):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, WORKER,
                    "--coordinator", f"localhost:{port}",
                    "--num-processes", str(num_processes),
                    "--process-id", str(i),
                    "--local-devices", str(local_devices),
                    "--global-batch", str(batch),
                    *extra,
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
                env=env,
                cwd=ROOT,
            )
        )
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
    for line in outs[0].splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line from process 0:\n{outs[0][-3000:]}")


@pytest.mark.slow
def test_two_process_fleet_stats_match_reference():
    """2 processes x 2 devices: cross-process psum'd stats must equal a
    single-process recomputation of the same global fleet."""
    r = _launch(num_processes=2, local_devices=2, batch=32)
    assert r["process_count"] == 2
    assert r["global_devices"] == 4
    s, ref = r["stats"], r["reference"]
    assert s["total"] == ref["total"] == 32.0
    assert s["converged"] == ref["converged"]
    np.testing.assert_allclose(s["mean_cost"], ref["mean_cost"], rtol=1e-3)
    np.testing.assert_allclose(
        s["max_grad_norm"], ref["max_grad_norm"], rtol=0.1
    )


@pytest.mark.slow
def test_four_process_mesh():
    """4 processes x 1 device: the mesh spans 4 real processes."""
    r = _launch(num_processes=4, local_devices=1, batch=32)
    assert r["process_count"] == 4
    assert r["global_devices"] == 4
    assert r["stats"]["total"] == 32.0
    np.testing.assert_allclose(
        r["stats"]["mean_cost"], r["reference"]["mean_cost"], rtol=1e-3
    )

"""Security layer + DI + metrics + multiprocess loop tests."""

import time

import numpy as np
import pytest

from dart_planner_tpu.common.di import (
    DIContainer,
    Stage,
    create_default_container,
)
from dart_planner_tpu.common.errors import DependencyError, ValidationError
from dart_planner_tpu.common.metrics import MetricsManager
from dart_planner_tpu.runtime.multiprocess_loop import ProcessControlLoop
from dart_planner_tpu.security import (
    AuthManager,
    RateLimitConfig,
    RateLimiter,
    Role,
    TokenError,
    compute_file_digest,
    validate_position,
    validate_waypoints,
    verify_file_digest,
)


# ---- auth ----
@pytest.fixture(scope="module")
def auth():
    a = AuthManager()
    a.register_user("op", "hunter2-secure", Role.OPERATOR)
    a.register_user("viewer", "look-only", Role.VIEWER)
    return a


def test_password_hash_roundtrip(auth):
    assert auth.authenticate("op", "hunter2-secure") is not None
    assert auth.authenticate("op", "wrong") is None
    assert auth.authenticate("ghost", "x") is None


def test_token_lifecycle(auth):
    user = auth.authenticate("op", "hunter2-secure")
    token = auth.create_access_token(user)
    payload = auth.verify_token(token)
    assert payload["sub"] == "op" and payload["role"] == "operator"
    # refresh flow
    refresh = auth.create_refresh_token(user)
    new_access = auth.refresh_access_token(refresh)
    assert auth.verify_token(new_access)["sub"] == "op"
    # wrong type rejected
    with pytest.raises(TokenError):
        auth.verify_token(refresh, expected_type="access")


def test_token_forgery_rejected(auth):
    user = auth.authenticate("op", "hunter2-secure")
    token = auth.create_access_token(user)
    h, p, s = token.split(".")
    import base64, json

    payload = json.loads(base64.urlsafe_b64decode(p + "==="))
    payload["role"] = "admin"
    forged_p = base64.urlsafe_b64encode(
        json.dumps(payload).encode()
    ).rstrip(b"=").decode()
    with pytest.raises(TokenError):
        auth.verify_token(f"{h}.{forged_p}.{s}")
    # a different keypair's token is also rejected
    other = AuthManager()
    other.register_user("op", "hunter2-secure", Role.ADMIN)
    alien = other.create_access_token(other.authenticate("op", "hunter2-secure"))
    with pytest.raises(TokenError):
        auth.verify_token(alien)


def test_role_permissions(auth):
    op = auth.create_access_token(auth.authenticate("op", "hunter2-secure"))
    vw = auth.create_access_token(auth.authenticate("viewer", "look-only"))
    assert auth.has_permission(op, "takeoff")
    assert not auth.has_permission(vw, "takeoff")
    assert auth.has_permission(vw, "view")


# ---- rate limiter ----
def test_rate_limiter_lockout_and_recovery():
    rl = RateLimiter(RateLimitConfig(max_attempts=3, window_s=10.0, base_lockout_s=0.1))
    for _ in range(3):
        ok, _ = rl.is_allowed("1.2.3.4")
        assert ok
    ok, reason = rl.is_allowed("1.2.3.4")
    assert not ok and "locked" in reason
    time.sleep(0.12)
    ok, _ = rl.is_allowed("1.2.3.4")
    assert ok
    rl.record_success("1.2.3.4")
    assert rl.get_status("1.2.3.4") is None


# ---- validation / file integrity ----
def test_validators():
    validate_position([1.0, 2.0, 3.0])
    with pytest.raises(ValidationError):
        validate_position([np.inf, 0, 0])
    with pytest.raises(ValidationError):
        validate_position([1, 2])
    with pytest.raises(ValidationError):
        validate_waypoints([])
    out = validate_waypoints([{"position": [0, 0, 1]}, [1, 1, 1]])
    assert len(out) == 2


def test_file_digest(tmp_path):
    f = tmp_path / "cfg.yaml"
    f.write_text("a: 1\n")
    digest = compute_file_digest(f)
    assert verify_file_digest(f, digest)
    f.write_text("a: 2\n")
    assert not verify_file_digest(f, digest)


# ---- DI ----
def test_di_singleton_and_factory():
    c = DIContainer()
    c.register_singleton(dict, lambda _: {"n": 0})
    c.register_factory(list, lambda _: [])
    a, b = c.resolve(dict), c.resolve(dict)
    assert a is b
    assert c.resolve(list) is not c.resolve(list)
    with pytest.raises(DependencyError):
        c.resolve(set)


def test_di_cycle_detection():
    class A: ...

    class B: ...

    c = DIContainer()
    c.register_singleton(A, lambda cc: A(), depends_on=(B,))
    c.register_singleton(B, lambda cc: B(), depends_on=(A,))
    assert c.detect_cycles()
    with pytest.raises(DependencyError):
        c.dependency_order()


def test_default_container_wires_stack():
    from dart_planner_tpu.planning.se3_mpc import SE3MPCPlanner

    c = create_default_container()
    planner = c.resolve(SE3MPCPlanner)
    assert planner.config.prediction_horizon == 20
    assert planner is c.resolve(SE3MPCPlanner)
    order = c.dependency_order()
    assert order.index(type(c.resolve(SE3MPCPlanner))) >= 0


# ---- metrics ----
def test_metrics_summaries():
    m = MetricsManager()
    for v in range(100):
        m.record("plan_ms", v)
    m.increment("solves", 100)
    s = m.summary("plan_ms")
    assert s["count"] == 100 and s["p95"] == pytest.approx(94.05, rel=0.01)
    with m.timer("tick_ms"):
        time.sleep(0.01)
    assert m.summary("tick_ms")["mean"] >= 10.0
    assert m.all_summaries()["counters"]["solves"] == 100


# ---- multiprocess loop ----
def _double(s):
    # module level: the loop's spawned child unpickles it by reference
    return {"double": s["x"] * 2}


def test_process_control_loop():
    loop = ProcessControlLoop(_double, frequency_hz=200.0)
    loop.start()
    try:
        loop.send_state({"x": 21})
        deadline = time.time() + 2.0
        out = None
        while time.time() < deadline:
            out = loop.get_output(timeout=0.1)
            if out:
                break
        assert out == {"double": 42}
        assert loop.running
    finally:
        loop.stop()
    assert not loop.running

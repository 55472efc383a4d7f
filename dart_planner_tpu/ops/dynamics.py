"""Quadrotor translational dynamics: scan rollout + condensed linear maps.

The reference encodes dynamics as equality constraints over a 9N decision
vector (se3_mpc_planner.py:426-462):

    a_k     = T_k / m - [0, 0, g]
    p_{k+1} = p_k + v_k dt + 0.5 a_k dt^2
    v_{k+1} = v_k + a_k dt

(its L-BFGS-B solver cannot actually enforce them — see SURVEY.md 3.1).

This design *eliminates* the dynamics instead: thrust vectors
``u (N, 3)`` are the only decision variables and positions/velocities are
affine functions of ``u``:

    v_k = v0 + S_v a      with  S_v[k, j] = dt            for j < k
    p_k = p0 + k dt v0 + S_p a   with  S_p[k, j] = dt^2 (k - j - 1/2) for j < k

where ``a = u / m + g_vec`` (``g_vec`` is the signed gravity acceleration,
(0,0,-g) in ENU). This turns the MPC into a small dense QP whose Hessian is
constant per configuration — ideal for batched matrix work — and makes every
iterate exactly dynamics-feasible (a strict superset of the reference, which
only satisfies dynamics approximately).

Both a ``lax.scan`` rollout (O(N) depth, used for generic simulation) and the
closed-form matmul rollout (O(1) depth, used inside the solver) are provided;
they agree to float tolerance.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray


@functools.lru_cache(maxsize=32)
def rollout_matrices(N: int, dt: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant maps (S_p, S_v, t) for horizon ``N`` and step ``dt``.

    - ``S_p`` (N, N): acceleration -> position contribution (per axis)
    - ``S_v`` (N, N): acceleration -> velocity contribution (per axis)
    - ``t``   (N,):  k * dt  (drift of p from v0)

    Strictly lower triangular: state k depends on accelerations 0..k-1; the
    final thrust u_{N-1} never enters the dynamics (it only appears in the
    cost), exactly as in the reference transcription.
    """
    k = np.arange(N)[:, None]
    j = np.arange(N)[None, :]
    mask = (j < k).astype(np.float64)
    S_v = dt * mask
    S_p = (dt * dt) * (k - j - 0.5) * mask
    t = (dt * np.arange(N)).astype(np.float64)
    return S_p, S_v, t


def accel_from_thrust(u: Array, mass: float, gravity_vec: Array) -> Array:
    """a_k = u_k / m + g_vec (reference se3_mpc_planner.py:444-447, with the
    sign folded into the frame-aware gravity vector)."""
    return u / mass + gravity_vec


def rollout_linear(
    u: Array,
    p0: Array,
    v0: Array,
    dt: float,
    mass: float,
    gravity_vec: Array,
) -> tuple[Array, Array, Array]:
    """Closed-form rollout: thrusts (..., N, 3) -> (positions, velocities,
    accelerations), each (..., N, 3).

    One batched matmul per state sequence — no sequential dependency, so
    its depth does not grow with the horizon.
    """
    N = u.shape[-2]
    S_p, S_v, t = rollout_matrices(N, float(dt))
    S_p = jnp.asarray(S_p, u.dtype)
    S_v = jnp.asarray(S_v, u.dtype)
    t = jnp.asarray(t, u.dtype)
    a = accel_from_thrust(u, mass, gravity_vec)
    # (..., N, 3) = (N, N) @ (..., N, 3)
    vel = v0[..., None, :] + jnp.einsum(
        "kj,...jd->...kd", S_v, a, precision=jax.lax.Precision.HIGHEST
    )
    pos = p0[..., None, :] + t[:, None] * v0[..., None, :] + jnp.einsum(
        "kj,...jd->...kd", S_p, a, precision=jax.lax.Precision.HIGHEST
    )
    return pos, vel, a


def rollout_scan(
    u: Array,
    p0: Array,
    v0: Array,
    dt: float,
    mass: float,
    gravity_vec: Array,
) -> tuple[Array, Array, Array]:
    """Sequential rollout via ``lax.scan`` (identical semantics to
    :func:`rollout_linear`; used as a cross-check and for models where the
    step is not affine)."""
    a = accel_from_thrust(u, mass, gravity_vec)

    def step(carry, a_k):
        p, v = carry
        p_next = p + v * dt + 0.5 * a_k * dt * dt
        v_next = v + a_k * dt
        return (p_next, v_next), (p, v)

    # state k uses accelerations 0..k-1; emit state before applying a_k
    (_, _), (ps, vs) = jax.lax.scan(step, (p0, v0), jnp.moveaxis(a, -2, 0))
    pos = jnp.moveaxis(ps, 0, -2)
    vel = jnp.moveaxis(vs, 0, -2)
    return pos, vel, a


def simulator_step(
    pos: Array,
    vel: Array,
    att: Array,
    ang_vel: Array,
    thrust: Array,
    torque: Array,
    dt: float,
    mass: float = 1.5,
    gravity: float = 9.81,
    inertia_diag: Array | None = None,
    wind: Array | None = None,
    thrust_along_body_z: bool = False,
) -> tuple[Array, Array, Array, Array]:
    """One Euler step of the point-mass + rigid-rotation simulator.

    ``thrust_along_body_z=False`` reproduces the reference
    ``DroneSimulator.step`` exactly (drone_simulator.py:52-72): thrust acts
    along *world* z (their simplification), semi-implicit Euler
    (velocity first, then position with the new velocity). With
    ``True`` the thrust acts along the body z-axis (full SE(3) model).
    """
    from dart_planner_tpu.ops.so3 import euler_to_rotmat

    if inertia_diag is None:
        inertia_diag = jnp.array([0.1, 0.1, 0.2], dtype=pos.dtype)
    if wind is None:
        wind = jnp.zeros(3, dtype=pos.dtype)

    e3 = jnp.zeros_like(pos).at[..., 2].set(1.0)
    if thrust_along_body_z:
        R = euler_to_rotmat(att)
        thrust_dir = R[..., :, 2]
    else:
        thrust_dir = e3
    acc = (
        -gravity * e3
        + thrust[..., None] / mass * thrust_dir
        + wind / mass
    )
    new_vel = vel + acc * dt
    new_pos = pos + new_vel * dt
    ang_acc = torque / inertia_diag
    new_ang_vel = ang_vel + ang_acc * dt
    new_att = att + new_ang_vel * dt
    return new_pos, new_vel, new_att, new_ang_vel

"""SO(3) operators: hat/vee, Euler/quaternion rotations, thrust-frame
construction, and body-rate extraction.

Branch-free, batched re-designs of the rotation math scattered through the
reference (geometric_controller.py:770-801, se3_mpc_planner.py:604-654).
Every function works on arbitrary leading batch dimensions and is safe under
``jit`` / ``vmap`` — all singularity handling is via ``jnp.where`` masks, not
Python branches.

Convention: Euler angles are (roll, pitch, yaw) with R = Rz(yaw) @ Ry(pitch)
@ Rx(roll) (ZYX extrinsic), matching the reference's
``_euler_to_rotation_matrix`` (geometric_controller.py:770-784).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

Array = jnp.ndarray

_EPS = 1e-6


def mm(a: Array, b: Array) -> Array:
    """fp32 matmul for rotation chains.

    On the GPU, ``a @ b`` on fp32 inputs may run in TF32 (about three
    decimal digits); a 400 Hz closed loop multiplies ~2,400 rotation
    increments per episode, and at reduced precision the attitude
    estimate disintegrates (with bf16 products, Monte-Carlo success fell
    from 0.603 to 0.154). Every rotation-matrix product in this package
    must go through here. The 3x3 shapes are tiny, so HIGHEST costs
    nothing.
    """
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def hat(v: Array) -> Array:
    """Map R^3 -> so(3): v -> [v]_x skew matrix. Batched over leading dims."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(m: Array) -> Array:
    """Inverse of :func:`hat` (reference geometric_controller.py:800)."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def euler_to_rotmat(euler: Array) -> Array:
    """(roll, pitch, yaw) -> R in SO(3), ZYX convention
    (reference geometric_controller.py:770-784)."""
    roll, pitch, yaw = euler[..., 0], euler[..., 1], euler[..., 2]
    cr, sr = jnp.cos(roll), jnp.sin(roll)
    cp, sp = jnp.cos(pitch), jnp.sin(pitch)
    cy, sy = jnp.cos(yaw), jnp.sin(yaw)
    r00 = cy * cp
    r01 = cy * sp * sr - sy * cr
    r02 = cy * sp * cr + sy * sr
    r10 = sy * cp
    r11 = sy * sp * sr + cy * cr
    r12 = sy * sp * cr - cy * sr
    r20 = -sp
    r21 = cp * sr
    r22 = cp * cr
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def rotmat_to_euler(R: Array) -> Array:
    """R -> (roll, pitch, yaw), inverse of :func:`euler_to_rotmat`
    (reference se3_mpc_planner.py:636-638)."""
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    pitch = jnp.arcsin(jnp.clip(-R[..., 2, 0], -1.0, 1.0))
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def quat_to_rotmat(q: Array) -> Array:
    """(w, x, y, z) quaternion -> R; non-normalized input is normalized,
    near-zero quaternions map to identity
    (reference geometric_controller.py:786-798)."""
    norm = jnp.linalg.norm(q, axis=-1, keepdims=True)
    safe = norm > _EPS
    qn = jnp.where(safe, q / jnp.where(safe, norm, 1.0), jnp.zeros_like(q))
    w, x, y, z = qn[..., 0], qn[..., 1], qn[..., 2], qn[..., 3]
    R = jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                axis=-1,
            ),
        ],
        axis=-2,
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), R.shape)
    return jnp.where(safe[..., None], R, eye)


def normalize(v: Array, fallback: Array | None = None) -> Array:
    """Safe normalize: ||v||<eps falls back to ``fallback`` (default e1)."""
    if fallback is None:
        fallback = jnp.zeros_like(v).at[..., 0].set(1.0)
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    safe = n > _EPS
    return jnp.where(safe, v / jnp.where(safe, n, 1.0), fallback)


def thrust_yaw_to_rotmat(thrust_vec: Array, yaw: Array) -> Array:
    """Desired attitude from a world-frame thrust vector and yaw angle.

    The standard differentially-flat quadrotor frame construction used by
    both the planner's attitude extraction (se3_mpc_planner.py:616-634) and
    the controller's desired frame (geometric_controller.py:655-680):

        b3 = thrust / ||thrust||
        c  = (cos yaw, sin yaw, 0)
        b1 = normalize(c x b3);  b2 = b3 x b1;  R = [b1 b2 b3]

    Degeneracies are masked: near-zero thrust -> identity attitude; c nearly
    parallel to b3 -> b1 from projecting e1 onto the plane normal to b3 (the
    reference's "skip_yaw" fallback, geometric_controller.py:206-215).
    """
    tmag = jnp.linalg.norm(thrust_vec, axis=-1, keepdims=True)
    thrust_ok = tmag > _EPS
    b3 = jnp.where(thrust_ok, thrust_vec / jnp.where(thrust_ok, tmag, 1.0),
                   jnp.zeros_like(thrust_vec).at[..., 2].set(1.0))

    c = jnp.stack([jnp.cos(yaw), jnp.sin(yaw), jnp.zeros_like(yaw)], axis=-1)
    b1_raw = jnp.cross(c, b3)
    b1_norm = jnp.linalg.norm(b1_raw, axis=-1, keepdims=True)
    # skip_yaw fallback: project a world axis onto the plane perpendicular
    # to b3. Unlike the reference (which always projects e1 and degenerates
    # when b3 ~ e1, geometric_controller.py:209-215), pick whichever of
    # e1/e2 is less aligned with b3 — always well-conditioned.
    e1 = jnp.zeros_like(b3).at[..., 0].set(1.0)
    e2 = jnp.zeros_like(b3).at[..., 1].set(1.0)
    use_e2 = jnp.abs(b3[..., 0:1]) > 0.9
    axis = jnp.where(use_e2, e2, e1)
    proj = axis - (jnp.sum(axis * b3, axis=-1, keepdims=True)) * b3
    b1_fallback = normalize(proj, fallback=e1)
    cross_ok = b1_norm > _EPS
    b1 = jnp.where(cross_ok, b1_raw / jnp.where(cross_ok, b1_norm, 1.0), b1_fallback)
    b2 = jnp.cross(b3, b1)
    R = jnp.stack([b1, b2, b3], axis=-1)  # columns are b1, b2, b3
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    return jnp.where(thrust_ok[..., None], R, eye)


def attitude_error(R: Array, R_des: Array) -> Array:
    """Geometric attitude error e_R = 0.5 * vee(R_d^T R - R^T R_d)
    (reference geometric_controller.py:681)."""
    Rd_T_R = mm(jnp.swapaxes(R_des, -1, -2), R)
    return 0.5 * vee(Rd_T_R - jnp.swapaxes(Rd_T_R, -1, -2))


def body_rates_from_rotmats(Rs: Array, dt: float | Array) -> Array:
    """Finite-difference body rates omega_k = vee(R_k^T (R_k - R_{k-1}) / dt)
    along a trajectory of rotations, first step zero
    (reference se3_mpc_planner.py:640-649).

    ``Rs``: (..., N, 3, 3) -> omega: (..., N, 3)
    """
    R_prev = jnp.concatenate([Rs[..., :1, :, :], Rs[..., :-1, :, :]], axis=-3)
    R_dot = (Rs - R_prev) / dt
    omega_mat = mm(jnp.swapaxes(Rs, -1, -2), R_dot)
    omega = vee(omega_mat)
    # first step has no predecessor -> zero
    return omega.at[..., 0, :].set(0.0)


def exp_so3(w: Array) -> Array:
    """SO(3) exponential by Rodrigues' formula, Taylor-safe near zero.

    ``w``: (..., 3) rotation vector -> (..., 3, 3) rotation matrix.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 1e-5
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(small, 1.0, theta))
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, theta2)
    )
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * mm(W, W)


def log_so3(R: Array) -> Array:
    """SO(3) logarithm: rotation vector from a rotation matrix (inverse of
    :func:`exp_so3`), numerically safe near identity and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    skew = vee(R - jnp.swapaxes(R, -1, -2))  # = 2 sin(theta) * axis
    small = theta < 1e-5
    # w = theta / (2 sin theta) * vee(R - R^T); series for small theta
    scale = jnp.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / jnp.where(small, 1.0, 2.0 * jnp.sin(jnp.where(small, 1.0, theta))),
    )
    w = scale[..., None] * skew
    # near pi the skew part vanishes; fall back to the diagonal formula
    near_pi = theta > jnp.pi - 1e-3
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis2 = jnp.maximum((diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + 1e-12), 0.0)
    axis = jnp.sqrt(axis2)
    # fix signs from off-diagonal sums
    sx = jnp.where(R[..., 2, 1] - R[..., 1, 2] >= 0, 1.0, -1.0)
    sy = jnp.where(R[..., 0, 2] - R[..., 2, 0] >= 0, 1.0, -1.0)
    sz = jnp.where(R[..., 1, 0] - R[..., 0, 1] >= 0, 1.0, -1.0)
    axis = axis * jnp.stack([sx, sy, sz], axis=-1)
    w_pi = theta[..., None] * axis
    return jnp.where(near_pi[..., None], w_pi, w)

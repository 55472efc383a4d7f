"""Jittable extended Kalman filter for translational state.

New capability beyond the reference (which only *consumes* PX4's EKF2
output): a 9-state EKF (position, velocity, accelerometer bias) with a
constant-acceleration process model, usable per-vehicle or vmapped over
a fleet. All operations are fixed-shape matrix math, so a 100k-vehicle
filter bank is one batched 9x9 pipeline.

State x = [p (3), v (3), b_a (3)]; inputs are body-frame specific force
rotated to world by the known attitude (from the attitude loop) plus
gravity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dart_planner_tpu.common.types import pytree_dataclass

Array = jnp.ndarray


class EKFConfig(NamedTuple):
    accel_noise: float = 0.5  # m/s^2 process noise on acceleration
    bias_noise: float = 0.01  # random-walk on accel bias
    pos_meas_noise: float = 0.05  # m (e.g. mocap/GPS-RTK)
    vel_meas_noise: float = 0.1  # m/s


@pytree_dataclass
class EKFState:
    x: Array  # (..., 9)
    P: Array  # (..., 9, 9)


def ekf_init(
    position,
    velocity=None,
    pos_var: float = 1.0,
    vel_var: float = 1.0,
    bias_var: float = 0.01,
    dtype=jnp.float32,
) -> EKFState:
    p = jnp.asarray(position, dtype)
    v = (
        jnp.asarray(velocity, dtype)
        if velocity is not None
        else jnp.zeros_like(p)
    )
    batch = p.shape[:-1]
    x = jnp.concatenate([p, v, jnp.zeros_like(p)], axis=-1)
    P = jnp.zeros(batch + (9, 9), dtype)
    idx = jnp.arange(9)
    diag = jnp.concatenate(
        [
            jnp.full((3,), pos_var, dtype),
            jnp.full((3,), vel_var, dtype),
            jnp.full((3,), bias_var, dtype),
        ]
    )
    P = P.at[..., idx, idx].set(diag)
    return EKFState(x=x, P=P)


@functools.partial(jax.jit, static_argnames=("config",))
def ekf_predict(
    config: EKFConfig, state: EKFState, accel_world: Array, dt
) -> EKFState:
    """Propagate with measured world-frame acceleration (bias-corrected)."""
    dtype = state.x.dtype
    dt = jnp.asarray(dt, dtype)
    p, v, b = state.x[..., 0:3], state.x[..., 3:6], state.x[..., 6:9]
    a = accel_world - b
    p2 = p + v * dt + 0.5 * a * dt * dt
    v2 = v + a * dt
    x2 = jnp.concatenate([p2, v2, b], axis=-1)

    eye3 = jnp.eye(3, dtype=dtype)
    zero3 = jnp.zeros((3, 3), dtype)
    # F = d(x2)/d(x): p depends on v (dt) and b (-dt^2/2); v on b (-dt)
    F = jnp.block(
        [
            [eye3, eye3 * dt, -0.5 * eye3 * dt * dt],
            [zero3, eye3, -eye3 * dt],
            [zero3, zero3, eye3],
        ]
    )
    qa = config.accel_noise**2
    qb = config.bias_noise**2
    # discrete white-noise-acceleration Q
    Q = jnp.block(
        [
            [eye3 * qa * dt**4 / 4, eye3 * qa * dt**3 / 2, zero3],
            [eye3 * qa * dt**3 / 2, eye3 * qa * dt**2, zero3],
            [zero3, zero3, eye3 * qb * dt],
        ]
    )
    # fp32 matmuls: a TF32 default would drift P off symmetric-PSD
    with jax.default_matmul_precision("highest"):
        P2 = F @ state.P @ F.T + Q
    return EKFState(x=x2, P=P2)


def _kalman_update(state: EKFState, H: Array, z: Array, R: Array) -> EKFState:
    with jax.default_matmul_precision("highest"):
        y = z - jnp.einsum("ij,...j->...i", H, state.x)
        S = H @ state.P @ H.T + R
        K = state.P @ H.T @ jnp.linalg.inv(S)
        x2 = state.x + jnp.einsum("...ij,...j->...i", K, y)
        eye = jnp.eye(state.x.shape[-1], dtype=state.x.dtype)
        P2 = (eye - K @ H) @ state.P
    return EKFState(x=x2, P=P2)


@functools.partial(jax.jit, static_argnames=("config",))
def ekf_update_position(
    config: EKFConfig, state: EKFState, pos_meas: Array
) -> EKFState:
    dtype = state.x.dtype
    H = jnp.concatenate(
        [jnp.eye(3, dtype=dtype), jnp.zeros((3, 6), dtype)], axis=1
    )
    R = jnp.eye(3, dtype=dtype) * config.pos_meas_noise**2
    return _kalman_update(state, H, jnp.asarray(pos_meas, dtype), R)


@functools.partial(jax.jit, static_argnames=("config",))
def ekf_update_velocity(
    config: EKFConfig, state: EKFState, vel_meas: Array
) -> EKFState:
    dtype = state.x.dtype
    H = jnp.concatenate(
        [
            jnp.zeros((3, 3), dtype),
            jnp.eye(3, dtype=dtype),
            jnp.zeros((3, 3), dtype),
        ],
        axis=1,
    )
    R = jnp.eye(3, dtype=dtype) * config.vel_meas_noise**2
    return _kalman_update(state, H, jnp.asarray(vel_meas, dtype), R)

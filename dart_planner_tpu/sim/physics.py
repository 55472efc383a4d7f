"""Jittable drone physics.

Two models, mirroring the reference's range:

- ``point_mass_step``: thrust-z only + wind, the reference
  ``DroneSimulator.step`` (utils/drone_simulator.py:52-72) — but the
  thrust here is applied along the body z-axis from the attitude, fixing
  the reference's world-z-only simplification when attitude is nonzero.
  Set ``body_frame_thrust=False`` in :class:`PhysicsConfig` for strict
  reference behavior.
- ``rigid_body_step``: full SE(3) rigid body (R in SO(3), Euler-integrated
  with a rotation-vector exponential, inertia-coupled angular dynamics),
  the model the geometric controller is actually designed for.

Both are pure (state, command, wind, dt) -> state and batch over any
leading dims.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dart_planner_tpu.common import frames
from dart_planner_tpu.common.types import ControlCommand, DroneState
from dart_planner_tpu.ops import so3

Array = jnp.ndarray


class PhysicsConfig(NamedTuple):
    """Static physics parameters (reference DroneSimulator.__init__:40-49
    and SimulatorConfig:14-33)."""

    mass: float = 1.5  # kg
    gravity: float = 9.81
    # hardware.yaml inertia (the reference DroneSimulator hard-codes a 5x
    # heavier diag(0.1,0.1,0.2) inconsistent with its own controller tuning)
    inertia: tuple = (0.02, 0.02, 0.04)  # diag, kg m^2
    max_thrust: float = 20.0  # N
    max_torque: float = 10.0  # N m
    drag_coefficient: float = 0.0  # linear drag / mass
    body_frame_thrust: bool = True


class RigidBodyState(NamedTuple):
    """Full rigid-body state with a rotation matrix (no Euler drift)."""

    position: Array  # (..., 3)
    velocity: Array  # (..., 3)
    rotation: Array  # (..., 3, 3)
    angular_velocity: Array  # (..., 3) body frame

    @classmethod
    def from_drone_state(cls, s: DroneState) -> "RigidBodyState":
        return cls(
            position=s.position,
            velocity=s.velocity,
            rotation=so3.euler_to_rotmat(s.attitude),
            angular_velocity=s.angular_velocity,
        )

    def to_drone_state(self, timestamp) -> DroneState:
        return DroneState(
            timestamp=jnp.asarray(timestamp, self.position.dtype),
            position=self.position,
            velocity=self.velocity,
            attitude=so3.rotmat_to_euler(self.rotation),
            angular_velocity=self.angular_velocity,
        )


def sample_wind(key, batch_shape: tuple, mean: float, std: float, dtype=jnp.float32):
    """Constant-per-episode wind vector (reference wind knobs,
    SimulatorConfig:29-31 / test_monte_carlo_sim.py)."""
    direction = jax.random.normal(key, batch_shape + (3,), dtype)
    direction = direction / jnp.maximum(
        jnp.linalg.norm(direction, axis=-1, keepdims=True), 1e-9
    )
    kmag, _ = jax.random.split(key)
    mag = mean + std * jax.random.normal(kmag, batch_shape + (1,), dtype)
    return direction * mag


def point_mass_step(
    config: PhysicsConfig,
    state: DroneState,
    command: ControlCommand,
    dt,
    wind: Array | None = None,
) -> DroneState:
    """Semi-implicit Euler point-mass step (reference step(), :52-72)."""
    dtype = state.position.dtype
    dt = jnp.asarray(dt, dtype)
    thrust = jnp.clip(command.thrust, 0.0, config.max_thrust)
    torque = jnp.clip(command.torque, -config.max_torque, config.max_torque)
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, config.gravity).astype(dtype)

    if config.body_frame_thrust:
        R = so3.euler_to_rotmat(state.attitude)
        thrust_dir = R[..., :, 2]
    else:
        thrust_dir = jnp.zeros_like(state.position).at[..., 2].set(1.0)
    acc = gvec + thrust_dir * (thrust[..., None] / config.mass)
    if wind is not None:
        acc = acc + wind / config.mass
    if config.drag_coefficient > 0:
        acc = acc - config.drag_coefficient * state.velocity

    vel = state.velocity + acc * dt
    pos = state.position + vel * dt
    inertia = jnp.asarray(config.inertia, dtype)
    ang_acc = torque / inertia
    omega = state.angular_velocity + ang_acc * dt
    att = state.attitude + omega * dt
    return DroneState(
        timestamp=state.timestamp + dt,
        position=pos,
        velocity=vel,
        attitude=att,
        angular_velocity=omega,
    )


def rigid_body_step(
    config: PhysicsConfig,
    state: RigidBodyState,
    command: ControlCommand,
    dt,
    wind: Array | None = None,
) -> RigidBodyState:
    """Full SE(3) step: thrust along body z, exact SO(3) exponential for the
    attitude update, Euler-equation angular dynamics with gyroscopic term."""
    dtype = state.position.dtype
    dt = jnp.asarray(dt, dtype)
    thrust = jnp.clip(command.thrust, 0.0, config.max_thrust)
    torque = jnp.clip(command.torque, -config.max_torque, config.max_torque)
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, config.gravity).astype(dtype)

    b3 = state.rotation[..., :, 2]
    acc = gvec + b3 * (thrust[..., None] / config.mass)
    if wind is not None:
        acc = acc + wind / config.mass
    if config.drag_coefficient > 0:
        acc = acc - config.drag_coefficient * state.velocity
    vel = state.velocity + acc * dt
    pos = state.position + vel * dt

    inertia = jnp.asarray(config.inertia, dtype)
    gyro = jnp.cross(state.angular_velocity, inertia * state.angular_velocity)
    ang_acc = (torque - gyro) / inertia
    omega = state.angular_velocity + ang_acc * dt
    # so3.mm: fp32 product — a reduced-precision (TF32/bf16) matmul
    # destroys the attitude over a 2,400-tick episode
    R = so3.mm(state.rotation, so3.exp_so3(omega * dt))
    return RigidBodyState(position=pos, velocity=vel, rotation=R, angular_velocity=omega)

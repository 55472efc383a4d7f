"""Typed state / trajectory / command pytrees.

Re-design of the reference's ``common/types.py``
(/root/reference/src/dart_planner/common/types.py:63,102,115,127): instead of
pint-united dataclasses plus a separate unit-stripped ``FastDroneState`` for
hot loops, there is exactly one representation — JAX pytrees of SI-unit
arrays — which is simultaneously the "fast" type (no unit objects anywhere
near jit) and the API type (unit discipline is enforced by convention and by
:func:`dart_planner_tpu.common.units.ensure_si` at system boundaries).

All types are :func:`pytree_dataclass` classes: frozen dataclasses
registered as pytrees (``jax.tree_util.register_dataclass``), and therefore
directly usable under ``jit`` / ``vmap`` / ``lax.scan``. Every field
may carry leading batch dimensions, so a ``DroneState`` can be one vehicle or
a 100k-scenario fleet with no code change.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def static_field(**kwargs):
    """A dataclass field kept out of the pytree leaves (hashed into the
    treedef, so a change retraces)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``replace(**kw)``.
    Fields made with :func:`static_field` are metadata, all others
    leaves."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


@pytree_dataclass
class DroneState:
    """Complete vehicle state at an instant (SI units).

    Mirrors reference ``DroneState`` (types.py:63) and ``FastDroneState``
    (types.py:28) in one pytree.

    - ``timestamp``:        s
    - ``position``:         m         (..., 3)
    - ``velocity``:         m/s       (..., 3)
    - ``attitude``:         rad       (..., 3) roll, pitch, yaw
    - ``angular_velocity``: rad/s     (..., 3)
    """

    timestamp: Array
    position: Array
    velocity: Array
    attitude: Array
    angular_velocity: Array

    @classmethod
    def zeros(cls, batch_shape: tuple = (), dtype=jnp.float32) -> "DroneState":
        v3 = jnp.zeros(batch_shape + (3,), dtype)
        return cls(
            timestamp=jnp.zeros(batch_shape, dtype),
            position=v3,
            velocity=v3,
            attitude=v3,
            angular_velocity=v3,
        )

    @classmethod
    def create(
        cls,
        timestamp=0.0,
        position=(0.0, 0.0, 0.0),
        velocity=(0.0, 0.0, 0.0),
        attitude=(0.0, 0.0, 0.0),
        angular_velocity=(0.0, 0.0, 0.0),
        dtype=jnp.float32,
    ) -> "DroneState":
        return cls(
            timestamp=jnp.asarray(timestamp, dtype),
            position=jnp.asarray(position, dtype),
            velocity=jnp.asarray(velocity, dtype),
            attitude=jnp.asarray(attitude, dtype),
            angular_velocity=jnp.asarray(angular_velocity, dtype),
        )


@pytree_dataclass
class ControlCommand:
    """Low-level controller output (reference types.py:102).

    - ``thrust``: N      (...,)   collective thrust magnitude
    - ``torque``: N*m    (..., 3) body roll/pitch/yaw moments
    """

    thrust: Array
    torque: Array

    @classmethod
    def zeros(cls, batch_shape: tuple = (), dtype=jnp.float32) -> "ControlCommand":
        return cls(
            thrust=jnp.zeros(batch_shape, dtype),
            torque=jnp.zeros(batch_shape + (3,), dtype),
        )


@pytree_dataclass
class BodyRateCommand:
    """PX4-offboard style command (reference types.py:115).

    - ``thrust``: normalized [0, 1]
    - ``body_rates``: rad/s (..., 3)
    """

    thrust: Array
    body_rates: Array


@pytree_dataclass
class Trajectory:
    """Time-indexed desired-state sequence from the planner
    (reference types.py:127).

    Shapes: ``timestamps`` (..., N); vector fields (..., N, 3);
    ``thrusts``/``yaws``/``yaw_rates`` (..., N).
    """

    timestamps: Array
    positions: Array
    velocities: Optional[Array] = None
    accelerations: Optional[Array] = None
    attitudes: Optional[Array] = None
    body_rates: Optional[Array] = None
    thrusts: Optional[Array] = None
    yaws: Optional[Array] = None
    yaw_rates: Optional[Array] = None

    @property
    def horizon(self) -> int:
        return self.timestamps.shape[-1]


@pytree_dataclass
class Pose:
    """Position + orientation (reference types.py:10)."""

    position: Array
    orientation: Array  # roll, pitch, yaw (rad)


@pytree_dataclass
class Twist:
    """Linear + angular velocity (reference types.py:16)."""

    linear: Array
    angular: Array


@pytree_dataclass
class Accel:
    """Linear + angular acceleration (reference types.py:22)."""

    linear: Array
    angular: Array


@pytree_dataclass
class EstimatedState:
    """Standardized state-estimator output (reference types.py:142)."""

    timestamp: Array
    pose: Pose
    twist: Twist
    accel: Accel
    source: str = static_field(default="unknown")

    def to_drone_state(self) -> DroneState:
        return DroneState(
            timestamp=self.timestamp,
            position=self.pose.position,
            velocity=self.twist.linear,
            attitude=self.pose.orientation,
            angular_velocity=self.twist.angular,
        )

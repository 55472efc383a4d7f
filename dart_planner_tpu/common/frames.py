"""ENU / NED world-frame management.

Equivalent of the reference's ``coordinate_frames.py``
(/root/reference/src/dart_planner/common/coordinate_frames.py:46-140): frozen
transform constants plus a tiny functional manager. Gravity-vector sign
consistency is the load-bearing behavior (the geometric controller computes
``thrust_vector = acc_des - gravity_vector``; reference
geometric_controller.py:108-121,460).

The default world frame is ENU (z up), matching config/defaults.yaml
``coordinate_frame.world_frame: ENU``.
"""

from __future__ import annotations

import enum
import threading

import jax.numpy as jnp
import numpy as np


class WorldFrame(str, enum.Enum):
    ENU = "ENU"  # x east, y north, z up
    NED = "NED"  # x north, y east, z down


# ENU <-> NED: swap x/y, negate z. The matrix is its own inverse.
ENU_TO_NED = np.array(
    [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]], dtype=np.float64
)
NED_TO_ENU = ENU_TO_NED.T  # == ENU_TO_NED

GRAVITY_MAGNITUDE = 9.81  # m/s^2, matches reference vehicle params


def gravity_vector(frame: WorldFrame = WorldFrame.ENU, magnitude: float = GRAVITY_MAGNITUDE):
    """Gravity acceleration vector expressed in the given world frame.

    ENU: (0, 0, -g) — gravity pulls down, z is up.
    NED: (0, 0, +g) — z is down.
    (reference coordinate_frames.py get_gravity_vector)
    """
    sign = -1.0 if frame == WorldFrame.ENU else 1.0
    return jnp.array([0.0, 0.0, sign * magnitude])


def up_vector(frame: WorldFrame = WorldFrame.ENU):
    sign = 1.0 if frame == WorldFrame.ENU else -1.0
    return jnp.array([0.0, 0.0, sign])


def enu_to_ned(v):
    return v[..., jnp.array([1, 0, 2])] * jnp.array([1.0, 1.0, -1.0])


def ned_to_enu(v):
    return v[..., jnp.array([1, 0, 2])] * jnp.array([1.0, 1.0, -1.0])


class CoordinateFrameManager:
    """Thread-local frame context for multi-sim tests
    (reference coordinate_frames.py:120-140)."""

    _local = threading.local()

    def __init__(self, frame: WorldFrame = WorldFrame.ENU):
        self.world_frame = frame

    def get_gravity_vector(self, magnitude: float = GRAVITY_MAGNITUDE):
        return gravity_vector(self.world_frame, magnitude)

    def get_up_vector(self):
        return up_vector(self.world_frame)

    def __enter__(self):
        self._prev = getattr(self._local, "manager", None)
        self._local.manager = self
        return self

    def __exit__(self, *exc):
        self._local.manager = self._prev
        return False


def get_coordinate_frame_manager() -> CoordinateFrameManager:
    mgr = getattr(CoordinateFrameManager._local, "manager", None)
    if mgr is None:
        mgr = CoordinateFrameManager()
        CoordinateFrameManager._local.manager = mgr
    return mgr

"""Geometric SE(3) controller, functional and batched.

Re-design of the reference ``GeometricController``
(/root/reference/src/dart_planner/control/geometric_controller.py). The
control law is identical —

    acc_des = ff_acc + Kp e_p + Kd e_v + Ki (integral of e_v)        (:452-458)
    f_world = acc_des - g_vec;  T = ||f_world|| clipped               (:460-474)
    b3 tilt-limited                                                   (:491-496)
    e_R = 0.5 vee(R_d^T R - R^T R_d)                                  (:681)
    tau = -K_R e_R - K_Omega e_Omega + Omega x (I Omega)              (:690)

— but the implementation is a pure function ``(config, ctrl_state, inputs)
-> (command, ctrl_state')`` with *no* Python branches in the hot path:
yaw-singularity fallback, saturation, anti-windup, and failsafe are all
``jnp.where`` masks, so one jitted executable serves the 1 kHz single-vehicle
loop and a vmapped fleet of controllers. Gains default to the reference's
transport-delay-retuned values (:38-47).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.common import frames
from dart_planner_tpu.common.types import (
    BodyRateCommand,
    ControlCommand,
    DroneState,
    pytree_dataclass,
)
from dart_planner_tpu.ops import so3

Array = jnp.ndarray


class GeometricConfig(NamedTuple):
    """Static gains/limits (reference GeometricControllerConfig :25-76).

    Tuples (not arrays) so the config is hashable and can close over jit.
    """

    kp_pos: tuple = (7.0, 7.0, 8.5)
    ki_pos: tuple = (0.35, 0.35, 0.7)
    kd_pos: tuple = (4.2, 4.2, 5.6)
    kp_att: tuple = (9.0, 9.0, 3.75)
    kd_att: tuple = (3.0, 3.0, 1.5)
    inertia: tuple = (0.02, 0.02, 0.04)
    max_torque_xyz: tuple = (5.4, 5.4, 0.36)  # from hardware.yaml geometry
    ff_pos: float = 1.2
    ff_vel: float = 0.8
    max_integral_pos: float = 5.0
    max_tilt_angle: float = float(np.pi / 3)
    mass: float = 1.0  # reference vehicle_params default mass
    gravity: float = 9.81
    max_thrust: float = 20.0
    min_thrust: float = 0.5  # fraction of hover (ref :468: min*m*g)
    tracking_error_threshold: float = 2.0
    velocity_error_threshold: float = 1.0
    anti_windup_method: str = "clamping"  # or "back_calculation"
    max_integral_per_axis: tuple = (2.0, 2.0, 3.0)
    back_calculation_gain: float = 0.1
    integral_decay_factor: float = 0.99
    saturation_threshold: float = 0.95
    yaw_singularity_threshold: float = 0.1
    default_heading_yaw: float = 0.0
    failsafe_trigger_count: int = 100
    # "lee": standard desired frame b2 = b3 x c, b1 = b2 x b3 (identity at
    # hover). "reference": bug-compatible b1 = c x b3 (reference
    # geometric_controller.py:374), which yaws the desired frame -90 deg
    # and commands a saturated yaw torque at hover.
    yaw_convention: str = "lee"


@pytree_dataclass
class ControllerState:
    """Explicit controller state pytree (the reference keeps these as
    mutable attributes, geometric_controller.py:91-105)."""

    integral_vel_error: Array  # (..., 3)
    last_thrust_saturated: Array  # (...,) bool
    last_torque_saturated: Array  # (..., 3) bool
    unsaturated_thrust: Array  # (...,)
    unsaturated_torque: Array  # (..., 3)
    failsafe_count: Array  # (...,) int32
    failsafe_active: Array  # (...,) bool
    last_valid_thrust: Array  # (...,)
    last_time: Array  # (...,)

    @classmethod
    def zeros(cls, config: GeometricConfig, batch_shape: tuple = (), dtype=jnp.float32):
        return cls(
            integral_vel_error=jnp.zeros(batch_shape + (3,), dtype),
            last_thrust_saturated=jnp.zeros(batch_shape, bool),
            last_torque_saturated=jnp.zeros(batch_shape + (3,), bool),
            unsaturated_thrust=jnp.zeros(batch_shape, dtype),
            unsaturated_torque=jnp.zeros(batch_shape + (3,), dtype),
            failsafe_count=jnp.zeros(batch_shape, jnp.int32),
            failsafe_active=jnp.zeros(batch_shape, bool),
            last_valid_thrust=jnp.full(
                batch_shape, config.mass * config.gravity, dtype
            ),
            last_time=jnp.full(batch_shape, -1.0, dtype),
        )


class ControlSetpoint(NamedTuple):
    """Desired state fed to the controller (from the trajectory smoother)."""

    position: Array
    velocity: Array
    acceleration: Array
    yaw: Array
    yaw_rate: Array

    @classmethod
    def hover_at(cls, position, dtype=jnp.float32):
        p = jnp.asarray(position, dtype)
        z3 = jnp.zeros_like(p)
        z = jnp.zeros(p.shape[:-1], dtype)
        return cls(position=p, velocity=z3, acceleration=z3, yaw=z, yaw_rate=z)


def _desired_frame(config: GeometricConfig, b3_des: Array, yaw_des: Array) -> Array:
    """Desired rotation with branch-free yaw-singularity fallback.

    Normal case: b1 = normalize(c x b3) with c = (cos yaw, sin yaw, 0)
    (ref :671-678). When |c . b3| >= yaw_singularity_threshold the reference
    falls back to "skip_yaw": b1 from projecting e1 onto b3's orthogonal
    plane (ref :206-215). Both are computed and selected by mask.
    """
    c = jnp.stack(
        [jnp.cos(yaw_des), jnp.sin(yaw_des), jnp.zeros_like(yaw_des)], axis=-1
    )
    cos_angle = jnp.abs(jnp.sum(c * b3_des, axis=-1))
    singular = cos_angle >= config.yaw_singularity_threshold

    if config.yaw_convention == "reference":
        # bug-compatible: b1 = c x b3 (see class docstring note)
        b1_normal_raw = jnp.cross(c, b3_des)
    else:
        # standard Lee construction: b1 = (b3 x c) x b3 = c projected onto
        # the plane perpendicular to b3 -> identity frame at hover
        b1_normal_raw = jnp.cross(jnp.cross(b3_des, c), b3_des)
    n1 = jnp.linalg.norm(b1_normal_raw, axis=-1, keepdims=True)
    ok = n1 > 1e-6
    e1 = jnp.zeros_like(b3_des).at[..., 0].set(1.0)
    b1_unit = b1_normal_raw / jnp.where(ok, n1, 1.0)
    b1_normal = jnp.where(ok, b1_unit, e1)

    # skip_yaw fallback: project e1 onto plane perpendicular to b3
    straight = jnp.abs(b3_des[..., 2:3]) >= 0.99
    proj = e1 - jnp.sum(e1 * b3_des, axis=-1, keepdims=True) * b3_des
    b1_skip = so3.normalize(proj, fallback=e1)
    b1_skip = jnp.where(straight, e1, b1_skip)

    b1 = jnp.where(singular[..., None], b1_skip, b1_normal)
    b2 = jnp.cross(b3_des, b1)
    return jnp.stack([b1, b2, b3_des], axis=-1)


def _tilt_limit(config: GeometricConfig, b3: Array) -> Array:
    """Tilt-angle limiting, azimuth-preserving.

    The reference scales x/y by cos(max)/b3_z (ref :334-339) — when the
    commanded direction dips below the horizon (b3_z <= 0) that scale is
    negative and INVERTS the lateral direction, turning the position loop
    into positive feedback. Here the over-tilt branch projects to the
    max-tilt cone keeping the lateral azimuth: (sin_max * unit(xy),
    cos_max), which equals the reference result whenever b3_z > 0.
    """
    cos_max = jnp.cos(config.max_tilt_angle)
    sin_max = jnp.sin(config.max_tilt_angle)
    over = b3[..., 2] < cos_max  # tilt angle > max
    xy = b3[..., :2]
    xy_norm = jnp.linalg.norm(xy, axis=-1, keepdims=True)
    dir_xy = xy / jnp.maximum(xy_norm, 1e-9)
    b3_lim = jnp.concatenate(
        [sin_max * dir_xy, jnp.broadcast_to(cos_max, b3[..., 2:3].shape)],
        axis=-1,
    )
    return jnp.where(over[..., None], b3_lim, b3)


def compute_control(
    config: GeometricConfig,
    state: ControllerState,
    drone: DroneState,
    setpoint: ControlSetpoint,
    dt: Array | float = 0.001,
) -> tuple[ControlCommand, ControllerState]:
    """One control tick. Pure, jittable, batched.

    Returns the command and the updated controller state. Invalid dt
    (<=0 or >0.1 s) or persistent tracking failure produce the failsafe
    command (last valid thrust, zero torque) exactly like the reference
    (:442-443, :485-486, :803-819), selected by mask.
    """
    dtype = drone.position.dtype
    dt = jnp.asarray(dt, dtype)
    kp = jnp.asarray(config.kp_pos, dtype)
    ki = jnp.asarray(config.ki_pos, dtype)
    kd = jnp.asarray(config.kd_pos, dtype)
    kp_att = jnp.asarray(config.kp_att, dtype)
    kd_att = jnp.asarray(config.kd_att, dtype)
    inertia = jnp.asarray(config.inertia, dtype)
    max_torque = jnp.asarray(config.max_torque_xyz, dtype)
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, config.gravity).astype(dtype)

    pos_error = setpoint.position - drone.position
    vel_error = setpoint.velocity - drone.velocity
    pos_err_mag = jnp.linalg.norm(pos_error, axis=-1)
    vel_err_mag = jnp.linalg.norm(vel_error, axis=-1)

    # --- desired acceleration: PID + feedforward (ref :452-458) ---
    acc_pid = kp * pos_error + kd * vel_error + ki * state.integral_vel_error
    acc_des = setpoint.acceleration + acc_pid

    # --- thrust vector and magnitude (ref :300-320) ---
    # NOTE deviation: the reference computes thrust = ||acc_des - g||
    # WITHOUT the mass factor (geometric_controller.py:301-302), which is
    # only dimensionally correct for a 1 kg vehicle — flown against its own
    # 1.5 kg simulator it steadily sinks. Newtons require m * ||a||.
    f_world = acc_des - gvec
    thrust_mag_raw = config.mass * jnp.linalg.norm(f_world, axis=-1)
    min_thrust = config.min_thrust * config.mass * config.gravity
    thrust_mag = jnp.clip(thrust_mag_raw, min_thrust, config.max_thrust)
    thrust_saturated = thrust_mag_raw != thrust_mag

    # --- integral update with anti-windup (ref :536-625) ---
    integral_update = vel_error * dt
    if config.anti_windup_method == "clamping":
        # saturated axes accumulate at 10% (ref :566-582)
        damp = jnp.where(thrust_saturated[..., None], 0.1, 1.0)
        damp = damp * jnp.where(state.last_torque_saturated, 0.1, 1.0)
        integral_update = integral_update * damp
    else:  # back_calculation (ref :584-606)
        Kb = config.back_calculation_gain
        thrust_fb = jnp.where(
            thrust_saturated,
            (state.unsaturated_thrust - config.max_thrust) * Kb,
            0.0,
        )
        integral_update = integral_update - thrust_fb[..., None] * jnp.asarray(
            [0.33, 0.33, 0.34], dtype
        )
        torque_fb = jnp.where(
            state.last_torque_saturated,
            (state.unsaturated_torque - max_torque) * Kb,
            0.0,
        )
        integral_update = integral_update - torque_fb * 0.5

    integral = state.integral_vel_error + integral_update
    # per-axis clamp (ref :608-616)
    per_axis = jnp.asarray(config.max_integral_per_axis, dtype)
    integral = jnp.clip(integral, -per_axis, per_axis)
    # norm clamp (ref :617-620)
    mag = jnp.linalg.norm(integral, axis=-1, keepdims=True)
    integral = jnp.where(
        mag > config.max_integral_pos,
        integral * (config.max_integral_pos / jnp.maximum(mag, 1e-9)),
        integral,
    )
    # decay near limits (ref :622-625)
    near = jnp.abs(integral) > per_axis * config.saturation_threshold
    integral = jnp.where(near, integral * config.integral_decay_factor, integral)

    # --- desired thrust direction with tilt limit (ref :487-496) ---
    up = jnp.zeros_like(f_world).at[..., 2].set(1.0)
    tm_ok = thrust_mag > 1e-6
    b3_des = jnp.where(
        tm_ok[..., None],
        f_world / jnp.maximum(thrust_mag_raw, 1e-9)[..., None],
        up,
    )
    b3_des = so3.normalize(b3_des, fallback=up)
    b3_des = _tilt_limit(config, b3_des)

    # --- geometric attitude control (ref :643-704) ---
    R = so3.euler_to_rotmat(drone.attitude)
    R_des = _desired_frame(config, b3_des, setpoint.yaw)
    eR = so3.attitude_error(R, R_des)
    omega_des = jnp.stack(
        [
            jnp.zeros_like(setpoint.yaw_rate),
            jnp.zeros_like(setpoint.yaw_rate),
            setpoint.yaw_rate,
        ],
        axis=-1,
    )
    eOmega = drone.angular_velocity - omega_des
    coriolis = jnp.cross(
        drone.angular_velocity, inertia * drone.angular_velocity
    )
    torque_raw = -kp_att * eR - kd_att * eOmega + coriolis
    torque = jnp.clip(torque_raw, -max_torque, max_torque)
    torque_saturated = torque_raw != torque

    # --- failsafe logic (ref :633-641, :803-819) ---
    bad_tracking = (pos_err_mag > config.tracking_error_threshold) & (
        vel_err_mag > config.velocity_error_threshold
    )
    failsafe_count = jnp.where(
        bad_tracking,
        state.failsafe_count + 1,
        jnp.maximum(state.failsafe_count - 1, 0),
    )
    dt_invalid = (dt <= 0) | (dt > 0.1)
    failsafe = dt_invalid | (failsafe_count > config.failsafe_trigger_count)

    thrust_out = jnp.where(failsafe, state.last_valid_thrust, thrust_mag)
    torque_out = jnp.where(failsafe[..., None], 0.0, torque)

    new_state = ControllerState(
        integral_vel_error=jnp.where(failsafe[..., None], 0.0, integral),
        last_thrust_saturated=thrust_saturated,
        last_torque_saturated=torque_saturated,
        unsaturated_thrust=thrust_mag_raw,
        unsaturated_torque=torque_raw,
        failsafe_count=failsafe_count,
        failsafe_active=failsafe,
        last_valid_thrust=jnp.where(failsafe, state.last_valid_thrust, thrust_mag),
        last_time=drone.timestamp,
    )
    return ControlCommand(thrust=thrust_out, torque=torque_out), new_state


def compute_body_rate_command(
    config: GeometricConfig,
    state: ControllerState,
    drone: DroneState,
    setpoint: ControlSetpoint,
    dt: Array | float = 0.001,
) -> tuple[BodyRateCommand, ControllerState]:
    """PX4-offboard body-rate command (ref :706-726): integrate the torque
    through the nominal inertia for one tick and normalize thrust."""
    cmd, new_state = compute_control(config, state, drone, setpoint, dt)
    inertia = jnp.asarray([0.1, 0.1, 0.2], drone.position.dtype)  # ref :718
    ang_acc = cmd.torque / inertia
    rates = drone.angular_velocity + ang_acc * 0.001
    thrust_norm = jnp.clip(cmd.thrust / config.max_thrust, 0.0, 1.0)
    return BodyRateCommand(thrust=thrust_norm, body_rates=rates), new_state


class GeometricController:
    """Stateful facade mirroring the reference class API
    (geometric_controller.py:78) over the pure function. Applies failsafe
    gain-halving on first activation (ref :803-819), which is inherently
    stateful and so lives here rather than in the jitted path."""

    def __init__(self, config: GeometricConfig | None = None):
        self.config = config or GeometricConfig()
        self.state = ControllerState.zeros(self.config)
        self._was_failsafe = False
        self.position_errors: list[float] = []
        self.velocity_errors: list[float] = []

    def compute_control(
        self, drone: DroneState, desired_pos, desired_vel, desired_acc,
        desired_yaw=0.0, desired_yaw_rate=0.0,
    ) -> ControlCommand:
        dtype = drone.position.dtype
        sp = ControlSetpoint(
            position=jnp.asarray(desired_pos, dtype),
            velocity=jnp.asarray(desired_vel, dtype),
            acceleration=jnp.asarray(desired_acc, dtype),
            yaw=jnp.asarray(desired_yaw, dtype),
            yaw_rate=jnp.asarray(desired_yaw_rate, dtype),
        )
        last = float(self.state.last_time)
        dt = float(drone.timestamp) - last if last >= 0 else 0.001
        cmd, self.state = compute_control(self.config, self.state, drone, sp, dt)
        if bool(self.state.failsafe_active) and not self._was_failsafe:
            # first activation: halve gains (ref :806-811)
            self.config = self.config._replace(
                kp_pos=tuple(g * 0.5 for g in self.config.kp_pos),
                kd_pos=tuple(g * 0.5 for g in self.config.kd_pos),
                kp_att=tuple(g * 0.5 for g in self.config.kp_att),
                kd_att=tuple(g * 0.5 for g in self.config.kd_att),
            )
        self._was_failsafe = bool(self.state.failsafe_active)
        self.position_errors.append(
            float(jnp.linalg.norm(sp.position - drone.position))
        )
        self.velocity_errors.append(
            float(jnp.linalg.norm(sp.velocity - drone.velocity))
        )
        return cmd

    def reset(self):
        self.state = ControllerState.zeros(self.config)
        self._was_failsafe = False
        self.position_errors.clear()
        self.velocity_errors.clear()

    def get_performance_metrics(self) -> dict:
        """(ref :821-851)"""
        out = {
            "failsafe_activations": int(self.state.failsafe_count),
            "integral_magnitude": float(
                jnp.linalg.norm(self.state.integral_vel_error)
            ),
            "anti_windup_method": self.config.anti_windup_method,
        }
        if self.position_errors:
            out.update(
                mean_position_error=float(np.mean(self.position_errors)),
                max_position_error=float(np.max(self.position_errors)),
                mean_velocity_error=float(np.mean(self.velocity_errors)),
                total_samples=len(self.position_errors),
            )
        return out

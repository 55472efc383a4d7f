"""C2-continuous trajectory splicing, branch-free and jittable.

Re-design of the reference ``TrajectorySmoother``
(/root/reference/src/dart_planner/control/trajectory_smoother.py, "TS"):
same semantics — minimum-jerk transition when a new plan jumps
(TS:147-165), linear trajectory interpolation (TS:215-260), velocity/
acceleration/jerk rate limits (TS:66-92), exponential smoothing
(TS:95-113), 2 s comms-timeout failsafe hold (TS:175-177) — but as a pure
``(config, state, inputs) -> (outputs, state)`` function over fixed-shape
pytrees, so a fleet of smoothers runs under ``vmap`` inside the same
executable as the controller.

The reference's Butterworth filter (TS:57-63) is created but never
applied to the output path (its ``lfilter`` state is unused); the
exponential smoothing member is what actually shapes commands, so that is
what this port implements.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dart_planner_tpu.common.types import DroneState, Trajectory, pytree_dataclass

Array = jnp.ndarray


class SmootherConfig(NamedTuple):
    """Static smoother parameters (TS:19-26)."""

    transition_time: float = 0.5  # s, min-jerk blend duration
    velocity_limit: float = 20.0  # m/s^2: max setpoint-velocity slew
    acceleration_limit: float = 60.0  # m/s^3: max setpoint-accel slew
    jerk_limit: float = 60.0  # m/s^3 bound on accel change (legacy knob)
    pos_jump_threshold: float = 0.5  # m (TS:151)
    vel_jump_threshold: float = 1.0  # m/s (TS:151)
    failsafe_timeout: float = 2.0  # s without a plan update (TS:176)
    smoothing_dt: float = 0.01  # assumed command rate (TS:180)


@pytree_dataclass
class SmootherState:
    """Explicit smoother state pytree. ``horizon`` is fixed at creation."""

    positions: Array  # (N, 3) active plan
    velocities: Array  # (N, 3)
    accelerations: Array  # (N, 3)
    timestamps: Array  # (N,)
    traj_start_time: Array  # ()
    last_update_time: Array  # ()
    has_trajectory: Array  # () bool
    in_transition: Array  # () bool
    transition_start_time: Array  # ()
    trans_p0: Array  # (3,)
    trans_v0: Array  # (3,)
    trans_p1: Array  # (3,)
    trans_v1: Array  # (3,)
    last_pos: Array  # (3,) exponential-smoothing memory
    last_vel: Array  # (3,)
    last_acc: Array  # (3,)
    last_call_time: Array  # () for real-dt rate limiting
    primed: Array  # () bool: smoothing memory valid

    @classmethod
    def zeros(cls, horizon: int, batch_shape: tuple = (), dtype=jnp.float32):
        v = jnp.zeros(batch_shape + (3,), dtype)
        s = jnp.zeros(batch_shape, dtype)
        return cls(
            positions=jnp.zeros(batch_shape + (horizon, 3), dtype),
            velocities=jnp.zeros(batch_shape + (horizon, 3), dtype),
            accelerations=jnp.zeros(batch_shape + (horizon, 3), dtype),
            timestamps=jnp.zeros(batch_shape + (horizon,), dtype),
            traj_start_time=s,
            last_update_time=jnp.full(batch_shape, -1e9, dtype),
            has_trajectory=jnp.zeros(batch_shape, bool),
            in_transition=jnp.zeros(batch_shape, bool),
            transition_start_time=s,
            trans_p0=v,
            trans_v0=v,
            trans_p1=v,
            trans_v1=v,
            last_pos=v,
            last_vel=v,
            last_acc=v,
            last_call_time=jnp.full(batch_shape, -1.0, dtype),
            primed=jnp.zeros(batch_shape, bool),
        )


def _interpolate(ts: Array, pos: Array, vel: Array, acc: Array, t_rel: Array):
    """Linear interpolation with endpoint clamping (TS:215-260)."""
    rel = ts - ts[..., :1]
    N = rel.shape[-1]
    idx = jnp.clip(jnp.searchsorted(rel, t_rel, side="right") - 1, 0, N - 2)
    t1 = jnp.take_along_axis(rel, idx[..., None], axis=-1)[..., 0]
    t2 = jnp.take_along_axis(rel, idx[..., None] + 1, axis=-1)[..., 0]
    alpha = jnp.clip((t_rel - t1) / jnp.maximum(t2 - t1, 1e-9), 0.0, 1.0)

    def pick(arr):
        lo = jnp.take_along_axis(arr, idx[..., None, None], axis=-2)[..., 0, :]
        hi = jnp.take_along_axis(arr, idx[..., None, None] + 1, axis=-2)[..., 0, :]
        return lo + alpha[..., None] * (hi - lo)

    return pick(pos), pick(vel), pick(acc)


def _min_jerk(p0, v0, p1, v1, T: float, tau: Array):
    """Quintic minimum-jerk blend with a(0)=a(T)=0 (TS transition,
    _generate_transition_state)."""
    s = jnp.clip(tau / T, 0.0, 1.0)[..., None]
    s2, s3, s4, s5 = s * s, None, None, None
    s3 = s2 * s
    s4 = s3 * s
    s5 = s4 * s
    h00 = 1 - 10 * s3 + 15 * s4 - 6 * s5
    h01 = 10 * s3 - 15 * s4 + 6 * s5
    h10 = T * (s - 6 * s3 + 8 * s4 - 3 * s5)
    h11 = T * (-4 * s3 + 7 * s4 - 3 * s5)
    pos = h00 * p0 + h01 * p1 + h10 * v0 + h11 * v1
    d00 = (-30 * s2 + 60 * s3 - 30 * s4) / T
    d01 = (30 * s2 - 60 * s3 + 30 * s4) / T
    d10 = 1 - 18 * s2 + 32 * s3 - 15 * s4
    d11 = -12 * s2 + 28 * s3 - 15 * s4
    vel = d00 * p0 + d01 * p1 + d10 * v0 + d11 * v1
    a00 = (-60 * s + 180 * s2 - 120 * s3) / (T * T)
    a01 = (60 * s - 180 * s2 + 120 * s3) / (T * T)
    a10 = (-36 * s + 96 * s2 - 60 * s3) / T
    a11 = (-24 * s + 84 * s2 - 60 * s3) / T
    acc = a00 * p0 + a01 * p1 + a10 * v0 + a11 * v1
    return pos, vel, acc


def _rate_limit(
    config: SmootherConfig, state: SmootherState, pos, vel, acc, dt
):
    """Velocity/accel-change and jerk limits + exponential smoothing
    (TS:66-113), masked by ``primed``.

    Deviation from the reference: limits are applied over the REAL elapsed
    time ``dt`` between calls instead of an assumed 100 Hz ``dt=0.01``
    (TS:180), so behavior is invariant to the caller's loop rate — the
    reference's per-call limiting makes setpoint ramps 4x slower at 400 Hz
    than at 100 Hz.
    """

    dv = vel - state.last_vel
    dv_mag = jnp.linalg.norm(dv, axis=-1, keepdims=True)
    lim = config.velocity_limit * dt
    vel = jnp.where(
        dv_mag > lim, state.last_vel + dv * (lim / jnp.maximum(dv_mag, 1e-9)), vel
    )

    da = acc - state.last_acc
    da_mag = jnp.linalg.norm(da, axis=-1, keepdims=True)
    lim_a = config.acceleration_limit * dt
    acc = jnp.where(
        da_mag > lim_a, state.last_acc + da * (lim_a / jnp.maximum(da_mag, 1e-9)), acc
    )

    jerk = (acc - state.last_acc) / dt
    j_mag = jnp.linalg.norm(jerk, axis=-1, keepdims=True)
    acc = jnp.where(
        j_mag > config.jerk_limit,
        state.last_acc + jerk * (config.jerk_limit / jnp.maximum(j_mag, 1e-9)) * dt,
        acc,
    )

    alpha = jnp.minimum(1.0, dt / 0.1)[..., None]
    primed = state.primed[..., None]
    pos = jnp.where(primed, alpha * pos + (1 - alpha) * state.last_pos, pos)
    vel = jnp.where(primed, alpha * vel + (1 - alpha) * state.last_vel, vel)
    acc = jnp.where(primed, alpha * acc + (1 - alpha) * state.last_acc, acc)
    return pos, vel, acc


@functools.partial(jax.jit, static_argnames=("config",))
def update_trajectory(
    config: SmootherConfig,
    state: SmootherState,
    trajectory: Trajectory,
    current_time: Array,
) -> SmootherState:
    """Accept a new plan; start a min-jerk transition on a jump
    (TS:114-165). Pure: returns the new state."""
    t = jnp.asarray(current_time, state.positions.dtype)
    # desired state of the OLD plan now
    old_p, old_v, _ = _interpolate(
        state.timestamps,
        state.positions,
        state.velocities,
        state.accelerations,
        t - state.traj_start_time,
    )
    # start of the new plan (jump detection, TS:147-151)
    new_p = trajectory.positions[..., 0, :]
    new_v = trajectory.velocities[..., 0, :]
    # transition TARGET: where the new plan will be when the blend ends.
    # (The reference blends toward the plan's t=0 point — i.e. toward the
    # vehicle's own current state — so during sustained acceleration the
    # velocity-jump check re-fires every splice and the command never
    # advances into the plan. Aiming at plan(t + transition_time) keeps the
    # splice C2-consistent AND progressing.)
    tgt_p, tgt_v, _ = _interpolate(
        trajectory.timestamps,
        trajectory.positions,
        trajectory.velocities,
        trajectory.accelerations,
        jnp.asarray(config.transition_time, state.positions.dtype),
    )

    pos_diff = jnp.linalg.norm(new_p - old_p, axis=-1)
    vel_diff = jnp.linalg.norm(new_v - old_v, axis=-1)
    jump = (pos_diff > config.pos_jump_threshold) | (
        vel_diff > config.vel_jump_threshold
    )
    start_transition = state.has_trajectory & jump

    return state.replace(
        positions=trajectory.positions,
        velocities=trajectory.velocities,
        accelerations=trajectory.accelerations,
        timestamps=trajectory.timestamps,
        traj_start_time=t,
        last_update_time=t,
        has_trajectory=jnp.ones_like(state.has_trajectory),
        in_transition=start_transition | state.in_transition,
        transition_start_time=jnp.where(start_transition, t, state.transition_start_time),
        trans_p0=jnp.where(start_transition[..., None], old_p, state.trans_p0),
        trans_v0=jnp.where(start_transition[..., None], old_v, state.trans_v0),
        trans_p1=jnp.where(start_transition[..., None], tgt_p, state.trans_p1),
        trans_v1=jnp.where(start_transition[..., None], tgt_v, state.trans_v1),
    )


@functools.partial(jax.jit, static_argnames=("config",))
def get_desired_state(
    config: SmootherConfig,
    state: SmootherState,
    current_time: Array,
    drone_state: DroneState,
) -> tuple[tuple[Array, Array, Array], SmootherState]:
    """Smooth (pos, vel, acc) command at ``current_time`` (TS:167-213).

    Failsafe: hold current position when no plan update for
    ``failsafe_timeout`` (TS:175-177) or no plan at all.
    """
    t = jnp.asarray(current_time, state.positions.dtype)

    dt_real = jnp.clip(
        t - state.last_call_time, config.smoothing_dt * 0.1, 0.1
    )
    dt_real = jnp.where(state.primed, dt_real, config.smoothing_dt)

    # normal interpolation of the active plan
    pos_n, vel_n, acc_n = _interpolate(
        state.timestamps,
        state.positions,
        state.velocities,
        state.accelerations,
        t - state.traj_start_time,
    )

    # min-jerk transition overlay
    tau = t - state.transition_start_time
    trans_done = tau >= config.transition_time
    pos_t, vel_t, acc_t = _min_jerk(
        state.trans_p0,
        state.trans_v0,
        state.trans_p1,
        state.trans_v1,
        config.transition_time,
        tau,
    )
    use_trans = state.in_transition & ~trans_done
    pos = jnp.where(use_trans[..., None], pos_t, pos_n)
    vel = jnp.where(use_trans[..., None], vel_t, vel_n)
    acc = jnp.where(use_trans[..., None], acc_t, acc_n)

    pos, vel, acc = _rate_limit(config, state, pos, vel, acc, dt_real)

    # failsafe hold (stale comms or no plan yet)
    stale = (t - state.last_update_time) > config.failsafe_timeout
    hold = stale | ~state.has_trajectory
    pos = jnp.where(hold[..., None], drone_state.position, pos)
    vel = jnp.where(hold[..., None], 0.0, vel)
    acc = jnp.where(hold[..., None], 0.0, acc)

    new_state = state.replace(
        in_transition=state.in_transition & ~trans_done,
        last_pos=pos,
        last_vel=vel,
        last_acc=acc,
        last_call_time=t,
        primed=jnp.ones_like(state.primed),
    )
    return (pos, vel, acc), new_state


class TrajectorySmoother:
    """Stateful facade mirroring the reference class (TS:11)."""

    def __init__(
        self,
        transition_time: float = 0.5,
        smoothing_factor: float = 0.8,
        horizon: int = 20,
        config: SmootherConfig | None = None,
    ):
        self.config = config or SmootherConfig(transition_time=transition_time)
        self.state = SmootherState.zeros(horizon)

    def update_trajectory(self, trajectory: Trajectory, current_time) -> None:
        self.state = update_trajectory(
            self.config, self.state, trajectory, current_time
        )

    def get_desired_state(self, current_time, drone_state: DroneState):
        (pos, vel, acc), self.state = get_desired_state(
            self.config, self.state, current_time, drone_state
        )
        return pos, vel, acc

"""Fused Pallas kernel (Triton route) for the closed-loop tick block.

One replan block of the closed-loop simulator runs ``T`` control ticks
(geometric SE(3) controller + rigid-body plant step) at 400 Hz between
10 Hz MPC replans. As a ``lax.scan`` that is one device-loop iteration of
tiny elementwise work per tick (2,400 per 6 s episode). This kernel runs
the whole tick block in one call: each program owns a block of episodes
on the minor axis, keeps the state in registers and loops over the ticks
with a ``fori_loop``.

Scope (asserted): the closed-loop sim configuration —

- ``anti_windup_method == "clamping"`` (the default),
- setpoint yaw = yaw_rate = 0 (what the simulator commands),
- ``physics_substeps`` small (python-unrolled).

Math mirrors :func:`dart_planner_tpu.control.geometric.compute_control`
and :func:`dart_planner_tpu.sim.physics.rigid_body_step` line for line
(same masks, clamps, and Rodrigues update); a noise-free parity test
against the scan path runs in interpret mode on the CPU.

State row layout (one (32, B) array; each row is loaded and stored on
its own, Triton holds no row slices of a loaded block):
  0-2 pos | 3-5 vel | 6-8 omega | 9-17 R row-major | 18-20 integral |
  21-23 last_torque_saturated | 24 failsafe_count | 25 last_valid_thrust
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.ops.pallas_mpc import pow2_at_least

Array = jnp.ndarray

_ROWS = 32


def _lerp_weights(T: int, control_dt: float, mpc_dt: float, N: int) -> np.ndarray:
    """Static (T, N) linear-interpolation matrix: plan -> per-tick setpoint."""
    W = np.zeros((T, N), np.float32)
    for j in range(T):
        tau = (j + 1) * control_dt
        x = min(max(tau / mpc_dt, 0.0), N - 1.001)
        i0 = int(np.floor(x))
        frac = x - i0
        W[j, i0] = 1.0 - frac
        W[j, i0 + 1] += frac
    return W


def _tick_kernel(control_cfg, physics_cfg, control_dt: float, T: int,
                 substeps: int, num_obstacles: int = 0):
    """Build the kernel body. All config scalars are python constants.

    ``num_obstacles > 0`` adds a per-episode obstacle-rows input
    ((4K, B): cx, cy, cz, r per sphere; inactive rows use r = -1e30) and
    tracks the per-tick minimum surface clearance in accum row 3 — the
    TRUE-world collision signal for the obstacle Monte-Carlo."""
    assert control_cfg.anti_windup_method == "clamping"
    c = control_cfg
    p = physics_cfg
    h = control_dt / substeps
    g = float(c.gravity)  # controller's gravity (f_world term)
    pg = float(p.gravity)  # plant's gravity (they may differ by config)
    kp = tuple(float(v) for v in c.kp_pos)
    ki = tuple(float(v) for v in c.ki_pos)
    kd = tuple(float(v) for v in c.kd_pos)
    kp_att = tuple(float(v) for v in c.kp_att)
    kd_att = tuple(float(v) for v in c.kd_att)
    inertia = tuple(float(v) for v in c.inertia)
    max_tq = tuple(float(v) for v in c.max_torque_xyz)
    per_axis_int = tuple(float(v) for v in c.max_integral_per_axis)
    min_thrust = float(c.min_thrust) * float(c.mass) * g
    cos_max = float(np.cos(c.max_tilt_angle))
    sin_max = float(np.sin(c.max_tilt_angle))
    p_inertia = tuple(float(v) for v in p.inertia)

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def cross3(a, b):
        return (
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        )

    def norm3(a):
        return jnp.sqrt(dot3(a, a))

    def kernel(S_ref, spp_ref, spv_ref, spa_ref, gw_ref, *rest):
        if num_obstacles:
            obs_ref, out_ref, acc_ref = rest
        else:
            out_ref, acc_ref = rest

        def vec(ref, i):
            return (ref[i, :], ref[i + 1, :], ref[i + 2, :])

        goal = vec(gw_ref, 0)
        wind = vec(gw_ref, 3)
        R0 = tuple(S_ref[9 + k, :] for k in range(9))
        big = jnp.full_like(goal[0], 1e30)
        carry0 = (
            vec(S_ref, 0), vec(S_ref, 3), vec(S_ref, 6), R0,
            vec(S_ref, 18), vec(S_ref, 21), S_ref[24, :], S_ref[25, :],
            (big, 0.0 * big, big, big),  # min dist, track sum, min alt, clear
        )

        def tick(j, carry):
            pos, vel, omega, Rf, integral, lt_sat, fcount, last_valid, acc = carry
            min_dist, track_sum, min_alt, min_clear = acc
            R = [[Rf[3 * i + k] for k in range(3)] for i in range(3)]
            sp_pos = vec(spp_ref, 3 * j)
            sp_vel = vec(spv_ref, 3 * j)
            sp_acc = vec(spa_ref, 3 * j)

            # ---- geometric controller (geometric.py:185-326) ----
            pe = tuple(sp_pos[d] - pos[d] for d in range(3))
            ve = tuple(sp_vel[d] - vel[d] for d in range(3))
            pe_mag = norm3(pe)
            ve_mag = norm3(ve)
            acc_des = tuple(
                sp_acc[d] + kp[d] * pe[d] + kd[d] * ve[d] + ki[d] * integral[d]
                for d in range(3)
            )
            # f_world = acc_des - g_vec (ENU gravity = (0,0,-g))
            f = (acc_des[0], acc_des[1], acc_des[2] + g)
            f_norm = norm3(f)
            thrust_raw = c.mass * f_norm
            thrust_mag = jnp.clip(thrust_raw, min_thrust, c.max_thrust)
            thrust_sat = (thrust_raw != thrust_mag).astype(jnp.float32)

            # integral update, clamping anti-windup
            damp_t = 1.0 - 0.9 * thrust_sat  # where(sat, 0.1, 1.0)
            new_int = []
            for d in range(3):
                damp = damp_t * (1.0 - 0.9 * lt_sat[d])
                v = integral[d] + ve[d] * control_dt * damp
                v = jnp.clip(v, -per_axis_int[d], per_axis_int[d])
                new_int.append(v)
            mag = norm3(tuple(new_int))
            scale = jnp.where(
                mag > c.max_integral_pos,
                c.max_integral_pos / jnp.maximum(mag, 1e-9),
                1.0,
            )
            new_int = [v * scale for v in new_int]
            integral = tuple(
                jnp.where(
                    jnp.abs(v) > per_axis_int[d] * c.saturation_threshold,
                    v * c.integral_decay_factor,
                    v,
                )
                for d, v in enumerate(new_int)
            )

            # desired thrust direction + tilt limit
            inv_f = 1.0 / jnp.maximum(f_norm, 1e-9)
            b3 = tuple(f[d] * inv_f for d in range(3))
            tm_ok = (thrust_mag > 1e-6).astype(jnp.float32)
            b3 = (
                b3[0] * tm_ok,
                b3[1] * tm_ok,
                b3[2] * tm_ok + (1.0 - tm_ok),
            )
            over = b3[2] < cos_max
            xy_n = jnp.sqrt(b3[0] * b3[0] + b3[1] * b3[1])
            inv_xy = 1.0 / jnp.maximum(xy_n, 1e-9)
            b3 = (
                jnp.where(over, sin_max * b3[0] * inv_xy, b3[0]),
                jnp.where(over, sin_max * b3[1] * inv_xy, b3[1]),
                jnp.where(over, cos_max + 0.0 * b3[2], b3[2]),
            )

            # desired frame at yaw 0 (c = e1), geometric.py:124-159
            singular = jnp.abs(b3[0]) >= c.yaw_singularity_threshold
            bc = cross3(b3, (1.0, 0.0, 0.0))
            b1_raw = cross3(bc, b3)
            n1 = norm3(b1_raw)
            ok = n1 > 1e-6
            inv_n1 = 1.0 / jnp.where(ok, n1, 1.0)
            b1_normal = tuple(
                jnp.where(ok, b1_raw[d] * inv_n1, 1.0 if d == 0 else 0.0)
                for d in range(3)
            )
            straight = jnp.abs(b3[2]) >= 0.99
            proj = (1.0 - b3[0] * b3[0], -b3[0] * b3[1], -b3[0] * b3[2])
            np_ = norm3(proj)
            ok_p = np_ > 1e-9
            inv_np = 1.0 / jnp.where(ok_p, np_, 1.0)
            b1_skip = tuple(
                jnp.where(ok_p, proj[d] * inv_np, 1.0 if d == 0 else 0.0)
                for d in range(3)
            )
            b1_skip = tuple(
                jnp.where(straight, 1.0 if d == 0 else 0.0, b1_skip[d])
                for d in range(3)
            )
            b1 = tuple(
                jnp.where(singular, b1_skip[d], b1_normal[d]) for d in range(3)
            )
            b2 = cross3(b3, b1)
            Rd_cols = (b1, b2, b3)  # desired columns

            # e_R = 0.5 vee(Rd^T R - R^T Rd); M[i][j] = col_i(Rd) . col_j(R)
            Rc = [tuple(R[k][j] for k in range(3)) for j in range(3)]  # cols
            M = [[dot3(Rd_cols[i], Rc[j]) for j in range(3)] for i in range(3)]
            eR = (
                0.5 * (M[2][1] - M[1][2]),
                0.5 * (M[0][2] - M[2][0]),
                0.5 * (M[1][0] - M[0][1]),
            )
            cor = cross3(
                omega, tuple(inertia[d] * omega[d] for d in range(3))
            )
            tq_raw = tuple(
                -kp_att[d] * eR[d] - kd_att[d] * omega[d] + cor[d]
                for d in range(3)
            )
            tq = tuple(
                jnp.clip(tq_raw[d], -max_tq[d], max_tq[d]) for d in range(3)
            )
            lt_sat = tuple(
                (tq_raw[d] != tq[d]).astype(jnp.float32) for d in range(3)
            )

            # failsafe accounting (geometric.py:300-313)
            bad = (pe_mag > c.tracking_error_threshold) & (
                ve_mag > c.velocity_error_threshold
            )
            fcount = jnp.where(bad, fcount + 1.0, jnp.maximum(fcount - 1.0, 0.0))
            failsafe = fcount > float(c.failsafe_trigger_count)
            thrust_out = jnp.where(failsafe, last_valid, thrust_mag)
            tq = tuple(jnp.where(failsafe, 0.0, tq[d]) for d in range(3))
            integral = tuple(
                jnp.where(failsafe, 0.0, integral[d]) for d in range(3)
            )
            last_valid = jnp.where(failsafe, last_valid, thrust_mag)

            # ---- rigid-body plant (physics.py:127-157), substeps ----
            thr = jnp.clip(thrust_out, 0.0, p.max_thrust)
            ptq = tuple(
                jnp.clip(tq[d], -p.max_torque, p.max_torque) for d in range(3)
            )
            for _ in range(substeps):
                b3w = (R[0][2], R[1][2], R[2][2])  # body z in world
                acc = tuple(
                    (0.0 if d != 2 else -pg)
                    + b3w[d] * thr / p.mass
                    + wind[d] / p.mass
                    - (p.drag_coefficient * vel[d] if p.drag_coefficient > 0 else 0.0)
                    for d in range(3)
                )
                vel = tuple(vel[d] + acc[d] * h for d in range(3))
                pos = tuple(pos[d] + vel[d] * h for d in range(3))
                gyro = cross3(
                    omega, tuple(p_inertia[d] * omega[d] for d in range(3))
                )
                omega = tuple(
                    omega[d] + (ptq[d] - gyro[d]) / p_inertia[d] * h
                    for d in range(3)
                )
                # R <- R @ exp(hat(omega * h)), Rodrigues (so3.exp_so3)
                w = tuple(omega[d] * h for d in range(3))
                t2 = dot3(w, w)
                theta = jnp.sqrt(t2)
                small = theta < 1e-5
                a_c = jnp.where(
                    small, 1.0 - t2 / 6.0,
                    jnp.sin(theta) / jnp.where(small, 1.0, theta),
                )
                b_c = jnp.where(
                    small, 0.5 - t2 / 24.0,
                    (1.0 - jnp.cos(theta)) / jnp.where(small, 1.0, t2),
                )
                wx, wy, wz = w
                E = [
                    [
                        1.0 + b_c * (-(wy * wy + wz * wz)),
                        -a_c * wz + b_c * wx * wy,
                        a_c * wy + b_c * wx * wz,
                    ],
                    [
                        a_c * wz + b_c * wx * wy,
                        1.0 + b_c * (-(wx * wx + wz * wz)),
                        -a_c * wx + b_c * wy * wz,
                    ],
                    [
                        -a_c * wy + b_c * wx * wz,
                        a_c * wx + b_c * wy * wz,
                        1.0 + b_c * (-(wx * wx + wy * wy)),
                    ],
                ]
                R = [
                    [
                        sum(R[i][k] * E[k][j] for k in range(3))
                        for j in range(3)
                    ]
                    for i in range(3)
                ]

            # ---- per-tick episode metrics ----
            dvec = tuple(pos[d] - goal[d] for d in range(3))
            dist = norm3(dvec)
            terr = dot3(
                tuple(pos[d] - sp_pos[d] for d in range(3)),
                tuple(pos[d] - sp_pos[d] for d in range(3)),
            )
            min_dist = jnp.minimum(min_dist, dist)
            min_alt = jnp.minimum(min_alt, pos[2])
            track_sum = track_sum + terr
            for k in range(num_obstacles):
                ovec = tuple(pos[d] - obs_ref[4 * k + d, :] for d in range(3))
                clear = norm3(ovec) - obs_ref[4 * k + 3, :]
                min_clear = jnp.minimum(min_clear, clear)
            return (
                pos, vel, omega,
                tuple(R[i][k] for i in range(3) for k in range(3)),
                integral, tuple(lt_sat), fcount, last_valid,
                (min_dist, track_sum, min_alt, min_clear),
            )

        # ---- write back ----
        pos, vel, omega, Rf, integral, lt_sat, fcount, last_valid, acc = (
            jax.lax.fori_loop(0, T, tick, carry0)
        )
        rows = (
            list(pos) + list(vel) + list(omega) + list(Rf)
            + list(integral) + list(lt_sat) + [fcount, last_valid]
        )
        zero = 0.0 * fcount
        for i in range(_ROWS):
            out_ref[i, :] = rows[i] if i < len(rows) else zero
        for i in range(8):
            acc_ref[i, :] = acc[i] if i < len(acc) else zero

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("control_cfg", "physics_cfg", "control_dt", "T",
                     "substeps", "block_b", "interpret"),
)
def run_tick_block(
    control_cfg,
    physics_cfg,
    control_dt: float,
    T: int,
    substeps: int,
    state_rows: Array,  # (32, B) packed state
    sp_pos: Array,  # (3T, B) per-tick setpoint positions (rows 3j..3j+2)
    sp_vel: Array,
    sp_acc: Array,
    goal_wind: Array,  # (8, B): goal rows 0-2, wind rows 3-5
    obstacle_rows: Array | None = None,  # (4K, B): cx,cy,cz,r per sphere
    block_b: int = 128,
    interpret: bool = False,
) -> tuple[Array, Array]:
    """Execute one fused tick block. Returns (new_state_rows, accum_rows)
    with accum rows 0=min dist, 1=sum track err, 2=min altitude,
    3=min obstacle surface clearance (1e30 when no obstacles given).
    Inactive obstacle rows must carry r = -1e30. ``block_b`` episodes
    per program (a power of two); ``interpret=True`` runs the kernel in
    the Pallas interpreter (CPU tests), otherwise it compiles through
    Triton."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    if block_b & (block_b - 1):
        raise ValueError(f"block_b={block_b} must be a power of two")
    B = state_rows.shape[1]
    block_b = min(block_b, pow2_at_least(B, 16))
    Bp = -(-B // block_b) * block_b
    T3 = pow2_at_least(sp_pos.shape[0])

    def pad(x, rows=None):
        rows = x.shape[0] if rows is None else rows
        return jnp.pad(x, ((0, rows - x.shape[0]), (0, Bp - B)))

    bspec = lambda rows: pl.BlockSpec(  # noqa: E731
        (rows, block_b), lambda i: (0, i)
    )
    K = 0 if obstacle_rows is None else obstacle_rows.shape[0] // 4
    kernel = _tick_kernel(
        control_cfg, physics_cfg, control_dt, T, substeps, num_obstacles=K
    )
    in_specs = [bspec(_ROWS), bspec(T3), bspec(T3), bspec(T3), bspec(8)]
    args = [pad(state_rows), pad(sp_pos, T3), pad(sp_vel, T3),
            pad(sp_acc, T3), pad(goal_wind)]
    if K:
        in_specs.append(bspec(4 * K))
        args.append(pad(obstacle_rows))
    out, acc = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((_ROWS, Bp), state_rows.dtype),
            jax.ShapeDtypeStruct((8, Bp), state_rows.dtype),
        ),
        grid=(Bp // block_b,),
        in_specs=in_specs,
        out_specs=(bspec(_ROWS), bspec(8)),
        compiler_params=pl_triton.CompilerParams(
            num_warps=max(1, block_b // 32), num_stages=1,  # an episode a thread
        ),
        backend="triton",
        interpret=interpret,
        name="closed_loop_ticks",
    )(*args)
    return out[:, :B], acc[:, :B]


# ---- packing helpers (host/XLA side) --------------------------------

def pack_state(rb, ctrl) -> Array:
    """RigidBodyState + ControllerState (leading batch (B,)) -> (32, B)."""
    B = rb.position.shape[0]
    dtype = rb.position.dtype
    rows = [
        rb.position.T,  # (3, B)
        rb.velocity.T,
        rb.angular_velocity.T,
        rb.rotation.reshape(B, 9).T,
        ctrl.integral_vel_error.T,
        ctrl.last_torque_saturated.astype(dtype).T,
        ctrl.failsafe_count.astype(dtype)[None, :],
        ctrl.last_valid_thrust[None, :],
    ]
    S = jnp.concatenate(rows, axis=0)
    return jnp.pad(S, ((0, _ROWS - S.shape[0]), (0, 0)))


def unpack_state(S: Array, rb_template, ctrl_template):
    """(32, B) -> (RigidBodyState, ControllerState) matching templates."""
    B = S.shape[1]
    rb = rb_template.__class__(
        position=S[0:3].T,
        velocity=S[3:6].T,
        rotation=S[9:18].T.reshape(B, 3, 3),
        angular_velocity=S[6:9].T,
    )
    ctrl = ctrl_template.replace(
        integral_vel_error=S[18:21].T,
        last_torque_saturated=S[21:24].T > 0.5,
        failsafe_count=S[24].astype(jnp.int32),
        failsafe_active=S[24] > 0.0,  # informational
        last_valid_thrust=S[25],
    )
    return rb, ctrl


def pack_obstacles(obstacles: Array, mask: Array) -> Array:
    """(B, K, 4) spheres + (B, K) mask -> (4K, B) kernel rows.

    Inactive rows get r = -1e30 so their clearance is ~+1e30 and never
    wins the running minimum."""
    obstacles = jnp.asarray(obstacles)
    r = jnp.where(mask, obstacles[..., 3], jnp.asarray(-1e30, obstacles.dtype))
    rows = jnp.concatenate([obstacles[..., :3], r[..., None]], axis=-1)
    B, K = rows.shape[0], rows.shape[1]
    return rows.reshape(B, 4 * K).T


def setpoints_from_plan(
    positions: Array, velocities: Array, accelerations: Array,
    T: int, control_dt: float, mpc_dt: float,
) -> tuple[Array, Array, Array]:
    """Plan arrays (B, N, 3) -> per-tick setpoint rows (3T, B) each."""
    N = positions.shape[-2]
    W = jnp.asarray(_lerp_weights(T, control_dt, mpc_dt, N))

    def to_rows(arr):
        sp = jnp.einsum(  # (B, T, 3); fp32 — setpoints feed the 400 Hz loop
            "tn,bnd->btd", W, arr, precision=jax.lax.Precision.HIGHEST
        )
        return sp.reshape(arr.shape[0], 3 * T).T  # rows t*3+d

    return to_rows(positions), to_rows(velocities), to_rows(accelerations)

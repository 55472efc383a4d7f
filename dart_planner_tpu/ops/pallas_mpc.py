"""Fused Pallas kernel (Triton route) for the condensed SE(3) MPC solve.

One ``pallas_call`` runs the *entire* projected-Newton solve — gradient,
active-set masking, Jacobi-preconditioned CG, the projected line search
and the final exact rollout + cost — for a block of scenarios per
program. The pure-XLA path
(:func:`dart_planner_tpu.planning.se3_mpc.solve_se3_mpc`) runs every
Newton round, CG step and line-search candidate as its own small kernels
and round-trips the per-scenario state (~1 KB at N=20) through device
memory each time; here that state never leaves the program.

Layout (one program = one block of ``Bb`` scenarios on the minor axis):

- a scenario's thrust, position or velocity sequence is three
  ``(NPN, Bb)`` arrays, one per world axis; rows are horizon steps, the
  horizon padded from N up to a power of two ``NPN`` (>= 16, the smallest
  operand Triton's dot takes). Padding rows hold exactly zero throughout:
  every per-row constant and hinge is multiplied by the ``valid`` row mask;
- the per-axis condensed maps (quadratic Hessian H, S_p/m, S_v/m, their
  transposes and elementwise squares) are one ``(7, NPN, NPN)`` operand
  shared by every program; each product is a ``jnp.dot`` at
  ``Precision.HIGHEST`` (IEEE fp32 on the GPU, never TF32);
- per-scenario scalars (CG step sizes, line-search costs) are ``(1, Bb)``
  column sums;
- obstacle spheres arrive as ``(4K, Bb)`` rows (cx, cy, cz, r); a masked
  sphere carries r = -1e30, so its hinge is exactly zero.

Algorithm and semantics are those of ``solve_se3_mpc`` (same cost model,
Newton/CG/line-search schedule, ftol stall tracking), so the paths agree
to float tolerance on convex problems and in aggregate on obstacle
problems (line-search near-ties may branch); ``tests/test_pallas_mpc.py``
checks both in interpret mode on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.ops import costs, dynamics

Array = jnp.ndarray

_HI = jax.lax.Precision.HIGHEST

# order of the stacked per-axis maps in the shared operand
_MATS = ("H", "Sp", "SpT", "Sv", "SvT", "Sp2T", "Sv2T")
_MIN_ROWS = 16  # Triton's dot wants every operand dimension >= 16
# warps per program: of block 16/32 x 4/8/16 warps measured on the H100,
# 16 scenarios x 8 warps ran fastest (docs/kernel.md)
_NUM_WARPS = 8


def pow2_at_least(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


def block_size(batch: int, block_b: int) -> int:
    """Scenarios per program: ``block_b`` (a power of two >= 16), cut to
    the batch's own power of two so a small batch is not padded up to a
    large block (the single-solve path runs one 16-lane program)."""
    if block_b < _MIN_ROWS or block_b & (block_b - 1):
        raise ValueError(f"block_b={block_b} must be a power of two >= 16")
    return min(block_b, pow2_at_least(batch, _MIN_ROWS))


@functools.lru_cache(maxsize=32)
def _axis_operands(config) -> dict:
    """Per-config numpy constants: the stacked (7, NPN, NPN) maps and the
    (NPN,) rollout drift rows, zero beyond the horizon."""
    N = config.prediction_horizon
    NPN = pow2_at_least(N, _MIN_ROWS)
    S_p, S_v, t = dynamics.rollout_matrices(N, float(config.dt))
    Spm = S_p / config.mass
    Svm = S_v / config.mass
    H = costs.quadratic_hessian(
        N, config.dt, config.mass, config.gravity, config.weights
    )
    maps = {
        "H": H, "Sp": Spm, "SpT": Spm.T, "Sv": Svm, "SvT": Svm.T,
        "Sp2T": (Spm * Spm).T, "Sv2T": (Svm * Svm).T,
    }
    mats = np.zeros((len(_MATS), NPN, NPN), np.float32)
    for i, name in enumerate(_MATS):
        mats[i, :N, :N] = np.asarray(maps[name], np.float32)

    def padded(v):
        out = np.zeros(NPN, np.float32)
        out[:N] = v
        return out

    return {
        "NPN": NPN,
        "mats": mats,
        "t": padded(t),
        "spg": padded(S_p @ np.ones(N)),
        "svg": padded(S_v @ np.ones(N)),
        "valid": padded(np.ones(N)),
    }


def _solver_kernel(config, NPN: int, K: int, dynamic_vmax: bool):
    """Build the kernel body; every config scalar closes over as a
    constant. ``K`` obstacle rows (0 = obstacle terms compiled out);
    ``dynamic_vmax`` reads a per-scenario velocity cap row
    (``Problem.v_cap``) in place of the static ``max_velocity``.

    Code size sets Triton's compile time (minutes for a fully unrolled
    body), so the Newton rounds, the obstacle spheres and the
    line-search candidates are loops: the Gauss-Newton and the
    full-curvature stages share one round body, the full-curvature
    terms scaled by a 0/1 stage flag (exact: x + 0 * y == x for the
    finite y here)."""
    N = config.prediction_horizon
    w = config.weights
    inv_m = 1.0 / config.mass
    grav = float(config.gravity)
    hover_z = config.mass * grav
    mtt = config.max_thrust * float(np.sin(config.max_tilt_angle))
    lb = (-mtt, -mtt, float(config.min_thrust))
    ub = (mtt, mtt, float(config.max_thrust))
    term = float(w.terminal)
    w_p = float(w.position)
    w_v = float(w.velocity)
    w_a = float(w.acceleration)
    w_t = float(w.thrust)
    w_obs = float(w.obstacle)
    w_g = float(w.ground)
    z_min = float(w.ground_altitude)
    w_vb = float(w.velocity_bound)
    v_max = float(w.max_velocity)
    w_tilt = float(w.tilt)
    tan_max = float(w.tan_max_tilt)
    w_tn = float(w.thrust_norm)
    u_max = float(w.max_thrust_norm)
    use_obstacles = K > 0
    use_ground = w_g > 0.0
    use_vel_hinge = w_vb > 0.0
    use_pos_pen = use_obstacles or use_ground
    mat_index = {name: i for i, name in enumerate(_MATS)}
    alphas = tuple(float(a) for a in config.line_search_alphas)
    warmup = (
        min(config.gn_warmup_iterations, config.max_iterations)
        if config.newton_full_curvature
        else config.max_iterations
    )

    def mm(a, b):
        return jnp.dot(a, b, precision=_HI, preferred_element_type=jnp.float32)

    def colsum(x):
        return jnp.sum(x, axis=0, keepdims=True)

    def dot3(x, y):
        return colsum(x[0] * y[0] + x[1] * y[1] + x[2] * y[2])

    def kernel(*refs):
        u_ref, cpos_ref, cvel_ref, goal_ref, *rest = refs
        obs_ref = rest.pop(0) if use_obstacles else None
        vcap_ref = rest.pop(0) if dynamic_vmax else None
        mats_ref, u_out, pos_out, vel_out, sc_out = rest

        def map3(name, v):
            M = mats_ref[mat_index[name]]
            return tuple(mm(M, x) for x in v)

        def load3(ref):
            return tuple(ref[a] for a in range(3))

        C_pos = load3(cpos_ref)
        C_vel = load3(cvel_ref)
        goal = load3(goal_ref)
        row = jax.lax.broadcasted_iota(jnp.int32, (NPN, 1), 0)
        valid = (row < N).astype(jnp.float32)
        wp_row = w_p * valid * jnp.where(row == N - 1, 1.0 + term, 1.0)
        eye = jax.lax.broadcasted_iota(
            jnp.int32, (NPN, NPN), 0
        ) == jax.lax.broadcasted_iota(jnp.int32, (NPN, NPN), 1)
        diag_quad = jnp.sum(
            jnp.where(eye, mats_ref[mat_index["H"]], 0.0), axis=1,
            keepdims=True,
        )  # (NPN, 1)
        hover = (0.0 * valid, 0.0 * valid, hover_z * valid)
        lb_r = tuple(lb[a] * valid for a in range(3))
        ub_r = tuple(ub[a] * valid for a in range(3))
        g_acc = (0.0 * valid, 0.0 * valid, -grav * valid)
        vmax = vcap_ref[...] if dynamic_vmax else v_max  # (1, Bb) or const

        def rollout(uu):
            dp = map3("Sp", uu)
            dv = map3("Sv", uu)
            pos = tuple(C_pos[a] + dp[a] for a in range(3))
            vel = tuple(C_vel[a] + dv[a] for a in range(3))
            acc = tuple(uu[a] * inv_m + g_acc[a] for a in range(3))
            return pos, vel, acc

        def sphere(o, pos):
            """Offsets to sphere ``o``, its distance and hinge violation."""
            r = obs_ref[4 * o + 3, :][None, :]
            dx = pos[0] - obs_ref[4 * o, :][None, :]
            dy = pos[1] - obs_ref[4 * o + 1, :][None, :]
            dz = pos[2] - obs_ref[4 * o + 2, :][None, :]
            d = jnp.sqrt(dx * dx + dy * dy + dz * dz + 1e-9)
            return r, dx, dy, dz, d, jnp.maximum(r - d, 0.0) * valid

        def obstacle_cost(pos):
            """Obstacle cost density (NPN, Bb)."""

            def body(o, dens):
                viol = sphere(o, pos)[-1]
                return dens + viol * viol

            return w_obs * jax.lax.fori_loop(0, K, body, 0.0 * pos[0])

        def obstacle_grad_gn(pos, fc):
            """Position-space gradient and the per-step 3x3 Gauss-Newton
            blocks (costs.penalty_blocks; with ``fc`` = 1 the h * hess(h)
            term too: Hp = 2w (1 + h/d) n n^T - 2w (h/d) I)."""

            def body(o, carry):
                gx, gy, gz, hxx, hyy, hzz, hxy, hxz, hyz = carry
                r, dx, dy, dz, d, viol = sphere(o, pos)
                coef = (2.0 * w_obs) * viol / d
                act = (r > d).astype(jnp.float32) * valid * (2.0 * w_obs)
                hd = viol / d
                inv_d2 = act * (1.0 + fc * hd) / (d * d)
                diag_c = fc * act * hd
                return (
                    gx - coef * dx, gy - coef * dy, gz - coef * dz,
                    hxx + inv_d2 * dx * dx - diag_c,
                    hyy + inv_d2 * dy * dy - diag_c,
                    hzz + inv_d2 * dz * dz - diag_c,
                    hxy + inv_d2 * dx * dy,
                    hxz + inv_d2 * dx * dz,
                    hyz + inv_d2 * dy * dz,
                )

            out = jax.lax.fori_loop(0, K, body, (0.0 * pos[0],) * 9)
            return out[:3], out[3:]

        def cost_terms(pos, vel, acc, uu):
            """Per-scenario total cost (1, Bb) from a rollout: every term
            is an elementwise density over rows, summed once."""
            D = 0.0
            for a in range(3):
                pe = pos[a] - goal[a]
                du = uu[a] - hover[a]
                D = D + (
                    wp_row * pe * pe
                    + w_v * vel[a] * vel[a]
                    + w_a * acc[a] * acc[a]
                    + w_t * du * du
                )
                if use_vel_hinge:
                    vv = jnp.maximum(jnp.abs(vel[a]) - vmax, 0.0)
                    D = D + w_vb * vv * vv
            if use_ground:
                gv = jnp.maximum(z_min - pos[2], 0.0) * valid
                D = D + w_g * gv * gv
            if use_obstacles:
                D = D + obstacle_cost(pos)
            ux, uy, uz = uu
            if w_tilt > 0.0:
                lat = jnp.sqrt(ux * ux + uy * uy + 1e-9)
                tv = jnp.maximum(lat - tan_max * uz, 0.0) * valid
                D = D + w_tilt * tv * tv
            if w_tn > 0.0:
                un = jnp.sqrt(ux * ux + uy * uy + uz * uz + 1e-9)
                nv = jnp.maximum(un - u_max, 0.0) * valid
                D = D + w_tn * nv * nv
            return colsum(D)

        def newton_round(it, carry):
            u, min_imp = carry
            # stage flag: 0 = Gauss-Newton warmup, 1 = full curvature; the
            # ftol stall tracker restarts at the switch (stage-2
            # directions differ), as in solve_se3_mpc
            fc = (it >= warmup).astype(jnp.float32)
            min_imp = jnp.where(it == warmup, jnp.inf, min_imp)
            pos, vel, acc = rollout(u)
            zero = 0.0 * u[0]

            # gradient in physical space, pulled back to thrust space
            gpos = [2.0 * wp_row * (pos[a] - goal[a]) for a in range(3)]
            hp = (zero,) * 6
            if use_obstacles:
                g_obs, hp = obstacle_grad_gn(pos, fc)
                gpos = [gpos[a] + g_obs[a] for a in range(3)]
            if use_ground:
                gv = jnp.maximum(z_min - pos[2], 0.0) * valid
                gpos[2] = gpos[2] - 2.0 * w_g * gv
                gz_act = (2.0 * w_g) * (pos[2] < z_min).astype(jnp.float32)
                hp = hp[:2] + (hp[2] + gz_act * valid,) + hp[3:]
            gvel = [2.0 * w_v * vel[a] for a in range(3)]
            hv = (zero,) * 3
            if use_vel_hinge:
                vv = [jnp.maximum(jnp.abs(vel[a]) - vmax, 0.0) for a in range(3)]
                gvel = [
                    gvel[a] + (2.0 * w_vb) * jnp.sign(vel[a]) * vv[a]
                    for a in range(3)
                ]
                hv = tuple(
                    (2.0 * w_vb)
                    * (jnp.abs(vel[a]) > vmax).astype(jnp.float32)
                    for a in range(3)
                )
            pb_p = map3("SpT", gpos)
            pb_v = map3("SvT", gvel)
            grad = [
                pb_p[a] + pb_v[a]
                + (2.0 * w_a * inv_m) * acc[a]
                + (2.0 * w_t) * (u[a] - hover[a])
                for a in range(3)
            ]

            # thrust-space hinges (tilt cone / total norm): gradient plus
            # rank-1 GN data (costs.penalty_blocks: Hu = 2 w 1{viol}
            # (dv)(dv)^T), consumed by the CG matvec and Jacobi diagonal
            ux, uy, uz = u
            tdiag = [zero, zero, zero]
            tilt = norm = None
            if w_tilt > 0.0:
                lat = jnp.sqrt(ux * ux + uy * uy + 1e-9)
                tv = jnp.maximum(lat - tan_max * uz, 0.0) * valid
                jx, jy = ux / lat, uy / lat
                c = (2.0 * w_tilt) * tv
                grad[0] = grad[0] + c * jx
                grad[1] = grad[1] + c * jy
                grad[2] = grad[2] - tan_max * c
                at_ = (2.0 * w_tilt) * valid * (
                    lat - tan_max * uz > 0.0
                ).astype(jnp.float32)
                # full curvature: + 2 w tv hess(lat) = c (I2 - q q^T) / lat
                ct_ = fc * c / lat
                tdiag[0] = tdiag[0] + at_ * jx * jx + ct_ * (1.0 - jx * jx)
                tdiag[1] = tdiag[1] + at_ * jy * jy + ct_ * (1.0 - jy * jy)
                tdiag[2] = tdiag[2] + at_ * (tan_max * tan_max)
                tilt = (at_, jx, jy, ct_)
            if w_tn > 0.0:
                un = jnp.sqrt(ux * ux + uy * uy + uz * uz + 1e-9)
                nvv = jnp.maximum(un - u_max, 0.0) * valid
                nvec = (ux / un, uy / un, uz / un)
                cng = (2.0 * w_tn) * nvv
                an_ = (2.0 * w_tn) * valid * (un > u_max).astype(jnp.float32)
                # full curvature: + 2 w nvv hess(||u||) = cng (I - n n^T) / ||u||
                cn_ = fc * cng / un
                for a in range(3):
                    grad[a] = grad[a] + cng * nvec[a]
                    tdiag[a] = (
                        tdiag[a] + an_ * nvec[a] * nvec[a]
                        + cn_ * (1.0 - nvec[a] * nvec[a])
                    )
                norm = (an_, nvec, cn_)

            # active set: at a bound with the gradient pushing outward
            eps = 1e-6
            free = tuple(
                1.0
                - (
                    ((u[a] <= lb_r[a] + eps) & (grad[a] > 0))
                    | ((u[a] >= ub_r[a] - eps) & (grad[a] < 0))
                ).astype(jnp.float32)
                for a in range(3)
            )

            # Jacobi preconditioner diagonal
            diag = [diag_quad + tdiag[a] for a in range(3)]
            if use_pos_pen:
                dp = map3("Sp2T", hp[:3])
                diag = [diag[a] + dp[a] for a in range(3)]
            if use_vel_hinge:
                dvh = map3("Sv2T", hv)
                diag = [diag[a] + dvh[a] for a in range(3)]
            # the full obstacle Hessian can drive diagonal entries
            # negative: at full curvature clamp to a fraction of the
            # quadratic diagonal (at fc = 0 this is max(diag, 1e-8)). The
            # absolute 1e-8 floor keeps padding rows (diag == 0) finite:
            # there r == 0, so z = minv * r stays exactly 0.
            minv = tuple(
                free[a]
                / jnp.maximum(jnp.maximum(diag[a], fc * 0.1 * diag_quad), 1e-8)
                for a in range(3)
            )

            hxx, hyy, hzz, hxy, hxz, hyz = hp

            def matvec(dv):
                dv = tuple(dv[a] * free[a] for a in range(3))
                out = list(map3("H", dv))
                if use_pos_pen:
                    y = map3("Sp", dv)
                    z = (
                        hxx * y[0] + hxy * y[1] + hxz * y[2],
                        hxy * y[0] + hyy * y[1] + hyz * y[2],
                        hxz * y[0] + hyz * y[1] + hzz * y[2],
                    )
                    zb = map3("SpT", z)
                    out = [out[a] + zb[a] for a in range(3)]
                if use_vel_hinge:
                    yv = map3("Sv", dv)
                    zv = map3("SvT", tuple(hv[a] * yv[a] for a in range(3)))
                    out = [out[a] + zv[a] for a in range(3)]
                if tilt is not None:
                    at_, jx, jy, ct_ = tilt
                    s = at_ * (jx * dv[0] + jy * dv[1] - tan_max * dv[2])
                    sq = jx * dv[0] + jy * dv[1]
                    # GN block, plus c (I2 - q q^T) / lat on the xy block
                    out[0] = out[0] + s * jx + ct_ * (dv[0] - jx * sq)
                    out[1] = out[1] + s * jy + ct_ * (dv[1] - jy * sq)
                    out[2] = out[2] - tan_max * s
                if norm is not None:
                    an_, nvec, cn_ = norm
                    sn = nvec[0] * dv[0] + nvec[1] * dv[1] + nvec[2] * dv[2]
                    for a in range(3):
                        out[a] = (
                            out[a] + an_ * sn * nvec[a]
                            + cn_ * (dv[a] - nvec[a] * sn)
                        )
                return tuple(out[a] * free[a] for a in range(3))

            r0 = tuple(-(grad[a] * free[a]) for a in range(3))
            z0 = tuple(minv[a] * r0[a] for a in range(3))
            rz0 = dot3(r0, z0)  # (1, Bb)

            def cg_body(_, carry):
                d, r, z, p, rz, alive = carry
                ap = matvec(p)
                pap = dot3(p, ap)
                # Steihaug truncation: on (near-)negative curvature freeze
                # this scenario's direction at the current partial sum,
                # with the scale-invariant guard of solve_se3_mpc (pap
                # above a Rayleigh-quotient floor of |p|^2)
                pp = dot3(p, p)
                alive = alive * (pap > 1e-8 * pp).astype(jnp.float32)
                alpha = alive * rz / jnp.maximum(pap, 1e-12)
                d = tuple(d[a] + alpha * p[a] for a in range(3))
                r = tuple(r[a] - alpha * ap[a] for a in range(3))
                z = tuple(minv[a] * r[a] for a in range(3))
                rz_new = dot3(r, z)
                beta = alive * rz_new / jnp.maximum(rz, 1e-12)
                p = tuple(
                    z[a] * alive + beta * p[a] + (1.0 - alive) * p[a]
                    for a in range(3)
                )
                rz = alive * rz_new + (1.0 - alive) * rz
                return d, r, z, p, rz, alive

            d, *_ = jax.lax.fori_loop(
                0, config.cg_iterations, cg_body,
                ((zero,) * 3, r0, z0, z0, rz0, 1.0 + 0.0 * rz0),
            )
            # at full curvature, negative curvature on the very first CG
            # step leaves d = 0: fall back to preconditioned steepest
            # descent (GN rounds keep d)
            dn = dot3(tuple(jnp.abs(x) for x in d), (1.0, 1.0, 1.0))
            keep = (dn > 0.0) | (fc == 0.0)
            d = tuple(jnp.where(keep, d[a], z0[a]) * free[a] for a in range(3))

            # projected line search; the current iterate is the fallback
            # and a strict-improvement update is argmin with the earliest
            # tie winning, as in solve_se3_mpc
            cur_cost = cost_terms(pos, vel, acc, u)

            def ls_body(k, best):
                best_cost, best_u = best
                alpha = jnp.float32(alphas[0])
                for j, a in enumerate(alphas[1:], 1):
                    alpha = jnp.where(k == j, jnp.float32(a), alpha)
                cand = tuple(
                    jnp.clip(u[a] + alpha * d[a], lb_r[a], ub_r[a])
                    for a in range(3)
                )
                cJ = cost_terms(*rollout(cand), cand)
                better = cJ < best_cost
                return (
                    jnp.where(better, cJ, best_cost),
                    tuple(jnp.where(better, cand[a], best_u[a]) for a in range(3)),
                )

            best_cost, best_u = jax.lax.fori_loop(
                0, len(alphas), ls_body, (cur_cost, u)
            )
            # realized relative improvement; the ftol stall criterion
            # takes the MIN over the stage's rounds
            imp = (cur_cost - best_cost) / (1.0 + jnp.abs(best_cost))
            return best_u, jnp.minimum(min_imp, imp)

        u = load3(u_ref)
        imp0 = jnp.full((1, u[0].shape[1]), jnp.inf, jnp.float32)
        u, imp = jax.lax.fori_loop(
            0, config.max_iterations, newton_round, (u, imp0)
        )
        # exact rollout + cost of the final iterate, so the host-side
        # finalize needs no further device work
        pos_f, vel_f, acc_f = rollout(u)
        J_f = cost_terms(pos_f, vel_f, acc_f, u)
        for a in range(3):
            u_out[a] = u[a]
            pos_out[a] = pos_f[a]
            vel_out[a] = vel_f[a]
        sc_out[0:1, :] = imp
        sc_out[1:2, :] = J_f

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "use_obstacles", "block_b", "interpret",
    ),
)
def solve_thrusts_fused(
    config,
    prob: costs.Problem,
    u_init: Array,
    use_obstacles: bool = True,
    block_b: int = 16,
    interpret: bool = False,
) -> tuple:
    """Run the fused solve; returns ``(thrusts, min_improvement,
    positions, velocities, cost)``: thrusts/positions/velocities have
    ``u_init``'s shape, min_improvement and cost are batch-shaped.
    min_improvement is the minimum realized relative cost decrease over
    the final Newton stage (the ftol input, as on the XLA path);
    positions/velocities/cost come from the kernel's exact fp32 rollout
    and cost of the final iterate.

    Accepts any leading batch shape (flattened internally). The batch is
    padded to a multiple of the scenario block (:func:`block_size`), one
    program per block. ``interpret=True`` runs the kernel in the Pallas
    interpreter (CPU tests); otherwise it compiles through Triton.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    N = config.prediction_horizon
    ops = _axis_operands(config)
    NPN = ops["NPN"]
    K = prob.obstacles.shape[-2] if use_obstacles else 0
    dtype = jnp.float32

    batch_shape = u_init.shape[:-2]
    B = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    Bb = block_size(B, block_b)
    B_pad = -(-B // Bb) * Bb

    def flat(x, trailing):
        x = jnp.broadcast_to(jnp.asarray(x, dtype), batch_shape + trailing)
        x = x.reshape((B,) + trailing)
        return jnp.pad(x, [(0, B_pad - B)] + [(0, 0)] * len(trailing))

    def axis_rows(x):  # (B_pad, N, 3) -> (3, NPN, B_pad), zero padding rows
        return jnp.pad(jnp.transpose(x, (2, 1, 0)), ((0, 0), (0, NPN - N), (0, 0)))

    if prob.goal.ndim == len(batch_shape) + 2:
        goal = flat(prob.goal, (N, 3))
    else:
        goal = jnp.broadcast_to(flat(prob.goal, (3,))[:, None, :], (B_pad, N, 3))
    p0 = flat(prob.p0, (3,)).T[:, None, :]  # (3, 1, B_pad)
    v0 = flat(prob.v0, (3,)).T[:, None, :]
    g_enu = jnp.asarray([0.0, 0.0, -config.gravity], dtype)[:, None, None]
    col = lambda name: jnp.asarray(ops[name])[None, :, None]  # noqa: E731
    C_pos = col("valid") * p0 + col("t") * v0 + col("spg") * g_enu
    C_vel = col("valid") * v0 + col("svg") * g_enu

    args = [axis_rows(flat(u_init, (N, 3))), C_pos, C_vel, axis_rows(goal)]
    spec3 = pl.BlockSpec((3, NPN, Bb), lambda i: (0, 0, i))
    rows = lambda r: pl.BlockSpec((r, Bb), lambda i: (0, i))  # noqa: E731
    in_specs = [spec3] * 4
    if K:
        obs = flat(prob.obstacles, (K, 4))
        mask = flat(prob.obstacle_mask, (K,)) > 0.5
        r = jnp.where(mask, obs[..., 3], -1e30)
        obs = jnp.concatenate([obs[..., :3], r[..., None]], axis=-1)
        args.append(obs.reshape(B_pad, 4 * K).T)  # rows 4k..4k+3: cx,cy,cz,r
        in_specs.append(rows(4 * K))
    dynamic_vmax = prob.v_cap is not None
    if dynamic_vmax:
        args.append(flat(prob.v_cap, ())[None, :])
        in_specs.append(rows(1))
    mats = jnp.asarray(ops["mats"])
    args.append(mats)
    in_specs.append(pl.BlockSpec(mats.shape, lambda i: (0, 0, 0)))

    kernel = _solver_kernel(config, NPN, K, dynamic_vmax)
    out3 = jax.ShapeDtypeStruct((3, NPN, B_pad), dtype)
    u_out, pos_out, vel_out, sc_out = pl.pallas_call(
        kernel,
        out_shape=(out3, out3, out3, jax.ShapeDtypeStruct((2, B_pad), dtype)),
        grid=(B_pad // Bb,),
        in_specs=in_specs,
        out_specs=(spec3, spec3, spec3, rows(2)),
        compiler_params=pl_triton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="se3_mpc_solve",
    )(*args)

    def unrows(xt):  # (3, NPN, B_pad) -> (..., N, 3)
        out = jnp.transpose(xt[:, :N, :B], (2, 1, 0))
        return out.reshape(batch_shape + (N, 3)).astype(u_init.dtype)

    def unscalar(v):  # (B_pad,) -> (...)
        return v[:B].reshape(batch_shape).astype(u_init.dtype)

    return (
        unrows(u_out),
        unscalar(sc_out[0]),
        unrows(pos_out),
        unrows(vel_out),
        unscalar(sc_out[1]),
    )

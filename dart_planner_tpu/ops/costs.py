"""SE(3) MPC cost model.

Reproduces the reference objective (se3_mpc_planner.py:516-550) over the
condensed thrust-only variable set, plus the obstacle penalty the reference
*declares* but never enforces (its L-BFGS-B ignores constraint dicts,
se3_mpc_planner.py:404-424; SURVEY.md 3.1) — here obstacles are a smooth
hinge penalty that actually binds.

Cost terms (weights from SE3MPCConfig, se3_mpc_planner.py:55-64):

    J(u) = sum_k  w_p ||p_k - goal||^2                (position tracking)
         + sum_k  w_v ||v_k||^2                       (velocity regulation)
         + sum_k  w_a ||a_k||^2                       (smoothness)
         + sum_k  w_T ||u_k - h e3||^2                (control effort, h = m g)
         + 10 w_p ||p_{N-1} - goal||^2                (terminal)
         + w_obs sum_{k,o} relu(r_safe_o - d_ko)^2    (obstacle hinge)

with (p, v, a) the affine functions of u from
:mod:`dart_planner_tpu.ops.dynamics`. Everything is batched and jit-safe;
obstacles are a fixed-size padded set ``(K, 4)`` of (cx, cy, cz, r_safe)
rows with a boolean validity mask.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.ops import dynamics

Array = jnp.ndarray


class CostWeights(NamedTuple):
    """Static cost weights (python floats — hashable, part of jit closure)."""

    position: float = 100.0
    velocity: float = 10.0
    acceleration: float = 1.0
    thrust: float = 0.1
    terminal: float = 10.0  # multiplier on position weight at the last step
    obstacle: float = 1000.0
    ground: float = 0.0  # ground-clearance hinge weight (0 = off)
    ground_altitude: float = 0.0  # min altitude z_min for the hinge
    velocity_bound: float = 0.0  # per-axis |v| <= v_max hinge weight (0 = off)
    max_velocity: float = 0.0  # v_max for the hinge
    # Thrust-feasibility hinges (novel vs reference). The reference bounds
    # each thrust AXIS separately (se3_mpc_planner.py:390-401), so box
    # corners command vectors tilted ~85 deg with norm up to sqrt(3) u_max —
    # thrusts no tilt-limited vehicle can produce. Tracking such plans is
    # what lost the closed-loop Monte-Carlo (success 0.609 -> 1.000 with
    # the hinges on, SE3MPCConfig.tilt_weight). Both hinges
    # are convex, with rank-1 thrust-space GN blocks.
    tilt: float = 0.0  # relu(||u_xy|| - tan_max_tilt * u_z)^2 weight
    tan_max_tilt: float = 0.0
    thrust_norm: float = 0.0  # relu(||u|| - max_thrust_norm)^2 weight
    max_thrust_norm: float = 0.0


class Problem(NamedTuple):
    """Per-scenario MPC problem data (pytree of arrays — traced)."""

    p0: Array  # (..., 3) current position
    v0: Array  # (..., 3) current velocity
    goal: Array  # (..., 3) goal position, or (..., N, 3) per-step
    # reference trajectory (tracking mode — beyond the reference planner,
    # which only supports a single goal point)
    obstacles: Array  # (..., K, 4): cx, cy, cz, r_safe (radius + margin)
    obstacle_mask: Array  # (..., K) bool
    # Optional per-scenario velocity cap (...,) in m/s overriding the
    # static ``CostWeights.max_velocity`` in the velocity-envelope hinge.
    # Lets the closed loop slow the vehicle through unknown (unobserved)
    # map regions without recompiling — the planner-side half of the
    # reference's "unknown voxels surface prior 0.5" signal
    # (explicit_geometric_mapper.py:154-169). None = use the static cap.
    v_cap: Optional[Array] = None


def effective_vmax(prob: Problem, weights: CostWeights):
    """Velocity-envelope cap: per-scenario ``prob.v_cap`` (broadcast over
    horizon and axis dims) when present, else the static weight."""
    if prob.v_cap is None:
        return weights.max_velocity
    return prob.v_cap[..., None, None]


def hover_thrust_vec(mass: float, gravity: float, dtype=jnp.float32) -> Array:
    """h e3: the control-effort setpoint (se3_mpc_planner.py:542)."""
    return jnp.array([0.0, 0.0, mass * gravity], dtype=dtype)


def obstacle_penalty(pos: Array, obstacles: Array, mask: Array) -> Array:
    """Smooth hinge penalty sum_{k,o} relu(r_safe - d)^2.

    ``pos`` (..., N, 3); ``obstacles`` (..., K, 4); ``mask`` (..., K).
    Distance is softened with a small epsilon so the gradient is defined at
    the obstacle center.
    """
    centers = obstacles[..., :3]  # (..., K, 3)
    r_safe = obstacles[..., 3]  # (..., K)
    diff = pos[..., :, None, :] - centers[..., None, :, :]  # (..., N, K, 3)
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-9)  # (..., N, K)
    viol = jnp.maximum(r_safe[..., None, :] - d, 0.0)
    viol = viol * mask[..., None, :].astype(viol.dtype)
    return jnp.sum(viol * viol, axis=(-1, -2))


def condensed_cost(
    u: Array,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Array,
) -> Array:
    """Total cost J(u) for thrusts ``u`` (..., N, 3). Returns (...)."""
    pos, vel, acc = dynamics.rollout_linear(u, prob.p0, prob.v0, dt, mass, gravity_vec)
    w = weights
    # gravity_vec z-component is negative in ENU; hover magnitude is m * |g|.
    hover = jnp.array([0.0, 0.0, 1.0], dtype=u.dtype) * (mass * jnp.abs(gravity_vec[2]))

    goal = prob.goal
    # per-step reference iff goal carries one more axis than the state
    # (p0 rank is the true batch rank; pos may carry extra candidate axes
    # from the vectorized line search, so compare against p0, not pos)
    if goal.ndim != prob.p0.ndim + 1:
        goal = goal[..., None, :]  # single point -> broadcast over horizon
    pe = pos - goal
    J = w.position * jnp.sum(pe * pe, axis=(-1, -2))
    J += w.velocity * jnp.sum(vel * vel, axis=(-1, -2))
    J += w.acceleration * jnp.sum(acc * acc, axis=(-1, -2))
    du = u - hover
    J += w.thrust * jnp.sum(du * du, axis=(-1, -2))
    term = pos[..., -1, :] - goal[..., -1, :]
    J += w.terminal * w.position * jnp.sum(term * term, axis=-1)
    J += w.obstacle * obstacle_penalty(pos, prob.obstacles, prob.obstacle_mask)
    if w.ground > 0.0:
        # ground-clearance hinge sum_k relu(z_min - z_k)^2 — keeps plans
        # above the floor (the reference only *validates* altitude >= 0.1
        # post-hoc, se3_mpc_planner.py:727; here it shapes the solution)
        gviol = jnp.maximum(w.ground_altitude - pos[..., 2], 0.0)
        J += w.ground * jnp.sum(gviol * gviol, axis=-1)
    if w.velocity_bound > 0.0:
        # per-axis velocity-envelope hinge: the reference encodes
        # +-max_velocity as hard box bounds on its velocity decision
        # variables (se3_mpc_planner.py:387-389); condensing eliminated
        # those variables, so the envelope returns as a penalty.
        # ``prob.v_cap`` (when set) tightens the cap per scenario.
        vviol = jnp.maximum(jnp.abs(vel) - effective_vmax(prob, w), 0.0)
        J += w.velocity_bound * jnp.sum(vviol * vviol, axis=(-1, -2))
    if w.tilt > 0.0:
        # tilt-cone hinge: ||u_xy|| <= tan(theta_max) u_z. The box bounds
        # alone admit ~85deg-tilt corners no real vehicle tracks.
        lat = jnp.sqrt(jnp.sum(u[..., :2] * u[..., :2], axis=-1) + 1e-9)
        tviol = jnp.maximum(lat - w.tan_max_tilt * u[..., 2], 0.0)
        J += w.tilt * jnp.sum(tviol * tviol, axis=-1)
    if w.thrust_norm > 0.0:
        # total-thrust hinge: ||u|| <= u_max (the box allows sqrt(3) u_max)
        un = jnp.sqrt(jnp.sum(u * u, axis=-1) + 1e-9)
        nviol = jnp.maximum(un - w.max_thrust_norm, 0.0)
        J += w.thrust_norm * jnp.sum(nviol * nviol, axis=-1)
    return J


def condensed_grad(
    u: Array,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Array,
) -> Array:
    """Analytic gradient dJ/du via reverse-mode AD (exact; XLA fuses the
    whole rollout + cost + pullback into one kernel)."""
    return jax.grad(
        lambda uu: jnp.sum(
            condensed_cost(uu, prob, weights, dt, mass, gravity_vec)
        )
    )(u)


@functools.lru_cache(maxsize=32)
def quadratic_hessian(
    N: int,
    dt: float,
    mass: float,
    gravity_z: float,
    weights: CostWeights,
) -> np.ndarray:
    """Constant per-axis Hessian (N, N) of the quadratic cost terms wrt u.

    Per axis d (the quadratic terms never couple axes):

        H = 2 [ w_p (S_p^T S_p + 10 s_N s_N^T) + w_v S_v^T S_v
                + (w_a / m^2 + w_T) I ] / m^2-scaled appropriately

    where p = const + S_p a, a = u/m + g, so dp/du = S_p / m.
    Computed in float64 once per configuration and cached.
    """
    S_p, S_v, _ = dynamics.rollout_matrices(N, dt)
    w = weights
    Hp = S_p.T @ S_p + w.terminal * np.outer(S_p[-1], S_p[-1])
    Hv = S_v.T @ S_v
    H = 2.0 * (
        w.position * Hp / (mass * mass)
        + w.velocity * Hv / (mass * mass)
        + (w.acceleration / (mass * mass) + w.thrust) * np.eye(N)
    )
    return H


def obstacle_gn_hessian(
    u: Array,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Array,
    include_obstacles: bool = True,
) -> Array:
    """Gauss-Newton Hessian of the hinge penalties (obstacles + ground),
    pulled back to thrust space. Returns (..., N, 3, N, 3).

    Residuals r_ko = relu(r_safe_o - d_ko); J_r wrt p_k = -diff_ko / d_ko
    where active. H_p[k] = 2 w_obs sum_o n n^T (3x3 per step), then
    H_u[(k1,a1),(k2,a2)] = sum_k S_p[k,k1] S_p[k,k2] H_p[k,a1,a2] / m^2.
    The ground hinge adds 2 w_g e_z e_z^T on active steps; the velocity
    hinge adds 2 w_vb per active axis, pulled back through S_v.
    """
    pos, vel, _ = dynamics.rollout_linear(u, prob.p0, prob.v0, dt, mass, gravity_vec)
    N_h = u.shape[-2]
    Hp = jnp.zeros(u.shape[:-2] + (N_h, 3, 3), u.dtype)
    centers = prob.obstacles[..., :3]
    r_safe = prob.obstacles[..., 3]
    diff = pos[..., :, None, :] - centers[..., None, :, :]  # (..., N, K, 3)
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-9)
    active = (
        (r_safe[..., None, :] > d)
        & prob.obstacle_mask[..., None, :]
    ).astype(u.dtype)
    n = diff / d[..., None]  # unit normals (..., N, K, 3)
    # per-step 3x3 position-space GN blocks
    if include_obstacles:
        Hp = Hp + 2.0 * weights.obstacle * jnp.einsum(
            "...nka,...nkb,...nk->...nab", n, n, active,
            precision=jax.lax.Precision.HIGHEST,
        )  # (..., N, 3, 3)
    if weights.ground > 0.0:
        g_active = (pos[..., 2] < weights.ground_altitude).astype(u.dtype)
        Hp = Hp.at[..., 2, 2].add(2.0 * weights.ground * g_active)
    S_p_np, S_v_np, _ = dynamics.rollout_matrices(N_h, float(dt))
    S_p = jnp.asarray(S_p_np, u.dtype) / mass
    H_u = jnp.einsum(
        "ki,kj,...kab->...iajb", S_p, S_p, Hp,
        precision=jax.lax.Precision.HIGHEST,
    )
    if weights.velocity_bound > 0.0:
        v_active = (jnp.abs(vel) > effective_vmax(prob, weights)).astype(
            u.dtype
        )
        S_v = jnp.asarray(S_v_np, u.dtype) / mass
        # diagonal per-axis velocity blocks: H_v[k,a] = 2 w_vb 1{active}
        Hv_diag = 2.0 * weights.velocity_bound * v_active  # (..., N, 3)
        tmp = jnp.einsum(
            "ki,kj,...ka->...iaj",
            S_v,
            S_v,
            Hv_diag,
            precision=jax.lax.Precision.HIGHEST,
        )  # (..., N, 3, N); axes never couple, so spread with delta_ab
        H_u = H_u + tmp[..., None] * jnp.eye(3, dtype=u.dtype)[None, :, None, :]
    return H_u


def penalty_blocks(
    u: Array,
    prob: Problem,
    weights: CostWeights,
    dt: float,
    mass: float,
    gravity_vec: Array,
    include_obstacles: bool = True,
    full_curvature: bool = False,
) -> tuple[Array, Array, Array | None]:
    """Per-step Hessian blocks of the hinge penalties.

    Returns ``(Hp, Hv_diag, Hu)`` with ``Hp`` (..., N, 3, 3) position-space
    blocks (obstacles + ground), ``Hv_diag`` (..., N, 3) diagonal
    velocity-space entries (velocity-envelope hinge), and ``Hu``
    (..., N, 3, 3) thrust-space blocks (tilt-cone + thrust-norm hinges) or
    ``None`` when both are off. These feed the matrix-free Newton-CG in the
    solver; the full thrust-space Hessian (:func:`obstacle_gn_hessian`) is
    never materialized on the hot path — building its (..., 3N, 3N) tensor
    dominated solve time at batch 4096.

    ``full_curvature=False`` gives Gauss-Newton blocks (outer products of
    hinge gradients only). ``True`` adds the ``h * hess(h)`` terms the GN
    model drops: for the sphere-obstacle hinge ``w max(0, r - d)^2`` the
    distance Hessian contributes NEGATIVE tangential curvature
    ``-2 w (h/d)(I - n n^T)`` — the "sliding around the sphere is
    downhill" information — while the tilt-cone and thrust-norm hinges
    (convex norms) contribute positive curvature GN underestimates. The
    full model makes the Newton system indefinite near deep obstacle
    violations; the solver guards with Steihaug CG truncation and a
    clamped Jacobi diagonal (see solve_se3_mpc).
    """
    pos, vel, _ = dynamics.rollout_linear(u, prob.p0, prob.v0, dt, mass, gravity_vec)
    N_h = u.shape[-2]
    Hp = jnp.zeros(u.shape[:-2] + (N_h, 3, 3), u.dtype)
    if include_obstacles:
        centers = prob.obstacles[..., :3]
        r_safe = prob.obstacles[..., 3]
        diff = pos[..., :, None, :] - centers[..., None, :, :]
        d = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-9)
        active = (
            (r_safe[..., None, :] > d) & prob.obstacle_mask[..., None, :]
        ).astype(u.dtype)
        n = diff / d[..., None]
        if full_curvature:
            # full Hessian of w max(0, r-d)^2:
            #   2w [ n n^T - (h/d)(I - n n^T) ]
            #   = 2w (1 + h/d) n n^T - 2w (h/d) I
            hd = jnp.maximum(r_safe[..., None, :] - d, 0.0) / d
            Hp = Hp + 2.0 * weights.obstacle * jnp.einsum(
                "...nka,...nkb,...nk->...nab", n, n, active * (1.0 + hd),
                precision=jax.lax.Precision.HIGHEST,
            )
            eye = jnp.eye(3, dtype=u.dtype)
            Hp = Hp - (
                2.0 * weights.obstacle
                * jnp.sum(active * hd, axis=-1)[..., None, None]
            ) * eye
        else:
            Hp = Hp + 2.0 * weights.obstacle * jnp.einsum(
                "...nka,...nkb,...nk->...nab", n, n, active,
                precision=jax.lax.Precision.HIGHEST,
            )
    if weights.ground > 0.0:
        g_active = (pos[..., 2] < weights.ground_altitude).astype(u.dtype)
        Hp = Hp.at[..., 2, 2].add(2.0 * weights.ground * g_active)
    Hv_diag = jnp.zeros(u.shape[:-2] + (N_h, 3), u.dtype)
    if weights.velocity_bound > 0.0:
        v_active = (jnp.abs(vel) > effective_vmax(prob, weights)).astype(
            u.dtype
        )
        Hv_diag = jnp.broadcast_to(
            2.0 * weights.velocity_bound * v_active, Hv_diag.shape
        )
    Hu = None
    if weights.tilt > 0.0 or weights.thrust_norm > 0.0:
        Hu = jnp.zeros(u.shape[:-2] + (N_h, 3, 3), u.dtype)
    if weights.tilt > 0.0:
        # v = ||u_xy|| - tan * u_z; GN block 2 w 1{v>0} (dv)(dv)^T with
        # dv = (ux/lat, uy/lat, -tan)
        lat = jnp.sqrt(jnp.sum(u[..., :2] * u[..., :2], axis=-1) + 1e-9)
        tv = jnp.maximum(lat - weights.tan_max_tilt * u[..., 2], 0.0)
        t_active = (tv > 0.0).astype(u.dtype)
        jv = jnp.concatenate(
            [
                u[..., :2] / lat[..., None],
                jnp.broadcast_to(
                    jnp.asarray(-weights.tan_max_tilt, u.dtype),
                    u.shape[:-1] + (1,),
                ),
            ],
            axis=-1,
        )
        Hu = Hu + 2.0 * weights.tilt * t_active[..., None, None] * (
            jv[..., :, None] * jv[..., None, :]
        )
        if full_curvature:
            # + 2 w tv hess(lat): hess = (I2 - q q^T)/lat on the xy block
            # (convex; positive semidefinite)
            q = u[..., :2] / lat[..., None]
            eye2 = jnp.eye(2, dtype=u.dtype)
            hxy = (eye2 - q[..., :, None] * q[..., None, :]) / lat[
                ..., None, None
            ]
            Hu = Hu.at[..., :2, :2].add(
                2.0 * weights.tilt * tv[..., None, None] * hxy
            )
    if weights.thrust_norm > 0.0:
        un = jnp.sqrt(jnp.sum(u * u, axis=-1) + 1e-9)
        nvh = jnp.maximum(un - weights.max_thrust_norm, 0.0)
        n_active = (nvh > 0.0).astype(u.dtype)
        nv = u / un[..., None]
        Hu = Hu + 2.0 * weights.thrust_norm * n_active[..., None, None] * (
            nv[..., :, None] * nv[..., None, :]
        )
        if full_curvature:
            # + 2 w nvh hess(||u||): (I - n n^T)/||u|| (convex, PSD)
            eye3 = jnp.eye(3, dtype=u.dtype)
            hn = (eye3 - nv[..., :, None] * nv[..., None, :]) / un[
                ..., None, None
            ]
            Hu = Hu + 2.0 * weights.thrust_norm * nvh[..., None, None] * hn
    return Hp, Hv_diag, Hu

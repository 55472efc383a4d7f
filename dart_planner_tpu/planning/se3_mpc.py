"""SE(3) model-predictive trajectory optimizer for batched accelerator solves.

Re-design of the reference ``SE3MPCPlanner``
(/root/reference/src/dart_planner/planning/se3_mpc_planner.py): same cost
model, bounds, warm-start policy, and trajectory extraction — but the solver
is a **condensed projected-Newton QP** instead of scipy L-BFGS-B over a 9N
vector:

- Decision variables are thrust vectors only (3N); dynamics are eliminated
  through the affine rollout (:mod:`dart_planner_tpu.ops.dynamics`), so every
  iterate is exactly dynamics-feasible. The reference *declares* dynamics
  equality constraints but its bounds-only L-BFGS-B never enforces them
  (se3_mpc_planner.py:404-424; SURVEY.md 3.1) — this solver is a strict
  superset.
- Box bounds on thrust (tilt-limited x/y, min/max z;
  se3_mpc_planner.py:378-402) are handled by an active-set-masked Newton
  step with a projected vectorized line search.
- Obstacles (se3_mpc_planner.py:499-514) enter as a smooth hinge penalty
  with a Gauss-Newton Hessian contribution, so avoidance actually binds.
- Everything is a pure jittable function of fixed-shape inputs: one solve,
  a vmapped 4096-scenario Monte-Carlo batch, and a shard_mapped multi-host
  fleet all call the same code.

A scipy-free "reference mode" reproducing the reference solver's separable
fixed point (for output-equivalence tests) lives in
:mod:`dart_planner_tpu.planning.reference_mode`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from dart_planner_tpu.common import frames
from dart_planner_tpu.common.types import DroneState, Trajectory
from dart_planner_tpu.ops import costs, dynamics, so3

Array = jnp.ndarray


class SE3MPCConfig(NamedTuple):
    """Static solver configuration (hashable; safe as a jit static arg).

    Defaults mirror reference ``SE3MPCConfig`` (se3_mpc_planner.py:36-79)
    except ``prediction_horizon`` defaults to the north-star N=20 and
    ``dt`` to 0.1 (config/defaults.yaml planning.dt).
    """

    prediction_horizon: int = 20
    dt: float = 0.1

    max_velocity: float = 10.0  # m/s
    max_acceleration: float = 15.0  # m/s^2
    max_thrust: float = 25.0  # N
    min_thrust: float = 2.0  # N
    max_tilt_angle: float = float(np.pi / 4)  # rad

    position_weight: float = 100.0
    velocity_weight: float = 10.0
    acceleration_weight: float = 1.0
    thrust_weight: float = 0.1
    terminal_weight: float = 10.0
    obstacle_weight: float = 1000.0
    safety_margin: float = 1.5  # m

    max_iterations: int = 12
    convergence_tolerance: float = 5e-2
    # Convergence is declared by realized progress (scipy L-BFGS-B ftol
    # semantics, the criterion the reference's solver actually terminates
    # on): relative cost decrease in the final Newton round <= ftol.
    # Measured honest on the bench batch: scenarios converged by this
    # criterion sit within ~2e-6 of a 60-iteration ground-truth cost at
    # p95 (scripts/diag_convergence.py). The raw projected-gradient norm
    # stays O(hinge weight) near active hinge boundaries even at optimum,
    # so it is reported as a diagnostic, not used as the gate.
    ftol: float = 1e-6
    # Inner PCG iterations per Newton step. cond(H_quad) ~ 300 with the
    # Jacobi preconditioner; measured on randomized obstacle batches,
    # 10 inner iterations matches or beats 25 on convergence rate and
    # p95 cost-vs-ground-truth (the CG loop dominates solve FLOPs, so
    # this sets throughput almost 1:1).
    cg_iterations: int = 10
    # Projected-line-search step candidates (largest first; the current
    # iterate is always an implicit fallback candidate).
    line_search_alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    # Two-stage Newton: after ``gn_warmup_iterations`` Gauss-Newton
    # rounds, switch to full hinge Hessians (h * hess(h) terms). The
    # obstacle hinge's negative tangential curvature is what lets Newton
    # slide around a sphere in one step instead of crawling; guarded by
    # Steihaug CG truncation + clamped Jacobi diagonal
    # (costs.penalty_blocks docstring). Full curvature from a COLD start
    # can leave the right basin (measured max cost-vs-ground-truth 17.8x,
    # on the bench batch); staged after a GN warmup it keeps GN's
    # basin and cuts p95 cost excess ~10x at equal iteration budget.
    newton_full_curvature: bool = True
    gn_warmup_iterations: int = 6

    # Adaptive tail refinement (two-phase solve; VERDICT round-3 item 2):
    # after the fixed-budget phase-1 solve, the ``tail_capacity`` fraction
    # of scenarios ranked unconverged-first is gathered into a compact
    # batch and refined for ``tail_iterations`` full-curvature Newton
    # rounds at ``tail_cg_iterations`` inner CG steps. The slow tail's
    # ~0.5x/round cost-error decay is INNER-CG-limited (hinge blocks at
    # weight 1000 push the reduced condition number far past the CG-10
    # design point; measured per-round decay matches the CG error factor)
    # — CG-25 restores a ~0.2x/round decay, so a few refine rounds stall
    # (ftol-converge) most of the tail. Refining only the compacted tail
    # keeps the extra cost ~ capacity * rounds instead of batch * rounds.
    # 0 disables (single-phase solve). Applied by :func:`solve`;
    # :func:`solve_se3_mpc` itself stays single-phase. Budget chosen on
    # the bench batch (scripts/diag_convergence.py): 12+8@25 at capacity
    # 0.25 measures conv 0.966 / max excess 0.044 (XLA path, 4096
    # scenarios) vs 0.775 / 1.08 single-phase.
    tail_iterations: int = 8
    tail_cg_iterations: int = 25
    tail_capacity: float = 0.25
    # Trimmed line-search grid for the refine rounds: near convergence
    # the tiny-alpha candidates almost never win, and each candidate is
    # a full cost pass (the largest share of a round). Measured on the bench
    # batch: conv 0.966 -> 0.979 at identical max excess (fewer
    # micro-improvements also means the ftol stall triggers honestly
    # sooner).
    tail_line_search_alphas: tuple = (1.0, 0.5, 0.25, 0.05)
    # Perturbed restart (phase 3, optional; VERDICT round-4 item 7):
    # the most SUSPICIOUS scenarios after the tail pass (ranked by
    # cost / hinge-free-quadratic-floor, still-unconverged first) are
    # re-solved from a jittered cold start in a compact batch, keeping
    # whichever result costs less. This is basin escape for the
    # nonconvex obstacle hinge: a basin-stuck scenario ftol-STALLS
    # (it is declared converged — progress genuinely stopped, in the
    # wrong basin), so no amount of polishing, and no unconverged-first
    # selection, can touch it. Anatomy of the one known instance
    # (scripts/diag_stuck.py, XLA path, excess 1.084): 98% of
    # 1-2 N jittered QP starts reach the true basin under the staged
    # shipping schedule — but 0% of unjittered starts, and large noise
    # (4-8 N) degrades to ~70%. Hence the defaults: noise 2 N, the
    # BASE staged Newton schedule (full curvature from a cold start is
    # exactly the basin-leaving regime the gn_warmup doc warns about),
    # a budget of ~20 rounds when enabled (12 landed the known instance
    # in a THIRD basin at excess 0.71; 20 reaches ground truth —
    # measured max excess 1.08 -> 0.080 across the 4096-bench batch),
    # and capacity 0.25 (matching the tail pass's lane count): the
    # suspicion signal separates stuck scenarios only into the top
    # 10-15% (measured positions ~410-540/4096 behind the ~2%
    # unconverged prefix), and WHICH scenarios stick varies per
    # compiled executable (line-search near-ties land differently per
    # fusion), so the cohort needs generous margin. 0 disables (the
    # shipping
    # default: the fused path's aggregate quality does not need it, and
    # the fleet cadence absorbs rare stragglers via warm-started
    # replans).
    restart_iterations: int = 0
    restart_capacity: float = 0.25
    restart_noise: float = 2.0  # N: thrust-plan jitter std around the init
    # Cold-start mode for :func:`initialize_thrusts`: "qp" starts at the
    # box-clipped unconstrained minimizer of the QUADRATIC cost terms
    # (one precomputed (N,N)-inverse matmul per axis — the constant
    # Hessian makes the hinge-free problem exactly solvable), "hover" at
    # hover thrust (the round-3 behavior). Measured on the bench batch,
    # "qp" starts in better basins: max cost-vs-ground-truth excess at
    # the 12-round budget drops ~40x while p95 is unchanged.
    cold_start: str = "qp"

    # Goal-adjacent margin clamp (0 = off, the reference-parity
    # default): per-obstacle, the ADDED safety margin shrinks just
    # enough that the inflated ball keeps ``goal_margin_clamp`` metres
    # clear of the goal (floored at 0.1 m of margin — the raw radius is
    # never touched). Rationale (scripts/diag_timeouts.py, 2048-episode
    # fleet): 94% of closed-loop quiet failures were goal-adjacent
    # hover standoffs where an obstacle's radius + 1.5 m margin ball
    # swallowed the goal — the hinge/goal-attraction equilibrium then
    # parks ~1.2 m out, just outside the 1 m success ring, forever
    # (more episode time converts only ~25% of them). Success when the
    # goal was margin-blocked: 0.815, vs 0.994 when clear. The mission
    # chose a goal there; refusing to approach is conservatism in the
    # wrong place.
    goal_margin_clamp: float = 0.0
    # Minimum ADDED margin after clamping. Swept on the 2048-episode
    # bench fleet (scripts/diag_goalclamp.py): floor 0.1 converts the
    # timeout cohort but doubles crashes (0.0049 -> 0.0103, plans skim
    # the clamped obstacle); 0.6 keeps the full conversion at the
    # pre-clamp crash rate (success 0.9937 / crash 0.0049).
    goal_margin_floor: float = 0.6

    ground_weight: float = 50000.0  # ground-clearance hinge (novel vs reference)
    min_altitude: float = 0.3  # m
    velocity_bound_weight: float = 1000.0  # +-max_velocity hinge (ref box bound)
    # Thrust-feasibility hinges (novel vs reference; costs.CostWeights
    # docstring): keep ||u_xy|| <= tan(max_tilt) u_z and ||u|| <= max_thrust.
    # The reference's per-axis box admits ~85deg-tilt / sqrt(3) u_max
    # corners that a tilt-limited vehicle cannot track; plans built on them
    # lose the closed loop (2048 windy episodes: MC success 0.609 ->
    # 1.000 when enabled).
    tilt_weight: float = 10.0
    thrust_norm_weight: float = 10.0

    mass: float = 1.5  # kg (se3_mpc_planner.py:149)
    gravity: float = 9.81

    max_obstacles: int = 8  # static padded obstacle capacity

    @property
    def weights(self) -> costs.CostWeights:
        return costs.CostWeights(
            position=self.position_weight,
            velocity=self.velocity_weight,
            acceleration=self.acceleration_weight,
            thrust=self.thrust_weight,
            terminal=self.terminal_weight,
            obstacle=self.obstacle_weight,
            ground=self.ground_weight,
            ground_altitude=self.min_altitude,
            velocity_bound=self.velocity_bound_weight,
            max_velocity=self.max_velocity,
            tilt=self.tilt_weight,
            tan_max_tilt=float(np.tan(self.max_tilt_angle)),
            thrust_norm=self.thrust_norm_weight,
            max_thrust_norm=self.max_thrust,
        )

    @property
    def hover_thrust(self) -> float:
        return self.mass * self.gravity

    def thrust_bounds(self, dtype=jnp.float32) -> tuple[Array, Array]:
        """Per-step (lb, ub) each (3,): tilt-limited x/y, [min,max] z
        (se3_mpc_planner.py:390-401)."""
        mtt = self.max_thrust * float(np.sin(self.max_tilt_angle))
        lb = jnp.array([-mtt, -mtt, self.min_thrust], dtype)
        ub = jnp.array([mtt, mtt, self.max_thrust], dtype)
        return lb, ub


class SolveResult(NamedTuple):
    """Solver output: dynamics-consistent state sequences + diagnostics."""

    thrusts: Array  # (..., N, 3) thrust vectors
    positions: Array  # (..., N, 3)
    velocities: Array  # (..., N, 3)
    accelerations: Array  # (..., N, 3)
    cost: Array  # (...)
    converged: Array  # (...) bool: see _finalize docstring (ftol criterion)
    grad_norm: Array  # (...) projected-gradient norm (diagnostic)
    # realized relative cost decrease in the final Newton round (what the
    # ftol convergence criterion evaluates); None on legacy paths
    min_improvement: Optional[Array] = None


def effective_margins(
    config: SE3MPCConfig, obstacles: Array, goal_pt: Array
) -> Array:
    """Per-obstacle safety margin to ADD to raw radii (..., K).

    With ``config.goal_margin_clamp`` > 0, an obstacle whose inflated
    ball (radius + safety_margin) would swallow the goal gets its ADDED
    margin shrunk so the ball stays ``goal_margin_clamp`` m clear of
    the goal, floored at 0.1 m — the raw radius is never reduced, so
    the hinge still guards the physical surface. See the config
    docstring for the measured closed-loop rationale."""
    margin = jnp.asarray(config.safety_margin, obstacles.dtype)
    if config.goal_margin_clamp <= 0.0:
        return jnp.broadcast_to(margin, obstacles.shape[:-1])
    gd = jnp.linalg.norm(
        goal_pt[..., None, :] - obstacles[..., :3], axis=-1
    )
    room = gd - obstacles[..., 3] - config.goal_margin_clamp
    return jnp.clip(
        jnp.minimum(margin, room), config.goal_margin_floor, margin
    )


def make_problem(
    position,
    velocity,
    goal,
    obstacles: Optional[Array] = None,
    obstacle_mask: Optional[Array] = None,
    config: SE3MPCConfig = SE3MPCConfig(),
    dtype=jnp.float32,
) -> costs.Problem:
    """Build a fixed-shape Problem; pads obstacles to ``config.max_obstacles``.

    ``obstacles`` rows are (cx, cy, cz, radius); the safety margin
    (se3_mpc_planner.py:509) is added here so the solver sees r_safe.
    """
    K = config.max_obstacles
    p0 = jnp.asarray(position, dtype)
    v0 = jnp.asarray(velocity, dtype)
    g = jnp.asarray(goal, dtype)
    batch = p0.shape[:-1]
    if obstacles is None:
        obs = jnp.zeros(batch + (K, 4), dtype)
        mask = jnp.zeros(batch + (K,), bool)
    else:
        obs_in = jnp.asarray(obstacles, dtype)
        n = obs_in.shape[-2]
        if n > K:
            raise ValueError(f"{n} obstacles > max_obstacles={K}")
        goal_pt = g[..., -1, :] if g.ndim == len(batch) + 2 else g
        obs_in = obs_in.at[..., 3].add(
            effective_margins(config, obs_in, goal_pt)
        )
        pad = [(0, 0)] * (obs_in.ndim - 2) + [(0, K - n), (0, 0)]
        obs = jnp.pad(obs_in, pad)
        if obstacle_mask is None:
            m = jnp.ones(obs_in.shape[:-1], bool)
        else:
            m = jnp.asarray(obstacle_mask, bool)
        mask = jnp.pad(m, [(0, 0)] * (m.ndim - 1) + [(0, K - n)])
    return costs.Problem(p0=p0, v0=v0, goal=g, obstacles=obs, obstacle_mask=mask)


@functools.lru_cache(maxsize=32)
def _quadratic_hessian_inverse(config: SE3MPCConfig) -> np.ndarray:
    """Inverse of the constant per-axis quadratic Hessian (float64 solve,
    cached per config) — the QP cold start is one matmul with this."""
    H = costs.quadratic_hessian(
        config.prediction_horizon, config.dt, config.mass, config.gravity,
        config.weights,
    )
    return np.linalg.inv(np.asarray(H, np.float64)).astype(np.float32)


def initialize_thrusts(
    config: SE3MPCConfig, prob: costs.Problem, mode: Optional[str] = None
) -> Array:
    """Cold start (the condensed analog of the reference's straight-line
    init, se3_mpc_planner.py:329-359 — positions are no longer decision
    variables, so only the thrust guess remains).

    ``mode`` (default ``config.cold_start``):

    - ``"qp"``: exact unconstrained minimizer of the quadratic cost terms
      — the constant per-axis Hessian is invertible once per config, and
      the gradient at hover is affine in (p0, v0, goal), so the optimum
      is ``u_h - H^-1 g(u_h)`` (box-clipped). Scenarios whose hinges
      never activate start essentially converged; obstacle-heavy
      scenarios start on the quadratic-optimal trajectory, which lands
      the staged Newton in materially better basins than hover
      (measured: max cost excess at the 12-round budget ~40x lower).
    - ``"hover"``: hover thrust at every step.
    """
    N = config.prediction_horizon
    batch = prob.p0.shape[:-1]
    dtype = prob.p0.dtype
    hover = jnp.array([0.0, 0.0, config.hover_thrust], dtype)
    u_h = jnp.broadcast_to(hover, batch + (N, 3))
    if (mode or config.cold_start) == "hover":
        return u_h
    # gradient of the quadratic terms only (hinge weights zeroed; the
    # obstacle term vanishes with weight 0, so masks need no stripping)
    w_quad = config.weights._replace(
        obstacle=0.0, ground=0.0, velocity_bound=0.0, tilt=0.0,
        thrust_norm=0.0,
    )
    gvec = frames.gravity_vector(
        frames.WorldFrame.ENU, config.gravity
    ).astype(dtype)
    g = costs.condensed_grad(u_h, prob, w_quad, config.dt, config.mass, gvec)
    Hinv = jnp.asarray(_quadratic_hessian_inverse(config), dtype)
    u_qp = u_h - jnp.einsum(
        "ij,...jd->...id", Hinv, g, precision=jax.lax.Precision.HIGHEST
    )
    lb, ub = config.thrust_bounds(dtype)
    return jnp.clip(u_qp, lb, ub)


def shift_warm_start(config: SE3MPCConfig, u_prev: Array) -> Array:
    """Warm start by shifting the previous solution one step and repeating
    the last thrust (reference warm start, se3_mpc_planner.py:294-327)."""
    return jnp.concatenate([u_prev[..., 1:, :], u_prev[..., -1:, :]], axis=-2)


# Fixed line-search candidates: vectorized projected backtracking.
# line-search candidates now live in SE3MPCConfig.line_search_alphas


def _strip_obstacles(prob: costs.Problem) -> costs.Problem:
    """Zero the obstacle mask so the penalty vanishes from cost, gradient,
    Hessian, and reported diagnostics alike — ``use_obstacles=False`` must
    mean the same thing on every solver path."""
    return prob._replace(obstacle_mask=jnp.zeros_like(prob.obstacle_mask))


@functools.partial(
    jax.jit, static_argnames=("config", "use_obstacles", "with_grad")
)
def solve_se3_mpc(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u_init: Optional[Array] = None,
    use_obstacles: bool = True,
    with_grad: bool = True,
) -> SolveResult:
    """Projected-Newton solve of the condensed SE(3) MPC.

    Batched over any leading dims of ``prob``. Fixed iteration count
    (``config.max_iterations``) with a per-scenario convergence mask — no
    data-dependent control flow, so one XLA executable serves single-solve
    latency and 100k-scenario fleets alike.
    """
    N = config.prediction_horizon
    dt = config.dt
    mass = config.mass
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, config.gravity)
    w = config.weights

    if not use_obstacles:
        prob = _strip_obstacles(prob)
    if u_init is None:
        u_init = initialize_thrusts(config, prob)
    u = u_init
    dtype = u.dtype
    gvec = gvec.astype(dtype)
    lb, ub = config.thrust_bounds(dtype)
    batch = u.shape[:-2]
    n_flat = 3 * N

    # Constant quadratic Hessian per axis (N, N); the 3 axes never couple
    # in the quadratic terms. Computed once per config (cached).
    H_axis = jnp.asarray(
        costs.quadratic_hessian(N, dt, mass, config.gravity, w), dtype
    )
    diag_quad = jnp.broadcast_to(jnp.diag(H_axis)[:, None], (N, 3))
    S_p_np, S_v_np, _ = dynamics.rollout_matrices(N, float(dt))
    Sp = jnp.asarray(S_p_np, dtype) / mass
    Sv = jnp.asarray(S_v_np, dtype) / mass
    hi = jax.lax.Precision.HIGHEST
    use_penalties = (
        use_obstacles
        or w.ground > 0.0
        or w.velocity_bound > 0.0
        or w.tilt > 0.0
        or w.thrust_norm > 0.0
    )

    def cost_fn(uu):
        return costs.condensed_cost(uu, prob, w, dt, mass, gvec)

    def grad_fn(uu):
        return costs.condensed_grad(uu, prob, w, dt, mass, gvec)

    lb_full = jnp.broadcast_to(lb, (N, 3))
    ub_full = jnp.broadcast_to(ub, (N, 3))

    def make_body(full_curv: bool):
        """One Newton round. ``full_curv=False`` = Gauss-Newton (convex
        model, globally stable — finds the right basin); ``True`` = full
        hinge Hessians with Steihaug-truncated CG (captures the obstacle
        hinge's negative tangential curvature — converges the basin fast,
        but from a cold start can jump to a worse one, measured max
        cost-vs-ground-truth 17.8x on the bench batch; staged GN->full it
        never leaves the GN basin)."""
        return functools.partial(_newton_round, full_curv)

    def _newton_round(full_curv, _, carry):
        u, min_imp = carry
        g = grad_fn(u)
        # Active set: at a bound with the gradient pushing outward.
        eps = 1e-6
        at_lo = (u <= lb_full + eps) & (g > 0)
        at_hi = (u >= ub_full - eps) & (g < 0)
        free = (~(at_lo | at_hi)).astype(dtype)  # (..., N, 3)

        # Matrix-free Newton step via Jacobi-preconditioned CG on the free
        # subspace. The (3N, 3N) Hessian is never formed: the quadratic
        # part is a per-axis (N, N) matmul and the penalty GN part is a
        # pullback through S_p / S_v of per-step 3x3 blocks — all small
        # batched einsums, so cost scales with batch, not n^3.
        if use_penalties:
            Hp, Hv, Hu = costs.penalty_blocks(
                u, prob, w, dt, mass, gvec,
                include_obstacles=use_obstacles,
                full_curvature=full_curv,
            )
        else:
            Hp = Hv = Hu = None

        def matvec(dv):
            dv = dv * free
            out = jnp.einsum("ij,...jd->...id", H_axis, dv, precision=hi)
            if Hp is not None:
                y = jnp.einsum("kj,...jd->...kd", Sp, dv, precision=hi)
                z = jnp.einsum("...kab,...kb->...ka", Hp, y, precision=hi)
                out = out + jnp.einsum("ki,...ka->...ia", Sp, z, precision=hi)
                yv = jnp.einsum("kj,...jd->...kd", Sv, dv, precision=hi)
                out = out + jnp.einsum(
                    "ki,...ka->...ia", Sv, Hv * yv, precision=hi
                )
            if Hu is not None:
                # thrust-space GN blocks act directly on dv (no S pullback)
                out = out + jnp.einsum(
                    "...kab,...kb->...ka", Hu, dv, precision=hi
                )
            return out * free

        diag = diag_quad
        if Hp is not None:
            Hp_diag = jnp.diagonal(Hp, axis1=-2, axis2=-1)  # (..., N, 3)
            diag = diag + jnp.einsum(
                "ki,...ka->...ia", Sp * Sp, Hp_diag, precision=hi
            )
            diag = diag + jnp.einsum("ki,...ka->...ia", Sv * Sv, Hv, precision=hi)
        if Hu is not None:
            diag = diag + jnp.diagonal(Hu, axis1=-2, axis2=-1)
        if full_curv:
            # the full obstacle Hessian can drive diagonal entries
            # negative; clamp the Jacobi preconditioner to a fraction of
            # the (always-positive) quadratic diagonal
            minv = free / jnp.maximum(diag, 0.1 * diag_quad)
        else:
            minv = free / jnp.maximum(diag, 1e-8)

        b = -(g * free)

        def cg_body(_, carry):
            d, r, z, p, rz, alive = carry
            ap = matvec(p)
            pap = jnp.sum(p * ap, axis=(-1, -2), keepdims=True)
            # Steihaug truncation: on (near-)negative curvature, freeze
            # this scenario's direction at the current partial sum (alive
            # stays False for the remaining inner iterations). The guard
            # is SCALE-INVARIANT — pap exceeding a tiny fraction of |p|^2
            # (a Rayleigh-quotient floor) — because an absolute epsilon
            # lets rounding-level positive pap through and alpha = rz/pap
            # then explodes the direction, wasting the whole round on a
            # rejected line search (observed with bf16 matvecs).
            pp = jnp.sum(p * p, axis=(-1, -2), keepdims=True)
            alive = alive & (pap > 1e-8 * pp)
            ok = alive.astype(d.dtype)
            alpha = ok * rz / jnp.maximum(pap, 1e-12)
            d = d + alpha * p
            r = r - alpha * ap
            z = minv * r
            rz_new = jnp.sum(r * z, axis=(-1, -2), keepdims=True)
            beta = ok * rz_new / jnp.maximum(rz, 1e-12)
            p = z * ok + beta * p + (1.0 - ok) * p
            rz = jnp.where(alive, rz_new, rz)
            return d, r, z, p, rz, alive

        r0 = b
        z0 = minv * r0
        rz0 = jnp.sum(r0 * z0, axis=(-1, -2), keepdims=True)
        d0 = jnp.zeros_like(b)
        alive0 = jnp.ones(rz0.shape, bool)
        d, *_ = jax.lax.fori_loop(
            0, config.cg_iterations, cg_body, (d0, r0, z0, z0, rz0, alive0)
        )
        if full_curv:
            # negative curvature on the very first CG step leaves d = 0;
            # fall back to the preconditioned steepest-descent direction
            # (standard Steihaug behaviour)
            d_norm = jnp.sum(jnp.abs(d), axis=(-1, -2), keepdims=True)
            d = jnp.where(d_norm > 0.0, d, z0)
        d = d * free

        # Vectorized projected line search: evaluate all candidate steps,
        # keep the lowest cost (never worse than alpha -> 0 / current cost).
        alphas = jnp.asarray(config.line_search_alphas, dtype)
        n_alpha = len(config.line_search_alphas)
        cand = jnp.clip(
            u[None, ...] + alphas.reshape((-1,) + (1,) * (u.ndim)) * d[None, ...],
            lb_full,
            ub_full,
        )  # (A, ..., N, 3)
        cand_costs = cost_fn(cand)  # (A, ...)
        cur_cost = cost_fn(u)  # (...)
        stacked = jnp.concatenate([cand_costs, cur_cost[None, ...]], axis=0)
        best = jnp.argmin(stacked, axis=0)
        best_cost = jnp.min(stacked, axis=0)
        all_cand = jnp.concatenate([cand, u[None, ...]], axis=0)
        u_next = jnp.take_along_axis(
            all_cand.reshape((n_alpha + 1,) + batch + (N * 3,)),
            best.reshape((1,) + batch + (1,)),
            axis=0,
        )[0].reshape(batch + (N, 3))
        # realized relative improvement this round; the ftol stall
        # criterion takes the MIN over the stage's rounds (scipy
        # L-BFGS-B stops at the FIRST round whose progress <= ftol — a
        # fixed-iteration solver must remember that the stall happened).
        # Cast keeps the carry dtype stable when x64 promotes the cost.
        improvement = (
            (cur_cost - best_cost) / (1.0 + jnp.abs(best_cost))
        ).astype(dtype)
        return u_next, jnp.minimum(min_imp, improvement)

    imp0 = jnp.full(batch, jnp.inf, dtype)
    warmup = (
        min(config.gn_warmup_iterations, config.max_iterations)
        if config.newton_full_curvature
        else config.max_iterations
    )
    u, min_improvement = jax.lax.fori_loop(
        0, warmup, make_body(False), (u, imp0)
    )
    rest = config.max_iterations - warmup
    if config.newton_full_curvature and rest > 0:
        # stage 2: full-curvature Newton from the GN basin. The stall
        # tracker restarts — stage-2 directions differ, so a GN stall
        # does not imply a stage-2 fixed point.
        u, min_improvement = jax.lax.fori_loop(
            0, rest, make_body(True), (u, imp0)
        )
    return _finalize(config, prob, u, min_improvement, with_grad=with_grad)


def _finalize(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u: Array,
    min_improvement: Optional[Array] = None,
    with_grad: bool = True,
    precomputed: Optional[tuple] = None,
) -> SolveResult:
    """Diagnostics + dynamics-consistent rollout for a final thrust iterate
    (shared by the XLA and fused-Pallas solver paths).

    Convergence criterion (``SolveResult.converged``): the MINIMUM
    realized relative cost decrease over the final Newton stage's rounds
    <= ``config.ftol`` — scipy L-BFGS-B's ftol semantics, the rule the
    reference solver terminates on in practice (se3_mpc_planner.py:
    256-268). scipy stops at the FIRST round whose progress drops below
    ftol; a fixed-iteration batched solver must remember that the stall
    happened, so the stage minimum (not the last round) is the faithful
    translation. The tracker restarts at the full-curvature stage switch
    (a GN stall is not a stage-2 fixed point). The
    projected-gradient norm is NOT used as the gate: near active hinge
    boundaries it stays O(hinge weight) at stationary points, and the
    diag-preconditioned Newton decrement overestimates achievable
    improvement when off-diagonal curvature dominates (measured in
    scripts/diag_convergence.py: a 60-iteration ground truth "converges"
    only 0.92 by gradient norm while its cost tail is within 0.07% of
    optimum). Honesty of the ftol gate, measured on the bench batch:
    scenarios it declares converged sit within ~2e-6 of the 60-iteration
    ground-truth cost at p95. ``grad_norm`` remains in the result as a
    diagnostic. When ``min_improvement`` is unavailable (direct legacy
    calls), the old gradient-norm rule is used as a fallback.
    """
    N = config.prediction_horizon
    dtype = u.dtype
    gvec = frames.gravity_vector(frames.WorldFrame.ENU, config.gravity).astype(dtype)
    w = config.weights
    batch = u.shape[:-2]
    n_flat = 3 * N
    lb, ub = config.thrust_bounds(dtype)
    lb_full = jnp.broadcast_to(lb, (N, 3))
    ub_full = jnp.broadcast_to(ub, (N, 3))

    # projected gradient norm (criticality diagnostic for the box QP).
    # ``with_grad=False`` skips the AD pass — the tail-refine phase keeps
    # phase-1's diagnostic instead of paying a full gradient evaluation
    # for a value that plays no part in the convergence criterion.
    if with_grad:
        g = costs.condensed_grad(u, prob, w, config.dt, config.mass, gvec)
        pg = jnp.clip(u - g, lb_full, ub_full) - u
        grad_norm = jnp.linalg.norm(pg.reshape(batch + (n_flat,)), axis=-1)
    else:
        grad_norm = None
    if min_improvement is not None:
        converged = min_improvement <= config.ftol
    elif grad_norm is not None:  # legacy: raw projected-gradient criterion
        converged = grad_norm < config.convergence_tolerance * n_flat
    else:
        raise ValueError("with_grad=False requires min_improvement")

    if precomputed is not None:
        # the fused kernel already emitted the exact fp32 rollout + cost
        # of the final iterate — re-deriving them in XLA costs dozens of
        # launch-bound kernels per solve (the two-phase fixed overhead)
        pos, vel, cost = precomputed
        acc = u / config.mass + gvec
    else:
        pos, vel, acc = dynamics.rollout_linear(
            u, prob.p0, prob.v0, config.dt, config.mass, gvec
        )
        cost = costs.condensed_cost(
            u, prob, w, config.dt, config.mass, gvec
        )
    return SolveResult(
        thrusts=u,
        positions=pos,
        velocities=vel,
        accelerations=acc,
        cost=cost,
        converged=converged,
        grad_norm=grad_norm,
        min_improvement=min_improvement,
    )


def resolve_method(method: str) -> str:
    """Map a solver ``method`` to the path that runs.

    ``"auto"`` takes the compiled fused kernel where there is one (the
    GPU) and the XLA path elsewhere; ``"fused"`` off the GPU raises
    rather than falling back; ``"interpret"`` runs the fused kernels in
    the Pallas interpreter (CPU tests of the kernel arithmetic)."""
    backend = jax.default_backend()
    if method == "auto":
        return "fused" if backend == "gpu" else "xla"
    if method == "fused" and backend != "gpu":
        raise ValueError(
            f"method='fused' needs a GPU (backend is {backend!r}): the "
            "kernel compiles through Triton. Use 'xla', or 'interpret' to "
            "run it in the Pallas interpreter."
        )
    if method not in ("xla", "fused", "interpret"):
        raise ValueError(f"unknown solver method {method!r}")
    return method


def _solve_once(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u_init: Optional[Array],
    use_obstacles: bool,
    method: str,
    block_b: int,
    with_grad: bool = True,
) -> SolveResult:
    """One fixed-budget solve on a resolved path (no tail refinement)."""
    if method == "xla":
        return solve_se3_mpc(
            config, prob, u_init, use_obstacles, with_grad=with_grad
        )
    from dart_planner_tpu.ops import pallas_mpc

    if u_init is None:
        u_init = initialize_thrusts(config, prob)
    u, min_improvement, pos, vel, cost = pallas_mpc.solve_thrusts_fused(
        config,
        prob,
        u_init,
        use_obstacles=use_obstacles,
        block_b=block_b,
        interpret=method == "interpret",
    )
    return _finalize(
        config, prob, u, min_improvement, with_grad=with_grad,
        precomputed=(pos, vel, cost),
    )


def _flatten_batch(prob: costs.Problem, res: SolveResult):
    """Flatten leading batch dims of a Problem/SolveResult pair.

    Shared Problem fields (no batch prefix — shared obstacle sets, a
    single goal point) broadcast to the full batch first. Shared vs
    batched is decided by ndim against the field's known trailing
    rank(s), NOT by shape-prefix equality: a shared (3,) goal with a
    batch of exactly 3 scenarios, or shared (K, 4) obstacles with
    K == B, must not be misread as batched. The one genuinely ambiguous
    corner — a shared per-step (N, 3) goal with nb == 1 and N == B —
    resolves to "batched" (prefix match)."""
    batch_shape = res.cost.shape
    B = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    nb = len(batch_shape)

    def flat(x, trailing):
        if x is None:
            return None
        shared = any(x.ndim == t for t in trailing)
        batched = any(x.ndim == t + nb for t in trailing)
        if shared and batched:
            batched = x.shape[:nb] == batch_shape
            shared = not batched
        if shared:
            x = jnp.broadcast_to(x, batch_shape + x.shape)
        return x.reshape((B,) + x.shape[nb:])

    prob_trailing = {
        "p0": (1,), "v0": (1,), "goal": (1, 2),  # goal: point or per-step
        "obstacles": (2,), "obstacle_mask": (1,), "v_cap": (0,),
    }
    res_trailing = {
        "thrusts": (2,), "positions": (2,), "velocities": (2,),
        "accelerations": (2,), "cost": (0,), "converged": (0,),
        "grad_norm": (0,), "min_improvement": (0,),
    }
    prob_f = costs.Problem(
        **{k: flat(getattr(prob, k), prob_trailing[k]) for k in prob._fields}
    )
    res_f = SolveResult(
        **{k: flat(getattr(res, k), res_trailing[k]) for k in res._fields}
    )
    return prob_f, res_f, batch_shape, B


def _compact_resolve(
    cfg_c: SE3MPCConfig,
    prob_f: costs.Problem,
    res_f: SolveResult,
    u_start_f: Array,
    C: int,
    slot: Array,
    use_obstacles: bool,
    method: str,
    block_b: int,
) -> SolveResult:
    """Re-solve the worst cohort in a compact batch and merge improvements.

    ``slot`` is a permutation ranking scenarios re-solve-first (slot i <
    C means scenario i is in the cohort); the first ``C`` are re-solved
    under ``cfg_c`` starting from their rows of ``u_start_f``. Results
    scatter back only where the re-solved cost is no worse (bf16
    line-search near-ties on the fused path could otherwise accept
    ~1e-5 relative regressions); ``converged`` ORs the two stalls — the
    combined criterion is still "some Newton round realized <= ftol
    progress". Shared by the tail-refinement and perturbed-restart
    phases."""
    B = res_f.cost.shape[0]
    # invert the permutation for the first C slots (one small int32
    # scatter; the value merges below are all gathers)
    idx = jnp.zeros((B,), slot.dtype).at[slot].set(
        jnp.arange(B, dtype=slot.dtype)
    )[:C]

    take = lambda x: None if x is None else x[idx]  # noqa: E731
    prob_t = costs.Problem(*[take(x) for x in prob_f])
    ref = _solve_once(
        cfg_c, prob_t, u_start_f[idx], use_obstacles, method, block_b,
        with_grad=False,
    )
    ok = ref.cost <= res_f.cost[idx]

    # scatter-free merge: scenario i was re-solved iff its partition
    # slot is within capacity; read the value back with a gather
    safe_slot = jnp.minimum(slot, C - 1)
    use_new = (slot < C) & ok[safe_slot]  # (B,)

    def merge(field, new):
        old = getattr(res_f, field)
        if old is None or new is None:
            return old
        sel = use_new.reshape(use_new.shape + (1,) * (new.ndim - 1))
        return jnp.where(sel, new[safe_slot], old)

    return SolveResult(
        thrusts=merge("thrusts", ref.thrusts),
        positions=merge("positions", ref.positions),
        velocities=merge("velocities", ref.velocities),
        accelerations=merge("accelerations", ref.accelerations),
        cost=merge("cost", ref.cost),
        converged=res_f.converged
        | (use_new & ref.converged[safe_slot]),
        # grad_norm keeps the phase-1 diagnostic for re-solved scenarios
        # (with_grad=False above skips the AD pass; the value is not part
        # of the ftol convergence criterion)
        grad_norm=res_f.grad_norm,
        min_improvement=merge("min_improvement", ref.min_improvement),
    )


def _unflatten(res: SolveResult, batch_shape) -> SolveResult:
    return SolveResult(
        *[
            None if x is None else x.reshape(batch_shape + x.shape[1:])
            for x in res
        ]
    )


def _tail_refine(
    config: SE3MPCConfig,
    prob: costs.Problem,
    res: SolveResult,
    use_obstacles: bool,
    method: str,
    block_b: int,
) -> SolveResult:
    """Adaptive phase 2: refine the unconverged tail in a compact batch.

    The first ``ceil(tail_capacity * B)`` scenarios ranked
    unconverged-first are re-solved, warm-started from their phase-1
    iterate, for ``tail_iterations`` full-curvature Newton rounds at
    ``tail_cg_iterations`` CG steps (the tail's crawl is
    inner-CG-limited; see SE3MPCConfig docstring). The batched
    equivalent of the reference's run-until-ftol scipy loop
    (se3_mpc_planner.py:256-268): converged scenarios pay nothing beyond
    the capacity slack, the tail gets the iterations it needs."""
    prob_f, res_f, batch_shape, B = _flatten_batch(prob, res)
    C = max(1, int(np.ceil(config.tail_capacity * B)))
    cfg_t = config._replace(
        max_iterations=config.tail_iterations,
        cg_iterations=config.tail_cg_iterations,
        newton_full_curvature=True,
        gn_warmup_iterations=0,
        tail_iterations=0,
        restart_iterations=0,
        line_search_alphas=config.tail_line_search_alphas,
    )
    # unconverged first via a stable PARTITION (two prefix sums), which
    # needs no sort
    unconv = (~res_f.converged).astype(jnp.int32)
    rank_u = jnp.cumsum(unconv) - 1
    n_unconv = rank_u[-1] + 1
    rank_c = jnp.cumsum(1 - unconv) - 1
    slot = jnp.where(unconv == 1, rank_u, n_unconv + rank_c)
    out = _compact_resolve(
        cfg_t, prob_f, res_f, res_f.thrusts, C, slot, use_obstacles,
        method, block_b,
    )
    return _unflatten(out, batch_shape)


def _perturbed_restart(
    config: SE3MPCConfig,
    prob: costs.Problem,
    res: SolveResult,
    use_obstacles: bool,
    method: str,
    block_b: int,
) -> SolveResult:
    """Optional phase 3: basin escape for still-stuck scenarios.

    The restart cohort is ranked by SUSPICION, not convergence: a
    basin-stuck scenario ftol-STALLS (measured on the XLA path:
    the one scenario at cost excess 1.08 is declared converged — its
    progress genuinely stalled, in the wrong basin), so
    unconverged-first selection can never find it. The rank signal is
    ``cost / quadratic-floor`` — the hinge-free QP cost at the
    box-clipped quadratic optimum is a scenario-scale reference, and a
    poor basin shows up as an outsized ratio — with still-unconverged
    scenarios forced to the front. The chosen cohort is re-solved from
    a PERTURBED cold start (deterministic Gaussian jitter of std
    ``restart_noise`` N on the QP/cold thrust init), keeping whichever
    result costs less; the cost-guarded merge makes the attempt free of
    quality risk."""
    prob_f, res_f, batch_shape, B = _flatten_batch(prob, res)
    C = max(1, int(np.ceil(config.restart_capacity * B)))
    # the BASE staged schedule (GN warmup -> full curvature, base CG
    # and line-search grid): a jittered start is a COLD start, and full
    # curvature from cold is the basin-leaving regime — measured on the
    # known stuck instance, the staged schedule converts 98% of 1-2 N
    # jittered starts, where an 8-round full-curvature-from-cold
    # variant converted none (scripts/diag_stuck.py)
    cfg_r = config._replace(
        max_iterations=config.restart_iterations,
        tail_iterations=0,
        restart_iterations=0,
    )
    u_cold = initialize_thrusts(config, prob_f)
    w_quad = config.weights._replace(
        obstacle=0.0, ground=0.0, velocity_bound=0.0, tilt=0.0,
        thrust_norm=0.0,
    )
    gvec = frames.gravity_vector(
        frames.WorldFrame.ENU, config.gravity
    ).astype(u_cold.dtype)
    quad_floor = costs.condensed_cost(
        u_cold, prob_f, w_quad, config.dt, config.mass, gvec
    )
    ratio = res_f.cost / jnp.maximum(quad_floor, 1e-3)
    priority = ratio + jnp.where(res_f.converged, 0.0, 1e12)
    order = jnp.argsort(-priority, stable=True)  # re-solve-first indices
    slot = jnp.zeros((B,), order.dtype).at[order].set(
        jnp.arange(B, dtype=order.dtype)
    )
    noise = config.restart_noise * jax.random.normal(
        jax.random.PRNGKey(0), u_cold.shape, u_cold.dtype
    )
    out = _compact_resolve(
        cfg_r, prob_f, res_f, u_cold + noise, C, slot, use_obstacles,
        method, block_b,
    )
    return _unflatten(out, batch_shape)


@functools.partial(
    jax.jit, static_argnames=("config", "use_obstacles", "method", "block_b")
)
def solve(
    config: SE3MPCConfig,
    prob: costs.Problem,
    u_init: Optional[Array] = None,
    use_obstacles: bool = True,
    method: str = "auto",
    block_b: int = 16,
) -> SolveResult:
    """Solve dispatcher: ``"fused"`` = the single fused Pallas kernel
    (GPU, compiled through Triton; ``block_b`` scenarios per program),
    ``"xla"`` = pure-XLA path, ``"auto"`` and ``"interpret"`` as in
    :func:`resolve_method`. Both paths run the identical algorithm and
    agree to float tolerance. With ``config.tail_iterations`` > 0, a
    second compacted pass refines the unconverged tail (see
    :func:`_tail_refine`)."""
    method = resolve_method(method)
    if not use_obstacles:
        prob = _strip_obstacles(prob)
    res = _solve_once(config, prob, u_init, use_obstacles, method, block_b)
    if config.tail_iterations > 0:
        res = _tail_refine(config, prob, res, use_obstacles, method, block_b)
    if config.restart_iterations > 0:
        res = _perturbed_restart(
            config, prob, res, use_obstacles, method, block_b
        )
    return res


def extract_trajectory(
    config: SE3MPCConfig, result: SolveResult, start_time
) -> Trajectory:
    """Attitude / body-rate extraction from thrust vectors
    (reference se3_mpc_planner.py:582-675): R from the differentially-flat
    frame at yaw 0, Euler angles from R, body rates by finite-difference
    vee(R^T dR), thrust magnitudes by norm."""
    u = result.thrusts
    N = config.prediction_horizon
    yaw0 = jnp.zeros(u.shape[:-1], u.dtype)  # desired yaw = 0 (ref :623)
    Rs = so3.thrust_yaw_to_rotmat(u, yaw0)  # (..., N, 3, 3)
    attitudes = so3.rotmat_to_euler(Rs)
    body_rates = so3.body_rates_from_rotmats(Rs, config.dt)
    # zero attitude/rates where thrust ~ 0 (ref :651-653)
    tmag = jnp.linalg.norm(u, axis=-1)
    ok = (tmag > 1e-6)[..., None]
    attitudes = jnp.where(ok, attitudes, 0.0)
    body_rates = jnp.where(ok, body_rates, 0.0)
    start_time = jnp.asarray(start_time, u.dtype)
    ts = start_time[..., None] + config.dt * jnp.arange(N, dtype=u.dtype)
    return Trajectory(
        timestamps=ts,
        positions=result.positions,
        velocities=result.velocities,
        accelerations=result.accelerations,
        attitudes=attitudes,
        body_rates=body_rates,
        thrusts=tmag,
        yaws=attitudes[..., 2],
        yaw_rates=body_rates[..., 2],
    )


def emergency_trajectory(config: SE3MPCConfig, state: DroneState) -> Trajectory:
    """Hover-in-place fallback (reference se3_mpc_planner.py:677-694)."""
    N = config.prediction_horizon
    dtype = state.position.dtype
    ts = state.timestamp[..., None] + config.dt * jnp.arange(N, dtype=dtype)
    pos = jnp.broadcast_to(
        state.position[..., None, :], state.position.shape[:-1] + (N, 3)
    )
    zeros = jnp.zeros_like(pos)
    return Trajectory(
        timestamps=ts, positions=pos, velocities=zeros, accelerations=zeros
    )


def is_plan_valid(trajectory: Trajectory) -> Array:
    """Vectorized validity check (reference se3_mpc_planner.py:717-737):
    finite positions, altitude >= 0.1 m, |velocity| <= 20 m/s."""
    pos_ok = jnp.all(jnp.isfinite(trajectory.positions), axis=(-1, -2))
    alt_ok = jnp.all(trajectory.positions[..., 2] >= 0.1, axis=-1)
    valid = pos_ok & alt_ok
    if trajectory.velocities is not None:
        vel_ok = jnp.all(jnp.abs(trajectory.velocities) <= 20.0, axis=(-1, -2))
        valid = valid & vel_ok
    return valid


from dart_planner_tpu.planning.base import BasePlanner  # noqa: E402


class SE3MPCPlanner(BasePlanner):
    """Thin stateful facade matching the reference planner's ergonomics
    (set_goal / add_obstacle / plan_trajectory,
    se3_mpc_planner.py:175-228) over the pure solver. Keeps the warm-start
    thrust sequence and planning stats; all math happens in
    :func:`solve_se3_mpc` under jit. Registered as ``"se3_mpc"`` in
    :class:`~dart_planner_tpu.planning.base.PlannerFactory`
    (reference se3_mpc_planner.py:760-762).
    """

    def __init__(self, config: SE3MPCConfig | dict | None = None):
        if isinstance(config, dict):
            config = SE3MPCConfig(**config)
        super().__init__(config._asdict() if config else None)
        self.config = config or SE3MPCConfig()
        self.goal_position: Optional[np.ndarray] = None
        self.last_solution: Optional[Array] = None
        self.warm_start_enabled = True
        # obstacle list + bounded stats live on BasePlanner
        # (self.obstacles / self.planning_stats)

    # -- goal / obstacle management (reference :175-191) --
    def set_goal(self, goal_position) -> None:
        self.goal_position = np.asarray(goal_position, np.float32)

    def add_obstacle(self, center, radius: float) -> None:
        if len(self.obstacles) >= self.config.max_obstacles:
            # keep the most recent K obstacles (static shape discipline)
            self.obstacles.pop(0)
        self.obstacles.append((np.asarray(center, np.float32), float(radius)))

    def clear_obstacles(self) -> None:
        self.obstacles.clear()

    def _problem(self, state: DroneState) -> costs.Problem:
        if self.obstacles:
            obs = np.stack(
                [np.concatenate([c, [r]]) for c, r in self.obstacles]
            ).astype(np.float32)
        else:
            obs = None
        return make_problem(
            state.position,
            state.velocity,
            self.goal_position,
            obstacles=obs,
            config=self.config,
        )

    def plan_trajectory(self, state: DroneState, goal_position) -> Trajectory:
        """sense -> plan -> act (reference :215-228)."""
        import time as _time

        t0 = _time.perf_counter()
        goal = np.asarray(goal_position, np.float32)
        if (
            self.goal_position is None
            or np.linalg.norm(self.goal_position - goal) > 0.5
        ):
            self.set_goal(goal)  # goal-change threshold (ref :193-203)
        prob = self._problem(state)
        u0 = None
        if self.warm_start_enabled and self.last_solution is not None:
            u0 = shift_warm_start(self.config, self.last_solution)
        result = solve(
            self.config, prob, u0, use_obstacles=bool(self.obstacles)
        )
        self.last_solution = result.thrusts
        traj = extract_trajectory(self.config, result, state.timestamp)
        self._update_planning_stats(
            (_time.perf_counter() - t0) * 1000.0,
            success=bool(jnp.all(result.converged)),
        )
        if not bool(jnp.all(is_plan_valid(traj))):
            return emergency_trajectory(self.config, state)
        return traj

    def get_planning_stats(self) -> dict:
        """(reference se3_mpc_planner.py:696-708); history is bounded by
        BasePlanner (last 100 samples)."""
        st = self.planning_stats
        if not st["planning_times"]:
            return {}
        return {
            "mean_planning_time_ms": float(np.mean(st["planning_times"])),
            "max_planning_time_ms": float(np.max(st["planning_times"])),
            "success_rate": st["successful_plans"] / max(st["total_plans"], 1),
            "total_plans": st["total_plans"],
        }

    def reset_performance_tracking(self) -> None:
        self.reset_stats()

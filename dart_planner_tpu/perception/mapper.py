"""Dense log-odds voxel mapper, fully jittable.

Re-design of the reference ``ExplicitGeometricMapper``
(/root/reference/src/dart_planner/perception/explicit_geometric_mapper.py,
"EGM"): its sparse ``Dict[(i,j,k) -> VoxelData]`` with Python DDA ray
tracing (EGM:250-309) cannot vmap or live on device, so this rebuild
uses a fixed-extent dense log-odds grid:

- Bayesian update (EGM:311-336, p_hit=0.7 / p_miss=0.4, clamp [0.01,0.99])
  becomes log-odds scatter-adds. NOTE: the reference's miss branch uses
  ``likelihood = 1 - prob_miss`` which *raises* occupancy for free-space
  rays (EGM:322-330) — an inversion bug. This implementation applies the
  standard update (miss lowers occupancy by log(p_miss/(1-p_miss))).
- Ray traversal is fixed-count line sampling at sub-voxel step with
  consecutive-duplicate suppression, instead of data-dependent DDA.
- Occupancy queries (EGM:154-193, prior 0.5 for unknown/out-of-bounds),
  trajectory safety with 6-neighbor margin probes (EGM:195-219,338-351),
  local occupancy grids (EGM:221-248), sphere-obstacle injection
  (EGM:399-423), and lidar simulation (EGM:365-397; here exact ray-sphere
  casting against an analytic scene instead of random hits) are all
  fixed-shape array ops.
- ``extract_obstacles`` reproduces the planner-feed path
  (cloud/main_improved_threelayer.py:381-398: threshold 0.6 -> downsample
  -> nearest-K spheres) as a masked top-k.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

_LOGODDS_HIT = float(np.log(0.7 / 0.3))  # p_hit = 0.7
_LOGODDS_MISS = float(np.log(0.4 / 0.6))  # p_miss = 0.4
_LOGODDS_CLAMP = float(np.log(0.99 / 0.01))  # prob clamp [0.01, 0.99]
_LOGODDS_OBSTACLE = float(np.log(0.9 / 0.1))  # injected spheres (EGM:419)


class MapperConfig(NamedTuple):
    """Static mapper geometry (hashable; part of the jit cache key)."""

    resolution: float = 0.5  # m per voxel (EGM default 0.2; three-layer 0.5)
    grid_size: tuple = (128, 128, 64)  # voxels per axis
    origin: tuple = (-32.0, -32.0, -8.0)  # world position of voxel (0,0,0)
    max_range: float = 50.0  # sensor range (EGM:46)

    @property
    def ray_samples(self) -> int:
        """Fixed sample count so ray updates have static shape."""
        return int(np.ceil(self.max_range / (0.9 * self.resolution))) + 1


class VoxelMap(NamedTuple):
    """The map state: dense log-odds grid (prior 0 == probability 0.5)."""

    log_odds: Array  # (X, Y, Z) float32
    total_observations: Array  # scalar int32


def create_map(config: MapperConfig, dtype=jnp.float32) -> VoxelMap:
    return VoxelMap(
        log_odds=jnp.zeros(config.grid_size, dtype),
        total_observations=jnp.zeros((), jnp.int32),
    )


def world_to_voxel(config: MapperConfig, position: Array) -> Array:
    """floor((p - origin)/res) (EGM:91-94, with a world-grid origin shift)."""
    origin = jnp.asarray(config.origin, position.dtype)
    return jnp.floor((position - origin) / config.resolution).astype(jnp.int32)


def voxel_to_world(config: MapperConfig, idx: Array) -> Array:
    """Voxel center (EGM:96-98)."""
    origin = jnp.asarray(config.origin, jnp.float32)
    return idx.astype(jnp.float32) * config.resolution + (
        origin + 0.5 * config.resolution
    )


def _flat_index(config: MapperConfig, idx: Array) -> tuple[Array, Array]:
    """Flatten (..., 3) voxel indices; returns (flat_idx, in_bounds)."""
    gs = config.grid_size
    in_bounds = jnp.all((idx >= 0) & (idx < jnp.asarray(gs)), axis=-1)
    flat = (idx[..., 0] * gs[1] + idx[..., 1]) * gs[2] + idx[..., 2]
    return jnp.where(in_bounds, flat, -1), in_bounds


@functools.partial(jax.jit, static_argnames=("config",))
def update_with_scan(
    config: MapperConfig,
    vmap_state: VoxelMap,
    origins: Array,  # (R, 3) ray origins
    directions: Array,  # (R, 3) unit directions
    hit_distances: Array,  # (R,) distance to hit; inf (or >max_range) = miss
) -> VoxelMap:
    """Bayesian update along R rays (EGM:100-152).

    Free-space cells up to the hit (or max range) get the miss update; the
    hit cell gets the hit update. Sampling is fixed-count at 0.9*resolution
    with consecutive-duplicate suppression, so the whole update is two
    scatter-adds regardless of ray content.
    """
    S = config.ray_samples
    res = config.resolution
    dtype = vmap_state.log_odds.dtype

    hd = jnp.minimum(hit_distances, config.max_range)
    is_hit = hit_distances <= config.max_range

    # free-space samples: t_k strictly before the hit cell
    t = (jnp.arange(S, dtype=dtype) + 0.5) * (0.9 * res)  # (S,)
    pts = origins[:, None, :] + t[None, :, None] * directions[:, None, :]
    idx = world_to_voxel(config, pts)  # (R, S, 3)
    flat, inb = _flat_index(config, idx)  # (R, S)
    valid = inb & (t[None, :] < hd[:, None] - 0.5 * res)
    # suppress consecutive duplicates along each ray
    dup = jnp.concatenate(
        [jnp.zeros_like(valid[:, :1]), flat[:, 1:] == flat[:, :-1]], axis=1
    )
    valid = valid & ~dup

    grid = vmap_state.log_odds.reshape(-1)
    upd = jnp.where(valid, _LOGODDS_MISS, 0.0).astype(dtype)
    safe_flat = jnp.where(valid, flat, 0)
    grid = grid.at[safe_flat.reshape(-1)].add(
        jnp.where(valid, upd, 0.0).reshape(-1), mode="drop"
    )

    # hit cells
    hit_pts = origins + hd[:, None] * directions
    hit_idx = world_to_voxel(config, hit_pts)
    hit_flat, hit_inb = _flat_index(config, hit_idx)
    hit_valid = hit_inb & is_hit
    grid = grid.at[jnp.where(hit_valid, hit_flat, 0)].add(
        jnp.where(hit_valid, jnp.asarray(_LOGODDS_HIT, dtype), 0.0),
        mode="drop",
    )

    grid = jnp.clip(grid, -_LOGODDS_CLAMP, _LOGODDS_CLAMP)
    return VoxelMap(
        log_odds=grid.reshape(config.grid_size),
        total_observations=vmap_state.total_observations
        + origins.shape[0],
    )


@functools.partial(jax.jit, static_argnames=("config",))
def query_occupancy(
    config: MapperConfig, vmap_state: VoxelMap, positions: Array
) -> Array:
    """Occupancy probability at world positions; prior 0.5 outside the grid
    or for never-observed cells (EGM:154-182)."""
    idx = world_to_voxel(config, positions)
    flat, inb = _flat_index(config, idx)
    lo = vmap_state.log_odds.reshape(-1)[jnp.where(inb, flat, 0)]
    lo = jnp.where(inb, lo, 0.0)
    return jax.nn.sigmoid(lo)


@functools.partial(jax.jit, static_argnames=("config",))
def query_observed(
    config: MapperConfig,
    vmap_state: VoxelMap,
    positions: Array,
    eps: float = 1e-6,
) -> Array:
    """True where the voxel holding ``positions`` has ever been observed.

    The unknown-space signal the reference surfaces through its prior-0.5
    occupancy for never-seen voxels (EGM:154-169) and this mapper's
    occupancy query also returns — but a 0.5 is indistinguishable from a
    genuinely uncertain observed cell, so consumers that must treat
    unknown space conservatively (speed caps through unscanned corridor
    regions) get the explicit boolean: |log-odds| > eps and in-bounds.
    Out-of-grid counts as unobserved."""
    idx = world_to_voxel(config, positions)
    flat, inb = _flat_index(config, idx)
    lo = vmap_state.log_odds.reshape(-1)[jnp.where(inb, flat, 0)]
    return inb & (jnp.abs(lo) > eps)


@functools.partial(jax.jit, static_argnames=("config", "num_samples"))
def corridor_observed_fraction(
    config: MapperConfig,
    vmap_state: VoxelMap,
    start: Array,  # (3,)
    goal: Array,  # (3,)
    num_samples: int = 24,
    probe_radius: float = 0.75,
) -> Array:
    """Observed fraction along the start->goal corridor: (num_samples,).

    Each corridor sample probes its voxel plus 6 cardinal neighbours at
    ``probe_radius`` (the ``is_trajectory_safe`` probe pattern,
    EGM:338-351) and reports the fraction of probes that have ever been
    observed. 1.0 = the surrounding tube was scanned (a sphere there
    would have been seen); ~0 = the region is terra incognita and a
    corridor-blocking sphere could be hiding in it."""
    dtype = jnp.asarray(start).dtype
    t = jnp.linspace(0.0, 1.0, num_samples, dtype=dtype)
    pts = start + t[:, None] * (goal - start)  # (M, 3)
    eye = jnp.eye(3, dtype=dtype) * probe_radius
    offsets = jnp.concatenate(
        [jnp.zeros((1, 3), dtype), eye, -eye], axis=0
    )  # (7, 3)
    probes = pts[:, None, :] + offsets  # (M, 7, 3)
    seen = query_observed(config, vmap_state, probes)
    return jnp.mean(seen.astype(dtype), axis=-1)


@functools.partial(
    jax.jit, static_argnames=("config",)
)
def is_trajectory_safe(
    config: MapperConfig,
    vmap_state: VoxelMap,
    positions: Array,  # (..., N, 3)
    safety_margin: float = 1.0,
    threshold: float = 0.6,
) -> Array:
    """All-waypoints check with center + 6 cardinal margin probes
    (EGM:195-219, 338-351). Returns (...,) bool."""
    eye = jnp.eye(3, dtype=positions.dtype) * safety_margin
    offsets = jnp.concatenate(
        [jnp.zeros((1, 3), positions.dtype), eye, -eye], axis=0
    )  # (7, 3)
    probes = positions[..., None, :] + offsets  # (..., N, 7, 3)
    occ = query_occupancy(config, vmap_state, probes)
    return jnp.all(occ <= threshold, axis=(-1, -2))


@functools.partial(jax.jit, static_argnames=("config", "size_cells"))
def local_occupancy_grid(
    config: MapperConfig,
    vmap_state: VoxelMap,
    center: Array,
    size_cells: int = 32,
) -> tuple[Array, Array]:
    """(occupancy (s,s,s), world position of its corner) around ``center``
    (EGM:221-248). ``size_cells`` is static; the slice clamps at borders."""
    c_idx = world_to_voxel(config, center)
    start = c_idx - size_cells // 2
    gs = jnp.asarray(config.grid_size)
    start = jnp.clip(start, 0, gs - size_cells)
    occ = jax.nn.sigmoid(
        jax.lax.dynamic_slice(
            vmap_state.log_odds,
            (start[0], start[1], start[2]),
            (size_cells, size_cells, size_cells),
        )
    )
    corner = voxel_to_world(config, start) - 0.5 * config.resolution
    return occ, corner


@functools.partial(
    jax.jit,
    static_argnames=(
        "config", "max_obstacles", "size_cells", "suppression_radius"
    ),
)
def extract_obstacles(
    config: MapperConfig,
    vmap_state: VoxelMap,
    center: Array,
    max_obstacles: int = 8,
    threshold: float = 0.6,
    size_cells: int = 32,
    suppression_radius: float = 0.0,
    toward: Optional[Array] = None,
    seg_start: Optional[Array] = None,
) -> tuple[Array, Array]:
    """Occupied voxels as padded sphere obstacles (K, 4) + mask.

    On-device equivalent of ``_refresh_se3_obstacles_from_mapper``
    (cloud/main_improved_threelayer.py:381-398): local grid -> threshold
    0.6 -> K best voxels, each a sphere of radius ``resolution`` (the
    reference uses 0.6*resolution per voxel; we keep a full voxel radius
    to bound the cell).

    Selection: by default the nearest K to ``center`` (reference
    behavior). With ``toward`` set, voxels are ranked by distance to the
    SEGMENT seg_start->toward (seg_start defaults to ``center``) — the
    corridor the vehicle will actually fly. Passing the corridor
    *midpoint* as ``center`` with ``seg_start``/``toward`` as its
    endpoints keeps the extraction window centered on the corridor (the
    window only spans size_cells*resolution, so centering it on an
    endpoint loses the far half of long corridors) while still ranking
    by the full flight segment.
    ``suppression_radius`` > 0 switches to greedy non-maximum
    suppression: after each pick, voxels within that radius are excluded,
    so the K slots spread across distinct obstacle blobs instead of all
    landing on the nearest one (the reference gets a cruder version of
    this from its grid downsampling; a plain nearest-K starves every
    blob but the closest and the planner never sees the others)."""
    occ, corner = local_occupancy_grid(config, vmap_state, center, size_cells)
    s = size_cells
    ii = jax.lax.broadcasted_iota(jnp.int32, (s, s, s), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (s, s, s), 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, (s, s, s), 2)
    centers = (
        jnp.stack([ii, jj, kk], axis=-1).astype(occ.dtype) + 0.5
    ) * config.resolution + corner
    occupied = occ > threshold
    if toward is None:
        d2 = jnp.sum((centers - center) ** 2, axis=-1)
    else:
        a = center if seg_start is None else jnp.asarray(
            seg_start, centers.dtype
        )
        seg = jnp.asarray(toward, centers.dtype) - a
        t = jnp.clip(
            jnp.sum((centers - a) * seg, axis=-1)
            / jnp.maximum(jnp.sum(seg * seg), 1e-9),
            0.0,
            1.0,
        )
        nearest = a + t[..., None] * seg
        d2 = jnp.sum((centers - nearest) ** 2, axis=-1)
    score0 = jnp.where(occupied, -d2, -jnp.inf).reshape(-1)
    flat_centers = centers.reshape(-1, 3)
    if suppression_radius > 0.0:
        r2 = suppression_radius * suppression_radius

        def pick(score, _):
            idx = jnp.argmax(score)
            best = score[idx]
            c = flat_centers[idx]
            near = jnp.sum((flat_centers - c) ** 2, axis=-1) <= r2
            score = jnp.where(near, -jnp.inf, score)
            return score, (best, idx)

        _, (top, flat_idx) = jax.lax.scan(
            pick, score0, None, length=max_obstacles
        )
    else:
        top, flat_idx = jax.lax.top_k(score0, max_obstacles)
    mask = jnp.isfinite(top)
    obs_centers = flat_centers[flat_idx]
    radii = jnp.full((max_obstacles, 1), config.resolution, occ.dtype)
    obstacles = jnp.concatenate([obs_centers, radii], axis=-1)
    return jnp.where(mask[:, None], obstacles, 0.0), mask


@functools.partial(jax.jit, static_argnames=("config",))
def add_obstacle(
    config: MapperConfig, vmap_state: VoxelMap, center: Array, radius: Array
) -> VoxelMap:
    """Inject a sphere at occupancy 0.9 (EGM:399-423) as a dense mask."""
    gs = config.grid_size
    ii = jax.lax.broadcasted_iota(jnp.int32, gs, 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, gs, 1)
    kk = jax.lax.broadcasted_iota(jnp.int32, gs, 2)
    centers = voxel_to_world(config, jnp.stack([ii, jj, kk], axis=-1))
    inside = jnp.sum((centers - center) ** 2, axis=-1) <= radius**2
    lo = jnp.where(
        inside,
        jnp.asarray(_LOGODDS_OBSTACLE, vmap_state.log_odds.dtype),
        vmap_state.log_odds,
    )
    return vmap_state._replace(log_odds=lo)


@functools.partial(jax.jit, static_argnames=("config", "num_rays"))
def simulate_lidar_scan(
    config: MapperConfig,
    position: Array,  # (3,) sensor position
    obstacles: Array,  # (K, 4) analytic spheres (cx, cy, cz, r)
    obstacle_mask: Array,  # (K,) valid rows
    num_rays: int = 360,
) -> tuple[Array, Array, Array]:
    """Horizontal lidar scan by exact ray-sphere casting (replaces the
    reference's random-hit placeholder, EGM:365-397).

    Returns (origins (R,3), directions (R,3), hit_distances (R,); inf for
    misses) — exactly the ``update_with_scan`` input signature.
    """
    dtype = position.dtype
    ang = 2 * jnp.pi * jnp.arange(num_rays, dtype=dtype) / num_rays
    dirs = jnp.stack(
        [jnp.cos(ang), jnp.sin(ang), jnp.zeros_like(ang)], axis=-1
    )
    oc = position - obstacles[:, :3]  # (K, 3)
    r2 = obstacles[:, 3] ** 2
    b = jnp.einsum(  # (R, K); fp32 — a TF32/bf16 product shifts hit cells
        "rd,kd->rk", dirs, oc, precision=jax.lax.Precision.HIGHEST
    )
    c = jnp.sum(oc * oc, axis=-1)[None, :] - r2[None, :]
    disc = b * b - c
    sqrt_disc = jnp.sqrt(jnp.maximum(disc, 0.0))
    t0 = -b - sqrt_disc
    t1 = -b + sqrt_disc
    t = jnp.where(t0 > 1e-6, t0, t1)  # nearest positive root
    hit = (disc >= 0) & (t > 1e-6) & obstacle_mask[None, :]
    t = jnp.where(hit, t, jnp.inf)
    t_min = jnp.min(t, axis=-1)
    origins = jnp.broadcast_to(position, (num_rays, 3))
    return origins, dirs, t_min


class GeometricMapper:
    """Stateful facade mirroring the reference class API (EGM:65+)."""

    def __init__(
        self,
        resolution: float = 0.5,
        max_range: float = 50.0,
        config: Optional[MapperConfig] = None,
    ):
        self.config = config or MapperConfig(
            resolution=resolution, max_range=max_range
        )
        self.map = create_map(self.config)
        self.total_queries = 0

    def update_map(self, origins, directions, hit_distances) -> None:
        self.map = update_with_scan(
            self.config,
            self.map,
            jnp.asarray(origins, jnp.float32),
            jnp.asarray(directions, jnp.float32),
            jnp.asarray(hit_distances, jnp.float32),
        )

    def query_occupancy(self, position) -> float | np.ndarray:
        self.total_queries += 1
        out = query_occupancy(
            self.config, self.map, jnp.asarray(position, jnp.float32)
        )
        return np.asarray(out)

    def is_collision(self, position, threshold: float = 0.6) -> bool:
        return bool(self.query_occupancy(position) > threshold)

    def is_trajectory_safe(
        self, positions, safety_margin: float = 1.0, threshold: float = 0.6
    ) -> bool:
        return bool(
            is_trajectory_safe(
                self.config,
                self.map,
                jnp.asarray(positions, jnp.float32),
                safety_margin,
                threshold,
            )
        )

    def get_local_occupancy_grid(self, center, size_cells: int = 32):
        occ, corner = local_occupancy_grid(
            self.config, self.map, jnp.asarray(center, jnp.float32), size_cells
        )
        return np.asarray(occ), np.asarray(corner)

    def extract_obstacles(self, center, max_obstacles: int = 8, **kw):
        obs, mask = extract_obstacles(
            self.config,
            self.map,
            jnp.asarray(center, jnp.float32),
            max_obstacles,
            **kw,
        )
        return np.asarray(obs), np.asarray(mask)

    def add_obstacle(self, center, radius: float) -> None:
        self.map = add_obstacle(
            self.config,
            self.map,
            jnp.asarray(center, jnp.float32),
            jnp.asarray(radius, jnp.float32),
        )

    def simulate_lidar_scan(
        self, position, obstacles, obstacle_mask=None, num_rays: int = 360
    ):
        obstacles = jnp.asarray(obstacles, jnp.float32)
        if obstacle_mask is None:
            obstacle_mask = jnp.ones(obstacles.shape[0], bool)
        return simulate_lidar_scan(
            self.config,
            jnp.asarray(position, jnp.float32),
            obstacles,
            jnp.asarray(obstacle_mask, bool),
            num_rays,
        )

    def get_mapping_stats(self) -> dict:
        """(EGM:353-363)"""
        occ = jax.nn.sigmoid(self.map.log_odds)
        observed = jnp.abs(self.map.log_odds) > 1e-6
        return {
            "total_voxels": int(observed.sum()),
            "occupied_voxels": int((occ > 0.6).sum()),
            "total_observations": int(self.map.total_observations),
            "total_queries": self.total_queries,
            "resolution": self.config.resolution,
            "max_range": self.config.max_range,
        }

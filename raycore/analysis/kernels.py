"""Analysis layer: ray grids, centroid, illumination, radiosity view factors.

JAX counterpart of the reference's analysis layer (reference:
src/kernels.jl). Where the reference runs `Threads.@threads` CPU loops of
scalar `closest_hit` calls, everything here is one batched jit trace; where
it uses the global RNG, functions take an explicit `jax.random` key.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.ray import Ray
from ..core.sampling import get_orthogonal_basis, sum_mul
from ..accel import dispatch as _disp
from ..accel.types import StaticTLAS


@struct.dataclass
class RayHits:
    """Batched RayHit record (reference RayHit, src/kernels.jl:1-5)."""
    hit: jnp.ndarray       # (...,) bool
    point: jnp.ndarray     # (..., 3) — barycentric-reconstructed hit point
    metadata: jnp.ndarray  # (...,) triangle metadata payload


def generate_ray_grid(scene: StaticTLAS, ray_direction, grid_size: int):
    """Orthographic ray-origin grid on a plane behind the scene, oriented by
    the view direction, sized from the world bound + 5% margin (reference
    generate_ray_grid, src/kernels.jl:10-56). Returns (G, G, 3) origins."""
    direction = jnp.asarray(ray_direction, jnp.float32)
    direction = direction / jnp.linalg.norm(direction)
    lo, hi = scene.root_aabb[0], scene.root_aabb[1]
    cs = jnp.arange(8)
    bits = jnp.stack([(cs >> 0) & 1, (cs >> 1) & 1, (cs >> 2) & 1], -1)
    corners = jnp.where(bits == 1, hi, lo)                     # (8, 3)

    temp = jnp.where(jnp.abs(direction[0]) < 0.9,
                     jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    basis1 = jnp.cross(direction, temp)
    basis1 = basis1 / jnp.linalg.norm(basis1)
    basis2 = jnp.cross(direction, basis1)
    basis2 = basis2 / jnp.linalg.norm(basis2)

    proj1 = jnp.sum(corners * basis1, axis=-1)
    proj2 = jnp.sum(corners * basis2, axis=-1)
    min1, max1 = jnp.min(proj1), jnp.max(proj1)
    min2, max2 = jnp.min(proj2), jnp.max(proj2)
    margin = 0.05 * jnp.maximum(max1 - min1, max2 - min2)
    width = max1 - min1 + 2 * margin
    height = max2 - min2 + 2 * margin

    depth = jnp.sum(corners * direction, axis=-1)
    min_depth = jnp.min(depth) - margin
    center = min_depth * direction + 0.5 * (min1 + max1) * basis1 \
        + 0.5 * (min2 + max2) * basis2

    cw = width / grid_size
    ch = height / grid_size
    ij = jnp.arange(1, grid_size + 1, dtype=jnp.float32)
    u = (ij - (grid_size + 1) / 2.0) * cw
    v = (ij - (grid_size + 1) / 2.0) * ch
    U, V = jnp.meshgrid(u, v, indexing="ij")
    return center + U[..., None] * basis1 + V[..., None] * basis2


def hits_from_grid(scene: StaticTLAS, viewdir, *, grid_size: int = 32,
                   tile_size: int = 16384) -> RayHits:
    """Trace the orthographic grid; hit point = barycentric-weighted
    vertices (reference hits_from_grid, src/kernels.jl:58-72)."""
    direction = jnp.asarray(viewdir, jnp.float32)
    direction = direction / jnp.linalg.norm(direction)
    origins = generate_ray_grid(scene, direction, grid_size)
    rays = Ray.create(o=origins,
                      d=jnp.broadcast_to(direction, origins.shape))
    res = _disp.scene_closest_hit(scene, rays, tile_size=tile_size)
    point = sum_mul(res.barycentric, res.triangle.vertices)
    return RayHits(hit=res.hit, point=point, metadata=res.triangle.metadata)


def get_centroid(scene: StaticTLAS, viewdir, *, grid_size: int = 32,
                 tile_size: int = 16384):
    """(hits, centroid): visible surface points + their mean (reference
    get_centroid, src/kernels.jl:106-110). The mean is over hit points only."""
    hits = hits_from_grid(scene, viewdir, grid_size=grid_size,
                          tile_size=tile_size)
    w = hits.hit.astype(jnp.float32)[..., None]
    denom = jnp.maximum(jnp.sum(w), 1.0)
    centroid = jnp.sum(hits.point * w, axis=(0, 1)) / denom
    return hits, centroid


def get_illumination(scene: StaticTLAS, viewdir, *, grid_size: int = 1000,
                     n_bins: int | None = None, tile_size: int = 16384):
    """Per-metadata-index hit counts — exposure from a direction (reference
    get_illumination, src/kernels.jl:112-124). Returns (n_bins,) float32."""
    if n_bins is None:
        n_bins = int(scene.prims.metadata.shape[0])
    hits = hits_from_grid(scene, viewdir, grid_size=grid_size,
                          tile_size=tile_size)
    idx = jnp.clip(hits.metadata.astype(jnp.int32).reshape(-1), 0, n_bins - 1)
    return jnp.zeros((n_bins,), jnp.float32).at[idx].add(
        hits.hit.reshape(-1).astype(jnp.float32), mode="drop")


def view_factors(scene: StaticTLAS, triangles, key, *,
                 rays_per_triangle: int = 10_000, n_bins: int | None = None,
                 offset: float = 0.01, ray_batch: int = 256,
                 tile_size: int = 16384):
    """Radiosity view-factor count matrix (reference view_factors,
    src/kernels.jl:74-104): for each source triangle, uniform-hemisphere
    rays from random surface points offset 0.01 along the normal; counts
    land in ``result[src_meta, hit_meta]``, self-hits excluded.

    ``triangles``: the (T,) Triangle SoA to sample from (the reference uses
    the TLAS's flat prim array; pass ``scene.prims`` masked to real rows for
    the same behavior). Rays are traced in batches of
    ``T * ray_batch`` to bound memory. Returns (n_bins, n_bins) float32.
    """
    T = triangles.vertices.shape[0]
    if n_bins is None:
        n_bins = T
    v = triangles.vertices
    n = jnp.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    u_b, v_b = get_orthogonal_basis(n)
    src_meta = jnp.clip(triangles.metadata.astype(jnp.int32), 0, n_bins - 1)

    n_batches = -(-rays_per_triangle // ray_batch)
    result = jnp.zeros((n_bins, n_bins), jnp.float32)

    @jax.jit
    def one_batch(result, key):
        k1, k2 = jax.random.split(key)
        r = jax.random.uniform(k1, (T, ray_batch, 2))
        sqrt_r1 = jnp.sqrt(r[..., 0])
        bary = jnp.stack([1.0 - sqrt_r1, sqrt_r1 * (1.0 - r[..., 1]),
                          sqrt_r1 * r[..., 1]], -1)
        # exact fp32 (not einsum: DEFAULT precision may round the inputs)
        pts = jnp.sum(bary[..., None] * v[:, None, :, :], axis=-2)
        o = pts + offset * n[:, None, :]

        xi = jax.random.uniform(k2, (T, ray_batch, 2))
        theta = jnp.arccos(xi[..., 0])
        phi = 2.0 * jnp.pi * xi[..., 1]
        st, ct = jnp.sin(theta), jnp.cos(theta)
        d = (u_b[:, None] * (st * jnp.cos(phi))[..., None]
             + v_b[:, None] * (st * jnp.sin(phi))[..., None]
             + n[:, None] * ct[..., None])

        rays = Ray.create(o=o.reshape(-1, 3), d=d.reshape(-1, 3))
        res = _disp.scene_closest_hit(scene, rays, tile_size=tile_size)
        hit_meta = jnp.clip(res.triangle.metadata.astype(jnp.int32), 0,
                            n_bins - 1).reshape(T, ray_batch)
        hit = res.hit.reshape(T, ray_batch)
        src = jnp.broadcast_to(src_meta[:, None], (T, ray_batch))
        valid = hit & (hit_meta != src)
        flat_idx = src * n_bins + hit_meta
        upd = jnp.zeros((n_bins * n_bins,), jnp.float32).at[
            flat_idx.reshape(-1)].add(valid.reshape(-1).astype(jnp.float32),
                                      mode="drop")
        return result + upd.reshape(n_bins, n_bins)

    for b in range(n_batches):
        key, sub = jax.random.split(key)
        result = one_batch(result, sub)
    return result

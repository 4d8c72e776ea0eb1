"""Brute-force reference intersector.

The semantic oracle for the BVH paths: tests every ray against every
triangle with the exact Möller–Trumbore hot-loop semantics and reduces with
argmin. Implements the full public hit contract — ``(hit, triangle, t,
barycentric(w,u,v), prim_idx)`` with the zero-triangle sentinel on miss
(reference: src/instanced-bvh.jl:2019-2023) — before any acceleration
structure exists. O(rays × tris); use only for validation and tiny scenes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core import triangle as _tri
from ..core.ray import Ray


@struct.dataclass
class HitResult:
    """Batched hit record, the pytree form of the reference's return tuple
    ``(hit, tri, t, bary, instance_idx)``. ``prim_idx``/``instance_idx`` are
    0-based and -1 on miss (the reference uses 1-based with 0-on-miss)."""

    hit: jnp.ndarray          # (...,) bool
    triangle: _tri.Triangle   # (...,) SoA — zero sentinel on miss
    t: jnp.ndarray            # (...,) float32 — 0 on miss
    barycentric: jnp.ndarray  # (..., 3) float32 (w, u, v) — 0 on miss
    prim_idx: jnp.ndarray     # (...,) int32 — -1 on miss
    instance_idx: jnp.ndarray  # (...,) int32 — -1 on miss


def _mask_triangle(tri: _tri.Triangle, hit) -> _tri.Triangle:
    """Zero out gathered triangles on miss, producing the sentinel."""
    mask_f = hit[..., None, None]
    return _tri.Triangle(
        vertices=jnp.where(mask_f, tri.vertices, 0.0),
        normals=jnp.where(mask_f, tri.normals, 0.0),
        tangents=jnp.where(mask_f, tri.tangents, 0.0),
        uv=jnp.where(hit[..., None, None], tri.uv, 0.0),
        metadata=jnp.where(hit, tri.metadata,
                           jnp.zeros_like(tri.metadata)),
    )


def gather_triangles(tris: _tri.Triangle, idx) -> _tri.Triangle:
    """Gather rows of a Triangle SoA at (clipped) indices."""
    idx = jnp.clip(idx, 0, tris.vertices.shape[0] - 1)
    take = lambda a: jnp.take(a, idx, axis=0)
    return jax.tree_util.tree_map(take, tris)


def closest_hit_brute(tris: _tri.Triangle, rays: Ray,
                      ray_chunk: int | None = None) -> HitResult:
    """Closest hit by exhaustive Möller–Trumbore + argmin.

    ``tris``: (N, ...) SoA; ``rays``: batched Ray. Hit selection matches the
    traversal semantics: smallest t in [t_min, t_max]; ties resolve to the
    lowest triangle index (deterministic, unlike traversal order — tests
    must use tie-free scenes when comparing).

    ``ray_chunk``: process flat rays in chunks of this size (the (rays, N)
    intermediates are O(R*N) — 1M rays x 100K tris is 26 GB, past HBM;
    chunking keeps the oracle usable for on-device parity at scale).
    Hit masks and winner indices are identical to the unchunked oracle;
    t may differ by ~1 ULP (different XLA fusion under lax.map)."""
    if ray_chunk is not None:
        batch = rays.batch_shape
        flat = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[len(batch):]), rays)
        R = flat.o.shape[0]
        pad = (-R) % ray_chunk
        if pad:
            flat = jax.tree_util.tree_map(
                lambda a: jnp.concatenate(
                    [a, jnp.broadcast_to(a[:1], (pad,) + a.shape[1:])]), flat)
        chunked = jax.tree_util.tree_map(
            lambda a: a.reshape((-1, ray_chunk) + a.shape[1:]), flat)
        out = jax.lax.map(lambda r: closest_hit_brute(tris, r), chunked)
        return jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:])[:R]
                       .reshape(batch + a.shape[2:]), out)
    o = rays.o[..., None, :]          # (..., 1, 3)
    d = rays.d[..., None, :]
    v = tris.vertices                 # (N, 3, 3)
    hit, t, u, vv = _tri.fast_intersect_triangle(
        o, d, v[..., 0, :], v[..., 1, :], v[..., 2, :],
        rays.t_min[..., None], rays.t_max[..., None])
    t_for_min = jnp.where(hit, t, jnp.inf)
    best = jnp.argmin(t_for_min, axis=-1)
    any_h = jnp.take_along_axis(hit, best[..., None], axis=-1)[..., 0]
    bt = jnp.take_along_axis(t, best[..., None], axis=-1)[..., 0]
    bu = jnp.take_along_axis(u, best[..., None], axis=-1)[..., 0]
    bv = jnp.take_along_axis(vv, best[..., None], axis=-1)[..., 0]
    bary = jnp.where(any_h[..., None],
                     jnp.stack([1.0 - bu - bv, bu, bv], -1), 0.0)
    tri_out = _mask_triangle(gather_triangles(tris, best), any_h)
    idx = jnp.where(any_h, best.astype(jnp.int32), -1)
    return HitResult(hit=any_h, triangle=tri_out,
                     t=jnp.where(any_h, bt, 0.0), barycentric=bary,
                     prim_idx=idx, instance_idx=jnp.where(any_h, 0, -1))


def any_hit_brute(tris: _tri.Triangle, rays: Ray) -> HitResult:
    """Occlusion query; like the reference's any_hit, forces t_min = 0
    (src/instanced-bvh.jl:2045). Reports the lowest-index hit (the reference
    reports traversal-order-first; only the boolean is contractual)."""
    rays0 = rays.replace(t_min=jnp.zeros_like(rays.t_min))
    return closest_hit_brute(tris, rays0)

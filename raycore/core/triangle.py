"""Triangles: SoA storage, watertight and Möller–Trumbore intersection.

JAX counterpart of the reference triangle layer (reference:
src/triangle_mesh.jl for the watertight PBRT-style test, and
src/instanced-bvh.jl:1742-1797 for `safe_invdir` + `fast_intersect_triangle`,
the Möller–Trumbore test used in all BVH traversal hot loops).

A ``Triangle`` value is a pytree whose leaves have arbitrary batch dims:
one value holds one triangle or a whole mesh. ``metadata`` is a uint32 array
by default (the reference's generic payload defaults to the face index,
src/instanced-bvh.jl:593-600); arbitrary pytree metadata is supported by the
scene layer.

Divergence from the reference (documented): for *exactly* degenerate
triangles (Möller–Trumbore determinant == 0 with NaN parameters) the
reference's scalar early-out chain can report a hit with t == NaN; here the
hit mask requires every range test to pass, so NaN parameters always miss.
This is what makes far-away zero/sentinel padding triangles safe.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from .bounds import Bounds3

DEGENERATE_EPS = 0.0  # exact-zero test, matching `≈ 0f0` in Julia (atol=0)


@struct.dataclass
class Triangle:
    """SoA triangle bundle (reference src/triangle_mesh.jl:1-7)."""

    vertices: jnp.ndarray  # (..., 3, 3) float32 — 3 vertices x xyz
    normals: jnp.ndarray   # (..., 3, 3) float32
    tangents: jnp.ndarray  # (..., 3, 3) float32
    uv: jnp.ndarray        # (..., 3, 2) float32
    metadata: jnp.ndarray  # (...,) uint32 payload (or any pytree of arrays)

    @classmethod
    def create(cls, vertices, normals=None, tangents=None, uv=None,
               metadata=None) -> "Triangle":
        vertices = jnp.asarray(vertices, jnp.float32)
        batch = vertices.shape[:-2]
        z = lambda shape: jnp.zeros(batch + shape, jnp.float32)
        if metadata is None:
            metadata = jnp.zeros(batch, jnp.uint32)
        return cls(
            vertices=vertices,
            normals=z((3, 3)) if normals is None else jnp.asarray(normals, jnp.float32),
            tangents=z((3, 3)) if tangents is None else jnp.asarray(tangents, jnp.float32),
            uv=z((3, 2)) if uv is None else jnp.asarray(uv, jnp.float32),
            metadata=metadata,
        )

    @property
    def batch_shape(self):
        return self.vertices.shape[:-2]

    def __len__(self):
        return self.vertices.shape[0]


def empty_triangle(batch_shape=(), metadata=None) -> Triangle:
    """Zero-filled no-hit sentinel (reference src/triangle_mesh.jl:49-76)."""
    if metadata is None:
        metadata = jnp.zeros(batch_shape, jnp.uint32)
    return Triangle(
        vertices=jnp.zeros(batch_shape + (3, 3), jnp.float32),
        normals=jnp.zeros(batch_shape + (3, 3), jnp.float32),
        tangents=jnp.zeros(batch_shape + (3, 3), jnp.float32),
        uv=jnp.zeros(batch_shape + (3, 2), jnp.float32),
        metadata=metadata,
    )


def area(t: Triangle):
    vs = t.vertices
    e1 = vs[..., 1, :] - vs[..., 0, :]
    e2 = vs[..., 2, :] - vs[..., 0, :]
    return 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)


def normal(t: Triangle):
    """Geometric normal (right-handed winding), unnormalized on degenerate."""
    vs = t.vertices
    n = jnp.cross(vs[..., 1, :] - vs[..., 0, :], vs[..., 2, :] - vs[..., 0, :])
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.where(ln > 0, ln, 1.0)


def is_degenerate(vertices):
    """Cross product of the edges is exactly zero (reference
    src/triangle_mesh.jl:14-17, where `≈ 0f0` matches only exact zero)."""
    vertices = jnp.asarray(vertices, jnp.float32)
    v = jnp.cross(vertices[..., 2, :] - vertices[..., 0, :],
                  vertices[..., 1, :] - vertices[..., 0, :])
    return jnp.sum(v * v, axis=-1) <= DEGENERATE_EPS


def object_bound(t: Triangle) -> Bounds3:
    return Bounds3(p_min=jnp.min(t.vertices, axis=-2),
                   p_max=jnp.max(t.vertices, axis=-2))


world_bound = object_bound


# ---------------------------------------------------------------------------
# Watertight intersection (PBRT-style; reference src/triangle_mesh.jl:90-201)
# ---------------------------------------------------------------------------

def _to_ray_coordinate_space(vertices, ray_o, ray_d):
    """Permute so the dominant |d| axis is z, then shear so d = (0,0,1)
    (reference `_to_ray_coordinate_space`, src/triangle_mesh.jl:90-117)."""
    kz = jnp.argmax(jnp.abs(ray_d), axis=-1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    perm = jnp.stack([kx, ky, kz], axis=-1)                   # (..., 3)
    d = jnp.take_along_axis(ray_d, perm, axis=-1)
    denom = 1.0 / d[..., 2]
    shear = jnp.stack([-d[..., 0] * denom, -d[..., 1] * denom, denom], -1)
    vo = vertices - ray_o[..., None, :]                       # (..., 3v, 3)
    batch = jnp.broadcast_shapes(vo.shape[:-2], perm.shape[:-1])
    vo = jnp.broadcast_to(vo, batch + vo.shape[-2:])
    perm_v = jnp.broadcast_to(perm[..., None, :], batch + vo.shape[-2:])
    vo = jnp.take_along_axis(vo, perm_v, axis=-1)
    sx = vo[..., 0] + shear[..., None, 0] * vo[..., 2]
    sy = vo[..., 1] + shear[..., None, 1] * vo[..., 2]
    return jnp.stack([sx, sy, vo[..., 2]], axis=-1), shear


def _edge_function(tv):
    """2D edge functions of the sheared triangle (reference
    src/triangle_mesh.jl:24-30)."""
    x, y = tv[..., 0], tv[..., 1]
    e0 = x[..., 1] * y[..., 2] - y[..., 1] * x[..., 2]
    e1 = x[..., 2] * y[..., 0] - y[..., 2] * x[..., 0]
    e2 = x[..., 0] * y[..., 1] - y[..., 0] * x[..., 1]
    return jnp.stack([e0, e1, e2], axis=-1)


def intersect_triangle(vertices, ray_o, ray_d, t_max):
    """Watertight ray-triangle test.

    Returns ``(hit, t_hit, barycentric)``; exact semantics of the reference
    `intersect_triangle` (src/triangle_mesh.jl:168-201): degenerate reject,
    permute+shear, same-sign edge test, det != 0, scaled-t range test
    ``0 < t < t_max``.
    """
    vertices = jnp.asarray(vertices, jnp.float32)
    ray_o = jnp.asarray(ray_o, jnp.float32)
    ray_d = jnp.asarray(ray_d, jnp.float32)
    t_max = jnp.asarray(t_max, jnp.float32)

    tv, shear = _to_ray_coordinate_space(vertices, ray_o, ray_d)
    edges = _edge_function(tv)

    all_zero = jnp.all(edges == 0.0, axis=-1)
    mixed = jnp.any(edges < 0.0, axis=-1) & jnp.any(edges > 0.0, axis=-1)
    det = jnp.sum(edges, axis=-1)
    sz = shear[..., 2]
    t_scaled = jnp.sum(edges * tv[..., 2] * sz[..., None], axis=-1)

    neg_ok = (det < 0.0) & (t_scaled < 0.0) & (t_scaled >= t_max * det)
    pos_ok = (det > 0.0) & (t_scaled > 0.0) & (t_scaled <= t_max * det)
    hit = (~is_degenerate(vertices)) & (~all_zero) & (~mixed) \
        & (det != 0.0) & (neg_ok | pos_ok)

    safe_det = jnp.where(det != 0.0, det, 1.0)
    inv_det = 1.0 / safe_det
    bary = jnp.where(hit[..., None], edges * inv_det[..., None], 0.0)
    t_hit = jnp.where(hit, t_scaled * inv_det, 0.0)
    return hit, t_hit, bary


def intersect(t: Triangle, ray):
    """Watertight intersection against a Ray pytree; returns
    (hit, t_hit, barycentric)."""
    return intersect_triangle(t.vertices, ray.o, ray.d, ray.t_max)


def intersect_p(t: Triangle, ray):
    return intersect(t, ray)[0]


# ---------------------------------------------------------------------------
# Möller–Trumbore (BVH hot loop; reference src/instanced-bvh.jl:1742-1797)
# ---------------------------------------------------------------------------

def safe_invdir(d):
    """1/d with |d| clamped away from zero at 1e-5, preserving sign
    (reference safe_invdir, src/instanced-bvh.jl:1742-1748)."""
    d = jnp.asarray(d, jnp.float32)
    eps = jnp.float32(1e-5)
    clamped = jnp.where(jnp.abs(d) > eps, d, jnp.copysign(eps, d))
    return 1.0 / clamped


# Exact magnitude safe_invdir produces for a clamped component: every
# clamped inverse is exactly +-this float32 value, and any GENUINE
# component (|d| > 1e-5) inverts to strictly-or-equal below it. Slab
# tests compare |inv_d| >= INV_DIR_CLAMP to detect clamped axes without
# misflagging genuine near-parallel directions (ADVICE r2: a 0.99e5
# threshold also captured real directions with |d| in [1e-5, 1.01e-5]).
import numpy as _np
INV_DIR_CLAMP = float(_np.float32(1.0) / _np.float32(1e-5))


def fast_intersect_triangle(ray_o, ray_d, v0, v1, v2, t_min, closest_t):
    """Möller–Trumbore, exact semantics of the reference
    `fast_intersect_triangle` (src/instanced-bvh.jl:1756-1797): no explicit
    degenerate guard — ``invd = 1/det`` may be inf and the u/v/t range tests
    reject. Returns ``(hit, t, u, v)`` with zeros on miss."""
    e1 = v1 - v0
    e2 = v2 - v0
    s1 = jnp.cross(ray_d, e2)
    det = jnp.sum(s1 * e1, axis=-1)
    invd = 1.0 / det
    dvec = ray_o - v0
    u = jnp.sum(dvec * s1, axis=-1) * invd
    s2 = jnp.cross(dvec, e1)
    v = jnp.sum(ray_d * s2, axis=-1) * invd
    t = jnp.sum(e2 * s2, axis=-1) * invd
    hit = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t >= t_min) & (t <= closest_t)
    z = jnp.zeros_like(t)
    return hit, jnp.where(hit, t, z), jnp.where(hit, u, z), jnp.where(hit, v, z)


def partial_derivatives(vertices, uv):
    """∂p/∂u, ∂p/∂v from vertex/uv deltas with degenerate fallback to an
    arbitrary orthonormal frame (reference src/triangle_mesh.jl:119-136)."""
    vertices = jnp.asarray(vertices, jnp.float32)
    uv = jnp.asarray(uv, jnp.float32)
    duv13 = uv[..., 0, :] - uv[..., 2, :]
    duv23 = uv[..., 1, :] - uv[..., 2, :]
    dp13 = vertices[..., 0, :] - vertices[..., 2, :]
    dp23 = vertices[..., 1, :] - vertices[..., 2, :]
    det = duv13[..., 0] * duv23[..., 1] - duv13[..., 1] * duv23[..., 0]

    ok = det != 0.0
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    dpdu = (duv23[..., 1:2] * dp13 - duv13[..., 1:2] * dp23) * inv_det[..., None]
    dpdv = (-duv23[..., 0:1] * dp13 + duv13[..., 0:1] * dp23) * inv_det[..., None]

    n = jnp.cross(vertices[..., 2, :] - vertices[..., 0, :],
                  vertices[..., 1, :] - vertices[..., 0, :])
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.where(ln > 0, ln, 1.0)
    fb_u, fb_v = _coordinate_system(n)
    dpdu = jnp.where(ok[..., None], dpdu, fb_u)
    dpdv = jnp.where(ok[..., None], dpdv, fb_v)
    return dpdu, dpdv, dp13, dp23


def normal_derivatives(t: Triangle):
    """∂n/∂u, ∂n/∂v, zero when uv-degenerate or normals are NaN placeholders
    (reference src/triangle_mesh.jl:142-157)."""
    uv = t.uv
    ns = t.normals
    duv13 = uv[..., 0, :] - uv[..., 2, :]
    duv23 = uv[..., 1, :] - uv[..., 2, :]
    dn13 = ns[..., 0, :] - ns[..., 2, :]
    dn23 = ns[..., 1, :] - ns[..., 2, :]
    det = duv13[..., 0] * duv23[..., 1] - duv13[..., 1] * duv23[..., 0]
    ok = (det != 0.0) & ~jnp.all(jnp.isnan(ns), axis=(-1, -2))
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    dndu = (duv23[..., 1:2] * dn13 - duv13[..., 1:2] * dn23) * inv_det[..., None]
    dndv = (-duv23[..., 0:1] * dn13 + duv13[..., 0:1] * dn23) * inv_det[..., None]
    zero = jnp.zeros_like(dndu)
    return (jnp.where(ok[..., None], dndu, zero),
            jnp.where(ok[..., None], dndv, zero))


def _coordinate_system(v1):
    """Build two vectors orthogonal to v1 (reference src/math.jl:93-100)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = jnp.abs(x) > jnp.abs(y)
    inv_a = 1.0 / jnp.sqrt(jnp.where(use_x, x * x + z * z, y * y + z * z))
    v2 = jnp.where(use_x[..., None],
                   jnp.stack([-z * inv_a, jnp.zeros_like(x), x * inv_a], -1),
                   jnp.stack([jnp.zeros_like(x), z * inv_a, -y * inv_a], -1))
    return v2, jnp.cross(v1, v2)


def bary_interp(bary, vals):
    """Barycentric interpolation sum_k bary[...,k] * vals[...,k,:].

    Elementwise multiply-add on purpose (not einsum): at DEFAULT
    precision the contraction may run with reduced-precision inputs,
    rounding the interpolated hit point — which then seeds
    shadow/secondary ray origins with ~3e-3 relative error (acne). fp32
    multiply-adds are exact and cheap at k=3 widths.
    """
    return jnp.sum(bary[..., None] * vals, axis=-2)

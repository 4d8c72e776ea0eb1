"""Axis-aligned bounding boxes (2D/3D).

JAX counterpart of the reference's bounds layer (reference:
src/bounds.jl). A ``Bounds3`` is an SoA pytree of ``p_min``/``p_max`` arrays
with arbitrary batch dims; all ops are vectorized and jit-friendly.

Invalid-by-default: ``p_min = +inf``, ``p_max = -inf`` (src/bounds.jl:12-13),
so the empty box is the identity of ``union``.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

INF = jnp.inf


@struct.dataclass
class Bounds3:
    p_min: jnp.ndarray  # (..., 3) float32
    p_max: jnp.ndarray  # (..., 3) float32

    @classmethod
    def empty(cls, batch_shape=()) -> "Bounds3":
        return cls(p_min=jnp.full(batch_shape + (3,), INF, jnp.float32),
                   p_max=jnp.full(batch_shape + (3,), -INF, jnp.float32))

    @classmethod
    def from_point(cls, p) -> "Bounds3":
        p = jnp.asarray(p, jnp.float32)
        return cls(p_min=p, p_max=p)

    @classmethod
    def from_points(cls, a, b) -> "Bounds3":
        a = jnp.asarray(a, jnp.float32)
        b = jnp.asarray(b, jnp.float32)
        return cls(p_min=jnp.minimum(a, b), p_max=jnp.maximum(a, b))

    @property
    def batch_shape(self):
        return self.p_min.shape[:-1]


@struct.dataclass
class Bounds2:
    p_min: jnp.ndarray  # (..., 2)
    p_max: jnp.ndarray  # (..., 2)

    @classmethod
    def empty(cls, batch_shape=()) -> "Bounds2":
        return cls(p_min=jnp.full(batch_shape + (2,), INF, jnp.float32),
                   p_max=jnp.full(batch_shape + (2,), -INF, jnp.float32))

    @classmethod
    def from_points(cls, a, b) -> "Bounds2":
        a = jnp.asarray(a, jnp.float32)
        b = jnp.asarray(b, jnp.float32)
        return cls(p_min=jnp.minimum(a, b), p_max=jnp.maximum(a, b))


# ---------------------------------------------------------------------------
# Generic ops (work for Bounds2 and Bounds3)
# ---------------------------------------------------------------------------

def union(a, b):
    """Union of two boxes, or of a box and a point array."""
    if isinstance(b, (Bounds2, Bounds3)):
        return type(a)(p_min=jnp.minimum(a.p_min, b.p_min),
                       p_max=jnp.maximum(a.p_max, b.p_max))
    b = jnp.asarray(b, jnp.float32)
    return type(a)(p_min=jnp.minimum(a.p_min, b), p_max=jnp.maximum(a.p_max, b))


def intersect_bounds(a, b):
    return type(a)(p_min=jnp.maximum(a.p_min, b.p_min),
                   p_max=jnp.minimum(a.p_max, b.p_max))


def overlaps(a, b):
    """Boxes overlap on every axis (closed intervals)."""
    return jnp.all((a.p_max >= b.p_min) & (a.p_min <= b.p_max), axis=-1)


def inside(b, p):
    p = jnp.asarray(p, jnp.float32)
    return jnp.all((p >= b.p_min) & (p <= b.p_max), axis=-1)


def inside_exclusive(b, p):
    p = jnp.asarray(p, jnp.float32)
    return jnp.all((p >= b.p_min) & (p < b.p_max), axis=-1)


def expand(b, delta):
    delta = jnp.asarray(delta, jnp.float32)
    return type(b)(p_min=b.p_min - delta, p_max=b.p_max + delta)


def diagonal(b):
    return b.p_max - b.p_min


def surface_area(b: Bounds3):
    d = diagonal(b)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def area(b: Bounds2):
    d = diagonal(b)
    return d[..., 0] * d[..., 1]


def volume(b: Bounds3):
    d = diagonal(b)
    return d[..., 0] * d[..., 1] * d[..., 2]


def maximum_extent(b):
    """Index of the longest axis (reference src/bounds.jl:118-126)."""
    return jnp.argmax(diagonal(b), axis=-1)


def corner(b: Bounds3, c):
    """c-th corner, c in [0,8): bit i of c selects p_max on axis i
    (reference src/bounds.jl:53-59)."""
    c = jnp.asarray(c, jnp.int32)
    bits = jnp.stack([(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1], axis=-1)
    return jnp.where(bits == 1, b.p_max, b.p_min)


def corners(b: Bounds3):
    """All 8 corners, shape (..., 8, 3)."""
    cs = jnp.arange(8, dtype=jnp.int32)
    bits = jnp.stack([(cs >> 0) & 1, (cs >> 1) & 1, (cs >> 2) & 1], axis=-1)
    return jnp.where(bits[..., :, :] == 1, b.p_max[..., None, :],
                     b.p_min[..., None, :])


def lerp(b, t):
    t = jnp.asarray(t, jnp.float32)
    return b.p_min + t * (b.p_max - b.p_min)


def offset(b, p):
    """Continuous coordinates of p within the box in [0,1] per axis
    (division skipped on degenerate axes, reference src/bounds.jl)."""
    p = jnp.asarray(p, jnp.float32)
    d = b.p_max - b.p_min
    o = p - b.p_min
    return jnp.where(d > 0, o / jnp.where(d > 0, d, 1.0), o)


def bounding_sphere(b: Bounds3):
    """(center, radius); radius 0 when the box doesn't contain its own center
    (i.e., it's invalid/empty) — reference src/bounds.jl:150-155."""
    center = (b.p_min + b.p_max) * 0.5
    radius = jnp.where(inside(b, center),
                       jnp.linalg.norm(b.p_max - center, axis=-1), 0.0)
    return center, radius


def is_valid(b):
    return jnp.all(b.p_min <= b.p_max, axis=-1)


# ---------------------------------------------------------------------------
# Ray-box intersection
# ---------------------------------------------------------------------------

def intersect_ray(b: Bounds3, ray_o, ray_d, t_max):
    """Slab test returning ``(hit, t0, t1)`` with the interval clipped to
    ``[0, t_max]`` (reference src/bounds.jl:157-173). Division by a zero
    direction component yields ±inf which the min/max logic handles."""
    ray_o = jnp.asarray(ray_o, jnp.float32)
    ray_d = jnp.asarray(ray_d, jnp.float32)
    inv_d = 1.0 / ray_d
    t_near = (b.p_min - ray_o) * inv_d
    t_far = (b.p_max - ray_o) * inv_d
    lo = jnp.minimum(t_near, t_far)
    hi = jnp.maximum(t_near, t_far)
    t0 = jnp.maximum(jnp.max(lo, axis=-1), 0.0)
    t1 = jnp.minimum(jnp.min(hi, axis=-1), jnp.asarray(t_max, jnp.float32))
    hit = t0 <= t1
    return hit, jnp.where(hit, t0, 0.0), jnp.where(hit, t1, 0.0)


def intersect_p(b: Bounds3, ray_o, t_max, inv_dir, dir_is_negative=None):
    """Precomputed-inverse-direction predicate variant (reference
    src/bounds.jl:175-208). Returns bool."""
    ray_o = jnp.asarray(ray_o, jnp.float32)
    inv_dir = jnp.asarray(inv_dir, jnp.float32)
    neg = inv_dir < 0 if dir_is_negative is None else dir_is_negative
    near = jnp.where(neg, b.p_max, b.p_min)
    far = jnp.where(neg, b.p_min, b.p_max)
    t_near = (near - ray_o) * inv_dir
    t_far = (far - ray_o) * inv_dir
    t0 = jnp.max(t_near, axis=-1)
    t1 = jnp.min(t_far, axis=-1)
    return (t0 <= t1) & (t0 < jnp.asarray(t_max, jnp.float32)) & (t1 > 0.0)


def fast_intersect_bbox(ray_o, ray_inv_d, p_min, p_max, t_min, t_max):
    """Slab test used in BVH traversal hot loops (reference
    `fast_intersect_bbox`, src/instanced-bvh.jl:1841-1859): returns
    ``(entry_t, exit_t)`` where entry<=exit iff hit. Inputs are raw
    arrays (broadcastable), not Bounds3, so callers can feed packed nodes.

    Deliberate fix over the reference: an axis-parallel ray (safe_invdir
    clamps |d|<1e-5 to ±1e5) whose origin lies INSIDE the slab never
    exits it, but the clamped products report an exit at |o-b|*1e5 —
    which falsely rejects a node whose face is within ~t*1e-5 of the
    origin coordinate (found at 1/5000 rate on axis-aligned primary
    grids; the bundle interval tests got the same fix in round 1). Such
    axes are treated as all-t when the origin is inside. When the origin
    is OUTSIDE the slab the finite clamped interval is kept: it
    underestimates the true entry (|o-b|*1e5 <= |o-b|/|d|), so it never
    culls a reachable node — forcing empty there would drop genuine
    far-t hits (ADVICE r2). Clamp detection compares against the exact
    clamp constant so genuine directions are never misflagged."""
    from .triangle import INV_DIR_CLAMP
    oxinv = -ray_o * ray_inv_d
    f = p_max * ray_inv_d + oxinv
    n = p_min * ray_inv_d + oxinv
    hi = jnp.maximum(f, n)
    lo = jnp.minimum(f, n)
    par = jnp.abs(ray_inv_d) >= INV_DIR_CLAMP
    inside = (ray_o >= p_min) & (ray_o <= p_max)
    inf = jnp.inf
    lo = jnp.where(par & inside, -inf, lo)
    hi = jnp.where(par & inside, inf, hi)
    max_t = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    min_t = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    return min_t, max_t

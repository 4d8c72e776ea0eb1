"""Affine transformations and quaternions.

JAX counterpart of the reference's transform layer (reference:
src/transformations.jl) plus the row-major 3x4 instance-transform utilities
from the instancing runtime (reference: src/instanced-bvh.jl:1655-1730).

A ``Transformation`` carries the 4x4 matrix and its cached inverse; batch
dims are allowed on the left. Instance transforms are stored as (..., 3, 4)
row-major affine matrices (``world = M[:, :3] @ p + M[:, 3]``), matching the
Vulkan ``VkTransformMatrixKHR`` layout the reference adopted.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from . import bounds as _bounds
from .ray import Ray, RayDifferentials


@struct.dataclass
class Transformation:
    m: jnp.ndarray      # (..., 4, 4) float32
    m_inv: jnp.ndarray  # (..., 4, 4) float32

    @classmethod
    def identity(cls, batch_shape=()) -> "Transformation":
        eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                               batch_shape + (4, 4))
        return cls(m=eye, m_inv=eye)

    @classmethod
    def from_matrix(cls, m) -> "Transformation":
        m = jnp.asarray(m, jnp.float32)
        return cls(m=m, m_inv=jnp.linalg.inv(m))

    def inverse(self) -> "Transformation":
        return Transformation(m=self.m_inv, m_inv=self.m)

    def transpose(self) -> "Transformation":
        return Transformation(m=jnp.swapaxes(self.m, -1, -2),
                              m_inv=jnp.swapaxes(self.m_inv, -1, -2))

    def compose(self, other: "Transformation") -> "Transformation":
        """self ∘ other — apply ``other`` first. Inverses compose in reverse
        order (reference src/transformations.jl:20-22)."""
        # HIGHEST precision: DEFAULT bf16-rounds composed matrices, which
        # then quantizes every point they are applied to.
        return Transformation(
            m=jnp.matmul(self.m, other.m, precision="highest"),
            m_inv=jnp.matmul(other.m_inv, self.m_inv, precision="highest"))

    def __matmul__(self, other):
        if isinstance(other, Transformation):
            return self.compose(other)
        return NotImplemented

    # -- application ---------------------------------------------------
    def apply_point(self, p):
        """Apply to a point with branch-free w-divide (reference
        src/transformations.jl:140-146)."""
        p = jnp.asarray(p, jnp.float32)
        # Exact fp32 elementwise math throughout (see _apply_mat3).
        r = _apply_mat3(self.m[..., :3, :3], p) + self.m[..., :3, 3]
        w = jnp.sum(self.m[..., 3, :3] * p, axis=-1) + self.m[..., 3, 3]
        return r / w[..., None]

    def apply_vector(self, v):
        v = jnp.asarray(v, jnp.float32)
        return _apply_mat3(self.m[..., :3, :3], v)

    def apply_normal(self, n):
        """Normals transform by the inverse-transpose (reference
        src/transformations.jl:149)."""
        n = jnp.asarray(n, jnp.float32)
        return jnp.sum(self.m_inv[..., :3, :3] * n[..., :, None], axis=-2)

    def apply_bounds(self, b: _bounds.Bounds3) -> _bounds.Bounds3:
        """Transform all 8 corners and re-union (reference
        src/transformations.jl:151-153)."""
        cs = _bounds.corners(b)                     # (..., 8, 3)
        tc = self.apply_point(cs)
        return _bounds.Bounds3(p_min=jnp.min(tc, axis=-2),
                               p_max=jnp.max(tc, axis=-2))

    def apply_ray(self, r):
        if isinstance(r, RayDifferentials):
            return r.replace(
                o=self.apply_point(r.o), d=self.apply_vector(r.d),
                rx_origin=self.apply_point(r.rx_origin),
                ry_origin=self.apply_point(r.ry_origin),
                rx_direction=self.apply_vector(r.rx_direction),
                ry_direction=self.apply_vector(r.ry_direction))
        return r.replace(o=self.apply_point(r.o), d=self.apply_vector(r.d))

    def __call__(self, x):
        if isinstance(x, _bounds.Bounds3):
            return self.apply_bounds(x)
        if isinstance(x, (Ray, RayDifferentials)):
            return self.apply_ray(x)
        return self.apply_point(x)


# ---------------------------------------------------------------------------
# Constructors (reference src/transformations.jl:24-138)
# ---------------------------------------------------------------------------

def _affine(m3, t):
    m = jnp.zeros(t.shape[:-1] + (4, 4), jnp.float32)
    m = m.at[..., :3, :3].set(m3)
    m = m.at[..., :3, 3].set(t)
    m = m.at[..., 3, 3].set(1.0)
    return m


def translate(delta) -> Transformation:
    delta = jnp.asarray(delta, jnp.float32)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                           delta.shape[:-1] + (3, 3))
    return Transformation(m=_affine(eye, delta), m_inv=_affine(eye, -delta))


def scale(s) -> Transformation:
    s = jnp.asarray(s, jnp.float32)
    if s.ndim == 0:
        s = jnp.broadcast_to(s, (3,))
    d = s[..., None, :] * jnp.eye(3, dtype=jnp.float32)
    d_inv = (1.0 / s)[..., None, :] * jnp.eye(3, dtype=jnp.float32)
    z = jnp.zeros(s.shape[:-1] + (3,), jnp.float32)
    return Transformation(m=_affine(d, z), m_inv=_affine(d_inv, z))


def _rot_axis(theta, i, j):
    theta = jnp.asarray(theta, jnp.float32)
    c, s = jnp.cos(theta), jnp.sin(theta)
    m = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                         theta.shape + (4, 4))
    m = m.at[..., i, i].set(c).at[..., i, j].set(-s)
    m = m.at[..., j, i].set(s).at[..., j, j].set(c)
    return Transformation(m=m, m_inv=jnp.swapaxes(m, -1, -2))


def rotate_x(theta_deg):
    return _rot_axis(jnp.deg2rad(jnp.asarray(theta_deg, jnp.float32)), 1, 2)


def rotate_y(theta_deg):
    return _rot_axis(jnp.deg2rad(jnp.asarray(theta_deg, jnp.float32)), 2, 0)


def rotate_z(theta_deg):
    return _rot_axis(jnp.deg2rad(jnp.asarray(theta_deg, jnp.float32)), 0, 1)


def rotate(theta_deg, axis) -> Transformation:
    """Rotation about an arbitrary axis (Rodrigues), angle in degrees."""
    theta = jnp.deg2rad(jnp.asarray(theta_deg, jnp.float32))
    a = jnp.asarray(axis, jnp.float32)
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    c, s = jnp.cos(theta), jnp.sin(theta)
    x, y, z = a[..., 0], a[..., 1], a[..., 2]
    K = jnp.stack([
        jnp.stack([jnp.zeros_like(x), -z, y], -1),
        jnp.stack([z, jnp.zeros_like(x), -x], -1),
        jnp.stack([-y, x, jnp.zeros_like(x)], -1),
    ], -2)
    eye = jnp.eye(3, dtype=jnp.float32)
    m3 = eye + s[..., None, None] * K \
        + (1 - c)[..., None, None] * jnp.matmul(K, K, precision="highest")
    zt = jnp.zeros(a.shape[:-1] + (3,), jnp.float32)
    m = _affine(m3, zt)
    return Transformation(m=m, m_inv=jnp.swapaxes(m, -1, -2))


def look_at(position, target, up) -> Transformation:
    """Camera-to-world transform (reference src/transformations.jl:101-119)."""
    position = jnp.asarray(position, jnp.float32)
    target = jnp.asarray(target, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    z = target - position
    z = z / jnp.linalg.norm(z, axis=-1, keepdims=True)
    x = jnp.cross(up / jnp.linalg.norm(up, axis=-1, keepdims=True), z)
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    y = jnp.cross(z, x)
    m3 = jnp.stack([x, y, z], axis=-1)
    m = _affine(m3, position)
    return Transformation(m=m, m_inv=jnp.linalg.inv(m))


def perspective(fov_deg, near, far) -> Transformation:
    """Perspective projection (reference src/transformations.jl:121-138)."""
    fov = jnp.asarray(fov_deg, jnp.float32)
    near = jnp.asarray(near, jnp.float32)
    far = jnp.asarray(far, jnp.float32)
    persp = jnp.array([[1, 0, 0, 0],
                       [0, 1, 0, 0],
                       [0, 0, 0, 0],
                       [0, 0, 1, 0]], jnp.float32)
    persp = persp.at[2, 2].set(far / (far - near))
    persp = persp.at[2, 3].set(-far * near / (far - near))
    inv_tan = 1.0 / jnp.tan(jnp.deg2rad(fov) / 2.0)
    return scale(jnp.stack([inv_tan, inv_tan, jnp.float32(1.0)])).compose(
        Transformation.from_matrix(persp))


def has_scale(t: Transformation, eps=1e-4):
    """True if the transform scales lengths (reference
    src/transformations.jl:169-175)."""
    m3 = t.m[..., :3, :3]
    la = jnp.sum(m3[..., :, 0] ** 2, -1)
    lb = jnp.sum(m3[..., :, 1] ** 2, -1)
    lc = jnp.sum(m3[..., :, 2] ** 2, -1)
    ok = lambda v: (v > 1 - eps) & (v < 1 + eps)
    return ~(ok(la) & ok(lb) & ok(lc))


def swaps_handedness(t: Transformation):
    """det of the upper-left 3x3 < 0 (reference src/transformations.jl:177-179)."""
    return jnp.linalg.det(t.m[..., :3, :3]) < 0


def is_identity(t: Transformation):
    return jnp.all(t.m == jnp.eye(4, dtype=jnp.float32), axis=(-1, -2))


# ---------------------------------------------------------------------------
# Quaternion (reference src/transformations.jl:181-263)
# ---------------------------------------------------------------------------

@struct.dataclass
class Quaternion:
    v: jnp.ndarray  # (..., 3)
    w: jnp.ndarray  # (...,)

    @classmethod
    def identity(cls, batch_shape=()) -> "Quaternion":
        return cls(v=jnp.zeros(batch_shape + (3,), jnp.float32),
                   w=jnp.ones(batch_shape, jnp.float32))

    @classmethod
    def from_transformation(cls, t: Transformation) -> "Quaternion":
        """Shepperd's branch-free extraction via jnp.where over the four cases."""
        m = t.m
        tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
        # Case A: trace positive.
        sA = jnp.sqrt(jnp.maximum(tr + 1.0, 0.0))
        wA = 0.5 * sA
        fA = jnp.where(sA > 0, 0.5 / jnp.where(sA > 0, sA, 1.0), 0.0)
        vA = jnp.stack([(m[..., 2, 1] - m[..., 1, 2]) * fA,
                        (m[..., 0, 2] - m[..., 2, 0]) * fA,
                        (m[..., 1, 0] - m[..., 0, 1]) * fA], -1)

        # Case B: largest diagonal element i.
        def diag_case(i):
            j, k = (i + 1) % 3, (i + 2) % 3
            s = jnp.sqrt(jnp.maximum(
                m[..., i, i] - m[..., j, j] - m[..., k, k] + 1.0, 1e-20))
            q = jnp.zeros(m.shape[:-2] + (3,), jnp.float32)
            q = q.at[..., i].set(0.5 * s)
            f = 0.5 / s
            q = q.at[..., j].set((m[..., j, i] + m[..., i, j]) * f)
            q = q.at[..., k].set((m[..., k, i] + m[..., i, k]) * f)
            w = (m[..., k, j] - m[..., j, k]) * f
            return q, w

        d = jnp.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], -1)
        i_max = jnp.argmax(d, axis=-1)
        qs, ws = zip(*(diag_case(i) for i in range(3)))
        vB = jnp.select([i_max[..., None] == i for i in range(3)], list(qs))
        wB = jnp.select([i_max == i for i in range(3)], list(ws))

        use_a = tr > 0
        return cls(v=jnp.where(use_a[..., None], vA, vB),
                   w=jnp.where(use_a, wA, wB))

    def to_transformation(self) -> Transformation:
        x, y, z = self.v[..., 0], self.v[..., 1], self.v[..., 2]
        w = self.w
        m3 = jnp.stack([
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ], -2)
        zt = jnp.zeros(w.shape + (3,), jnp.float32)
        m = _affine(m3, zt)
        return Transformation(m=m, m_inv=jnp.swapaxes(m, -1, -2))

    def normalize(self) -> "Quaternion":
        n = jnp.sqrt(dot(self, self))
        return Quaternion(v=self.v / n[..., None], w=self.w / n)


def dot(a: Quaternion, b: Quaternion):
    return jnp.sum(a.v * b.v, -1) + a.w * b.w


def slerp(t, a: Quaternion, b: Quaternion) -> Quaternion:
    """Spherical interpolation with small-angle lerp fallback (reference
    src/transformations.jl:246-263)."""
    t = jnp.asarray(t, jnp.float32)
    cos_theta = dot(a, b)
    near = cos_theta > 0.9995

    # Lerp branch.
    lv = a.v + t[..., None] * (b.v - a.v)
    lw = a.w + t * (b.w - a.w)
    ln = jnp.sqrt(jnp.sum(lv * lv, -1) + lw * lw)

    # Slerp branch.
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    theta_p = theta * t
    # qperp = normalize(b - a*cos_theta)
    pv = b.v - a.v * cos_theta[..., None]
    pw = b.w - a.w * cos_theta
    pn = jnp.sqrt(jnp.maximum(jnp.sum(pv * pv, -1) + pw * pw, 1e-20))
    sv = a.v * jnp.cos(theta_p)[..., None] + (pv / pn[..., None]) * jnp.sin(theta_p)[..., None]
    sw = a.w * jnp.cos(theta_p) + (pw / pn) * jnp.sin(theta_p)

    return Quaternion(v=jnp.where(near[..., None], lv / ln[..., None], sv),
                      w=jnp.where(near, lw / ln, sw))


# ---------------------------------------------------------------------------
# Row-major 3x4 instance transforms (reference src/instanced-bvh.jl:1655-1730)
# ---------------------------------------------------------------------------

def mat4_to_mat3x4(m):
    """Take the upper three rows of a 4x4 (reference mat4_to_mat3x4)."""
    return jnp.asarray(m, jnp.float32)[..., :3, :4]


def mat3x4_identity(batch_shape=()):
    return jnp.broadcast_to(
        jnp.eye(3, 4, dtype=jnp.float32), batch_shape + (3, 4))


def mat3x4_inverse(m):
    """Affine inverse of a row-major 3x4: inv = [B | -B t] with B = inv(R)
    (reference mat3x4_inverse, src/instanced-bvh.jl:1674-1687). Closed-form
    adjugate 3x3 inverse — batched and vmap-friendly."""
    m = jnp.asarray(m, jnp.float32)
    R = m[..., :3, :3]
    t = m[..., :3, 3]
    c0 = jnp.cross(R[..., :, 1], R[..., :, 2], axis=-1)
    c1 = jnp.cross(R[..., :, 2], R[..., :, 0], axis=-1)
    c2 = jnp.cross(R[..., :, 0], R[..., :, 1], axis=-1)
    det = jnp.sum(R[..., :, 0] * c0, axis=-1)
    B = jnp.stack([c0, c1, c2], axis=-2) / det[..., None, None]
    t_inv = -_apply_mat3(B, t)
    return jnp.concatenate([B, t_inv[..., :, None]], axis=-1)


def _apply_mat3(R, p):
    """Exact fp32 3x3 matrix-vector product via elementwise multiply-add.

    Deliberately NOT einsum/matmul: at DEFAULT precision XLA may run tiny
    contractions with reduced-precision inputs (bf16, or TF32 on a GPU) —
    which quantizes geometry (baked soup vertices rounded to bf16 values
    caused TLAS-vs-dense hit mismatches). Elementwise ops stay in full
    fp32 and are cheap for 3-wide shapes anyway."""
    return jnp.sum(R * p[..., None, :], axis=-1)


def transform_point_3x4(m, p):
    """world = R p + t for a row-major 3x4 (exact fp32; see _apply_mat3)."""
    return _apply_mat3(m[..., :3, :3], p) + m[..., :3, 3]


def transform_direction_3x4(m, v):
    return _apply_mat3(m[..., :3, :3], v)

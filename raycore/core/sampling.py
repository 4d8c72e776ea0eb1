"""Sampling and shading-frame math.

JAX counterpart of the reference's math layer (reference: src/math.jl).
The reference uses the implicit global RNG (`rand`); here every random
function threads an explicit `jax.random` key (or takes precomputed uniforms
``u``), the idiomatic JAX contract.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

PI = jnp.pi


def concentric_sample_disk(u):
    """Map [0,1]^2 uniforms to the unit disk, concentric mapping
    (reference src/math.jl:2-15)."""
    u = jnp.asarray(u, jnp.float32)
    offset = 2.0 * u - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    degenerate = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    safe = lambda x: jnp.where(x == 0.0, 1.0, x)
    r = jnp.where(use_x, ox, oy)
    theta = jnp.where(use_x, (oy / safe(ox)) * (PI / 4.0),
                      PI / 2.0 - (ox / safe(oy)) * (PI / 4.0))
    p = r[..., None] * jnp.stack([jnp.cos(theta), jnp.sin(theta)], -1)
    return jnp.where(degenerate[..., None], 0.0, p)


def cosine_sample_hemisphere(u):
    """Cosine-weighted hemisphere about +z (reference src/math.jl:17-21)."""
    d = concentric_sample_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.stack([d[..., 0], d[..., 1], z], -1)


def uniform_sample_sphere(u):
    u = jnp.asarray(u, jnp.float32)
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * PI * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], -1)


def uniform_sample_cone(u, cos_theta_max, x=None, y=None, z=None):
    """Uniform direction within a cone about +z, or about frame (x,y,z)
    (reference src/math.jl:31-50)."""
    u = jnp.asarray(u, jnp.float32)
    cos_theta = 1.0 - u[..., 0] + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta ** 2))
    phi = u[..., 1] * 2.0 * PI
    if x is None:
        return jnp.stack([jnp.cos(phi) * sin_theta,
                          jnp.sin(phi) * sin_theta, cos_theta], -1)
    return (x * (jnp.cos(phi) * sin_theta)[..., None]
            + y * (jnp.sin(phi) * sin_theta)[..., None]
            + z * cos_theta[..., None])


def uniform_sphere_pdf():
    return 1.0 / (4.0 * PI)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def sum_mul(a, b):
    """Barycentric combination helper: sum_i a[i]*b[i] where b is a stack of
    three vectors (reference src/math.jl:52)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return jnp.sum(a[..., :, None] * b, axis=-2)


# -- shading frame trig (normal = +z; reference src/math.jl:63-75) ----------

def cos_theta(w):
    return w[..., 2]


def sin_theta2(w):
    return jnp.maximum(0.0, 1.0 - cos_theta(w) ** 2)


def sin_theta(w):
    return jnp.sqrt(sin_theta2(w))


def tan_theta(w):
    return sin_theta(w) / cos_theta(w)


def cos_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 1.0, jnp.clip(w[..., 0] / jnp.where(st == 0, 1.0, st), -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 1.0, jnp.clip(w[..., 1] / jnp.where(st == 0, 1.0, st), -1.0, 1.0))


def reflect(wo, n):
    """Reflect wo about n (reference src/math.jl:80): -wo + 2(wo.n)n."""
    wo = jnp.asarray(wo, jnp.float32)
    n = jnp.asarray(n, jnp.float32)
    return -wo + 2.0 * jnp.sum(wo * n, -1, keepdims=True) * n


def coordinate_system(v1):
    """Orthonormal frame from one vector (reference src/math.jl:93-100).
    Returns (v1, v2, v3)."""
    v1 = jnp.asarray(v1, jnp.float32)
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = jnp.abs(x) > jnp.abs(y)
    inv = 1.0 / jnp.sqrt(jnp.where(use_x, x * x + z * z, y * y + z * z))
    v2 = jnp.where(use_x[..., None],
                   jnp.stack([-z * inv, jnp.zeros_like(x), x * inv], -1),
                   jnp.stack([jnp.zeros_like(x), z * inv, -y * inv], -1))
    return v1, v2, jnp.cross(v1, v2)


def spherical_direction(sin_t, cos_t, phi, x=None, y=None, z=None):
    if x is None:
        return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], -1)
    return (x * (sin_t * jnp.cos(phi))[..., None]
            + y * (sin_t * jnp.sin(phi))[..., None] + z * cos_t[..., None])


def spherical_theta(v):
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0, p + 2.0 * PI, p)


def face_forward(n, v):
    """Flip n into the hemisphere of v (reference src/math.jl:123)."""
    return jnp.where(jnp.sum(n * v, -1, keepdims=True) < 0, -n, n)


def random_hemisphere_uniform(key, n, u, v):
    """Uniform-cosine(theta in [0,1]) hemisphere sample in frame (u, v, n)
    (reference src/math.jl:125-141, with an explicit PRNG key). ``key`` may
    have a leading batch via jax.random.split upstream; shapes broadcast."""
    xi = jax.random.uniform(key, n.shape[:-1] + (2,), jnp.float32)
    theta = jnp.arccos(xi[..., 0])
    phi = 2.0 * PI * xi[..., 1]
    xl = jnp.sin(theta) * jnp.cos(phi)
    yl = jnp.sin(theta) * jnp.sin(phi)
    zl = jnp.cos(theta)
    return u * xl[..., None] + v * yl[..., None] + n * zl[..., None]


def get_orthogonal_basis(normal):
    """(u, v) orthonormal and perpendicular to normal; picks the smallest
    |component| cardinal axis as seed (reference src/math.jl:143-156)."""
    normal = jnp.asarray(normal, jnp.float32)
    n = normal / jnp.linalg.norm(normal, axis=-1, keepdims=True)
    idx = jnp.argmin(jnp.abs(normal), axis=-1)
    cand = jax.nn.one_hot(idx, 3, dtype=jnp.float32)
    v = jnp.cross(n, cand)
    v = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    u = jnp.cross(v, n)
    u = u / jnp.linalg.norm(u, axis=-1, keepdims=True)
    return u, v


def random_triangle_point(key, vertices):
    """Uniform point on a triangle via sqrt-barycentric mapping
    (reference src/math.jl:158-174, explicit key). ``vertices``: (..., 3, 3)."""
    vertices = jnp.asarray(vertices, jnp.float32)
    r = jax.random.uniform(key, vertices.shape[:-2] + (2,), jnp.float32)
    sqrt_r1 = jnp.sqrt(r[..., 0])
    u = 1.0 - sqrt_r1
    v = sqrt_r1 * (1.0 - r[..., 1])
    w = sqrt_r1 * r[..., 1]
    bary = jnp.stack([u, v, w], -1)
    return sum_mul(bary, vertices)

"""Ray types.

JAX counterpart of the reference's ray layer (reference: src/ray.jl:1-70).
Rays are SoA pytrees: every field is an array whose leading dimensions are an
arbitrary batch shape, so a single `Ray` value can hold one ray or a whole
wavefront of millions. All float fields are float32.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

INF = jnp.inf


@struct.dataclass
class Ray:
    """A ray ``o + t*d`` active on ``t in [t_min, t_max]``.

    Mirrors the reference `Ray` (src/ray.jl:1-7): fields o, d, t_min, t_max,
    time, immutable with kwarg copy-construction (use ``.replace(...)``).
    """

    o: jnp.ndarray  # (..., 3) float32
    d: jnp.ndarray  # (..., 3) float32
    t_min: jnp.ndarray  # (...,) float32
    t_max: jnp.ndarray  # (...,) float32
    time: jnp.ndarray  # (...,) float32

    @classmethod
    def create(cls, o, d, t_min=0.0, t_max=INF, time=0.0) -> "Ray":
        o = jnp.asarray(o, jnp.float32)
        d = jnp.asarray(d, jnp.float32)
        batch = jnp.broadcast_shapes(o.shape[:-1], d.shape[:-1])
        o = jnp.broadcast_to(o, batch + (3,))
        d = jnp.broadcast_to(d, batch + (3,))
        as_scalar = lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.float32), batch)
        return cls(o=o, d=d, t_min=as_scalar(t_min), t_max=as_scalar(t_max),
                   time=as_scalar(time))

    @property
    def batch_shape(self):
        return self.o.shape[:-1]


@struct.dataclass
class RayDifferentials:
    """Ray plus screen-space differential rays (reference: src/ray.jl:14-25).

    ``has_differentials`` is a boolean array so it stays trace-friendly.
    """

    o: jnp.ndarray
    d: jnp.ndarray
    t_max: jnp.ndarray
    time: jnp.ndarray
    has_differentials: jnp.ndarray  # (...,) bool
    rx_origin: jnp.ndarray
    ry_origin: jnp.ndarray
    rx_direction: jnp.ndarray
    ry_direction: jnp.ndarray

    @classmethod
    def create(cls, o, d, t_max=INF, time=0.0, has_differentials=False,
               rx_origin=None, ry_origin=None, rx_direction=None,
               ry_direction=None) -> "RayDifferentials":
        o = jnp.asarray(o, jnp.float32)
        d = jnp.asarray(d, jnp.float32)
        batch = jnp.broadcast_shapes(o.shape[:-1], d.shape[:-1])
        o = jnp.broadcast_to(o, batch + (3,))
        d = jnp.broadcast_to(d, batch + (3,))
        z3 = jnp.zeros(batch + (3,), jnp.float32)
        pick = lambda x: z3 if x is None else jnp.broadcast_to(
            jnp.asarray(x, jnp.float32), batch + (3,))
        as_scalar = lambda x, dt: jnp.broadcast_to(jnp.asarray(x, dt), batch)
        return cls(o=o, d=d, t_max=as_scalar(t_max, jnp.float32),
                   time=as_scalar(time, jnp.float32),
                   has_differentials=as_scalar(has_differentials, jnp.bool_),
                   rx_origin=pick(rx_origin), ry_origin=pick(ry_origin),
                   rx_direction=pick(rx_direction), ry_direction=pick(ry_direction))

    @classmethod
    def from_ray(cls, r: Ray) -> "RayDifferentials":
        return cls.create(r.o, r.d, t_max=r.t_max, time=r.time)

    def as_ray(self) -> Ray:
        return Ray.create(self.o, self.d, t_max=self.t_max, time=self.time)


def set_direction(r, d):
    """Normalize -0.0 direction components to +0.0 (reference src/ray.jl:39-49;
    there `isapprox(x, 0f0)` with default tolerances only matches exact zero)."""
    d = jnp.asarray(d, jnp.float32)
    d = jnp.where(d == 0.0, 0.0, d)
    return r.replace(d=d)


def check_direction(r):
    return set_direction(r, r.d)


def apply(r, t):
    """Point at parameter t: o + d*t (reference src/ray.jl:51)."""
    t = jnp.asarray(t, jnp.float32)
    return r.o + r.d * t[..., None]


def increase_hit(r, t_hit):
    """Shrink t_max to a found hit (reference src/ray.jl:62-63)."""
    return r.replace(t_max=jnp.asarray(t_hit, jnp.float32))


def scale_differentials(rd: RayDifferentials, s):
    s = jnp.asarray(s, jnp.float32)[..., None]
    return rd.replace(
        rx_origin=rd.o + (rd.rx_origin - rd.o) * s,
        ry_origin=rd.o + (rd.ry_origin - rd.o) * s,
        rx_direction=rd.d + (rd.rx_direction - rd.d) * s,
        ry_direction=rd.d + (rd.ry_direction - rd.d) * s,
    )

"""Batched ray/hit transport records.

Counterpart of the reference's HW-RT transport structs (reference:
src/rt_transport.jl:10-42 — 32-byte `RTRay`/`RTHitResult` matching the
Vulkan layout, consumed by external hardware-RT backends). The flat
batched form is kept as the second consumer-facing query API of the AbstractAccel contract
(SURVEY.md §7): fixed-width SoA arrays that serialize to the same field
layout.
"""
from __future__ import annotations

import jax.numpy as jnp
from ..utils import struct

from ..core.ray import Ray
from .brute import HitResult


@struct.dataclass
class RTRay:
    """origin + t_min, direction + t_max (reference RTRay, 32 bytes/row)."""
    origin: jnp.ndarray   # (N, 3) float32
    t_min: jnp.ndarray    # (N,) float32
    direction: jnp.ndarray  # (N, 3) float32
    t_max: jnp.ndarray    # (N,) float32

    @classmethod
    def from_rays(cls, rays: Ray) -> "RTRay":
        flat = lambda a: a.reshape((-1,) + a.shape[len(rays.batch_shape):])
        return cls(origin=flat(rays.o), t_min=flat(rays.t_min),
                   direction=flat(rays.d), t_max=flat(rays.t_max))

    def to_rays(self) -> Ray:
        return Ray.create(o=self.origin, d=self.direction,
                          t_min=self.t_min, t_max=self.t_max)

    def pack(self) -> jnp.ndarray:
        """(N, 8) float32 rows in the reference's byte layout:
        [ox oy oz tmin dx dy dz tmax]."""
        return jnp.concatenate(
            [self.origin, self.t_min[:, None], self.direction,
             self.t_max[:, None]], axis=1)


@struct.dataclass
class RTHitResult:
    """hit flag, t, primitive id, instance custom index, barycentric u/v,
    instance id (reference RTHitResult, 32 bytes/row)."""
    hit: jnp.ndarray                    # (N,) bool
    t: jnp.ndarray                      # (N,) float32
    primitive_id: jnp.ndarray           # (N,) int32
    instance_custom_index: jnp.ndarray  # (N,) uint32 (resolved override)
    bary_u: jnp.ndarray                 # (N,) float32
    bary_v: jnp.ndarray                 # (N,) float32
    instance_id: jnp.ndarray            # (N,) int32 (0-based, -1 miss)

    @classmethod
    def from_hit_result(cls, res: HitResult, instances=None) -> "RTHitResult":
        flat = lambda a: a.reshape((-1,) + a.shape[res.hit.ndim:])
        hit = flat(res.hit)
        bary = flat(res.barycentric)
        inst = flat(res.instance_idx)
        # instance_id == 0 means inherit from triangle metadata (reference
        # InstanceDescriptor contract, src/instanced-bvh.jl:80-88).
        meta = flat(res.triangle.metadata).astype(jnp.uint32)
        if instances is not None:
            override = jnp.take(instances.instance_id,
                                jnp.clip(inst, 0, None), axis=0)
            custom = jnp.where(override != 0, override, meta)
        else:
            custom = meta
        return cls(hit=hit, t=flat(res.t),
                   primitive_id=flat(res.prim_idx),
                   instance_custom_index=jnp.where(hit, custom, 0),
                   bary_u=bary[:, 1], bary_v=bary[:, 2],
                   instance_id=inst)


def trace_closest_hits(scene, rt_rays: RTRay, **kw) -> RTHitResult:
    """Batch closest-hit query in transport form (the role of the external
    `Lava.trace_closest_hits!` consumer in the reference)."""
    from . import traversal as _trav
    res = _trav.closest_hit(scene, rt_rays.to_rays(), **kw)
    return RTHitResult.from_hit_result(res, scene.instances)


def trace_any_hits(scene, rt_rays: RTRay, **kw) -> RTHitResult:
    from . import traversal as _trav
    res = _trav.any_hit(scene, rt_rays.to_rays(), **kw)
    return RTHitResult.from_hit_result(res, scene.instances)

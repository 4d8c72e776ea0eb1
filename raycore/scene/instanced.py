"""Dense instanced scene — the fast path for dynamic instanced scenes.

The baked DenseScene (scene/bake.py) duplicates world-space geometry per
instance and must re-bake on every transform change; the wavefront TLAS
traversal handles dynamics but is gather-latency bound.
This container keeps per-BLAS clustered feature tables in LOCAL space —
built once per geometry — plus per-instance transforms and world AABBs
that refresh in one cheap jitted pass per frame. Queries run the
regroup-style sweep over (ray-subgroup, instance, cluster) triples
(ops/pallas_instanced.py), mirroring the reference's production hot path
of closest_hit over a mutable instanced TLAS
(reference src/instanced-bvh.jl:1902-2140) with dense sweeps.

Möller–Trumbore in instance-local space returns the same t as world
space (affine maps commute with the ray parameter), so hit keys compare
across instances directly.
"""
from __future__ import annotations

import weakref as _weakref

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

# refresh_instances: baked instance->BLAS assignment, host copy per scene.
_BAKED_BLAS_CACHE: dict = {}

from ..accel.dense import FEAT, build_dense
from ..core.transforms import mat3x4_inverse, _apply_mat3
from ..core.triangle import Triangle


@struct.dataclass
class DenseInstancedScene:
    # Concatenated per-BLAS cluster tables, LOCAL space, cluster-major.
    tri_feats: jnp.ndarray     # (K_total, FEAT, 4*C)
    cluster_min: jnp.ndarray   # (K_total, 3) local AABBs
    cluster_max: jnp.ndarray   # (K_total, 3)
    prims: Triangle            # concatenated per-BLAS local prims,
                               # ORIGINAL (unsorted, unpadded) order
    prims_hot: jnp.ndarray     # (K_total*C, 11) int32 sorted hot rows
                               # (vertex f32 bits + metadata + index, see
                               # DenseScene.prims_hot); col 10 holds the
                               # GLOBAL original index into ``prims``
                               # (per-BLAS bases applied)
    # Per instance (refreshed by refresh_instances, no geometry rebuild).
    inst_inv: jnp.ndarray      # (I, 3, 4) world -> local
    inst_blas: jnp.ndarray     # (I,) int32 blas slot (dense, deduped)
    inst_cbase: jnp.ndarray    # (I,) int32 first cluster row of the blas
    inst_ncl: jnp.ndarray      # (I,) int32 cluster count of the blas
    inst_aabb_min: jnp.ndarray  # (I, 3) world AABBs
    inst_aabb_max: jnp.ndarray  # (I, 3)
    inst_local_min: jnp.ndarray  # (I, 3) local root AABB of the blas
    inst_local_max: jnp.ndarray  # (I, 3)
    root_aabb: jnp.ndarray     # (2, 3) world
    n_instances: int = struct.field(pytree_node=False)
    cluster_size: int = struct.field(pytree_node=False)
    max_clusters_per_blas: int = struct.field(pytree_node=False)
    payload_mask: int = struct.field(pytree_node=False, default=0b111)

    @property
    def n_clusters(self) -> int:
        return self.tri_feats.shape[0]


@jax.jit
def _world_aabbs(inv_unused, transforms, local_min, local_max):
    """Per-instance world AABB: transform the 8 corners of the local
    root AABB (reference compute_instance_aabbs_kernel!,
    src/instanced-bvh-kernels.jl:65-78)."""
    corners = jnp.stack([
        jnp.where(jnp.asarray([(i >> a) & 1 for a in range(3)], bool),
                  local_max, local_min)
        for i in range(8)], axis=1)                       # (I, 8, 3)
    R = transforms[:, :, :3]                              # (I, 3, 3)
    t = transforms[:, :, 3]                               # (I, 3)
    # Exact fp32 (not einsum — a DEFAULT-precision matmul may round
    # the corners, and a rounded-SMALLER world AABB drops true hits).
    wc = _apply_mat3(R[:, None], corners) + t[:, None, :]
    return jnp.min(wc, axis=1), jnp.max(wc, axis=1)


def _gather_instance_arrays(mgr):
    slots = sorted({rec.blas_slot for rec in mgr._instances})
    slot_to_dense = {s: i for i, s in enumerate(slots)}
    transforms = np.stack([rec.transform for rec in mgr._instances]) \
        .astype(np.float32)
    blas_idx = np.asarray([slot_to_dense[rec.blas_slot]
                           for rec in mgr._instances], np.int32)
    return slots, transforms, blas_idx


def bake_instanced(mgr, cluster_size: int = 128,
                   layout: str = "morton") -> DenseInstancedScene:
    """Build a DenseInstancedScene from a mutable TLAS manager. Per-BLAS
    cluster tables are built once (local space); instances carry only
    transforms + world AABBs. For pure transform dynamics, use
    refresh_instances(scene, mgr) per frame instead of re-baking."""
    assert mgr._instances, "empty scene"
    slots, transforms, blas_idx = _gather_instance_arrays(mgr)

    per = []
    for s in slots:
        blas = mgr._blas[s]
        n = blas.n_prims
        tris = jax.tree_util.tree_map(lambda a: a[:n], blas.prims)
        per.append(build_dense(tris, cluster_size=cluster_size,
                               layout=layout))
    cbase_by_dense = np.cumsum([0] + [d.n_clusters for d in per])[:-1] \
        .astype(np.int32)
    ncl_by_dense = np.asarray([d.n_clusters for d in per], np.int32)
    local_min = jnp.stack([d.root_aabb[0] for d in per])
    local_max = jnp.stack([d.root_aabb[1] for d in per])

    cat = lambda f: jnp.concatenate([f(d) for d in per], axis=0)
    tri_feats = cat(lambda d: d.tri_feats)
    prims = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *[d.prims for d in per])
    # Rebase each BLAS's hot original-index column (local, possibly
    # pointing at padding) to the global row in the concatenated prims.
    prim_base = np.cumsum(
        [0] + [d.prims.vertices.shape[0] for d in per])[:-1]
    hot_parts = []
    for base, d in zip(prim_base, per):
        n_local = d.prims.vertices.shape[0]
        h = d.prims_hot
        orig_l = jnp.clip(h[:, 10], 0, n_local - 1)
        hot_parts.append(h.at[:, 10].set(orig_l + jnp.int32(base)))
    prims_hot = jnp.concatenate(hot_parts, axis=0)

    tj = jnp.asarray(transforms)
    inv = mat3x4_inverse(tj)
    bi = jnp.asarray(blas_idx)
    lmin = local_min[blas_idx]
    lmax = local_max[blas_idx]
    wmin, wmax = _world_aabbs(None, tj, lmin, lmax)
    root = jnp.stack([jnp.min(wmin, 0), jnp.max(wmax, 0)])
    pm = 0
    for d in per:
        pm |= d.payload_mask & 0b111
    # Bit 8 (flat-shaded: finalize recomputes face normals instead of
    # gathering) is only sound scene-wide if EVERY member mesh is
    # flat-shaded — a smooth-normal or zero-normal member must keep the
    # gather path, else its hits would fabricate face normals.
    if all((d.payload_mask & 0b1001) == 0b1001 for d in per) and per:
        pm |= 8
    return DenseInstancedScene(
        tri_feats=tri_feats,
        cluster_min=cat(lambda d: d.cluster_min),
        cluster_max=cat(lambda d: d.cluster_max),
        prims=prims, prims_hot=prims_hot,
        inst_inv=inv, inst_blas=bi,
        inst_cbase=jnp.take(jnp.asarray(cbase_by_dense), bi),
        inst_ncl=jnp.take(jnp.asarray(ncl_by_dense), bi),
        inst_aabb_min=wmin, inst_aabb_max=wmax,
        inst_local_min=lmin, inst_local_max=lmax, root_aabb=root,
        n_instances=len(mgr._instances), cluster_size=cluster_size,
        max_clusters_per_blas=int(ncl_by_dense.max()),
        payload_mask=pm)


@jax.jit
def _refresh_jit(scene: DenseInstancedScene, transforms):
    inv = mat3x4_inverse(transforms)
    wmin, wmax = _world_aabbs(None, transforms, scene.inst_local_min,
                              scene.inst_local_max)
    root = jnp.stack([jnp.min(wmin, 0), jnp.max(wmax, 0)])
    return scene.replace(inst_inv=inv, inst_aabb_min=wmin,
                         inst_aabb_max=wmax, root_aabb=root)


def refresh_instances(scene: DenseInstancedScene,
                      mgr) -> DenseInstancedScene:
    """Per-frame transform refresh: recompute inverse transforms and
    world AABBs only — geometry tables untouched, shapes stable (no
    recompile across frames). The instance SET must be unchanged since
    bake_instanced (push/delete require a re-bake). Analogue of the
    reference refit path (sync! with only transforms_dirty,
    src/instanced-bvh.jl:2197-2222)."""
    _, transforms, blas_idx = _gather_instance_arrays(mgr)
    if transforms.shape[0] != scene.n_instances:
        raise ValueError(
            "instance set changed; re-bake with bake_instanced")
    # A delete+push cycle can preserve the COUNT while changing which
    # BLAS each slot references (or the dedup slot order) — the baked
    # inst_blas / cluster tables would then silently trace the wrong
    # geometry (ADVICE r2). Cheap host-side equality catches it; the
    # baked assignment is read back once per scene, not per frame
    # (weakref-validated: ids recycle after GC).
    key = id(scene.inst_blas)
    ent = _BAKED_BLAS_CACHE.get(key)
    if ent is None or ent[0]() is not scene.inst_blas:
        baked = np.asarray(scene.inst_blas)
        while len(_BAKED_BLAS_CACHE) >= 64:
            _BAKED_BLAS_CACHE.pop(next(iter(_BAKED_BLAS_CACHE)))
        _BAKED_BLAS_CACHE[key] = (_weakref.ref(scene.inst_blas), baked)
    else:
        baked = ent[1]
    if not np.array_equal(np.asarray(blas_idx), baked):
        raise ValueError(
            "instance->BLAS assignment changed since bake_instanced "
            "(delete+push cycle?); re-bake with bake_instanced")
    return _refresh_jit(scene, jnp.asarray(transforms))

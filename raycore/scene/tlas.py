"""Mutable TLAS scene manager.

JAX counterpart of the reference's mutable `TLAS{Backend}` container
(reference: src/instanced-bvh.jl:174-1065): handle-based push/delete/update
mutation on the host, with `sync()` as the single commit boundary that owns
the frozen `StaticTLAS` (the reference's `sync!`/`static_tlas` ownership
contract, src/instanced-bvh.jl:860-921).

Host side: Python dicts/lists of handles, transforms, and BLAS slots, plus
dirty flags. Device side: frozen SoA pytrees. `sync()` chooses between
 - structure rebuild (instances added/removed, geometry swapped): re-concat
   flat BLAS arrays + rebuild TLAS topology (reference rebuild_bvh!), and
 - transform refit (only transforms_dirty): rebuild only the TLAS node
   matrix over the cached flat arrays (reference refit_tlas!).

Shape discipline: instance capacity is padded to powers of two and BLAS
prim counts to power-of-two buckets, so repeated sync() calls at similar
scene sizes reuse compiled executables (the jit analogue of the reference's
"refit keeps static_tlas identity" contract).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.transforms import mat3x4_inverse
from ..core.triangle import Triangle
from ..accel.lbvh import build_blas
from ..accel.tlas_build import build_tlas_nodes
from ..accel.types import (BLAS, Instances, StaticTLAS, next_pow2,
                           pad_triangles)

INVALID_HANDLE = -1


@dataclasses.dataclass(frozen=True)
class TLASHandle:
    """Opaque handle for a pushed geometry+instances group (reference
    TLASHandle). One handle may own several instances (multi-transform
    push, reference src/instanced-bvh.jl:661-676)."""
    id: int


@dataclasses.dataclass
class _InstanceRec:
    handle_id: int
    blas_slot: int
    transform: np.ndarray     # (3, 4) float32 row-major
    instance_id: int          # 0 = inherit from triangle metadata
    sbt_offset: int = 0       # shader-binding-table offset (carried for
                              # parity with the reference/Vulkan layout)


@partial(jax.jit, static_argnames=("icap",))
def _assemble_instances(transforms, blas_index, instance_ids, mask, icap):
    inv = mat3x4_inverse(transforms)
    return Instances(transform=transforms, inv_transform=inv,
                     blas_index=blas_index, instance_id=instance_ids,
                     mask=mask)


@jax.jit
def _tlas_nodes_jit(instances: Instances, blas_root_aabb):
    return build_tlas_nodes(instances, blas_root_aabb)


class TLAS:
    """GPU-first mutable scene container, host-orchestrated.

    Usage mirrors the reference:
        tlas = TLAS()
        h = tlas.push(mesh_triangles, transform)     # build BLAS + instance
        tlas.update_transform(h, new_transform)
        tlas.delete(h)
        scene = tlas.sync()                          # frozen StaticTLAS
    """

    def __init__(self):
        self._blas: List[Optional[BLAS]] = []
        self._blas_refcount: List[int] = []
        self._instances: List[_InstanceRec] = []
        self._handles: Dict[int, List[int]] = {}   # handle id -> instance idxs
        self._deleted_handles: set[int] = set()
        self._next_handle = 1
        self._dirty = True
        self._transforms_dirty = False
        self._static: Optional[StaticTLAS] = None
        self._flat_cache = None                    # (prims, blas_nodes, ...)
        self.revision = 0

    # -- queries -----------------------------------------------------------
    @property
    def n_instances(self) -> int:
        """Live instances, excluding pending deletes (reference
        n_instances, src/instanced-bvh.jl:2390-2398)."""
        return len(self._instances)

    @property
    def n_total_instances(self) -> int:
        return len(self._instances)

    @property
    def n_geometries(self) -> int:
        return sum(1 for b in self._blas if b is not None)

    def is_valid(self, handle: TLASHandle) -> bool:
        return handle.id in self._handles

    @property
    def static_tlas(self) -> StaticTLAS:
        if self._static is None or self._dirty or self._transforms_dirty:
            self.sync()
        return self._static

    def world_bound(self):
        return np.asarray(self.static_tlas.root_aabb)

    # -- mutation ----------------------------------------------------------
    def _as_mat3x4(self, transform) -> np.ndarray:
        t = np.asarray(transform, np.float32) if transform is not None \
            else np.eye(3, 4, dtype=np.float32)
        if t.shape == (4, 4):
            t = t[:3, :4]
        assert t.shape == (3, 4), f"transform must be 3x4 or 4x4, got {t.shape}"
        return t.astype(np.float32)

    def _add_blas(self, tris: Triangle) -> int:
        blas = build_blas(tris)
        for slot, b in enumerate(self._blas):
            if b is None:
                self._blas[slot] = blas
                self._blas_refcount[slot] = 0
                return slot
        self._blas.append(blas)
        self._blas_refcount.append(0)
        return len(self._blas) - 1

    def push(self, tris: Triangle, transform=None, *, instance_id: int = 0,
             sbt_offset: int = 0,
             transforms: Optional[Sequence] = None,
             instance_ids: Optional[Sequence[int]] = None) -> TLASHandle:
        """Add geometry with one transform, or many transforms sharing a
        single BLAS build (reference push!, src/instanced-bvh.jl:551-676;
        multi-transform variant :661-676 with optional per-instance ids)."""
        slot = self._add_blas(tris)
        hid = self._next_handle
        self._next_handle += 1
        idxs = []
        mats = ([self._as_mat3x4(transform)] if transforms is None
                else [self._as_mat3x4(t) for t in transforms])
        ids = ([int(instance_id)] * len(mats) if instance_ids is None
               else [int(i) for i in instance_ids])
        assert len(ids) == len(mats)
        for m, iid in zip(mats, ids):
            idxs.append(len(self._instances))
            self._instances.append(
                _InstanceRec(hid, slot, m, iid, int(sbt_offset)))
            self._blas_refcount[slot] += 1
        self._handles[hid] = idxs
        self._dirty = True
        return TLASHandle(hid)

    def _require(self, handle: TLASHandle) -> List[int]:
        if handle.id not in self._handles:
            raise KeyError(f"invalid or deleted handle {handle.id}")
        return self._handles[handle.id]

    def delete(self, handle: TLASHandle) -> None:
        """Mark for removal; compaction happens at sync (reference delete!,
        src/instanced-bvh.jl:690-699)."""
        idxs = set(self._require(handle))
        for i in sorted(idxs):
            slot = self._instances[i].blas_slot
            self._blas_refcount[slot] -= 1
            if self._blas_refcount[slot] == 0:
                self._blas[slot] = None
        keep = [r for i, r in enumerate(self._instances) if i not in idxs]
        # Reindex handle->instance maps after compaction.
        remap = {}
        j = 0
        for i in range(len(self._instances)):
            if i not in idxs:
                remap[i] = j
                j += 1
        self._instances = keep
        del self._handles[handle.id]
        self._handles = {h: [remap[i] for i in ii]
                         for h, ii in self._handles.items()}
        self._deleted_handles.add(handle.id)
        self._dirty = True

    def update_transform(self, handle: TLASHandle, transform) -> None:
        """In-place transform update; next sync refits (reference
        update_transform!, src/instanced-bvh.jl:755-779)."""
        for i in self._require(handle):
            self._instances[i].transform = self._as_mat3x4(transform)
        self._transforms_dirty = True

    def update_transforms(self, handle: TLASHandle, transforms) -> None:
        idxs = self._require(handle)
        transforms = list(transforms)
        assert len(transforms) == len(idxs)
        for i, t in zip(idxs, transforms):
            self._instances[i].transform = self._as_mat3x4(t)
        self._transforms_dirty = True

    def update(self, handle: TLASHandle, tris: Triangle) -> None:
        """Swap the geometry behind a handle in place (reference update!,
        src/instanced-bvh.jl:808-857)."""
        idxs = self._require(handle)
        old_slot = self._instances[idxs[0]].blas_slot
        new_blas = build_blas(tris)
        # If the old BLAS is exclusively ours, replace the slot; otherwise
        # allocate a new slot (other handles keep the old geometry).
        if self._blas_refcount[old_slot] == len(idxs):
            self._blas[old_slot] = new_blas
        else:
            self._blas_refcount[old_slot] -= len(idxs)
            slot = self._add_blas(tris)
            self._blas[slot] = new_blas
            for i in idxs:
                self._instances[i].blas_slot = slot
            self._blas_refcount[slot] += len(idxs)
        self._dirty = True

    def instance_buffer(self, handle: TLASHandle) -> np.ndarray:
        """Writable (n, 3, 4) float32 transform buffer for a multi-instance
        batch (reference instance_buffer, src/Raycore.jl:118-130: hand out
        the raw instance buffer so callers can mutate transforms in place,
        then commit with refit_tlas!). Array-parallel shape: device arrays are
        immutable, so the mutable surface is the HOST staging buffer — the
        returned ndarray's rows ARE the batch's transform storage (each
        instance record aliases a row view). Write into it, then call
        :func:`refit_tlas` (or ``sync``) to upload + refit.

        Errors loudly for single-instance handles, matching the reference
        ("refers to a per-mesh push! instance, which has no instance
        buffer")."""
        idxs = self._require(handle)
        if len(idxs) < 2:
            raise ValueError(
                f"handle {handle.id} is a single-instance push, not an "
                "instance batch; use update_transform instead")
        buf = np.stack([self._instances[i].transform for i in idxs]) \
                .astype(np.float32)
        for k, i in enumerate(idxs):
            self._instances[i].transform = buf[k]   # row views alias buf
        # Caller writes are invisible to us until commit; be conservative.
        self._transforms_dirty = True
        return buf

    def refit_tlas(self) -> "StaticTLAS":
        """Commit in-place transform edits (e.g. through
        :meth:`instance_buffer`) and refit the TLAS (reference refit_tlas!,
        src/instanced-bvh.jl:880-915). Equivalent to marking transforms
        dirty and calling :meth:`sync`."""
        self._transforms_dirty = True
        return self.sync()

    def get_instance(self, handle: TLASHandle):
        recs = [self._instances[i] for i in self._require(handle)]
        return recs[0] if len(recs) == 1 else recs

    def get_instances(self, handle: TLASHandle):
        return [self._instances[i] for i in self._require(handle)]

    # -- commit boundary -----------------------------------------------------
    def _live_blas_slots(self) -> List[int]:
        return [s for s, b in enumerate(self._blas) if b is not None]

    def _rebuild_flat(self):
        """Concat per-BLAS node/prim arrays into flat device buffers
        (reference build_flat_blas_arrays!, src/instanced-bvh.jl:470)."""
        slots = self._live_blas_slots()
        if not slots:
            raise ValueError("sync() on an empty TLAS")
        slot_to_dense = {s: k for k, s in enumerate(slots)}
        blas = [self._blas[s] for s in slots]
        nodes = jnp.concatenate([b.nodes for b in blas], axis=0)
        prims = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *[b.prims for b in blas])
        node_counts = np.array([b.n_nodes for b in blas])
        prim_counts = np.array([b.capacity for b in blas])
        node_off = np.concatenate([[0], np.cumsum(node_counts)[:-1]])
        prim_off = np.concatenate([[0], np.cumsum(prim_counts)[:-1]])
        roots = jnp.stack([b.root_aabb for b in blas])
        return slot_to_dense, nodes, prims, node_off, prim_off, roots

    def _instance_arrays(self, slot_to_dense, icap):
        n = len(self._instances)
        tf = np.zeros((icap, 3, 4), np.float32)
        tf[:, :, :3] = np.eye(3)  # padding gets identity rotation
        bi = np.zeros((icap,), np.int32)
        iid = np.zeros((icap,), np.uint32)
        mask = np.zeros((icap,), bool)
        for i, rec in enumerate(self._instances):
            tf[i] = rec.transform
            bi[i] = slot_to_dense[rec.blas_slot]
            iid[i] = rec.instance_id
            mask[i] = True
        return (jnp.asarray(tf), jnp.asarray(bi), jnp.asarray(iid),
                jnp.asarray(mask), n)

    def sync(self) -> StaticTLAS:
        """Commit all pending mutations and return the frozen scene.

        Clean path is a no-op returning the cached StaticTLAS (reference
        sync!, src/instanced-bvh.jl:894-921)."""
        if self._static is not None and not self._dirty \
                and not self._transforms_dirty:
            return self._static

        if self._dirty or self._flat_cache is None:
            self._flat_cache = self._rebuild_flat()
        slot_to_dense, flat_nodes, flat_prims, node_off, prim_off, roots = \
            self._flat_cache

        n = len(self._instances)
        if n == 0:
            raise ValueError("sync() with zero instances")
        icap = next_pow2(n)
        tf, bi, iid, mask, _ = self._instance_arrays(slot_to_dense, icap)
        instances = _assemble_instances(tf, bi, iid, mask, icap)

        tlas_nodes, root_aabb = _tlas_nodes_jit(instances, roots)

        n_tlas_nodes = 2 * icap - 1
        unified = jnp.concatenate([tlas_nodes, flat_nodes], axis=0)
        self._static = StaticTLAS(
            unified_nodes=unified,
            instances=instances,
            prims=flat_prims,
            blas_nodes_offset=jnp.asarray(node_off + n_tlas_nodes, jnp.int32),
            blas_prims_offset=jnp.asarray(prim_off, jnp.int32),
            blas_root_aabb=roots,
            root_aabb=root_aabb,
            n_instances=n,
            instance_capacity=icap,
            n_blas=roots.shape[0],
        )
        self._dirty = False
        self._transforms_dirty = False
        self.revision += 1
        return self._static

    def free(self) -> None:
        """Drop all device references (reference free!/finalizer,
        src/instanced-bvh.jl:334-399 — under XLA the allocator reclaims
        once the pytrees are unreferenced)."""
        self._blas = []
        self._blas_refcount = []
        self._instances = []
        self._handles = {}
        self._static = None
        self._flat_cache = None
        self._dirty = True

    # -- convenience constructors -------------------------------------------
    @classmethod
    def from_primitives(cls, meshes: Sequence[Triangle], metadata_fn=None,
                        transforms=None):
        """One BLAS per mesh with a user metadata callback
        ``(mesh_idx, tri_idx) -> uint32`` (reference
        TLAS(primitives, metadata_fn), src/instanced-bvh.jl:2276-2324)."""
        import jax.numpy as jnp
        t = cls()
        transforms = transforms or [None] * len(meshes)
        handles = []
        for mi, (m, tr) in enumerate(zip(meshes, transforms)):
            if metadata_fn is not None:
                n = m.vertices.shape[0]
                meta = np.asarray([metadata_fn(mi, ti) for ti in range(n)],
                                  np.uint32)
                m = m.replace(metadata=jnp.asarray(meta))
            handles.append(t.push(m, tr))
        return t, handles

    @classmethod
    def from_meshes(cls, meshes: Sequence[Triangle], transforms=None):
        """Build a TLAS with one BLAS+instance per mesh; returns
        (tlas, handles) (reference TLAS(meshes), src/instanced-bvh.jl:2361-2378)."""
        t = cls()
        transforms = transforms or [None] * len(meshes)
        handles = [t.push(m, tr) for m, tr in zip(meshes, transforms)]
        return t, handles


def blas_to_static_tlas(blas: BLAS) -> StaticTLAS:
    """Wrap a single BLAS in a trivial one-instance StaticTLAS (identity
    transform) — the unit used by BLAS-level parity tests."""
    t = TLAS()
    t._blas = [blas]
    t._blas_refcount = [1]
    t._instances = [_InstanceRec(0, 0, np.eye(3, 4, dtype=np.float32), 0)]
    t._handles = {0: [0]}
    return t.sync()


def instance_buffer(tlas: TLAS, handle: TLASHandle) -> np.ndarray:
    """Functional spelling of :meth:`TLAS.instance_buffer` (the reference
    exports `instance_buffer(tlas, handle)`, src/Raycore.jl:118-130)."""
    return tlas.instance_buffer(handle)


def refit_tlas(tlas: TLAS) -> StaticTLAS:
    """Functional spelling of :meth:`TLAS.refit_tlas` (reference
    refit_tlas!, src/instanced-bvh.jl:880-915)."""
    return tlas.refit_tlas()

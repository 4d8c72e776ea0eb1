"""Dense clustered intersection engine — the XLA rounds path.

Pointer-chasing BVH traversal is bound by dependent gathers; this module
trades them for dense arithmetic: NO per-node gathers at all.

Scheme (single geometry, world space):
  Build: triangles are Morton-sorted (the LBVH build already does this);
  clusters = contiguous chunks of C sorted triangles, so cluster AABBs and
  per-cluster triangle tables are dense reshapes. Triangles are
  *featurized*: every Möller–Trumbore quantity is a bilinear form
      det   = d · (e2 x e1) = -d · n    n  = e1 x e2
      u*det = (o x d) · e2  - d · (e2 x v0)
      v*det = -(o x d) · e1 - d · (v0 x e1)
      t*det = o · n - v0 · n
  so with ray features phi = [d, o x d, o, 1, 0...] (16) and a (16, 4C)
  per-cluster triangle matrix, all four quantities for a whole ray-tile x
  cluster block are ONE fp32 matmul.

  Query: rays are processed in coherent tiles.
  Phase A: per-tile interval arithmetic (conservative ray-bundle vs AABB)
  produces an (n_tiles, K) entry-lower-bound matrix for a few dozen ops
  per pair — no per-ray sweep at all.
  Phase B rounds: each round selects the S untested clusters with the
  smallest entry per tile, fetches their feature blocks, runs the fused
  matmul + epilogue over tile groups, and updates per-ray bests. Rounds
  repeat until no untested cluster could beat any ray's best
  (conservative per-tile bound => exact closest-hit results).
  The worklist sweep (ops/pallas_dense.py) is the faster
  production variant of phase B.

Möller–Trumbore semantics match `fast_intersect_triangle` exactly
(reciprocal-of-det with inf/NaN rejection on degenerate dets).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.ray import Ray
from ..core.triangle import Triangle
from ..core.triangle import INV_DIR_CLAMP as _INV_DIR_CLAMP
from .brute import HitResult

FEAT = 16


@struct.dataclass
class DenseScene:
    """Clustered, featurized triangle soup (world space).

    ``tri_feats`` columns are laid out sub-chunk-major: for each of the
    SUB sub-chunks of CS = C/SUB consecutive Morton triangles, the four
    quantity blocks [det | u*det | v*det | t*det] x CS are contiguous —
    so a kernel can skip a whole sub-chunk's matmul when its AABB
    (``sub_bounds``) provably misses every ray in the tile."""
    tri_feats: jnp.ndarray     # (K, FEAT, 4*C) float32, sub-chunk-major
    cluster_min: jnp.ndarray   # (K, 3)
    cluster_max: jnp.ndarray   # (K, 3)
    sub_bounds: jnp.ndarray    # (K, 1, 128) f32; cols [s*6:(s+1)*6] hold
                               # sub-chunk s's [min xyz, max xyz]
    prims: Triangle            # ORIGINAL caller order (usually unpadded):
                               # cold payload fields (normals/tangents/uv)
                               # are never permuted at build — the sorted
                               # hot rows carry the original index instead
                               # (a full-SoA permute is a ~100 ms
                               # row-latency-bound gather at 1M tris)
    prims_hot: jnp.ndarray     # (K*C, 11) INT32, SORTED cluster-major:
                               # [vertex-f32-bits(9), metadata, orig index]
                               # — everything the exact-MT recompute and
                               # the payload/identity lookups need in one
                               # narrow gather; cold fields come from
                               # ``prims[orig]``, gated by payload_mask.
                               # int32 end-to-end like the node matrices:
                               # small ints bitcast INTO f32 are denormals
                               # and f32 ops may flush denormals to zero
                               # (every hit would report prim 0); float
                               # bits riding in int32 are safe in
                               # gathers/selects.
    root_aabb: jnp.ndarray     # (2, 3)
    n_prims: int = struct.field(pytree_node=False)
    cluster_size: int = struct.field(pytree_node=False)
    sub_chunks: int = struct.field(pytree_node=False, default=4)
    payload_mask: int = struct.field(pytree_node=False, default=0b111)
    # payload_mask bits: 1 = normals nonzero, 2 = tangents nonzero,
    # 4 = uv nonzero. Zero fields skip their gather and broadcast zeros.
    instance_of_prim: jnp.ndarray | None = None
    # int32 instance slot per ORIGINAL-order triangle, set by baked
    # instanced scenes (scene/bake.py); None for single-geometry builds,
    # where hits report instance 0. Indexed by the hot row's original
    # index. Mirrors the reference's instance_idx traversal output
    # (src/instanced-bvh.jl:2010-2023).

    @property
    def n_clusters(self) -> int:
        return self.tri_feats.shape[0]


def pack_prims_hot(tris: Triangle, orig_idx=None) -> jnp.ndarray:
    """(T, 11) int32 hot rows [vertex-f32-bits(9), metadata, orig index]
    — everything the exact-MT recompute and identity lookups need in one
    narrow gather. ``orig_idx`` defaults to row order (identity), for
    callers whose ``prims`` are already in table order."""
    T = tris.vertices.shape[0]
    from .types import f32_as_i32
    if orig_idx is None:
        orig_idx = jnp.arange(T, dtype=jnp.int32)
    return jnp.concatenate([
        f32_as_i32(tris.vertices.reshape(T, 9)),
        tris.metadata.astype(jnp.int32)[:, None],
        orig_idx.astype(jnp.int32)[:, None]], axis=1)


def gather_hit_payload(scene: "DenseScene", idx, hit):
    """(Triangle, original_index) for winning rows: one narrow hot gather
    plus per-field cold gathers gated by the scene's payload_mask
    (all-zero fields skip their gather entirely — gather cost scales with
    gathered columns). ``idx`` is in sorted (table) space; cold
    fields live in original order and are fetched via the hot row's
    original-index column. Misses return original index -1."""
    from .types import i32_as_f32
    R = idx.shape[0]
    rows = jnp.take(scene.prims_hot, idx, axis=0)          # (R, 11) int32
    rows = jnp.where(hit[:, None], rows, 0)    # int select: no FTZ hazard
    meta = jnp.where(hit, rows[:, 9], 0).astype(jnp.uint32)
    n_cold = scene.prims.vertices.shape[0]
    orig = jnp.where(hit, rows[:, 10], -1)
    cidx = jnp.clip(orig, 0, n_cold - 1)

    def cold(field, ncols, bit):
        if scene.payload_mask & bit:
            g = jnp.take(field.reshape(-1, ncols), cidx, axis=0)
            return jnp.where(hit[:, None], g, 0.0)
        return jnp.zeros((R, ncols), jnp.float32)

    verts = i32_as_f32(rows[:, 0:9]).reshape(R, 3, 3)
    if scene.payload_mask & 8:
        # Flat-shaded mesh (probe-verified): recompute the face normal
        # from the hot vertices instead of a second payload gather.
        fn = _face_normals(verts)
        fn = jnp.where(hit[:, None], fn, 0.0)
        normals = jnp.broadcast_to(fn[:, None, :], (R, 3, 3))
    else:
        normals = cold(scene.prims.normals, 9, 1).reshape(R, 3, 3)

    tri = Triangle(
        vertices=verts,
        normals=normals,
        tangents=cold(scene.prims.tangents, 9, 2).reshape(R, 3, 3),
        uv=cold(scene.prims.uv, 6, 4).reshape(R, 3, 2),
        metadata=meta)
    return tri, orig


def gather_hit_triangles(scene: "DenseScene", idx, hit) -> Triangle:
    """Winning-triangle payload only (see gather_hit_payload)."""
    return gather_hit_payload(scene, idx, hit)[0]


def _featurize_tris(v0, v1, v2):
    """(T, FEAT, 4) per-triangle feature matrix; quantities columns are
    [det, u*det, v*det, t*det]."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = jnp.cross(e1, e2)
    T = v0.shape[0]
    psi = jnp.zeros((T, FEAT, 4), jnp.float32)
    # det = (d x e2) . e1 = d . (e2 x e1) = -d . n
    psi = psi.at[:, 0:3, 0].set(-n)
    # u*det = d . (-(e2 x v0)) + (o x d) . e2
    psi = psi.at[:, 0:3, 1].set(-jnp.cross(e2, v0))
    psi = psi.at[:, 3:6, 1].set(e2)
    # v*det = d . (-(v0 x e1)) + (o x d) . (-e1)
    psi = psi.at[:, 0:3, 2].set(-jnp.cross(v0, e1))
    psi = psi.at[:, 3:6, 2].set(-e1)
    # t*det = o . n + 1 * (-v0 . n)
    psi = psi.at[:, 6:9, 3].set(n)
    psi = psi.at[:, 9, 3].set(-jnp.sum(v0 * n, axis=-1))
    return psi


def ray_features(o, d):
    """(R, FEAT) ray feature rows: [d, o x d, o, 1, invd, pad].

    Columns 10:13 carry safe_invdir(d) for in-kernel slab tests; the
    triangle feature rows there are zero so the matmul is unaffected."""
    R = o.shape[0]
    phi = jnp.zeros((R, FEAT), jnp.float32)
    phi = phi.at[:, 0:3].set(d)
    phi = phi.at[:, 3:6].set(jnp.cross(o, d))
    phi = phi.at[:, 6:9].set(o)
    phi = phi.at[:, 9].set(1.0)
    from ..core.triangle import safe_invdir
    phi = phi.at[:, 10:13].set(safe_invdir(d))
    return phi


def _dense_tables_from_hot(hot, cluster_size: int, sub_chunks: int):
    """Feature blocks + bounds from SORTED int32 hot rows."""
    from .types import i32_as_f32
    T = hot.shape[0]
    C = cluster_size
    SUB = sub_chunks
    CS = C // SUB
    K = T // C
    v = i32_as_f32(hot[:, :9]).reshape(T, 3, 3)
    psi = _featurize_tris(v[:, 0], v[:, 1], v[:, 2])          # (T, 16, 4)
    # Sub-chunk-major blocks: per sub s, columns
    # [det x CS | udet x CS | vdet x CS | tdet x CS] contiguous.
    blocks = psi.reshape(K, SUB, CS, FEAT, 4) \
        .transpose(0, 3, 1, 4, 2).reshape(K, FEAT, 4 * C)
    vk = v.reshape(K, SUB, CS, 3, 3)
    smin = jnp.min(vk, axis=(2, 3))                # (K, SUB, 3)
    smax = jnp.max(vk, axis=(2, 3))
    sb = jnp.concatenate([smin, smax], axis=2).reshape(K, SUB * 6)
    # (K, 1, 128) padded layout: per-cluster sub-chunk bounds, SUB * 6
    # floats used.
    sub_bounds = jnp.zeros((K, 1, 128), jnp.float32) \
        .at[:, 0, : SUB * 6].set(sb)
    cmin = jnp.min(smin, axis=1)
    cmax = jnp.max(smax, axis=1)
    # Root AABB over REAL triangles only: capacity padding lives at
    # PAD_COORD (1e30) and sorts into the tail clusters, so an unmasked
    # reduce reported root max = 1e30 — corrupting world_bound, the
    # prewarm ray grids (rays from z=1e30 hit nothing, so prewarmed
    # capacity hints were sized on a miss-all workload), and the scene
    # content fingerprint. Cluster/sub-chunk bounds keep the sentinel
    # spans (phase A's finite-arithmetic contract).
    from .types import PAD_COORD
    tvalid = jnp.all(jnp.abs(v) < PAD_COORD * 0.5, axis=(1, 2))   # (T,)
    vmin = jnp.where(tvalid[:, None], jnp.min(v, axis=1), jnp.inf)
    vmax = jnp.where(tvalid[:, None], jnp.max(v, axis=1), -jnp.inf)
    root = jnp.stack([jnp.min(vmin, 0), jnp.max(vmax, 0)])
    return blocks, cmin, cmax, sub_bounds, root


@partial(jax.jit, static_argnames=("cluster_size", "sub_chunks"))
def _build_dense(sorted_tris: Triangle, cluster_size: int,
                 sub_chunks: int = 1) -> DenseScene:
    """Build from an ALREADY-sorted padded SoA: prims stay in table order
    and the original-index column is the row index (compat path; the
    fast perm-only path is build_dense)."""
    hot = pack_prims_hot(sorted_tris)
    blocks, cmin, cmax, sub_bounds, root = _dense_tables_from_hot(
        hot, cluster_size, sub_chunks)
    return DenseScene(tri_feats=blocks, cluster_min=cmin, cluster_max=cmax,
                      sub_bounds=sub_bounds,
                      prims=sorted_tris, prims_hot=hot,
                      root_aabb=root, n_prims=hot.shape[0],
                      cluster_size=cluster_size, sub_chunks=sub_chunks)


@partial(jax.jit, static_argnames=("cap",))
def _pack_hot_padded(v, meta, cap: int):
    """(cap, 11) int32 ORIGINAL-order hot rows, vertex sentinels on
    padding (float bits ride in int32 — see DenseScene.prims_hot)."""
    from .types import PAD_COORD, f32_as_i32
    n = v.shape[0]
    v9 = jnp.concatenate([
        jnp.asarray(v, jnp.float32).reshape(n, 9),
        jnp.full((cap - n, 9), PAD_COORD, jnp.float32)])
    mi = jnp.concatenate([jnp.asarray(meta).astype(jnp.int32),
                          jnp.zeros((cap - n,), jnp.int32)])
    idx = jnp.arange(cap, dtype=jnp.int32)
    return jnp.concatenate([f32_as_i32(v9), mi[:, None],
                            idx[:, None]], axis=1)


@partial(jax.jit, static_argnames=("cluster_size", "sub_chunks", "layout",
                                   "axes", "s0", "s1"))
def _build_dense_perm(hot0, *, cluster_size: int, sub_chunks: int,
                      layout: str, axes=None, s0: int = 0, s1: int = 0):
    """Sort-permutation build: compute the spatial perm on vertices only,
    then move ONE (cap, 11) hot matrix instead of permuting the full SoA
    (5 fields); cold payload fields are never permuted at all (fetched
    at finalize via the original-index column)."""
    from .lbvh import morton_perm_padded, tile_perm_padded
    from .types import i32_as_f32
    cap = hot0.shape[0]
    vp = i32_as_f32(hot0[:, :9]).reshape(cap, 3, 3)
    if layout == "tiles":
        perm = tile_perm_padded(vp, axes=axes, s0=s0, s1=s1)
    else:
        perm = morton_perm_padded(vp)
    hot = jnp.take(hot0, perm, axis=0)
    blocks, cmin, cmax, sub_bounds, root = _dense_tables_from_hot(
        hot, cluster_size, sub_chunks)
    return hot, blocks, cmin, cmax, sub_bounds, root


@partial(jax.jit, static_argnames=("cap", "cluster_size", "sub_chunks",
                                   "layout", "axes", "s0", "s1"))
def _build_dense_fused(v, meta, *, cap: int, cluster_size: int,
                       sub_chunks: int, layout: str, axes=None,
                       s0: int = 0, s1: int = 0):
    """Whole dense build as ONE jit (pack -> perm sorts -> hot gather ->
    featurize+pack): a warm rebuild is a single dispatch + the final
    readback, instead of one dispatch per stage."""
    hot0 = _pack_hot_padded(v, meta, cap)
    return _build_dense_perm(hot0, cluster_size=cluster_size,
                             sub_chunks=sub_chunks, layout=layout,
                             axes=axes, s0=s0, s1=s1)


# Per-mesh probe memory (scene bounds + payload flags): one readback on
# the first build of a mesh, none on rebuilds. Weakref-validated like the
# engines' capacity caches (ids recycle after GC) and size-bounded FIFO.
import weakref as _weakref

_PROBE_CACHE: dict = {}
_PROBE_CACHE_MAX = 64


def _face_normals(v):
    """Unit face normal per triangle, the EXACT formula the finalize
    recompute path uses (must stay in lockstep with the probe below):
    normalize(cross(v1-v0, v2-v0)), zero-length guarded to 0."""
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    fn = jnp.cross(e1, e2)
    ln = jnp.sqrt(jnp.sum(fn * fn, axis=-1, keepdims=True))
    return fn / jnp.where(ln > 0, ln, 1.0)


@jax.jit
def _mesh_probe(v, n, tg, uv):
    vr = v.reshape(-1, 3).astype(jnp.float32)
    lohi = jnp.concatenate([jnp.min(vr, 0), jnp.max(vr, 0)])
    # Flat-shaded detection: when every stored vertex normal equals the
    # face normal (within 1e-6 — the probe runs the same jnp formula the
    # finalize recompute uses, on the same backend), the winner's normals
    # can be recomputed from its already-gathered vertices instead of
    # paying a second 1M-row payload gather.
    fn = _face_normals(v)[:, None, :]
    flat = jnp.all(jnp.abs(n - fn) <= 1e-6) & jnp.any(n != 0)
    flags = jnp.array([jnp.any(n != 0), jnp.any(tg != 0), jnp.any(uv != 0),
                       flat])
    return lohi, flags


def _probe_mesh(tris: Triangle):
    """(lohi ndarray(6), payload_mask int) for a mesh. Cached by the
    identity of ALL FOUR payload arrays — the mask depends on
    normals/tangents/uv, so a Triangle sharing a vertices array with
    different payload fields (tris.replace(uv=...)) must not inherit a
    stale mask (ADVICE r2). Every cached array is weakref-validated
    because ids recycle after GC."""
    import numpy as np
    arrays = (tris.vertices, tris.normals, tris.tangents, tris.uv)
    key = tuple(id(a) for a in arrays) + (tuple(tris.vertices.shape),)
    ent = _PROBE_CACHE.get(key)
    if ent is not None and all(
            r is None or r() is a for r, a in zip(ent["refs"], arrays)):
        return ent["lohi"], ent["mask"]
    lohi, flags = _mesh_probe(tris.vertices, tris.normals, tris.tangents,
                              tris.uv)
    lohi = np.asarray(lohi)
    f = np.asarray(flags)
    mask = int(1 * f[0] + 2 * f[1] + 4 * f[2] + 8 * f[3])
    def _ref(a):
        try:
            return _weakref.ref(a)
        except TypeError:
            return None
    while len(_PROBE_CACHE) >= _PROBE_CACHE_MAX:
        _PROBE_CACHE.pop(next(iter(_PROBE_CACHE)))
    _PROBE_CACHE[key] = dict(lohi=lohi, mask=mask,
                             refs=tuple(_ref(a) for a in arrays))
    return lohi, mask


def build_dense(tris: Triangle, cluster_size: int = 256,
                sub_chunks: int = 1, layout: str = "tiles",
                instance_of=None) -> DenseScene:
    """Cluster + featurize a triangle soup. Triangles are spatially sorted
    first (clusters must be spatially coherent); capacity pads to a
    multiple of cluster_size with far-away sentinels. Only the hot rows
    (vertices + metadata + original index) are permuted; ``prims`` keeps
    the caller's original order and hits report original indices.

    layout="tiles" (default): count-balanced strip/slab/chunk sort —
    clusters are compact axis-aligned tiles (~3-4x fewer phase-A
    candidates than Morton chunks on heightfield-like scenes).
    layout="morton": raw Morton-chunk clustering (one sort; marginally
    cheaper build, fatter clusters).

    instance_of: optional (n,) int32 instance slot per input triangle
    (bake_dense supplies it); kept in original order and looked up by
    hit original index so hits report the owning instance."""
    from .lbvh import tile_sort_axes
    from .types import next_pow2
    n = tris.vertices.shape[0]
    cap = max(next_pow2(n), cluster_size)
    lohi, payload_mask = _probe_mesh(tris)
    if layout == "tiles":
        axes, s0, s1 = tile_sort_axes(tris.vertices, cap, cluster_size,
                                      lohi=lohi)
    else:
        axes, s0, s1 = None, 0, 0
    hot, blocks, cmin, cmax, sub_bounds, root = _build_dense_fused(
        tris.vertices, tris.metadata, cap=cap, cluster_size=cluster_size,
        sub_chunks=sub_chunks, layout=layout, axes=axes, s0=s0, s1=s1)
    scene = DenseScene(
        tri_feats=blocks, cluster_min=cmin, cluster_max=cmax,
        sub_bounds=sub_bounds, prims=tris, prims_hot=hot,
        root_aabb=root, n_prims=cap, cluster_size=cluster_size,
        sub_chunks=sub_chunks)
    if instance_of is not None:
        scene = scene.replace(
            instance_of_prim=jnp.asarray(instance_of, jnp.int32))
    return scene.replace(payload_mask=payload_mask)


_DEPTH_CACHE: dict = {}
_DEPTH_CACHE_MAX = 64


def depth_layers(scene, n_probe_side: int = 16,
                 gap_frac: float = 0.02) -> float:
    """MEDIAN over the three axes of the mean number of DISJOINT
    depth-layer groups the scene's cluster AABBs form along axis-aligned
    probe rays.

    Host-side numpy over the (K, 3) cluster bounds — no device work,
    cached per scene. An open sheet has ~1 layer along its height axis
    and only ripple-gap counts on the others, so its median stays low
    (1M-class heightfield measures [1.57, 1.44, 1.00] -> 1.44); a
    closed / multi-layer surface shows ~2 layers along at least two
    axes (blobby: [2.05, 1.91, 1.24] -> 1.91) — exactly the workloads
    where the ordered-wave engine's pruning pays (tools/wave_sim.py:
    1.78x there, ~1.1x on single sheets). Used by ``passes="auto"``
    (threshold 1.6) to pick 4 vs 1.

    A gap must exceed ``gap_frac`` of the scene's extent along the probe
    axis to count as a layer boundary, so touching clusters of one
    surface never read as layers."""
    import numpy as _np
    import weakref as _weakref
    # Keyed on id(tri_feats) with a weakref staleness guard: after GC a
    # recycled id must not return a dead scene's statistic (it would
    # silently misroute passes="auto" for the new scene) — same hazard
    # and fix as pallas_regroup's _CAPACITY_CACHE (ADVICE r4).
    key = id(scene.tri_feats)
    ent = _DEPTH_CACHE.get(key)
    if ent is not None:
        ref, val = ent
        if ref is None or ref() is scene.tri_feats:
            return val
        del _DEPTH_CACHE[key]
    bmin = _np.asarray(scene.cluster_min, dtype=_np.float32)
    bmax = _np.asarray(scene.cluster_max, dtype=_np.float32)
    # Capacity-padding sentinel geometry lives at PAD_COORD (1e30); drop
    # clusters that contain any of it (root_aabb spans sentinels too, so
    # it can't be the filter).
    from .types import PAD_COORD
    real = _np.all(_np.abs(bmax) < PAD_COORD * 0.5, axis=1) \
        & _np.all(_np.abs(bmin) < PAD_COORD * 0.5, axis=1)
    bmin, bmax = bmin[real], bmax[real]
    if bmin.shape[0] == 0:
        return 1.0
    per_axis = []
    for a in range(3):
        u, v = (a + 1) % 3, (a + 2) % 3
        ext_a = float(bmax[:, a].max() - bmin[:, a].min())
        gap = gap_frac * max(ext_a, 1e-9)
        us = _np.linspace(bmin[:, u].min(), bmax[:, u].max(),
                          n_probe_side + 2, dtype=_np.float32)[1:-1]
        vs = _np.linspace(bmin[:, v].min(), bmax[:, v].max(),
                          n_probe_side + 2, dtype=_np.float32)[1:-1]
        U, V = _np.meshgrid(us, vs, indexing="ij")
        Uf, Vf = U.reshape(-1, 1), V.reshape(-1, 1)
        inside = (Uf >= bmin[None, :, u]) & (Uf <= bmax[None, :, u]) \
            & (Vf >= bmin[None, :, v]) & (Vf <= bmax[None, :, v])
        lo = _np.where(inside, bmin[None, :, a], _np.inf)
        hi = _np.where(inside, bmax[None, :, a], -_np.inf)
        order = _np.argsort(lo, axis=1)
        lo_s = _np.take_along_axis(lo, order, axis=1)
        hi_s = _np.take_along_axis(hi, order, axis=1)
        cummax = _np.maximum.accumulate(hi_s, axis=1)
        new_group = (lo_s[:, 1:] > cummax[:, :-1] + gap) \
            & _np.isfinite(lo_s[:, 1:])
        any_hit = _np.isfinite(lo_s[:, 0])
        n_hit = int(any_hit.sum())
        if n_hit:
            per_axis.append(
                float((new_group.sum(axis=1) + any_hit).sum()) / n_hit)
    val = float(_np.median(per_axis)) if per_axis else 1.0
    if len(_DEPTH_CACHE) >= _DEPTH_CACHE_MAX:
        _DEPTH_CACHE.pop(next(iter(_DEPTH_CACHE)))
    try:
        ref = _weakref.ref(scene.tri_feats)
    except TypeError:
        ref = None
    _DEPTH_CACHE[key] = (ref, val)
    return val


@jax.jit
def _payload_flags(n, tg, uv):
    return jnp.array([jnp.any(n != 0), jnp.any(tg != 0), jnp.any(uv != 0)])


# ---------------------------------------------------------------------------
# Query
# ---------------------------------------------------------------------------

def _phase_a_tile_entry(scene: DenseScene, o, d, invd, t_min, t_max,
                        n_tiles: int, tile: int):
    """(n_tiles, K) conservative lower bound on any tile ray's cluster
    entry t (inf = provably no ray enters).

    Interval arithmetic over the ray bundle: with per-tile component
    intervals for origin and safe inverse direction, each slab product's
    extrema are among the 8 corner products, so the whole test costs a few
    dozen ops per (tile, cluster) — independent of rays per tile — in
    place of a per-ray (R, K) sweep; conservativeness only adds phase-B
    candidates, never drops one (exactness preserved)."""
    K = scene.n_clusters
    shp = lambda a: a.reshape((n_tiles, tile) + a.shape[1:])
    o_t = shp(o)
    invd_t = shp(invd)
    o_lo = jnp.min(o_t, axis=1)            # (n_tiles, 3)
    o_hi = jnp.max(o_t, axis=1)
    i_lo = jnp.min(invd_t, axis=1)
    i_hi = jnp.max(invd_t, axis=1)
    tmin_lo = jnp.min(shp(t_min), axis=1)  # (n_tiles,)
    tmax_hi = jnp.max(shp(t_max), axis=1)

    bmin = scene.cluster_min               # (K, 3)
    bmax = scene.cluster_max

    t_lo_lb = jnp.full((n_tiles, K), -jnp.inf)
    t_hi_ub = jnp.full((n_tiles, K), jnp.inf)
    CL = jnp.float32(_INV_DIR_CLAMP)   # exact safe_invdir clamp
    for a in range(3):
        lo8 = jnp.full((n_tiles, K), jnp.inf)
        hi8 = jnp.full((n_tiles, K), -jnp.inf)
        for b in (bmin[:, a], bmax[:, a]):           # (K,)
            for oc in (o_lo[:, a:a + 1], o_hi[:, a:a + 1]):   # (n_tiles,1)
                diff = b[None, :] - oc               # (n_tiles, K)
                for ic in (i_lo[:, a:a + 1], i_hi[:, a:a + 1]):
                    p = diff * ic
                    lo8 = jnp.minimum(lo8, p)
                    hi8 = jnp.maximum(hi8, p)
        # A ray with d[a] ~ 0 (safe_invdir clamped) whose origin lies
        # inside this slab never exits it, but the clamped products say it
        # does at |o-b|*1e5 — a false early exit that can DROP a truly
        # hit cluster when the origin sits within ~t*1e-5 of the slab
        # face. Widen the axis to (-inf, inf) whenever the bundle may
        # contain such a ray.
        par = (i_hi[:, a:a + 1] >= CL) | (i_lo[:, a:a + 1] <= -CL)
        ovl = (o_hi[:, a:a + 1] >= bmin[None, :, a]) \
            & (o_lo[:, a:a + 1] <= bmax[None, :, a])
        wide = par & ovl
        t_lo_lb = jnp.maximum(t_lo_lb, jnp.where(wide, -jnp.inf, lo8))
        t_hi_ub = jnp.minimum(t_hi_ub, jnp.where(wide, jnp.inf, hi8))

    entry_lb = jnp.maximum(t_lo_lb, tmin_lo[:, None])
    exit_ub = jnp.minimum(t_hi_ub, tmax_hi[:, None])
    return jnp.where(entry_lb <= exit_ub, entry_lb, jnp.inf)


EDGE_EPS = 1e-5  # barycentric acceptance slack (see module docstring)


def _epilogue(q, t_min, cur_best, C, sub_chunks: int = 4):
    """From quantity block (R_t, 4C, sub-chunk-major) -> (t_or_inf, u, v)
    per pair, columns in global triangle order.

    fast_intersect_triangle semantics with one deliberate difference: the
    u/v range tests carry a small EDGE_EPS slack. The featurized matmul
    evaluates the same bilinear forms in a different association order, so
    exact-zero edge tests would crack shared edges that the scalar MT path
    hits; the slack turns cracks into harmless double-hits (closest wins).
    """
    R = q.shape[0]
    qs = q.reshape(R, sub_chunks, 4, C // sub_chunks)
    det = qs[:, :, 0].reshape(R, C)
    udet = qs[:, :, 1].reshape(R, C)
    vdet = qs[:, :, 2].reshape(R, C)
    tdet = qs[:, :, 3].reshape(R, C)
    r = 1.0 / det
    u = udet * r
    v = vdet * r
    t = tdet * r
    e = EDGE_EPS
    ok = (u >= -e) & (u <= 1.0 + e) & (v >= -e) & (u + v <= 1.0 + e) \
        & (t >= t_min[:, None]) & (t <= cur_best[:, None])
    return jnp.where(ok, t, jnp.inf), u, v


@partial(jax.jit, static_argnames=("tile", "select_per_round", "max_rounds"))
def _closest_hit_dense_flat(scene: DenseScene, o, d, t_min, t_max, *,
                            tile: int, select_per_round: int,
                            max_rounds: int):
    from ..core.triangle import safe_invdir
    R = o.shape[0]
    C = scene.cluster_size
    K = scene.n_clusters
    S = select_per_round
    n_tiles = R // tile
    invd = safe_invdir(d)

    entry = _phase_a_tile_entry(scene, o, d, invd, t_min, t_max,
                                n_tiles, tile)             # (n_tiles, K)
    phi = ray_features(o, d).reshape(n_tiles, tile, FEAT)

    shp = lambda a: a.reshape(n_tiles, tile)
    t_min_t = shp(t_min)

    init = dict(
        entry=entry,                                    # inf once tested
        best_t=shp(t_max),                              # shrinks on hits
        best_pair=jnp.full((n_tiles, tile), -1, jnp.int32),
        best_u=jnp.zeros((n_tiles, tile), jnp.float32),
        best_v=jnp.zeros((n_tiles, tile), jnp.float32),
        rounds=jnp.int32(0),
    )

    def cond(s):
        tile_best_max = jnp.max(s["best_t"], axis=1)        # (n_tiles,)
        todo = jnp.any(s["entry"] < tile_best_max[:, None])
        return todo & (s["rounds"] < max_rounds)

    def body(s):
        entry = s["entry"]
        best_t = s["best_t"]
        best_pair = s["best_pair"]
        best_u = s["best_u"]
        best_v = s["best_v"]

        # Select the S smallest-entry untested clusters per tile.
        sel = []
        e = entry
        for _ in range(S):
            cid = jnp.argmin(e, axis=1)                    # (n_tiles,)
            sel.append(cid)
            e = e.at[jnp.arange(n_tiles), cid].set(jnp.inf)
        entry = e
        cids = jnp.stack(sel, axis=1)                      # (n_tiles, S)

        # Fused gather + matmul + epilogue for all S clusters, processed
        # in tile groups to bound the (rays x S*4C) matmul intermediate.
        TG = max(1, min(n_tiles, (1 << 25) // (tile * S * 4 * C) + 1))
        n_groups = -(-n_tiles // TG)
        TGp = n_groups * TG

        def pad_g(a):
            if TGp == n_tiles:
                return a
            padn = TGp - n_tiles
            return jnp.concatenate(
                [a, jnp.zeros((padn,) + a.shape[1:], a.dtype)])

        def group_fn(args):
            phi_g, cids_g, bt, bp, bu, bv, tmin_g = args
            blocks = jnp.take(scene.tri_feats, cids_g.reshape(-1), axis=0) \
                .reshape(TG, S, FEAT, 4 * C) \
                .transpose(0, 2, 1, 3).reshape(TG, FEAT, S * 4 * C)
            q = jnp.einsum("brf,bfq->brq", phi_g, blocks,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
            t_pair, u, v = _epilogue(q.reshape(-1, 4 * C),
                                     jnp.repeat(tmin_g.reshape(-1), S),
                                     jnp.repeat(bt.reshape(-1), S), C,
                                     scene.sub_chunks)
            t_pair = t_pair.reshape(TG, tile, S * C)
            u = u.reshape(TG, tile, S * C)
            v = v.reshape(TG, tile, S * C)
            tmin_c = jnp.min(t_pair, axis=2)
            arg = jnp.argmin(t_pair, axis=2)
            better = tmin_c < bt
            s_of = arg // C
            pair_id = jnp.take_along_axis(cids_g, s_of, axis=1) * C + arg % C
            take2 = lambda a: jnp.take_along_axis(
                a, arg[..., None], axis=2)[..., 0]
            return (jnp.where(better, tmin_c, bt),
                    jnp.where(better, pair_id, bp),
                    jnp.where(better, take2(u), bu),
                    jnp.where(better, take2(v), bv))

        grp = lambda a: pad_g(a).reshape((n_groups, TG) + a.shape[1:])
        outs = jax.lax.map(group_fn, (grp(phi), grp(cids), grp(best_t),
                                      grp(best_pair), grp(best_u),
                                      grp(best_v), grp(t_min_t)))
        ung = lambda a: a.reshape((TGp,) + a.shape[2:])[:n_tiles]
        best_t, best_pair, best_u, best_v = (ung(x) for x in outs)

        return dict(entry=entry, best_t=best_t, best_pair=best_pair,
                    best_u=best_u, best_v=best_v, rounds=s["rounds"] + 1)

    out = jax.lax.while_loop(cond, body, init)
    flat = lambda a: a.reshape(R)
    return (flat(out["best_pair"]), flat(out["best_t"]),
            flat(out["best_u"]), flat(out["best_v"]))


def _hit_instance_idx(scene: DenseScene, orig, hit):
    """Owning-instance index for winning prims: the baked side array when
    present (reference traversal returns instance_idx,
    src/instanced-bvh.jl:2010-2023), else instance 0. ``orig`` is the
    ORIGINAL-order index from the hot row."""
    if scene.instance_of_prim is None:
        return jnp.where(hit, 0, -1)
    n = scene.instance_of_prim.shape[0]
    inst = jnp.take(scene.instance_of_prim, jnp.clip(orig, 0, n - 1))
    return jnp.where(hit, inst, -1)


def finalize_hits(scene: DenseScene, pair, t, u, v) -> HitResult:
    """HitResult from raw best arrays (jit this together with the query:
    eager glue costs a dispatch per op)."""
    hit = (pair >= 0) & jnp.isfinite(t)
    tri, orig = gather_hit_payload(scene, jnp.clip(pair, 0, None), hit)
    bary = jnp.where(hit[:, None], jnp.stack([1 - u - v, u, v], -1), 0.0)
    return HitResult(hit=hit, triangle=tri, t=jnp.where(hit, t, 0.0),
                     barycentric=bary,
                     prim_idx=orig,
                     instance_idx=_hit_instance_idx(scene, orig, hit))


def finalize_hits_exact(scene: DenseScene, pair, t_approx, o, d) -> HitResult:
    """Finalize for the sweep engines: the kernels carry only a t key +
    prim index, so gather the winning triangle
    and recompute (t, u, v) with full-precision scalar Möller–Trumbore
    (exactly the reference's fast_intersect_triangle math,
    src/instanced-bvh.jl:1756-1797). Winners admitted under the featurized
    EDGE_EPS slack clamp into the barycentric simplex."""
    hit = (pair >= 0) & jnp.isfinite(t_approx)
    tri, orig = gather_hit_payload(scene, jnp.clip(pair, 0, None), hit)
    v0, v1, v2 = tri.vertices[:, 0], tri.vertices[:, 1], tri.vertices[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    s1 = jnp.cross(d, e2)
    det = jnp.sum(s1 * e1, axis=-1)
    r = jnp.where(det != 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    dvec = o - v0
    u = jnp.sum(dvec * s1, axis=-1) * r
    s2 = jnp.cross(dvec, e1)
    v = jnp.sum(d * s2, axis=-1) * r
    t = jnp.where(det != 0.0, jnp.sum(e2 * s2, axis=-1) * r, t_approx)
    u = jnp.clip(u, 0.0, 1.0)
    v = jnp.clip(v, 0.0, 1.0 - u)
    bary = jnp.where(hit[:, None], jnp.stack([1 - u - v, u, v], -1), 0.0)
    return HitResult(hit=hit, triangle=tri, t=jnp.where(hit, t, 0.0),
                     barycentric=bary,
                     prim_idx=orig,
                     instance_idx=_hit_instance_idx(scene, orig, hit))


@partial(jax.jit, static_argnames=("tile", "select_per_round", "max_rounds"))
def _dense_query_full(scene: DenseScene, o, d, t_min, t_max, *, tile: int,
                      select_per_round: int, max_rounds: int):
    """End-to-end jitted query: pad -> rounds -> finalize. One dispatch."""
    R = o.shape[0]
    d = jnp.where(d == 0.0, 0.0, d)
    pad = (-R) % tile
    if pad:
        ext = lambda a, f: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], f, a.dtype)])
        o, d = ext(o, 0.0), ext(d, 1.0)
        t_min, t_max = ext(t_min, 0.0), ext(t_max, -jnp.inf)
    pair, t, u, v = _closest_hit_dense_flat(
        scene, o, d, t_min, t_max, tile=tile,
        select_per_round=select_per_round, max_rounds=max_rounds)
    return finalize_hits(scene, pair[:R], t[:R], u[:R], v[:R])


def closest_hit_dense(scene: DenseScene, rays: Ray, *, tile: int = 2048,
                      select_per_round: int = 4,
                      max_rounds: int = 1024) -> HitResult:
    """Exact closest hit via the dense clustered engine. Rays should be
    spatially coherent in batch order (primary grids are; for incoherent
    batches sort by Morton code of origin+direction first)."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o = flat(rays.o)
    tile = min(tile, max(o.shape[0], 8))
    res = _dense_query_full(scene, o, flat(rays.d), flat(rays.t_min),
                            flat(rays.t_max), tile=tile,
                            select_per_round=select_per_round,
                            max_rounds=max_rounds)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)


def morton_sort_rays(rays: Ray, bounds_min, bounds_max):
    """Sort a flat ray batch by the Morton code of (origin octant +
    direction octant) so dense-engine tiles become spatially compact.
    Returns (sorted_rays, inverse_permutation); recover original order with
    ``jax.tree_util.tree_map(lambda a: a[inv], result)``."""
    from . import morton as _morton
    o = rays.o
    ext = jnp.maximum(jnp.asarray(bounds_max) - jnp.asarray(bounds_min), 1e-12)
    p = (o - jnp.asarray(bounds_min)) / ext
    code = _morton.morton_code_30bit(p)
    oct_d = ((rays.d[:, 0] > 0).astype(jnp.uint32)
             | ((rays.d[:, 1] > 0).astype(jnp.uint32) << 1)
             | ((rays.d[:, 2] > 0).astype(jnp.uint32) << 2))
    key = (code >> 3) | (oct_d << 29)
    order = jnp.argsort(key)
    inv = jnp.argsort(order)
    take = lambda a: jnp.take(a, order, axis=0)
    return jax.tree_util.tree_map(take, rays), inv


def any_hit_dense(scene: DenseScene, rays: Ray, **kw) -> HitResult:
    """Occlusion query (t_min forced to 0, reference any_hit semantics).
    Uses the closest-hit machinery — only the boolean is contractual."""
    rays0 = rays.replace(t_min=jnp.zeros_like(rays.t_min))
    return closest_hit_dense(scene, rays0, **kw)

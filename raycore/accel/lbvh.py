"""LBVH construction as a pure-XLA sort/scan/vmap pipeline.

Array-parallel redesign of the reference's build kernels (reference:
src/instanced-bvh.jl:1209-1443 and src/instanced-bvh-kernels.jl). The Karras
2012 radix-tree searches become fixed-iteration masked loops vectorized over
all internal nodes; the atomic bottom-up AABB refit (which needs device
atomics) becomes idempotent fixpoint union passes —
after k passes every node within height k of the leaves is exact, and the
Karras tree depth is bounded by 64 (strictly increasing LCP along any
root-leaf path: <=31 values while codes differ + <=32 while identical).

Everything here is jit-compatible with static shapes; callers pad to
power-of-two capacities with far-away sentinel geometry (types.PAD_COORD).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.triangle import Triangle
from . import morton as _morton
from .types import (BLAS, INVALID_NODE, NODE_COLS, PAD_COORD, f32_as_i32,
                    i32_as_f32, next_pow2, pad_triangles)

MAX_DEPTH = 64  # Karras radix-tree depth bound for 30-bit codes + index tiebreak


# ---------------------------------------------------------------------------
# Karras 2012 radix tree (reference src/instanced-bvh.jl:1209-1295)
# ---------------------------------------------------------------------------

def _make_delta(codes: jnp.ndarray):
    """LCP of sorted Morton codes with index tiebreak for duplicates
    (reference `delta`, src/instanced-bvh.jl:1212-1229). Returns -1 out of
    bounds. Operates on int32 index arrays of any shape."""
    n = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < n) & (i >= 0) & (i < n)
        ic = jnp.clip(i, 0, n - 1)
        jc = jnp.clip(j, 0, n - 1)
        ci = jnp.take(codes, ic)
        cj = jnp.take(codes, jc)
        d_code = _morton.clz32(ci ^ cj)
        d_idx = 32 + _morton.clz32(ic.astype(jnp.uint32) ^ jc.astype(jnp.uint32))
        d = jnp.where(ci == cj, d_idx, d_code)
        return jnp.where(valid, d, jnp.int32(-1))

    return delta


def karras_topology(codes: jnp.ndarray):
    """Build the radix-tree topology from sorted Morton codes.

    Returns ``(child0, child1, parent)``:
    - child0/child1: (n-1,) int32 node ids of each internal node's children
      (internal ids [0, n-2]; leaf id for sorted prim p = (n-1)+p)
    - parent: (2n-1,) int32, INVALID_NODE at the root.

    Vectorized over all internal nodes at once; the exponential and binary
    searches run a fixed 32 masked iterations each (n < 2^31), replacing the
    reference's data-dependent while loops (src/instanced-bvh.jl:1232-1290).
    """
    n = codes.shape[0]
    assert n >= 2
    delta = _make_delta(codes)
    i = jnp.arange(n - 1, dtype=jnp.int32)

    # Direction and minimum LCP (span excludes the d=-1 neighbor).
    d_left = delta(i, i - 1)
    d_right = delta(i, i + 1)
    d = jnp.where(d_right > d_left, jnp.int32(1), jnp.int32(-1))
    delta_min = delta(i, i - d)

    # Exponential search for an upper bound on the span length. The loop
    # invariant (delta > delta_min iff inside the span) makes the masked
    # re-check idempotent once the condition first fails.
    def exp_body(_, l_max):
        grow = delta(i, i + l_max * d) > delta_min
        return jnp.where(grow, l_max * 2, l_max)

    l_max = jax.lax.fori_loop(0, 32, exp_body, jnp.full_like(i, 2))

    # Binary search for the exact other end.
    def bin_body(_, carry):
        l, t = carry
        active = t > 1
        t2 = jnp.where(active, t // 2, t)
        take = delta(i, i + (l + t2) * d) > delta_min
        l = jnp.where(active & take, l + t2, l)
        return l, t2

    l, _ = jax.lax.fori_loop(0, 32, bin_body,
                             (jnp.zeros_like(i), l_max))
    j = i + l * d
    first = jnp.minimum(i, j)
    last = jnp.maximum(i, j)

    # Binary search for the split position (reference find_split_in_span).
    num_identical = delta(first, last)

    def split_body(_, carry):
        left, right = carry
        active = right > left + 1
        mid = (left + right) // 2
        go_left = delta(first, mid) > num_identical
        new_left = jnp.where(go_left, mid, left)
        new_right = jnp.where(go_left, right, mid)
        return (jnp.where(active, new_left, left),
                jnp.where(active, new_right, right))

    split, _ = jax.lax.fori_loop(0, 32, split_body, (first, last))

    leaf_base = jnp.int32(n - 1)
    child0 = jnp.where(split == first, leaf_base + split, split)
    child1 = jnp.where(split + 1 == last, leaf_base + split + 1, split + 1)

    parent = jnp.full((2 * n - 1,), INVALID_NODE, jnp.int32)
    parent = parent.at[child0].set(i)
    parent = parent.at[child1].set(i)
    return child0, child1, parent


def refit_aabbs(child0, child1, leaf_min, leaf_max, n_passes=None):
    """Bottom-up AABB computation without atomics.

    ``leaf_min/max``: (n, 3) AABBs of the sorted leaves. Returns full
    per-node (2n-1, 3) min/max arrays (internal rows exact after the
    fixpoint). Replaces the reference's atomic second-arriver protocol
    (src/instanced-bvh-kernels.jl:239-286) with height-many idempotent
    gather-union passes.
    """
    n = leaf_min.shape[0]
    if n_passes is None:
        n_passes = min(MAX_DEPTH, n)
    mn = jnp.concatenate([jnp.full((n - 1, 3), jnp.inf, jnp.float32), leaf_min])
    mx = jnp.concatenate([jnp.full((n - 1, 3), -jnp.inf, jnp.float32), leaf_max])

    def body(_, carry):
        mn, mx = carry
        i_mn = jnp.minimum(jnp.take(mn, child0, axis=0),
                           jnp.take(mn, child1, axis=0))
        i_mx = jnp.maximum(jnp.take(mx, child0, axis=0),
                           jnp.take(mx, child1, axis=0))
        return (jnp.concatenate([i_mn, mn[n - 1:]]),
                jnp.concatenate([i_mx, mx[n - 1:]]))

    return jax.lax.fori_loop(0, n_passes, body, (mn, mx))


# ---------------------------------------------------------------------------
# BLAS build (reference build_blas, src/instanced-bvh.jl:1376-1443)
# ---------------------------------------------------------------------------

def _tri_bounds(vertices):
    return jnp.min(vertices, axis=-2), jnp.max(vertices, axis=-2)


def _normalize_centroids(centers, scene_min, scene_max):
    extent = jnp.maximum(scene_max - scene_min, 1e-12)
    return (centers - scene_min) / extent


@partial(jax.jit, static_argnames=("n_real",))
def _build_blas_padded(tris: Triangle, n_real: int) -> BLAS:
    """Core jitted build over a capacity-padded Triangle SoA."""
    cap = tris.vertices.shape[0]
    v = tris.vertices
    bmin, bmax = _tri_bounds(v)                         # (cap, 3)

    # Scene bound over the REAL prims only (padding lives at PAD_COORD).
    scene_min = jnp.min(bmin[:n_real], axis=0)
    scene_max = jnp.max(bmax[:n_real], axis=0)
    root_aabb = jnp.stack([scene_min, scene_max])

    centers = 0.5 * (bmin + bmax)
    codes = _morton.morton_code_30bit(
        _normalize_centroids(centers, scene_min, scene_max))

    # Stable sort by code, carrying the permutation (reference AK.sortperm).
    order = jnp.arange(cap, dtype=jnp.int32)
    codes_sorted, perm = jax.lax.sort((codes, order), num_keys=1,
                                      is_stable=True)
    prims = permute_triangles(tris, perm)

    child0, child1, parent = karras_topology(codes_sorted)

    leaf_min, leaf_max = _tri_bounds(prims.vertices)
    node_min, node_max = refit_aabbs(child0, child1, leaf_min, leaf_max,
                                     n_passes=min(MAX_DEPTH, cap))

    nodes = pack_nodes_blas(child0, child1, parent, node_min, node_max,
                            prims.vertices)
    return BLAS(nodes=nodes, prims=prims, root_aabb=root_aabb,
                n_prims=n_real, capacity=cap)


def pack_nodes_blas(child0, child1, parent, node_min, node_max, sorted_verts):
    """Pack the (2n-1, 16) int32 node matrix: internal rows carry child
    AABBs, leaf rows carry inline triangle vertices (BVH2IL; reference
    create_leaf_nodes_kernel!, src/instanced-bvh-kernels.jl:197-226).

    Float fields are bitcast to int32 so the matrix is int-typed end to
    end: float paths may canonicalize NaNs, and INVALID_NODE (-1) bitcast
    to f32 is a NaN pattern — keeping the storage integral preserves it.
    """
    n = sorted_verts.shape[0]

    # Internal rows [0, n-2].
    a0min = jnp.take(node_min, child0, axis=0)
    a0max = jnp.take(node_max, child0, axis=0)
    a1min = jnp.take(node_min, child1, axis=0)
    a1max = jnp.take(node_max, child1, axis=0)
    internal = jnp.concatenate(
        [f32_as_i32(jnp.concatenate([a0min, a0max, a1min, a1max], axis=1)),
         child0[:, None], child1[:, None], parent[: n - 1][:, None],
         jnp.zeros((n - 1, 1), jnp.int32)], axis=1)

    # Leaf rows [n-1, 2n-2]: inline v0/v1/v2, child1 = sorted prim index.
    prim_idx = jnp.arange(n, dtype=jnp.int32)
    leaves = jnp.concatenate(
        [f32_as_i32(jnp.concatenate(
            [sorted_verts[:, 0], sorted_verts[:, 1], sorted_verts[:, 2],
             jnp.zeros((n, 3), jnp.float32)], axis=1)),
         jnp.full((n, 1), INVALID_NODE, jnp.int32),
         prim_idx[:, None], parent[n - 1:][:, None],
         jnp.zeros((n, 1), jnp.int32)], axis=1)

    return jnp.concatenate([internal, leaves], axis=0)


def permute_triangles(tris: Triangle, perm):
    """Apply a row permutation to a Triangle SoA with ONE wide gather.

    Gathers cost per row more than per byte, so one take of the
    concatenated (T, 34) matrix replaces five per-field takes. The
    matrix is int32 with float bits riding as bit patterns: metadata ints
    bitcast INTO f32 would be denormals, which f32 ops may flush to zero
    (the int32 node-matrix discipline)."""
    from .types import f32_as_i32, i32_as_f32
    T = tris.vertices.shape[0]
    flat = jnp.concatenate([
        f32_as_i32(tris.vertices.reshape(T, 9)),
        f32_as_i32(tris.normals.reshape(T, 9)),
        f32_as_i32(tris.tangents.reshape(T, 9)),
        f32_as_i32(tris.uv.reshape(T, 6)),
        tris.metadata.astype(jnp.int32)[:, None]], axis=1)
    g = jnp.take(flat, perm, axis=0)
    return Triangle(
        vertices=i32_as_f32(g[:, 0:9]).reshape(T, 3, 3),
        normals=i32_as_f32(g[:, 9:18]).reshape(T, 3, 3),
        tangents=i32_as_f32(g[:, 18:27]).reshape(T, 3, 3),
        uv=i32_as_f32(g[:, 27:33]).reshape(T, 3, 2),
        metadata=g[:, 33].astype(jnp.uint32))


@jax.jit
def morton_perm_padded(v):
    """(cap,) permutation Morton-sorting capacity-padded (cap, 3, 3)
    triangle vertices (padding sentinels sort last). Perm-only so callers
    can move exactly the data they need (the dense build permutes one
    packed hot matrix instead of the whole SoA).

    Scene bounds for code normalization must EXCLUDE the PAD_COORD
    sentinels, or every real centroid collapses to one Morton cell and the
    clustering degenerates."""
    bmin, bmax = _tri_bounds(v)
    real = bmin[:, 0] < PAD_COORD / 2
    scene_min = jnp.min(jnp.where(real[:, None], bmin, jnp.inf), axis=0)
    scene_max = jnp.max(jnp.where(real[:, None], bmax, -jnp.inf), axis=0)
    centers = 0.5 * (bmin + bmax)
    codes = _morton.morton_code_30bit(
        _normalize_centroids(centers, scene_min, scene_max))
    order = jnp.arange(v.shape[0], dtype=jnp.int32)
    _, perm = jax.lax.sort((codes, order), num_keys=1, is_stable=True)
    return perm


@partial(jax.jit, static_argnames=())
def _morton_sort_padded(tris: Triangle):
    """Morton-sort a capacity-padded Triangle SoA (the build's first three
    stages only: bounds -> codes -> stable sort + permute)."""
    perm = morton_perm_padded(tris.vertices)
    return permute_triangles(tris, perm), perm


def morton_sort_triangles(tris: Triangle, capacity: int,
                          return_perm: bool = False):
    """Pad to capacity and Morton-sort (padding sentinels sort last).
    With return_perm, also returns the (capacity,) permutation applied
    (entries >= n point at padding), so callers can carry side arrays —
    e.g. bake_dense's per-triangle instance index."""
    out, perm = _morton_sort_padded(pad_triangles(tris, capacity))
    return (out, perm) if return_perm else out


@partial(jax.jit, static_argnames=("axes", "s0", "s1"))
def tile_perm_padded(v, *, axes: tuple, s0: int, s1: int):
    """(cap,) permutation for the count-balanced 3-level spatial sort of
    capacity-padded (cap, 3, 3) triangle vertices: equal-count strips
    along the longest scene axis, equal-count slabs along the second
    within each strip, final order along the third. Because capacity and
    the strip/slab counts are powers of two, every boundary between
    cluster_size chunks is also a strip/slab boundary — downstream
    fixed-size clusters are compact axis-aligned tiles instead of Morton
    chunks (measured: Morton clusters' xy footprint is 3-9x the ideal
    tile area on a 1M-tri heightfield, i.e. ~9 clusters overlap a
    vertical ray where tiles give ~2)."""
    bmin, bmax = _tri_bounds(v)
    real = bmin[:, 0] < PAD_COORD / 2
    scene_min = jnp.min(jnp.where(real[:, None], bmin, jnp.inf), axis=0)
    scene_max = jnp.max(jnp.where(real[:, None], bmax, -jnp.inf), axis=0)
    ext = jnp.maximum(scene_max - scene_min, 1e-12)
    centers = 0.5 * (bmin + bmax)
    q = jnp.clip((centers - scene_min) / ext * 65535.0, 0.0, 65535.0)
    q = q.astype(jnp.int32)                              # (cap, 3)
    N = v.shape[0]
    iota = jnp.arange(N, dtype=jnp.int32)

    # The later-pass sort keys ride through the earlier sorts as variadic
    # payload operands: a (cap,) jnp.take by the running permutation is a
    # row-latency-bound gather while sort payload columns move at
    # bandwidth.
    # Pass 0: strips along the dominant axis; pads last globally.
    key0 = jnp.where(real, q[:, axes[0]], jnp.int32(1 << 24))
    q1 = jnp.where(real, q[:, axes[1]], jnp.int32(65536))
    q2 = jnp.where(real, q[:, axes[2]], jnp.int32(65536))
    _, q1s, q2s, perm = jax.lax.sort((key0, q1, q2, iota), num_keys=1,
                                     is_stable=True)
    # Pass 1: slabs along the second axis inside each strip.
    strip = iota // (N // s0)
    _, q2ss, perm = jax.lax.sort((strip * 65537 + q1s, q2s, perm),
                                 num_keys=1, is_stable=True)
    # Pass 2: order along the third axis inside each slab.
    slab = iota // (N // (s0 * s1))
    _, perm = jax.lax.sort((slab * 65537 + q2ss, perm), num_keys=1,
                           is_stable=True)
    return perm


@jax.jit
def _bounds_lohi(vertices):
    vr = vertices.reshape(-1, 3).astype(jnp.float32)
    return jnp.concatenate([jnp.min(vr, 0), jnp.max(vr, 0)])


def tile_sort_axes(vertices, capacity: int, cluster_size: int, lohi=None):
    """Host-side strip/slab shape choice for the tile sort: greedily
    halve the currently-longest scene extent. One small host sync for
    the 6 scene-bound floats (one jitted reduction, not an eager
    min/max chain of dispatches); callers that
    already know the bounds pass ``lohi`` to skip the sync entirely.
    Returns (axes, s0, s1) for tile_perm_padded."""
    import numpy as np
    if lohi is None:
        lohi = np.asarray(_bounds_lohi(jnp.asarray(vertices, jnp.float32)))
    lohi = np.asarray(lohi)
    lo, hi = lohi[:3], lohi[3:]
    ext = np.maximum(hi - lo, 1e-12)
    K = max(capacity // cluster_size, 1)
    bits = [0, 0, 0]
    e = ext.copy()
    for _ in range(int(np.log2(K))):
        a = int(np.argmax(e))
        bits[a] += 1
        e[a] *= 0.5
    axes = tuple(int(a) for a in np.argsort(-np.asarray(bits, np.float64)
                                            - ext / ext.max() * 0.5))
    return axes, 1 << bits[axes[0]], 1 << bits[axes[1]]


def tile_sort_triangles(tris: Triangle, capacity: int,
                        cluster_size: int, return_perm: bool = False):
    """Pad to capacity and sort into count-balanced spatial tiles of
    ``cluster_size``. With return_perm, also returns the applied
    (capacity,) permutation (entries >= n are padding)."""
    padded = pad_triangles(tris, capacity)
    axes, s0, s1 = tile_sort_axes(tris.vertices, capacity, cluster_size)
    perm = tile_perm_padded(padded.vertices, axes=axes, s0=s0, s1=s1)
    out = permute_triangles(padded, perm)
    return (out, perm) if return_perm else out


def build_blas(tris: Triangle, capacity: int | None = None) -> BLAS:
    """Build a BLAS from a Triangle SoA (any count >= 1).

    Pads to a power-of-two capacity so repeated builds of similar-size
    meshes reuse the same compiled executable (the reference reallocs exact
    sizes; shape-bucketing is the jit-friendly equivalent).
    """
    n_real = tris.vertices.shape[0]
    cap = next_pow2(n_real) if capacity is None else int(capacity)
    assert cap >= max(2, n_real)
    return _build_blas_padded(pad_triangles(tris, cap), n_real)

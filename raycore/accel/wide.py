"""Wide (4-ary) BVH: collapse pass + 4-wide traversal.

JAX counterpart of the reference's BVH4 layer (reference:
src/bvh4.jl). The reference collapses BVH2 to 128-byte 4-wide nodes with a
sequential CPU worklist (`collapse_bvh2_to_bvh4`, src/bvh4.jl:314-497);
here the collapse is a single vectorized gather pass: every BVH2 internal
node i becomes BVH4 row i whose 4 slots are its children (if leaves) or
grandchildren — rows at odd depth are simply never referenced. No worklist,
no sequential pass, and the 4 AABB slab tests per step vectorize.

Parity note: like the reference, the instanced path over BVH4 is not
provided (reference TLAS4 has a type but no build/traversal,
SURVEY.md §2.3); `closest_hit4`/`any_hit4` operate on a single BLAS4.

Packed BVH4 row layout, (n-1, 32) float32:
    cols [6k, 6k+3)   slot-k AABB min   (k = 0..3; empty slot: +inf)
    cols [6k+3, 6k+6) slot-k AABB max   (empty slot: -inf)
    cols 24:28        slot refs (bitcast int32; -1 empty,
                      bit30 set => leaf, low bits = sorted prim index;
                      else BVH4 row index)
    cols 28:32        padding
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.bounds import fast_intersect_bbox
from ..core.ray import Ray
from ..core.triangle import Triangle, fast_intersect_triangle, safe_invdir
from .brute import HitResult, gather_triangles, _mask_triangle
from .lbvh import build_blas
from .types import BLAS, INVALID_NODE, f32_as_i32, i32_as_f32

LEAF_BIT = jnp.int32(1 << 30)
_INVALID = jnp.int32(-1)


@struct.dataclass
class BLAS4:
    """4-wide BLAS (reference BLAS4, src/bvh4.jl:154-166)."""
    nodes4: jnp.ndarray      # (cap-1, 32) int32 packed (f32 bitcast)
    prims: Triangle          # (cap,) sorted SoA (shared with the BVH2 build)
    root_aabb: jnp.ndarray   # (2, 3)
    n_prims: int = struct.field(pytree_node=False)
    capacity: int = struct.field(pytree_node=False)


def _node2_aabb(nodes2, ids):
    """AABB of an arbitrary BVH2 node id: internal rows store child AABBs
    (union them); leaf rows store inline vertices (bound them).
    ``nodes2`` is the int32-packed matrix; float slices are bitcast."""
    nfi = jnp.take(nodes2, ids, axis=0)
    nf = i32_as_f32(nfi[:, :12])
    is_leaf = nfi[:, 12] == INVALID_NODE
    int_min = jnp.minimum(nf[:, 0:3], nf[:, 6:9])
    int_max = jnp.maximum(nf[:, 3:6], nf[:, 9:12])
    v = jnp.stack([nf[:, 0:3], nf[:, 3:6], nf[:, 6:9]], axis=1)
    leaf_min = jnp.min(v, axis=1)
    leaf_max = jnp.max(v, axis=1)
    return (jnp.where(is_leaf[:, None], leaf_min, int_min),
            jnp.where(is_leaf[:, None], leaf_max, int_max))


@jax.jit
def _collapse(nodes2):
    """Vectorized BVH2 -> BVH4 collapse over all internal rows.

    Interior-preference (reference gather_children_bvh2's BFS "prefer
    interior" choice, src/bvh4.jl:201-300, :235): when exactly one child
    is a leaf the two-grandchildren expansion fills only 3 slots; a
    third expansion step replaces the first INTERIOR grandchild with its
    own two children, filling all 4. Under leaf-skewed Karras trees
    (caterpillars) this descends 3 BVH2 levels per BVH4 step instead of
    2 — same slot sets as the reference's sequential BFS, computed as
    two fixed vectorized gather rounds."""
    total = nodes2.shape[0]
    n = (total + 1) // 2            # capacity (leaf count)
    ni = n - 1                      # internal rows
    c0 = nodes2[:ni, 12]
    c1 = nodes2[:ni, 13]
    leaf_base = n - 1

    def children(c):
        """(g0, g1) of a BVH2 node id (garbage for leaf rows — callers
        mask on interiority)."""
        cc = jnp.clip(c, 0, ni - 1)
        return (jnp.take(nodes2[:, 12], cc), jnp.take(nodes2[:, 13], cc))

    def expand(c):
        """Candidate slot pair from one BVH2 child: (slotA, slotB).
        Leaf child -> (leaf c, empty); internal child -> its two children."""
        c_is_leaf = c >= leaf_base
        g0, g1 = children(c)
        slot_a = jnp.where(c_is_leaf, c, g0)
        slot_b = jnp.where(c_is_leaf, _INVALID, g1)
        return slot_a, slot_b

    a0, b0 = expand(c0)
    a1, b1 = expand(c1)
    slots = jnp.stack([a0, b0, a1, b1], axis=1)          # (ni, 4) BVH2 ids

    # Third expansion: one child leaf + one internal -> 3 filled slots.
    # Expand the first interior grandchild of the internal child.
    c0_leaf = c0 >= leaf_base
    c1_leaf = c1 >= leaf_base
    one_leaf = c0_leaf ^ c1_leaf
    leaf_slot = jnp.where(c0_leaf, c0, c1)
    g0, g1 = children(jnp.where(c0_leaf, c1, c0))
    g0_int = (g0 >= 0) & (g0 < leaf_base)
    g1_int = (g1 >= 0) & (g1 < leaf_base)
    e = jnp.where(g0_int, g0, g1)               # grandchild to expand
    keep = jnp.where(g0_int, g1, g0)
    h0, h1 = children(e)
    do3 = one_leaf & (g0_int | g1_int)
    slots3 = jnp.stack([leaf_slot, keep, h0, h1], axis=1)
    slots = jnp.where(do3[:, None], slots3, slots)

    valid = slots >= 0
    ids = jnp.clip(slots, 0, total - 1).reshape(-1)
    mn, mx = _node2_aabb(nodes2, ids)
    mn = jnp.where(valid.reshape(-1, 1), mn, jnp.inf).reshape(ni, 4, 3)
    mx = jnp.where(valid.reshape(-1, 1), mx, -jnp.inf).reshape(ni, 4, 3)

    # Encode refs: leaf -> LEAF_BIT | sorted prim idx (child1 of leaf row);
    # internal -> BVH4 row index (same id).
    slot_is_leaf = slots >= leaf_base
    prim_idx = jnp.take(
        nodes2[:, 13], jnp.clip(slots, 0, total - 1).reshape(-1)
    ).reshape(ni, 4)
    refs = jnp.where(slot_is_leaf, LEAF_BIT | prim_idx, slots)
    refs = jnp.where(valid, refs, _INVALID)

    boxes = jnp.concatenate([mn, mx], axis=2).reshape(ni, 24)
    packed = jnp.concatenate(
        [f32_as_i32(boxes), refs, jnp.zeros((ni, 4), jnp.int32)], axis=1)
    return packed


def collapse_blas(blas: BLAS) -> BLAS4:
    """BVH2 -> BVH4 (reference collapse_bvh2_to_bvh4 + build_blas4,
    src/bvh4.jl:314-522)."""
    return BLAS4(nodes4=_collapse(blas.nodes), prims=blas.prims,
                 root_aabb=blas.root_aabb, n_prims=blas.n_prims,
                 capacity=blas.capacity)


def build_blas4(tris: Triangle, capacity: int | None = None) -> BLAS4:
    return collapse_blas(build_blas(tris, capacity))


@struct.dataclass
class TLAS4:
    """Placeholder for a 4-wide instanced TLAS. Parity note: the reference
    also exports a TLAS4 type with NO build or traversal path over
    instances (src/bvh4.jl:154-178; SURVEY.md §2.3 "only BLAS4 is
    functional"). Kept for API-surface parity; the production instanced
    path is the BVH2 StaticTLAS or the dense clustered engine."""
    blas4: BLAS4
    instances: object = None


# ---------------------------------------------------------------------------
# 4-wide traversal (reference closest_hit4/any_hit4, src/bvh4.jl:524-766)
# ---------------------------------------------------------------------------

def _sort4(keys, vals):
    """Ascending sort of 4 (key, val) lanes via a 5-comparator network."""
    def cas(i, j, k, v):
        swap = k[i] > k[j]
        ki = jnp.where(swap, k[j], k[i])
        kj = jnp.where(swap, k[i], k[j])
        vi = jnp.where(swap, v[j], v[i])
        vj = jnp.where(swap, v[i], v[j])
        k = k[:i] + (ki,) + k[i + 1:j] + (kj,) + k[j + 1:]
        v = v[:i] + (vi,) + v[i + 1:j] + (vj,) + v[j + 1:]
        return k, v

    k = tuple(keys)
    v = tuple(vals)
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        k, v = cas(i, j, k, v)
    return k, v


def _traverse4_tile(blas4: BLAS4, o, d, t_min, t_max0, *, any_hit: bool,
                    stack_size: int, max_iters: int):
    R = o.shape[0]
    nodes = blas4.nodes4
    verts = blas4.prims.vertices
    invd = safe_invdir(d)

    init = dict(
        node=jnp.zeros((R,), jnp.int32),
        stack=jnp.full((R, stack_size), _INVALID, jnp.int32),
        sptr=jnp.zeros((R,), jnp.int32),
        t_max=t_max0,
        best_prim=jnp.full((R,), -1, jnp.int32),
        best_u=jnp.zeros((R,), jnp.float32),
        best_v=jnp.zeros((R,), jnp.float32),
        iters=jnp.int32(0),
    )
    slots_iota = jnp.arange(stack_size, dtype=jnp.int32)[None, :]

    def cond(s):
        return jnp.any(s["node"] != _INVALID) & (s["iters"] < max_iters)

    def body(s):
        node, t_max = s["node"], s["t_max"]
        active = node != _INVALID
        is_leaf = active & ((node & LEAF_BIT) != 0)
        is_int = active & ~is_leaf

        # --- internal: fetch row, 4 slab tests, sort near->far ----------
        row = jnp.clip(jnp.where(is_leaf, 0, node), 0, nodes.shape[0] - 1)
        nfi = jnp.take(nodes, row, axis=0)               # (R, 32) int32
        nf = i32_as_f32(nfi[:, :24])
        refs = [nfi[:, 24 + k] for k in range(4)]
        tmins, hits = [], []
        for k in range(4):
            lo, hi = fast_intersect_bbox(o, invd, nf[:, 6 * k:6 * k + 3],
                                         nf[:, 6 * k + 3:6 * k + 6],
                                         t_min, t_max)
            ok = (lo <= hi) & (refs[k] != _INVALID)
            tmins.append(jnp.where(ok, lo, jnp.inf))
            hits.append(ok)
        keys, vals = _sort4(tmins, refs)
        valid_sorted = [jnp.isfinite(k) for k in keys]

        # --- leaf: Möller–Trumbore against the referenced prim ----------
        prim = jnp.clip(node & (LEAF_BIT - 1), 0, verts.shape[0] - 1)
        tv = jnp.take(verts, prim, axis=0)               # (R, 3, 3)
        h, t, u, v = fast_intersect_triangle(
            o, d, tv[:, 0], tv[:, 1], tv[:, 2], t_min, t_max)
        h = h & is_leaf
        t_max = jnp.where(h, t, t_max)
        best_prim = jnp.where(h, node & (LEAF_BIT - 1), s["best_prim"])
        best_u = jnp.where(h, u, s["best_u"])
        best_v = jnp.where(h, v, s["best_v"])

        if any_hit:
            lane_done = h
        else:
            lane_done = jnp.zeros_like(h)

        # --- push far slots (3rd, 2nd in far-to-near order), descend ----
        sptr = s["sptr"]
        stack = s["stack"]
        # Push order: farthest first so nearest pops first (reference
        # intersect_all_children4 pushes in reverse, src/bvh4.jl:562-599).
        for k in (3, 2, 1):
            do = is_int & valid_sorted[k] & ~lane_done
            sptr = jnp.where(do, sptr + 1, sptr)
            wm = (slots_iota == jnp.clip(sptr, 0, stack_size - 1)[:, None]) \
                & do[:, None]
            stack = jnp.where(wm, vals[k][:, None], stack)

        descend = is_int & valid_sorted[0] & ~lane_done
        need_pop = active & ~descend & ~lane_done
        top = jnp.take_along_axis(
            stack, jnp.clip(sptr, 0, stack_size - 1)[:, None], axis=1)[:, 0]
        node_next = jnp.where(lane_done, _INVALID,
                              jnp.where(descend, vals[0],
                                        jnp.where(need_pop, top, node)))
        sptr_next = jnp.where(need_pop, sptr - 1, sptr)

        return dict(node=node_next, stack=stack, sptr=sptr_next, t_max=t_max,
                    best_prim=best_prim, best_u=best_u, best_v=best_v,
                    iters=s["iters"] + 1)

    out = jax.lax.while_loop(cond, body, init)
    return out["best_prim"], out["t_max"], out["best_u"], out["best_v"]


@partial(jax.jit, static_argnames=("any_hit", "stack_size", "max_iters",
                                   "tile_size"))
def _trace4(blas4: BLAS4, o, d, t_min, t_max, *, any_hit, stack_size,
            max_iters, tile_size):
    R = o.shape[0]
    n_tiles = max(1, -(-R // tile_size))
    padded = n_tiles * tile_size
    if padded != R:
        padf = lambda a, fill: jnp.concatenate(
            [a, jnp.full((padded - R,) + a.shape[1:], fill, a.dtype)])
        o, d = padf(o, 0.0), padf(d, 1.0)
        t_min, t_max = padf(t_min, 0.0), padf(t_max, -1.0)
    tiles = lambda a: a.reshape((n_tiles, tile_size) + a.shape[1:])

    def one(tile):
        return _traverse4_tile(blas4, *tile, any_hit=any_hit,
                               stack_size=stack_size, max_iters=max_iters)

    outs = jax.lax.map(one, (tiles(o), tiles(d), tiles(t_min), tiles(t_max)))
    return tuple(x.reshape((padded,) + x.shape[2:])[:R] for x in outs)


def _finalize4(blas4: BLAS4, best_prim, t_maxed, u, v, batch) -> HitResult:
    hit = best_prim >= 0
    tri = _mask_triangle(gather_triangles(blas4.prims, best_prim), hit)
    bary = jnp.where(hit[..., None], jnp.stack([1 - u - v, u, v], -1), 0.0)
    res = HitResult(hit=hit, triangle=tri, t=jnp.where(hit, t_maxed, 0.0),
                    barycentric=bary,
                    prim_idx=jnp.where(hit, best_prim, -1),
                    instance_idx=jnp.where(hit, 0, -1))
    return jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)


def closest_hit4(blas4: BLAS4, rays: Ray, *, stack_size: int = 48,
                 tile_size: int = 16384, max_iters: int = 1 << 17) -> HitResult:
    """Closest hit on a single (non-instanced) BLAS4 (reference
    closest_hit4, src/bvh4.jl:606-700)."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o = flat(rays.o)
    d = jnp.where(rays.d == 0.0, 0.0, rays.d).reshape(o.shape)
    out = _trace4(blas4, o, d, flat(rays.t_min), flat(rays.t_max),
                  any_hit=False, stack_size=stack_size, max_iters=max_iters,
                  tile_size=min(tile_size, max(o.shape[0], 8)))
    return _finalize4(blas4, *out, batch=batch)


def any_hit4(blas4: BLAS4, rays: Ray, *, stack_size: int = 48,
             tile_size: int = 16384, max_iters: int = 1 << 17) -> HitResult:
    """First-hit query on a BLAS4; forces t_min = 0 (reference any_hit4,
    src/bvh4.jl:707-766)."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o = flat(rays.o)
    d = jnp.where(rays.d == 0.0, 0.0, rays.d).reshape(o.shape)
    t_min = jnp.zeros(o.shape[:1], jnp.float32)
    out = _trace4(blas4, o, d, t_min, flat(rays.t_max),
                  any_hit=True, stack_size=stack_size, max_iters=max_iters,
                  tile_size=min(tile_size, max(o.shape[0], 8)))
    return _finalize4(blas4, *out, batch=batch)

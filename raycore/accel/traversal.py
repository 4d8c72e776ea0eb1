"""Two-level BVH traversal as a vectorized wavefront.

Array-parallel re-expression of the reference's per-thread divergent stack
machine (reference: closest_hit/any_hit, src/instanced-bvh.jl:1902-2140).
Semantics are identical — same near/far child ordering, the same
TOP_LEVEL_SENTINEL instance transitions, Möller–Trumbore leaf tests against
inline vertices, t_max shrinking on hit, any_hit forcing t_min=0 and
terminating on first hit — but the machine is lane-parallel: every ray in a
tile advances one traversal step per iteration of one `lax.while_loop`,
with per-lane masks in place of branches and one packed-row gather per step.

The node fetch is one gather from `unified_nodes` (TLAS block first, then
all BLAS blocks), so TLAS-vs-BLAS selection is just a row base, not a
branch. Ray tiles are processed with `lax.map` so early-converging tiles
retire without waiting for global stragglers.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.ray import Ray
from ..core.bounds import fast_intersect_bbox
from ..core.transforms import transform_point_3x4, transform_direction_3x4
from ..core.triangle import fast_intersect_triangle, safe_invdir
from .brute import HitResult, gather_triangles, _mask_triangle
from .types import (INVALID_NODE, TOP_LEVEL_SENTINEL, StaticTLAS,
                    f32_as_i32, i32_as_f32)

_INVALID = jnp.int32(INVALID_NODE)
_SENTINEL = jnp.int32(TOP_LEVEL_SENTINEL)


def _traverse_tile(tlas: StaticTLAS, o_w, d_w, t_min, t_max0, *,
                   any_hit: bool, stack_size: int, max_iters: int,
                   substeps: int = 4):
    """Run the wavefront stack machine for one tile of rays.

    Returns (best_inst, best_prim, t, u, v): best_inst/prim are -1 on miss.
    All inputs are flat (R, ...) arrays; R is static.
    """
    R = o_w.shape[0]
    nodes = tlas.unified_nodes
    inst_inv = tlas.instances.inv_transform
    inst_blas = tlas.instances.blas_index
    blas_base = tlas.blas_nodes_offset
    invd_w = safe_invdir(d_w)

    init = dict(
        node=jnp.zeros((R,), jnp.int32),                 # TLAS root
        base=jnp.zeros((R,), jnp.int32),
        inst=jnp.full((R,), -1, jnp.int32),
        stack=jnp.full((R, stack_size), _INVALID, jnp.int32),
        sptr=jnp.zeros((R,), jnp.int32),                 # stack[0] = INVALID
        o=o_w, d=d_w, invd=invd_w,
        t_max=t_max0,
        best_inst=jnp.full((R,), -1, jnp.int32),
        best_prim=jnp.full((R,), -1, jnp.int32),
        best_u=jnp.zeros((R,), jnp.float32),
        best_v=jnp.zeros((R,), jnp.float32),
        iters=jnp.int32(0),
        ovf=jnp.zeros((), bool),     # any lane pushed past the stack top
    )

    def cond(s):
        # An overflowed tile terminates immediately: its results are
        # discarded (the caller re-runs with the proven-depth stack), and
        # a corrupted stack could otherwise cycle until max_iters.
        return jnp.any(s["node"] != _INVALID) & (s["iters"] < max_iters) \
            & ~s["ovf"]

    def body(s):
        node, base, inst = s["node"], s["base"], s["inst"]
        o, d, invd, t_max = s["o"], s["d"], s["invd"], s["t_max"]
        active = node != _INVALID

        # --- fetch packed node row (single gather) ----------------------
        row = jnp.clip(base + node, 0, nodes.shape[0] - 1)
        nfi = jnp.take(nodes, row, axis=0)               # (R, 16) int32
        nf = i32_as_f32(nfi[:, :12])                     # float fields
        c0 = nfi[:, 12]
        c1 = nfi[:, 13]
        is_leaf = c0 == _INVALID
        is_top = inst < 0

        case_internal = active & ~is_leaf
        case_tlas_leaf = active & is_leaf & is_top
        case_blas_leaf = active & is_leaf & ~is_top

        # --- internal: ordered two-child slab test ----------------------
        # (reference intersect_internal_node, src/instanced-bvh.jl:1807-1832)
        t0min, t0max = fast_intersect_bbox(o, invd, nf[:, 0:3], nf[:, 3:6],
                                           t_min, t_max)
        t1min, t1max = fast_intersect_bbox(o, invd, nf[:, 6:9], nf[:, 9:12],
                                           t_min, t_max)
        trav0 = jnp.where(t0min <= t0max, c0, _INVALID)
        trav1 = jnp.where(t1min <= t1max, c1, _INVALID)
        first0 = (t0min < t1min) & (trav0 != _INVALID)
        near = jnp.where(first0, trav0, trav1)
        far = jnp.where(first0, trav1, trav0)

        # --- BLAS leaf: Möller–Trumbore on inline vertices --------------
        h, t, u, v = fast_intersect_triangle(
            o, d, nf[:, 0:3], nf[:, 3:6], nf[:, 6:9], t_min, t_max)
        h = h & case_blas_leaf
        t_max = jnp.where(h, t, t_max)
        best_inst = jnp.where(h, inst, s["best_inst"])
        best_prim = jnp.where(h, c1, s["best_prim"])
        best_u = jnp.where(h, u, s["best_u"])
        best_v = jnp.where(h, v, s["best_v"])

        # --- TLAS leaf: enter instance ----------------------------------
        enter = case_tlas_leaf
        new_inst = jnp.clip(c1, 0, inst_inv.shape[0] - 1)
        inv_t = jnp.take(inst_inv, new_inst, axis=0)      # (R, 3, 4)
        bidx = jnp.clip(jnp.take(inst_blas, new_inst, axis=0), 0,
                        blas_base.shape[0] - 1)
        new_base = jnp.take(blas_base, bidx, axis=0)
        o_loc = transform_point_3x4(inv_t, o_w)
        d_loc = transform_direction_3x4(inv_t, d_w)

        # --- stack push (far child or sentinel) -------------------------
        do_push = (case_internal & (far != _INVALID)) | enter
        push_val = jnp.where(enter, _SENTINEL, far)
        sptr1 = jnp.where(do_push, s["sptr"] + 1, s["sptr"])
        # A push past the top would silently overwrite the top slot and
        # drop a far child (wrong closer-miss, no error). Detect it; the
        # eager wrappers re-run with the proven-depth stack (VERDICT r1
        # #10). The clip below keeps indices in range either way.
        ovf = s["ovf"] | jnp.any(do_push & (sptr1 > stack_size - 1))
        # Row scatter, not a masked full rewrite: the (R, stack_size)
        # where-write moved ~4 MB per step per 16K-ray tile (the loop
        # carry is rewritten each iteration); writing the one touched
        # slot per lane is stack_size x less traffic. Non-push lanes
        # write back their old top value (a no-op store).
        widx = jnp.clip(sptr1, 0, stack_size - 1)
        old_top = jnp.take_along_axis(s["stack"], widx[:, None],
                                      axis=1)[:, 0]
        stack = s["stack"].at[
            jnp.arange(R, dtype=jnp.int32), widx].set(
                jnp.where(do_push, push_val, old_top))

        # --- choose next node: descend or pop ---------------------------
        if any_hit:
            # First hit terminates the lane (reference any_hit early return).
            lane_done = h
        else:
            lane_done = jnp.zeros_like(h)

        descend = ((case_internal & (near != _INVALID)) | enter) & ~lane_done
        need_pop = active & ~descend & ~lane_done

        top_idx = jnp.clip(sptr1, 0, stack_size - 1)
        top = jnp.take_along_axis(stack, top_idx[:, None], axis=1)[:, 0]
        sptr2 = sptr1 - 1
        hit_sent = need_pop & (top == _SENTINEL)
        top2_idx = jnp.clip(sptr2, 0, stack_size - 1)
        top2 = jnp.take_along_axis(stack, top2_idx[:, None], axis=1)[:, 0]
        popped = jnp.where(hit_sent, top2, top)
        sptr2 = jnp.where(hit_sent, sptr2 - 1, sptr2)

        node_next = jnp.where(lane_done, _INVALID,
                              jnp.where(descend,
                                        jnp.where(enter, jnp.int32(0), near),
                                        jnp.where(need_pop, popped, node)))
        sptr_next = jnp.where(need_pop, sptr2, sptr1)

        leave = hit_sent                                  # back to top level
        inst_next = jnp.where(enter, new_inst, jnp.where(leave, -1, inst))
        base_next = jnp.where(enter, new_base, jnp.where(leave, 0, base))
        pick3 = lambda en, a, lv, b, c: jnp.where(en[:, None], a,
                                                  jnp.where(lv[:, None], b, c))
        o_next = pick3(enter, o_loc, leave, o_w, o)
        d_next = pick3(enter, d_loc, leave, d_w, d)
        invd_next = jnp.where(enter[:, None], safe_invdir(d_loc),
                              jnp.where(leave[:, None], invd_w, invd))

        return dict(node=node_next, base=base_next, inst=inst_next,
                    stack=stack, sptr=sptr_next,
                    o=o_next, d=d_next, invd=invd_next, t_max=t_max,
                    best_inst=best_inst, best_prim=best_prim,
                    best_u=best_u, best_v=best_v,
                    iters=s["iters"] + 1, ovf=ovf)

    def multi_body(s):
        # Unroll several traversal steps per while iteration: the carried
        # state (stack, rays, bests) is rewritten once per iteration, so
        # unrolling amortizes that HBM traffic over `substeps` node visits.
        for _ in range(substeps):
            s = body(s)
        return s

    out = jax.lax.while_loop(cond, multi_body, init)
    return (out["best_inst"], out["best_prim"], out["t_max"],
            out["best_u"], out["best_v"],
            jnp.broadcast_to(out["ovf"], (R,)))


def _finalize(tlas: StaticTLAS, best_inst, best_prim, t_maxed, u, v,
              batch_shape) -> HitResult:
    hit = best_inst >= 0
    bidx = jnp.clip(jnp.take(tlas.instances.blas_index,
                             jnp.clip(best_inst, 0, None), axis=0), 0,
                    tlas.blas_prims_offset.shape[0] - 1)
    prim_row = jnp.take(tlas.blas_prims_offset, bidx, axis=0) \
        + jnp.clip(best_prim, 0, None)
    tri = _mask_triangle(gather_triangles(tlas.prims, prim_row), hit)
    bary = jnp.where(hit[..., None],
                     jnp.stack([1.0 - u - v, u, v], axis=-1), 0.0)
    res = HitResult(
        hit=hit, triangle=tri,
        t=jnp.where(hit, t_maxed, 0.0), barycentric=bary,
        prim_idx=jnp.where(hit, best_prim, -1),
        instance_idx=jnp.where(hit, best_inst, -1))
    reshape = lambda a: a.reshape(batch_shape + a.shape[1:])
    return jax.tree_util.tree_map(reshape, res)


@partial(jax.jit, static_argnames=("any_hit", "stack_size", "max_iters",
                                   "tile_size", "substeps", "force_tmin0"))
def _trace(tlas: StaticTLAS, o, d, t_min, t_max, *, any_hit: bool,
           stack_size: int, max_iters: int, tile_size: int,
           substeps: int = 4, force_tmin0: bool = False):
    """End-to-end jitted: check_direction, pad, tile loop, finalize —
    one dispatch (eager glue costs a dispatch per op)."""
    R0 = o.shape[0]
    d = jnp.where(d == 0.0, 0.0, d)
    if force_tmin0:
        t_min = jnp.zeros_like(t_min)
    R = o.shape[0]
    n_tiles = max(1, -(-R // tile_size))
    padded = n_tiles * tile_size
    if padded != R:
        padf = lambda a, fill: jnp.concatenate(
            [a, jnp.full((padded - R,) + a.shape[1:], fill, a.dtype)])
        o = padf(o, 0.0)
        d = padf(d, 1.0)
        t_min = padf(t_min, 0.0)
        t_max = padf(t_max, -1.0)   # never hits; tile lane retires instantly

    tiles = lambda a: a.reshape((n_tiles, tile_size) + a.shape[1:])

    def one(tile):
        to, td, tn, tx = tile
        return _traverse_tile(tlas, to, td, tn, tx, any_hit=any_hit,
                              stack_size=stack_size, max_iters=max_iters,
                              substeps=substeps)

    outs = jax.lax.map(one, (tiles(o), tiles(d), tiles(t_min), tiles(t_max)))
    flat = tuple(x.reshape((padded,) + x.shape[2:])[:R0] for x in outs[:5])
    return _finalize(tlas, *flat, batch_shape=(R0,)), jnp.any(outs[5])


def stack_depth_bound(tlas: StaticTLAS) -> int:
    """Proven worst-case traversal stack need. A Karras radix tree over
    n leaves with 30-bit codes + index tiebreak has root-leaf depth
    <= 30 + ceil(log2 n): every path step either consumes a code bit or
    bisects a duplicate-code run by index (karras_topology's delta
    tiebreak, accel/lbvh.py). Stack occupancy <= TLAS depth + 1 sentinel
    + BLAS depth; unified_nodes row count bounds both leaf counts."""
    import math
    n = max(int(tlas.unified_nodes.shape[0]), 2)
    per_level = 30 + math.ceil(math.log2(n))
    return 2 * per_level + 2


def _query(tlas, rays, *, any_hit: bool, stack_size: int, tile_size: int,
           max_iters: int, substeps: int, force_tmin0: bool) -> HitResult:
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o = flat(rays.o)
    bound = stack_depth_bound(tlas)
    if isinstance(o, jax.core.Tracer):
        # Inside a caller's jit we cannot read the overflow flag; use the
        # proven-depth stack up front so overflow is impossible.
        stack_size = max(stack_size, bound)
    args = (tlas, o, flat(rays.d), flat(rays.t_min), flat(rays.t_max))
    kw = dict(any_hit=any_hit, max_iters=max_iters,
              tile_size=min(tile_size, max(o.shape[0], 8)),
              substeps=substeps, force_tmin0=force_tmin0)
    res, ovf = _trace(*args, stack_size=stack_size, **kw)
    if not isinstance(ovf, jax.core.Tracer) and stack_size < bound \
            and bool(ovf):
        # A push ran past the stack top: the short-stack result may have
        # dropped far children. Re-run once with the proven-depth stack
        # (cannot overflow); costs one recompile, triggers only on
        # adversarially deep trees.
        res, ovf = _trace(*args, stack_size=bound, **kw)
        assert not bool(ovf), "traversal overflowed its proven stack bound"
    return jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)


def closest_hit(tlas: StaticTLAS, rays: Ray, *, stack_size: int = 64,
                tile_size: int = 16384, max_iters: int = 1 << 17,
                substeps: int = 4) -> HitResult:
    """Closest-hit query over a batched Ray (reference closest_hit,
    src/instanced-bvh.jl:1902-2023). Returns a HitResult pytree with the
    ray batch shape; zero-triangle sentinel and -1 indices on miss.

    Stack safety: overflow of the fast 64-slot stack is detected in-loop
    and the query transparently re-runs with the proven-depth stack
    (`stack_depth_bound`); under tracing the proven bound is used up
    front, so results are exact either way."""
    return _query(tlas, rays, any_hit=False, stack_size=stack_size,
                  tile_size=tile_size, max_iters=max_iters,
                  substeps=substeps, force_tmin0=False)


def any_hit(tlas: StaticTLAS, rays: Ray, *, stack_size: int = 64,
            tile_size: int = 16384, max_iters: int = 1 << 17,
            substeps: int = 4) -> HitResult:
    """First-hit occlusion query; forces t_min = 0 like the reference
    (src/instanced-bvh.jl:2045) and terminates each lane on its first hit.
    The reported hit is traversal-order-first, not closest — only the
    boolean and occluder identity are contractual."""
    return _query(tlas, rays, any_hit=True, stack_size=stack_size,
                  tile_size=tile_size, max_iters=max_iters,
                  substeps=substeps, force_tmin0=True)

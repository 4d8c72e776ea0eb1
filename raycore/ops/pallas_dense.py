"""Tile worklist engine for the dense clustered scene.

The XLA rounds engine (accel/dense.py) pays for S clusters per tile per
round even when a tile needs one. This engine removes that waste with a
compacted worklist: phase A interval-culls every (ray-tile, cluster)
pair, the qualifying pairs are enumerated once sorted by tile, and the
sweep kernel (ops/sweep.py) walks each tile's run with the per-ray best
(t-bits key, prim) in registers. Exact (u, v, t) for the single winning
triangle are recomputed in finalize_hits_exact.

The kernel's grid is one program per ray-tile row chunk, so it does not
depend on the worklist length: the queries here need no host sync.
"""
from __future__ import annotations

import os as _os
from functools import partial

import jax
import jax.numpy as jnp

from ..core.triangle import safe_invdir
from ..core.triangle import INV_DIR_CLAMP as _INV_DIR_CLAMP
from .sweep import (COL_TMAX, COL_TMIN, INT32_MAX, occlude_tiles,
                    sweep_tiles)


def _t_from_keys(key):
    """Decode a t-bits key (INT32_MAX, the no-hit key, decodes to NaN)."""
    return jax.lax.bitcast_convert_type(key, jnp.float32)


def bundle_entry_vs_bounds(olo, ohi, ilo, ihi, tlo, thi, bmin, bmax):
    """Conservative ray-bundle vs AABB interval test, elementwise over
    matching leading shapes: the bundle's entry t lower bound, or +inf
    when provably no ray of the bundle enters the box.

    olo/ohi: origin bounds, ilo/ihi: safe_invdir bounds (..., 3);
    tlo/thi: t_min lower / t_max upper bound (...); bmin/bmax (..., 3)."""
    shape = jnp.broadcast_shapes(olo[..., 0].shape, bmin[..., 0].shape)
    t_lo = jnp.full(shape, -jnp.inf)
    t_hi = jnp.full(shape, jnp.inf)
    CL = jnp.float32(_INV_DIR_CLAMP)   # exact safe_invdir clamp
    for a in range(3):
        lo8 = jnp.full(shape, jnp.inf)
        hi8 = jnp.full(shape, -jnp.inf)
        for b in (bmin[..., a], bmax[..., a]):
            for oc in (olo[..., a], ohi[..., a]):
                diff = b - oc
                for ic in (ilo[..., a], ihi[..., a]):
                    prod = diff * ic
                    lo8 = jnp.minimum(lo8, prod)
                    hi8 = jnp.maximum(hi8, prod)
        # Clamped-invdir slab tests falsely evict near-parallel rays whose
        # origin sits inside the slab within ~t*1e-5 of a face (see
        # dense._phase_a_tile_entry); widen the axis for such bundles.
        par = (ihi[..., a] >= CL) | (ilo[..., a] <= -CL)
        ovl = (ohi[..., a] >= bmin[..., a]) & (olo[..., a] <= bmax[..., a])
        wide = par & ovl
        t_lo = jnp.maximum(t_lo, jnp.where(wide, -jnp.inf, lo8))
        t_hi = jnp.minimum(t_hi, jnp.where(wide, jnp.inf, hi8))
    entry = jnp.maximum(t_lo, tlo)
    exit_ = jnp.minimum(t_hi, thi)
    return jnp.where(entry <= exit_, entry, jnp.inf)


def phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE):
    """Tile stats + interval culling -> (n_tiles, K) entry bounds."""
    return phase_a_entry_bounds(scene.cluster_min, scene.cluster_max,
                                o, d, t_min, t_max, n_tiles, TILE)


def phase_a_entry_bounds(bounds_min, bounds_max, o, d, t_min, t_max,
                         n_tiles, TILE):
    """phase_a_entry against arbitrary (K, 3) AABBs — the instanced
    engine culls against per-instance world AABBs with the same test.
    One elementwise broadcast over (tiles, boxes), fused by XLA."""
    invd = safe_invdir(jnp.where(d == 0.0, 0.0, d))
    shp = lambda a: a.reshape((n_tiles, TILE) + a.shape[1:])
    o_t, invd_t = shp(o), shp(invd)
    col = lambda a: a[:, None]
    return bundle_entry_vs_bounds(
        col(jnp.min(o_t, axis=1)), col(jnp.max(o_t, axis=1)),
        col(jnp.min(invd_t, axis=1)), col(jnp.max(invd_t, axis=1)),
        col(jnp.min(shp(t_min), axis=1)), col(jnp.max(shp(t_max), axis=1)),
        bounds_min[None], bounds_max[None])


def compact_indices(flat, cap: int):
    """Indices of the first ``cap`` True flags, in order, plus the true
    count. Entries past the count are 0 (callers mask on ``arange < total``).

    Two lowerings, RAYCORE_WORKLIST={argsort (default) | scatter}: a
    stable argsort of the flags, or cumsum positions + one ordered
    scatter (O(N) bandwidth)."""
    N = flat.shape[0]
    total = jnp.sum(flat.astype(jnp.int32))
    if _os.environ.get("RAYCORE_WORKLIST", "argsort") == "argsort":
        order = jnp.argsort(~flat, stable=True)
        return order[:cap], total
    pos = jnp.cumsum(flat.astype(jnp.int32)) - 1     # in-order positions
    idx = jnp.where(flat, pos, cap)                  # invalid -> dropped
    sel = jnp.zeros((cap,), jnp.int32).at[idx].set(
        jnp.arange(N, dtype=jnp.int32), mode="drop")
    return sel, total


def build_worklist(entry, max_pairs: int):
    """From the (n_tiles, K) conservative entry matrix, emit (tids, cids)
    for every finite-entry pair, sorted by tile (finite pairs first).
    Invalid/overflow rows get ``tid = n_tiles`` (past the last tile, so
    the sweep never visits them). Returns (tids, cids, total) — the
    caller must check total <= max_pairs."""
    n_tiles, K = entry.shape
    finite = jnp.isfinite(entry)
    flat = finite.reshape(-1)
    sel, total = compact_indices(flat, max_pairs)
    valid = jnp.arange(max_pairs) < total
    tids = jnp.where(valid, (sel // K).astype(jnp.int32), n_tiles)
    cids = jnp.where(valid, (sel % K).astype(jnp.int32), 0)
    return tids, cids, total


def _pad_to_tiles(o, d, t_min, t_max, TILE):
    """Pad the flat ray batch to whole tiles with rays that hit nothing."""
    d = jnp.where(d == 0.0, 0.0, d)
    pad = (-o.shape[0]) % TILE
    if pad:
        ext = lambda a, f: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], f, a.dtype)])
        o, d = ext(o, 0.0), ext(d, 1.0)
        t_min, t_max = ext(t_min, 0.0), ext(t_max, -jnp.inf)
    return o, d, t_min, t_max


def _ray_table(o, d, t_min, t_max):
    """(R, FEAT) ray features with t_min / t_max in columns 13 / 14."""
    from ..accel.dense import ray_features
    return ray_features(o, d).at[:, COL_TMIN].set(t_min) \
        .at[:, COL_TMAX].set(t_max)


def _no_hits(R: int):
    return (jnp.full((R,), INT32_MAX, jnp.int32),
            jnp.full((R,), -1, jnp.int32))


def _sweep(scene, tids, cids, tbl, key0, pair0, TILE):
    return sweep_tiles(tids, cids, tbl, key0, pair0, scene.tri_feats,
                       TILE=TILE, C=scene.cluster_size, SUB=scene.sub_chunks)


def _one_pass(scene, o, d, t_min, t_max, *, TILE: int, max_pairs: int):
    """One-pass query: pad -> interval phase A -> worklist -> sweep ->
    finalize. Returns (result, pair total)."""
    from ..accel.dense import finalize_hits_exact
    R0 = o.shape[0]
    o, d, t_min, t_max = _pad_to_tiles(o, d, t_min, t_max, TILE)
    n_tiles = o.shape[0] // TILE
    entry = phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE)
    tids, cids, total = build_worklist(entry, max_pairs)
    key, pair = _sweep(scene, tids, cids, _ray_table(o, d, t_min, t_max),
                       *_no_hits(o.shape[0]), TILE)
    res = finalize_hits_exact(scene, pair[:R0], _t_from_keys(key[:R0]),
                              o[:R0], d[:R0])
    return res, total


_pallas_query = jax.jit(_one_pass, static_argnames=("TILE", "max_pairs"))


def _toppass_worklist(entry, S1: int):
    """Per-tile nearest-S1 selection, emitted tile-major (already sorted).
    Returns (tids, cids, remaining_entry)."""
    n_tiles, K = entry.shape
    e = entry
    cids = []
    rows = jnp.arange(n_tiles)
    for _ in range(S1):
        cid = jnp.argmin(e, axis=1)
        cids.append(cid)
        e = e.at[rows, cid].set(jnp.inf)
    cids = jnp.stack(cids, axis=1)                     # (n_tiles, S1)
    sel_entry = jnp.take_along_axis(entry, cids, axis=1)
    valid = jnp.isfinite(sel_entry)
    tids = jnp.where(valid, rows[:, None], n_tiles).reshape(-1)
    cids = jnp.where(valid, cids, 0).reshape(-1)
    # Tile-major but invalids interleaved; sort by tid to group dummies last.
    order = jnp.argsort(tids, stable=True)
    return tids[order].astype(jnp.int32), cids[order].astype(jnp.int32), e


@partial(jax.jit, static_argnames=("TILE", "max_pairs", "S1"))
def _pallas_query2(scene, o, d, t_min, t_max, *, TILE: int, max_pairs: int,
                   S1: int):
    """Two-pass pruned query: nearest-S1 clusters per tile first, then only
    the candidates whose conservative entry can still beat some ray's best."""
    from ..accel.dense import finalize_hits_exact
    R0 = o.shape[0]
    o, d, t_min, t_max = _pad_to_tiles(o, d, t_min, t_max, TILE)
    n_tiles = o.shape[0] // TILE
    entry = phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE)
    tbl = _ray_table(o, d, t_min, t_max)

    # Pass 1: nearest S1 clusters per tile (no sort, fixed count).
    tids1, cids1, entry_rest = _toppass_worklist(entry, S1)
    key, pair = _sweep(scene, tids1, cids1, tbl, *_no_hits(o.shape[0]),
                       TILE)

    # Pass 2: remaining candidates that could still beat a ray in the
    # tile (a ray without a hit yet bounds at its own t_max).
    t = jnp.where(pair >= 0, _t_from_keys(key), t_max)
    tile_best_max = jnp.max(t.reshape(n_tiles, TILE), axis=1)
    entry2 = jnp.where(entry_rest <= tile_best_max[:, None], entry_rest,
                       jnp.inf)
    tids2, cids2, total2 = build_worklist(entry2, max_pairs)
    # Pass 2 seeds its carried bests from pass 1 (key AND pair), so its
    # outputs are already the merged result for every row.
    key, pair = _sweep(scene, tids2, cids2, tbl, key, pair, TILE)
    res = finalize_hits_exact(scene, pair[:R0], _t_from_keys(key[:R0]),
                              o[:R0], d[:R0])
    return res, total2


@partial(jax.jit, static_argnames=("TILE",))
def _auto_query(scene, o, d, t_min, t_max, *, TILE: int):
    """Every candidate pair, one dispatch (capacity = the hard bound)."""
    n_tiles = -(-o.shape[0] // TILE)
    return _one_pass(scene, o, d, t_min, t_max, TILE=TILE,
                     max_pairs=n_tiles * scene.n_clusters)[0]


def closest_hit_dense_pallas_auto(scene, rays, *, tile: int = 512):
    """Closest hit over every conservative candidate pair: the worklist
    capacity is the hard bound (tiles x clusters), so it never overflows
    and needs no host sync. The production entry point for renderers
    (see accel/dispatch.py)."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o = flat(rays.o)
    TILE = min(tile, max(o.shape[0], 8))
    res = _auto_query(scene, o, flat(rays.d), flat(rays.t_min),
                      flat(rays.t_max), TILE=TILE)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)


@partial(jax.jit, static_argnames=("TILE",))
def _occl_query(scene, o, d, t_max, *, TILE: int):
    from ..accel.dense import _hit_instance_idx
    from ..accel.brute import HitResult
    from ..core.triangle import Triangle
    R0 = o.shape[0]
    t_min = jnp.zeros_like(t_max)
    o, d, t_min, t_max = _pad_to_tiles(o, d, t_min, t_max, TILE)
    n_tiles = o.shape[0] // TILE
    entry = phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE)
    tids, cids, _ = build_worklist(entry, n_tiles * scene.n_clusters)
    pair = occlude_tiles(tids, cids, _ray_table(o, d, t_min, t_max),
                         scene.tri_feats, TILE=TILE, C=scene.cluster_size,
                         SUB=scene.sub_chunks)[:R0]
    hit = pair >= 0
    # Translate the table-space winner to its original index (one tiny
    # R-row gather of the hot original-index column).
    ids = jnp.take(scene.prims_hot[:, 10], jnp.clip(pair, 0, None))
    orig = jnp.where(hit, ids, -1)
    z3 = jnp.zeros((R0, 3, 3), jnp.float32)
    tri = Triangle(vertices=z3, normals=z3, tangents=z3,
                   uv=jnp.zeros((R0, 3, 2), jnp.float32),
                   metadata=jnp.zeros((R0,), jnp.uint32))
    return HitResult(hit=hit, triangle=tri,
                     t=jnp.zeros((R0,), jnp.float32),
                     barycentric=jnp.zeros((R0, 3), jnp.float32),
                     prim_idx=orig,
                     instance_idx=_hit_instance_idx(scene, orig, hit))


def any_hit_dense_pallas_auto(scene, rays, *, tile: int = 512):
    """Occlusion query via the occlusion sweep: first accepted candidate
    wins, no best-t carry, no payload gather — the boolean, occluder
    prim and instance are contractual (t/bary/triangle are zeros;
    reference any_hit early-exit semantics, src/instanced-bvh.jl:
    2034-2140). Forces t_min = 0 like the reference. Sweeps every
    conservative candidate pair; no host sync."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o = flat(rays.o)
    TILE = min(tile, max(o.shape[0], 8))
    res = _occl_query(scene, o, flat(rays.d), flat(rays.t_max), TILE=TILE)
    return jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)


def closest_hit_dense_pallas(scene, rays, *, tile: int = 256,
                             max_pairs_per_tile: int = 24,
                             check_overflow: bool = True,
                             passes: int = 2, nearest_first: int = 4):
    """Closest hit via the tile worklist sweep with a fixed capacity.

    passes=2 (default): nearest-``nearest_first`` clusters per tile first,
    then only candidates whose conservative entry can still beat a found
    hit — the best-t pruning the one-pass variant lacks. passes=1 tests
    every conservative candidate. ``check_overflow=False`` skips the host
    sync on the pair count (use when capacity is known ample)."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o = flat(rays.o)
    R = o.shape[0]
    TILE = min(tile, max(R, 8))
    n_tiles = -(-R // TILE)
    max_pairs = min(max_pairs_per_tile * n_tiles,
                    n_tiles * scene.n_clusters)
    args = (scene, o, flat(rays.d), flat(rays.t_min), flat(rays.t_max))
    if passes == 2:
        res, total = _pallas_query2(*args, TILE=TILE, max_pairs=max_pairs,
                                    S1=nearest_first)
    else:
        res, total = _pallas_query(*args, TILE=TILE, max_pairs=max_pairs)
    if check_overflow and int(total) > max_pairs:
        raise RuntimeError(
            f"worklist overflow: {int(total)} pairs > capacity {max_pairs}; "
            f"raise max_pairs_per_tile")
    return jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)

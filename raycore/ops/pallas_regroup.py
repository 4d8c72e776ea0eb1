"""Cluster-major regrouped sweep — per-subgroup candidate lists.

The tile worklist engine (pallas_dense.py) tests each candidate cluster
against a whole ray tile, so every ray pays for the union of its tile's
candidates. This engine shrinks the candidate granularity to G=32-ray
*subgroups*:

  1. Coarse phase A (per-tile interval culling) emits (tile, cluster)
     pairs.
  2. Each surviving pair is refined against the tile's TILE/G subgroups
     (same interval test on per-subgroup stats) — pure XLA, ~60 flops
     per (pair, subgroup).
  3. Surviving (subgroup, cluster) candidates are sorted cluster-major
     and packed into blocks of SPB=16 subgroups that all need the SAME
     cluster; each cluster's list is padded to a block boundary with
     dummy-subgroup slots.
  4. The sweep kernel (ops/sweep.py) gathers each block's ray-table rows,
     runs the featurized Möller–Trumbore product against the cluster's
     triangles chunk by chunk in registers, and writes per-row (t-bits
     key, prim) exactly once.
  5. A ray appears once per candidate cluster, so duplicates are merged
     outside the kernel: sort rows by (ray, key) + take the first per
     ray (or segment_min), then one scatter back to ray order.

Semantics match the tile worklist engine (same featurized MT with
EDGE_EPS slack, same exact scalar finalize): keys carry full-precision t
bits, so the winner is the strict closest hit up to featurized-evaluation
rounding. Candidate sets stay conservative supersets of the reachable
clusters per ray, so results stay exact.

Reference hot-loop parity target: fast_intersect_triangle semantics
(reference src/instanced-bvh.jl:1756-1797) via the featurized bilinear
forms of accel/dense.py.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import os as _os

from . import capacity_store as _cap_store
from ..core.triangle import safe_invdir
from ..core.triangle import INV_DIR_CLAMP as _INV_DIR_CLAMP
from .pallas_dense import _t_from_keys, build_worklist, phase_a_entry
# Ray-table layout: ray_features cols 0:13 (d, o x d, o, 1, invd) plus
# t_min in col 13 and t_max in col 14 (the sweep reads only cols 0:10 for
# the product).
from .sweep import COL_TMAX, COL_TMIN, FEAT, INT32_MAX, sweep_regrouped


def ray_table(o, d, t_min, t_max, G: int):
    """(n_sub + 1, G, FEAT) per-subgroup ray table; the trailing dummy
    subgroup (zeros, t_max=-inf) absorbs padding slots."""
    from ..accel.dense import ray_features
    R = o.shape[0]
    n_sub = R // G
    phi = ray_features(o, d)
    phi = phi.at[:, COL_TMIN].set(t_min)
    phi = phi.at[:, COL_TMAX].set(t_max)
    tbl = phi.reshape(n_sub, G, FEAT)
    dummy = jnp.zeros((1, G, FEAT), jnp.float32) \
        .at[:, :, COL_TMAX].set(-jnp.inf)
    return jnp.concatenate([tbl, dummy])


def subgroup_stats(o, d, t_min, t_max, G: int):
    """(n_tiles*, SPT-grouped) interval stats per G-ray subgroup:
    cols [o_lo(3) o_hi(3) i_lo(3) i_hi(3) tmin_lo tmax_hi] -> (n_sub, 14)."""
    R = o.shape[0]
    n_sub = R // G
    invd = safe_invdir(jnp.where(d == 0.0, 0.0, d))
    shp = lambda a: a.reshape((n_sub, G) + a.shape[1:])
    o_t, i_t = shp(o), shp(invd)
    return jnp.concatenate([
        jnp.min(o_t, 1), jnp.max(o_t, 1),
        jnp.min(i_t, 1), jnp.max(i_t, 1),
        jnp.min(shp(t_min), 1)[:, None],
        jnp.max(shp(t_max), 1)[:, None]], axis=1)


def refine_pairs(stats, tids, cids, cluster_min, cluster_max,
                 SPT: int, n_tiles: int):
    """Interval-test each coarse (tile, cluster) pair against the tile's
    SPT subgroups. Returns (P, SPT) conservative entry bounds (+inf =
    provably no ray of the subgroup enters the cluster)."""
    P = tids.shape[0]
    n_sub = stats.shape[0]
    # Gather at tile granularity: one (SPT*14)-wide row per pair.
    stats_t = stats.reshape(n_tiles, SPT * 14)
    stats_t = jnp.concatenate(
        [stats_t, jnp.zeros((1, SPT * 14), jnp.float32)])    # dummy tile
    st = jnp.take(stats_t, jnp.minimum(tids, n_tiles), axis=0) \
        .reshape(P, SPT, 14)
    bmin = jnp.take(cluster_min, cids, axis=0)               # (P, 3)
    bmax = jnp.take(cluster_max, cids, axis=0)

    t_lo = jnp.full((P, SPT), -jnp.inf)
    t_hi = jnp.full((P, SPT), jnp.inf)
    CL = jnp.float32(_INV_DIR_CLAMP)   # exact safe_invdir clamp
    for a in range(3):
        lo8 = jnp.full((P, SPT), jnp.inf)
        hi8 = jnp.full((P, SPT), -jnp.inf)
        for b in (bmin[:, a:a + 1], bmax[:, a:a + 1]):       # (P, 1)
            for oc in (st[:, :, a], st[:, :, 3 + a]):        # (P, SPT)
                diff = b - oc
                for ic in (st[:, :, 6 + a], st[:, :, 9 + a]):
                    prod = diff * ic
                    lo8 = jnp.minimum(lo8, prod)
                    hi8 = jnp.maximum(hi8, prod)
        # Near-parallel rays inside the slab never exit it; the clamped
        # products say they exit at |o-b|*1e5, which can drop a truly hit
        # cluster (found at 1M scale, C=64: ~1e-4 of rays). Widen the
        # axis when the subgroup may contain such a ray.
        par = (st[:, :, 9 + a] >= CL) | (st[:, :, 6 + a] <= -CL)
        ovl = (st[:, :, 3 + a] >= bmin[:, a:a + 1]) \
            & (st[:, :, a] <= bmax[:, a:a + 1])
        wide = par & ovl
        t_lo = jnp.maximum(t_lo, jnp.where(wide, -jnp.inf, lo8))
        t_hi = jnp.minimum(t_hi, jnp.where(wide, jnp.inf, hi8))
    entry = jnp.maximum(t_lo, st[:, :, 12])
    exit_ = jnp.minimum(t_hi, st[:, :, 13])
    ok = (entry <= exit_) & (tids < n_tiles)[:, None]
    return jnp.where(ok, entry, jnp.inf)


def pack_presorted_cluster_major(cid_s, sub_s, valid_s, *, SPB: int,
                                 n_sub: int, B_cap: int, K: int):
    """Pack an ALREADY cluster-contiguous (cid, sub, valid) list into
    blocks of SPB subgroups — pure rank arithmetic, no sort. Requires
    equal cids adjacent and every invalid entry carrying cid >= K."""
    N = sub_s.shape[0]
    i = jnp.arange(N, dtype=jnp.int32)
    boundary = jnp.concatenate(
        [jnp.ones((1,), bool), cid_s[1:] != cid_s[:-1]])
    first = jax.lax.associative_scan(
        jnp.maximum, jnp.where(boundary, i, 0))
    rank = i - first
    slot = rank % SPB
    starts = valid_s & (slot == 0)
    block_id = jnp.cumsum(starts.astype(jnp.int32)) - 1
    total = jnp.sum(starts.astype(jnp.int32))
    block_id = jnp.where(valid_s, block_id, B_cap)          # drop invalid

    block_cid = jnp.full((B_cap,), -1, jnp.int32).at[
        jnp.where(starts, block_id, B_cap)].set(cid_s, mode="drop")
    block_subs = jnp.full((B_cap, SPB), n_sub, jnp.int32).at[
        block_id, slot].set(sub_s, mode="drop")
    return block_cid, block_subs, total


def group_flat_cluster_major(sub, cid, valid, *, SPB: int, n_sub: int,
                             B_cap: int, K: int):
    """Pack flat (subgroup, cluster) candidates into cluster-major blocks
    of SPB subgroups. Returns (block_cid (B_cap,), block_subs
    (B_cap, SPB), total_blocks). block_cid = -1 marks padding blocks;
    padding slots point at the dummy subgroup ``n_sub``."""
    cid_k = jnp.where(valid, cid, K)              # invalids sort last
    cid_s, sub_s = jax.lax.sort((cid_k, sub), num_keys=1, is_stable=False)
    valid_s = cid_s < K
    return pack_presorted_cluster_major(cid_s, sub_s, valid_s, SPB=SPB,
                                        n_sub=n_sub, B_cap=B_cap, K=K)


def group_cluster_major(tids, cids, fine_entry, *, SPT: int, SPB: int,
                        n_sub: int, B_cap: int, K: int):
    """group_flat_cluster_major over the (coarse pair x subgroup) grid."""
    P = tids.shape[0]
    N = P * SPT
    sub = (tids[:, None] * SPT
           + jnp.arange(SPT, dtype=jnp.int32)[None, :]).reshape(N)
    cid = jnp.broadcast_to(cids[:, None], (P, SPT)).reshape(N)
    valid = jnp.isfinite(fine_entry).reshape(N)
    return group_flat_cluster_major(sub, cid, valid, SPB=SPB, n_sub=n_sub,
                                    B_cap=B_cap, K=K)


def combine_rows_grouped(keys, pairs, block_subs, n_blocks: int, G: int,
                         SPB: int, n_sub: int):
    """Merge per-(subgroup, cluster) result rows into per-subgroup bests
    WITHOUT touching individual scalar rows: rows stay (subgroup-row, G)
    shaped, only the n_blocks*SPB subgroup ids are argsorted, then a
    sorted-segment min reduces each subgroup's duplicate rows (one per
    candidate cluster). ~10x cheaper than sorting the scalar rows.
    Returns per-ray (key, pair) of shape (n_sub*G,)."""
    n_rows = n_blocks * SPB
    kr = keys.reshape(n_rows, G)
    pr = pairs.reshape(n_rows, G)
    subs = block_subs[:n_blocks].reshape(n_rows)
    order = jnp.argsort(subs)
    subs_s = jnp.take(subs, order)
    kr = jnp.take(kr, order, axis=0)
    pr = jnp.take(pr, order, axis=0)
    # Sorted-segment min (measured ~3x cheaper than a log-shift segmented
    # min at these shapes); empty segments keep the INT32_MAX identity.
    kk = jax.ops.segment_min(kr, subs_s, num_segments=n_sub + 1,
                             indices_are_sorted=True)
    tied = kr == jnp.take(kk, subs_s, axis=0)
    pp = jax.ops.segment_min(jnp.where(tied, pr, INT32_MAX), subs_s,
                             num_segments=n_sub + 1,
                             indices_are_sorted=True)
    pp = jnp.where(pp == INT32_MAX, -1, pp)
    return kk[:n_sub].reshape(-1), pp[:n_sub].reshape(-1)


def combine_rows(keys, pairs, ray_ids, n_segments: int, method: str = "sort"):
    """Merge per-(subgroup, cluster) rows into per-ray bests.
    Rows with key == INT32_MAX (no candidate hit) and rows mapping to the
    dummy segment are naturally dropped (INT32_MAX decodes to NaN)."""
    if method == "segment":
        seg_key = jax.ops.segment_min(keys, ray_ids,
                                      num_segments=n_segments)
        pick = (keys == jnp.take(seg_key, ray_ids)) & (keys != INT32_MAX)
        seg_pair = jax.ops.segment_min(
            jnp.where(pick, pairs, INT32_MAX), ray_ids,
            num_segments=n_segments)
        seg_pair = jnp.where(seg_pair == INT32_MAX, -1, seg_pair)
        return seg_key, seg_pair
    # num_keys=3: exact-equal t resolves to the smallest prim index,
    # matching the brute oracle's first-wins argmin.
    rk, kk, pk = jax.lax.sort((ray_ids, keys, pairs), num_keys=3,
                              is_stable=False)
    pk = jnp.where(kk == INT32_MAX, -1, pk)       # no-candidate rows
    firstmask = jnp.concatenate([jnp.ones((1,), bool), rk[1:] != rk[:-1]])
    idx = jnp.where(firstmask, rk, n_segments)        # dups -> dropped
    out_key = jnp.full((n_segments,), INT32_MAX, jnp.int32).at[idx].set(
        kk, mode="drop")
    out_pair = jnp.full((n_segments,), -1, jnp.int32).at[idx].set(
        pk, mode="drop")
    return out_key, out_pair


def nearest_cluster_per_subgroup(tids, cids, fine, n_tiles: int, SPT: int,
                                 K: int):
    """Per subgroup, the candidate cluster with the smallest conservative
    entry bound (K where a subgroup has no candidates). fine is (P, SPT)
    with tids sorted tile-major (dummy pairs have tids == n_tiles)."""
    e = jnp.where(jnp.isfinite(fine), fine, jnp.float32(3e38))
    emin = jax.ops.segment_min(e, tids, num_segments=n_tiles + 1,
                               indices_are_sorted=True)
    tied = (e == jnp.take(emin, tids, axis=0)) & jnp.isfinite(fine)
    cidb = jnp.broadcast_to(cids[:, None], e.shape)
    csel = jax.ops.segment_min(jnp.where(tied, cidb, K), tids,
                               num_segments=n_tiles + 1,
                               indices_are_sorted=True)
    return csel[:n_tiles].reshape(-1)                 # (n_sub,)


def _stage1_pruned_core(scene, o, d, t_min, t_max, TILE: int, G: int,
                        SPB: int, P_cap: int, waves: int = 1, nb1=None):
    """Ordered-wave stage1: refine, sweep each subgroup's ``waves``
    NEAREST candidate clusters (by conservative slab entry; one
    statically-bounded grid — no extra host sync), then prune the
    remaining candidates against the per-subgroup best-t upper bound.
    Pruning is conservative: a cluster whose entry bound exceeds every
    ray's current best cannot improve any hit, so exactness holds.

    waves=1 is the classic passes=2 two-pass machine. The W-wave
    generalization is the round-4 architecture-decision prototype: on
    depth-complex scenes (tools/wave_sim.py, 1M-tri blobby, G=32
    cs=128) W=3-4 sweeps 674 tris/ray vs 1196 unordered (1.78x) and
    1062 for W=1 (which barely pays); the per-subgroup ordered floor is
    383. Sweeping all W choices in ONE grid gives the same final bound
    as sequential waves — exact Möller–Trumbore best-t is order
    independent — at a single dispatch."""
    K = scene.n_clusters
    C = scene.cluster_size
    SPT = TILE // G
    R = o.shape[0]
    n_tiles = R // TILE
    n_sub = R // G
    B_cap = P_cap * SPT // SPB + K + 1

    entry = phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE)
    tids, cids, coarse_total = build_worklist(entry, P_cap)
    stats = subgroup_stats(o, d, t_min, t_max, G)
    fine = refine_pairs(stats, tids, cids, scene.cluster_min,
                        scene.cluster_max, SPT, n_tiles)
    tbl = ray_table(o, d, t_min, t_max, G)
    tclamp = jnp.minimum(tids, n_tiles)

    # Per subgroup, the `waves` nearest candidate clusters (iterated
    # exclusion: W segmented min-reductions over the pair rows).
    chosen_all = []
    fine_w = fine
    for _ in range(waves):
        chosen = nearest_cluster_per_subgroup(tids, cids, fine_w, n_tiles,
                                              SPT, K)
        chosen_all.append(chosen)
        ch_t = jnp.take(jnp.concatenate(
            [chosen.reshape(n_tiles, SPT),
             jnp.full((1, SPT), K, jnp.int32)]), tclamp, axis=0)
        fine_w = jnp.where(cids[:, None] == ch_t, jnp.inf, fine_w)

    # Wave sweep: all W choices of every subgroup in one grid.
    chf = jnp.stack(chosen_all, axis=1).reshape(-1)   # (n_sub * W,)
    subrep = jnp.repeat(jnp.arange(n_sub, dtype=jnp.int32), waves)
    B1 = n_sub * waves // SPB + K + 1
    bc1, bs1, tot1 = group_flat_cluster_major(
        subrep, jnp.minimum(chf, K - 1), chf < K,
        SPB=SPB, n_sub=n_sub, B_cap=B1, K=K)
    if nb1 is not None:
        # Predicted wave grid (warm fused path): the static worst-case
        # bound pads ~K no-op grid steps per sweep (~8K at the 1M blobby
        # config); slice to the validated prediction instead — tot1
        # rides the totals readback, a miss falls back to two-stage.
        B1 = min(nb1, B1)
        bc1, bs1 = bc1[:B1], bs1[:B1]
    k1r, p1r = sweep_regrouped(bs1, bc1, tbl, scene.tri_feats, G=G, SPB=SPB,
                             C=C, n_blocks=B1)
    k1, p1 = combine_rows_grouped(k1r, p1r, bs1, B1, G, SPB, n_sub)

    # Per-subgroup upper bound on the remaining useful entry t. fine_w
    # already carries inf at every swept (subgroup, cluster), so the
    # threshold alone excludes the wave set from the remainder.
    t1 = jnp.where(k1 == INT32_MAX, jnp.inf, _t_from_keys(k1))
    ub = jnp.max(t1.reshape(n_sub, G), axis=1)        # (n_sub,)
    ub_t = jnp.take(jnp.concatenate(
        [ub.reshape(n_tiles, SPT), jnp.zeros((1, SPT))]), tclamp, axis=0)
    fine2 = jnp.where(fine_w <= ub_t, fine_w, jnp.inf)
    block_cid, block_subs, total = group_cluster_major(
        tids, cids, fine2, SPT=SPT, SPB=SPB, n_sub=n_sub, B_cap=B_cap, K=K)
    return (block_cid, block_subs, tbl, total, coarse_total, k1, p1, tot1)


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap", "waves"))
def _stage1_pruned(scene, o, d, t_min, t_max, *, TILE: int, G: int,
                   SPB: int, P_cap: int, waves: int = 1):
    return _stage1_pruned_core(scene, o, d, t_min, t_max, TILE, G, SPB,
                               P_cap, waves)


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap", "nb",
                                   "combine", "R0", "waves", "payload",
                                   "nb1"))
def _fused_query_pruned(scene, o, d, t_min, t_max, *, TILE: int, G: int,
                        SPB: int, P_cap: int, nb: int, combine: str, R0: int,
                        waves: int,
                        payload: str = "full", nb1=None):
    """One-dispatch warm path for the ordered-wave (passes>=2) engine:
    wave stage1 + remainder sweep with a PREDICTED remainder grid, same
    predict-then-validate contract as _fused_query. The wave grid runs
    at the predicted nb1 (tot1 rides the totals readback as the 4th
    element; a miss falls back to the two-stage path)."""
    out = _stage1_pruned_core(scene, o, d, t_min, t_max, TILE, G, SPB,
                              P_cap, waves, nb1)
    block_cid, block_subs, tbl, total, coarse_total, k1, p1, tot1 = out
    res = _stage2_core(scene, block_cid, block_subs, tbl, o[:R0], d[:R0],
                       G, SPB, nb, combine, o.shape[0],
                       k1, p1, payload)
    csum = jnp.sum(res.t[::257], dtype=jnp.float32)
    return res, jnp.stack([total, coarse_total,
                           jax.lax.bitcast_convert_type(csum, jnp.int32),
                           tot1])


def _stage1_core(scene, o, d, t_min, t_max, TILE, G, SPB, P_cap):
    K = scene.n_clusters
    SPT = TILE // G
    R = o.shape[0]
    n_tiles = R // TILE
    n_sub = R // G
    B_cap = P_cap * SPT // SPB + K + 1

    entry = phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE)
    tids, cids, coarse_total = build_worklist(entry, P_cap)
    stats = subgroup_stats(o, d, t_min, t_max, G)
    fine = refine_pairs(stats, tids, cids, scene.cluster_min,
                        scene.cluster_max, SPT, n_tiles)
    block_cid, block_subs, total = group_cluster_major(
        tids, cids, fine, SPT=SPT, SPB=SPB, n_sub=n_sub, B_cap=B_cap, K=K)
    tbl = ray_table(o, d, t_min, t_max, G)
    return block_cid, block_subs, tbl, total, coarse_total


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap"))
def _stage1(scene, o, d, t_min, t_max, *, TILE: int, G: int, SPB: int,
            P_cap: int):
    """Phase A -> coarse worklist -> subgroup refine -> cluster-major
    grouping. Returns everything the sweep stage needs plus the runtime
    totals (coarse pairs, blocks) for host-side grid sizing."""
    return _stage1_core(scene, o, d, t_min, t_max, TILE, G, SPB, P_cap)


def _stage1_cm_core(scene, o, d, t_min, t_max, TILE, G, SPB, P_cap, Q_cap,
                    waves: int = 0, nb1=None):
    """SORT-FREE stage1: compact the TRANSPOSED phase-A entry matrix so
    the coarse worklist comes out cluster-major for free; the subgroup
    expansion preserves that order, so after one compaction the blocks
    pack with pure rank arithmetic (pack_presorted_cluster_major) —
    replacing the N = P_cap*SPT two-key grouping sort with O(N)
    compaction + an O(Q_cap) pack. Candidate SET is identical to
    _stage1_core; only the block order differs (by cluster id instead of
    sort order), which the per-ray merge is insensitive to.

    waves=W>0 is the ordered-multiwave (passes=W+1) variant on this
    driver: each subgroup's W nearest candidate clusters (by the refined
    conservative entry) are swept in one statically-bounded grid, then
    the remaining compacted pairs are pruned against the per-subgroup
    best-t bound — the same exactness argument as _stage1_pruned_core.
    Two structural wins over the sort-path multiwave: (a) the W-round
    nearest selection runs on the COMPACTED (Q_cap,) pair list instead
    of the (P_cap, SPT) candidate matrix (~50x fewer elements per
    segment reduction), and (b) the remainder needs no grouping sort —
    pruning only DROPS elements from the cluster-major list, so a second
    order-preserving compaction + rank pack rebuilds the blocks.
    Returns (block_cid, block_subs, tbl, totals, k1, p1); k1/p1 are the
    wave sweep's per-ray merge inputs (None when waves=0)."""
    from .pallas_dense import compact_indices
    K = scene.n_clusters
    SPT = TILE // G
    R = o.shape[0]
    n_tiles = R // TILE
    n_sub = R // G

    entry = phase_a_entry(scene, o, d, t_min, t_max, n_tiles, TILE)
    # build_worklist on entry.T: "tids" = rows = CLUSTER ids (dummy K),
    # "cids" = cols = TILE ids; compaction order = cluster-major.
    crow, tcol, coarse_total = build_worklist(entry.T, P_cap)
    valid_p = crow < K
    tile_ids = jnp.where(valid_p, tcol, n_tiles)
    cluster_ids = jnp.where(valid_p, crow, 0)
    stats = subgroup_stats(o, d, t_min, t_max, G)
    fine = refine_pairs(stats, tile_ids, cluster_ids, scene.cluster_min,
                        scene.cluster_max, SPT, n_tiles)       # (P, SPT)

    sub = (tile_ids[:, None] * SPT
           + jnp.arange(SPT, dtype=jnp.int32)[None, :]).reshape(-1)
    cid = jnp.broadcast_to(cluster_ids[:, None],
                           (P_cap, SPT)).reshape(-1)
    sel, q_total = compact_indices(jnp.isfinite(fine).reshape(-1), Q_cap)
    qvalid = jnp.arange(Q_cap) < q_total
    sub_q = jnp.where(qvalid, jnp.take(sub, sel), n_sub)
    cid_q = jnp.where(qvalid, jnp.take(cid, sel), K)
    B_cap = Q_cap // SPB + K + 1
    tbl = ray_table(o, d, t_min, t_max, G)

    if waves == 0:
        block_cid, block_subs, total = pack_presorted_cluster_major(
            cid_q, sub_q, qvalid, SPB=SPB, n_sub=n_sub, B_cap=B_cap, K=K)
        totals = jnp.stack([coarse_total, q_total, total])
        return block_cid, block_subs, tbl, totals, None, None

    # --- ordered waves on the compacted pair list ---
    entry_q = jnp.where(qvalid, jnp.take(fine.reshape(-1), sel), jnp.inf)
    BIG = jnp.float32(3e38)
    chosen_all = []
    ent_w = entry_q
    for _ in range(waves):
        e = jnp.where(jnp.isfinite(ent_w), ent_w, BIG)
        emin = jax.ops.segment_min(e, sub_q, num_segments=n_sub + 1)
        tied = jnp.isfinite(ent_w) & (e == jnp.take(emin, sub_q))
        csel = jax.ops.segment_min(jnp.where(tied, cid_q, K), sub_q,
                                   num_segments=n_sub + 1)
        chosen = csel[:n_sub]
        chosen_all.append(chosen)
        ch_full = jnp.concatenate([chosen, jnp.full((1,), K, jnp.int32)])
        ent_w = jnp.where(cid_q == jnp.take(ch_full, sub_q), jnp.inf,
                          ent_w)

    chf = jnp.stack(chosen_all, axis=1).reshape(-1)   # (n_sub * W,)
    subrep = jnp.repeat(jnp.arange(n_sub, dtype=jnp.int32), waves)
    B1 = n_sub * waves // SPB + K + 1
    bc1, bs1, tot1 = group_flat_cluster_major(
        subrep, jnp.minimum(chf, K - 1), chf < K,
        SPB=SPB, n_sub=n_sub, B_cap=B1, K=K)
    if nb1 is not None:
        # Predicted wave grid (warm fused path): the static worst-case
        # bound pads ~K no-op grid steps per sweep; slice to the
        # validated prediction instead (same contract as the remainder
        # grid's nb — tot1 rides the totals readback and a miss falls
        # back to the two-stage path).
        B1 = min(nb1, B1)
        bc1, bs1 = bc1[:B1], bs1[:B1]
    k1r, p1r = sweep_regrouped(bs1, bc1, tbl, scene.tri_feats, G=G, SPB=SPB,
                             C=scene.cluster_size, n_blocks=B1)
    k1, p1 = combine_rows_grouped(k1r, p1r, bs1, B1, G, SPB, n_sub)

    t1 = jnp.where(k1 == INT32_MAX, jnp.inf, _t_from_keys(k1))
    ub = jnp.max(t1.reshape(n_sub, G), axis=1)        # (n_sub,)
    ub_full = jnp.concatenate([ub, jnp.zeros((1,), ub.dtype)])
    # ent_w already carries inf at every swept (subgroup, cluster), so
    # the threshold alone excludes the wave set from the remainder; the
    # prune only DROPS entries, so cluster-major order is preserved and
    # an order-preserving compaction + rank pack rebuilds the blocks.
    keep = qvalid & (ent_w <= jnp.take(ub_full, sub_q))
    sel2, r_total = compact_indices(keep, Q_cap)
    rvalid = jnp.arange(Q_cap) < r_total
    sub_r = jnp.where(rvalid, jnp.take(sub_q, sel2), n_sub)
    cid_r = jnp.where(rvalid, jnp.take(cid_q, sel2), K)
    block_cid, block_subs, total = pack_presorted_cluster_major(
        cid_r, sub_r, rvalid, SPB=SPB, n_sub=n_sub, B_cap=B_cap, K=K)
    # 4-element totals for the multiwave driver: tot1 (true wave-grid
    # block count) validates the nb1 prediction. passes=1 totals stay
    # 3-element — its fused graphs (the headline path) are unchanged.
    totals = jnp.stack([coarse_total, q_total, total, tot1])
    return block_cid, block_subs, tbl, totals, k1, p1


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap", "Q_cap",
                                   "waves"))
def _stage1_cm(scene, o, d, t_min, t_max, *, TILE: int, G: int, SPB: int,
               P_cap: int, Q_cap: int, waves: int = 0):
    return _stage1_cm_core(scene, o, d, t_min, t_max, TILE, G, SPB,
                           P_cap, Q_cap, waves)


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap", "Q_cap",
                                   "nb", "combine", "R0",
                                   "waves", "nb1"))
def _fused_query_cm(scene, o, d, t_min, t_max, *, TILE: int, G: int,
                    SPB: int, P_cap: int, Q_cap: int, nb: int,
                    combine: str, R0: int,
                    waves: int = 0, nb1=None):
    """One-dispatch warm path for the sort-free stage1 (same predict-
    then-validate contract as _fused_query; totals carry coarse, q,
    blocks + a result checksum). waves>0 adds the ordered-wave sweep
    whose per-ray results merge into stage2; its grid runs at the
    predicted nb1 (validated via the 4th totals element)."""
    block_cid, block_subs, tbl, totals, k1, p1 = _stage1_cm_core(
        scene, o, d, t_min, t_max, TILE, G, SPB, P_cap, Q_cap,
        waves, nb1)
    res = _stage2_core(scene, block_cid, block_subs, tbl, o[:R0], d[:R0],
                       G, SPB, nb, combine, o.shape[0],
                       k1, p1)
    csum = jnp.sum(res.t[::257], dtype=jnp.float32)
    return res, jnp.concatenate(
        [totals, jax.lax.bitcast_convert_type(csum, jnp.int32)[None]])


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap", "nb",
                                   "combine", "R0", "payload"))
def _fused_query(scene, o, d, t_min, t_max, *, TILE: int, G: int, SPB: int,
                 P_cap: int, nb: int, combine: str,
                 R0: int, payload: str = "full"):
    """One-dispatch warm path: stage1 + stage2 with a PREDICTED block
    grid (from the call site's previous query). The caller validates the
    returned totals post-hoc and falls back to the two-stage path when
    the prediction was too small — results are only used when valid, so
    exactness is unaffected."""
    out = _stage1_core(scene, o, d, t_min, t_max, TILE, G, SPB, P_cap)
    block_cid, block_subs, tbl, total, coarse_total = out
    res = _stage2_core(scene, block_cid, block_subs, tbl, o[:R0], d[:R0],
                       G, SPB, nb, combine, o.shape[0],
                       None, None, payload)
    # One packed totals array = one host readback for the validation.
    # A result checksum rides along in the same readback: a strided sum
    # over the result's t is value-dependent on the WHOLE query, so the
    # caller's totals pull doubles as a completion barrier without a
    # second dispatch + roundtrip.
    # Occlusion results carry t == 0 (constant — XLA would fold a t-sum
    # without running the query); sum the occluder ids instead.
    carrier = res.prim_idx.astype(jnp.float32) \
        if payload == "occlusion" else res.t
    csum = jnp.sum(carrier[::257], dtype=jnp.float32)
    return res, jnp.stack([total, coarse_total,
                           jax.lax.bitcast_convert_type(csum, jnp.int32)])


def _stage2_core(scene, block_cid, block_subs, tbl, o, d, G, SPB,
                 n_blocks, combine, R_pad, k1, p1,
                 payload: str = "full"):
    from ..accel.dense import finalize_hits_exact
    C = scene.cluster_size
    R = o.shape[0]
    n_sub = R_pad // G
    key, pair = sweep_regrouped(block_subs, block_cid, tbl, scene.tri_feats,
                              G=G, SPB=SPB, C=C, n_blocks=n_blocks)
    if combine == "grouped":
        out_key, out_pair = combine_rows_grouped(
            key, pair, block_subs, n_blocks, G, SPB, n_sub)
    else:
        row_ray = (block_subs[:n_blocks, :, None] * G
                   + jnp.arange(G, dtype=jnp.int32)).reshape(-1)
        out_key, out_pair = combine_rows(key, pair, row_ray, R_pad + G,
                                         method=combine)
        out_key, out_pair = out_key[:R_pad], out_pair[:R_pad]
    if k1 is not None:       # merge the pass-1 per-ray bests
        better1 = (k1 < out_key) | ((k1 == out_key) & (p1 >= 0)
                                    & ((p1 < out_pair) | (out_pair < 0)))
        out_key = jnp.where(better1, k1, out_key)
        out_pair = jnp.where(better1, p1, out_pair)
    if payload in ("occlusion", "slim"):
        # Occlusion contract (reference any_hit early-exit semantics,
        # src/instanced-bvh.jl:2034-2140): only hit + occluder prim +
        # instance are contractual — skip the payload finalize (the
        # closest path's hot+cold gathers) entirely. The "slim" variant
        # keeps the same skip but ALSO returns the true t (free — it is
        # the full-precision winning key) for consumers that never read
        # triangle/barycentric (view_factors, AO, collision probes).
        from ..accel.brute import HitResult
        from ..accel.dense import _hit_instance_idx
        from ..core.triangle import Triangle
        pair_r = out_pair[:R]
        hit = pair_r >= 0
        ids = jnp.take(scene.prims_hot[:, 10], jnp.clip(pair_r, 0, None))
        orig = jnp.where(hit, ids, -1)
        if payload == "slim":
            t = _t_from_keys(out_key[:R])
            t = jnp.where(hit, t, 0.0)
            # metadata rides along (one narrow 4 B gather): view_factors
            # and illumination consume only hit/metadata — slim serves
            # them without the 160 B payload gather.
            meta = jnp.where(hit, jnp.take(
                scene.prims.metadata, jnp.clip(orig, 0, None), axis=0,
                mode="clip"), 0)
        else:
            t = jnp.zeros((R,), jnp.float32)
            meta = jnp.zeros((R,), scene.prims.metadata.dtype)
        z3 = jnp.zeros((R, 3, 3), jnp.float32)
        tri = Triangle(vertices=z3, normals=z3, tangents=z3,
                       uv=jnp.zeros((R, 3, 2), jnp.float32),
                       metadata=meta)
        return HitResult(hit=hit, triangle=tri, t=t,
                         barycentric=jnp.zeros((R, 3), jnp.float32),
                         prim_idx=orig,
                         instance_idx=_hit_instance_idx(scene, orig, hit))
    t = _t_from_keys(out_key[:R])        # full-precision keys
    return finalize_hits_exact(scene, out_pair[:R], t, o, d)


@partial(jax.jit, static_argnames=("G", "SPB", "n_blocks",
                                   "combine", "R_pad", "payload"))
def _stage2(scene, block_cid, block_subs, tbl, o, d, *, G: int, SPB: int,
            n_blocks: int, combine: str, R_pad: int,
            k1=None, p1=None, payload: str = "full"):
    return _stage2_core(scene, block_cid, block_subs, tbl, o, d, G, SPB,
                        n_blocks, combine, R_pad, k1, p1,
                        payload)


# Per-(scene, query-shape) capacity memory: repeated queries (bench reps,
# render loops) right-size the coarse pair capacity from the previous
# call's true count, shrinking the grouping sort/scatter work ~3x vs the
# conservative first-call default. Overflow still retries with doubling.
# Entries carry a weakref to the keying array: ids are recycled after GC,
# so a recycled id must not inherit a dead scene's prediction (results
# would still be validated/correct, but the misprediction would trigger
# fallback recompiles). Size-bounded FIFO.
import weakref as _weakref

_CAPACITY_CACHE: dict = {}
_CAPACITY_CACHE_MAX = 64


def _cache_get(scene, ck):
    ent = _CAPACITY_CACHE.get(ck)
    if ent is None:
        # Fresh process / fresh scene: adopt a persisted hint from a
        # previous process at this (shape, params) key. Safe because
        # every prediction is validated post-hoc (capacity_store.py).
        hint = _cap_store.load_hint(ck, scene)
        if hint is not None:
            try:
                hint["ref"] = _weakref.ref(scene.tri_feats)
            except TypeError:
                hint["ref"] = None
            while len(_CAPACITY_CACHE) >= _CAPACITY_CACHE_MAX:
                _CAPACITY_CACHE.pop(next(iter(_CAPACITY_CACHE)))
            _CAPACITY_CACHE[ck] = hint
        return hint
    if ent.get("ref") is not None and ent["ref"]() is not scene.tri_feats:
        del _CAPACITY_CACHE[ck]         # stale: id was recycled
        return None
    return ent


def _cache_put(scene, ck, coarse, nb, nb1=None):
    try:
        ref = _weakref.ref(scene.tri_feats)
    except TypeError:
        ref = None
    while len(_CAPACITY_CACHE) >= _CAPACITY_CACHE_MAX:
        _CAPACITY_CACHE.pop(next(iter(_CAPACITY_CACHE)))
    ent = dict(coarse=coarse, nb=nb, ref=ref)
    if nb1 is not None:
        ent["nb1"] = nb1
    _CAPACITY_CACHE[ck] = ent
    _cap_store.save_hint(ck, _CAPACITY_CACHE[ck], scene)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def _shape_params(R0: int, tile: int, subgroup: int):
    """(G, TILE, padded R) exactly as closest_hit_regrouped
    derive them — warm-capacity keys must match."""
    G = min(subgroup, max(8, 1 << (max(R0, 1) - 1).bit_length()))
    TILE = min(tile, max(R0, G))
    TILE = -(-TILE // G) * G
    return G, TILE, R0 + ((-R0) % TILE)


def auto_passes(scene) -> int:
    """passes="auto" resolution: depth-complex scenes (cluster AABBs
    forming >=~2 disjoint depth layers) take the ordered-wave multiwave
    path — 1.7-1.8x fewer swept candidates there; single sheets stay
    passes=1 where ordering structurally cannot pay (tools/wave_sim.py
    decision tables). Host-side cached statistic; no device work."""
    from ..accel.dense import depth_layers
    return 4 if depth_layers(scene) >= 1.6 else 1


def has_warm_capacity(scene, n_rays: int, *, tile: int = 2048,
                      subgroup: int = 32, spb: int = 16,
                      passes=1, occlusion: bool = False,
                      payload: str = "full") -> bool:
    """True when a previous regrouped query at this (scene, shape,
    params) has populated the capacity cache — i.e. the fused one-
    dispatch executables exist and a repeat query is cheap. dispatch
    uses this to auto-route big queries to the regrouped engine without
    making an unrelated first query pay the stage-graph compile."""
    if getattr(scene, "sub_chunks", 1) != 1:
        return False
    if passes == "auto":
        passes = auto_passes(scene)
    if occlusion:
        payload = "occlusion"
    G, TILE, Rp = _shape_params(n_rays, tile, subgroup)
    explicit_s1 = "RAYCORE_REGROUP_STAGE1" in _os.environ
    s1 = _os.environ.get("RAYCORE_REGROUP_STAGE1", "compact")
    if payload == "full" and s1 == "compact" \
            and (passes == 1 or explicit_s1):
        # A routed full-payload query will take the sort-free compact
        # driver (the measured passes=1 default; multiwave stays on
        # "sort" unless explicitly opted in — mirror
        # closest_hit_regrouped's routing), which capacity-caches under
        # its own "cm" key — warmth must be probed on the key the routed
        # query will actually use, else dispatch would either miss a
        # warm compact engine or route into a cold one.
        ck = (id(scene.tri_feats), scene.tri_feats.shape, Rp, TILE, G,
              spb, "cm") if passes == 1 else \
             (id(scene.tri_feats), scene.tri_feats.shape, Rp, TILE, G,
              spb, "cm", passes)
    else:
        ck = (id(scene.tri_feats), scene.tri_feats.shape, Rp, TILE, G,
              spb, passes, payload)
    return _cache_get(scene, ck) is not None


def prewarm(scene, n_rays: int, *, engine: str = "auto", tile: int = 2048,
            subgroup: int = 32, spb: int = 16, passes="auto"):
    """Compile + capacity-size the regrouped sweep engine for (scene,
    n_rays)-shaped queries. Runs two throwaway coherent queries (the
    first sizes capacities and compiles the two-stage path, the second
    compiles + validates the fused one-dispatch path). After this,
    dispatch auto-routes matching queries to the warmed engine, so a
    renderer's first frame never pays the stage-graph compile.

    engine: "regroup" or "auto" (the same; sub_chunks=1 scenes only).
    Returns seconds spent."""
    import time as _time
    from ..core.ray import Ray as _Ray
    if engine not in ("auto", "regroup"):
        raise ValueError(f"engine must be 'auto' or 'regroup', got {engine}")
    if passes == "auto":
        passes = auto_passes(scene)
    t0 = _time.time()
    # Coherent primary-style grid over the scene's top face, looking
    # down: candidate counts are workload-dependent, so the capacity
    # cache validates post-hoc and falls back gracefully if a real
    # query needs more (sticky-max growth, no correctness impact).
    lo = scene.root_aabb[0]
    hi = scene.root_aabb[1]
    side = max(int(n_rays ** 0.5), 1)
    R0 = n_rays
    xs = jnp.linspace(lo[0], hi[0], side)
    ys = jnp.linspace(lo[1], hi[1], side)
    X, Y = jnp.meshgrid(xs, ys, indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, hi[2] + 1.0)], -1).reshape(-1, 3)
    reps = -(-R0 // o.shape[0])
    o = jnp.tile(o, (reps, 1))[:R0]
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
                         o.shape)
    rays = _Ray.create(o=o, d=d)
    for _ in range(2):
        closest_hit_regrouped(scene, rays, tile=tile, subgroup=subgroup,
                              spb=spb, passes=passes)
        any_hit_regrouped(scene, rays, tile=tile, subgroup=subgroup,
                          spb=spb)
    return _time.time() - t0


def _closest_hit_regrouped_cm(scene, rays, *, tile: int, subgroup: int,
                              spb: int, pairs_per_tile: int, combine: str,
                              with_checksum: bool, deferred: bool = False,
                              passes: int = 1):
    """Sort-free stage1 driver (stage1="compact"): same auto-sizing
    contract as closest_hit_regrouped with one extra capacity (Q_cap,
    the compacted subgroup-pair list) validated from the same
    totals readback. passes=N>=2 runs the ordered multiwave on this
    driver (waves selected on the compacted pair list — see
    _stage1_cm_core)."""
    waves = passes - 1
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o, d = flat(rays.o), flat(rays.d)
    t_min, t_max = flat(rays.t_min), flat(rays.t_max)
    R0 = o.shape[0]
    G = min(subgroup, max(8, 1 << (max(R0, 1) - 1).bit_length()))
    TILE = min(tile, max(R0, G))
    TILE = -(-TILE // G) * G
    SPB = spb
    d = jnp.where(d == 0.0, 0.0, d)
    pad = (-R0) % TILE
    if pad:
        ext = lambda a, f: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], f, a.dtype)])
        o, d = ext(o, 0.0), ext(d, 1.0)
        t_min, t_max = ext(t_min, 0.0), ext(t_max, -jnp.inf)
    n_tiles = o.shape[0] // TILE
    n_sub = o.shape[0] // G
    SPT = TILE // G
    K = scene.n_clusters
    hard_p = n_tiles * K
    hard_q = n_sub * K
    P_cap = min(pairs_per_tile * n_tiles, hard_p)
    Q_cap = min(max(4096, 8 * n_sub), hard_q)
    # passes=1 keeps the original "cm" key (persisted hints stay valid);
    # multiwave capacities live under their own key — the remainder
    # block count differs from the unpruned one.
    ck = (id(scene.tri_feats), scene.tri_feats.shape, o.shape[0], TILE, G,
          SPB, "cm") if passes == 1 else \
         (id(scene.tri_feats), scene.tri_feats.shape, o.shape[0], TILE, G,
          SPB, "cm", passes)
    cached = _cache_get(scene, ck)
    if cached is not None:
        bucket = lambda w, h: min(max(4096, -(-int(w * 1.2) // 4096) * 4096),
                                  h)
        P_cap = bucket(cached["coarse"], hard_p)
        Q_cap = bucket(cached["q"], hard_q)
    # The compacted pair list is drawn from the (P_cap, SPT) candidate
    # matrix — a Q_cap beyond its size is shape-invalid (small scenes).
    Q_cap = min(Q_cap, P_cap * SPT)

    reshape_out = lambda res: jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)
    import numpy as _np

    # Same fused-graph size gate as the sort driver: the one-dispatch
    # executable's XLA compile is superlinear in K; above the threshold
    # stay two-stage.
    fuse_max_k = int(_os.environ.get("RAYCORE_FUSE_MAX_K", "16384"))
    # Static worst-case wave-grid bound (multiwave only): the warm path
    # runs the wave sweep at a predicted nb1 instead (validated via the
    # 4th totals element), saving ~K no-op grid steps per query.
    n_sub_pad = o.shape[0] // G
    B1_full = n_sub_pad * waves // SPB + K + 1 if waves else 0
    if cached is not None and combine == "grouped" and K <= fuse_max_k:
        B_cap = Q_cap // SPB + K + 1
        nb_pred = min(cached["nb"], B_cap)
        nb1_pred = min(cached.get("nb1", B1_full), B1_full) if waves \
            else None
        res, totals = _fused_query_cm(
            scene, o, d, t_min, t_max, TILE=TILE, G=G, SPB=SPB,
            P_cap=P_cap, Q_cap=Q_cap, nb=nb_pred, combine=combine, R0=R0,
            waves=waves, nb1=nb1_pred)

        def _validate(tarr, sync_cache=True):
            # Shared fused-path validation: 3-element totals (+checksum)
            # for passes=1, 4-element for multiwave (tot1 validates the
            # wave-grid prediction). Returns the checksum or None.
            coarse, q_total, total = (int(x) for x in tarr[:3])
            ok = coarse <= P_cap and q_total <= Q_cap and total <= nb_pred
            ent = dict(coarse=max(cached["coarse"], coarse),
                       q=max(cached["q"], q_total),
                       nb=max(cached["nb"], nb_pred))
            ci = 3
            if waves:
                tot1 = int(tarr[3])
                ok = ok and tot1 <= nb1_pred
                ent["nb1"] = max(cached.get("nb1", 0),
                                 min(max(512, _next_pow2(tot1)), B1_full))
                ci = 4
            if not ok:
                return None
            if sync_cache:
                _cache_put_cm(scene, ck, **ent)
            return float(tarr[ci:ci + 1].view(_np.float32)[0])

        if deferred:
            def _finalize(res=res, totals=totals):
                return _validate(_np.asarray(totals))
            return reshape_out(res), _finalize
        cs = _validate(_np.asarray(totals))
        if cs is not None:
            if with_checksum:
                return reshape_out(res), cs
            return reshape_out(res)

    while True:
        block_cid, block_subs, tbl, totals, k1, p1 = _stage1_cm(
            scene, o, d, t_min, t_max, TILE=TILE, G=G, SPB=SPB,
            P_cap=P_cap, Q_cap=Q_cap, waves=waves)
        tarr = _np.asarray(totals)
        coarse, q_total, total = (int(x) for x in tarr[:3])
        tot1 = int(tarr[3]) if waves else 0
        ok_p, ok_q = coarse <= P_cap, q_total <= Q_cap
        if ok_p and ok_q:
            break
        if P_cap >= hard_p and Q_cap >= hard_q:
            raise RuntimeError(
                f"regroup-cm worklist overflow at hard capacity: "
                f"coarse={coarse}/{P_cap} pairs={q_total}/{Q_cap}")
        if not ok_p:
            P_cap = min(2 * P_cap, hard_p)
        if not ok_q:
            Q_cap = min(2 * Q_cap, hard_q)
        Q_cap = min(Q_cap, P_cap * (TILE // G))
    nb = 1 << max(9, (max(total, 1) - 1).bit_length())
    nb = min(nb, block_cid.shape[0])
    prev = cached or dict(coarse=0, q=0, nb=0)
    kw = dict(coarse=max(prev["coarse"], coarse),
              q=max(prev["q"], q_total), nb=max(prev["nb"], nb))
    if waves:
        kw["nb1"] = max(prev.get("nb1", 0),
                        min(max(512, _next_pow2(tot1)), B1_full))
    _cache_put_cm(scene, ck, **kw)
    res = _stage2(scene, block_cid, block_subs, tbl, o[:R0], d[:R0],
                  G=G, SPB=SPB, n_blocks=nb, combine=combine,
                  R_pad=o.shape[0], k1=k1, p1=p1)
    res = reshape_out(res)
    if deferred:
        return res, None
    return (res, None) if with_checksum else res


def _cache_put_cm(scene, ck, coarse, q, nb, nb1=None):
    try:
        ref = _weakref.ref(scene.tri_feats)
    except TypeError:
        ref = None
    while len(_CAPACITY_CACHE) >= _CAPACITY_CACHE_MAX:
        _CAPACITY_CACHE.pop(next(iter(_CAPACITY_CACHE)))
    ent = dict(coarse=coarse, q=q, nb=nb, ref=ref)
    if nb1 is not None:
        ent["nb1"] = nb1
    _CAPACITY_CACHE[ck] = ent
    _cap_store.save_hint(ck, _CAPACITY_CACHE[ck], scene)


def closest_hit_regrouped(scene, rays, *, tile: int = 512, subgroup: int = 32,
                          spb: int = 16, pairs_per_tile: int = 48,
                          combine: str = "grouped", passes: int = 2,
                          with_checksum: bool = False,
                          stage1: str | None = None,
                          deferred: bool = False,
                          payload: str = "full",
                          _occlusion: bool = False):
    """Exact closest hit via the cluster-major regrouped sweep. One host
    sync reads the true block count and pow2-buckets the kernel grid
    (same auto-sizing contract as closest_hit_dense_pallas_auto).
    passes=N>=2 sweeps each subgroup's N-1 NEAREST clusters first (one
    ordered-wave grid) and prunes the rest against the resulting
    per-subgroup best-t bound (conservative, so still exact); passes=1
    sweeps every refined candidate. On depth-complex scenes passes=4
    sweeps ~1.8x fewer triangles than passes=1 (tools/wave_sim.py);
    on single-layer scenes (heightfield) ordering cannot pay — keep
    passes=1 there.

    with_checksum=True returns (result, checksum) where checksum is a
    HOST float strided-sum of result.t (None when the warm fused path
    was not taken). Reading it costs nothing extra — it rides the warm
    path's existing totals readback — and it is value-dependent on the
    full query, so benchmarks can use it as the honest completion
    barrier instead of dispatching a separate probe.

    stage1: "compact" (the passes=1 default; env RAYCORE_REGROUP_STAGE1
    overrides) compacts the transposed phase-A matrix so blocks pack
    sort-free; "sort" uses the two-key grouping sort — same candidate
    set, different block order. The multiwave (passes>=2) defaults to
    "sort"; stage1="compact" opts it into the compact driver. Non-full
    payloads always use "sort" (the compact driver returns the full
    payload only).

    payload: "full" (default) gathers the winning triangle and returns
    the exact (t, barycentric, triangle) payload; "slim" returns the
    same exact hit/t/prim_idx/instance_idx but ZERO triangle/barycentric
    — skipping the 160 B/ray payload gather + scalar recompute for
    consumers that never read them (view_factors, AO, collision
    probes); "occlusion" is any_hit_regrouped's internal mode."""
    if scene.sub_chunks != 1:
        raise ValueError("regrouped engine requires sub_chunks=1 scenes")
    if passes == "auto":
        passes = auto_passes(scene)
    if _occlusion:
        payload = "occlusion"
    if payload not in ("full", "slim", "occlusion"):
        raise ValueError(f"payload must be 'full', 'slim' or 'occlusion',"
                         f" got {payload}")
    explicit_s1 = stage1 is not None \
        or "RAYCORE_REGROUP_STAGE1" in _os.environ
    if stage1 is None:
        stage1 = _os.environ.get("RAYCORE_REGROUP_STAGE1", "compact")
    if stage1 not in ("sort", "compact"):
        raise ValueError(f"stage1 must be 'sort' or 'compact', got {stage1}")
    # Compact for passes=1, sort for the multiwave; an explicit
    # stage1="compact" (arg or env) opts the multiwave into the cm
    # driver.
    if stage1 == "compact" and payload == "full" \
            and (passes == 1 or explicit_s1):
        return _closest_hit_regrouped_cm(
            scene, rays, tile=tile, subgroup=subgroup, spb=spb,
            pairs_per_tile=pairs_per_tile, combine=combine,
            with_checksum=with_checksum, deferred=deferred, passes=passes)
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o, d = flat(rays.o), flat(rays.d)
    t_min, t_max = flat(rays.t_min), flat(rays.t_max)
    R0 = o.shape[0]
    G = min(subgroup, max(8, 1 << (max(R0, 1) - 1).bit_length()))
    # TILE must be a multiple of G (subgroup_stats / ray_table reshape
    # (n_sub, G)); round up so e.g. R0=100, G=32 pads to TILE=128.
    TILE = min(tile, max(R0, G))
    TILE = -(-TILE // G) * G
    SPB = spb
    d = jnp.where(d == 0.0, 0.0, d)
    pad = (-R0) % TILE
    if pad:
        ext = lambda a, f: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], f, a.dtype)])
        o, d = ext(o, 0.0), ext(d, 1.0)
        t_min, t_max = ext(t_min, 0.0), ext(t_max, -jnp.inf)
    n_tiles = o.shape[0] // TILE
    hard = n_tiles * scene.n_clusters
    P_cap = min(pairs_per_tile * n_tiles, hard)
    ck = (id(scene.tri_feats), scene.tri_feats.shape, o.shape[0], TILE, G,
          SPB, passes, payload)
    cached = _cache_get(scene, ck)
    if cached is not None:
        # 4096-multiple buckets: tight enough to shrink the grouping N,
        # coarse enough to bound recompiles.
        want = int(cached["coarse"] * 1.2)
        P_cap = min(max(4096, -(-want // 4096) * 4096), hard)

    reshape_out = lambda res: jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)

    # Fused-graph size gate: the one-dispatch warm executable's XLA
    # compile scales superlinearly with cluster count. Above the
    # threshold the engine stays on the two-stage path: same results,
    # one extra dispatch, compile cost bounded.
    fuse_max_k = int(_os.environ.get("RAYCORE_FUSE_MAX_K", "16384"))
    if cached is not None and combine == "grouped" \
            and scene.n_clusters <= fuse_max_k \
            and not (passes > 1 and payload == "occlusion"):
        # Warm path: ONE dispatch with the predicted block grid; validate
        # the totals afterwards and fall back when the prediction missed.
        B_cap = P_cap * (TILE // G) // SPB + scene.n_clusters + 1
        nb_pred = min(cached["nb"], B_cap)
        n_sub_pad = o.shape[0] // G
        B1_full = n_sub_pad * (passes - 1) // SPB + scene.n_clusters + 1 \
            if passes > 1 else 0
        nb1_pred = min(cached.get("nb1", B1_full), B1_full) \
            if passes > 1 else None
        if passes == 1:
            res, totals = _fused_query(
                scene, o, d, t_min, t_max, TILE=TILE, G=G, SPB=SPB,
                P_cap=P_cap, nb=nb_pred, combine=combine, R0=R0,
                payload=payload)
        else:
            res, totals = _fused_query_pruned(
                scene, o, d, t_min, t_max, TILE=TILE, G=G, SPB=SPB,
                P_cap=P_cap, nb=nb_pred, combine=combine, R0=R0,
                waves=passes - 1,
                payload=payload, nb1=nb1_pred)
        import numpy as _np

        def _validate(tarr):
            # Totals: [blocks, coarse, checksum] (+ tot1 for multiwave —
            # validates the wave-grid prediction). Returns the checksum
            # or None on any capacity miss.
            it, ic = int(tarr[0]), int(tarr[1])
            ok = ic <= P_cap and it <= nb_pred
            ent = dict(coarse=max(cached["coarse"], ic),
                       nb=max(cached["nb"], max(512, _next_pow2(it))))
            if passes > 1:
                tot1 = int(tarr[3])
                ok = ok and tot1 <= nb1_pred
                ent["nb1"] = max(cached.get("nb1", 0),
                                 min(max(512, _next_pow2(tot1)), B1_full))
            if not ok:
                return None
            _cache_put(scene, ck, **ent)
            return float(tarr[2:3].view(_np.float32)[0])

        if deferred:
            # Pipelined-dispatch mode: hand back the UNSYNCED result plus
            # a finalizer that does the usual totals validation later.
            # The finalizer returns the checksum, or None when a capacity
            # prediction missed (the result must then be DISCARDED and
            # the query re-issued non-deferred). For identical repeated
            # queries (bench reps, fixed camera) the totals are
            # deterministic, so one validated call validates them all.
            def _finalize(res=res, totals=totals):
                return _validate(_np.asarray(totals))
            return reshape_out(res), _finalize
        # Sticky-max all counts: shrinking workloads (e.g. later
        # path-tracer bounces) must NOT move to smaller capacity
        # buckets — every new bucket is a fresh compile.
        cs = _validate(_np.asarray(totals))
        if cs is not None:
            if with_checksum:
                return reshape_out(res), cs
            return reshape_out(res)

    k1 = p1 = None
    while True:
        # Retry with doubled capacity until the coarse pair count fits.
        # Terminates: coarse <= hard (= n_tiles * K) by construction, and
        # P_cap reaches hard after finitely many doublings — a truncated
        # worklist is never swept (that would silently drop candidates
        # from an API documented as exact).
        if passes >= 2:
            out = _stage1_pruned(scene, o, d, t_min, t_max, TILE=TILE,
                                 G=G, SPB=SPB, P_cap=P_cap,
                                 waves=passes - 1)
            block_cid, block_subs, tbl, total, coarse, k1, p1, tot1 = out
        else:
            block_cid, block_subs, tbl, total, coarse = _stage1(
                scene, o, d, t_min, t_max, TILE=TILE, G=G, SPB=SPB,
                P_cap=P_cap)
        if int(coarse) <= P_cap:
            break
        if P_cap >= hard:
            raise RuntimeError(
                f"regroup worklist overflow at hard capacity: "
                f"{int(coarse)} coarse pairs > {P_cap}")
        P_cap = min(2 * P_cap, hard)
    nb = int(total)                         # the one host sync
    nb = 1 << max(9, (max(nb, 1) - 1).bit_length())
    nb = min(nb, block_cid.shape[0])
    prev = _cache_get(scene, ck) or dict(coarse=0, nb=0)
    kw = dict(coarse=max(prev["coarse"], int(coarse)),
              nb=max(prev["nb"], nb))
    if passes >= 2:
        n_sub_pad = o.shape[0] // G
        B1_full = n_sub_pad * (passes - 1) // SPB + scene.n_clusters + 1
        kw["nb1"] = max(prev.get("nb1", 0),
                        min(max(512, _next_pow2(int(tot1))), B1_full))
    _cache_put(scene, ck, **kw)
    res = _stage2(scene, block_cid, block_subs, tbl, o[:R0], d[:R0],
                  G=G, SPB=SPB, n_blocks=nb, combine=combine,
                  R_pad=o.shape[0], k1=k1, p1=p1,
                  payload=payload)
    res = jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)
    if deferred:
        return res, None        # cold path already synced; no finalizer
    return (res, None) if with_checksum else res


def any_hit_regrouped(scene, rays, *, tile: int = 2048, subgroup: int = 32,
                      spb: int = 16, pairs_per_tile: int = 48,
                      with_checksum: bool = False, deferred: bool = False):
    """Occlusion over a DenseScene via the regrouped sweep: same
    candidate culling and sweep as closest_hit_regrouped with t_min
    forced to 0 (reference any_hit, src/instanced-bvh.jl:2045), but only
    (hit, occluder prim, instance) are contractual — t/bary/triangle are
    zeros and the payload finalize is skipped entirely."""
    rays0 = rays.replace(t_min=jnp.zeros_like(rays.t_min))
    return closest_hit_regrouped(
        scene, rays0, tile=tile, subgroup=subgroup, spb=spb,
        pairs_per_tile=pairs_per_tile, combine="grouped", passes=1,
        with_checksum=with_checksum, stage1="sort", deferred=deferred,
        _occlusion=True)

"""Regroup-style sweep over instanced scenes — the dynamic fast path.

The wavefront TLAS traversal handles arbitrary instancing but is
gather-latency bound; the baked dense engine is fast but
re-bakes world geometry on every transform change. This engine covers
the reference's production hot path — closest_hit over a mutable
instanced TLAS (reference src/instanced-bvh.jl:1902-2140) — with
per-frame dynamics at dense-engine speeds:

  1. Phase A: per-ray-tile interval culling against per-INSTANCE world
     AABBs -> (tile, instance) pairs (same interval test as the dense
     engine, phase_a_entry_bounds).
  2. Refine to G-ray subgroups -> valid (subgroup, instance) pairs,
     compacted to a capacity Q_cap.
  3. Per pair: transform the subgroup's rays into instance-local space
     (one 3x4 apply per ray) and build its 16-wide ray-feature table
     row. Möller–Trumbore's t is invariant under the affine map, so
     hit keys compare across instances directly.
  4. Expand each pair over its BLAS's clusters (local-space interval
     test, max_clusters_per_blas static slots) -> (pair, cluster-row)
     candidates, grouped cluster-major into SPB-pair blocks.
  5. sweep_regrouped sweeps the blocks against the concatenated LOCAL
     per-BLAS feature tables (payload="pairrow": the winner encodes the
     pair so the instance is recoverable).
  6. Grouped segment-min combine per ray; exact scalar MT recompute in
     the winning instance's local space.

Exactness: every stage is conservative (interval tests never drop a
reachable candidate; capacities are validated post-hoc and retried), so
results match the TLAS traversal up to the dense engines' documented
EDGE_EPS featurization slack.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..accel.dense import FEAT, ray_features
from ..core.transforms import _apply_mat3
from ..core.triangle import safe_invdir
from .pallas_dense import (_t_from_keys, build_worklist,
                           bundle_entry_vs_bounds, phase_a_entry_bounds)
from .pallas_regroup import (COL_TMAX, COL_TMIN, combine_rows_grouped,
                             group_flat_cluster_major, refine_pairs,
                             subgroup_stats)
from .sweep import sweep_regrouped


def _stage1_inst_core(scene, o, d, t_min, t_max, TILE, G, SPB, P_cap,
                      Q_cap):
    C = scene.cluster_size
    S = scene.max_clusters_per_blas
    K_total = scene.n_clusters
    SPT = TILE // G
    R = o.shape[0]
    n_tiles = R // TILE
    n_sub = R // G

    # 1) tile x instance culling.
    entry = phase_a_entry_bounds(scene.inst_aabb_min, scene.inst_aabb_max,
                                 o, d, t_min, t_max, n_tiles, TILE)
    tids, iids, coarse = build_worklist(entry, P_cap)

    # 2) subgroup refinement (world space).
    stats = subgroup_stats(o, d, t_min, t_max, G)
    fine = refine_pairs(stats, tids, iids, scene.inst_aabb_min,
                        scene.inst_aabb_max, SPT, n_tiles)     # (P, SPT)
    from .pallas_dense import compact_indices
    sub = (tids[:, None] * SPT
           + jnp.arange(SPT, dtype=jnp.int32)[None, :]).reshape(-1)
    inst = jnp.broadcast_to(iids[:, None], fine.shape).reshape(-1)
    valid = jnp.isfinite(fine).reshape(-1)
    sel, q_total = compact_indices(valid, Q_cap)
    qvalid = jnp.arange(Q_cap) < q_total
    qsub = jnp.where(qvalid, jnp.take(sub, sel), n_sub)
    qinst = jnp.where(qvalid, jnp.take(inst, sel), 0)

    # 3) per-pair local-space rays + feature table.
    inv = jnp.take(scene.inst_inv, qinst, axis=0)              # (Q, 3, 4)
    grp = lambda a, f: jnp.concatenate(
        [a.reshape((n_sub, G) + a.shape[1:]),
         jnp.full((1, G) + a.shape[1:], f, a.dtype)])
    o_g = jnp.take(grp(o, 0.0), jnp.minimum(qsub, n_sub), axis=0)
    d_g = jnp.take(grp(d, 1.0), jnp.minimum(qsub, n_sub), axis=0)
    tmin_g = jnp.take(grp(t_min, 0.0), jnp.minimum(qsub, n_sub), axis=0)
    tmax_g = jnp.take(grp(t_max, -jnp.inf), jnp.minimum(qsub, n_sub),
                      axis=0)
    tmax_g = jnp.where(qvalid[:, None], tmax_g, -jnp.inf)
    # _apply_mat3, not einsum: a DEFAULT-precision matmul may round the
    # rays below fp32.
    o_l = _apply_mat3(inv[:, None, :, :3], o_g) + inv[:, None, :, 3]
    d_l = _apply_mat3(inv[:, None, :, :3], d_g)
    d_l = jnp.where(d_l == 0.0, 0.0, d_l)
    Q = Q_cap
    phi = ray_features(o_l.reshape(-1, 3), d_l.reshape(-1, 3)) \
        .reshape(Q, G, FEAT)
    phi = phi.at[:, :, COL_TMIN].set(tmin_g)
    phi = phi.at[:, :, COL_TMAX].set(tmax_g)
    dummy = jnp.zeros((1, G, FEAT), jnp.float32) \
        .at[:, :, COL_TMAX].set(-jnp.inf)
    tbl = jnp.concatenate([phi, dummy])                        # (Q+1, G, F)

    # 4) cluster expansion in local space.
    cbase = jnp.take(scene.inst_cbase, qinst)
    ncl = jnp.take(scene.inst_ncl, qinst)
    slots = jnp.arange(S, dtype=jnp.int32)[None, :]
    crow = cbase[:, None] + jnp.minimum(slots, ncl[:, None] - 1)
    cvalid = (slots < ncl[:, None]) & qvalid[:, None]          # (Q, S)
    invd_l = safe_invdir(d_l)
    olo, ohi = jnp.min(o_l, 1), jnp.max(o_l, 1)                # (Q, 3)
    ilo, ihi = jnp.min(invd_l, 1), jnp.max(invd_l, 1)
    tlo = jnp.min(tmin_g, 1)
    thi = jnp.max(tmax_g, 1)
    bmin = jnp.take(scene.cluster_min, crow.reshape(-1), axis=0) \
        .reshape(Q, S, 3)
    bmax = jnp.take(scene.cluster_max, crow.reshape(-1), axis=0) \
        .reshape(Q, S, 3)
    e2 = bundle_entry_vs_bounds(
        olo[:, None, :], ohi[:, None, :], ilo[:, None, :], ihi[:, None, :],
        tlo[:, None], thi[:, None], bmin, bmax)                # (Q, S)
    tvalid = cvalid & jnp.isfinite(e2)

    B_cap = Q_cap * S // SPB + K_total + 1
    pair_ids = jnp.broadcast_to(
        jnp.arange(Q, dtype=jnp.int32)[:, None], (Q, S)).reshape(-1)
    block_cid, block_subs, total = group_flat_cluster_major(
        pair_ids, crow.reshape(-1), tvalid.reshape(-1), SPB=SPB,
        n_sub=Q, B_cap=B_cap, K=K_total)
    totals = jnp.stack([coarse, q_total, total])
    return block_cid, block_subs, tbl, qsub, qinst, totals


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap", "Q_cap"))
def _stage1_inst(scene, o, d, t_min, t_max, *, TILE: int, G: int, SPB: int,
                 P_cap: int, Q_cap: int):
    return _stage1_inst_core(scene, o, d, t_min, t_max, TILE, G, SPB,
                             P_cap, Q_cap)


@partial(jax.jit, static_argnames=("TILE", "G", "SPB", "P_cap", "Q_cap",
                                   "nb", "R0"))
def _fused_query_inst(scene, o, d, t_min, t_max, *, TILE: int, G: int,
                      SPB: int, P_cap: int, Q_cap: int, nb: int, R0: int):
    """One-dispatch warm path (same contract as pallas_regroup's
    _fused_query): stage1 + stage2 with predicted capacities, totals
    validated post-hoc by the caller; the readback carries a strided
    checksum of result.t as the honest completion barrier."""
    out = _stage1_inst_core(scene, o, d, t_min, t_max, TILE, G, SPB,
                            P_cap, Q_cap)
    block_cid, block_subs, tbl, qsub, qinst, totals = out
    res = _stage2_inst_core(scene, block_cid, block_subs, tbl, qsub, qinst,
                            o, d, G, SPB, nb, R0)
    csum = jnp.sum(res.t[::257], dtype=jnp.float32)
    return res, jnp.concatenate(
        [totals, jax.lax.bitcast_convert_type(csum, jnp.int32)[None]])


def _stage2_inst_core(scene, block_cid, block_subs, tbl, qsub, qinst, o, d,
                      G, SPB, nb, R0):
    C = scene.cluster_size
    R_pad = (tbl.shape[0] - 1)  # unused; rays counted via qsub domain
    n_sub_dummy = int(o.shape[0] // G)  # o here is the PADDED flat rays
    key, pair = sweep_regrouped(block_subs, block_cid, tbl, scene.tri_feats,
                                G=G, SPB=SPB, C=C, n_blocks=nb,
                                payload="pairrow")
    # Map block rows -> ray subgroups through the pair table.
    qsub_ext = jnp.concatenate(
        [qsub, jnp.full((1,), n_sub_dummy, jnp.int32)])
    subs_m = jnp.take(qsub_ext, block_subs)                    # (B_cap, SPB)
    out_key, out_pair = combine_rows_grouped(
        key, pair, subs_m, nb, G, SPB, n_sub_dummy)

    # Decode winner: pairrow payload = (block*SPB + slot)*C + lane.
    cand = out_pair[:R0]
    t = _t_from_keys(out_key[:R0])
    hit = cand >= 0
    safe = jnp.clip(cand, 0, None)
    pair_row = safe // C
    lane = safe % C
    blk = pair_row // SPB
    prim = jnp.take(block_cid, blk) * C + lane
    pairq = jnp.take(block_subs.reshape(-1), pair_row)
    inst = jnp.take(qinst, jnp.clip(pairq, 0, qinst.shape[0] - 1))
    prim = jnp.where(hit, prim, -1)
    inst = jnp.where(hit, inst, -1)

    # Exact scalar MT in the winning instance's local space (reference
    # fast_intersect_triangle, src/instanced-bvh.jl:1756-1797; t/u/v are
    # invariant under the instance transform).
    inv = jnp.take(scene.inst_inv, jnp.clip(inst, 0, None), axis=0)
    o_l = _apply_mat3(inv[:, :, :3], o[:R0]) + inv[:, :, 3]
    d_l = _apply_mat3(inv[:, :, :3], d[:R0])
    return _finalize_local(scene, prim, inst, t, o_l, d_l)


@partial(jax.jit, static_argnames=("G", "SPB", "nb", "R0"))
def _stage2_inst(scene, block_cid, block_subs, tbl, qsub, qinst, o, d, *,
                 G: int, SPB: int, nb: int, R0: int):
    return _stage2_inst_core(scene, block_cid, block_subs, tbl, qsub,
                             qinst, o, d, G, SPB, nb, R0)


def _finalize_local(scene, prim, inst, t_approx, o_l, d_l):
    from ..accel.brute import HitResult
    from ..accel.dense import gather_hit_payload
    hit = (prim >= 0) & jnp.isfinite(t_approx)
    tri, orig = gather_hit_payload(scene, jnp.clip(prim, 0, None), hit)
    v0, v1, v2 = tri.vertices[:, 0], tri.vertices[:, 1], tri.vertices[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    s1 = jnp.cross(d_l, e2)
    det = jnp.sum(s1 * e1, axis=-1)
    r = jnp.where(det != 0.0, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0)
    dvec = o_l - v0
    u = jnp.sum(dvec * s1, axis=-1) * r
    s2 = jnp.cross(dvec, e1)
    v = jnp.sum(d_l * s2, axis=-1) * r
    t = jnp.where(det != 0.0, jnp.sum(e2 * s2, axis=-1) * r, t_approx)
    u = jnp.clip(u, 0.0, 1.0)
    v = jnp.clip(v, 0.0, 1.0 - u)
    bary = jnp.where(hit[:, None], jnp.stack([1 - u - v, u, v], -1), 0.0)
    return HitResult(hit=hit, triangle=tri, t=jnp.where(hit, t, 0.0),
                     barycentric=bary,
                     prim_idx=orig,
                     instance_idx=jnp.where(hit, inst, -1))


# Capacity memory, weakref-validated like pallas_regroup's (ids recycle
# after GC; a recycled id must not inherit a dead scene's prediction) and
# size-bounded FIFO.
import weakref as _weakref

_CAP_CACHE: dict = {}
_CAP_CACHE_MAX = 64


def _cap_get(scene, ck):
    ent = _CAP_CACHE.get(ck)
    if ent is None:
        return None
    if ent.get("ref") is not None and ent["ref"]() is not scene.tri_feats:
        del _CAP_CACHE[ck]
        return None
    return ent


def _cap_put(scene, ck, p, q, nb=0):
    try:
        ref = _weakref.ref(scene.tri_feats)
    except TypeError:
        ref = None
    while len(_CAP_CACHE) >= _CAP_CACHE_MAX:
        _CAP_CACHE.pop(next(iter(_CAP_CACHE)))
    _CAP_CACHE[ck] = dict(p=p, q=q, nb=nb, ref=ref)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (max(n, 1) - 1).bit_length())


def closest_hit_instanced(scene, rays, *, tile: int = 2048,
                          subgroup: int = 32, spb: int = 16,
                          pairs_per_tile: int = 64,
                          with_checksum: bool = False):
    """Exact closest hit over a DenseInstancedScene. One host sync reads
    the true (coarse, pair, block) counts; capacities are pow2-bucketed
    and retried on overflow, so results are never truncated. Repeat
    queries at a cached (scene, shape) take a ONE-dispatch fused path
    with predicted capacities, validated post-hoc (fallback on a miss).

    with_checksum=True returns (result, checksum): a HOST float strided
    sum of result.t riding the warm path's totals readback (None when
    the fused path was not taken) — the same honest completion barrier
    contract as closest_hit_regrouped."""
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
    I = scene.n_instances
    hard_p = n_tiles * I
    hard_q = n_sub * I
    P_cap = min(pairs_per_tile * n_tiles, hard_p)
    Q_cap = min(max(4096, 4 * n_sub), hard_q)
    ck = (id(scene.tri_feats), o.shape[0], TILE, G, SPB)
    cached = _cap_get(scene, ck)
    if cached is not None:
        P_cap = min(max(4096, _next_pow2(int(cached["p"] * 1.2))), hard_p)
        Q_cap = min(max(4096, _next_pow2(int(cached["q"] * 1.2))), hard_q)
    # The compacted pair list is drawn from the (P_cap, SPT) candidate
    # matrix — a Q_cap beyond its size is shape-invalid (small batches).
    Q_cap = min(Q_cap, P_cap * (TILE // G))

    reshape_out = lambda res: jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)

    if cached is not None and cached.get("nb", 0) >= 1:
        # Warm path: ONE dispatch with predicted capacities + block grid.
        S = scene.max_clusters_per_blas
        B_cap = Q_cap * S // SPB + scene.n_clusters + 1
        nb_pred = min(cached["nb"], B_cap)
        res, totals = _fused_query_inst(
            scene, o, d, t_min, t_max, TILE=TILE, G=G, SPB=SPB,
            P_cap=P_cap, Q_cap=Q_cap, nb=nb_pred, R0=R0)
        import numpy as _np
        tarr = _np.asarray(totals)
        coarse, q_total, total = (int(x) for x in tarr[:3])
        if coarse <= P_cap and q_total <= Q_cap and total <= nb_pred:
            # Sticky-max: shrinking workloads must not move to smaller
            # capacity buckets (each bucket is a fresh compile).
            _cap_put(scene, ck, max(cached["p"], coarse),
                     max(cached["q"], q_total),
                     nb=max(cached["nb"], nb_pred))
            if with_checksum:
                return reshape_out(res), float(
                    tarr[3:4].view(_np.float32)[0])
            return reshape_out(res)

    while True:
        block_cid, block_subs, tbl, qsub, qinst, totals = _stage1_inst(
            scene, o, d, t_min, t_max, TILE=TILE, G=G, SPB=SPB,
            P_cap=P_cap, Q_cap=Q_cap)
        import numpy as _np
        coarse, q_total, total = (int(x) for x in _np.asarray(totals))
        ok_p = coarse <= P_cap
        ok_q = q_total <= Q_cap
        if ok_p and ok_q:
            break
        if P_cap >= hard_p and Q_cap >= hard_q:
            raise RuntimeError(
                f"instanced worklist overflow at hard capacity: "
                f"coarse={coarse}/{P_cap} pairs={q_total}/{Q_cap}")
        if not ok_p:
            P_cap = min(2 * P_cap, hard_p)
        if not ok_q:
            Q_cap = min(2 * Q_cap, hard_q)
        Q_cap = min(Q_cap, P_cap * (TILE // G))
    nb = 1 << max(9, (max(total, 1) - 1).bit_length())
    nb = min(nb, block_cid.shape[0])
    _cap_put(scene, ck, max(coarse, (cached or {}).get("p", 0)),
             max(q_total, (cached or {}).get("q", 0)),
             nb=max(nb, (cached or {}).get("nb", 0)))
    res = _stage2_inst(scene, block_cid, block_subs, tbl, qsub, qinst,
                       o, d, G=G, SPB=SPB, nb=nb, R0=R0)
    return (reshape_out(res), None) if with_checksum else reshape_out(res)


def instanced_capacity_hint(scene, n_rays: int, *, tile: int = 2048,
                            subgroup: int = 32, spb: int = 16,
                            headroom: float = 1.5):
    """(p_cap, q_cap, nb) for closest_hit_instanced_static, derived from
    the capacity cache a previous EAGER closest_hit_instanced at this
    (scene, shape) populated — warm up once outside jit, then drive the
    jitted pipeline with these static capacities. Returns None when no
    matching warm entry exists."""
    R0 = n_rays
    G = min(subgroup, max(8, 1 << (max(R0, 1) - 1).bit_length()))
    TILE = min(tile, max(R0, G))
    TILE = -(-TILE // G) * G
    Rp = R0 + ((-R0) % TILE)
    ck = (id(scene.tri_feats), Rp, TILE, G, spb)
    ent = _cap_get(scene, ck)
    if ent is None:
        return None
    return (_next_pow2(int(ent["p"] * headroom)),
            _next_pow2(int(ent["q"] * headroom)),
            _next_pow2(max(int(ent["nb"] * headroom), 512)))


def closest_hit_instanced_static(scene, rays, *, p_cap: int, q_cap: int,
                                 nb: int, tile: int = 2048,
                                 subgroup: int = 32, spb: int = 16):
    """Trace-safe instanced closest hit with STATIC capacities — the
    form usable INSIDE jitted pipelines (dynamic instanced scenes in a
    renderer loop), where the auto-sizing host sync of
    closest_hit_instanced cannot run.

    Returns ``(result, totals)`` where totals = int32[coarse_pairs,
    refined_pairs, blocks]. Contract (same predict-then-validate scheme
    as the engines' fused warm paths): results are exact only when
    ``totals <= (p_cap, q_cap, nb)`` — the caller must read totals on
    the host after the jitted step and re-run with doubled capacities
    on overflow. Derive capacities from a warmup query via
    instanced_capacity_hint()."""
    batch = rays.batch_shape
    flat = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    o, d = flat(rays.o), flat(rays.d)
    t_min, t_max = flat(rays.t_min), flat(rays.t_max)
    R0 = o.shape[0]
    G = min(subgroup, max(8, 1 << (max(R0, 1) - 1).bit_length()))
    TILE = min(tile, max(R0, G))
    TILE = -(-TILE // G) * G
    d = jnp.where(d == 0.0, 0.0, d)
    pad = (-R0) % TILE
    if pad:
        ext = lambda a, f: jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], f, a.dtype)])
        o, d = ext(o, 0.0), ext(d, 1.0)
        t_min, t_max = ext(t_min, 0.0), ext(t_max, -jnp.inf)
    # Clamp to the hard maxima (same as the eager driver): a cap above
    # the candidate-domain size breaks the compaction's shape contract.
    n_tiles = o.shape[0] // TILE
    n_sub = o.shape[0] // G
    p_cap = min(p_cap, n_tiles * scene.n_instances)
    q_cap = min(q_cap, n_sub * scene.n_instances, p_cap * (TILE // G))
    out = _stage1_inst_core(scene, o, d, t_min, t_max, TILE, G, spb,
                            p_cap, q_cap)
    block_cid, block_subs, tbl, qsub, qinst, totals = out
    nb = min(nb, block_cid.shape[0])     # static clamp to the block grid
    res = _stage2_inst_core(scene, block_cid, block_subs, tbl, qsub,
                            qinst, o, d, G, spb, nb, R0)
    res = jax.tree_util.tree_map(
        lambda a: a.reshape(batch + a.shape[1:]), res)
    return res, totals


def any_hit_instanced(scene, rays, **kw):
    """Occlusion over a DenseInstancedScene: t_min forced to 0
    (reference any_hit, src/instanced-bvh.jl:2045). Uses the closest-hit
    machinery; only the boolean + occluder ids are contractual."""
    rays0 = rays.replace(t_min=jnp.zeros_like(rays.t_min))
    return closest_hit_instanced(scene, rays0, **kw)

"""Parity tests for the cluster-major regrouped sweep (ops/pallas_regroup).

Oracle: brute-force closest hit over the same sorted triangle soup —
the same contract the tile worklist engine is tested against.
Hot-loop semantics target the reference's fast_intersect_triangle
(/root/reference/src/instanced-bvh.jl:1756-1797).
"""
import numpy as np
import jax.numpy as jnp
import pytest

import raycore as rc
from raycore.accel.brute import closest_hit_brute
from raycore.accel.dense import build_dense
from raycore.ops.pallas_regroup import closest_hit_regrouped


def _scene_and_rays(n=40, C=128, R=1024, seed=0, coherent=False):
    mesh = rc.displaced_grid_mesh(n=n, extent=2.0, amplitude=0.35)
    scene = build_dense(mesh, cluster_size=C)
    rng = np.random.default_rng(seed)
    if coherent:
        side = int(np.sqrt(R))
        R = side * side
        xs = np.linspace(-0.9, 0.9, side, dtype=np.float32)
        X, Y = np.meshgrid(xs, xs, indexing="ij")
        o = np.stack([X, Y, np.full_like(X, 3.0)], -1).reshape(-1, 3)
        d = np.broadcast_to(np.array([0, 0, -1], np.float32), o.shape)
    else:
        o = rng.uniform(-1, 1, (R, 3)).astype(np.float32)
        o[:, 2] = 2.0
        d = rng.normal(size=(R, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[:, 2] = -np.abs(d[:, 2]) - 0.3
    rays = rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(np.ascontiguousarray(d)))
    return scene, rays


def _check(ref, got):
    assert np.array_equal(np.asarray(ref.hit), np.asarray(got.hit))
    both = np.asarray(ref.hit)
    # t matches everywhere both hit (shared-edge ties have equal t).
    np.testing.assert_allclose(np.asarray(got.t)[both],
                               np.asarray(ref.t)[both], rtol=2e-5, atol=2e-6)
    # Shared-edge / near-coplanar hits are fp32 rounding-level ties — the
    # oracle's own winner is rounding-determined there. Any differing
    # winner must be an ulp-level t tie; the bulk must match exactly.
    # (Coherent grids can put whole ray columns exactly on mesh lattice
    # lines — e.g. x = -0.9 — so tie rates up to tens of percent are
    # geometry, not bugs; the ulp check below is the real contract.)
    pm = np.asarray(ref.prim_idx)[both] == np.asarray(got.prim_idx)[both]
    assert pm.mean() >= 0.7
    if not pm.all():
        rt = np.asarray(ref.t)[both][~pm]
        gt = np.asarray(got.t)[both][~pm]
        assert np.max(np.abs(gt - rt) / np.maximum(rt, 1e-6)) < 2e-6


@pytest.mark.slow
@pytest.mark.parametrize("combine", ["grouped", "sort", "segment"])
def test_regroup_parity_incoherent(combine):
    scene, rays = _scene_and_rays()
    ref = closest_hit_brute(scene.prims, rays)
    got = closest_hit_regrouped(scene, rays, combine=combine)
    _check(ref, got)


@pytest.mark.parametrize("C,G,SPB,passes", [(128, 32, 16, 2),
                                            (128, 32, 16, 1),
                                            (64, 32, 16, 2),
                                            (128, 16, 32, 2),
                                            (128, 32, 16, 4)])
def test_regroup_parity_configs(C, G, SPB, passes):
    scene, rays = _scene_and_rays(C=C, coherent=True)
    ref = closest_hit_brute(scene.prims, rays)
    got = closest_hit_regrouped(scene, rays, subgroup=G, spb=SPB,
                                passes=passes)
    _check(ref, got)


def test_regroup_multiwave_depth_complex():
    """passes=4 (3 ordered waves + prune) on a depth-complex scene — the
    workload the multiwave generalization exists for (tools/wave_sim.py:
    1.78x candidate reduction on 1M-tri blobby). Exactness must hold
    through the wave selection + remainder prune."""
    mesh = rc.blobby_mesh(n_theta=96, n_phi=96)
    scene = build_dense(mesh, cluster_size=128)
    rng = np.random.default_rng(3)
    R = 1024
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    o[:, 2] = 2.5
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    rays = rc.Ray.create(o=jnp.asarray(o),
                         d=jnp.asarray(np.ascontiguousarray(d)))
    ref = closest_hit_brute(scene.prims, rays)
    for p in (2, 4, 6):
        _check(ref, closest_hit_regrouped(scene, rays, passes=p))
    # Second passes=4 query rides the fused warm path (predicted
    # remainder grid + totals validation) — must stay exact.
    got, cs = closest_hit_regrouped(scene, rays, passes=4,
                                    with_checksum=True)
    _check(ref, got)
    assert cs is not None    # warm fused path was actually taken


def test_regroup_multiwave_compact_matches_sort():
    """The compact-stage1 multiwave (wave selection on the compacted
    pair list + re-compacted remainder) must produce the same hits as
    the sort-stage1 multiwave: identical wave SET per subgroup (nearest
    by the same refined entries, same cid tiebreak) and an identical
    conservative prune threshold — only the block packing differs."""
    mesh = rc.blobby_mesh(n_theta=64, n_phi=64)
    scene = build_dense(mesh, cluster_size=64)
    rng = np.random.default_rng(7)
    R = 1536
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    o[:, 2] = 2.5
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3
    rays = rc.Ray.create(o=jnp.asarray(o),
                         d=jnp.asarray(np.ascontiguousarray(d)))
    for p in (2, 4):
        a = closest_hit_regrouped(scene, rays, passes=p, stage1="sort")
        b = closest_hit_regrouped(scene, rays, passes=p, stage1="compact")
        assert np.array_equal(np.asarray(a.hit), np.asarray(b.hit))
        assert np.array_equal(np.asarray(a.prim_idx),
                              np.asarray(b.prim_idx))
        h = np.asarray(a.hit)
        np.testing.assert_allclose(np.asarray(a.t)[h], np.asarray(b.t)[h],
                                   rtol=1e-6)
    # Warm repeat rides the fused compact-multiwave executable.
    got, cs = closest_hit_regrouped(scene, rays, passes=4,
                                    stage1="compact", with_checksum=True)
    assert cs is not None
    _check(closest_hit_brute(scene.prims, rays), got)


@pytest.mark.parametrize("passes", [1, 2])
def test_regroup_slim_payload(passes):
    """payload="slim" skips the triangle-payload gather but must keep
    hit/t/prim_idx/instance_idx/metadata EXACTLY equal to the full
    result; triangle vertices and barycentric are contractually zero."""
    scene, rays = _scene_and_rays(coherent=True)
    full = closest_hit_regrouped(scene, rays, passes=passes)
    slim = closest_hit_regrouped(scene, rays, passes=passes,
                                 payload="slim")
    assert np.array_equal(np.asarray(full.hit), np.asarray(slim.hit))
    assert np.array_equal(np.asarray(full.prim_idx),
                          np.asarray(slim.prim_idx))
    assert np.array_equal(np.asarray(full.instance_idx),
                          np.asarray(slim.instance_idx))
    assert np.array_equal(np.asarray(full.triangle.metadata),
                          np.asarray(slim.triangle.metadata))
    h = np.asarray(full.hit)
    # full.t is the exact scalar recompute; slim.t is the full-precision
    # winning key — identical math modulo the recompute's rounding.
    np.testing.assert_allclose(np.asarray(slim.t)[h],
                               np.asarray(full.t)[h], rtol=2e-6, atol=2e-7)
    assert not np.asarray(slim.triangle.vertices).any()
    assert not np.asarray(slim.barycentric).any()
    # Warm repeat must route through the fused slim executable and stay
    # identical.
    slim2, cs = closest_hit_regrouped(scene, rays, passes=passes,
                                      payload="slim", with_checksum=True)
    assert np.array_equal(np.asarray(slim.prim_idx),
                          np.asarray(slim2.prim_idx))
    assert cs is not None


def test_fuse_gate_large_k(monkeypatch):
    """Above RAYCORE_FUSE_MAX_K clusters the warm path must SKIP the
    fused one-dispatch executable (its XLA compile is superlinear in K) and
    stay on the exact two-stage path: results identical, checksum None
    (the fused path's totals readback is the only checksum source)."""
    scene, rays = _scene_and_rays(coherent=True)
    ref = closest_hit_regrouped(scene, rays, passes=1)
    monkeypatch.setenv("RAYCORE_FUSE_MAX_K", "1")
    got, cs = closest_hit_regrouped(scene, rays, passes=1,
                                    with_checksum=True)
    assert cs is None
    assert np.array_equal(np.asarray(ref.hit), np.asarray(got.hit))
    assert np.array_equal(np.asarray(ref.prim_idx), np.asarray(got.prim_idx))
    monkeypatch.delenv("RAYCORE_FUSE_MAX_K")
    got2, cs2 = closest_hit_regrouped(scene, rays, passes=1,
                                      with_checksum=True)
    assert cs2 is not None    # gate lifted -> fused path again


def test_capacity_hints_not_shared_across_scene_content(tmp_path,
                                                        monkeypatch):
    """Two scenes with IDENTICAL padded shapes but different geometry
    (heightfield vs blobby both pad to the same (K, 16, 4C)) must NOT
    share persisted capacity hints: hints are sticky-max, so the denser
    scene's counts would permanently inflate the sparser scene's
    capacities — the measured round-4 4.64-vs-7.57 Mrays/s headline
    discrepancy (226 ms with polluted hints vs 138 ms scene-true)."""
    monkeypatch.setenv("RAYCORE_CAPACITY_DIR", str(tmp_path))
    from raycore.ops import capacity_store as cs
    hf = build_dense(rc.displaced_grid_mesh(n=40, extent=2.0,
                                            amplitude=0.35),
                     cluster_size=128)
    bl = build_dense(rc.blobby_mesh(n_theta=40, n_phi=40),
                     cluster_size=128)
    ck = (id(hf.tri_feats), hf.tri_feats.shape, 4096, 2048, 32, 16, 1,
          "full")
    cs.save_hint(ck, dict(coarse=999_999, nb=65536), bl)
    # Same ck shape-tail, different scene content: must MISS.
    assert cs.load_hint(ck, hf) is None
    assert cs.load_hint(ck, bl) == dict(coarse=999_999, nb=65536)
    # Same scene, fresh fingerprint cache entry: still hits.
    cs._FP_CACHE.clear()
    assert cs.load_hint(ck, bl) is not None


def test_depth_layers_and_auto_passes():
    """depth_layers separates the single-sheet heightfield (~1 layer)
    from the shell-like blobby scene (>=1.5), and passes="auto" resolves
    through it while staying exact."""
    from raycore.accel.dense import depth_layers
    from raycore.ops.pallas_regroup import auto_passes

    hf = build_dense(rc.displaced_grid_mesh(n=64, extent=2.0,
                                            amplitude=0.35),
                     cluster_size=128)
    bl = build_dense(rc.blobby_mesh(n_theta=96, n_phi=96),
                     cluster_size=128)
    d_hf, d_bl = depth_layers(hf), depth_layers(bl)
    # Assert with headroom around the 1.6 routing threshold (ADVICE r4):
    # the measured statistics (hf ~1.44, bl ~1.91) must clear it by a
    # margin, so benign mesh-generator / cluster_size tweaks that nudge
    # the statistic don't flip routing silently at the boundary.
    assert d_hf < 1.5, d_hf
    assert d_bl > 1.7, d_bl
    assert auto_passes(hf) == 1 and auto_passes(bl) == 4
    # Third scene class (VERDICT r4 weak #8): an instanced ROOM interior
    # (walls + spheres + box via the TLAS manager, baked dense). Its
    # clusters are sparse big objects that barely overlap along the
    # minor axis — measured statistic ~1.02, comfortably passes=1: the
    # per-subgroup candidate sets are small, so ordering overhead
    # cannot pay (same reason as the heightfield, different geometry
    # class).
    from raycore.scene.mesh import box_mesh, plane_mesh, sphere_mesh
    from raycore.scene.bake import bake_dense
    mgr = rc.TLAS()
    mgr.push(plane_mesh(center=(0, 0, 0), u=(4, 0, 0), v=(0, 4, 0)))
    mgr.push(plane_mesh(center=(0, 4, 2), u=(4, 0, 0), v=(0, 0, 2)))
    mgr.push(plane_mesh(center=(-4, 0, 2), u=(0, 4, 0), v=(0, 0, 2)))
    mgr.push(sphere_mesh(center=(0.0, 1.0, 1.0), radius=1.0,
                         n_theta=24, n_phi=48))
    mgr.push(sphere_mesh(center=(2.0, -0.5, 0.7), radius=0.7,
                         n_theta=24, n_phi=48))
    mgr.push(box_mesh(p_min=(-2.6, -0.4, 0.0), p_max=(-1.4, 0.8, 1.2)))
    room = bake_dense(mgr, cluster_size=128)
    d_room = depth_layers(room)
    assert d_room < 1.5, d_room
    assert auto_passes(room) == 1
    # Cached: second call is a dict hit with the same value.
    assert depth_layers(bl) == d_bl

    rng = np.random.default_rng(7)
    R = 512
    o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    o[:, 2] = 2.5
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    rays = rc.Ray.create(o=jnp.asarray(o),
                         d=jnp.asarray(np.ascontiguousarray(d)))
    for scene in (hf, bl):
        ref = closest_hit_brute(scene.prims, rays)
        _check(ref, closest_hit_regrouped(scene, rays, passes="auto"))


@pytest.mark.slow
def test_regroup_respects_t_range():
    scene, rays = _scene_and_rays(coherent=True, R=256)
    ref = closest_hit_brute(scene.prims, rays)
    # t_max below every hit distance => all misses.
    near = rays.replace(t_max=jnp.full_like(rays.t_max, 0.5))
    got = closest_hit_regrouped(scene, near)
    assert not bool(np.asarray(got.hit).any())
    # t_min beyond every hit => all misses.
    far = rays.replace(t_min=jnp.full_like(rays.t_min, 100.0))
    got = closest_hit_regrouped(scene, far)
    assert not bool(np.asarray(got.hit).any())
    # Wide-open range reproduces the oracle.
    _check(ref, closest_hit_regrouped(scene, rays))


@pytest.mark.slow
def test_regroup_small_non_multiple_of_subgroup():
    # R0=100 with subgroup=32: TILE must round up to a multiple of G
    # (previously a reshape TypeError at trace time — ADVICE.md round 1).
    scene, rays = _scene_and_rays(R=100)
    ref = closest_hit_brute(scene.prims, rays)
    got = closest_hit_regrouped(scene, rays, subgroup=32)
    _check(ref, got)


@pytest.mark.slow
def test_regroup_ragged_batch_and_2d():
    scene, rays = _scene_and_rays(R=777)      # not a multiple of TILE
    ref = closest_hit_brute(scene.prims, rays)
    got = closest_hit_regrouped(scene, rays)
    _check(ref, got)
    # 2D batch shape round-trips.
    r2 = jax.tree_util.tree_map(
        lambda a: a[:750].reshape((25, 30) + a.shape[1:]), rays)
    got2 = closest_hit_regrouped(scene, r2)
    assert got2.hit.shape == (25, 30)


import jax  # noqa: E402  (used by the ragged test)


def test_regroup_compact_stage1_parity():
    """stage1="compact" (sort-free cluster-major grouping) must produce
    the exact same results as the sort path, cold and warm (fused)."""
    scene, rays = _scene_and_rays(R=4096, coherent=True)
    ref = closest_hit_brute(scene.prims, rays)
    got = closest_hit_regrouped(scene, rays, tile=512, passes=1,
                                stage1="compact")
    _check(ref, got)
    # Second call takes the fused warm path; checksum must be real.
    got2, cs = closest_hit_regrouped(scene, rays, tile=512, passes=1,
                                     stage1="compact", with_checksum=True)
    _check(ref, got2)
    assert cs is not None
    np.testing.assert_allclose(
        cs, float(np.asarray(got2.t)[::257].sum()), rtol=1e-6)


def test_any_hit_regrouped_occlusion_contract():
    """any_hit_regrouped: hit boolean matches the brute oracle with
    t_min=0 forced; the reported occluder must be a genuine intersection
    within [0, t_max]; t/bary/triangle are zeros (occlusion contract)."""
    from raycore.core.triangle import fast_intersect_triangle
    from raycore.ops.pallas_regroup import any_hit_regrouped
    scene, rays = _scene_and_rays(R=2048, seed=9)
    import jax.numpy as jnp
    rays = rays.replace(t_min=jnp.full((2048,), 0.7, jnp.float32))
    ref = closest_hit_brute(scene.prims,
                            rays.replace(t_min=jnp.zeros((2048,))))
    got = any_hit_regrouped(scene, rays, tile=512)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    assert float(np.abs(np.asarray(got.t)).max()) == 0.0
    assert float(np.abs(np.asarray(got.triangle.vertices)).max()) == 0.0
    # Occluder validity: the reported prim really intersects the ray.
    m = np.asarray(got.hit)
    pid = np.asarray(got.prim_idx)[m]
    v = np.asarray(scene.prims.vertices)[pid]
    h, t, u, v_ = (np.asarray(x) for x in fast_intersect_triangle(
        jnp.asarray(np.asarray(rays.o)[m]), jnp.asarray(np.asarray(rays.d)[m]),
        jnp.asarray(v[:, 0]), jnp.asarray(v[:, 1]), jnp.asarray(v[:, 2]),
        jnp.zeros((m.sum(),)), jnp.full((m.sum(),), np.inf)))
    assert h.mean() > 0.999   # featurized EDGE_EPS slack allows rare edges
    # Warm second call (fused path) agrees.
    got2 = any_hit_regrouped(scene, rays, tile=512)
    np.testing.assert_array_equal(np.asarray(got2.hit), np.asarray(ref.hit))


def test_regroup_deferred_warm_path():
    """deferred=True: warm queries return (result, finalizer) with the
    totals validation deferred — the chained-dispatch bench contract.
    The finalizer must validate and return the checksum; results match
    the synced path exactly."""
    scene, rays = _scene_and_rays(R=2048, seed=11)
    ref = closest_hit_regrouped(scene, rays, tile=512, passes=1)  # warm up
    res, fin = closest_hit_regrouped(scene, rays, tile=512, passes=1,
                                     deferred=True)
    assert fin is not None, "warm shape must take the fused path"
    cs = fin()
    assert cs is not None, "finalizer must validate on identical query"
    np.testing.assert_allclose(
        cs, float(np.asarray(res.t)[::257].sum()), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(res.hit), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(res.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-6)

    # Cold shape: deferred degrades to a synced result with no finalizer.
    rays2 = _scene_and_rays(R=512, seed=12)[1]
    res2, fin2 = closest_hit_regrouped(scene, rays2, tile=256, passes=1,
                                       deferred=True)
    assert fin2 is None
    _check(closest_hit_brute(scene.prims, rays2), res2)


def test_regroup_compact_stage1_incoherent_and_ragged():
    scene, rays = _scene_and_rays(R=777, seed=5)
    ref = closest_hit_brute(scene.prims, rays)
    _check(ref, closest_hit_regrouped(scene, rays, tile=512, passes=1,
                                      stage1="compact"))


@pytest.mark.slow
def test_regroup_with_checksum_warm_path(monkeypatch):
    """with_checksum: cold call returns None, the warm fused call returns
    a host float equal to a strided sum of result.t (the bench's honest
    completion barrier rides the totals readback).

    Persistence off: the disk hint store shares keys across same-shaped
    scenes by design (ops/capacity_store.py), which would legitimately
    warm the "cold" first call here."""
    monkeypatch.setenv("RAYCORE_PERSIST_CAPACITY", "0")
    scene, rays = _scene_and_rays(coherent=True, R=4096)
    res0, cs0 = closest_hit_regrouped(scene, rays, passes=1,
                                      with_checksum=True)
    assert cs0 is None            # first call seeds the capacity cache
    res1, cs1 = closest_hit_regrouped(scene, rays, passes=1,
                                      with_checksum=True)
    assert cs1 is not None
    flat_t = np.asarray(res1.t).reshape(-1)
    np.testing.assert_allclose(cs1, np.sum(flat_t[::257], dtype=np.float32),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(res0.t), np.asarray(res1.t))

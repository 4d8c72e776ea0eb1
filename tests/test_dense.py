"""Dense clustered (matmul-featurized) engine tests — exact parity with the
brute-force oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.accel.dense import (build_dense, closest_hit_dense,
                                     any_hit_dense, ray_features,
                                     _featurize_tris)
from raycore.core.triangle import fast_intersect_triangle


def test_featurization_matches_mt(rng):
    v0 = jnp.asarray(rng.normal(size=(32, 3)), jnp.float32)
    v1 = jnp.asarray(rng.normal(size=(32, 3)), jnp.float32)
    v2 = jnp.asarray(rng.normal(size=(32, 3)), jnp.float32)
    o = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
    psi = _featurize_tris(v0, v1, v2)
    phi = ray_features(o, d)
    q = jnp.einsum("rf,tfq->rtq", phi, psi)          # (8, 32, 4)
    det, udet, vdet, tdet = (np.asarray(q[..., k]) for k in range(4))
    # Direct MT quantities.
    e1, e2 = v1 - v0, v2 - v0
    s1 = jnp.cross(d[:, None], e2[None])
    det_ref = jnp.sum(s1 * e1[None], -1)
    P = o[:, None] - v0[None]
    u_ref = jnp.sum(P * s1, -1)
    s2 = jnp.cross(P, jnp.broadcast_to(e1[None], P.shape))
    v_ref = jnp.sum(d[:, None] * s2, -1)
    t_ref = jnp.sum(e2[None] * s2, -1)
    np.testing.assert_allclose(det, det_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(udet, u_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(vdet, v_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdet, t_ref, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def heightfield():
    tris = rc.displaced_grid_mesh(n=32, extent=2.0, amplitude=0.3)
    return build_dense(tris, cluster_size=64)


def test_dense_matches_brute_coherent(heightfield):
    ds = heightfield
    xs = jnp.linspace(-0.9, 0.9, 40)
    X, Y = jnp.meshgrid(xs, xs, indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, 2.0)], -1).reshape(-1, 3)
    rays = rc.Ray.create(o=o, d=jnp.broadcast_to(jnp.array([0.0, 0, -1.0]),
                                                 o.shape))
    r = closest_hit_dense(ds, rays, tile=256)
    rb = rc.closest_hit_brute(ds.prims, rays)
    np.testing.assert_array_equal(np.asarray(r.hit), np.asarray(rb.hit))
    m = np.asarray(r.hit)
    assert m.all()
    np.testing.assert_allclose(np.asarray(r.t)[m], np.asarray(rb.t)[m],
                               rtol=1e-4, atol=1e-4)
    # Differing winners are shared-edge t-ties (t asserted equal above);
    # tie-breaking happens in sorted table space but ids report original
    # order, so oracle/engine tie winners may differ.
    assert (np.asarray(r.prim_idx)[m] == np.asarray(rb.prim_idx)[m]).mean() \
        > 0.97


def test_dense_matches_brute_incoherent(heightfield, rng):
    ds = heightfield
    n = 400
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgt = np.asarray(ds.prims.vertices[rng.integers(0, ds.prims.vertices.shape[0], n)]).mean(1)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))
    r = closest_hit_dense(ds, rays, tile=128, select_per_round=2)
    rb = rc.closest_hit_brute(ds.prims, rays)
    np.testing.assert_array_equal(np.asarray(r.hit), np.asarray(rb.hit))
    m = np.asarray(r.hit)
    np.testing.assert_allclose(np.asarray(r.t)[m], np.asarray(rb.t)[m],
                               rtol=1e-3, atol=1e-3)


def test_dense_t_range_semantics(heightfield):
    ds = heightfield
    r1 = closest_hit_dense(ds, rc.Ray.create(o=[0.0, 0, 2.0], d=[0.0, 0, -1.0],
                                             t_max=1.0), tile=8)
    assert not bool(r1.hit)
    r2 = closest_hit_dense(ds, rc.Ray.create(o=[0.0, 0, 2.0], d=[0.0, 0, -1.0],
                                             t_min=5.0), tile=8)
    assert not bool(r2.hit)
    r3 = closest_hit_dense(ds, rc.Ray.create(o=[0.0, 0, 2.0], d=[0.0, 0, -1.0]),
                           tile=8)
    assert bool(r3.hit)
    # Miss -> zero sentinel contract.
    r4 = closest_hit_dense(ds, rc.Ray.create(o=[9.0, 9, 2.0], d=[0.0, 0, -1.0]),
                           tile=8)
    assert not bool(r4.hit)
    assert np.all(np.asarray(r4.triangle.vertices) == 0)


def test_any_hit_dense(heightfield):
    ds = heightfield
    # t_min forced to zero like the reference any_hit.
    r = any_hit_dense(ds, rc.Ray.create(o=[0.0, 0, 2.0], d=[0.0, 0, -1.0],
                                        t_min=5.0), tile=8)
    assert bool(r.hit)


def test_dense_nonpow2_counts(rng):
    tris = rc.sphere_mesh(radius=1.0, n_theta=11, n_phi=23)  # odd count
    ds = build_dense(tris, cluster_size=32)
    r = closest_hit_dense(ds, rc.Ray.create(o=[0.05, 0.02, -4.0],
                                            d=[0.0, 0, 1.0]), tile=8)
    assert bool(r.hit)
    assert float(r.t) == pytest.approx(3.0, abs=0.05)


def test_probe_cache_tracks_payload_fields():
    """ADVICE r2: the per-mesh probe cache must not key only on the
    vertices array — a Triangle sharing vertices with DIFFERENT payload
    fields (replace(uv=...)) must get a fresh payload_mask, not inherit
    the stale one (which silently zeroed uv in hit payloads)."""
    mesh = rc.sphere_mesh(radius=1.0, n_theta=8, n_phi=16)
    t0 = mesh.replace(uv=jnp.zeros_like(mesh.uv))
    s0 = build_dense(t0, cluster_size=32)
    assert not (s0.payload_mask & 4)          # uv bit clear
    t1 = t0.replace(uv=jnp.ones_like(t0.uv))  # same vertices identity
    s1 = build_dense(t1, cluster_size=32)
    assert s1.payload_mask & 4                # uv bit set, not stale
    r = closest_hit_dense(s1, rc.Ray.create(o=[0.05, 0.02, -4.0],
                                            d=[0.0, 0, 1.0]), tile=8)
    assert bool(r.hit)
    assert float(jnp.abs(r.triangle.uv).max()) > 0.0


def test_flat_shaded_normals_recompute():
    """Flat-shaded meshes (stored normals == face normals, probe bit 8):
    finalize recomputes normals from the hot vertices instead of a second
    payload gather; values must match the stored normals."""
    mesh = rc.displaced_grid_mesh(n=16)        # build_triangles default:
    scene = build_dense(mesh, cluster_size=32)  # face normals
    assert scene.payload_mask & 8
    o = np.stack([*np.meshgrid(np.linspace(-0.8, 0.8, 16),
                               np.linspace(-0.8, 0.8, 16)),
                  np.full((16, 16), 3.0)], -1).reshape(-1, 3).astype(
                      np.float32)
    d = np.broadcast_to(np.array([0, 0, -1], np.float32), o.shape)
    rays = rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d.copy()))
    r = closest_hit_dense(scene, rays, tile=64)
    assert bool(np.asarray(r.hit).all())
    stored = np.asarray(mesh.normals)[np.asarray(r.prim_idx)]
    np.testing.assert_allclose(np.asarray(r.triangle.normals), stored,
                               atol=2e-6)

    # Smooth normals (not face normals): bit 8 clear, gather path intact.
    smooth = mesh.replace(normals=jnp.ones_like(mesh.normals))
    s2 = build_dense(smooth, cluster_size=32)
    assert not (s2.payload_mask & 8)
    r2 = closest_hit_dense(s2, rays, tile=64)
    np.testing.assert_allclose(np.asarray(r2.triangle.normals)
                               [np.asarray(r2.hit)], 1.0)


def test_bake_dense_matches_tlas():
    from raycore.scene.tlas import TLAS
    from raycore.scene.bake import bake_dense
    mgr = TLAS()
    mgr.push(rc.sphere_mesh(radius=1.0, n_theta=12, n_phi=24), None)
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    tr[:, :3] *= 0.5
    mgr.push(rc.box_mesh(), tr)
    scene_t = mgr.sync()
    scene_d = bake_dense(mgr, cluster_size=64)

    xs = jnp.linspace(-1.5, 4.0, 24)
    X, Y = jnp.meshgrid(xs, jnp.linspace(-1.2, 1.2, 16), indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, -4.0)], -1).reshape(-1, 3)
    rays = rc.Ray.create(o=o, d=jnp.broadcast_to(jnp.asarray([0.0, 0, 1.0]),
                                                 o.shape))
    rt = rc.closest_hit(scene_t, rays, tile_size=128)
    rd = closest_hit_dense(scene_d, rays, tile=128)
    np.testing.assert_array_equal(np.asarray(rt.hit), np.asarray(rd.hit))
    m = np.asarray(rt.hit)
    np.testing.assert_allclose(np.asarray(rt.t)[m], np.asarray(rd.t)[m],
                               rtol=2e-4, atol=2e-4)
    # Material metadata survives baking.
    mm = m & (np.asarray(rt.t) > 0)
    assert (np.asarray(rt.triangle.metadata)[mm]
            == np.asarray(rd.triangle.metadata)[mm]).mean() > 0.98
    # Instance identity survives baking (VERDICT r1 #8): baked hits must
    # report the same instance slot the TLAS traversal reports.
    np.testing.assert_array_equal(np.asarray(rt.instance_idx)[m],
                                  np.asarray(rd.instance_idx)[m])
    assert np.asarray(rd.instance_idx)[~m].max(initial=-1) == -1
    # The worklist sweep engine's finalize path reports it too.
    from raycore.ops.pallas_dense import closest_hit_dense_pallas_auto
    rp = closest_hit_dense_pallas_auto(scene_d, rays, tile=128)
    np.testing.assert_array_equal(np.asarray(rt.hit), np.asarray(rp.hit))
    np.testing.assert_array_equal(np.asarray(rt.instance_idx)[m],
                                  np.asarray(rp.instance_idx)[m])


def test_prims_hot_is_int32():
    """Layout discipline: prims_hot must be int32 end-to-end. Small ints
    bitcast into f32 are denormals, and f32 ops may flush denormals to
    zero — an f32 hot matrix silently zeroed every hit's prim index and
    metadata on device (CPU tests can't catch the flush itself, so pin
    the dtype)."""
    mesh = rc.displaced_grid_mesh(n=16, extent=2.0, amplitude=0.3)
    scene = build_dense(mesh, cluster_size=64)
    assert scene.prims_hot.dtype == jnp.int32
    n = mesh.vertices.shape[0]
    orig = np.asarray(scene.prims_hot[:, 10])
    real = orig[orig < n]
    # The original-index column is a permutation of 0..n-1 (+ padding).
    assert len(np.unique(real)) == n
    meta = np.asarray(scene.prims_hot[:, 9])
    assert meta[orig < n].max() >= 0


def test_root_aabb_excludes_padding_sentinels():
    """root_aabb must be the REAL scene bound: capacity padding lives at
    PAD_COORD (1e30) and sorts into tail clusters, and an unmasked
    reduce once reported root max = 1e30 — corrupting world_bound, the
    prewarm ray grids, and the scene content fingerprint."""
    mesh = rc.displaced_grid_mesh(n=100, extent=2.0, amplitude=0.35)
    for C in (64, 128):
        scene = build_dense(mesh, cluster_size=C)
        root = np.asarray(scene.root_aabb)
        v = np.asarray(mesh.vertices).reshape(-1, 3)
        assert np.all(np.abs(root) < 1e6), root
        np.testing.assert_allclose(root[0], v.min(0), atol=1e-5)
        np.testing.assert_allclose(root[1], v.max(0), atol=1e-5)

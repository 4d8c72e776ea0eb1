"""Intersection tests — ports coverage of reference test/test_intersection.jl
plus Möller–Trumbore hot-loop semantics checks."""
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.core import triangle as T


def make_tri(v0, v1, v2):
    return rc.Triangle.create(jnp.asarray([np.stack([v0, v1, v2])], jnp.float32))


def test_watertight_hit_t_bary():
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    ray = rc.Ray.create(o=[0.25, 0.25, -3.0], d=[0, 0, 1.0])
    hit, t, bary = T.intersect_triangle(tri, ray.o, ray.d, ray.t_max)
    assert bool(hit)
    assert float(t) == pytest.approx(3.0, rel=1e-6)
    np.testing.assert_allclose(np.asarray(bary).sum(), 1.0, rtol=1e-6)
    # Barycentric reconstruction of the hit point.
    p = np.asarray(bary) @ tri
    np.testing.assert_allclose(p, [0.25, 0.25, 0.0], atol=1e-6)


def test_watertight_miss_outside_and_behind():
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    # Outside the triangle.
    hit, _, _ = T.intersect_triangle(tri, jnp.array([2.0, 2.0, -1.0]),
                                     jnp.array([0.0, 0, 1.0]), jnp.inf)
    assert not bool(hit)
    # Behind the origin.
    hit2, _, _ = T.intersect_triangle(tri, jnp.array([0.25, 0.25, -1.0]),
                                      jnp.array([0.0, 0, -1.0]), jnp.inf)
    assert not bool(hit2)
    # Beyond t_max.
    hit3, _, _ = T.intersect_triangle(tri, jnp.array([0.25, 0.25, -10.0]),
                                      jnp.array([0.0, 0, 1.0]), 5.0)
    assert not bool(hit3)


def test_watertight_degenerate_rejected():
    tri = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)  # collinear
    hit, _, _ = T.intersect_triangle(tri, jnp.array([0.5, 0.0, -1.0]),
                                     jnp.array([0.0, 0, 1.0]), jnp.inf)
    assert not bool(hit)


def test_moller_trumbore_matches_watertight_on_clean_hits(rng):
    n = 256
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(0.1, 1, (n, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, -0.1, (n, 3)).astype(np.float32)
    o = np.array([0, 0, -5], np.float32)
    d = np.array([0.01, 0.02, 1.0], np.float32)
    hw, tw, _ = T.intersect_triangle(
        np.stack([v0, v1, v2], axis=1), jnp.asarray(o), jnp.asarray(d), jnp.inf)
    hm, tm, um, vm = T.fast_intersect_triangle(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(v0), jnp.asarray(v1),
        jnp.asarray(v2), 0.0, jnp.inf)
    hw, hm = np.asarray(hw), np.asarray(hm)
    # Hit masks agree except possibly at exact edges; none expected here.
    np.testing.assert_array_equal(hw, hm)
    np.testing.assert_allclose(np.asarray(tw)[hw], np.asarray(tm)[hm],
                               rtol=1e-4, atol=1e-5)


def test_mt_t_range_semantics():
    v0 = jnp.array([0.0, 0, 0]); v1 = jnp.array([1.0, 0, 0]); v2 = jnp.array([0.0, 1, 0])
    o = jnp.array([0.2, 0.2, -2.0]); d = jnp.array([0.0, 0, 1.0])
    hit, t, u, v = T.fast_intersect_triangle(o, d, v0, v1, v2, 0.0, jnp.inf)
    assert bool(hit) and float(t) == pytest.approx(2.0)
    assert float(u) == pytest.approx(0.2) and float(v) == pytest.approx(0.2)
    # t below t_min rejected (closed range test, :1792-1794).
    hit2, *_ = T.fast_intersect_triangle(o, d, v0, v1, v2, 2.5, jnp.inf)
    assert not bool(hit2)
    hit3, *_ = T.fast_intersect_triangle(o, d, v0, v1, v2, 2.0, jnp.inf)
    assert bool(hit3)  # t == t_min accepted
    hit4, *_ = T.fast_intersect_triangle(o, d, v0, v1, v2, 0.0, 1.9)
    assert not bool(hit4)


def test_mt_zero_triangle_sentinel_misses():
    z = jnp.zeros(3)
    hit, t, u, v = T.fast_intersect_triangle(
        jnp.array([0.3, 0.3, -5.0]), jnp.array([0.0, 0, 1.0]), z, z, z, 0.0, jnp.inf)
    assert not bool(hit)
    assert float(t) == 0.0 and float(u) == 0.0 and float(v) == 0.0


def test_safe_invdir():
    inv = np.asarray(rc.safe_invdir(jnp.array([0.0, -0.0, 2.0])))
    assert inv[0] == pytest.approx(1e5)
    assert inv[1] == pytest.approx(-1e5)
    assert inv[2] == pytest.approx(0.5)
    inv2 = np.asarray(rc.safe_invdir(jnp.array([1e-6, -1e-6, -3.0])))
    assert inv2[0] == pytest.approx(1e5)
    assert inv2[1] == pytest.approx(-1e5)


def test_empty_triangle_sentinel():
    e = rc.empty_triangle()
    assert np.all(np.asarray(e.vertices) == 0)
    assert np.all(np.asarray(e.uv) == 0)
    assert int(e.metadata) == 0


def test_brute_force_closest_hit_sphere():
    tris = rc.sphere_mesh(center=(0, 0, 0), radius=1.0, n_theta=24, n_phi=48)
    rays = rc.Ray.create(o=[0.05, 0.02, -4.0], d=[0.0, 0, 1.0])
    res = rc.closest_hit_brute(tris, rays)
    assert bool(res.hit)
    # Faceted sphere: entry depth slightly above 3 = 4 - radius.
    assert float(res.t) == pytest.approx(3.0, abs=0.02)
    assert np.asarray(res.barycentric).sum() == pytest.approx(1.0, rel=1e-5)
    # Miss path returns the zero sentinel.
    miss = rc.closest_hit_brute(tris, rc.Ray.create(o=[0.05, 5, -4.0], d=[0, 0, 1.0]))
    assert not bool(miss.hit)
    assert np.all(np.asarray(miss.triangle.vertices) == 0)
    assert float(miss.t) == 0.0
    assert int(miss.prim_idx) == -1


def test_brute_force_grid_batch():
    tris = rc.sphere_mesh(radius=1.0, n_theta=16, n_phi=32)
    xs = jnp.linspace(-2, 2, 32)
    X, Y = jnp.meshgrid(xs, xs, indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, -4.0)], -1)
    rays = rc.Ray.create(o=o, d=jnp.broadcast_to(jnp.array([0.0, 0, 1.0]), o.shape))
    res = rc.closest_hit_brute(tris, rays)
    hits = np.asarray(res.hit)
    assert hits.shape == (32, 32)
    frac = hits.mean()
    # Disk of radius 1 in a 4x4 window: pi/16 ≈ 0.196.
    assert 0.1 < frac < 0.3
    # any_hit agrees on the mask.
    res2 = rc.any_hit_brute(tris, rays)
    np.testing.assert_array_equal(hits, np.asarray(res2.hit))


def test_area_and_normals():
    tri = make_tri(np.zeros(3, np.float32), np.array([2, 0, 0], np.float32),
                   np.array([0, 2, 0], np.float32))
    assert float(T.area(tri)[0]) == pytest.approx(2.0)
    np.testing.assert_allclose(np.asarray(T.normal(tri))[0], [0, 0, 1], atol=1e-6)


def test_partial_derivatives_fallback():
    verts = jnp.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], jnp.float32)
    uv = jnp.array([[0, 0], [1, 0], [0, 1]], jnp.float32)
    dpdu, dpdv, _, _ = T.partial_derivatives(verts, uv)
    np.testing.assert_allclose(dpdu, [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(dpdv, [0, 1, 0], atol=1e-6)
    # Degenerate uv -> orthonormal fallback frame, still orthogonal to n.
    uv0 = jnp.zeros((3, 2), jnp.float32)
    du, dv, _, _ = T.partial_derivatives(verts, uv0)
    n = np.array([0, 0, 1.0])
    assert abs(np.dot(np.asarray(du), n)) < 1e-6
    assert abs(np.dot(np.asarray(dv), n)) < 1e-6

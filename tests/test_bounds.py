"""Bounds2/3 API tests — ports the coverage of reference test/bounds.jl."""
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.core import bounds as B


def test_empty_default_invalid():
    b = rc.Bounds3.empty()
    assert np.all(np.asarray(b.p_min) == np.inf)
    assert np.all(np.asarray(b.p_max) == -np.inf)
    assert not bool(B.is_valid(b))


def test_from_points_sorts():
    b = rc.Bounds3.from_points([1, 5, 3], [4, 2, 6])
    np.testing.assert_allclose(b.p_min, [1, 2, 3])
    np.testing.assert_allclose(b.p_max, [4, 5, 6])


def test_union_box_box_and_point():
    a = rc.Bounds3.from_points([0, 0, 0], [1, 1, 1])
    b = rc.Bounds3.from_points([2, -1, 0.5], [3, 0.5, 2])
    u = B.union(a, b)
    np.testing.assert_allclose(u.p_min, [0, -1, 0])
    np.testing.assert_allclose(u.p_max, [3, 1, 2])
    up = B.union(a, jnp.array([5.0, 0.5, -2.0]))
    np.testing.assert_allclose(up.p_max, [5, 1, 1])
    np.testing.assert_allclose(up.p_min, [0, 0, -2])
    # Empty box is the union identity.
    e = B.union(rc.Bounds3.empty(), a)
    np.testing.assert_allclose(e.p_min, a.p_min)
    np.testing.assert_allclose(e.p_max, a.p_max)


def test_intersect_overlaps_inside():
    a = rc.Bounds3.from_points([0, 0, 0], [2, 2, 2])
    b = rc.Bounds3.from_points([1, 1, 1], [3, 3, 3])
    i = B.intersect_bounds(a, b)
    np.testing.assert_allclose(i.p_min, [1, 1, 1])
    np.testing.assert_allclose(i.p_max, [2, 2, 2])
    assert bool(B.overlaps(a, b))
    c = rc.Bounds3.from_points([5, 5, 5], [6, 6, 6])
    assert not bool(B.overlaps(a, c))
    assert bool(B.inside(a, [1, 1, 1]))
    assert bool(B.inside(a, [2, 2, 2]))          # inclusive upper
    assert not bool(B.inside_exclusive(a, [2, 2, 2]))
    assert not bool(B.inside(a, [3, 0, 0]))


def test_geometry_queries():
    b = rc.Bounds3.from_points([0, 0, 0], [2, 3, 4])
    np.testing.assert_allclose(B.diagonal(b), [2, 3, 4])
    assert float(B.surface_area(b)) == pytest.approx(2 * (6 + 8 + 12))
    assert float(B.volume(b)) == pytest.approx(24)
    assert int(B.maximum_extent(b)) == 2
    np.testing.assert_allclose(B.lerp(b, jnp.array([0.5, 0.5, 0.5])), [1, 1.5, 2])
    np.testing.assert_allclose(B.offset(b, [1, 1.5, 2]), [0.5, 0.5, 0.5])
    ex = B.expand(b, 1.0)
    np.testing.assert_allclose(ex.p_min, [-1, -1, -1])
    np.testing.assert_allclose(ex.p_max, [3, 4, 5])


def test_corners():
    b = rc.Bounds3.from_points([0, 0, 0], [1, 2, 3])
    cs = np.asarray(B.corners(b))
    assert cs.shape == (8, 3)
    np.testing.assert_allclose(cs[0], [0, 0, 0])
    np.testing.assert_allclose(cs[7], [1, 2, 3])
    np.testing.assert_allclose(np.asarray(B.corner(b, 1)), [1, 0, 0])
    np.testing.assert_allclose(np.asarray(B.corner(b, 6)), [0, 2, 3])


def test_bounding_sphere():
    b = rc.Bounds3.from_points([-1, -1, -1], [1, 1, 1])
    c, r = B.bounding_sphere(b)
    np.testing.assert_allclose(c, [0, 0, 0])
    assert float(r) == pytest.approx(np.sqrt(3), rel=1e-6)
    # Invalid box -> radius 0 (center not inside).
    e = rc.Bounds3.empty()
    _, r0 = B.bounding_sphere(e)
    assert float(r0) == 0.0


def test_ray_slab_hit_miss():
    b = rc.Bounds3.from_points([-1, -1, -1], [1, 1, 1])
    hit, t0, t1 = B.intersect_ray(b, jnp.array([0.0, 0, -5]), jnp.array([0.0, 0, 1]), jnp.inf)
    assert bool(hit)
    assert float(t0) == pytest.approx(4.0)
    assert float(t1) == pytest.approx(6.0)
    hit2, _, _ = B.intersect_ray(b, jnp.array([0.0, 0, -5]), jnp.array([0.0, 0, -1]), jnp.inf)
    assert not bool(hit2)
    # Origin inside: entry clamps to 0.
    hit3, t03, t13 = B.intersect_ray(b, jnp.array([0.0, 0, 0]), jnp.array([0.0, 0, 1]), jnp.inf)
    assert bool(hit3) and float(t03) == 0.0 and float(t13) == pytest.approx(1.0)
    # t_max clips.
    hit4, _, _ = B.intersect_ray(b, jnp.array([0.0, 0, -5]), jnp.array([0.0, 0, 1]), 3.0)
    assert not bool(hit4)


def test_intersect_p_precomputed():
    b = rc.Bounds3.from_points([-1, -1, -1], [1, 1, 1])
    o = jnp.array([0.0, 0, -5])
    d = jnp.array([0.0, 0, 1.0])
    inv_d = 1.0 / d
    assert bool(B.intersect_p(b, o, jnp.inf, inv_d))
    assert not bool(B.intersect_p(b, o, 3.0, inv_d))
    assert bool(B.intersect_p(b, jnp.array([0.0, 0, 5]), jnp.inf, 1.0 / jnp.array([1e-20, 1e-20, -1.0])))


def test_fast_intersect_bbox_matches_reference_form():
    # entry<=exit iff hit; clamped to [t_min, t_max].
    o = jnp.array([0.0, 0.0, -5.0])
    inv = rc.safe_invdir(jnp.array([0.0, 0.0, 1.0]))
    lo, hi = B.fast_intersect_bbox(o, inv, jnp.array([-1.0, -1, -1]), jnp.array([1.0, 1, 1]), 0.0, jnp.inf)
    assert float(lo) == pytest.approx(4.0) and float(hi) == pytest.approx(6.0)
    lo2, hi2 = B.fast_intersect_bbox(o, inv, jnp.array([-1.0, -1, 10]), jnp.array([1.0, 1, 12]), 0.0, 5.0)
    assert float(lo2) > float(hi2)  # miss by t_max clip


def test_fast_intersect_bbox_clamped_axis_outside_keeps_far_hit():
    """ADVICE r2: a clamped axis (|d| <= 1e-5) with origin OUTSIDE the
    slab must keep the finite (conservative) clamped interval, not force
    empty — the ray genuinely enters at large finite t."""
    o = jnp.array([0.0, 0.0, 0.0])
    inv = rc.safe_invdir(jnp.array([1e-6, 1.0, 0.0]))   # x clamped
    # Slab x in [1, 2]; y in [0, 3e6] so the true overlap (t ~ 1e6..2e6)
    # lies inside the y interval. Clamped-x interval is [1e5, 2e5] —
    # an entry underestimate, still a non-empty overlap.
    lo, hi = B.fast_intersect_bbox(o, inv, jnp.array([1.0, 0.0, -1.0]),
                                   jnp.array([2.0, 3e6, 1.0]),
                                   0.0, jnp.inf)
    assert float(lo) <= float(hi)   # node kept (pre-fix: culled)


def test_fast_intersect_bbox_genuine_near_parallel_not_misflagged():
    """|d| just above the 1e-5 clamp inverts to just below the clamp
    constant; it must take the normal product path (pre-fix a 0.99e5
    detector threshold forced these to empty when outside)."""
    d = jnp.array([1.005e-5, 1.0, 0.0])
    inv = rc.safe_invdir(d)
    assert float(jnp.abs(inv[0])) < 1.0 / 1e-5
    o = jnp.array([0.0, 0.0, 0.0])
    lo, hi = B.fast_intersect_bbox(o, inv, jnp.array([1.0, 0.0, -1.0]),
                                   jnp.array([2.0, 3e6, 1.0]),
                                   0.0, jnp.inf)
    assert float(lo) <= float(hi)
    # Entry matches the true product (1-0)/d_x.
    assert float(lo) == pytest.approx(1.0 / 1.005e-5, rel=1e-3)


def test_bounds2():
    b = rc.Bounds2.from_points([0, 0], [2, 4])
    np.testing.assert_allclose(B.diagonal(b), [2, 4])
    assert float(B.area(b)) == pytest.approx(8.0)
    assert not bool(B.is_valid(rc.Bounds2.empty()))


def test_batched_ops():
    pmin = jnp.zeros((5, 3))
    pmax = jnp.ones((5, 3)) * jnp.arange(1, 6, dtype=jnp.float32)[:, None]
    b = rc.Bounds3(p_min=pmin, p_max=pmax)
    sa = np.asarray(B.surface_area(b))
    assert sa.shape == (5,)
    np.testing.assert_allclose(sa, 6 * np.arange(1, 6.0) ** 2, rtol=1e-6)

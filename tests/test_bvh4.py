"""BVH4 collapse + 4-wide traversal tests — ports coverage of reference
test BVH4 sections (build_blas4, closest_hit4/any_hit4 parity)."""
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.accel import wide
from raycore.accel.lbvh import build_blas
from raycore.accel.types import f32_as_i32


def rand_tris(rng, n, extent=2.0, size=0.1):
    base = rng.uniform(-extent, extent, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    return rc.Triangle.create(jnp.asarray(base + offs))


def aimed_rays(rng, tris, n):
    c = np.asarray(tris.vertices).mean(1)
    tgt = c[rng.integers(0, len(c), n)] \
        + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))


def test_collapse_structure(rng):
    tris = rand_tris(rng, 64)
    blas = build_blas(tris)
    b4 = wide.collapse_blas(blas)
    assert b4.nodes4.shape == (63, 32)
    nodes4 = np.asarray(b4.nodes4)           # int32-packed
    refs = nodes4[:, 24:28]
    boxes = nodes4[:, :24].view(np.float32)
    # Root row 0: all slot AABBs either valid boxes or empty sentinels.
    leaf_bit = 1 << 30
    # Count reachable leaves from root by BFS over rows.
    seen_prims = set()
    frontier = [0]
    visited = set()
    while frontier:
        r = frontier.pop()
        if r in visited:
            continue
        visited.add(r)
        for k in range(4):
            ref = refs[r, k]
            if ref == -1:
                continue
            if ref & leaf_bit:
                seen_prims.add(ref & (leaf_bit - 1))
            else:
                frontier.append(ref)
    assert seen_prims == set(range(64))   # every sorted prim reachable once
    # Slot AABBs contain the referenced prim bounds.
    verts = np.asarray(b4.prims.vertices)
    for r in visited:
        for k in range(4):
            ref = refs[r, k]
            if ref != -1 and (ref & leaf_bit):
                p = ref & (leaf_bit - 1)
                lo = boxes[r, 6 * k:6 * k + 3]
                hi = boxes[r, 6 * k + 3:6 * k + 6]
                assert np.all(verts[p].min(0) >= lo - 1e-5)
                assert np.all(verts[p].max(0) <= hi + 1e-5)


@pytest.mark.parametrize("n_tris", [7, 128, 501])
def test_closest_hit4_matches_brute(rng, n_tris):
    tris = rand_tris(rng, n_tris)
    b4 = wide.build_blas4(tris)
    rays = aimed_rays(rng, tris, 256)
    r4 = wide.closest_hit4(b4, rays, tile_size=256)
    rb = rc.closest_hit_brute(tris, rays)
    h4, hb = np.asarray(r4.hit), np.asarray(rb.hit)
    np.testing.assert_array_equal(h4, hb)
    assert h4.sum() > 30
    np.testing.assert_allclose(np.asarray(r4.t)[h4], np.asarray(rb.t)[hb],
                               rtol=1e-4, atol=1e-5)
    m4 = np.asarray(r4.triangle.metadata)[h4]
    mb = np.asarray(rb.triangle.metadata)[hb]
    assert (m4 == mb).mean() > 0.98


def test_any_hit4(rng):
    tris = rand_tris(rng, 200)
    b4 = wide.build_blas4(tris)
    rays = aimed_rays(rng, tris, 128)
    a = wide.any_hit4(b4, rays, tile_size=128)
    c = wide.closest_hit4(b4, rays, tile_size=128)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(c.hit))
    m = np.asarray(a.hit)
    assert np.all(np.asarray(a.t)[m] >= np.asarray(c.t)[m] - 1e-5)


def _bvh4_depth(nodes4):
    """Max root-to-leaf depth in BVH4 rows (host BFS)."""
    refs = np.asarray(nodes4)[:, 24:28]
    leaf_bit = 1 << 30
    depth = {0: 1}
    frontier = [0]
    best = 1
    while frontier:
        r = frontier.pop()
        for k in range(4):
            ref = refs[r, k]
            if ref == -1 or (ref & leaf_bit):
                continue
            if ref not in depth or depth[ref] < depth[r] + 1:
                depth[ref] = depth[r] + 1
                best = max(best, depth[ref])
                frontier.append(ref)
    return best


def test_collapse_interior_preference_on_skewed_tree(rng):
    """Reference gather_children_bvh2 prefers expanding interior nodes so
    all 4 slots fill (src/bvh4.jl:235). On a leaf-skewed (caterpillar)
    Karras tree the naive both-grandchildren collapse leaves a slot empty
    at every step and only halves the depth; interior preference must cut
    it to ~D/3 AND keep exact brute parity."""
    # Exponentially clustered x positions -> morton split at a different
    # leading bit every level -> caterpillar BVH2.
    n = 128
    x = (2.0 ** -np.arange(n, dtype=np.float64)).astype(np.float32)
    base = np.stack([x, np.zeros_like(x), np.zeros_like(x)], -1)[:, None, :]
    offs = np.array([[0, 0, 0], [0, 0.01, 0], [0, 0, 0.01]],
                    np.float32)[None] * np.maximum(x, 1e-6)[:, None, None]
    tris = rc.Triangle.create(jnp.asarray(base + offs))
    blas = build_blas(tris)
    b4 = wide.collapse_blas(blas)
    d4 = _bvh4_depth(b4.nodes4)
    # BVH2 depth of the caterpillar is ~n; the naive collapse gives ~n/2.
    # Interior preference must beat that decisively.
    assert d4 < n // 2 - 8, f"BVH4 depth {d4} — interior preference inactive?"
    # Parity on the skewed tree.
    rays = aimed_rays(rng, tris, 128)
    r4 = wide.closest_hit4(b4, rays, tile_size=128)
    rb = rc.closest_hit_brute(tris, rays)
    np.testing.assert_array_equal(np.asarray(r4.hit), np.asarray(rb.hit))
    m = np.asarray(r4.hit)
    np.testing.assert_allclose(np.asarray(r4.t)[m], np.asarray(rb.t)[m],
                               rtol=1e-4, atol=1e-5)


def test_bvh4_sphere_depth():
    tris = rc.sphere_mesh(radius=1.0, n_theta=16, n_phi=32)
    b4 = wide.build_blas4(tris)
    r = wide.closest_hit4(
        b4, rc.Ray.create(o=[0.05, 0.02, -4.0], d=[0.0, 0, 1.0]),
        tile_size=8)
    assert bool(r.hit)
    assert float(r.t) == pytest.approx(3.0, abs=0.05)

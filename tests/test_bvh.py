"""LBVH build + two-level traversal tests — ports coverage of reference
test/test_instanced_bvh.jl (Morton ordering, build structure, closest/any
hit, transforms, handles, delete/sync)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.accel import morton, traversal as trav
from raycore.accel.lbvh import build_blas, karras_topology, refit_aabbs
from raycore.accel.types import INVALID_NODE, f32_as_i32
from raycore.scene.tlas import TLAS, blas_to_static_tlas


def rand_tris(rng, n, extent=2.0, size=0.1):
    base = rng.uniform(-extent, extent, (n, 1, 3)).astype(np.float32)
    offs = rng.uniform(-size, size, (n, 3, 3)).astype(np.float32)
    return rc.Triangle.create(jnp.asarray(base + offs))


def rand_rays(rng, n, extent=3.0):
    o = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))


def aimed_rays(rng, tris, n):
    """Rays from random origins aimed at random triangle centroids (with
    jitter), guaranteeing a healthy hit rate on sparse scenes."""
    c = np.asarray(tris.vertices).mean(1)
    tgt = c[rng.integers(0, len(c), n)] \
        + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))


# ---------------------------------------------------------------------------
# Morton / Karras
# ---------------------------------------------------------------------------

def test_expand_bits_and_morton():
    # expand_bits dilates so bits land 3 apart.
    assert int(morton.expand_bits(jnp.uint32(1))) == 1
    assert int(morton.expand_bits(jnp.uint32(2))) == 8
    assert int(morton.expand_bits(jnp.uint32(3))) == 9
    # x dominates the top bit of each triad.
    cx = int(morton.morton_code_30bit(jnp.array([1.0, 0, 0])))
    cy = int(morton.morton_code_30bit(jnp.array([0.0, 1.0, 0])))
    cz = int(morton.morton_code_30bit(jnp.array([0.0, 0, 1.0])))
    assert cx > cy > cz
    # Clamp beyond [0,1].
    c_hi = int(morton.morton_code_30bit(jnp.array([2.0, 2.0, 2.0])))
    c_1 = int(morton.morton_code_30bit(jnp.array([1.0, 1.0, 1.0])))
    assert c_hi == c_1 == (2 ** 30 - 1)


def test_morton_orders_along_axis():
    # Points along +x should get nondecreasing codes.
    xs = jnp.linspace(0, 1, 64)
    pts = jnp.stack([xs, jnp.zeros(64), jnp.zeros(64)], -1)
    codes = np.asarray(morton.morton_code_30bit(pts))
    assert np.all(np.diff(codes.astype(np.int64)) >= 0)


@pytest.mark.slow
def test_karras_topology_structure(rng):
    for n in (2, 3, 8, 33, 128):
        codes = jnp.asarray(
            np.sort(rng.integers(0, 2 ** 30, n).astype(np.uint32)))
        c0, c1, parent = jax.tree_util.tree_map(
            np.asarray, karras_topology(codes))
        total = 2 * n - 1
        # Every node except the root has exactly one parent.
        child_count = np.zeros(total, np.int64)
        for c in np.concatenate([c0, c1]):
            child_count[c] += 1
        assert child_count[0] == 0          # root is nobody's child
        assert np.all(child_count[1:] == 1)
        # Parent pointers invert the child arrays.
        for i in range(n - 1):
            assert parent[c0[i]] == i
            assert parent[c1[i]] == i
        assert parent[0] == -1


def test_karras_duplicate_codes(rng):
    # All-identical codes must still build a valid tree (index tiebreak).
    n = 16
    codes = jnp.asarray(np.full(n, 12345, np.uint32))
    c0, c1, parent = jax.tree_util.tree_map(np.asarray, karras_topology(codes))
    child_count = np.zeros(2 * n - 1, np.int64)
    for c in np.concatenate([c0, c1]):
        child_count[c] += 1
    assert child_count[0] == 0 and np.all(child_count[1:] == 1)


def test_refit_covers_leaves(rng):
    n = 64
    codes = jnp.asarray(np.sort(rng.integers(0, 2 ** 30, n).astype(np.uint32)))
    c0, c1, _ = karras_topology(codes)
    lo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.2, (n, 3)).astype(np.float32)
    mn, mx = jax.tree_util.tree_map(
        np.asarray, refit_aabbs(c0, c1, jnp.asarray(lo), jnp.asarray(hi)))
    # Root bound equals union of all leaves.
    np.testing.assert_allclose(mn[0], lo.min(0), rtol=1e-6)
    np.testing.assert_allclose(mx[0], hi.max(0), rtol=1e-6)
    # Every internal node contains its children.
    c0, c1 = np.asarray(c0), np.asarray(c1)
    assert np.all(mn[: n - 1] <= mn[c0] + 1e-6)
    assert np.all(mx[: n - 1] >= mx[c1] - 1e-6)


# ---------------------------------------------------------------------------
# BLAS build
# ---------------------------------------------------------------------------

def test_blas_build_shapes_and_root(rng):
    tris = rand_tris(rng, 100)
    blas = build_blas(tris)
    assert blas.capacity == 128
    assert blas.nodes.shape == (255, 16)
    assert blas.n_prims == 100
    v = np.asarray(tris.vertices)
    np.testing.assert_allclose(np.asarray(blas.root_aabb)[0],
                               v.min((0, 1)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(blas.root_aabb)[1],
                               v.max((0, 1)), rtol=1e-6)
    # Leaf rows store prim indices 0..cap-1 and INVALID child0.
    nodes = np.asarray(blas.nodes)           # int32-packed
    c0 = nodes[:, 12]
    leaf_rows = c0 == -1
    assert leaf_rows.sum() == 128
    assert np.all(leaf_rows[127:])


def test_blas_single_and_two_triangles():
    # n=1 pads to capacity 2 without a special case.
    tri = rc.Triangle.create(jnp.asarray(
        [[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], jnp.float32))
    blas = build_blas(tri)
    assert blas.capacity == 2 and blas.n_prims == 1
    scene = blas_to_static_tlas(blas)
    res = trav.closest_hit(scene, rc.Ray.create(o=[0.2, 0.2, -5.0], d=[0, 0, 1.0]))
    assert bool(res.hit) and float(res.t) == pytest.approx(5.0, rel=1e-6)
    # Padding sentinel must never hit.
    res2 = trav.closest_hit(scene, rc.Ray.create(o=[0.2, 0.2, 5.0], d=[0, 0, 1.0]))
    assert not bool(res2.hit)


# ---------------------------------------------------------------------------
# Traversal parity vs brute force
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tris", [5, 100, 777])
def test_closest_hit_matches_brute(rng, n_tris):
    tris = rand_tris(rng, n_tris)
    scene = blas_to_static_tlas(build_blas(tris))
    rays = aimed_rays(rng, tris, 256)
    r_bvh = trav.closest_hit(scene, rays)
    r_ref = rc.closest_hit_brute(tris, rays)
    h1, h2 = np.asarray(r_bvh.hit), np.asarray(r_ref.hit)
    np.testing.assert_array_equal(h1, h2)
    assert h1.sum() > 30
    np.testing.assert_allclose(np.asarray(r_bvh.t)[h1],
                               np.asarray(r_ref.t)[h2], rtol=1e-4, atol=1e-5)
    # Same triangle selected (via metadata payload), modulo exact-t ties.
    m1 = np.asarray(r_bvh.triangle.metadata)[h1]
    m2 = np.asarray(r_ref.triangle.metadata)[h2]
    assert (m1 == m2).mean() > 0.98


@pytest.mark.slow
def test_stack_overflow_detected_and_retried(rng):
    """VERDICT r1 #10: a too-small stack must not silently drop far
    children. Duplicate-Morton geometry (many overlapping slivers at the
    same centroid cell) forces deep index-tiebreak subtrees; with
    stack_size=4 the short-stack pass overflows, and the wrapper must
    transparently re-run at the proven bound and still match brute."""
    base = rand_tris(rng, 40, extent=0.01, size=0.5)   # near-dup centroids
    far = rand_tris(rng, 24, extent=2.0, size=0.2)
    tris = jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a, b]), base, far)
    scene = blas_to_static_tlas(build_blas(tris))
    rays = aimed_rays(rng, tris, 128)
    r_small = trav.closest_hit(scene, rays, stack_size=4)
    r_ref = rc.closest_hit_brute(tris, rays)
    h1, h2 = np.asarray(r_small.hit), np.asarray(r_ref.hit)
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_allclose(np.asarray(r_small.t)[h1],
                               np.asarray(r_ref.t)[h2], rtol=1e-4, atol=1e-5)
    # The proven bound itself must never overflow.
    from raycore.accel.traversal import stack_depth_bound, _trace
    bound = stack_depth_bound(scene)
    flatr = lambda a: a.reshape((-1,) + a.shape[1:])
    _, ovf = _trace(scene, flatr(rays.o), flatr(rays.d), flatr(rays.t_min),
                    flatr(rays.t_max), any_hit=False, stack_size=bound,
                    max_iters=1 << 17, tile_size=128)
    assert not bool(ovf)


@pytest.mark.slow
def test_any_hit_mask_matches(rng):
    tris = rand_tris(rng, 333)
    scene = blas_to_static_tlas(build_blas(tris))
    rays = rand_rays(rng, 256)
    a = trav.any_hit(scene, rays)
    c = trav.closest_hit(scene, rays)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(c.hit))
    # any_hit t is a real intersection (>= closest).
    ah, ch = np.asarray(a.t), np.asarray(c.t)
    m = np.asarray(a.hit)
    assert np.all(ah[m] >= ch[m] - 1e-5)


def test_t_min_respected(rng):
    tris = rc.plane_mesh(center=(0, 0, 0), u=(2, 0, 0), v=(0, 2, 0))
    scene = blas_to_static_tlas(build_blas(tris))
    # Ray starting before the plane with t_min beyond it: closest_hit must miss.
    r = rc.Ray.create(o=[0.0, 0, -1.0], d=[0.0, 0, 1.0], t_min=2.0)
    assert not bool(trav.closest_hit(scene, r).hit)
    # ...but any_hit forces t_min=0 (reference semantics) and hits.
    assert bool(trav.any_hit(scene, r).hit)
    # t_max clipping.
    r2 = rc.Ray.create(o=[0.0, 0, -5.0], d=[0.0, 0, 1.0], t_max=4.0)
    assert not bool(trav.closest_hit(scene, r2).hit)


# ---------------------------------------------------------------------------
# TLAS instancing
# ---------------------------------------------------------------------------

def sphere():
    return rc.sphere_mesh(radius=1.0, n_theta=12, n_phi=24)


def test_tlas_two_instances_ids_and_selection():
    t = TLAS()
    tr1 = np.eye(3, 4, dtype=np.float32)
    tr2 = np.eye(3, 4, dtype=np.float32)
    tr2[0, 3] = 3.0
    h1 = t.push(sphere(), tr1)
    h2 = t.push(sphere(), tr2)
    scene = t.sync()
    assert t.n_instances == 2 and t.n_geometries == 2
    r1 = trav.closest_hit(scene, rc.Ray.create(o=[0.05, 0.02, -4], d=[0.0, 0, 1]))
    r2 = trav.closest_hit(scene, rc.Ray.create(o=[3.05, 0.02, -4], d=[0.0, 0, 1]))
    assert int(r1.instance_idx) == 0 and int(r2.instance_idx) == 1
    assert float(r1.t) == pytest.approx(3.0, abs=0.05)
    # Ray between instances misses.
    miss = trav.closest_hit(scene, rc.Ray.create(o=[1.5, 0, -4], d=[0.0, 0, 1]))
    assert not bool(miss.hit)


def test_tlas_scaled_rotated_transform():
    # Scale 2x: sphere of radius 2 at origin.
    t = TLAS()
    tr = np.zeros((3, 4), np.float32)
    tr[0, 0] = tr[1, 1] = tr[2, 2] = 2.0
    t.push(sphere(), tr)
    scene = t.sync()
    r = trav.closest_hit(scene, rc.Ray.create(o=[0.05, 0.02, -6], d=[0.0, 0, 1]))
    assert bool(r.hit)
    assert float(r.t) == pytest.approx(4.0, abs=0.1)  # 6 - 2*radius
    wb = np.asarray(scene.root_aabb)
    np.testing.assert_allclose(wb[0], [-2, -2, -2], atol=0.05)
    np.testing.assert_allclose(wb[1], [2, 2, 2], atol=0.05)


def test_tlas_closest_across_instances():
    # Two spheres along the ray; closest must win regardless of push order.
    t = TLAS()
    far = np.eye(3, 4, dtype=np.float32); far[2, 3] = 5.0
    t.push(sphere(), far)
    t.push(sphere(), None)
    scene = t.sync()
    r = trav.closest_hit(scene, rc.Ray.create(o=[0.05, 0.02, -4], d=[0.0, 0, 1]))
    assert int(r.instance_idx) == 1
    assert float(r.t) == pytest.approx(3.0, abs=0.05)


def test_multi_transform_push_shares_blas():
    t = TLAS()
    trs = []
    for k in range(5):
        m = np.eye(3, 4, dtype=np.float32)
        m[0, 3] = 3.0 * k
        trs.append(m)
    h = t.push(sphere(), transforms=trs)
    scene = t.sync()
    assert t.n_instances == 5 and t.n_geometries == 1
    for k in range(5):
        r = trav.closest_hit(scene, rc.Ray.create(o=[3.0 * k, 0, -4], d=[0.0, 0, 1]))
        assert bool(r.hit) and int(r.instance_idx) == k


def test_update_transform_refit():
    t = TLAS()
    h = t.push(sphere(), None)
    s1 = t.sync()
    assert bool(trav.closest_hit(s1, rc.Ray.create(o=[0.05, 0.02, -4], d=[0.0, 0, 1])).hit)
    m = np.eye(3, 4, dtype=np.float32)
    m[0, 3] = 10.0
    t.update_transform(h, m)
    s2 = t.sync()
    assert s2.unified_nodes.shape == s1.unified_nodes.shape  # no realloc shape churn
    assert not bool(trav.closest_hit(s2, rc.Ray.create(o=[0.05, 0.02, -4], d=[0.0, 0, 1])).hit)
    assert bool(trav.closest_hit(s2, rc.Ray.create(o=[10.05, 0.02, -4], d=[0.0, 0, 1])).hit)


def test_delete_and_compaction():
    t = TLAS()
    h1 = t.push(sphere(), None)
    tr = np.eye(3, 4, dtype=np.float32); tr[0, 3] = 3.0
    h2 = t.push(sphere(), tr)
    t.sync()
    t.delete(h1)
    scene = t.sync()
    assert t.n_instances == 1 and t.n_geometries == 1
    assert not t.is_valid(h1) and t.is_valid(h2)
    assert not bool(trav.closest_hit(scene, rc.Ray.create(o=[0.05, 0.02, -4], d=[0.0, 0, 1])).hit)
    r = trav.closest_hit(scene, rc.Ray.create(o=[3.05, 0.02, -4], d=[0.0, 0, 1]))
    assert bool(r.hit) and int(r.instance_idx) == 0  # compacted index
    with pytest.raises(KeyError):
        t.update_transform(h1, np.eye(3, 4, dtype=np.float32))


def test_update_geometry_swap():
    t = TLAS()
    h = t.push(sphere(), None)
    t.sync()
    t.update(h, rc.box_mesh(p_min=(-1, -1, -1), p_max=(1, 1, 1)))
    scene = t.sync()
    r = trav.closest_hit(scene, rc.Ray.create(o=[0.9, 0.9, -4], d=[0.0, 0, 1]))
    # Box corner hits where the sphere would miss.
    assert bool(r.hit) and float(r.t) == pytest.approx(3.0, abs=1e-4)


def test_instance_inherits_vs_overrides_id():
    t = TLAS()
    t.push(sphere(), None, instance_id=0)     # inherit
    tr = np.eye(3, 4, dtype=np.float32); tr[0, 3] = 3.0
    t.push(sphere(), tr, instance_id=42)      # override
    scene = t.sync()
    iid = np.asarray(scene.instances.instance_id)
    assert iid[0] == 0 and iid[1] == 42


def test_world_bound_excludes_padding():
    t = TLAS()
    t.push(sphere(), None)
    t.push(sphere(), None)
    t.push(sphere(), None)  # icap pads 3 -> 4
    scene = t.sync()
    wb = np.asarray(scene.root_aabb)
    assert np.all(np.abs(wb) < 2.0)  # no PAD_COORD leakage


def test_ray_inside_instance():
    t = TLAS()
    t.push(sphere(), None)
    scene = t.sync()
    r = trav.closest_hit(scene, rc.Ray.create(o=[0.05, 0.02, 0], d=[0.0, 0, 1]))
    assert bool(r.hit)
    assert float(r.t) == pytest.approx(1.0, abs=0.05)

"""Scene-churn stress/property tests — ports the invariants of reference
test/test_tlas_stress.jl and test/test_mesh_update.jl: exact buffer-shape
invariants after every op, refit shape stability (the jit analogue of
"refit keeps static_tlas identity"), deleted-handle errors, drain-to-empty,
mesh grow/shrink oscillation with analytic hit checks, interleaved
update+trace."""
import numpy as np
import jax.numpy as jnp
import pytest

import raycore as rc
from raycore.accel import traversal as trav
from raycore.accel.types import next_pow2
from raycore.scene.tlas import TLAS


def sphere(radius=1.0, nt=8, np_=16):
    return rc.sphere_mesh(radius=radius, n_theta=nt, n_phi=np_)


def translation(x, y=0.0, z=0.0):
    m = np.eye(3, 4, dtype=np.float32)
    m[:, 3] = (x, y, z)
    return m


def assert_invariants(mgr: TLAS, scene):
    """Exact buffer-shape bookkeeping (reference assert_compact!,
    test/test_tlas_stress.jl:85-90)."""
    icap = next_pow2(mgr.n_instances)
    assert scene.instance_capacity == icap
    assert scene.n_instances == mgr.n_instances
    assert scene.instances.transform.shape == (icap, 3, 4)
    assert int(scene.instances.mask.sum()) == mgr.n_instances
    n_tlas = 2 * icap - 1
    live = [b for b in mgr._blas if b is not None]
    total_nodes = n_tlas + sum(b.n_nodes for b in live)
    assert scene.unified_nodes.shape == (total_nodes, 16)
    total_prims = sum(b.capacity for b in live)
    assert scene.prims.vertices.shape == (total_prims, 3, 3)
    assert scene.blas_nodes_offset.shape[0] == len(live) == scene.n_blas
    # Offsets are within bounds and ascending.
    off = np.asarray(scene.blas_nodes_offset)
    assert np.all(np.diff(off) > 0) if len(off) > 1 else True
    assert off[0] == n_tlas


def hit_t(scene, x, z0=-4.0):
    r = trav.closest_hit(
        scene, rc.Ray.create(o=[x + 0.03, 0.02, z0], d=[0.0, 0, 1.0]),
        tile_size=64)
    return bool(r.hit), float(r.t)


@pytest.mark.slow
def test_churn_push_delete_update_sync(rng):
    mgr = TLAS()
    handles = {}
    xs = {}
    x_next = 0.0
    for step in range(30):
        op = rng.integers(0, 4)
        if op == 0 or not handles:       # push
            h = mgr.push(sphere(0.4, 6, 8), translation(x_next))
            handles[h.id] = h
            xs[h.id] = x_next
            x_next += 3.0
        elif op == 1 and len(handles) > 1:  # delete
            hid = list(handles)[rng.integers(0, len(handles))]
            mgr.delete(handles.pop(hid))
            xs.pop(hid)
        elif op == 2:                    # move
            hid = list(handles)[rng.integers(0, len(handles))]
            xs[hid] += 0.5
            mgr.update_transform(handles[hid], translation(xs[hid]))
        else:                            # geometry swap
            hid = list(handles)[rng.integers(0, len(handles))]
            mgr.update(handles[hid], sphere(0.4, rng.integers(5, 9), 10))
        scene = mgr.sync()
        assert_invariants(mgr, scene)
    # All live spheres are hittable at their positions.
    scene = mgr.sync()
    for hid, h in handles.items():
        ok, t = hit_t(scene, xs[hid])
        assert ok, f"instance for handle {hid} at x={xs[hid]} not hit"
        assert t == pytest.approx(4.0 - 0.4, abs=0.1)


@pytest.mark.slow
def test_refit_loop_shape_stable():
    mgr = TLAS()
    h = mgr.push(sphere(), translation(0.0))
    mgr.push(sphere(), translation(5.0))
    s0 = mgr.sync()
    shapes0 = (s0.unified_nodes.shape, s0.instances.transform.shape)
    for frame in range(20):
        x = float(np.sin(frame * 0.3) * 2.0)
        mgr.update_transform(h, translation(x))
        s = mgr.sync()
        assert (s.unified_nodes.shape, s.instances.transform.shape) == shapes0
        ok, t = hit_t(s, x)
        assert ok and t == pytest.approx(3.0, abs=0.1)


def test_rebuild_loop():
    mgr = TLAS()
    keep = mgr.push(sphere(), translation(0.0))
    for i in range(15):
        h = mgr.push(sphere(0.3, 6, 8), translation(3.0 + i))
        s = mgr.sync()
        assert_invariants(mgr, s)
        mgr.delete(h)
        s = mgr.sync()
        assert_invariants(mgr, s)
    assert mgr.n_instances == 1
    ok, t = hit_t(mgr.sync(), 0.0)
    assert ok and t == pytest.approx(3.0, abs=0.1)


def test_batch_update_transforms_refit():
    n = 64
    mgr = TLAS()
    base = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    base[:, 0, 3] = np.arange(n) * 3.0
    h = mgr.push(sphere(0.5, 6, 8), transforms=list(base))
    s = mgr.sync()
    assert mgr.n_instances == n
    # Shift all instances by +1 in y and refit.
    base[:, 1, 3] = 1.0
    mgr.update_transforms(h, list(base))
    s2 = mgr.sync()
    assert s2.unified_nodes.shape == s.unified_nodes.shape
    r = trav.closest_hit(
        s2, rc.Ray.create(o=[30.03, 1.02, -4.0], d=[0.0, 0, 1.0]),
        tile_size=64)
    assert bool(r.hit) and int(r.instance_idx) == 10


def test_deleted_handle_errors():
    mgr = TLAS()
    h = mgr.push(sphere(), None)
    mgr.push(sphere(), translation(5.0))
    mgr.delete(h)
    for op in (lambda: mgr.delete(h),
               lambda: mgr.update_transform(h, translation(1.0)),
               lambda: mgr.update(h, sphere()),
               lambda: mgr.get_instance(h)):
        with pytest.raises(KeyError):
            op()
    assert not mgr.is_valid(h)


@pytest.mark.slow
def test_mesh_grow_shrink_oscillation():
    """Reference test_mesh_update.jl:96-116 — swap mesh size every step and
    verify the analytic sphere-hit depth after each swap (catches stale
    buffers)."""
    mgr = TLAS()
    h = mgr.push(sphere(1.0, 8, 16), None)
    for step in range(10):
        big = step % 2 == 0
        radius = 1.5 if big else 0.5
        nt = 16 if big else 6
        mgr.update(h, sphere(radius, nt, 2 * nt))
        s = mgr.sync()
        ok, t = hit_t(s, 0.0)
        assert ok
        assert t == pytest.approx(4.0 - radius, abs=0.1), f"step {step}"


def test_delete_push_without_intermediate_sync():
    mgr = TLAS()
    h = mgr.push(sphere(), None)
    mgr.push(sphere(), translation(5.0))
    mgr.sync()
    mgr.delete(h)
    h2 = mgr.push(sphere(0.5, 6, 8), translation(10.0))  # no sync between
    s = mgr.sync()
    assert mgr.n_instances == 2
    assert not bool(hit_t(s, -0.06)[0]) or hit_t(s, 0.0)[1] > 3.4  # old gone
    ok, t = hit_t(s, 10.0)
    assert ok and t == pytest.approx(3.5, abs=0.1)


def test_drain_and_rebuild():
    mgr = TLAS()
    hs = [mgr.push(sphere(0.5, 6, 8), translation(3.0 * k)) for k in range(4)]
    mgr.sync()
    for h in hs:
        mgr.delete(h)
    with pytest.raises(ValueError):
        mgr.sync()           # zero instances is an error, loudly
    h = mgr.push(sphere(), None)
    s = mgr.sync()
    assert mgr.n_instances == 1
    ok, t = hit_t(s, 0.0)
    assert ok and t == pytest.approx(3.0, abs=0.1)


def test_interleaved_update_and_trace():
    mgr = TLAS()
    h = mgr.push(sphere(0.4, 8, 16), None)
    for k in range(8):
        x = float(k)
        mgr.update_transform(h, translation(x))
        s = mgr.sync()
        ok, t = hit_t(s, x)
        assert ok and t == pytest.approx(3.6, abs=0.1)
        # Old position must miss (instances moved, not copied).
        if k > 0:
            assert not hit_t(s, x - 1.0)[0]


def test_blas_dedup_on_multi_transform():
    mgr = TLAS()
    n = 17
    trs = [translation(2.0 * k) for k in range(n)]
    mgr.push(sphere(0.4, 6, 8), transforms=trs)
    s = mgr.sync()
    assert mgr.n_geometries == 1
    assert s.n_blas == 1
    assert mgr.n_instances == n
    assert s.instance_capacity == next_pow2(n)


def test_from_primitives_metadata_fn():
    meshes = [sphere(0.5, 6, 8), rc.box_mesh()]
    mgr, handles = TLAS.from_primitives(
        meshes, metadata_fn=lambda mi, ti: mi * 1000 + ti)
    s = mgr.sync()
    assert len(handles) == 2 and mgr.n_geometries == 2
    import jax.numpy as jnp
    meta = np.asarray(s.prims.metadata)
    assert (meta >= 1000).any() and (meta < 1000).any()


def test_push_instance_ids_and_sbt():
    mgr = TLAS()
    h = mgr.push(sphere(0.4, 6, 8), transforms=[translation(0), translation(3)],
                 instance_ids=[7, 8], sbt_offset=2)
    s = mgr.sync()
    iid = np.asarray(s.instances.instance_id)
    assert iid[0] == 7 and iid[1] == 8
    recs = mgr.get_instances(h)
    assert all(r.sbt_offset == 2 for r in recs)


def test_free_drops_scene():
    mgr = TLAS()
    mgr.push(sphere(0.4, 6, 8), None)
    mgr.sync()
    mgr.free()
    assert mgr.n_instances == 0 and mgr.n_geometries == 0
    with pytest.raises(ValueError):
        mgr.sync()


@pytest.mark.slow
def test_instance_buffer_write_and_refit():
    """instance_buffer hands out a writable host staging buffer whose rows
    alias the batch's transforms; refit_tlas commits (reference
    instance_buffer, src/Raycore.jl:118-130)."""
    n = 16
    mgr = TLAS()
    base = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    base[:, 0, 3] = np.arange(n) * 3.0
    h = mgr.push(sphere(0.5, 6, 8), transforms=list(base))
    mgr.sync()
    buf = rc.instance_buffer(mgr, h)
    assert buf.shape == (n, 3, 4)
    buf[:, 1, 3] = 2.0                      # shift every instance +2 in y
    s = rc.refit_tlas(mgr)
    r = trav.closest_hit(
        s, rc.Ray.create(o=[15.02, 2.01, -4.0], d=[0.0, 0.0, 1.0]),
        tile_size=64)
    assert bool(r.hit) and int(r.instance_idx) == 5
    # Single-instance handles have no batch buffer: loud error.
    h1 = mgr.push(sphere(), None)
    with pytest.raises(ValueError):
        rc.instance_buffer(mgr, h1)

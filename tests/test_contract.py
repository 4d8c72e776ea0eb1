"""AbstractAccel contract tests — ports reference
test/test_abstract_accel_contract.jl: the same surface behaves identically
on both implementations (BVH TLASAccel and brute-force BruteAccel)."""
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.accel.protocol import TLASAccel, BruteAccel
from raycore.accel.transport import RTRay, trace_closest_hits, trace_any_hits
from raycore.scene.tlas import TLAS


@pytest.fixture(params=[TLASAccel, BruteAccel])
def accel(request):
    a = request.param()
    a.push(rc.sphere_mesh(radius=1.0, n_theta=12, n_phi=24), None)
    tr = np.eye(3, 4, dtype=np.float32)
    tr[0, 3] = 3.0
    a.push(rc.box_mesh(p_min=(-0.5, -0.5, -0.5), p_max=(0.5, 0.5, 0.5)), tr,
           instance_id=7)
    return a


def test_contract_counts_and_bounds(accel):
    assert accel.n_instances == 2
    assert accel.n_geometries == 2
    wb = np.asarray(accel.world_bound())
    np.testing.assert_allclose(wb[0], [-1, -1, -1], atol=0.01)
    np.testing.assert_allclose(wb[1], [3.5, 1, 1], atol=0.01)
    # wait_for_gpu is chainable (reference contract).
    assert accel.wait_for_gpu() is accel


@pytest.mark.slow
def test_contract_queries(accel):
    rays = rc.Ray.create(
        o=jnp.asarray([[0.05, 0.02, -4.0], [3.05, 0.02, -4.0], [9.0, 0, -4.0]]),
        d=jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (3, 3)))
    res = accel.closest_hit(rays)
    hits = np.asarray(res.hit)
    np.testing.assert_array_equal(hits, [True, True, False])
    np.testing.assert_allclose(np.asarray(res.t)[0], 3.0, atol=0.05)
    np.testing.assert_allclose(np.asarray(res.t)[1], 3.5, atol=1e-4)
    assert np.asarray(res.instance_idx)[0] == 0
    assert np.asarray(res.instance_idx)[1] == 1
    assert np.asarray(res.instance_idx)[2] == -1
    a = accel.any_hit(rays)
    np.testing.assert_array_equal(np.asarray(a.hit), hits)


def test_contract_mutation(accel):
    far = np.eye(3, 4, dtype=np.float32)
    far[1, 3] = 50.0
    h = accel.push(rc.sphere_mesh(radius=0.3, n_theta=8, n_phi=12), far)
    assert accel.n_instances == 3
    accel.delete(h)
    assert accel.n_instances == 2
    h2 = accel.push(rc.sphere_mesh(radius=0.3, n_theta=8, n_phi=12), None)
    accel.update_transform(h2, far)
    ray = rc.Ray.create(o=[0.0, 50.0, -4.0], d=[0.0, 0, 1.0])
    assert bool(accel.closest_hit(ray).hit)


@pytest.mark.slow
def test_rt_transport_roundtrip():
    mgr = TLAS()
    mgr.push(rc.sphere_mesh(radius=1.0, n_theta=12, n_phi=24), None,
             instance_id=99)
    scene = mgr.sync()
    rt = RTRay(origin=jnp.asarray([[0.05, 0.02, -4.0], [5.0, 5, 5]]),
               t_min=jnp.zeros(2), direction=jnp.asarray([[0.0, 0, 1.0],
                                                          [0.0, 0, 1.0]]),
               t_max=jnp.full(2, jnp.inf))
    packed = np.asarray(rt.pack())
    assert packed.shape == (2, 8)
    res = trace_closest_hits(scene, rt, tile_size=64)
    assert bool(res.hit[0]) and not bool(res.hit[1])
    assert float(res.t[0]) == pytest.approx(3.0, abs=0.05)
    # instance_id override (99) beats the metadata payload.
    assert int(res.instance_custom_index[0]) == 99
    assert int(res.instance_custom_index[1]) == 0
    u, v = float(res.bary_u[0]), float(res.bary_v[0])
    assert 0 <= u <= 1 and 0 <= v <= 1
    anyres = trace_any_hits(scene, rt, tile_size=64)
    assert bool(anyres.hit[0]) and not bool(anyres.hit[1])


def test_soa_and_switch_utils():
    from raycore.utils.soa import (soa_get, soa_set, similar_soa,
                                       switch_apply, map_unrolled,
                                       sum_unrolled)
    soa = {"a": jnp.arange(4.0), "b": jnp.arange(4.0) * 10}
    assert float(soa_get(soa, 2, "a")) == 2.0
    a, b = soa_get(soa, 1, "a", "b")
    assert (float(a), float(b)) == (1.0, 10.0)
    soa2 = soa_set(soa, 0, a=5.0)
    assert float(soa2["a"][0]) == 5.0 and float(soa["a"][0]) == 0.0
    s = similar_soa(soa, 8)
    assert s["a"].shape == (8,)
    assert map_unrolled(lambda x: x * 2, (1, 2, 3)) == (2, 4, 6)
    assert sum_unrolled(lambda x: x, (1.0, 2.0, 3.0)) == 6.0
    out = switch_apply(jnp.int32(1), [lambda: 10.0, lambda: 20.0])
    assert float(out) == 20.0
    out2 = switch_apply(jnp.int32(0), [jnp.float32(1.5), jnp.float32(2.5)])
    assert float(out2) == 1.5

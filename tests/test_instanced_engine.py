"""Dense instanced engine (ops/pallas_instanced.py) parity + dynamics.

Oracle: the two-level TLAS wavefront traversal (itself brute-verified in
tests/test_bvh.py). Mirrors the reference's instanced closest_hit tests
(test/test_instanced_bvh.jl GPU sections)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.accel import traversal as trav
from raycore.ops.pallas_instanced import (any_hit_instanced,
                                              closest_hit_instanced)
from raycore.scene.instanced import bake_instanced, refresh_instances
from raycore.scene.tlas import TLAS


def _transform(rng, scale_lo=0.4, scale_hi=1.2, span=3.0):
    s = rng.uniform(scale_lo, scale_hi)
    th = rng.uniform(0, 2 * np.pi)
    c, sn = np.cos(th), np.sin(th)
    R = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32) * s
    t = rng.uniform(-span, span, 3).astype(np.float32)
    m = np.zeros((3, 4), np.float32)
    m[:, :3] = R
    m[:, 3] = t
    return m


def _scene(rng, n_inst=12):
    mgr = TLAS()
    sph = rc.sphere_mesh(radius=1.0, n_theta=8, n_phi=16)
    box = rc.box_mesh()
    handles = [mgr.push(sph, _transform(rng))]
    for i in range(n_inst - 1):
        mesh = sph if i % 2 == 0 else box
        handles.append(mgr.push(mesh, _transform(rng)))
    return mgr, handles


def _rays(rng, n=2048, span=4.5):
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    o[:, 2] = -6.0
    tgt = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))


def _check(ref, got, check_inst=True):
    h1, h2 = np.asarray(ref.hit), np.asarray(got.hit)
    np.testing.assert_array_equal(h1, h2)
    m = h1
    assert m.sum() > 50
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=2e-4, atol=2e-4)
    if check_inst:
        ii = np.asarray(ref.instance_idx)[m]
        ig = np.asarray(got.instance_idx)[m]
        # Exact-t ties between overlapping instances may pick either.
        assert (ii == ig).mean() > 0.98


@pytest.mark.slow
def test_instanced_matches_tlas(rng):
    mgr, _ = _scene(rng)
    tlas = mgr.sync()
    ds = bake_instanced(mgr, cluster_size=32)
    rays = _rays(rng)
    ref = trav.closest_hit(tlas, rays, tile_size=2048)
    got = closest_hit_instanced(ds, rays, tile=256, subgroup=8, spb=16)
    _check(ref, got)


@pytest.mark.slow
def test_instanced_default_params(rng):
    mgr, _ = _scene(rng, n_inst=5)
    tlas = mgr.sync()
    ds = bake_instanced(mgr, cluster_size=64)
    rays = _rays(rng, n=777)          # ragged, non-pow2
    ref = trav.closest_hit(tlas, rays, tile_size=2048)
    got = closest_hit_instanced(ds, rays)
    _check(ref, got)


@pytest.mark.slow
def test_instanced_t_ranges(rng):
    mgr = TLAS()
    mgr.push(rc.plane_mesh(center=(0, 0, 0), u=(4, 0, 0), v=(0, 4, 0)),
             None)
    ds = bake_instanced(mgr, cluster_size=32)
    o = jnp.asarray([[0.1, 0.1, -2.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    assert bool(closest_hit_instanced(
        ds, rc.Ray.create(o=o, d=d)).hit[0])
    # t_min beyond the plane: closest_hit misses, any_hit (t_min forced
    # to 0, reference semantics) hits.
    late = rc.Ray.create(o=o, d=d, t_min=5.0)
    assert not bool(closest_hit_instanced(ds, late).hit[0])
    assert bool(any_hit_instanced(ds, late).hit[0])
    short = rc.Ray.create(o=o, d=d, t_max=1.0)
    assert not bool(closest_hit_instanced(ds, short).hit[0])


@pytest.mark.slow
def test_instanced_dynamics_refresh(rng):
    """Transform-only updates: refresh_instances must track the TLAS
    refit path exactly, with stable array shapes (no geometry rebuild)."""
    mgr, handles = _scene(rng, n_inst=8)
    ds = bake_instanced(mgr, cluster_size=32)
    shapes0 = jax.tree_util.tree_map(
        lambda a: getattr(a, "shape", None), ds)
    rays = _rays(rng, n=1024)
    for step in range(3):
        for h in handles[:4]:
            mgr.update_transform(h, _transform(rng))
        tlas = mgr.sync()
        ds = refresh_instances(ds, mgr)
        shapes = jax.tree_util.tree_map(
            lambda a: getattr(a, "shape", None), ds)
        assert shapes == shapes0
        ref = trav.closest_hit(tlas, rays, tile_size=2048)
        got = closest_hit_instanced(ds, rays, tile=256, subgroup=8)
        _check(ref, got)


def test_refresh_rejects_changed_blas_assignment(rng):
    """ADVICE r2: a delete+push cycle that preserves the instance COUNT
    but changes which BLAS a slot references must be rejected by
    refresh_instances (the baked tables would trace the wrong geometry)."""
    mgr = TLAS()
    sph = rc.sphere_mesh(radius=1.0, n_theta=8, n_phi=16)
    box = rc.box_mesh()
    h1 = mgr.push(sph, _transform(rng))
    mgr.push(sph, _transform(rng))
    mgr.sync()
    ds = bake_instanced(mgr, cluster_size=32)
    # Same count, different geometry in slot h1.
    mgr.delete(h1)
    mgr.push(box, _transform(rng))
    mgr.sync()
    with pytest.raises(ValueError, match="re-bake"):
        refresh_instances(ds, mgr)


@pytest.mark.slow
def test_instanced_shared_blas_many_instances(rng):
    """Particles pattern: one BLAS, many transforms (reference
    multi-transform push, src/instanced-bvh.jl:661-676)."""
    mgr = TLAS()
    trs = [_transform(rng, scale_lo=0.2, scale_hi=0.5, span=2.5)
           for _ in range(40)]
    mgr.push(rc.sphere_mesh(radius=1.0, n_theta=6, n_phi=12),
             transforms=trs)
    tlas = mgr.sync()
    ds = bake_instanced(mgr, cluster_size=32)
    rays = _rays(rng, n=2048, span=3.0)
    ref = trav.closest_hit(tlas, rays, tile_size=2048)
    got = closest_hit_instanced(ds, rays, tile=512, subgroup=8)
    _check(ref, got)


@pytest.mark.slow
def test_instanced_static_caps_inside_jit(rng):
    """VERDICT r2 item 8: dynamic instanced scenes inside jitted
    pipelines — warm up eagerly once, derive static capacities via
    instanced_capacity_hint, then run the SAME query under jax.jit with
    closest_hit_instanced_static; results identical, totals validate."""
    from raycore.ops.pallas_instanced import (
        closest_hit_instanced_static, instanced_capacity_hint)
    mgr, _ = _scene(rng, n_inst=6)
    ds = bake_instanced(mgr, cluster_size=32)
    rays = _rays(rng, n=1024)
    assert instanced_capacity_hint(ds, 1024, tile=256, subgroup=8) is None
    ref = closest_hit_instanced(ds, rays, tile=256, subgroup=8)  # warmup
    caps = instanced_capacity_hint(ds, 1024, tile=256, subgroup=8)
    assert caps is not None
    p_cap, q_cap, nb = caps

    @jax.jit
    def pipeline(scene, rays):
        res, totals = closest_hit_instanced_static(
            scene, rays, p_cap=p_cap, q_cap=q_cap, nb=nb,
            tile=256, subgroup=8)
        return res, totals

    got, totals = pipeline(ds, rays)
    coarse, q_total, total = (int(x) for x in np.asarray(totals))
    assert coarse <= p_cap and q_total <= q_cap and total <= nb
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    m = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(got.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.instance_idx),
                                  np.asarray(ref.instance_idx))


def test_instanced_with_checksum_warm_path(rng):
    """Fused warm path: cold call seeds the capacity cache (checksum
    None), the second call takes the one-dispatch path and returns the
    host checksum; results identical both ways."""
    mgr, _ = _scene(rng)
    ds = bake_instanced(mgr, cluster_size=32)
    rays = _rays(rng, n=1024)
    res0, cs0 = closest_hit_instanced(ds, rays, tile=256, subgroup=8,
                                      with_checksum=True)
    assert cs0 is None
    res1, cs1 = closest_hit_instanced(ds, rays, tile=256, subgroup=8,
                                      with_checksum=True)
    assert cs1 is not None
    flat_t = np.asarray(res1.t).reshape(-1)
    np.testing.assert_allclose(cs1, np.sum(flat_t[::257], dtype=np.float32),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(res0.t), np.asarray(res1.t))
    np.testing.assert_array_equal(np.asarray(res0.instance_idx),
                                  np.asarray(res1.instance_idx))

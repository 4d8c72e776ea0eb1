"""The Triton sweep kernels (ops/sweep.py) in interpret mode against the
plain sweep, and the one backend decision (ops/backend.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.accel.dense import build_dense
from raycore.ops import backend, sweep
from raycore.ops.pallas_dense import (_ray_table, build_worklist,
                                      phase_a_entry)
from raycore.ops.pallas_regroup import _stage1_core, _shape_params


def _grid_rays(side=32, tilt=(0.03, 0.02)):
    xs = jnp.linspace(-0.9, 0.9, side) + 0.013
    X, Y = jnp.meshgrid(xs, xs + 0.007, indexing="ij")
    o = jnp.stack([X, Y, jnp.full_like(X, 2.0)], -1).reshape(-1, 3)
    d = jnp.broadcast_to(jnp.asarray([tilt[0], tilt[1], -1.0]), o.shape)
    return rc.Ray.create(o=o, d=d / jnp.linalg.norm(d, axis=-1,
                                                     keepdims=True))


def _blocks(scene, rays, G=8, SPB=4):
    """Real cluster-major blocks for the rays (the engine's stage 1)."""
    R = rays.o.shape[0]
    G, TILE, _ = _shape_params(R, 256, G)
    n_tiles = R // TILE
    P_cap = n_tiles * scene.n_clusters
    block_cid, block_subs, tbl, total, _ = _stage1_core(
        scene, rays.o, rays.d, rays.t_min, rays.t_max, TILE, G, SPB, P_cap)
    return block_cid, block_subs, tbl, int(total), G, SPB


@pytest.mark.parametrize("payload", ["prim", "pairrow"])
@pytest.mark.parametrize("C", [32, 64, 128, 256])
def test_regroup_sweep_matches_plain(C, payload):
    mesh = rc.displaced_grid_mesh(n=20, extent=2.0, amplitude=0.3)
    scene = build_dense(mesh, cluster_size=C)
    cid, subs, tbl, nb, G, SPB = _blocks(scene, _grid_rays())
    assert nb > 0
    kw = dict(G=G, SPB=SPB, C=C, n_blocks=nb, payload=payload)
    k1, p1 = sweep.sweep_regrouped(subs, cid, tbl, scene.tri_feats, **kw)
    k2, p2 = sweep.sweep_regrouped_reference(subs, cid, tbl,
                                             scene.tri_feats, **kw)
    k1, k2 = np.asarray(k1), np.asarray(k2)
    assert (k2 != sweep.INT32_MAX).sum() > 100
    np.testing.assert_array_equal(k1 != sweep.INT32_MAX,
                                  k2 != sweep.INT32_MAX)
    hit = k2 != sweep.INT32_MAX
    t1, t2 = (k.view(np.float32)[hit] for k in (k1, k2))
    np.testing.assert_allclose(t1, t2, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def test_regroup_sweep_padded_blocks():
    mesh = rc.displaced_grid_mesh(n=12, extent=2.0, amplitude=0.3)
    scene = build_dense(mesh, cluster_size=64)
    cid, subs, tbl, nb, G, SPB = _blocks(scene, _grid_rays(16))
    pad = jnp.full_like(cid, -1)            # every block is padding
    key, pair = sweep.sweep_regrouped(subs, pad, tbl, scene.tri_feats, G=G,
                                      SPB=SPB, C=64, n_blocks=nb)
    assert key.shape == (nb * G * SPB,)
    assert np.all(np.asarray(key) == sweep.INT32_MAX)
    assert np.all(np.asarray(pair) == -1)
    z = sweep.sweep_regrouped(subs, cid, tbl, scene.tri_feats, G=G,
                              SPB=SPB, C=64, n_blocks=0)
    assert z[0].shape == (0,)


def _tile_setup(TILE=64, C=64):
    mesh = rc.displaced_grid_mesh(n=12, extent=2.0, amplitude=0.3)
    scene = build_dense(mesh, cluster_size=C)
    rays = _grid_rays(16)
    R = rays.o.shape[0]
    tbl = _ray_table(rays.o, rays.d, rays.t_min, rays.t_max)
    entry = phase_a_entry(scene, rays.o, rays.d, rays.t_min, rays.t_max,
                          R // TILE, TILE)
    tids, cids, _ = build_worklist(entry, (R // TILE) * scene.n_clusters)
    return scene, rays, tbl, tids, cids


def test_tile_sweep_matches_brute():
    scene, rays, tbl, tids, cids = _tile_setup()
    R = rays.o.shape[0]
    key0 = jnp.full((R,), sweep.INT32_MAX, jnp.int32)
    key, pair = sweep.sweep_tiles(tids, cids, tbl, key0,
                                  jnp.full((R,), -1, jnp.int32),
                                  scene.tri_feats, TILE=64, C=64)
    ref = rc.closest_hit_brute(scene.prims, rays)
    hit = np.asarray(pair) >= 0
    np.testing.assert_array_equal(hit, np.asarray(ref.hit))
    np.testing.assert_allclose(np.asarray(key).view(np.float32)[hit],
                               np.asarray(ref.t)[hit], rtol=2e-5)


def test_tile_sweeps_empty_worklist():
    scene, rays, tbl, tids, cids = _tile_setup()
    R = rays.o.shape[0]
    n_tiles = R // 64
    tids = jnp.full_like(tids, n_tiles)     # nothing but padding
    key0 = jnp.arange(R, dtype=jnp.int32)
    pair0 = jnp.arange(R, dtype=jnp.int32) - 7
    key, pair = sweep.sweep_tiles(tids, cids, tbl, key0, pair0,
                                  scene.tri_feats, TILE=64, C=64)
    np.testing.assert_array_equal(np.asarray(key), np.asarray(key0))
    np.testing.assert_array_equal(np.asarray(pair), np.asarray(pair0))
    occ = sweep.occlude_tiles(tids, cids, tbl, scene.tri_feats, TILE=64,
                              C=64)
    assert np.all(np.asarray(occ) == -1)


def test_occlusion_sweep_matches_closest_mask():
    scene, rays, tbl, tids, cids = _tile_setup()
    R = rays.o.shape[0]
    _, pair = sweep.sweep_tiles(tids, cids, tbl,
                                jnp.full((R,), sweep.INT32_MAX, jnp.int32),
                                jnp.full((R,), -1, jnp.int32),
                                scene.tri_feats, TILE=64, C=64)
    occ = sweep.occlude_tiles(tids, cids, tbl, scene.tri_feats, TILE=64,
                              C=64)
    np.testing.assert_array_equal(np.asarray(occ) >= 0,
                                  np.asarray(pair) >= 0)


@pytest.mark.parametrize("platform,mode", [("cpu", "interpret"),
                                           ("gpu", "compile")])
def test_kernel_mode(platform, mode):
    assert backend.kernel_mode(platform) == mode


def test_kernel_mode_refuses_other_platforms():
    with pytest.raises(RuntimeError, match="no Pallas kernel route"):
        backend.kernel_mode("rocm")


def test_interpret_follows_default_backend():
    assert backend.interpret() == (jax.default_backend() == "cpu")


@pytest.mark.gpu
def test_sweep_kernel_compiles_on_gpu(gpu):
    """On the card: the compiled kernel against the plain sweep."""
    mesh = rc.displaced_grid_mesh(n=64, extent=2.0, amplitude=0.3)
    scene = build_dense(mesh, cluster_size=256)
    cid, subs, tbl, nb, G, SPB = _blocks(scene, _grid_rays(64), G=32,
                                         SPB=16)
    kw = dict(G=G, SPB=SPB, C=256, n_blocks=nb)
    k1, p1 = sweep.sweep_regrouped(subs, cid, tbl, scene.tri_feats, **kw)
    k2, p2 = sweep.sweep_regrouped_reference(subs, cid, tbl,
                                             scene.tri_feats, **kw)
    np.testing.assert_array_equal(np.asarray(p1) >= 0, np.asarray(p2) >= 0)

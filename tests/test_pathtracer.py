"""Multi-bounce path tracer tests (BASELINE config #5 shape)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.render.pathtracer import PTConfig, trace_paths
from raycore.render.scenes import example_scene
from raycore.collections.multitypeset import MultiTypeSet


@pytest.fixture(scope="module")
def room():
    return example_scene()


@pytest.mark.slow
def test_pathtracer_smoke(room):
    scene, mats, lights, cam = room
    img = np.asarray(trace_paths(scene, mats, lights, cam,
                                 jax.random.PRNGKey(0),
                                 PTConfig(width=48, height=32, spp=2,
                                          bounces=3, tile_size=512)))
    assert img.shape == (32, 48, 3)
    assert np.all((img >= 0) & (img <= 1))
    assert img.std() > 0.02
    assert img.mean() > 0.01


@pytest.mark.slow
def test_more_bounces_add_light(room):
    scene, mats, lights, cam = room
    mk = lambda b: np.asarray(trace_paths(
        scene, mats, lights, cam, jax.random.PRNGKey(1),
        PTConfig(width=40, height=30, spp=2, bounces=b, tile_size=512)))
    img1 = mk(1)
    img4 = mk(4)
    # Indirect light only adds energy.
    assert img4.mean() >= img1.mean() - 1e-4
    assert img4.mean() > img1.mean() * 1.001


@pytest.mark.slow
def test_compaction_does_not_change_image(room):
    scene, mats, lights, cam = room
    a = np.asarray(trace_paths(scene, mats, lights, cam,
                               jax.random.PRNGKey(2),
                               PTConfig(width=32, height=24, spp=1,
                                        bounces=3, tile_size=256,
                                        compact=True)))
    b = np.asarray(trace_paths(scene, mats, lights, cam,
                               jax.random.PRNGKey(2),
                               PTConfig(width=32, height=24, spp=1,
                                        bounces=3, tile_size=256,
                                        compact=False)))
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.slow
def test_textured_albedo(room):
    scene, mats, lights, cam = room
    s = MultiTypeSet()
    checker = np.indices((8, 8)).sum(0) % 2
    tex = np.stack([checker, 1 - checker, np.ones_like(checker)], -1) \
        .astype(np.float32)
    h = s.store_texture(tex)
    pool = s.get_static().textures
    n_mats = mats.base_color.shape[0]
    tex_refs = jnp.full((n_mats,), -1, jnp.int32).at[0].set(h)  # floor only
    img_t = np.asarray(trace_paths(scene, mats, lights, cam,
                                   jax.random.PRNGKey(3),
                                   PTConfig(width=48, height=32, spp=1,
                                            bounces=1, tile_size=512),
                                   pool=pool, tex_refs=tex_refs))
    img_p = np.asarray(trace_paths(scene, mats, lights, cam,
                                   jax.random.PRNGKey(3),
                                   PTConfig(width=48, height=32, spp=1,
                                            bounces=1, tile_size=512)))
    # Textured floor changes pixels vs the plain material.
    assert np.abs(img_t - img_p).max() > 0.02


@pytest.mark.slow
def test_staged_matches_jitted(room):
    from raycore.render.pathtracer import trace_paths_staged
    scene, mats, lights, cam = room
    cfg = PTConfig(width=32, height=24, spp=1, bounces=3, tile_size=256)
    a = np.asarray(trace_paths(scene, mats, lights, cam,
                               jax.random.PRNGKey(5), cfg))
    b = np.asarray(trace_paths_staged(scene, mats, lights, cam,
                                      jax.random.PRNGKey(5), cfg))
    np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.slow
def test_staged_batch_matches_solo_frames(room):
    """The F-frame batched driver (one concatenated F*R-ray query per
    stage — the batch-amortization production path) must match F solo
    trace_paths_staged calls with the same keys to float ulp: per-frame
    key chains + original-ray-id-indexed draws make the cross-frame
    compaction permutation invisible to each ray, so every ray samples
    the SAME path; the only residual is XLA fusing the shading
    reductions differently at the 2R shape (measured 9e-08 max abs on
    this scene — tie-flips or draw mixups would show at 1e-2)."""
    from raycore.render.pathtracer import (trace_paths_staged,
                                               trace_paths_staged_batch)
    scene, mats, lights, cam = room
    cfg = PTConfig(width=24, height=16, spp=2, bounces=3, tile_size=256)
    k1, k2 = jax.random.PRNGKey(5), jax.random.PRNGKey(11)
    solo = np.stack([np.asarray(trace_paths_staged(scene, mats, lights,
                                                   cam, k, cfg))
                     for k in (k1, k2)])
    batch = np.asarray(trace_paths_staged_batch(scene, mats, lights, cam,
                                                [k1, k2], cfg))
    assert batch.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(solo, batch, atol=1e-6)


@pytest.mark.slow
def test_staged_pipelined_matches(room):
    """pipelined=True (deferred whole-frame dispatch) is bit-identical
    to the per-query staged driver: the deferral only removes host
    syncs, never changes what is computed. On engines without a
    deferred mode the queries degrade to their normal sync path."""
    from raycore.render.pathtracer import trace_paths_staged
    scene, mats, lights, cam = room
    cfg = PTConfig(width=32, height=24, spp=1, bounces=3, tile_size=256)
    a = np.asarray(trace_paths_staged(scene, mats, lights, cam,
                                      jax.random.PRNGKey(7), cfg))
    b = np.asarray(trace_paths_staged(scene, mats, lights, cam,
                                      jax.random.PRNGKey(7), cfg,
                                      pipelined=True))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_staged_pipelined_dense_regroup(monkeypatch):
    """Pipelined frames through the REAL deferred regroup route: opt the
    dispatch into the regrouped engine at test size, render one frame
    per-query (warms capacities + fused graphs), then a pipelined frame
    — every warm query must defer (finalizers validate at frame end)
    and the image must match the per-query frame bit-for-bit."""
    from raycore.render.pathtracer import trace_paths_staged
    from raycore.accel.dense import build_dense
    from raycore.accel import dispatch as _disp
    from raycore.render.wavefront import Materials, PointLights, Camera
    monkeypatch.setattr(_disp, "REGROUP_MIN_RAYS", 256)
    monkeypatch.setenv("RAYCORE_DISPATCH_REGROUP", "1")
    tris = rc.displaced_grid_mesh(n=24)
    ds = build_dense(tris, cluster_size=64)
    mats = Materials.create(base_color=np.full((2000, 3), 0.6, np.float32))
    lights = PointLights(position=jnp.asarray([[0.0, 0, 5.0]]),
                         intensity=jnp.asarray([[20.0, 20, 20]]))
    cam = Camera.create(position=(0, -3, 2.5), target=(0, 0, 0))
    cfg = PTConfig(width=32, height=16, spp=1, bounces=2, tile_size=256)
    a = np.asarray(trace_paths_staged(ds, mats, lights, cam,
                                      jax.random.PRNGKey(3), cfg))
    b = np.asarray(trace_paths_staged(ds, mats, lights, cam,
                                      jax.random.PRNGKey(3), cfg,
                                      pipelined=True))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_staged_batch_pipelined_dense_regroup(monkeypatch):
    """The advertised production mode end-to-end: F=2 frames batched
    into every query AND chained through the deferred regroup route.
    Warm the 2R-ray query shape per-query first, then the pipelined
    batch must match it bit-for-bit (deferral never changes values),
    and each frame must match its solo per-query render to ulp."""
    from raycore.render.pathtracer import (trace_paths_staged,
                                               trace_paths_staged_batch)
    from raycore.accel.dense import build_dense
    from raycore.accel import dispatch as _disp
    from raycore.render.wavefront import Materials, PointLights, Camera
    monkeypatch.setattr(_disp, "REGROUP_MIN_RAYS", 256)
    monkeypatch.setenv("RAYCORE_DISPATCH_REGROUP", "1")
    tris = rc.displaced_grid_mesh(n=24)
    ds = build_dense(tris, cluster_size=64)
    mats = Materials.create(base_color=np.full((2000, 3), 0.6, np.float32))
    lights = PointLights(position=jnp.asarray([[0.0, 0, 5.0]]),
                         intensity=jnp.asarray([[20.0, 20, 20]]))
    cam = Camera.create(position=(0, -3, 2.5), target=(0, 0, 0))
    cfg = PTConfig(width=32, height=16, spp=1, bounces=2, tile_size=256)
    k1, k2 = jax.random.PRNGKey(3), jax.random.PRNGKey(9)
    a = np.asarray(trace_paths_staged_batch(ds, mats, lights, cam,
                                            [k1, k2], cfg))
    b = np.asarray(trace_paths_staged_batch(ds, mats, lights, cam,
                                            [k1, k2], cfg, pipelined=True))
    np.testing.assert_array_equal(a, b)
    solo = np.asarray(trace_paths_staged(ds, mats, lights, cam, k2, cfg))
    np.testing.assert_allclose(a[1], solo, atol=1e-6)


@pytest.mark.slow
def test_staged_dense_scene():
    from raycore.render.pathtracer import trace_paths_staged
    from raycore.accel.dense import build_dense
    from raycore.render.wavefront import Materials, PointLights, Camera
    tris = rc.displaced_grid_mesh(n=24)
    ds = build_dense(tris, cluster_size=64)
    mats = Materials.create(base_color=np.full((2000, 3), 0.6, np.float32))
    lights = PointLights(position=jnp.asarray([[0.0, 0, 5.0]]),
                         intensity=jnp.asarray([[20.0, 20, 20]]))
    cam = Camera.create(position=(0, -3, 2.5), target=(0, 0, 0))
    img = np.asarray(trace_paths_staged(
        ds, mats, lights, cam, jax.random.PRNGKey(0),
        PTConfig(width=32, height=24, spp=1, bounces=2, tile_size=256)))
    assert img.shape == (24, 32, 3)
    assert img.mean() > 0.005

"""Heterogeneous-material renderer tests (Hikari-integration analog)."""
import jax
import jax.numpy as jnp
import numpy as np

import raycore as rc
from raycore.collections.multitypeset import MultiTypeSet
from raycore.render import mts_renderer as M
from raycore.render.wavefront import Camera, PointLights, RenderConfig
from raycore.scene.tlas import TLAS
import pytest


def build_scene():
    s = MultiTypeSet()
    k_matte = s.push({"kd_r": 0.8, "kd_g": 0.4, "kd_b": 0.2, "sigma": 0.0},
                     "matte")
    k_mirror = s.push({"kr_r": 0.9, "kr_g": 0.9, "kr_b": 0.95}, "mirror")
    k_plastic = s.push({"kd_r": 0.2, "kd_g": 0.4, "kd_b": 0.8,
                        "ks_r": 0.4, "ks_g": 0.4, "ks_b": 0.4,
                        "rough": 0.1}, "plastic")
    k_glass = s.push({"kt_r": 0.9, "kt_g": 0.9, "kt_b": 0.9, "eta": 1.5},
                     "glass")
    keys = {"matte": k_matte, "mirror": k_mirror, "plastic": k_plastic,
            "glass": k_glass}

    def with_key(tris, key):
        meta = M.pack_key(int(key[0]), int(key[1]))
        return tris.replace(metadata=jnp.full(tris.batch_shape, meta,
                                              jnp.uint32))

    mgr = TLAS()
    mgr.push(with_key(rc.plane_mesh(center=(0, 0, 0), u=(4, 0, 0),
                                    v=(0, 4, 0)), k_matte), None)
    mgr.push(with_key(rc.sphere_mesh(center=(0, 1, 1), radius=1.0,
                                     n_theta=16, n_phi=32), k_mirror), None)
    mgr.push(with_key(rc.sphere_mesh(center=(1.8, -0.5, 0.6), radius=0.6,
                                     n_theta=16, n_phi=32), k_plastic), None)
    mgr.push(with_key(rc.box_mesh(p_min=(-2.5, -0.5, 0), p_max=(-1.5, 0.5, 1)),
                      k_glass), None)
    scene = mgr.sync()
    return scene, s.get_static(), keys


def test_key_packing_roundtrip():
    meta = jnp.asarray([M.pack_key(2, 77), M.pack_key(0, 0),
                        M.pack_key(3, 123456)], jnp.uint32)
    ti, ri = M.unpack_key(meta)
    np.testing.assert_array_equal(np.asarray(ti), [2, 0, 3])
    np.testing.assert_array_equal(np.asarray(ri), [77, 0, 123456])


def test_shade_props_dispatch():
    scene, sset, keys = build_scene()
    ti = jnp.asarray([0, 1, 2, 3], jnp.int32)
    ri = jnp.asarray([int(keys[n][1]) for n in
                      ("matte", "mirror", "plastic", "glass")], jnp.int32)
    kd, ks, refl = M._shade_props(sset, ti, ri)
    kd, ks, refl = np.asarray(kd), np.asarray(ks), np.asarray(refl)
    np.testing.assert_allclose(kd[0], [0.8, 0.4, 0.2], rtol=1e-6)   # matte
    assert refl[0] == 0.0
    np.testing.assert_allclose(ks[1], [0.9, 0.9, 0.95], rtol=1e-6)  # mirror
    assert refl[1] == 1.0
    np.testing.assert_allclose(kd[2], [0.2, 0.4, 0.8], rtol=1e-6)   # plastic
    assert 0 < refl[2] < 1
    assert refl[3] > 0.5                                            # glass


@pytest.mark.slow
def test_mts_render_smoke():
    scene, sset, _ = build_scene()
    lights = PointLights(position=jnp.asarray([[3.0, -3, 5.0]], jnp.float32),
                         intensity=jnp.asarray([[25.0, 25, 24]], jnp.float32))
    cam = Camera.create(position=(1.0, -5.5, 2.2), target=(0, 0.3, 0.8),
                        up=(0, 0, 1), fov_deg=50)
    img = M.render_step_mts(scene, sset, lights, cam, jax.random.PRNGKey(0),
                            RenderConfig(width=64, height=48, spp=1,
                                         tile_size=1024))
    a = np.asarray(img)
    assert a.shape == (48, 64, 3)
    assert np.all((a >= 0) & (a <= 1))
    assert a.std() > 0.02

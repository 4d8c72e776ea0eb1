"""Tutorial-renderer kernels + package-surface checks (Aqua analog)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raycore as rc
from raycore.render import simple as S
from raycore.render.scenes import example_scene


@pytest.fixture(scope="module")
def room():
    return example_scene()


@pytest.mark.slow
def test_depth_kernel(room):
    scene, mats, lights, cam = room
    img = np.asarray(S.trace(S.depth_kernel, scene, cam, width=48, height=32,
                             tile_size=512))
    assert img.shape == (32, 48, 3)
    assert img.std() > 0.02
    # Grayscale: channels equal.
    np.testing.assert_allclose(img[..., 0], img[..., 1])


@pytest.mark.slow
def test_normal_kernel(room):
    scene, mats, lights, cam = room
    img = np.asarray(S.trace(S.normal_kernel, scene, cam, width=48, height=32,
                             tile_size=512))
    assert np.all((img >= 0) & (img <= 1))
    assert img.std() > 0.05


@pytest.mark.slow
def test_hard_vs_soft_shadow(room):
    scene, mats, lights, cam = room
    hard = np.asarray(S.trace(S.shadow_kernel, scene, cam, width=48,
                              height=32, tile_size=512, light_radius=0.0))
    soft = np.asarray(S.trace(S.shadow_kernel, scene, cam, width=48,
                              height=32, tile_size=512, light_radius=0.6,
                              n_shadow=4, key=jax.random.PRNGKey(3)))
    assert hard.std() > 0.05 and soft.std() > 0.05
    # Soft shadows produce intermediate visibility values somewhere.
    inter = (soft > 0.08) & (soft < 0.75)
    assert inter.mean() > 0.02


@pytest.mark.slow
def test_multi_light_and_reflective(room):
    scene, mats, lights, cam = room
    ml = np.asarray(S.trace(S.multi_light_kernel, scene, cam, width=48,
                            height=32, tile_size=512, lights=lights,
                            materials=mats))
    rf = np.asarray(S.trace(S.reflective_kernel, scene, cam, width=48,
                            height=32, tile_size=512, lights=lights,
                            materials=mats))
    assert ml.std() > 0.03 and rf.std() > 0.03
    # Reflection changes the metallic sphere's pixels.
    assert np.abs(ml - rf).max() > 0.05


def test_export_surface():
    """Every name promised by the API map exists (Aqua.test_all analog)."""
    names = [
        "Ray", "RayDifferentials", "Triangle", "empty_triangle", "Bounds3",
        "Bounds2", "Transformation", "Quaternion", "translate", "scale",
        "rotate", "rotate_x", "rotate_y", "rotate_z", "look_at",
        "perspective", "slerp", "has_scale", "swaps_handedness",
        "mat4_to_mat3x4", "mat3x4_inverse", "transform_point_3x4",
        "transform_direction_3x4", "intersect_triangle",
        "fast_intersect_triangle", "safe_invdir", "reflect", "BLAS",
        "build_blas", "TLAS", "TLASHandle", "StaticTLAS", "INVALID_NODE",
        "INVALID_HANDLE", "closest_hit", "any_hit", "BLAS4", "build_blas4",
        "closest_hit4", "any_hit4", "AbstractAccel", "TLASAccel",
        "BruteAccel", "RTRay", "RTHitResult", "trace_closest_hits",
        "trace_any_hits", "MultiTypeSet", "StaticMultiTypeSet", "SetKey",
        "with_index", "is_invalid", "is_valid_key", "sample_nearest",
        "sample_bilinear", "CollisionResult", "collide_instances",
        "collide_instances_any", "get_centroid", "get_illumination",
        "view_factors", "generate_ray_grid", "hits_from_grid", "soa_get",
        "soa_set", "similar_soa", "for_unrolled", "map_unrolled",
        "reduce_unrolled", "sum_unrolled", "switch_apply",
        "WavefrontRenderer", "RenderConfig", "Materials", "PointLights",
        "Camera", "example_scene", "particle_scene", "build_triangles",
        "is_degenerate_face", "sphere_mesh", "box_mesh", "plane_mesh",
        "displaced_grid_mesh", "HitResult", "closest_hit_brute",
        "any_hit_brute", "sampling", "sharding", "blas_to_static_tlas",
        "Instances", "karras_topology", "refit_aabbs", "build_triangle",
        "deref", "to_tuple", "maybe_convert_field", "texture_to_numpy",
        "DenseScene", "build_dense", "closest_hit_dense", "any_hit_dense",
        "morton_sort_rays", "closest_hit_dense_pallas", "save_scene",
        "load_scene", "load_obj", "bake_dense", "flatten_world_triangles",
        "PTConfig", "trace_paths", "TLAS4",
    ]
    missing = [n for n in names if not hasattr(rc, n)]
    assert not missing, f"missing exports: {missing}"


@pytest.mark.slow
def test_ray_plot_recipe(room, tmp_path):
    """Software RayPlot recipe (reference ext/RaycoreMakieExt.jl:105-202):
    geometry + hit/miss arrows + markers + labels, depth-tested."""
    scene, mats, lights, cam = room
    lo, hi = (np.asarray(v) for v in scene.root_aabb)
    c = (lo + hi) / 2
    o = np.tile(c + np.array([0, 0, hi[2] - lo[2] + 1.0]), (3, 1))
    d = np.array([[0, 0, -1.0],          # hits the scene from above
                  [0, 0, 1.0],           # escapes upward (miss)
                  [0.2, 0.1, -1.0]])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays = rc.Ray.create(o=jnp.asarray(o, jnp.float32),
                         d=jnp.asarray(d, jnp.float32))
    res = rc.trace_rays(scene, rays)
    hits = np.asarray(res.hits)
    assert hits[0] and not hits[1]
    img = rc.ray_plot(scene, res, width=160, height=120, show_labels=True)
    assert img.shape == (120, 160, 3) and np.isfinite(img).all()
    assert (img >= 0).all() and (img <= 1).all()
    # The plot must differ from the empty background and from a
    # geometry-only render (rays/markers actually drawn).
    geo_only = rc.ray_plot(scene, rc.RayIntersectionResult(
        origins=res.origins[:0], directions=res.directions[:0],
        hits=res.hits[:0], points=res.points[:0], t=res.t[:0],
        instance_idx=res.instance_idx[:0], metadata=res.metadata[:0]),
        width=160, height=120)
    assert img.std() > 0.01
    assert np.abs(img - geo_only).max() > 0.2
    rc.save_png(img, str(tmp_path / "rayplot.png"))
    assert (tmp_path / "rayplot.png").stat().st_size > 100

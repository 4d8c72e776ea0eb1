"""raycore — a ray-triangle intersection engine in JAX.

Built from scratch in JAX/XLA/Pallas with the capabilities of
JuliaGeometry/Raycore.jl (see SURVEY.md for the component map). The public
surface mirrors the reference's exported API (reference src/Raycore.jl:90-152)
in Python form: SoA pytrees instead of isbits structs, explicit PRNG keys,
0-based indices, and `sync()` as the jit commit boundary.
"""

import os as _os

import jax as _jax

from .utils.cache import DEFAULT_DIR as _DEFAULT_CACHE_DIR

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set (JAX
# reads it itself), else one fixed directory inside the checkout.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)

from .core.ray import (Ray, RayDifferentials, apply, check_direction,
                       increase_hit, scale_differentials, set_direction)
from .core.bounds import (Bounds2, Bounds3, union, intersect_bounds, overlaps,
                          inside, inside_exclusive, expand, diagonal,
                          surface_area, volume, maximum_extent, corner,
                          corners, lerp, offset, bounding_sphere,
                          intersect_ray, intersect_p, fast_intersect_bbox)
from .core.transforms import (Transformation, Quaternion, translate, scale,
                              rotate, rotate_x, rotate_y, rotate_z, look_at,
                              perspective, has_scale, swaps_handedness, slerp,
                              mat4_to_mat3x4, mat3x4_inverse, mat3x4_identity,
                              transform_point_3x4, transform_direction_3x4)
from .core.triangle import (Triangle, empty_triangle, area, normal,
                            is_degenerate, intersect_triangle,
                            fast_intersect_triangle, safe_invdir,
                            partial_derivatives, normal_derivatives,
                            object_bound, world_bound)
from .core import sampling
from .core.sampling import reflect
from .accel.brute import HitResult, closest_hit_brute, any_hit_brute
from .accel.types import (BLAS, Instances, StaticTLAS, INVALID_NODE,
                          TOP_LEVEL_SENTINEL)
from .accel.lbvh import build_blas, karras_topology, refit_aabbs
# Generic query entry points: dispatch on the scene form (StaticTLAS /
# DenseScene / DenseInstancedScene) — the reference's multiple dispatch
# over AbstractAccel. The traversal-engine functions stay importable as
# raycore.accel.traversal.closest_hit/any_hit.
from .accel.dispatch import (scene_closest_hit as closest_hit,
                             scene_any_hit as any_hit)
from .accel.wide import (BLAS4, TLAS4, build_blas4, collapse_blas,
                         closest_hit4, any_hit4)
from .accel.transport import (RTRay, RTHitResult, trace_closest_hits,
                              trace_any_hits)
from .accel.protocol import AbstractAccel, TLASAccel, BruteAccel
from .accel.dense import (DenseScene, build_dense, closest_hit_dense,
                          any_hit_dense, morton_sort_rays)
from .ops.pallas_dense import closest_hit_dense_pallas
from .ops.pallas_regroup import (closest_hit_regrouped, has_warm_capacity,
                                 prewarm)
from .scene.tlas import (TLAS, TLASHandle, INVALID_HANDLE,
                         blas_to_static_tlas, instance_buffer, refit_tlas)
from .scene.mesh import (build_triangles, build_triangle,
                         is_degenerate_face, sphere_mesh,
                         box_mesh, plane_mesh, displaced_grid_mesh,
                         blobby_mesh)
from .scene.obj import load_obj
from .scene.io import save_scene, load_scene
from .scene.bake import bake_dense, flatten_world_triangles
from .scene.instanced import (DenseInstancedScene, bake_instanced,
                              refresh_instances)
from .collections.multitypeset import (MultiTypeSet, StaticMultiTypeSet,
                                       SetKey, TexturePool, with_index,
                                       is_invalid, is_valid_key,
                                       sample_nearest, sample_bilinear,
                                       deref, to_tuple, maybe_convert_field,
                                       texture_to_numpy)
from .analysis.kernels import (RayHits, generate_ray_grid, hits_from_grid,
                               get_centroid, get_illumination, view_factors)
from .analysis.collision import (CollisionResult, collide_instances,
                                 collide_instances_any)
from .render.wavefront import (WavefrontRenderer, RenderConfig, Materials,
                               PointLights, Camera, render_step)
from .render.scenes import example_scene, particle_scene
from .render.pathtracer import PTConfig, trace_paths
from .render.debug_viz import (RayIntersectionResult, trace_rays,
                               scene_preview, ray_plot, save_ppm, save_png)
from .utils.soa import (soa_get, soa_set, similar_soa, for_unrolled,
                        map_unrolled, reduce_unrolled, sum_unrolled,
                        switch_apply)
from .parallel import sharding

__version__ = "0.1.0"

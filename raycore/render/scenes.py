"""Example scenes for the renderers, tests, and benchmarks.

Procedural analog of the reference's example_scene (reference:
docs/src/raytracing-core.jl:168-216 — a room with furniture-like props and
per-mesh material metadata). No external model files: the centerpiece is a
displaced sphere instead of the cat mesh.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.triangle import Triangle
from ..scene.mesh import box_mesh, plane_mesh, sphere_mesh, displaced_grid_mesh
from ..scene.tlas import TLAS
from .wavefront import Camera, Materials, PointLights


def _with_material(tris: Triangle, mat_idx: int) -> Triangle:
    return tris.replace(metadata=jnp.full(tris.batch_shape, mat_idx,
                                          jnp.uint32))


def example_scene():
    """Room + props, 6 meshes with per-mesh material metadata.

    Returns (static_tlas, materials, lights, camera). Material indices:
    0 floor, 1 back wall, 2 side wall, 3 matte sphere, 4 metallic sphere,
    5 box.
    """
    mgr, materials, lights, camera = example_manager()
    return mgr.sync(), materials, lights, camera


def example_manager():
    """example_scene with the mutable TLAS manager in place of its
    synced StaticTLAS (bake it with bake_dense / bake_instanced)."""
    mgr = TLAS()
    # Floor (z=0 plane), walls.
    mgr.push(_with_material(
        plane_mesh(center=(0, 0, 0), u=(4, 0, 0), v=(0, 4, 0)), 0))
    mgr.push(_with_material(
        plane_mesh(center=(0, 4, 2), u=(4, 0, 0), v=(0, 0, 2)), 1))
    mgr.push(_with_material(
        plane_mesh(center=(-4, 0, 2), u=(0, 4, 0), v=(0, 0, 2)), 2))
    # Props.
    mgr.push(_with_material(
        sphere_mesh(center=(0.0, 1.0, 1.0), radius=1.0,
                    n_theta=24, n_phi=48), 3))
    mgr.push(_with_material(
        sphere_mesh(center=(2.0, -0.5, 0.7), radius=0.7,
                    n_theta=24, n_phi=48), 4))
    mgr.push(_with_material(
        box_mesh(p_min=(-2.6, -0.4, 0.0), p_max=(-1.4, 0.8, 1.2)), 5))

    materials = Materials.create(
        base_color=np.array([
            [0.75, 0.75, 0.75],   # floor
            [0.65, 0.25, 0.22],   # back wall
            [0.25, 0.45, 0.65],   # side wall
            [0.85, 0.65, 0.25],   # matte sphere
            [0.95, 0.95, 0.95],   # metal sphere
            [0.35, 0.65, 0.35],   # box
        ], np.float32),
        metallic=np.array([0.0, 0.0, 0.0, 0.0, 0.9, 0.0], np.float32),
        roughness=np.array([0.8, 0.9, 0.9, 0.6, 0.1, 0.7], np.float32),
    )
    lights = PointLights(
        position=jnp.asarray([[3.0, -3.0, 5.0], [-3.0, -1.0, 4.0]],
                             jnp.float32),
        intensity=jnp.asarray([[30.0, 30.0, 28.0], [8.0, 9.0, 12.0]],
                              jnp.float32),
    )
    camera = Camera.create(position=(1.5, -6.0, 2.5), target=(0.0, 0.5, 1.0),
                           up=(0, 0, 1), fov_deg=50.0)
    return mgr, materials, lights, camera


def particle_scene(n_particles=1024, seed=0):
    """Instanced-particles analog (reference wavefront_particles.jl): one
    low-poly sphere BLAS, one multi-transform handle with n instances.
    Returns (tlas_manager, handle, positions)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-4, 4, (n_particles, 3)).astype(np.float32)
    transforms = np.tile(np.eye(3, 4, dtype=np.float32), (n_particles, 1, 1))
    transforms[:, :, :3] *= 0.08
    transforms[:, :, 3] = pos
    mgr = TLAS()
    h = mgr.push(sphere_mesh(radius=1.0, n_theta=6, n_phi=8),
                 transforms=list(transforms))
    return mgr, h, pos

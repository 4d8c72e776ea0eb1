"""Scene baking: flatten an instanced TLAS into a world-space soup.

For static (or rarely-changing) scenes, the fastest query path is the
dense clustered engine, which operates on a single world-space triangle
soup. ``bake_dense`` transforms every live instance's triangles by its 3x4
transform and builds a DenseScene; renderers then route through the dense
engine via accel/dispatch.

Trade-offs vs the instanced StaticTLAS (documented contract):
- geometry is duplicated per instance (memory ∝ total instanced tris),
- `HitResult.instance_idx` reports the baked soup's instance slot via a
  side array (`instance_of_prim`) rather than during traversal,
- transform updates require re-baking (use the TLAS refit path for
  per-frame dynamics).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.dense import DenseScene, build_dense
from ..core.transforms import transform_point_3x4, _apply_mat3
from ..core.triangle import Triangle


def flatten_world_triangles(mgr) -> tuple[Triangle, jnp.ndarray]:
    """(world-space Triangle soup, per-triangle instance index) from a
    mutable TLAS manager."""
    parts = []
    inst_of = []
    for idx, rec in enumerate(mgr._instances):
        blas = mgr._blas[rec.blas_slot]
        tris = blas.prims
        n = blas.n_prims
        take = lambda a: a[:n]
        m = jnp.asarray(rec.transform)
        v = transform_point_3x4(m, take(tris.vertices))
        # Normals transform by inverse-transpose of the 3x3 block.
        R = np.asarray(rec.transform)[:, :3]
        R_it = np.linalg.inv(R).T.astype(np.float32)
        nrm = _apply_mat3(jnp.asarray(R_it), take(tris.normals))
        parts.append(Triangle(
            vertices=v, normals=nrm,
            tangents=take(tris.tangents), uv=take(tris.uv),
            metadata=take(tris.metadata)))
        inst_of.append(jnp.full((n,), idx, jnp.int32))
    soup = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs, axis=0), *parts)
    return soup, jnp.concatenate(inst_of)


def bake_dense(mgr, cluster_size: int = 128) -> DenseScene:
    """Bake a mutable TLAS into a DenseScene (static fast path). Hits
    report the owning instance slot via the scene's instance_of_prim
    side array (matches the TLAS traversal's instance_idx)."""
    soup, inst_of = flatten_world_triangles(mgr)
    return build_dense(soup, cluster_size=cluster_size,
                       instance_of=inst_of)

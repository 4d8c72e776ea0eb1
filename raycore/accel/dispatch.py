"""Engine dispatch: route queries to the right accelerator for the scene.

Two interchangeable scene forms implement the query contract:
- `StaticTLAS`  -> two-level BVH wavefront traversal (general: instancing,
                   dynamic scenes, any ray distribution),
- `DenseScene`  -> dense clustered engines (single geometry): the tile
                   worklist sweep, or the cluster-major regrouped sweep
                   for big queries once it is warm. Unlike the XLA rounds
                   variant, the worklist's work is exactly the per-tile
                   candidate set, so tiles with escaping rays don't
                   amplify into global extra rounds.

The renderers and the analysis layer call through these functions so either
scene form plugs in (the AbstractAccel idea applied at the query level).
"""
from __future__ import annotations

import jax

from .brute import HitResult
from .dense import DenseScene, any_hit_dense, closest_hit_dense
from .types import StaticTLAS
from . import traversal as _trav


def _tracing(x):
    return isinstance(x, jax.core.Tracer)


# Queries below this size don't amortize the regrouped engine's per-call
# grouping/argsort overhead; they stay on the auto-sized tile worklist.
REGROUP_MIN_RAYS = 1 << 19


def _dense_query(scene, rays, tile_size, payload: str = "full",
                 deferred: bool = False):
    if _tracing(rays.o):
        # Inside someone's jit the regrouped engine's host sync cannot
        # run. The XLA rounds engine is the best all-rounder there: for
        # coherent bundles it converges in a couple of rounds; pipelines
        # with many incoherent escaping rays should use the staged
        # drivers that call the worklist sweep between jitted stages
        # (render/pathtracer.trace_paths_staged).
        res = closest_hit_dense(scene, rays,
                                tile=min(2048, max(tile_size, 8)))
        return (res, None) if deferred else res
    import os
    n_rays = 1
    for s in rays.batch_shape:
        n_rays *= s
    if n_rays >= REGROUP_MIN_RAYS and scene.sub_chunks == 1:
        # Cluster-major regrouped sweep: the big-query engine. Routed
        # here when EITHER the user opted in (RAYCORE_DISPATCH_REGROUP=1)
        # OR the engine is already WARM for this (scene, shape) — a
        # previous query or an explicit rc.prewarm() sized its capacities
        # and compiled its stage graphs, so a repeat query is one
        # dispatch and a renderer's first frame never pays that compile.
        from ..ops.pallas_regroup import (closest_hit_regrouped,
                                          has_warm_capacity)
        opt_in = os.environ.get("RAYCORE_DISPATCH_REGROUP", "0") == "1"
        # passes="auto": depth-complex scenes take the ordered-wave
        # multiwave path, single sheets stay passes=1. Probe warmth for
        # BOTH the auto-resolved passes and the plain passes=1 engine: a
        # scene explicitly prewarmed with passes=1 that auto-resolves to
        # 4 must still route to its compiled fused engine.
        if opt_in or has_warm_capacity(scene, n_rays, passes="auto",
                                       payload=payload):
            return closest_hit_regrouped(scene, rays, tile=2048,
                                         passes="auto", payload=payload,
                                         deferred=deferred)
        if has_warm_capacity(scene, n_rays, passes=1, payload=payload):
            return closest_hit_regrouped(scene, rays, tile=2048,
                                         passes=1, payload=payload,
                                         deferred=deferred)
    from ..ops.pallas_dense import closest_hit_dense_pallas_auto
    res = closest_hit_dense_pallas_auto(scene, rays,
                                        tile=min(512, max(tile_size, 8)))
    return (res, None) if deferred else res


def scene_closest_hit(scene, rays, *, tile_size: int = 16384,
                      payload: str = "full", deferred: bool = False,
                      **trav_kw) -> HitResult:
    """Generic closest-hit over any scene form — the package-level
    ``rc.closest_hit``. Dispatches by scene type the way the reference's
    multiple dispatch does over `AbstractAccel` (src/Raycore.jl:23-47):
    StaticTLAS -> two-level traversal, DenseScene -> dense engines,
    DenseInstancedScene -> instanced sweep. Extra keyword args
    (stack_size, max_iters, substeps) apply to the traversal engine only.

    payload="slim" (DenseScene fast path only) declares that the caller
    never reads triangle/barycentric: the regrouped engine then skips
    the per-ray payload gather + exact recompute (hit/t/prim/instance/
    metadata stay exact). Engines without a slim mode ignore the hint
    and return the full payload — slim consumers are unaffected.

    deferred=True (host-pipelined drivers): ALWAYS returns
    ``(result, finalizer_or_None)``. When the query ran on a warm fused
    regroup path the result is UNSYNCED and the finalizer must be called
    later — it blocks on the query's capacity totals and returns a
    checksum, or None when a capacity prediction missed (the result is
    then garbage and the query/frame must be re-issued non-deferred).
    Every other engine runs its normal synchronous path and hands back
    ``(result, None)`` — already valid. This is how the staged renderers
    chain a whole frame's queries into back-to-back device dispatches
    with ONE host sync at the end."""
    if isinstance(scene, DenseScene):
        if trav_kw:
            raise TypeError(f"dense-engine queries do not accept {trav_kw}")
        return _dense_query(scene, rays, tile_size, payload=payload,
                            deferred=deferred)
    from ..scene.instanced import DenseInstancedScene
    if isinstance(scene, DenseInstancedScene):
        if _tracing(rays.o):
            raise ValueError(
                "DenseInstancedScene queries auto-size their worklists "
                "with a host sync and cannot run under tracing; inside "
                "jit use ops.pallas_instanced.closest_hit_instanced_"
                "static with capacities from instanced_capacity_hint "
                "(warm up once outside jit), call between jitted stages "
                "(staged drivers), or use a StaticTLAS scene")
        if trav_kw:
            raise TypeError(f"instanced queries do not accept {trav_kw}")
        from ..ops.pallas_instanced import closest_hit_instanced
        res = closest_hit_instanced(scene, rays)
        return (res, None) if deferred else res
    res = _trav.closest_hit(scene, rays, tile_size=tile_size, **trav_kw)
    return (res, None) if deferred else res


def scene_any_hit(scene, rays, *, tile_size: int = 16384,
                  deferred: bool = False, **trav_kw) -> HitResult:
    if isinstance(scene, DenseScene):
        import jax.numpy as jnp
        if trav_kw:
            raise TypeError(f"dense-engine queries do not accept {trav_kw}")
        if not _tracing(rays.o):
            import os
            n_rays = 1
            for s in rays.batch_shape:
                n_rays *= s
            if n_rays >= REGROUP_MIN_RAYS and scene.sub_chunks == 1:
                # Regrouped occlusion (per-subgroup candidates + skipped
                # payload finalize) when warm / opted-in — same routing
                # rule as the closest path.
                from ..ops.pallas_regroup import (any_hit_regrouped,
                                                  has_warm_capacity)
                opt_in = os.environ.get("RAYCORE_DISPATCH_REGROUP",
                                        "0") == "1"
                if opt_in or has_warm_capacity(scene, n_rays,
                                               occlusion=True):
                    return any_hit_regrouped(scene, rays, tile=2048,
                                             deferred=deferred)
            # Dedicated occlusion kernel: first accepted hit wins, no
            # best-t carry / merge / payload gather (reference any_hit
            # early-exit, src/instanced-bvh.jl:2034-2140). Only hit +
            # occluder ids are populated — the occlusion contract.
            from ..ops.pallas_dense import any_hit_dense_pallas_auto
            res = any_hit_dense_pallas_auto(
                scene, rays, tile=min(512, max(tile_size, 8)))
            return (res, None) if deferred else res
        rays0 = rays.replace(t_min=jnp.zeros_like(rays.t_min))
        return _dense_query(scene, rays0, tile_size, deferred=deferred)
    from ..scene.instanced import DenseInstancedScene
    if isinstance(scene, DenseInstancedScene):
        if trav_kw:
            raise TypeError(f"instanced queries do not accept {trav_kw}")
        from ..ops.pallas_instanced import any_hit_instanced
        res = any_hit_instanced(scene, rays)
        return (res, None) if deferred else res
    res = _trav.any_hit(scene, rays, tile_size=tile_size, **trav_kw)
    return (res, None) if deferred else res


def scene_root_aabb(scene):
    return scene.root_aabb

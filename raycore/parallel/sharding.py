"""Multi-device scaling: data-parallel ray sharding over a device mesh.

The reference is a single-device library (SURVEY.md §2.9, §5.8: no
inter-device communication anywhere); its scalable dimension is the number
of rays in flight. The scaling strategy is therefore:

- the frozen scene pytree (flat node/prim/instance buffers) is REPLICATED
  on every device,
- the ray wavefront is SHARDED along its batch dimension over the mesh,
- analysis reductions (illumination histograms, view-factor rows) come back
  replicated, which makes XLA insert the all-reduce over the device
  interconnect.

No explicit collectives are written here — shardings are declared with
`jax.sharding.NamedSharding` and XLA/pjit inserts the communication.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.ray import Ray
from ..accel import dispatch as _disp, traversal as _trav
from ..accel.types import StaticTLAS

RAY_AXIS = "rays"


def make_mesh(devices=None, axis_name: str = RAY_AXIS) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def replicate_scene(scene: StaticTLAS, mesh: Mesh) -> StaticTLAS:
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, rep), scene)


def shard_rays(rays: Ray, mesh: Mesh) -> Ray:
    """Shard the flat ray batch over the mesh's ray axis. The batch size
    must be divisible by the axis size (pad upstream with t_max=-1 rays)."""
    shard = lambda spec: lambda a: jax.device_put(a, NamedSharding(mesh, spec))
    return Ray(o=shard(P(RAY_AXIS, None))(rays.o),
               d=shard(P(RAY_AXIS, None))(rays.d),
               t_min=shard(P(RAY_AXIS))(rays.t_min),
               t_max=shard(P(RAY_AXIS))(rays.t_max),
               time=shard(P(RAY_AXIS))(rays.time))


def pad_rays_to(rays: Ray, multiple: int) -> Ray:
    n = rays.o.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return rays
    pad = target - n

    def ext(a, fill):
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])

    return Ray(o=ext(rays.o, 0.0), d=ext(rays.d, 1.0),
               t_min=ext(rays.t_min, 0.0), t_max=ext(rays.t_max, -1.0),
               time=ext(rays.time, 0.0))


def distributed_closest_hit(scene: StaticTLAS, rays: Ray, mesh: Mesh,
                            tile_size: int = 16384):
    """closest_hit with rays sharded over the mesh, scene replicated.
    Returns a HitResult sharded like the rays."""
    scene = replicate_scene(scene, mesh)
    rays = shard_rays(pad_rays_to(rays, mesh.size), mesh)
    return _disp.scene_closest_hit(scene, rays, tile_size=tile_size)


def _hitresult_specs(res_tree, axis=RAY_AXIS):
    """PartitionSpec pytree sharding every HitResult leaf on its ray dim."""
    from jax.sharding import PartitionSpec as P_
    return jax.tree_util.tree_map(
        lambda a: P_(axis, *([None] * (a.ndim - 1))), res_tree)


# Per-(scene, shape, mesh) capacity memory for the sharded regroup driver
# (same contract as the single-device engines' caches).
_DIST_CAPS: dict = {}

# Compiled shard_map executables keyed by their static parameters: the
# driver builds a fresh Python closure per call, which would otherwise
# re-trace and re-compile every query — serving loops need the repeat
# query to be a cache hit.
_DIST_FNS: dict = {}


def _stage2_abs(scene, TILE, G, spb, P_cap, B_cap,
                o, d, t_min, t_max):
    """Collective-free single-shard pipeline, used only under
    jax.eval_shape to derive the HitResult leaf structure for the
    shard_map out_specs (the real body adds a pmax, which cannot trace
    outside the mesh)."""
    from ..ops.pallas_regroup import _stage1_core, _stage2_core
    block_cid, block_subs, tbl, _total, _coarse = _stage1_core(
        scene, o, d, t_min, t_max, TILE, G, spb, P_cap)
    return _stage2_core(scene, block_cid, block_subs, tbl, o, d, G, spb,
                        B_cap, "grouped", o.shape[0],
                        None, None)


def distributed_closest_hit_dense(scene, rays: Ray, mesh: Mesh, *,
                                  tile: int = 2048, subgroup: int = 32,
                                  spb: int = 16, pairs_per_tile: int = 48):
    """Exact closest hit on a replicated DenseScene with rays sharded
    over the mesh — the multi-device form of the PRODUCTION cluster-major
    regrouped engine (ops/pallas_regroup.py), not the slow traversal
    fallback.

    Expression: `shard_map` over the ray axis; each device runs the full
    stage1 (phase A -> worklist -> subgroup refine -> cluster-major
    grouping) and the sweep kernel on its local ray partition against
    the replicated scene tables — the pipeline is embarrassingly
    data-parallel over ray partitions, so the only cross-device
    communication is a `pmax` of the per-device worklist totals, which
    the host reads to validate the STATIC capacity buckets (the
    auto-sizing host-sync contract, lifted over the mesh: overflow
    doubles the bucket and retries, so results are never truncated).
    Capacities are remembered per (scene, shape, mesh) like the
    single-device engines' caches."""
    from ..ops.pallas_regroup import (_stage1_core, _stage2_core,
                                      _shape_params)
    if getattr(scene, "sub_chunks", 1) != 1:
        raise ValueError("sharded regroup requires sub_chunks=1 scenes")
    n_dev = mesh.size
    batch = rays.batch_shape
    flatten = lambda a: a.reshape((-1,) + a.shape[len(batch):])
    rays = Ray(o=flatten(rays.o), d=flatten(rays.d),
               t_min=flatten(rays.t_min), t_max=flatten(rays.t_max),
               time=flatten(rays.time))
    R0 = rays.o.shape[0]
    G, TILE, _ = _shape_params(max(R0 // n_dev, 1), tile, subgroup)
    rays = pad_rays_to(rays, n_dev * TILE)
    R = rays.o.shape[0]
    R_loc = R // n_dev
    n_tiles_loc = R_loc // TILE
    K = scene.n_clusters
    hard = n_tiles_loc * K
    SPT = TILE // G

    scene_r = replicate_scene(scene, mesh)
    rays_s = shard_rays(rays, mesh)
    d = jnp.where(rays_s.d == 0.0, 0.0, rays_s.d)

    ck = (id(scene.tri_feats), scene.tri_feats.shape, R, n_dev, TILE, G,
          spb)
    ent = _DIST_CAPS.get(ck)
    if ent is not None and ent["ref"]() is scene.tri_feats:
        P_cap = min(max(4096, -(-int(ent["coarse"] * 1.2) // 4096) * 4096),
                    hard)
    else:
        ent = None
        P_cap = min(pairs_per_tile * n_tiles_loc, hard)

    while True:
        B_cap = P_cap * SPT // spb + K + 1

        fk = (TILE, G, spb, P_cap, B_cap, R_loc, mesh,
              scene.tri_feats.shape, scene.cluster_size)
        jfn = _DIST_FNS.get(fk)
        if jfn is None:
            def body(scene, o, d, t_min, t_max):
                out = _stage1_core(scene, o, d, t_min, t_max, TILE, G,
                                   spb, P_cap)
                block_cid, block_subs, tbl, total, coarse = out
                res = _stage2_core(scene, block_cid, block_subs, tbl, o,
                                   d, G, spb, B_cap,
                                   "grouped", o.shape[0], None, None)
                totals = jax.lax.pmax(jnp.stack([total, coarse]),
                                      RAY_AXIS)
                return res, totals

            # Output specs: HitResult leaves sharded on rays; totals
            # replicated. Build the spec tree from an abstract eval of
            # one local shard.
            loc = lambda a: jax.ShapeDtypeStruct((R_loc,) + a.shape[1:],
                                                 a.dtype)
            res_abs = jax.eval_shape(
                partial(_stage2_abs, scene, TILE, G, spb, P_cap, B_cap),
                loc(rays.o), loc(rays.d), loc(rays.t_min),
                loc(rays.t_max))
            out_specs = (_hitresult_specs(res_abs), P())

            jfn = jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(P(), P(RAY_AXIS, None), P(RAY_AXIS, None),
                          P(RAY_AXIS), P(RAY_AXIS)),
                out_specs=out_specs, check_vma=False))
            if len(_DIST_FNS) > 64:
                _DIST_FNS.pop(next(iter(_DIST_FNS)))
            _DIST_FNS[fk] = jfn
        res, totals = jfn(scene_r, rays_s.o, d, rays_s.t_min,
                          rays_s.t_max)
        total_max, coarse_max = (int(x) for x in np.asarray(totals))
        if coarse_max <= P_cap:
            break
        if P_cap >= hard:
            raise RuntimeError(
                f"sharded regroup overflow at hard capacity: "
                f"{coarse_max} > {P_cap}")
        P_cap = min(2 * P_cap, hard)
    import weakref
    _DIST_CAPS[ck] = dict(coarse=max(coarse_max,
                                     (ent or {}).get("coarse", 0)),
                          ref=weakref.ref(scene.tri_feats))
    return jax.tree_util.tree_map(lambda a: a[:R0], res)


@partial(jax.jit, static_argnames=("n_bins", "tile_size"))
def _illumination_step(scene: StaticTLAS, rays: Ray, n_bins: int,
                       tile_size: int):
    """One full sharded analysis step: trace + shade + global histogram.
    The (n_bins,) output is replicated => XLA inserts the cross-device
    reduction over the device interconnect."""
    res = _disp.scene_closest_hit(scene, rays, tile_size=tile_size)
    idx = jnp.clip(res.triangle.metadata.astype(jnp.int32), 0, n_bins - 1)
    hist = jnp.zeros((n_bins,), jnp.float32).at[idx].add(
        res.hit.astype(jnp.float32), mode="drop")
    return res.t, hist


def distributed_illumination(scene: StaticTLAS, rays: Ray, mesh: Mesh,
                             n_bins: int, tile_size: int = 16384):
    """The flagship multi-device step: sharded rays -> per-device trace ->
    all-reduced per-triangle hit histogram (the multi-device form of
    get_illumination, reference src/kernels.jl:112-124)."""
    scene = replicate_scene(scene, mesh)
    rays = shard_rays(pad_rays_to(rays, mesh.size), mesh)
    return _illumination_step(scene, rays, n_bins, tile_size)

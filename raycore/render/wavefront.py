"""Wavefront path-tracing renderer — the flagship workload.

JAX port of the reference's canonical consumer (reference:
docs/src/wavefront-renderer.jl): the 9-stage SoA pipeline
(primary rays -> intersect -> shadow rays -> occlusion -> lambert shade ->
reflection rays -> intersect -> blend -> accumulate) expressed as one jit
step over SoA wavefront queues.

Improvement over the reference: between bounces, rays are
COMPACTED by sorting on the active mask — inactive lanes cluster into
whole tiles whose traversal while_loops retire immediately (the reference
keeps dense queues with dummy rays; SURVEY.md §2.6 "no compaction").

Materials are an SoA table indexed by triangle metadata (the reference's
per-mesh material-index payload, docs/src/raytracing-core.jl:29-44).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core.ray import Ray
from ..core.triangle import bary_interp
from ..core.sampling import reflect
from ..accel import dispatch as _disp
from ..accel.types import StaticTLAS


@struct.dataclass
class Materials:
    """SoA material table (reference Material,
    docs/src/raytracing-core.jl:29-38)."""
    base_color: jnp.ndarray   # (M, 3)
    metallic: jnp.ndarray     # (M,)
    roughness: jnp.ndarray    # (M,)
    ior: jnp.ndarray          # (M,)
    transmission: jnp.ndarray  # (M,)

    @classmethod
    def create(cls, base_color, metallic=None, roughness=None, ior=None,
               transmission=None):
        base_color = jnp.asarray(base_color, jnp.float32)
        m = base_color.shape[0]
        z = lambda v, d: (jnp.full((m,), d, jnp.float32) if v is None
                          else jnp.asarray(v, jnp.float32))
        return cls(base_color=base_color, metallic=z(metallic, 0.0),
                   roughness=z(roughness, 0.0), ior=z(ior, 1.5),
                   transmission=z(transmission, 0.0))


@struct.dataclass
class PointLights:
    """SoA point lights (reference PointLight,
    docs/src/raytracing-core.jl:23-27)."""
    position: jnp.ndarray   # (L, 3)
    intensity: jnp.ndarray  # (L, 3)


@struct.dataclass
class Camera:
    position: jnp.ndarray
    target: jnp.ndarray
    up: jnp.ndarray
    fov_deg: jnp.ndarray

    @classmethod
    def create(cls, position, target, up=(0, 0, 1), fov_deg=45.0):
        f = lambda x: jnp.asarray(x, jnp.float32)
        return cls(position=f(position), target=f(target), up=f(up),
                   fov_deg=f(fov_deg))


def camera_basis(cam: Camera):
    fwd = cam.target - cam.position
    fwd = fwd / jnp.linalg.norm(fwd)
    right = jnp.cross(fwd, cam.up)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(right, fwd)
    return fwd, right, up


def generate_primary_rays(cam: Camera, width: int, height: int, spp: int,
                          key) -> Ray:
    """Stage 1: pinhole lookat rays, spp jittered samples per pixel
    (reference generate_primary_rays_lookat!)."""
    fwd, right, up = camera_basis(cam)
    tan_half = jnp.tan(jnp.deg2rad(cam.fov_deg) * 0.5)
    aspect = width / height
    jit = jax.random.uniform(key, (height, width, spp, 2), jnp.float32)
    px = jnp.arange(width, dtype=jnp.float32)[None, :, None]
    py = jnp.arange(height, dtype=jnp.float32)[:, None, None]
    u = ((px + jit[..., 0]) / width * 2.0 - 1.0) * tan_half * aspect
    v = (1.0 - (py + jit[..., 1]) / height * 2.0) * tan_half
    d = fwd + u[..., None] * right + v[..., None] * up
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam.position, d.shape)
    return Ray.create(o=o.reshape(-1, 3), d=d.reshape(-1, 3))


def _mat_lookup(materials: Materials, idx):
    idx = jnp.clip(idx, 0, materials.base_color.shape[0] - 1)
    take = lambda a: jnp.take(a, idx, axis=0)
    return jax.tree_util.tree_map(take, materials)


def compact_order(active):
    """Stable order putting active lanes first — inactive lanes cluster
    into tiles that retire instantly in the traversal lax.map."""
    return jnp.argsort(~active, stable=True)


@struct.dataclass
class RenderConfig:
    width: int = struct.field(pytree_node=False, default=256)
    height: int = struct.field(pytree_node=False, default=256)
    spp: int = struct.field(pytree_node=False, default=1)
    ambient: float = struct.field(pytree_node=False, default=0.08)
    shadow_eps: float = struct.field(pytree_node=False, default=1e-3)
    reflect_eps: float = struct.field(pytree_node=False, default=1e-3)
    tile_size: int = struct.field(pytree_node=False, default=16384)
    background: tuple = struct.field(pytree_node=False,
                                     default=(0.05, 0.07, 0.12))


def _shade_lambert(hit_p, hit_n, view_dir, mats, lights: PointLights,
                   occluded, ambient):
    """Stages 4-5: lambert + inverse-square attenuation + hard shadows +
    ambient (reference shade_primary_hits!)."""
    to_l = lights.position[None, :, :] - hit_p[:, None, :]     # (R, L, 3)
    dist2 = jnp.sum(to_l * to_l, axis=-1)
    dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    wi = to_l / dist[..., None]
    ndotl = jnp.maximum(jnp.sum(hit_n[:, None, :] * wi, -1), 0.0)
    vis = jnp.where(occluded, 0.0, 1.0)
    irr = lights.intensity[None] * (ndotl * vis / jnp.maximum(dist2, 1e-12))[..., None]
    diffuse = mats.base_color * (jnp.sum(irr, axis=1) + ambient)
    return diffuse


def _surface_frame(res, in_dir):
    """Hit point + viewer-facing smooth normal from a query result."""
    tri = res.triangle
    p = bary_interp(res.barycentric, tri.vertices)
    n = bary_interp(res.barycentric, tri.normals)
    nl = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = jnp.where(nl > 1e-8, n / jnp.where(nl > 0, nl, 1.0), 0.0)
    n = jnp.where(jnp.sum(n * in_dir, -1, keepdims=True) > 0, -n, n)
    return p, n


def _shadow_setup_core(rays, res, materials, lights, cfg: RenderConfig):
    """Stages 2-3 glue: surface frame, material fetch, shadow-ray SoA
    (reference generate_shadow_rays!)."""
    n_lights = lights.position.shape[0]
    hit = res.hit
    hit_p, n = _surface_frame(res, rays.d)
    mats = _mat_lookup(materials, res.triangle.metadata.astype(jnp.int32))
    to_l = lights.position[None] - hit_p[:, None]
    dist = jnp.linalg.norm(to_l, axis=-1)
    wi = to_l / jnp.maximum(dist[..., None], 1e-12)
    so = (hit_p + n * cfg.shadow_eps)[:, None, :] \
        .repeat(n_lights, 1).reshape(-1, 3)
    sd = wi.reshape(-1, 3)
    st = jnp.where(jnp.repeat(hit, n_lights),
                   (dist - 2 * cfg.shadow_eps).reshape(-1), -1.0)
    return dict(hit=hit, hit_p=hit_p, n=n, mats=mats, so=so, sd=sd, st=st)


def _shade_reflect_core(rays, occl_hit, s, key, lights,
                        cfg: RenderConfig):
    """Stages 5-6: lambert shade + compacted reflection-ray generation
    with roughness jitter (reference shade_primary_hits! +
    generate_reflection_rays!, docs/src/wavefront-renderer.jl:457-459)."""
    hit, hit_p, n, mats = s["hit"], s["hit_p"], s["n"], s["mats"]
    R = hit.shape[0]
    n_lights = lights.position.shape[0]
    occluded = occl_hit.reshape(R, n_lights)
    view_dir = -rays.d
    color = _shade_lambert(hit_p, n, view_dir, mats, lights, occluded,
                           cfg.ambient)
    bg = jnp.asarray(cfg.background, jnp.float32)
    color = jnp.where(hit[:, None], color, bg)

    refl_active = hit & (mats.metallic > 0.0)
    rd = reflect(view_dir, n)
    # Roughness jitter: uniform [-1,1]^3 offset scaled by material
    # roughness, renormalized. roughness=0 mirrors exactly.
    offs = (jax.random.uniform(jax.random.fold_in(key, 1), rd.shape,
                               jnp.float32) * 2.0 - 1.0)
    rd = rd + offs * mats.roughness[:, None]
    rd = rd / jnp.maximum(jnp.linalg.norm(rd, axis=-1, keepdims=True), 1e-12)
    order = compact_order(refl_active)
    inv_order = jnp.argsort(order)
    ro_c = (hit_p + n * cfg.reflect_eps)[order]
    rd_c = rd[order]
    act_c = refl_active[order]
    return dict(color=color, refl_active=refl_active, rd=rd,
                inv_order=inv_order, ro_c=ro_c, rd_c=rd_c, act_c=act_c,
                mats=mats)


def _blend_core(rres_sorted, s2, materials, lights, cfg: RenderConfig):
    """Stages 7-9: shade reflections, metallic blend, sample mean
    (reference shade_reflections_and_blend! + accumulate_final!)."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    rres = jax.tree_util.tree_map(lambda a: a[s2["inv_order"]], rres_sorted)
    rd = s2["rd"]
    bg = jnp.asarray(cfg.background, jnp.float32)
    r_p, r_n = _surface_frame(rres, rd)
    r_mats = _mat_lookup(materials,
                         rres.triangle.metadata.astype(jnp.int32))
    r_to_l = lights.position[None] - r_p[:, None]
    r_d2 = jnp.sum(r_to_l * r_to_l, -1)
    r_wi = r_to_l / jnp.maximum(jnp.sqrt(r_d2)[..., None], 1e-12)
    r_ndotl = jnp.maximum(jnp.sum(r_n[:, None] * r_wi, -1), 0.0)
    r_irr = lights.intensity[None] \
        * (r_ndotl / jnp.maximum(r_d2, 1e-12))[..., None]
    r_color = r_mats.base_color * (jnp.sum(r_irr, 1) + cfg.ambient)
    r_color = jnp.where(rres.hit[:, None], r_color, bg)

    mats = s2["mats"]
    m = mats.metallic[:, None]
    color = jnp.where(s2["refl_active"][:, None],
                      s2["color"] * (1 - m)
                      + r_color * mats.base_color * m,
                      s2["color"])
    img = color.reshape(H, W, spp, 3).mean(axis=2)
    return jnp.clip(img, 0.0, 1.0)


@partial(jax.jit, static_argnames=("cfg",))
def render_step(scene: StaticTLAS, materials: Materials, lights: PointLights,
                cam: Camera, key, cfg: RenderConfig):
    """One full wavefront frame -> (H, W, 3) image (reference render!,
    docs/src/wavefront-renderer.jl:758-883, with compaction added).
    Single-jit variant: traversal runs on the in-jit engine (XLA rounds
    for DenseScene). For big frames prefer render_staged below."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    rays = generate_primary_rays(cam, W, H, spp, key)
    res = _disp.scene_closest_hit(scene, rays, tile_size=cfg.tile_size)
    s = _shadow_setup_core(rays, res, materials, lights, cfg)
    occl = _disp.scene_any_hit(
        scene, Ray.create(o=s["so"], d=s["sd"], t_max=s["st"]),
        tile_size=cfg.tile_size)
    s2 = _shade_reflect_core(rays, occl.hit, s, key, lights, cfg)
    rres = _disp.scene_closest_hit(
        scene, Ray.create(o=s2["ro_c"], d=s2["rd_c"],
                          t_max=jnp.where(s2["act_c"], jnp.inf, -1.0)),
        tile_size=cfg.tile_size)
    return _blend_core(rres, s2, materials, lights, cfg)


# Jitted glue stages for the staged driver: all elementwise math stays
# compiled (eager glue costs a dispatch per op); only the three
# traversal queries run at host level, where dispatch can pick the
# worklist / regrouped sweep engines (accel/dispatch.py).
@partial(jax.jit, static_argnames=("W", "H", "spp"))
def _jit_primary(cam, key, W: int, H: int, spp: int):
    return generate_primary_rays(cam, W, H, spp, key)


_jit_shadow_setup = jax.jit(_shadow_setup_core,
                            static_argnames=("cfg",))
_jit_shade_reflect = jax.jit(_shade_reflect_core,
                             static_argnames=("cfg",))
_jit_blend = jax.jit(_blend_core, static_argnames=("cfg",))


def render_staged(scene, materials: Materials, lights: PointLights,
                  cam: Camera, key, cfg: RenderConfig,
                  pipelined: bool = False):
    """Same frame as render_step, but the three traversal queries run
    BETWEEN jitted glue stages, so dispatch routes them to the fastest
    engine available for the scene form (worklist / regrouped
    sweep for DenseScene — those auto-size with a host sync and cannot
    run under tracing). Bitwise-identical math to render_step.

    pipelined=True chains the frame's three queries through the
    deferred dispatch mode (one capacity-validation sync at frame end
    instead of one per query; the inter-query dependencies are
    device-side). A missed capacity prediction discards the frame and
    re-runs it per-query, which grows the sticky-max capacities so the
    miss does not repeat. Prewarm the scene (rc.prewarm) first —
    unwarmed engines just run synchronously."""
    W, H, spp = cfg.width, cfg.height, cfg.spp

    def frame(deferred: bool):
        fin = []
        rays = _jit_primary(cam, key, W, H, spp)
        res = _disp.scene_closest_hit(scene, rays, tile_size=cfg.tile_size,
                                      deferred=deferred)
        if deferred:
            res, f = res
            fin.append(f)
        s = _jit_shadow_setup(rays, res, materials, lights, cfg)
        occl = _disp.scene_any_hit(
            scene, Ray.create(o=s["so"], d=s["sd"], t_max=s["st"]),
            tile_size=cfg.tile_size, deferred=deferred)
        if deferred:
            occl, f = occl
            fin.append(f)
        s2 = _jit_shade_reflect(rays, occl.hit, s, key, lights, cfg)
        rres = _disp.scene_closest_hit(
            scene, Ray.create(o=s2["ro_c"], d=s2["rd_c"],
                              t_max=jnp.where(s2["act_c"], jnp.inf, -1.0)),
            tile_size=cfg.tile_size, deferred=deferred)
        if deferred:
            rres, f = rres
            fin.append(f)
        return _jit_blend(rres, s2, materials, lights, cfg), fin

    if pipelined:
        img, fin = frame(deferred=True)
        if all(f() is not None for f in fin if f is not None):
            return img
    img, _ = frame(deferred=False)
    return img


class WavefrontRenderer:
    """Holds the frozen scene + materials + lights + config; `render(key)`
    runs the full pipeline (reference WavefrontRenderer struct + render!,
    docs/src/wavefront-renderer.jl:647-883).

    staged=True (default) runs the three traversal queries between
    jitted glue stages so each query gets the fastest engine for the
    scene form; staged=False compiles the whole frame as one jit
    (embed it in a larger jitted loop, donate buffers, etc.).
    pipelined=True (staged only) chains the frame's queries with one
    capacity sync at frame end (see render_staged)."""

    def __init__(self, scene: StaticTLAS, materials: Materials,
                 lights: PointLights, camera: Camera,
                 config: Optional[RenderConfig] = None,
                 staged: bool = True, pipelined: bool = False):
        self.scene = scene
        self.materials = materials
        self.lights = lights
        self.camera = camera
        self.config = config or RenderConfig()
        self.staged = staged
        self.pipelined = pipelined

    def render(self, key=None) -> jnp.ndarray:
        if key is None:
            key = jax.random.PRNGKey(0)
        if self.staged:
            return render_staged(self.scene, self.materials, self.lights,
                                 self.camera, key, self.config,
                                 pipelined=self.pipelined)
        return render_step(self.scene, self.materials, self.lights,
                           self.camera, key, self.config)

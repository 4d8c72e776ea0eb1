"""Wavefront renderer over heterogeneous MultiTypeSet materials.

Counterpart of the reference's Hikari-integration renderer (reference:
docs/src/hikari-wavefront-renderer.jl): the same wavefront pipeline, but
materials live in a MultiTypeSet with distinct per-type schemas
(Matte / Mirror / Plastic / Glass) and shading dispatches per hit through
`with_index` — which here is `lax.switch` over the packed per-type tables,
so heterogeneous scenes stay a single traced program.

Triangle metadata encodes the SetKey: ``meta = type_idx * 2^24 + row_idx``
(the reference packs SetKeys into the per-face payload the same way its
MaterialScene does).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core.ray import Ray
from ..core.triangle import bary_interp
from ..core.sampling import reflect
from ..accel import dispatch as _disp
from ..accel.types import StaticTLAS
from ..collections.multitypeset import StaticMultiTypeSet, gather_row
from .wavefront import Camera, PointLights, RenderConfig, camera_basis, \
    generate_primary_rays, compact_order

KEY_SHIFT = 24
TYPE_MATTE, TYPE_MIRROR, TYPE_PLASTIC, TYPE_GLASS = 0, 1, 2, 3

MATERIAL_TYPES = ("matte", "mirror", "plastic", "glass")


def pack_key(type_idx: int, row_idx: int) -> int:
    return (type_idx << KEY_SHIFT) | row_idx


def unpack_key(meta):
    meta = meta.astype(jnp.int32)
    return meta >> KEY_SHIFT, meta & ((1 << KEY_SHIFT) - 1)


def default_material_set():
    """Build a MultiTypeSet with the four reference material archetypes
    (reference extract_material_props over Matte/Mirror/Plastic/Glass)."""
    from ..collections.multitypeset import MultiTypeSet
    s = MultiTypeSet()
    # Type order must match TYPE_* constants: push one default per type.
    s.push({"kd_r": 0.7, "kd_g": 0.7, "kd_b": 0.7, "sigma": 0.0}, "matte")
    s.push({"kr_r": 0.95, "kr_g": 0.95, "kr_b": 0.95}, "mirror")
    s.push({"kd_r": 0.6, "kd_g": 0.6, "kd_b": 0.6,
            "ks_r": 0.3, "ks_g": 0.3, "ks_b": 0.3, "rough": 0.1}, "plastic")
    s.push({"kt_r": 0.9, "kt_g": 0.9, "kt_b": 0.9, "eta": 1.5}, "glass")
    return s


def _shade_props(sset: StaticMultiTypeSet, type_idx, row_idx):
    """Per-hit material properties via lax.switch over type tables.
    Returns (diffuse_rgb, specular_rgb, reflectivity). Batched over rays:
    vmapped switch."""

    def matte(row):
        kd = jnp.stack([row["kd_r"], row["kd_g"], row["kd_b"]])
        return kd, jnp.zeros(3), jnp.float32(0.0)

    def mirror(row):
        kr = jnp.stack([row["kr_r"], row["kr_g"], row["kr_b"]])
        return jnp.zeros(3), kr, jnp.float32(1.0)

    def plastic(row):
        kd = jnp.stack([row["kd_r"], row["kd_g"], row["kd_b"]])
        ks = jnp.stack([row["ks_r"], row["ks_g"], row["ks_b"]])
        return kd, ks, jnp.float32(0.35)

    def glass(row):
        kt = jnp.stack([row["kt_r"], row["kt_g"], row["kt_b"]])
        return jnp.zeros(3), kt, jnp.float32(0.9)

    fns = (matte, mirror, plastic, glass)

    def one(ti, ri):
        branches = [
            (lambda tbl, fn: lambda: fn(gather_row(tbl, ri)))(tbl, fn)
            for tbl, fn in zip(sset.tables, fns)
        ]
        return jax.lax.switch(jnp.clip(ti, 0, len(branches) - 1), branches)

    return jax.vmap(one)(type_idx, row_idx)


@partial(jax.jit, static_argnames=("cfg",))
def render_step_mts(scene: StaticTLAS, sset: StaticMultiTypeSet,
                    lights: PointLights, cam: Camera, key,
                    cfg: RenderConfig):
    """One frame with per-hit lax.switch material dispatch."""
    H, W, spp = cfg.height, cfg.width, cfg.spp
    R = H * W * spp
    n_lights = lights.position.shape[0]
    bg = jnp.asarray(cfg.background, jnp.float32)

    rays = generate_primary_rays(cam, W, H, spp, key)
    res = _disp.scene_closest_hit(scene, rays, tile_size=cfg.tile_size)
    hit = res.hit
    tri = res.triangle
    p = bary_interp(res.barycentric, tri.vertices)
    n = bary_interp(res.barycentric, tri.normals)
    nl = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = jnp.where(nl > 1e-8, n / jnp.where(nl > 0, nl, 1.0), 0.0)
    n = jnp.where(jnp.sum(n * rays.d, -1, keepdims=True) > 0, -n, n)

    ti, ri = unpack_key(tri.metadata)
    kd, ks, refl = _shade_props(sset, ti, ri)

    # Shadow rays.
    to_l = lights.position[None] - p[:, None]
    dist = jnp.linalg.norm(to_l, axis=-1)
    wi = to_l / jnp.maximum(dist[..., None], 1e-12)
    so = (p + n * cfg.shadow_eps)[:, None, :].repeat(n_lights, 1).reshape(-1, 3)
    st = jnp.where(jnp.repeat(hit, n_lights),
                   (dist - 2 * cfg.shadow_eps).reshape(-1), -1.0)
    occ = _disp.scene_any_hit(scene, Ray.create(o=so, d=wi.reshape(-1, 3), t_max=st),
                        tile_size=cfg.tile_size).hit.reshape(R, n_lights)

    ndotl = jnp.maximum(jnp.sum(n[:, None] * wi, -1), 0.0)
    vis = jnp.where(occ, 0.0, 1.0)
    irr = lights.intensity[None] * (ndotl * vis
                                    / jnp.maximum(dist * dist, 1e-12))[..., None]
    direct = kd * (jnp.sum(irr, 1) + cfg.ambient)
    color = jnp.where(hit[:, None], direct, bg)

    # One specular bounce for reflective types (mirror/plastic/glass),
    # traced compacted.
    active = hit & (refl > 0.0)
    rd = reflect(-rays.d, n)
    rd = rd / jnp.maximum(jnp.linalg.norm(rd, -1, keepdims=True), 1e-12)
    order = compact_order(active)
    inv = jnp.argsort(order)
    rres = _disp.scene_closest_hit(
        scene, Ray.create(o=(p + n * cfg.reflect_eps)[order], d=rd[order],
                          t_max=jnp.where(active[order], jnp.inf, -1.0)),
        tile_size=cfg.tile_size)
    rres = jax.tree_util.tree_map(lambda a: a[inv], rres)
    r_tri = rres.triangle
    r_p = bary_interp(rres.barycentric, r_tri.vertices)
    r_n = bary_interp(rres.barycentric, r_tri.normals)
    rl = jnp.linalg.norm(r_n, -1, keepdims=True)
    r_n = jnp.where(rl > 1e-8, r_n / jnp.where(rl > 0, rl, 1.0), 0.0)
    r_ti, r_ri = unpack_key(r_tri.metadata)
    r_kd, _, _ = _shade_props(sset, r_ti, r_ri)
    r_to_l = lights.position[None] - r_p[:, None]
    r_d2 = jnp.sum(r_to_l * r_to_l, -1)
    r_wi = r_to_l / jnp.maximum(jnp.sqrt(r_d2)[..., None], 1e-12)
    r_nd = jnp.maximum(jnp.sum(r_n[:, None] * r_wi, -1), 0.0)
    r_col = r_kd * (jnp.sum(lights.intensity[None]
                            * (r_nd / jnp.maximum(r_d2, 1e-12))[..., None], 1)
                    + cfg.ambient)
    r_col = jnp.where(rres.hit[:, None], r_col, bg)

    color = jnp.where(active[:, None],
                      color * (1 - refl[:, None]) + ks * r_col * refl[:, None],
                      color)
    img = color.reshape(H, W, spp, 3).mean(2)
    return jnp.clip(img, 0.0, 1.0)

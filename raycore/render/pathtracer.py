"""Multi-bounce wavefront path tracer with ray compaction.

The BASELINE "full tutorial path tracer" configuration: N-bounce wavefront
over SoA queues with compaction between bounces, next-event estimation
(one shadow ray per bounce), diffuse/metallic materials with optional
textured albedo from the flat TexturePool, explicit PRNG keys.

Structure: one jit per frame; every bounce is
  trace -> shade/NEE -> sample BRDF -> compact (sort by alive mask)
and dead lanes cluster into tiles that retire immediately in the
underlying engines (the compaction the reference's dense queues lack,
SURVEY.md §2.6).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.ray import Ray
from ..core.triangle import bary_interp
from ..core.sampling import cosine_sample_hemisphere, reflect
from ..accel import dispatch as _disp
from ..collections.multitypeset import TexturePool, sample_nearest
from .wavefront import (Camera, Materials, PointLights, RenderConfig,
                        generate_primary_rays)


@struct.dataclass
class PTConfig:
    width: int = struct.field(pytree_node=False, default=256)
    height: int = struct.field(pytree_node=False, default=256)
    spp: int = struct.field(pytree_node=False, default=1)
    bounces: int = struct.field(pytree_node=False, default=4)
    tile_size: int = struct.field(pytree_node=False, default=2048)
    eps: float = struct.field(pytree_node=False, default=1e-3)
    background: tuple = struct.field(pytree_node=False,
                                     default=(0.03, 0.04, 0.07))
    compact: bool = struct.field(pytree_node=False, default=True)


def _shading_basis(n):
    """Orthonormal frame with n as +z (branch-free)."""
    s = jnp.where(n[:, 2:3] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2:3])
    b = n[:, 0:1] * n[:, 1:2] * a
    t1 = jnp.concatenate([1.0 + s * n[:, 0:1] ** 2 * a, s * b,
                          -s * n[:, 0:1]], axis=1)
    t2 = jnp.concatenate([b, s + n[:, 1:2] ** 2 * a, -n[:, 1:2]], axis=1)
    return t1, t2


def _albedo(materials: Materials, pool, tex_refs, mi, uv):
    base = jnp.take(materials.base_color, mi, axis=0)
    if pool is None or tex_refs is None:
        return base
    ref = jnp.take(tex_refs, mi, axis=0)
    texel = sample_nearest(pool, jnp.maximum(ref, 0), uv)[:, :3]
    return jnp.where((ref >= 0)[:, None], texel, base)


@partial(jax.jit, static_argnames=("cfg",))
def trace_paths(scene, materials: Materials, lights: PointLights,
                cam: Camera, key, cfg: PTConfig, pool: TexturePool = None,
                tex_refs=None):
    """One frame of N-bounce path tracing -> (H, W, 3)."""
    H, W, spp, B = cfg.height, cfg.width, cfg.spp, cfg.bounces
    R = H * W * spp
    bg = jnp.asarray(cfg.background, jnp.float32)
    n_lights = lights.position.shape[0]

    key, kp = jax.random.split(key)
    rays = generate_primary_rays(cam, W, H, spp, kp)
    o, d = rays.o, rays.d
    throughput = jnp.ones((R, 3), jnp.float32)
    radiance = jnp.zeros((R, 3), jnp.float32)
    alive = jnp.ones((R,), bool)
    order_acc = jnp.arange(R)      # composition of compaction permutations

    for bounce in range(B):
        key, k_l, k_b, k_r = jax.random.split(key, 4)
        # Per-path-deterministic randomness: draw in ORIGINAL path order and
        # permute by the carried compaction index, so results are identical
        # with and without compaction.
        perm = order_acc
        u_l = jax.random.randint(k_l, (R,), 0, n_lights)[perm]
        u_b = jax.random.uniform(k_b, (R, 3))[perm]
        u_r = jax.random.normal(k_r, (R, 3))[perm]
        res = _disp.scene_closest_hit(
            scene, Ray.create(o=o, d=d,
                              t_max=jnp.where(alive, jnp.inf, -1.0)),
            tile_size=cfg.tile_size)
        hit = res.hit & alive
        tri = res.triangle
        p = bary_interp(res.barycentric, tri.vertices)
        n = bary_interp(res.barycentric, tri.normals)
        ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
        n = jnp.where(ln > 1e-8, n / jnp.where(ln > 0, ln, 1.0), 0.0)
        n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)
        uv_hit = bary_interp(res.barycentric, tri.uv)

        # Escaped rays pick up the environment once.
        radiance = radiance + jnp.where((alive & ~res.hit)[:, None],
                                        throughput * bg, 0.0)

        mi = jnp.clip(tri.metadata.astype(jnp.int32), 0,
                      materials.base_color.shape[0] - 1)
        base = _albedo(materials, pool, tex_refs, mi, uv_hit)
        metal = jnp.take(materials.metallic, mi, axis=0)
        rough = jnp.take(materials.roughness, mi, axis=0)

        # Next-event estimation: one random light per path.
        li = u_l
        lp = jnp.take(lights.position, li, axis=0)
        lint = jnp.take(lights.intensity, li, axis=0)
        to_l = lp - p
        dist = jnp.linalg.norm(to_l, axis=-1)
        wi = to_l / jnp.maximum(dist[:, None], 1e-12)
        occ = _disp.scene_any_hit(
            scene, Ray.create(o=p + n * cfg.eps, d=wi,
                              t_max=jnp.where(hit, dist - 2 * cfg.eps, -1.0)),
            tile_size=cfg.tile_size).hit
        ndotl = jnp.maximum(jnp.sum(n * wi, -1), 0.0)
        # Diffuse lobe only for NEE (mirror handled by bounce).
        f_d = base / jnp.pi * (1.0 - metal)[:, None]
        contrib = f_d * lint * (ndotl * (~occ) * float(n_lights)
                                / jnp.maximum(dist ** 2, 1e-12))[:, None]
        radiance = radiance + jnp.where(hit[:, None],
                                        throughput * contrib, 0.0)

        if bounce == B - 1:
            break

        # BRDF sample: mirror with prob = metallic, else cosine diffuse.
        u = u_b
        pick_spec = u[:, 0] < metal
        t1, t2 = _shading_basis(n)
        local = cosine_sample_hemisphere(u[:, 1:3])
        d_diff = (t1 * local[:, 0:1] + t2 * local[:, 1:2] + n * local[:, 2:3])
        d_spec = reflect(-d, n)
        jitter = u_r * rough[:, None] * 0.25
        d_spec = d_spec + jitter
        d_spec = d_spec / jnp.maximum(
            jnp.linalg.norm(d_spec, -1, keepdims=True), 1e-12)
        new_d = jnp.where(pick_spec[:, None], d_spec, d_diff)
        # Throughput: diffuse cosine sampling cancels cos/pdf -> albedo;
        # mirror reflects with base tint.
        throughput = throughput * jnp.where(pick_spec[:, None], base, base)
        o = p + n * cfg.eps
        d = new_d
        alive = hit

        if cfg.compact:
            # Compact AND re-coherence: dead lanes last; live lanes grouped
            # by direction octant then origin Morton code, so the dense
            # engine's per-tile interval culling stays tight for secondary
            # bounces (incoherent tiles collapse its pruning).
            from ..accel.morton import morton_code_30bit
            lo_w = scene.root_aabb[0]
            ext_w = jnp.maximum(scene.root_aabb[1] - lo_w, 1e-12)
            code = morton_code_30bit(
                jnp.clip((o - lo_w) / ext_w, 0.0, 1.0))
            octant = ((d[:, 0] > 0).astype(jnp.uint32)
                      | ((d[:, 1] > 0).astype(jnp.uint32) << 1)
                      | ((d[:, 2] > 0).astype(jnp.uint32) << 2))
            key_sort = ((~alive).astype(jnp.uint32) << 31) \
                | (octant << 28) | (code >> 3)
            order = jnp.argsort(key_sort)
            o, d = o[order], d[order]
            throughput = throughput[order]
            radiance = radiance[order]
            alive = alive[order]
            order_acc = order_acc[order]

    # Undo the accumulated compaction permutation.
    inv = jnp.argsort(order_acc)
    radiance = radiance[inv]
    img = radiance.reshape(H, W, spp, 3).mean(axis=2)
    return jnp.clip(img, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Staged (host-orchestrated) driver
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def _pt_prep_nee(res_hit, res_bary, res_verts, res_norms, res_uv, res_meta,
                 d, alive, materials, lights, u_l, eps, pool, tex_refs):
    """After closest-hit: surface frame + NEE shadow-ray setup."""
    hit = res_hit & alive
    p = bary_interp(res_bary, res_verts)
    n = bary_interp(res_bary, res_norms)
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = jnp.where(ln > 1e-8, n / jnp.where(ln > 0, ln, 1.0), 0.0)
    n = jnp.where(jnp.sum(n * d, -1, keepdims=True) > 0, -n, n)
    uv_hit = bary_interp(res_bary, res_uv)
    mi = jnp.clip(res_meta.astype(jnp.int32), 0,
                  materials.base_color.shape[0] - 1)
    base = _albedo(materials, pool, tex_refs, mi, uv_hit)
    lp = jnp.take(lights.position, u_l, axis=0)
    to_l = lp - p
    dist = jnp.linalg.norm(to_l, axis=-1)
    wi = to_l / jnp.maximum(dist[:, None], 1e-12)
    so = p + n * eps
    st = jnp.where(hit, dist - 2 * eps, -1.0)
    return hit, p, n, base, mi, wi, dist, so, st


@partial(jax.jit, static_argnames=("n_lights", "last"))
def _pt_shade_and_sample(hit, res_hit, p, n, base, mi, wi, dist, occ_hit,
                         o, d, throughput, radiance, alive, order_acc,
                         materials, lights, u_l, u_b, u_r, root_aabb,
                         bg, eps, *, n_lights: int, last: bool):
    """NEE shading, BRDF sampling, and coherence-sorting compaction."""
    from ..accel.morton import morton_code_30bit
    radiance = radiance + jnp.where((alive & ~res_hit)[:, None],
                                    throughput * bg, 0.0)
    metal = jnp.take(materials.metallic, mi, axis=0)
    rough = jnp.take(materials.roughness, mi, axis=0)
    lint = jnp.take(lights.intensity, u_l, axis=0)
    ndotl = jnp.maximum(jnp.sum(n * wi, -1), 0.0)
    f_d = base / jnp.pi * (1.0 - metal)[:, None]
    contrib = f_d * lint * (ndotl * (~occ_hit) * float(n_lights)
                            / jnp.maximum(dist ** 2, 1e-12))[:, None]
    radiance = radiance + jnp.where(hit[:, None], throughput * contrib, 0.0)
    if last:
        return o, d, throughput, radiance, alive, order_acc

    pick_spec = u_b[:, 0] < metal
    t1, t2 = _shading_basis(n)
    local = cosine_sample_hemisphere(u_b[:, 1:3])
    d_diff = t1 * local[:, 0:1] + t2 * local[:, 1:2] + n * local[:, 2:3]
    d_spec = reflect(-d, n) + u_r * rough[:, None] * 0.25
    d_spec = d_spec / jnp.maximum(
        jnp.linalg.norm(d_spec, -1, keepdims=True), 1e-12)
    new_d = jnp.where(pick_spec[:, None], d_spec, d_diff)
    throughput = throughput * base
    o = p + n * eps
    d = new_d
    alive = hit

    lo_w = root_aabb[0]
    ext_w = jnp.maximum(root_aabb[1] - lo_w, 1e-12)
    code = morton_code_30bit(jnp.clip((o - lo_w) / ext_w, 0.0, 1.0))
    octant = ((d[:, 0] > 0).astype(jnp.uint32)
              | ((d[:, 1] > 0).astype(jnp.uint32) << 1)
              | ((d[:, 2] > 0).astype(jnp.uint32) << 2))
    key_sort = ((~alive).astype(jnp.uint32) << 31) | (octant << 28) \
        | (code >> 3)
    order = jnp.argsort(key_sort)
    return (o[order], d[order], throughput[order], radiance[order],
            alive[order], order_acc[order])


def trace_paths_staged(scene, materials: Materials, lights: PointLights,
                       cam: Camera, key, cfg: PTConfig,
                       pool: TexturePool = None, tex_refs=None,
                       pipelined: bool = False):
    """Host-orchestrated N-bounce path trace: jitted shading stages with
    engine queries BETWEEN them, so DenseScene queries use the worklist
    sweeps (exact per-tile work — no global-round amplification
    from escaping diffuse rays). Matches trace_paths bit-for-bit on the
    same key when both use the same engine.

    pipelined=True chains the whole frame's 2B queries through the
    deferred dispatch mode: every closest/occlusion query on a warm
    fused regroup path skips its per-query capacity host sync (the
    dependency between bounces is device-side — the next bounce's rays
    are functions of device arrays, never of host values), so the frame
    runs as back-to-back device dispatches with ONE validation sync at
    the end. If any capacity prediction missed, that query's output was
    truncated garbage, so the frame is discarded and re-run in the
    per-query sync mode (which also grows the sticky-max capacities, so
    misses do not repeat). Prewarm the scene first (rc.prewarm) —
    unwarmed engines run synchronously and the pipeline degrades to the
    plain staged driver."""
    return trace_paths_staged_batch(scene, materials, lights, cam, [key],
                                    cfg, pool=pool, tex_refs=tex_refs,
                                    pipelined=pipelined)[0]


def trace_paths_staged_batch(scene, materials: Materials,
                             lights: PointLights, cam: Camera, keys,
                             cfg: PTConfig, pool: TexturePool = None,
                             tex_refs=None, pipelined: bool = False):
    """Batched staged path trace: F independent frames (one PRNG key
    each) ride EVERY engine query as one concatenated F*R-ray batch ->
    (F, H, W, 3). Each frame samples the SAME paths as a solo
    trace_paths_staged call with its key (per-frame key chains; the
    per-bounce draws are indexed by original ray id, so the cross-frame
    compaction permutation never changes a ray's randoms) — outputs
    match to float ulp, the residual being XLA's different reduction
    fusion at the F*R shape (tests/test_pathtracer.py measures 9e-08).

    Why: the regrouped engine amortizes its per-query stages over bigger
    batches (on the H100, 4M-ray sharded queries ran at a higher per-ray
    rate than 1M-ray ones, PERF.md), so an animation or spp-accumulation
    driver should render frames in batches of 2-4 rather than one at a
    time. Composes with pipelined=True, which
    additionally chains the batch's 2B queries into back-to-back device
    dispatches with one validation sync per batch."""
    H, W, spp, B = cfg.height, cfg.width, cfg.spp, cfg.bounces
    R = H * W * spp
    F = len(keys)
    RT = F * R
    bg = jnp.asarray(cfg.background, jnp.float32)
    n_lights = lights.position.shape[0]

    def frame(deferred: bool):
        fin = []
        split = [jax.random.split(k) for k in keys]
        prim = [generate_primary_rays(cam, W, H, spp, kp)
                for _, kp in split]
        o = jnp.concatenate([r.o for r in prim])
        d = jnp.concatenate([r.d for r in prim])
        throughput = jnp.ones((RT, 3), jnp.float32)
        radiance = jnp.zeros((RT, 3), jnp.float32)
        alive = jnp.ones((RT,), bool)
        order_acc = jnp.arange(RT)
        fkeys = [fk for fk, _ in split]

        for bounce in range(B):
            kl, kb, kr = [], [], []
            for f in range(F):
                fkeys[f], k_l, k_b, k_r = jax.random.split(fkeys[f], 4)
                kl.append(jax.random.randint(k_l, (R,), 0, n_lights))
                kb.append(jax.random.uniform(k_b, (R, 3)))
                kr.append(jax.random.normal(k_r, (R, 3)))
            # Index the draws by ORIGINAL ray id (frame-major), then
            # apply the accumulated compaction permutation: ray i of
            # frame f sees the same randoms as in its solo frame no
            # matter where compaction moved it.
            perm = order_acc
            u_l = jnp.concatenate(kl)[perm]
            u_b = jnp.concatenate(kb)[perm]
            u_r = jnp.concatenate(kr)[perm]

            res = _disp.scene_closest_hit(
                scene, Ray.create(o=o, d=d,
                                  t_max=jnp.where(alive, jnp.inf, -1.0)),
                tile_size=cfg.tile_size, deferred=deferred)
            if deferred:
                res, f = res
                fin.append(f)
            hit, p, n, base, mi, wi, dist, so, st = _pt_prep_nee(
                res.hit, res.barycentric, res.triangle.vertices,
                res.triangle.normals, res.triangle.uv, res.triangle.metadata,
                d, alive, materials, lights, u_l, cfg.eps, pool, tex_refs)
            occ = _disp.scene_any_hit(scene,
                                      Ray.create(o=so, d=wi, t_max=st),
                                      tile_size=cfg.tile_size,
                                      deferred=deferred)
            if deferred:
                occ, f = occ
                fin.append(f)
            o, d, throughput, radiance, alive, order_acc = \
                _pt_shade_and_sample(
                    hit, res.hit, p, n, base, mi, wi, dist, occ.hit,
                    o, d, throughput, radiance, alive, order_acc,
                    materials, lights, u_l, u_b, u_r,
                    jnp.asarray(scene.root_aabb), bg, cfg.eps,
                    n_lights=n_lights, last=(bounce == B - 1))

        inv = jnp.argsort(order_acc)
        radiance = radiance[inv]
        img = radiance.reshape(F, H, W, spp, 3).mean(axis=3)
        return jnp.clip(img, 0.0, 1.0), fin

    if pipelined:
        img, fin = frame(deferred=True)
        # One sync for the whole batch: each finalizer blocks on its
        # query's totals (the device has long since moved on) and
        # reports whether the capacity prediction held.
        if all(f() is not None for f in fin if f is not None):
            return img
        # A prediction missed -> the unsynced batch is garbage. Re-run
        # per-query; the sync path auto-sizes and sticky-maxes the
        # missed capacities, so the next pipelined batch stays valid.
    img, _ = frame(deferred=False)
    return img

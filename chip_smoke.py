#!/usr/bin/env python
"""On-card smoke test of the ray-query path.

    python chip_smoke.py              # one GPU: phases 1-6
    python chip_smoke.py --cards 4    # four GPUs: the sharded phase only

Drives the user entry points (rc.build_dense, rc.TLAS().sync(),
rc.prewarm, rc.closest_hit, rc.any_hit, bake_instanced, the staged path
tracer) at the headline sizes: a 1M-triangle heightfield and 1,048,576
Morton-ordered primary rays. Every result is compared with the brute-force
oracle (or, for the instanced scene and the frame, with the plain engine)
on the spot. Each phase prints its timings and comparison; compile time
(the first call) is printed apart from run time (the repeat). The last
line of stdout is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

It exits non-zero, printing no JSON, if JAX finds no GPU or any phase
fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

import raycore as rc
from raycore.utils import workloads as wl

HEADLINE_TRIS = 1_000_000
HEADLINE_RAYS = 1 << 20
SMALL_RAYS = 1 << 16
SHARDED_RAYS = 1 << 22
SAMPLE = 4096
# Dense-engine exactness tolerance (tests/test_pallas_regroup.py::_check).
RTOL, ATOL, TIE_RTOL = 2e-5, 2e-6, 2e-6
# Share of frame pixels allowed beyond atol 1e-5 (edge-rounding path
# flips between the staged and the jitted engine; see phase_frame).
FRAME_MAX_OFF = 1e-3


class PhaseError(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def _ready(x):
    return jax.block_until_ready(x)


def timed(fn, *args, repeats: int = 2, **kw):
    """(result, first-call seconds incl. compile, best repeat seconds).
    A warm path may compile on its second call (capacity buckets learned
    from the first), so the repeat time is the best of ``repeats``."""
    t0 = time.perf_counter()
    out = _ready(fn(*args, **kw))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = _ready(fn(*args, **kw))
        best = min(best, time.perf_counter() - t0)
    return out, first, best


def _take(tree, idx):
    return jax.tree_util.tree_map(lambda a: jnp.take(a, idx, axis=0), tree)


def brute_reference(tris, rays, *, occlusion=False, chunk=64):
    """The brute-force oracle over every triangle, in ray chunks."""
    if occlusion:
        rays = rays.replace(t_min=jnp.zeros_like(rays.t_min))
    return rc.closest_hit_brute(tris, rays, ray_chunk=chunk)


def compare(label, ref, got, *, hit_only=False, rtol=RTOL, atol=ATOL):
    """Hit masks equal; t within tolerance; the same winning triangle
    except on exact-t ties (shared edges). Prints one line; raises on a
    violation."""
    hr, hg = np.asarray(ref.hit), np.asarray(got.hit)
    n_bad_hit = int((hr != hg).sum())
    line = (f"  {label}: {hr.size} rays, {int(hr.sum())} hits, "
            f"hit-mask mismatches {n_bad_hit}")
    ok = n_bad_hit == 0
    if not hit_only:
        both = hr & hg
        tr, tg = np.asarray(ref.t)[both], np.asarray(got.t)[both]
        excess = np.abs(tg - tr) - (atol + rtol * np.abs(tr))
        worst = float(excess.max()) if excess.size else -1.0
        vr = np.asarray(ref.triangle.vertices)[both]
        vg = np.asarray(got.triangle.vertices)[both]
        differ = ~np.all(vr == vg, axis=(1, 2))
        rel = np.abs(tg - tr) / np.maximum(np.abs(tr), 1e-6)
        ties = bool(np.all(rel[differ] < TIE_RTOL))
        line += (f", max |dt| over tolerance {worst:.3g}, "
                 f"winner differs on {int(differ.sum())} (all t-ties: "
                 f"{ties})")
        ok = ok and worst <= 0.0 and ties
    log(line + (" OK" if ok else " FAIL"))
    if not ok:
        raise PhaseError(label)


def phase_device(platform: str = "gpu") -> dict:
    dev = wl.device_record()
    if dev["platform"] != platform:
        raise PhaseError(f"JAX runs on {dev['platform']!r}, "
                         f"not {platform!r}")
    from raycore.utils.cache import cache_dir
    log(f"[device] {dev['card']}")
    log(f"  jax {jax.__version__}, {dev['count']} x {dev['kind']}, "
        f"compile cache {cache_dir()}")
    return dev


def phase_build(n_tris: int):
    mesh = wl.heightfield(n_tris)
    log(f"[build] heightfield, {mesh.vertices.shape[0]} triangles")

    def dense():
        return rc.build_dense(mesh)

    def tlas():
        mgr = rc.TLAS()
        mgr.push(mesh, None)
        return mgr.sync()

    scene, c, w = timed(dense)
    log(f"  DenseScene (cluster_size={scene.cluster_size}, "
        f"{scene.n_clusters} clusters): cold {c * 1e3:.1f} ms, "
        f"warm {w * 1e3:.1f} ms")
    static, c, w = timed(tlas)
    log(f"  StaticTLAS: cold {c * 1e3:.1f} ms, warm {w * 1e3:.1f} ms")
    return scene, static


def _sample(n: int, k: int, seed: int):
    k = min(k, n)
    return jnp.asarray(np.sort(np.random.default_rng(seed).choice(
        n, k, replace=False)).astype(np.int32))


def phase_closest(scene, static, n_big: int, n_small: int,
                  sample: int = SAMPLE):
    from raycore.ops.pallas_regroup import has_warm_capacity
    big = wl.primary_rays(n_big)
    small = wl.primary_rays(n_small)
    n_big, n_small = big.o.shape[0], small.o.shape[0]
    log(f"[closest] {n_big} and {n_small} Morton-ordered primary rays")
    t0 = time.perf_counter()
    rc.prewarm(scene, n_big)
    log(f"  rc.prewarm: {time.perf_counter() - t0:.1f} s")
    if not has_warm_capacity(scene, n_big, passes="auto"):
        raise PhaseError("prewarm left the regrouped route cold")
    idx = _sample(n_big, sample, 1)
    ref = brute_reference(scene.prims, _take(big, idx))
    for label, sc, rays, s_idx, s_ref in (
            ("DenseScene, warm regrouped route", scene, big, idx, ref),
            ("DenseScene, worklist route", scene, small,
             _sample(n_small, sample, 2), None),
            ("StaticTLAS traversal", static, big, idx, ref)):
        res, c, w = timed(rc.closest_hit, sc, rays)
        n = rays.o.shape[0]
        log(f"  {label}: first call {c:.2f} s, repeat {w * 1e3:.1f} ms "
            f"= {n / w / 1e6:.2f} Mrays/s")
        if s_ref is None:
            s_ref = brute_reference(scene.prims, _take(rays, s_idx))
        compare(label + " vs brute", s_ref, _take(res, s_idx))


def phase_any(scene, n_big: int, n_small: int, sample: int = SAMPLE):
    from raycore.ops.pallas_regroup import has_warm_capacity
    log("[any] secondary rays from the primary hits: random directions, "
        "t_max in [0.02, 0.2]")
    if not has_warm_capacity(scene, n_big, occlusion=True):
        raise PhaseError("prewarm left the regrouped occlusion route cold")
    for label, n, seed in (("worklist occlusion route", n_small, 3),
                           ("warm regrouped occlusion route", n_big, 4)):
        primary = wl.primary_rays(n)
        rays = wl.secondary_rays(primary, rc.closest_hit(scene, primary),
                                 seed=seed)
        res, c, w = timed(rc.any_hit, scene, rays)
        log(f"  {label} ({n} rays): first call {c:.2f} s, repeat "
            f"{w * 1e3:.1f} ms = {n / w / 1e6:.2f} Mrays/s")
        idx = _sample(n, sample, seed)
        ref = brute_reference(scene.prims, _take(rays, idx), occlusion=True)
        compare(label + " vs brute", ref, _take(res, idx), hit_only=True)


def instanced_manager(side: int = 16, seed: int = 0):
    """side x side non-overlapping spheres and boxes with random
    rotations and scales."""
    rng = np.random.default_rng(seed)
    mgr = rc.TLAS()
    sphere = rc.sphere_mesh(radius=1.0, n_theta=16, n_phi=32)
    box = rc.box_mesh()
    for i in range(side * side):
        th = rng.uniform(0, 2 * np.pi)
        c, s = np.cos(th), np.sin(th)
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) \
            * rng.uniform(0.25, 0.4)
        m[:, 3] = (i % side - side / 2 + 0.5, i // side - side / 2 + 0.5,
                   rng.uniform(-0.2, 0.2))
        mgr.push(sphere if i % 3 else box, m)
    return mgr


def phase_instanced(side: int, n_rays: int, sample: int = SAMPLE):
    from raycore.scene.bake import flatten_world_triangles
    from raycore.scene.instanced import bake_instanced
    mgr = instanced_manager(side)
    static = mgr.sync()
    (dis, c, w) = timed(bake_instanced, mgr)
    log(f"[instanced] {side * side} instances, "
        f"{dis.n_clusters} clusters: bake first {c:.2f} s, "
        f"repeat {w * 1e3:.1f} ms")
    # Primary rays over the instance field, slightly tilted.
    grid = wl.primary_rays(n_rays)
    o = grid.o * jnp.asarray([side / 2, side / 2, 1.0])
    d = jnp.broadcast_to(jnp.asarray([0.05, 0.03, -1.0], jnp.float32),
                         o.shape)
    rays = rc.Ray.create(o=o, d=d / jnp.linalg.norm(d, axis=-1,
                                                     keepdims=True))
    n = o.shape[0]
    got, c, w = timed(rc.closest_hit, dis, rays)
    log(f"  DenseInstancedScene ({n} rays): first call {c:.2f} s, "
        f"repeat {w * 1e3:.1f} ms")
    ref, c, w = timed(rc.closest_hit, static, rays)
    log(f"  StaticTLAS: first call {c:.2f} s, repeat {w * 1e3:.1f} ms")
    # Instance transforms are applied per ray: t agrees to the
    # instanced-engine tolerance of tests/test_instanced_engine.py.
    hit = np.asarray(ref.hit)
    tr, tg = np.asarray(ref.t)[hit], np.asarray(got.t)[hit]
    off = np.abs(tg - tr) > 2e-4 + 2e-4 * np.abs(tr)
    inst = float((np.asarray(ref.instance_idx)[hit]
                  == np.asarray(got.instance_idx)[hit]).mean())
    log(f"  {int(hit.sum())} hits; t beyond 2e-4 on {int(off.sum())} "
        f"(max |dt| {float(np.abs(tg - tr).max()):.3g}); instance "
        f"agreement {inst:.4f}")
    # The brute oracle over the world-space soup names the culprit of
    # any disagreement.
    soup, _ = flatten_world_triangles(mgr)
    idx = _sample(n, sample, 6)
    brute = brute_reference(soup, _take(rays, idx))
    compare("StaticTLAS vs brute", brute, _take(ref, idx), hit_only=True)
    compare("DenseInstancedScene vs brute", brute, _take(got, idx),
            hit_only=True)
    compare("DenseInstancedScene vs StaticTLAS", ref, got, hit_only=True)
    if off.any() or inst <= 0.98 or not hit.any():
        raise PhaseError("instanced")


def phase_frame(width: int, height: int, bounces: int):
    from raycore.render.pathtracer import (PTConfig, trace_paths,
                                           trace_paths_staged)
    from raycore.render.scenes import example_manager
    mgr, mats, lights, cam = example_manager()
    scene = rc.bake_dense(mgr)
    cfg = PTConfig(width=width, height=height, spp=1, bounces=bounces)
    key = jax.random.PRNGKey(5)
    staged, c, w = timed(trace_paths_staged, scene, mats, lights, cam, key,
                         cfg)
    log(f"[frame] {width}x{height}, {bounces} bounces, staged: first call "
        f"{c:.2f} s, repeat {w:.3f} s")
    jitted, c, w = timed(trace_paths, scene, mats, lights, cam, key, cfg)
    log(f"  jitted trace_paths: first call {c:.2f} s, repeat {w:.3f} s")
    # Both engines accept hits under the same EDGE_EPS slack but round
    # differently, so a ray within rounding of a triangle edge may take
    # another path in the two frames (seen on a few pixels from 160x160
    # up, also on the CPU). The frame matches when the pixels beyond
    # atol stay that rare and the mean difference stays at rounding.
    a, b = np.asarray(staged), np.asarray(jitted)
    diff = np.abs(a - b).max(axis=-1)
    frac = float((diff > 1e-5).mean())
    ok = bool(np.isfinite(a).all()) and frac <= FRAME_MAX_OFF \
        and float(diff.mean()) <= 1e-5
    log(f"  finite {bool(np.isfinite(a).all())}, pixels beyond atol 1e-5: "
        f"{int((diff > 1e-5).sum())} of {diff.size} ({frac:.2e}, limit "
        f"{FRAME_MAX_OFF:g}), mean |staged - jitted| {diff.mean():.3g}, "
        f"max {diff.max():.3g}{' OK' if ok else ' FAIL'}")
    if not ok:
        raise PhaseError("frame")


def phase_sharded(scene, static, n_rays: int, n_cards: int):
    from raycore.parallel import sharding as sh
    devices = jax.devices()[:n_cards]
    if len(devices) < n_cards:
        raise PhaseError(f"need {n_cards} devices, have {len(devices)}")
    mesh_n, mesh_1 = sh.make_mesh(devices), sh.make_mesh(devices[:1])
    rays = wl.primary_rays(n_rays)
    n = rays.o.shape[0]
    log(f"[sharded] {n} rays over {n_cards} cards vs one card")
    for label, fn, sc in (
            ("distributed_closest_hit_dense",
             lambda sc, m: sh.distributed_closest_hit_dense(sc, rays, m),
             scene),
            ("distributed_illumination",
             lambda sc, m: sh.distributed_illumination(
                 sc, rays, m, n_bins=64), static)):
        many, c, w = timed(fn, sc, mesh_n)
        log(f"  {label}, {n_cards} cards: first call {c:.2f} s, repeat "
            f"{w * 1e3:.1f} ms = {n / w / 1e6:.2f} Mrays/s")
        one, c1, w1 = timed(fn, sc, mesh_1)
        log(f"  {label}, 1 card: first call {c1:.2f} s, repeat "
            f"{w1 * 1e3:.1f} ms = {n / w1 / 1e6:.2f} Mrays/s")
        t_many = many.t if hasattr(many, "t") else many[0]
        spread = sorted(s.device.id for s in t_many.addressable_shards
                        if s.data.size)
        log(f"  {label}: result shards on devices {spread}")
        if len(set(spread)) != n_cards:
            raise PhaseError(f"{label}: result not spread over the mesh")
        if hasattr(many, "hit"):
            compare(label + ", n cards vs 1", one, many)
        else:
            t_a, h_a = (np.asarray(x) for x in one)
            t_b, h_b = (np.asarray(x) for x in many)
            ok = np.array_equal(h_a, h_b) and np.allclose(
                t_a, t_b, rtol=RTOL, atol=ATOL)
            log(f"  {label}: histogram equal {np.array_equal(h_a, h_b)}, "
                f"t equal within tolerance "
                f"{np.allclose(t_a, t_b, rtol=RTOL, atol=ATOL)}"
                f"{' OK' if ok else ' FAIL'}")
            if not ok:
                raise PhaseError(label)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="4: run only the sharded phase on four cards")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        dev = phase_device()
        scene, static = phase_build(HEADLINE_TRIS)
        if args.cards > 1:
            phase_sharded(scene, static, SHARDED_RAYS, args.cards)
        else:
            phase_closest(scene, static, HEADLINE_RAYS, SMALL_RAYS)
            phase_any(scene, HEADLINE_RAYS, SMALL_RAYS)
            phase_instanced(16, SMALL_RAYS)
            phase_frame(1024, 1024, 4)
    except Exception as e:      # any phase failing fails the smoke test
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(dev["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Closest-hit throughput on the headline configuration, one process.

    python bench.py

Headline (BASELINE.md): closest_hit with 1,048,576 coherent primary rays
(Morton pixel order) against a 1M-triangle heightfield, through
rc.closest_hit after rc.prewarm. The reference (Raycore.jl on an RX 7900
XTX) reaches ~90 Mrays/s at 1M tris / 1M rays
(`benchmarks/implicitbvh_comparison.md:38`).

Prints ONE JSON line (the last line on stdout) with the metric, the build
times, and the device it ran on (platform, device_kind, count, and the
card's name and power limit). Exits non-zero on any error. It refuses to
run on anything but a GPU, unless JAX_PLATFORMS=cpu is set explicitly for
a rehearsal at small sizes.

Knobs (env): RAYCORE_BENCH_TRIS (1000000), RAYCORE_BENCH_RAYS (1048576),
RAYCORE_BENCH_REPS (5), RAYCORE_BENCH_CLUSTER (256),
RAYCORE_BENCH_SCENE (heightfield | blobby), RAYCORE_BENCH_ENGINE:
  auto      rc.closest_hit on a DenseScene after rc.prewarm (default)
  worklist  the tile worklist sweep (closest_hit_dense_pallas_auto)
  dense     the XLA rounds engine (rc.closest_hit_dense)
  traversal rc.closest_hit on a StaticTLAS
"""
import json
import os
import sys
import time

METRIC = "closest_hit_primary_mrays_per_s"
BASELINE_MRAYS = 90.0  # RX 7900 XTX, 1M tris / 1M rays (BASELINE.md)


def main() -> int:
    import jax
    import numpy as np
    import raycore as rc
    from raycore.utils import workloads as wl

    dev = wl.device_record()
    rehearsal = os.environ.get("JAX_PLATFORMS", "") == "cpu"
    if dev["platform"] != "gpu" and not (rehearsal
                                         and dev["platform"] == "cpu"):
        print(f"bench.py: needs a GPU, JAX runs on {dev['platform']!r} "
              f"(set JAX_PLATFORMS=cpu for a CPU rehearsal)",
              file=sys.stderr)
        return 2
    env = os.environ.get
    n_tris = int(env("RAYCORE_BENCH_TRIS", 1_000_000))
    n_rays = int(env("RAYCORE_BENCH_RAYS", 1 << 20))
    reps = int(env("RAYCORE_BENCH_REPS", 5))
    cluster = int(env("RAYCORE_BENCH_CLUSTER", 256))
    scene_kind = env("RAYCORE_BENCH_SCENE", "heightfield")
    engine = env("RAYCORE_BENCH_ENGINE", "auto")

    mesh = wl.blobby(n_tris) if scene_kind == "blobby" \
        else wl.heightfield(n_tris)

    def build():
        if engine == "traversal":
            mgr = rc.TLAS()
            mgr.push(mesh, None)
            return jax.block_until_ready(mgr.sync())
        return jax.block_until_ready(rc.build_dense(mesh,
                                                    cluster_size=cluster))

    t0 = time.perf_counter()
    scene = build()
    build_cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    scene = build()
    build_ms = (time.perf_counter() - t0) * 1e3

    rays = wl.primary_rays(n_rays)
    n_rays = rays.o.shape[0]
    if engine == "auto":
        prewarm_s = rc.prewarm(scene, n_rays)
        run = lambda: rc.closest_hit(scene, rays)
    elif engine == "worklist":
        from raycore.ops.pallas_dense import closest_hit_dense_pallas_auto
        prewarm_s = 0.0
        run = lambda: closest_hit_dense_pallas_auto(scene, rays)
    elif engine == "dense":
        prewarm_s = 0.0
        run = lambda: rc.closest_hit_dense(scene, rays)
    elif engine == "traversal":
        prewarm_s = 0.0
        run = lambda: rc.closest_hit(scene, rays)
    else:
        raise ValueError(f"unknown RAYCORE_BENCH_ENGINE {engine!r}")

    t0 = time.perf_counter()
    res = jax.block_until_ready(run())
    first_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(run())
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    value = n_rays / best / 1e6
    print(json.dumps({
        "metric": METRIC, "value": value, "unit": "Mrays/s",
        "vs_baseline": value / BASELINE_MRAYS,
        "engine": engine, "scene": scene_kind,
        "n_tris": int(mesh.vertices.shape[0]), "n_rays": int(n_rays),
        "rep_ms": [t * 1e3 for t in ts], "first_call_s": first_s,
        "prewarm_s": prewarm_s, "build_ms_warm": build_ms,
        "build_ms_cold": build_cold_ms,
        "hit_frac": float(np.asarray(res.hit).mean()),
        "device": dev,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

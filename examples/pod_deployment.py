"""Multi-GPU deployment config: mesh axes, per-shard capacity hints, and
the sharded production query path (docs/deployment.md).

  1. ONE mesh over all cards, ray axis only. Rays are embarrassingly
     parallel and the scene is replicated, so there is no model axis and
     no hot-path collective — the sharded regroup engine's only
     cross-device op is a pmax of worklist totals (capacity validation),
     and analysis reductions (histograms) all-reduce at the very end.
  2. Per-shard capacity hints: the regroup engine auto-sizes its
     worklist capacity per LOCAL shard (rays/device), so the capacity
     prewarm must run at the DEPLOYMENT shard shape — capacities learned
     at a different rays/device do not transfer. The sizing pass below is
     that prewarm; the learned (scene, shape, mesh) capacities are
     remembered process-locally (parallel.sharding._DIST_CAPS).
  3. Run this once at the sizing shape, then at the serving shape: both
     compiles land in the persistent JAX cache, so serving processes
     start warm.

Run on real cards or locally on a virtual mesh:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python examples/pod_deployment.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import jax.numpy as jnp
import numpy as np

import raycore as rc
from raycore.accel.dense import build_dense
from raycore.parallel import sharding as sh


def ray_grid(scene, n_rays):
    lo = np.asarray(scene.root_aabb[0])
    hi = np.asarray(scene.root_aabb[1])
    side = max(int(np.sqrt(n_rays)), 1)
    xs = np.linspace(lo[0] + 1e-3, hi[0] - 1e-3, side, dtype=np.float32)
    o = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    o = np.concatenate([o, np.full((o.shape[0], 1), hi[2] + 1.0,
                                   np.float32)], 1)
    reps = -(-n_rays // o.shape[0])
    o = np.tile(o, (reps, 1))[:n_rays]
    d = np.tile(np.array([0, 0, -1], np.float32), (o.shape[0], 1))
    return rc.Ray.create(o=jnp.asarray(o), d=jnp.asarray(d))


def main():
    devs = jax.devices()
    n_dev = len(devs)
    # Mesh axes: one flat ray axis over every chip of the slice. On a
    # multi-host pod the SAME construction applies (jax.devices() spans
    # hosts under jax.distributed); there is no reason to split host and
    # chip into separate axes because nothing here communicates along a
    # second dimension — the scene is replicated and rays never talk.
    mesh = sh.make_mesh(devs)
    print(f"mesh: {n_dev} x {devs[0].platform} along axis "
          f"'{sh.RAY_AXIS}'", flush=True)

    on_cpu = devs[0].platform == "cpu"
    n = int(os.environ.get("POD_MESH_N", 64 if on_cpu else 160))
    mesh_geo = rc.displaced_grid_mesh(n=n, extent=2.0, amplitude=0.35)
    scene = build_dense(mesh_geo, cluster_size=128)
    print(f"scene: {mesh_geo.vertices.shape[0]} tris, "
          f"K={scene.n_clusters} clusters, replicated to {n_dev} chips",
          flush=True)

    # --- per-shard capacity sizing pass (the deployment prewarm) -----
    # Rays/chip at serving shape; the TINY pass must use the same
    # per-shard TILE so the capacity key matches, but fewer rays would
    # change rays/chip — so size AT the serving shard shape, once.
    n_rays = int(os.environ.get("POD_RAYS",
                                1 << 14 if on_cpu else 1 << 17))
    rays = ray_grid(scene, n_rays)
    t0 = time.time()
    res = sh.distributed_closest_hit_dense(scene, rays, mesh)
    jax.block_until_ready(res.hit)
    print(f"sizing pass: {time.time() - t0:.2f} s "
          f"(compiles + learns per-shard capacities)", flush=True)
    from raycore.parallel.sharding import _DIST_CAPS
    for ck, ent in _DIST_CAPS.items():
        print(f"  capacity hint: R={ck[2]} shards={ck[3]} TILE={ck[4]} "
              f"-> coarse={ent['coarse']} pairs/shard")

    # --- serving-shape repeat: warm path, no capacity growth ---------
    t0 = time.time()
    res = sh.distributed_closest_hit_dense(scene, rays, mesh)
    hit_frac = float(jnp.mean(res.hit.astype(jnp.float32)))
    dt = time.time() - t0
    print(f"warm sharded query: {n_rays} rays on {n_dev} chips in "
          f"{dt * 1e3:.1f} ms ({n_rays / dt / 1e6:.2f} Mrays/s aggregate"
          f"), hit_frac={hit_frac:.3f}")

    # --- analysis reduction: all-reduced illumination histogram -----
    tlas = rc.TLAS()
    tlas.push(mesh_geo)
    static = tlas.sync()
    n_bins = 64
    t, hist = sh.distributed_illumination(static, rays, mesh, n_bins,
                                          tile_size=4096)
    jax.block_until_ready(hist)
    print(f"illumination all-reduce: {int(jnp.sum(hist))} hits into "
          f"{n_bins} bins (replicated output => XLA inserted the "
          f"cross-chip psum)")
    assert hit_frac > 0.99, hit_frac
    print("POD-DEPLOYMENT-OK")


if __name__ == "__main__":
    main()

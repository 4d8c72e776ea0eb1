"""Refit-vs-rebuild timing for animated scenes.

Port of the reference's wavefront_dynamic.jl experiment: per frame either
(a) update instance transforms + sync (refit path) or (b) push/delete
geometry + sync (rebuild path), and report the cost of each, plus a trace
to confirm correctness after every commit.
Run: `python examples/dynamic_refit.py [n_instances]`.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax



def main(n_instances=128, n_frames=6):
    import raycore as rc

    rng = np.random.default_rng(0)
    mgr = rc.TLAS()
    base = np.tile(np.eye(3, 4, dtype=np.float32), (n_instances, 1, 1))
    base[:, :, 3] = rng.uniform(-5, 5, (n_instances, 3))
    handle = mgr.push(rc.sphere_mesh(radius=0.3, n_theta=8, n_phi=16),
                      transforms=list(base))
    scene = mgr.sync()
    jax.block_until_ready(scene.unified_nodes)
    print(f"{n_instances} instances, {scene.unified_nodes.shape[0]} nodes")

    # Refit path: transforms only.
    refit_times = []
    for frame in range(n_frames):
        base[:, 0, 3] += 0.1
        t0 = time.time()
        mgr.update_transforms(handle, list(base))
        scene = mgr.sync()
        jax.block_until_ready(scene.unified_nodes)
        refit_times.append(time.time() - t0)
    print(f"refit  sync: best {min(refit_times)*1e3:.1f} ms "
          f"(transforms only — no BLAS rebuild, same buffer shapes)")

    # Rebuild path: structural change every frame.
    rebuild_times = []
    extra = None
    for frame in range(n_frames):
        t0 = time.time()
        if extra is not None:
            mgr.delete(extra)
        extra = mgr.push(rc.box_mesh(), None)
        scene = mgr.sync()
        jax.block_until_ready(scene.unified_nodes)
        rebuild_times.append(time.time() - t0)
    print(f"rebuild sync: best {min(rebuild_times)*1e3:.1f} ms "
          f"(instance set changed — flat arrays re-concatenated)")

    r = rc.closest_hit(scene, rc.Ray.create(
        o=[float(base[0, 0, 3]), float(base[0, 1, 3]),
           float(base[0, 2, 3]) - 4.0], d=[0.0, 0, 1.0]), tile_size=64)
    print("post-churn trace hit:", bool(r.hit))


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    main(n)

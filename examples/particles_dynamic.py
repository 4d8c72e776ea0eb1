"""Dynamic instanced-particles example.

Port of the reference's wavefront_particles.jl workload: one low-poly
sphere BLAS, thousands of instances from a single multi-transform handle,
per-frame `update_transforms` + `sync` (refit path, no rebuild), then a
frame render. Run: `python examples/particles_dynamic.py [n_particles]`.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax



def main(n_particles=512, n_frames=8):
    import raycore as rc
    from raycore.render.scenes import particle_scene
    from raycore.render.debug_viz import scene_preview, save_ppm

    mgr, handle, pos = particle_scene(n_particles)
    vel = np.random.default_rng(1).normal(0, 0.5, pos.shape).astype(np.float32)

    scene = mgr.sync()
    print(f"{n_particles} particles, unified nodes {scene.unified_nodes.shape}")

    for frame in range(n_frames):
        t0 = time.time()
        pos += vel * 0.05
        # Bounce off the [-4, 4] box.
        out = np.abs(pos) > 4
        vel[out] *= -1
        transforms = np.tile(np.eye(3, 4, dtype=np.float32),
                             (n_particles, 1, 1))
        transforms[:, :, :3] *= 0.08
        transforms[:, :, 3] = pos
        mgr.update_transforms(handle, list(transforms))
        scene = mgr.sync()            # transforms-only => refit
        jax.block_until_ready(scene.unified_nodes)
        t_sync = time.time() - t0

        t0 = time.time()
        hits = rc.closest_hit(
            scene, rc.Ray.create(
                o=np.stack([pos[:, 0], pos[:, 1],
                            np.full(n_particles, -6.0, np.float32)], -1),
                d=np.tile(np.array([0, 0, 1.0], np.float32),
                          (n_particles, 1))),
            tile_size=4096)
        jax.block_until_ready(hits.t)
        t_trace = time.time() - t0
        print(f"frame {frame}: sync {t_sync*1e3:.1f} ms, "
              f"trace {t_trace*1e3:.1f} ms, "
              f"hits {int(np.asarray(hits.hit).sum())}/{n_particles}")

    img = scene_preview(scene, width=320, height=240)
    out = os.path.join(os.path.dirname(__file__), "particles.ppm")
    save_ppm(img, out)
    print("wrote", out)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    main(n)

"""Flagship render demo: the example room scene through the wavefront
renderer (reference: docs/src/wavefront-renderer.jl demo configs).
Writes examples/room.png. Run: `python examples/render_room.py [W H SPP]`.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
    jax.config.update("jax_platforms", "cpu")


def main(width=640, height=480, spp=2):
    from raycore.render.scenes import example_scene
    from raycore.render.wavefront import WavefrontRenderer, RenderConfig
    from raycore.render.debug_viz import save_png

    scene, materials, lights, camera = example_scene()
    r = WavefrontRenderer(scene, materials, lights, camera,
                          RenderConfig(width=width, height=height, spp=spp))
    t0 = time.time()
    img = r.render(jax.random.PRNGKey(0))
    jax.block_until_ready(img)
    print(f"first frame (compile+run): {time.time()-t0:.1f}s")
    t0 = time.time()
    img = r.render(jax.random.PRNGKey(1))
    jax.block_until_ready(img)
    dt = time.time() - t0
    rays = width * height * spp * (2 + lights.position.shape[0])
    print(f"steady frame: {dt*1e3:.1f} ms (~{rays/dt/1e6:.1f} Mrays/s "
          f"incl. shadow+reflection)")
    out = os.path.join(os.path.dirname(__file__), "room.png")
    save_png(img, out)
    print("wrote", out)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:4]]
    main(*args)

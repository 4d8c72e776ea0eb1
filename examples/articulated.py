"""Articulated figure with hierarchical transforms.

Port of the reference's wavefront_lego.jl workload shape: a multi-part
figure (torso, head, two arms, two legs) where each part is its own BLAS
instance and limb transforms compose hierarchically from the body frame;
per-frame joint angles drive `update_transform` + refit sync.
Run: `python examples/articulated.py`.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax



def rot_y(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def affine(R=None, t=(0, 0, 0)):
    m = np.eye(3, 4, dtype=np.float32)
    if R is not None:
        m[:, :3] = R
    m[:, 3] = t
    return m


def compose(a, b):
    """a ∘ b for row-major 3x4 affines."""
    out = np.empty((3, 4), np.float32)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out


def main(n_frames=12):
    import raycore as rc

    mgr = rc.TLAS()
    torso = rc.box_mesh(p_min=(-0.4, -0.25, 0.0), p_max=(0.4, 0.25, 1.0))
    head = rc.sphere_mesh(center=(0, 0, 0), radius=0.3, n_theta=10, n_phi=20)
    limb = rc.box_mesh(p_min=(-0.12, -0.12, -0.7), p_max=(0.12, 0.12, 0.0))

    h_torso = mgr.push(torso, affine(t=(0, 0, 1.0)))
    h_head = mgr.push(head, affine(t=(0, 0, 2.3)))
    h_arm_l = mgr.push(limb, affine(t=(-0.55, 0, 1.9)))
    h_arm_r = mgr.push(limb, affine(t=(0.55, 0, 1.9)))
    h_leg_l = mgr.push(limb, affine(t=(-0.25, 0, 1.0)))
    h_leg_r = mgr.push(limb, affine(t=(0.25, 0, 1.0)))
    mgr.sync()

    body_frame = affine(t=(0, 0, 1.0))
    for frame in range(n_frames):
        t0 = time.time()
        phase = frame * 0.5
        swing = 0.7 * np.sin(phase)
        # Hierarchy: limbs compose from the (possibly moving) body frame.
        body = compose(affine(t=(0.05 * np.sin(phase), 0, 0)), body_frame)
        mgr.update_transform(h_torso, body)
        mgr.update_transform(h_head, compose(body, affine(t=(0, 0, 1.3))))
        mgr.update_transform(h_arm_l, compose(
            body, compose(affine(t=(-0.55, 0, 0.9)), affine(rot_y(swing)))))
        mgr.update_transform(h_arm_r, compose(
            body, compose(affine(t=(0.55, 0, 0.9)), affine(rot_y(-swing)))))
        mgr.update_transform(h_leg_l, compose(
            body, compose(affine(t=(-0.25, 0, 0.0)), affine(rot_y(-swing)))))
        mgr.update_transform(h_leg_r, compose(
            body, compose(affine(t=(0.25, 0, 0.0)), affine(rot_y(swing)))))
        scene = mgr.sync()
        jax.block_until_ready(scene.unified_nodes)
        # Probe: a ray at the left arm's swung tip should track the swing.
        tip_x = -0.55 + 0.7 * np.sin(swing) * 0.0 - np.sin(swing) * 0.7
        r = rc.closest_hit(scene, rc.Ray.create(
            o=[float(tip_x), -3.0, 1.4], d=[0.0, 1.0, 0.0]), tile_size=64)
        print(f"frame {frame}: sync+trace {(time.time()-t0)*1e3:.1f} ms, "
              f"arm probe hit={bool(r.hit)}")


if __name__ == "__main__":
    main()

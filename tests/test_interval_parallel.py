"""Regression: clamped-invdir slab tests must not evict near-parallel rays.

Found at 1M scale (C=64 bench, hit_frac 0.9999): a ray with d=(0,0,-1)
whose origin sits inside a cluster's y-slab within ~3e-5 of the face gets
a false slab exit at (bmax_y - o_y)*1e5 < entry_z — the conservative
interval tests then DROP a truly hit cluster. All three bundle interval
tests (dense phase A, Pallas phase A, regroup refine) must widen an axis
to (-inf, inf) when the bundle may contain a parallel ray inside that
slab.
"""
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp

from raycore.accel.dense import _phase_a_tile_entry
from raycore.core.triangle import safe_invdir
from raycore.ops.pallas_dense import phase_a_entry
from raycore.ops.pallas_regroup import refine_pairs, subgroup_stats

O = np.array([0.3, 0.7 - 1e-6, 3.0], np.float32)   # 1e-6 inside the y face
D = np.array([0.0, 0.0, -1.0], np.float32)
BMIN = np.array([-1.0, -1.0, -1.0], np.float32)
BMAX = np.array([1.0, 0.7, 0.0], np.float32)       # y face at 0.7


def _rays(n=8):
    o = jnp.broadcast_to(jnp.asarray(O), (n, 3))
    d = jnp.broadcast_to(jnp.asarray(D), (n, 3))
    t_min = jnp.zeros((n,), jnp.float32)
    t_max = jnp.full((n,), jnp.inf, jnp.float32)
    return o, d, t_min, t_max


def _scene():
    return SimpleNamespace(cluster_min=jnp.asarray(BMIN)[None, :],
                           cluster_max=jnp.asarray(BMAX)[None, :],
                           n_clusters=1)


def test_dense_phase_a_keeps_parallel_inside_ray():
    o, d, t_min, t_max = _rays()
    entry = _phase_a_tile_entry(_scene(), o, d, safe_invdir(d), t_min,
                                t_max, n_tiles=1, tile=8)
    assert np.isfinite(float(entry[0, 0]))
    assert abs(float(entry[0, 0]) - 3.0) < 1e-3      # true entry t = 3


def test_pallas_phase_a_keeps_parallel_inside_ray():
    o, d, t_min, t_max = _rays()
    entry = phase_a_entry(_scene(), o, d, t_min, t_max, 1, 8)
    assert np.isfinite(float(entry[0, 0]))


def test_refine_keeps_parallel_inside_ray():
    o, d, t_min, t_max = _rays(32)
    stats = subgroup_stats(o, d, t_min, t_max, 32)
    fine = refine_pairs(stats, jnp.array([0], jnp.int32),
                        jnp.array([0], jnp.int32),
                        _scene().cluster_min, _scene().cluster_max,
                        SPT=1, n_tiles=1)
    assert np.isfinite(float(fine[0, 0]))


def test_outside_parallel_ray_still_pruned():
    # Origin OUTSIDE the y slab with d_y = 0: the cluster is unreachable
    # and must still be pruned (the widening only applies when origins
    # overlap the slab).
    o, d, t_min, t_max = _rays()
    o = o.at[:, 1].set(0.7 + 1e-3)
    entry = _phase_a_tile_entry(_scene(), o, d, safe_invdir(d), t_min,
                                t_max, n_tiles=1, tile=8)
    assert not np.isfinite(float(entry[0, 0]))

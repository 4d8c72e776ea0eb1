#!/usr/bin/env python
"""Rows per program, column chunk and warps of the sweep kernels, timed
alone on one GPU at the chip_smoke shapes.

    PYTHONPATH=. python tools/tune_sweep.py

Builds the real inputs once — the cluster-major blocks of the 1M-ray
headline query (1M-triangle heightfield, cluster_size 256, G=32, SPB=16)
and the tile worklist of the 64K-ray query — then times
``sweep.sweep_regrouped`` and ``sweep.sweep_tiles`` for each
(ROWS_PER_PROGRAM, COLS_PER_CHUNK, NUM_WARPS), checking each result
against the first. Prints one JSON line per configuration and the card.
"""
import itertools
import json
import statistics
import time

import jax
import jax.numpy as jnp

import raycore as rc
from raycore.ops import pallas_dense, pallas_regroup, sweep
from raycore.utils import workloads as wl


def median_ms(fn, reps=10):
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def regroup_inputs(scene, rays, TILE=2048, G=32, SPB=16):
    R = rays.o.shape[0]
    n_tiles = R // TILE
    hard = n_tiles * scene.n_clusters
    P_cap = min(48 * n_tiles, hard)
    while True:
        cid, subs, tbl, total, coarse = pallas_regroup._stage1(
            scene, rays.o, rays.d, rays.t_min, rays.t_max, TILE=TILE, G=G,
            SPB=SPB, P_cap=P_cap)
        if int(coarse) <= P_cap:
            return cid, subs, tbl, int(total)
        P_cap = min(2 * P_cap, hard)


def tile_inputs(scene, rays, TILE=512):
    R = rays.o.shape[0]
    entry = pallas_dense.phase_a_entry(scene, rays.o, rays.d, rays.t_min,
                                       rays.t_max, R // TILE, TILE)
    tids, cids, total = pallas_dense.build_worklist(
        entry, (R // TILE) * scene.n_clusters)
    tbl = pallas_dense._ray_table(rays.o, rays.d, rays.t_min, rays.t_max)
    return tids, cids, tbl, int(total)


def main():
    dev = wl.device_record()
    if dev["platform"] != "gpu":
        raise SystemExit(f"needs a GPU; JAX runs on {dev['platform']}")
    print(dev["card"], flush=True)
    scene = rc.build_dense(wl.heightfield(1_000_000))
    C = scene.cluster_size
    cid, subs, tbl, nb = regroup_inputs(scene, wl.primary_rays(1 << 20))
    small = wl.primary_rays(1 << 16)
    tids, cids, ttbl, npairs = tile_inputs(scene, small)
    R = ttbl.shape[0]
    key0 = jnp.full((R,), sweep.INT32_MAX, jnp.int32)
    pair0 = jnp.full((R,), -1, jnp.int32)
    print(json.dumps({"regroup_blocks": nb, "tile_pairs": npairs}),
          flush=True)
    ref = None
    for rb, cc, warps in itertools.product((32, 64, 128), (16, 32, 64),
                                           (4, 8)):
        sweep.ROWS_PER_PROGRAM, sweep.COLS_PER_CHUNK = rb, cc
        sweep.NUM_WARPS = warps
        jax.clear_caches()
        regroup = lambda: sweep.sweep_regrouped(
            subs, cid, tbl, scene.tri_feats, G=32, SPB=16, C=C,
            n_blocks=nb)
        tiles = lambda: sweep.sweep_tiles(tids, cids, ttbl, key0, pair0,
                                          scene.tri_feats, TILE=512, C=C)
        rec = {"rows": rb, "cols": cc, "warps": warps}
        try:
            out = (regroup()[1], tiles()[1])
            if ref is None:
                ref = out
            rec["same_pairs"] = all(bool(jnp.array_equal(a, b))
                                    for a, b in zip(out, ref))
            rec["regroup_ms"] = median_ms(regroup)
            rec["tiles_ms"] = median_ms(tiles)
        except Exception as e:        # a config the compiler refuses
            rec["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""A/B of each hand-written sweep kernel against its plain-XLA version,
end to end through the user entry points, on one GPU.

    python tools/ab_sweeps.py [--reps N] [--rounds R]

At the chip_smoke shapes (1M-triangle heightfield, cluster_size 256):

- regroup: rc.closest_hit on 1,048,576 Morton primary rays and rc.any_hit
  on 1,048,576 secondary rays (random directions from the primary hits,
  t_max in [0.02, 0.2]), both on the warm regrouped route, with
  the Triton sweep (ops/sweep.sweep_regrouped) against the plain version
  (sweep_regrouped_reference: take + einsum(HIGHEST) + min).
- worklist: rc.closest_hit on 65,536 primary rays and rc.any_hit on
  65,536 secondary rays (the tile worklist sweeps) against the XLA
  rounds engine (rc.closest_hit_dense / rc.any_hit_dense) on the same
  rays.

Versions alternate in rounds (kernel, plain, plain, kernel, ...); each
time is the median of --reps repeats after a warm-up call, on the host
clock around work ending in block_until_ready. Prints one JSON line per
comparison and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import jax

import raycore as rc
from raycore.ops import pallas_regroup, sweep
from raycore.utils import workloads as wl


def median_ms(fn, reps: int) -> float:
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def use_plain_regroup_sweep(plain: bool) -> None:
    """Point the regrouped engine at the plain or the kernel sweep; the
    stage graphs are re-traced so the change takes effect."""
    pallas_regroup.sweep_regrouped = (sweep.sweep_regrouped_reference
                                      if plain else sweep.sweep_regrouped)
    jax.clear_caches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--tris", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    dev = wl.device_record()
    if dev["platform"] != "gpu":
        raise SystemExit(f"needs a GPU; JAX runs on {dev['platform']}")
    print(dev["card"], flush=True)
    scene = rc.build_dense(wl.heightfield(args.tris))
    big, small = wl.primary_rays(1 << 20), wl.primary_rays(1 << 16)
    rc.prewarm(scene, 1 << 20)
    big_occ = wl.secondary_rays(big, rc.closest_hit(scene, big), seed=4)
    small_occ = wl.secondary_rays(small, rc.closest_hit(scene, small),
                                  seed=3)

    cells = {
        "regroup closest_hit 1M": (
            lambda: rc.closest_hit(scene, big), None),
        "regroup any_hit 1M": (
            lambda: rc.any_hit(scene, big_occ), None),
        "worklist closest_hit 64K": (
            lambda: rc.closest_hit(scene, small),
            lambda: rc.closest_hit_dense(scene, small)),
        "worklist any_hit 64K": (
            lambda: rc.any_hit(scene, small_occ),
            lambda: rc.any_hit_dense(scene, small_occ)),
    }
    times = {k: {"kernel": [], "plain": []} for k in cells}
    for r in range(args.rounds):
        order = ("kernel", "plain") if r % 2 == 0 else ("plain", "kernel")
        for version in order:
            use_plain_regroup_sweep(version == "plain")
            for name, (kernel_fn, plain_fn) in cells.items():
                fn = kernel_fn if (version == "kernel"
                                   or plain_fn is None) else plain_fn
                times[name][version].append(median_ms(fn, args.reps))
    use_plain_regroup_sweep(False)
    for name, t in times.items():
        k, p = min(t["kernel"]), min(t["plain"])
        print(json.dumps({"cell": name, "kernel_ms": t["kernel"],
                          "plain_ms": t["plain"],
                          "plain_over_kernel": round(p / k, 3),
                          "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Procedural workloads shared by bench.py and chip_smoke.py, plus the
device record every measurement prints beside its numbers.

The headline scene is the displaced-grid heightfield (one depth layer,
coherent like a scanned surface); the headline rays are a downward grid
over it in Morton pixel order, so any ray tile is a near-square pixel
block. There is no mesh asset in the repository: every scene is made from
a seed.
"""
from __future__ import annotations

import subprocess

import numpy as np
import jax
import jax.numpy as jnp


def heightfield(n_tris: int):
    """~n_tris-triangle heightfield over [-1, 1]^2 (999,698 at 1M)."""
    from ..scene.mesh import displaced_grid_mesh
    return displaced_grid_mesh(n=int(np.sqrt(n_tris / 2)), extent=2.0,
                               amplitude=0.35)


def blobby(n_tris: int):
    """~n_tris-triangle closed displaced sphere (>= 2 depth layers)."""
    from ..scene.mesh import blobby_mesh
    nt = int(np.sqrt(n_tris / 2))
    return blobby_mesh(n_theta=nt, n_phi=nt)


def morton_order(side: int) -> np.ndarray:
    """Permutation putting a row-major side x side pixel grid in Morton
    (Z) order; side must be a power of two."""
    ij = np.arange(side, dtype=np.uint64)

    def spread(v):
        v = (v | (v << np.uint64(8))) & np.uint64(0x00FF00FF)
        v = (v | (v << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        v = (v | (v << np.uint64(2))) & np.uint64(0x33333333)
        return (v | (v << np.uint64(1))) & np.uint64(0x55555555)

    z = spread(ij)
    code = (z[:, None] << np.uint64(1)) | z[None, :]
    return np.argsort(code.reshape(-1), kind="stable")


def primary_rays(n_rays: int):
    """Downward primary rays from z=3 over [-0.95, 0.95]^2 (the coherent
    primary-ray configuration of BASELINE.md), Morton-ordered when the
    grid side is a power of two. n_rays is rounded down to a square.

    The x and y grids are shifted by different fractions of a pixel so
    that no ray runs exactly along a shared mesh edge (the diagonal
    x = y of an unshifted grid does), where the brute-force oracle's hit
    flips with rounding."""
    from ..core.ray import Ray
    side = int(np.sqrt(n_rays))
    xs = np.linspace(-0.95, 0.95, side)
    step = 1.9 / max(side - 1, 1)
    X, Y = np.meshgrid((xs + 0.137 * step).astype(np.float32),
                       (xs + 0.419 * step).astype(np.float32),
                       indexing="ij")
    o = np.stack([X, Y, np.full_like(X, 3.0)], -1).reshape(-1, 3)
    if side & (side - 1) == 0:
        o = o[morton_order(side)]
    o = jnp.asarray(o)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
                         o.shape)
    return Ray.create(o=o, d=d)


def secondary_rays(primary, hits, seed: int = 0, t_max=(0.02, 0.2)):
    """Incoherent rays spawned where ``primary`` hit (``hits``, a
    HitResult), in the primaries' order: origins backed off 1e-3 along
    the incoming direction, directions uniform over the sphere, t_max
    drawn from ``t_max`` — the short shadow/diffuse probes of a bounce.
    Rays whose primary missed start at the primary's origin."""
    from ..core.ray import Ray
    n = primary.o.shape[0]
    rng = np.random.default_rng(seed)
    o = primary.o + (hits.t - 1e-3)[:, None] * primary.d
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = rng.uniform(t_max[0], t_max[1], n).astype(np.float32)
    return Ray.create(o=o, d=jnp.asarray(d), t_max=jnp.asarray(tm))


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them, or a
    note saying why they are unavailable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else "nvidia-smi gave no GPU"


def device_record() -> dict:
    """Platform, kind and count as JAX reports them, plus the card."""
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card()}

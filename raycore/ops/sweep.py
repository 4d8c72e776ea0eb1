"""Featurized Möller–Trumbore sweeps for the GPU (Pallas through Triton).

One sweep body serves three drivers:

- ``sweep_regrouped``: the cluster-major regrouped engine. One program
  per (block, row chunk): it reads its block's cluster id and subgroup
  ids from device memory, gathers its ray-table rows, and walks the
  cluster's triangles in register-sized column chunks, carrying the
  per-row min key and lane. Nothing of the (rows, 4C) product is written
  to device memory.
- ``sweep_tiles``: the tile worklist engine. One program per (ray tile,
  row chunk) loops over that tile's run of the tile-sorted worklist with
  the best key and pair in registers.
- ``occlude_tiles``: the occlusion variant of ``sweep_tiles``; a program
  leaves its loop once every one of its rays has an occluder.

The product runs as explicit IEEE fp32 multiply-adds over the ten
non-zero feature rows (d, o x d, o, 1), never through TF32, so the
exactness contract of docs/engines.md holds. ``sweep_regrouped_reference``
is the plain version (``jnp.take`` + ``einsum(precision=HIGHEST)`` + min)
the kernels are tested against.

Keys are the int32 bit pattern of the hit t (non-negative, so int order
is float order); INT32_MAX means no hit. Ties resolve to the smallest
lane within a cluster and to the earliest cluster across a worklist run.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .backend import interpret

FEAT = 16
N_TERMS = 10            # feature rows with non-zero triangle weights
COL_TMIN = 13
COL_TMAX = 14
INT32_MAX = 0x7FFFFFFF
EDGE_EPS = 1e-5

# Chosen on the H100 by tools/tune_sweep.py over rows {32, 64, 128} x
# cols {16, 32, 64} x warps {4, 8} at the 1M-ray headline (PERF.md).
ROWS_PER_PROGRAM = 32   # rays held by one program
COLS_PER_CHUNK = 32     # triangles per register chunk
NUM_WARPS = 4


def _params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


def _chunk_cols(C: int, SUB: int) -> int:
    return min(COLS_PER_CHUNK, C // SUB)


def _test_chunk(cols, tmin, tmax, feats_ref, cid, j, *, C: int, SUB: int):
    """Featurized Möller–Trumbore of the rows against the cluster's j-th
    chunk of triangles: (t, accepted, lane) of shape (RB, CC)."""
    CS = C // SUB
    CC = _chunk_cols(C, SUB)
    lane0 = j * CC
    s = lane0 // CS
    start = s * (4 * CS) + (lane0 - s * CS)     # sub-chunk-major columns
    q = []
    for qi in range(4):                 # det, u*det, v*det, t*det
        acc = None
        for k in range(N_TERMS):
            f = feats_ref[cid, k, pl.ds(start + qi * CS, CC)]
            term = cols[k][:, None] * f[None, :]
            acc = term if acc is None else acc + term
        q.append(acc)
    det, udet, vdet, tdet = q
    r = 1.0 / det
    u, v, t = udet * r, vdet * r, tdet * r
    e = EDGE_EPS
    ok = (u >= -e) & (u <= 1.0 + e) & (v >= -e) & (u + v <= 1.0 + e) \
        & (t >= tmin[:, None]) & (t <= tmax[:, None])
    lanes = lane0 + jax.lax.broadcasted_iota(jnp.int32, ok.shape, 1)
    return t, ok, lanes


def _sweep(cols, tmin, tmax, feats_ref, cid, base, key, pair, *, C: int,
           SUB: int, n_chunks):
    """Fold one cluster into the carried (key, pair) of each row.

    cols: N_TERMS (RB,) ray feature columns; tmin/tmax: (RB,); base:
    scalar or (RB,) added to the winning lane to form the pair id.
    n_chunks may be traced (0 skips the cluster)."""

    def chunk(c):
        j, key, pair = c
        t, ok, lanes = _test_chunk(cols, tmin, tmax, feats_ref, cid, j, C=C,
                                   SUB=SUB)
        kb = jax.lax.bitcast_convert_type(jnp.maximum(t, 0.0), jnp.int32)
        kb = jnp.where(ok, kb, INT32_MAX)
        kmin = jnp.min(kb, axis=1)
        lane = jnp.min(jnp.where(kb == kmin[:, None], lanes, INT32_MAX),
                       axis=1)
        better = kmin < key
        return (j + 1, jnp.where(better, kmin, key),
                jnp.where(better, base + lane, pair))

    _, key, pair = jax.lax.while_loop(lambda c: c[0] < n_chunks, chunk,
                                      (jnp.int32(0), key, pair))
    return key, pair


def _ray_cols(tbl_ref, rows):
    cols = [tbl_ref[rows, k] for k in range(N_TERMS)]
    return cols, tbl_ref[rows, COL_TMIN], tbl_ref[rows, COL_TMAX]


def _rows_per_program(rows: int) -> int:
    return min(ROWS_PER_PROGRAM, rows)


# --- regrouped (cluster-major block) sweep ----------------------------------

def _regroup_kernel(cid_ref, subs_ref, tbl_ref, feats_ref, key_ref, pair_ref,
                    *, C: int, SUB: int, G: int, SPB: int, RB: int,
                    payload: str):
    b = pl.program_id(0)
    r = pl.program_id(1)
    ROWS = G * SPB
    cid = cid_ref[b]
    local = r * RB + jax.lax.broadcasted_iota(jnp.int32, (RB,), 0)
    slot = local // G
    sub = subs_ref[b * SPB + slot]
    cols, tmin, tmax = _ray_cols(tbl_ref, sub * G + local % G)
    if payload == "pairrow":
        # Instanced engine: the winner names (block row, lane); the same
        # prim can be hit through different instances.
        base = (b * SPB + slot) * C
    else:
        base = cid * C
    n_chunks = (cid >= 0).astype(jnp.int32) * (C // _chunk_cols(C, SUB))
    key, pair = _sweep(cols, tmin, tmax, feats_ref, jnp.maximum(cid, 0),
                       base, jnp.full((RB,), INT32_MAX, jnp.int32),
                       jnp.full((RB,), -1, jnp.int32), C=C, SUB=SUB,
                       n_chunks=n_chunks)
    out = pl.ds(b * ROWS + r * RB, RB)
    key_ref[out] = key
    pair_ref[out] = pair


@partial(jax.jit, static_argnames=("G", "SPB", "C", "SUB", "n_blocks",
                                   "payload"))
def sweep_regrouped(block_subs, block_cid, tbl, feats, *, G: int, SPB: int,
                    C: int, n_blocks: int, SUB: int = 1,
                    payload: str = "prim"):
    """Sweep the first ``n_blocks`` cluster-major blocks. block_cid (B,)
    names each block's cluster (-1 = padding: key INT32_MAX, pair -1);
    block_subs (B, SPB) names its ray-table subgroups; tbl is the
    (n_sub + 1, G, FEAT) ray table (t_min / t_max in columns 13 / 14);
    feats is the scene's (K, FEAT, 4C) table. Returns (key, pair) of
    shape (n_blocks * SPB * G,) in block-row order. pair is
    ``cid * C + lane`` ("prim") or ``(block * SPB + slot) * C + lane``
    ("pairrow")."""
    ROWS = G * SPB
    if n_blocks == 0:
        z = jnp.zeros((0,), jnp.int32)
        return z, z
    RB = _rows_per_program(ROWS)
    kernel = partial(_regroup_kernel, C=C, SUB=SUB, G=G, SPB=SPB, RB=RB,
                     payload=payload)
    out = jax.ShapeDtypeStruct((n_blocks * ROWS,), jnp.int32)
    return pl.pallas_call(
        kernel, grid=(n_blocks, ROWS // RB), out_shape=[out, out],
        backend="triton", compiler_params=_params(),
        interpret=interpret(), name="regroup_sweep",
    )(block_cid[:n_blocks], block_subs[:n_blocks].reshape(-1),
      tbl.reshape(-1, FEAT), feats)


def _block_keys_reference(cid, subs, tbl, feats, *, G, SPB, C, SUB):
    """Plain per-block sweep: (ROWS,) key and winning lane."""
    rows = jnp.take(tbl, subs, axis=0).reshape(G * SPB, FEAT)
    phi = jnp.where(jnp.arange(FEAT) < N_TERMS, rows, 0.0)
    q = jnp.einsum("rf,fc->rc", phi, feats[jnp.maximum(cid, 0)],
                   precision=jax.lax.Precision.HIGHEST)
    CS = C // SUB
    q = q.reshape(-1, SUB, 4, CS).transpose(0, 2, 1, 3).reshape(-1, 4, C)
    det, udet, vdet, tdet = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = 1.0 / det
    u, v, t = udet * r, vdet * r, tdet * r
    e = EDGE_EPS
    ok = (u >= -e) & (u <= 1.0 + e) & (v >= -e) & (u + v <= 1.0 + e) \
        & (t >= rows[:, COL_TMIN:COL_TMIN + 1]) \
        & (t <= rows[:, COL_TMAX:COL_TMAX + 1]) & (cid >= 0)
    kb = jnp.where(ok, jax.lax.bitcast_convert_type(jnp.maximum(t, 0.0),
                                                    jnp.int32), INT32_MAX)
    key = jnp.min(kb, axis=1)
    lane = jnp.argmin(kb, axis=1).astype(jnp.int32)     # first on ties
    return key, lane


REFERENCE_BLOCKS_PER_STEP = 256    # (512, 1024) fp32 products: 512 MB


@partial(jax.jit, static_argnames=("G", "SPB", "C", "SUB", "n_blocks",
                                   "payload"))
def sweep_regrouped_reference(block_subs, block_cid, tbl, feats, *, G: int,
                              SPB: int, C: int, n_blocks: int, SUB: int = 1,
                              payload: str = "prim"):
    """``sweep_regrouped`` in plain JAX, REFERENCE_BLOCKS_PER_STEP blocks
    at a time so the (rows, 4C) products stay within device memory."""
    ROWS = G * SPB
    if n_blocks == 0:
        z = jnp.zeros((0,), jnp.int32)
        return z, z
    step = min(REFERENCE_BLOCKS_PER_STEP, n_blocks)
    nb_p = -(-n_blocks // step) * step
    pad = nb_p - n_blocks
    cid = jnp.concatenate([block_cid[:n_blocks],
                           jnp.full((pad,), -1, jnp.int32)])
    subs = jnp.concatenate([block_subs[:n_blocks],
                            jnp.zeros((pad, SPB), jnp.int32)])
    one = jax.vmap(partial(_block_keys_reference, tbl=tbl, feats=feats, G=G,
                           SPB=SPB, C=C, SUB=SUB))
    key, lane = jax.lax.map(
        lambda a: one(a[0], a[1]),
        (cid.reshape(-1, step), subs.reshape(-1, step, SPB)))
    key = key.reshape(nb_p, ROWS)[:n_blocks]
    lane = lane.reshape(nb_p, ROWS)[:n_blocks]
    if payload == "pairrow":
        slot = jnp.arange(ROWS, dtype=jnp.int32) // G
        base = (jnp.arange(n_blocks, dtype=jnp.int32)[:, None] * SPB
                + slot[None, :]) * C
    else:
        base = cid[:n_blocks, None] * C
    pair = jnp.where(key == INT32_MAX, -1, base + lane)
    return key.reshape(-1), pair.reshape(-1)


# --- tile worklist sweeps ----------------------------------------------------

def tile_starts(tids, n_tiles: int):
    """(n_tiles + 1,) start offsets of each tile's run in a tile-sorted
    worklist; entries with tid >= n_tiles (padding) fall past the end."""
    return jnp.searchsorted(tids, jnp.arange(n_tiles + 1, dtype=tids.dtype),
                            side="left").astype(jnp.int32)


def _tile_kernel(start_ref, cids_ref, phi_ref, key0_ref, pair0_ref,
                 feats_ref, key_ref, pair_ref, *, C: int, SUB: int,
                 TILE: int, RB: int):
    tile = pl.program_id(0)
    r = pl.program_id(1)
    rows = tile * TILE + r * RB + jax.lax.broadcasted_iota(jnp.int32,
                                                           (RB,), 0)
    cols, tmin, tmax = _ray_cols(phi_ref, rows)
    n_chunks = C // _chunk_cols(C, SUB)

    def entry(i, carry):
        cid = cids_ref[i]
        return _sweep(cols, tmin, tmax, feats_ref, cid, cid * C, *carry,
                      C=C, SUB=SUB, n_chunks=n_chunks)

    key, pair = jax.lax.fori_loop(start_ref[tile], start_ref[tile + 1],
                                  entry, (key0_ref[rows], pair0_ref[rows]))
    key_ref[rows] = key
    pair_ref[rows] = pair


@partial(jax.jit, static_argnames=("TILE", "C", "SUB"))
def sweep_tiles(tids, cids, phi, key0, pair0, feats, *, TILE: int, C: int,
                SUB: int = 1):
    """Closest-hit sweep over a tile-sorted worklist. phi is the
    (n_tiles * TILE, FEAT) ray table (t_min / t_max in columns 13 / 14),
    tids/cids the worklist (tid >= n_tiles = padding). key0/pair0 seed
    each row's best (INT32_MAX / -1 for none). Returns (key, pair)."""
    R = phi.shape[0]
    n_tiles = R // TILE
    RB = _rows_per_program(TILE)
    kernel = partial(_tile_kernel, C=C, SUB=SUB, TILE=TILE, RB=RB)
    out = jax.ShapeDtypeStruct((R,), jnp.int32)
    return pl.pallas_call(
        kernel, grid=(n_tiles, TILE // RB), out_shape=[out, out],
        backend="triton", compiler_params=_params(),
        interpret=interpret(), name="tile_sweep",
    )(tile_starts(tids, n_tiles), cids, phi, key0, pair0, feats)


def _occlusion_kernel(start_ref, cids_ref, phi_ref, feats_ref, pair_ref, *,
                      C: int, SUB: int, TILE: int, RB: int):
    tile = pl.program_id(0)
    r = pl.program_id(1)
    rows = tile * TILE + r * RB + jax.lax.broadcasted_iota(jnp.int32,
                                                           (RB,), 0)
    cols, tmin, tmax = _ray_cols(phi_ref, rows)
    # Padding rows (t_max < t_min) can never be occluded; count them done.
    live = tmax >= tmin

    def chunk(j, carry):
        pair, cid = carry
        _, ok, lanes = _test_chunk(cols, tmin, tmax, feats_ref, cid, j, C=C,
                                   SUB=SUB)
        lane = jnp.min(jnp.where(ok, lanes, INT32_MAX), axis=1)
        found = (pair < 0) & (lane < INT32_MAX)
        return jnp.where(found, cid * C + lane, pair), cid

    def cond(c):
        i, pair = c
        open_rows = jnp.where(live & (pair < 0), 1, 0)
        return (i < start_ref[tile + 1]) & (jnp.max(open_rows) > 0)

    def body(c):
        i, pair = c
        pair, _ = jax.lax.fori_loop(0, C // _chunk_cols(C, SUB), chunk,
                                    (pair, cids_ref[i]))
        return i + 1, pair

    _, pair = jax.lax.while_loop(
        cond, body, (start_ref[tile], jnp.full((RB,), -1, jnp.int32)))
    pair_ref[rows] = pair


@partial(jax.jit, static_argnames=("TILE", "C", "SUB"))
def occlude_tiles(tids, cids, phi, feats, *, TILE: int, C: int,
                  SUB: int = 1):
    """Occlusion sweep over a tile-sorted worklist: per row, the first
    accepted candidate (-1 = unoccluded). Same layout as sweep_tiles."""
    R = phi.shape[0]
    n_tiles = R // TILE
    RB = _rows_per_program(TILE)
    kernel = partial(_occlusion_kernel, C=C, SUB=SUB, TILE=TILE, RB=RB)
    return pl.pallas_call(
        kernel, grid=(n_tiles, TILE // RB),
        out_shape=jax.ShapeDtypeStruct((R,), jnp.int32),
        backend="triton", compiler_params=_params(),
        interpret=interpret(), name="occlusion_sweep",
    )(tile_starts(tids, n_tiles), cids, phi, feats)

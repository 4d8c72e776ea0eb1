"""Heterogeneous, trace-friendly collections: the MultiTypeSet equivalent.

Array-parallel redesign of the reference's MultiTypeSet (reference:
src/multitypeset.jl). The reference achieves GPU-safe heterogeneous dispatch
with a tuple of per-type device vectors + an @generated if-elseif chain over
type slots (`with_index`, src/multitypeset.jl:573-597) and isbits texture
pointers (`TextureRef`). Here:

- a ``SetKey`` is an (type_idx, row_idx) int32 pair; ``(-1, -1)`` is the
  invalid sentinel (the reference uses (0,0) with 1-based indices),
- the static form is a tuple of per-type packed SoA tables (pytrees of
  arrays with a power-of-two padded leading dim),
- ``with_index`` is literally ``lax.switch`` over the type slots,
- textures live in one flat float32 pool + (offset, h, w, c) int32 records;
  a ``TextureRef`` is an int32 handle into the records (no pointers), and
  ``deref``/sampling are gathers computed from uv.

The mutable host class keeps the authoritative Python-side items and
surgically refreshes the static form per mutation (same contract as the
reference's always-consistent `static` field, src/multitypeset.jl:213-260).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

INVALID_KEY = (-1, -1)


def SetKey(type_idx: int, row_idx: int):
    """Key into a (Static)MultiTypeSet: int32 (type, row) pair, batchable."""
    return jnp.asarray([type_idx, row_idx], jnp.int32)


def is_invalid(key) -> jnp.ndarray:
    key = jnp.asarray(key)
    return (key[..., 0] < 0) | (key[..., 1] < 0)


def is_valid_key(key) -> jnp.ndarray:
    return ~is_invalid(key)


@struct.dataclass
class TexturePool:
    """Flat texture storage: all texel data in one float32 buffer plus
    (offset, h, w, c) records. Replaces the reference's isbits device
    pointers (TextureRef, src/multitypeset.jl:157-176)."""
    data: jnp.ndarray      # (total_texels,) float32
    records: jnp.ndarray   # (n_textures, 4) int32: offset, h, w, c

    @classmethod
    def empty(cls):
        return cls(data=jnp.zeros((1,), jnp.float32),
                   records=jnp.zeros((1, 4), jnp.int32))

    def shape_of(self, ref):
        r = self.records[jnp.asarray(ref, jnp.int32)]
        return r[..., 1], r[..., 2], r[..., 3]


def sample_nearest(pool: TexturePool, ref, uv):
    """Point-sample texture `ref` at uv in [0,1]^2 -> (..., C) where C is
    read per-call from the record (result channel count is the max C in the
    pool's record; callers slice). For simplicity returns 4 channels padded
    with zeros."""
    ref = jnp.asarray(ref, jnp.int32)
    rec = pool.records[jnp.clip(ref, 0, pool.records.shape[0] - 1)]
    off, h, w, c = rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3]
    uv = jnp.asarray(uv, jnp.float32)
    x = jnp.clip((uv[..., 0] * w.astype(jnp.float32)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h.astype(jnp.float32)).astype(jnp.int32), 0, h - 1)
    base = off + (y * w + x) * c
    ch = jnp.arange(4, dtype=jnp.int32)
    idx = base[..., None] + jnp.minimum(ch, jnp.maximum(c[..., None] - 1, 0))
    texel = pool.data[jnp.clip(idx, 0, pool.data.shape[0] - 1)]
    return jnp.where(ch < c[..., None], texel, 0.0)


def sample_bilinear(pool: TexturePool, ref, uv):
    ref = jnp.asarray(ref, jnp.int32)
    rec = pool.records[jnp.clip(ref, 0, pool.records.shape[0] - 1)]
    off, h, w, c = rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3]
    uv = jnp.asarray(uv, jnp.float32)
    fx = uv[..., 0] * w.astype(jnp.float32) - 0.5
    fy = uv[..., 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0.astype(jnp.float32)
    ty = fy - y0.astype(jnp.float32)

    def tap(xi, yi):
        xc = jnp.clip(xi, 0, w - 1)
        yc = jnp.clip(yi, 0, h - 1)
        base = off + (yc * w + xc) * c
        ch = jnp.arange(4, dtype=jnp.int32)
        idx = base[..., None] + jnp.minimum(ch, jnp.maximum(c[..., None] - 1, 0))
        texel = pool.data[jnp.clip(idx, 0, pool.data.shape[0] - 1)]
        return jnp.where(ch < c[..., None], texel, 0.0)

    t00, t10 = tap(x0, y0), tap(x0 + 1, y0)
    t01, t11 = tap(x0, y0 + 1), tap(x0 + 1, y0 + 1)
    tx = tx[..., None]
    ty = ty[..., None]
    return (t00 * (1 - tx) + t10 * tx) * (1 - ty) \
        + (t01 * (1 - tx) + t11 * tx) * ty


@struct.dataclass
class StaticMultiTypeSet:
    """Frozen form: per-type SoA tables + texture pool + live counts."""
    tables: Tuple[Any, ...]        # tuple of pytrees, leading dim per type
    counts: jnp.ndarray            # (n_types,) int32 live rows per type
    textures: TexturePool

    @property
    def n_slots(self) -> int:
        return len(self.tables)


def gather_row(table, row_idx):
    """Gather one (or a batch of) row(s) from a per-type SoA table."""
    row_idx = jnp.asarray(row_idx, jnp.int32)

    def take(a):
        return jnp.take(a, jnp.clip(row_idx, 0, a.shape[0] - 1), axis=0)

    return jax.tree_util.tree_map(take, table)


def with_index(fns: Sequence[Callable], sset: StaticMultiTypeSet, key,
               *args):
    """Dispatch on the key's type slot: ``fns[type](row_data, *args)``
    (reference with_index, src/multitypeset.jl:573-597 — the @generated
    if-chain is literally `lax.switch`). ``fns`` may be one callable
    (applied to every type) or one per type. Invalid keys dispatch to slot
    0's function on row 0 — guard with ``is_invalid(key)`` at the call site
    for the reference's no-op contract."""
    key = jnp.asarray(key, jnp.int32)
    if callable(fns):
        fns = [fns] * len(sset.tables)
    assert len(fns) == len(sset.tables)
    branches = [
        (lambda tbl, fn: lambda k, a: fn(gather_row(tbl, k[..., 1]), *a))(t, f)
        for t, f in zip(sset.tables, fns)
    ]
    return jax.lax.switch(jnp.clip(key[..., 0], 0, len(branches) - 1),
                          branches, key, args)


def deref(pool: TexturePool, ref):
    """Texture record for a handle: (offset, h, w, c) int32 (the reference's
    deref yields the texture view; with a flat pool the record plus
    `sample_nearest`/`sample_bilinear` is the trace-friendly equivalent)."""
    return pool.records[jnp.asarray(ref, jnp.int32)]


def texture_to_numpy(pool: TexturePool, ref):
    """Host-side full texture fetch (shapes are dynamic, so this is a
    NumPy utility, not a traced op)."""
    import numpy as np
    rec = np.asarray(pool.records)[int(ref)]
    off, h, w, c = (int(x) for x in rec)
    return np.asarray(pool.data)[off:off + h * w * c].reshape(h, w, c)


def to_tuple(sset: StaticMultiTypeSet):
    """The per-type table tuple (reference to_tuple)."""
    return sset.tables


def maybe_convert_field(mts: "MultiTypeSet", value):
    """Array-valued fields become texture handles; scalars pass through
    (reference maybe_convert_field, src/multitypeset.jl:281-324)."""
    import numpy as np
    if isinstance(value, np.ndarray) and value.ndim >= 2:
        return mts.store_texture(value)
    return value


def n_slots(sset) -> int:
    return sset.n_slots


def foreach_type(fn: Callable, sset: StaticMultiTypeSet):
    """Apply ``fn(type_idx, table, count)`` per type slot (trace-unrolled,
    like the reference's foreach_element over slots)."""
    return [fn(i, t, sset.counts[i]) for i, t in enumerate(sset.tables)]


def mapreduce_set(map_fns, reduce_fn, init, sset: StaticMultiTypeSet):
    """Vectorized map over every live row of every type, reduced with
    ``reduce_fn`` (reference mapreduce, src/multitypeset.jl:84-150)."""
    if callable(map_fns):
        map_fns = [map_fns] * len(sset.tables)
    acc = init
    for i, (tbl, fn) in enumerate(zip(sset.tables, map_fns)):
        n = jax.tree_util.tree_leaves(tbl)[0].shape[0]
        vals = jax.vmap(fn)(tbl)
        live = jnp.arange(n) < sset.counts[i]
        acc = reduce_fn(acc, vals, live)
    return acc


class MultiTypeSet:
    """Mutable host-side registry of heterogeneous items.

    Items are dicts of: python scalars (packed inline as f32/i32 columns) or
    numpy arrays (stored in the texture pool; the column holds the int32
    TextureRef handle). Type slots are keyed by an explicit type name, in
    first-seen order (matching the reference's data-vector ordering
    semantics, test/test_multitypeset.jl:45-61).
    """

    def __init__(self):
        self._type_names: List[str] = []
        self._items: Dict[str, List[Optional[dict]]] = {}
        self._schemas: Dict[str, Dict[str, str]] = {}   # field -> kind
        self._textures: List[np.ndarray] = [np.zeros((1, 1, 1), np.float32)]
        self._static: Optional[StaticMultiTypeSet] = None
        self._dirty = True

    # -- mutation ---------------------------------------------------------
    def _schema_of(self, item: dict) -> Dict[str, str]:
        sch = {}
        for k, v in item.items():
            if isinstance(v, np.ndarray) and v.ndim >= 2:
                sch[k] = "texture"
            elif isinstance(v, (bool, np.bool_)):
                sch[k] = "int"
            elif isinstance(v, (int, np.integer)):
                sch[k] = "int"
            elif isinstance(v, (np.ndarray, list, tuple)):
                # Small fixed-length vectors stay inline as (cap, K)
                # columns — the reference's inline StaticArrays
                # (maybe_convert_field, src/multitypeset.jl:281-324).
                n = int(np.asarray(v).size)
                assert n > 0, f"empty vector field '{k}'"
                sch[k] = f"vec{n}"
            else:
                sch[k] = "float"
        return sch

    def store_texture(self, arr: np.ndarray) -> int:
        """Add a texture to the pool; returns its int handle (reference
        store_texture, src/multitypeset.jl:333-359)."""
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        self._textures.append(arr)
        self._dirty = True
        return len(self._textures) - 1

    def update_texture(self, handle: int, arr: np.ndarray) -> None:
        """Overwrite a pool slot (capacity-aware in the reference,
        copyto_texture!; here the pool is rebuilt lazily on get_static)."""
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        self._textures[handle] = arr
        self._dirty = True

    def push(self, item: dict, type_name: str):
        """Insert an item; returns its SetKey (reference push!,
        src/multitypeset.jl:368-392). Array-valued fields are converted to
        texture handles (maybe_convert_field semantics)."""
        if type_name not in self._items:
            self._type_names.append(type_name)
            self._items[type_name] = []
            self._schemas[type_name] = self._schema_of(item)
        sch = self._schemas[type_name]
        assert set(item) == set(sch), \
            f"fields {set(item)} != schema {set(sch)} for '{type_name}'"
        conv = {}
        for k, v in item.items():
            if sch[k] == "texture":
                conv[k] = self.store_texture(v)
            else:
                conv[k] = v
        rows = self._items[type_name]
        # Reuse a freed row if any (stable keys, like the reference).
        for ri, r in enumerate(rows):
            if r is None:
                rows[ri] = conv
                self._dirty = True
                return SetKey(self._type_names.index(type_name), ri)
        rows.append(conv)
        self._dirty = True
        return SetKey(self._type_names.index(type_name), len(rows) - 1)

    def update(self, key, item: dict) -> None:
        """Overwrite the item at key, reusing texture slots when shapes
        match (reference update!, src/multitypeset.jl:411-503). An invalid
        key is a silent no-op (regression contract,
        test/test_multitypeset.jl:45-61)."""
        ti, ri = int(key[0]), int(key[1])
        if ti < 0 or ri < 0:
            return
        tname = self._type_names[ti]
        sch = self._schemas[tname]
        old = self._items[tname][ri]
        conv = {}
        for k, v in item.items():
            if sch[k] == "texture":
                h = old[k]
                v3 = np.asarray(v, np.float32)
                if v3.ndim == 2:
                    v3 = v3[..., None]
                if v3.shape == self._textures[h].shape:
                    self.update_texture(h, v3)
                    conv[k] = h
                else:
                    conv[k] = self.store_texture(v3)
            else:
                conv[k] = v
        self._items[tname][ri] = conv
        self._dirty = True

    def delete(self, key) -> None:
        ti, ri = int(key[0]), int(key[1])
        if ti < 0 or ri < 0:
            return
        self._items[self._type_names[ti]][ri] = None
        self._dirty = True

    def free(self) -> None:
        """Drop everything (reference free!, src/multitypeset.jl:640-656)."""
        self.__init__()

    # -- static form --------------------------------------------------------
    def get_static(self) -> StaticMultiTypeSet:
        if self._static is not None and not self._dirty:
            return self._static

        # Texture pool.
        offsets = []
        off = 0
        for t in self._textures:
            offsets.append(off)
            off += t.size
        data = np.concatenate([t.ravel() for t in self._textures]) \
            if off else np.zeros((1,), np.float32)
        recs = np.array([[o, t.shape[0], t.shape[1], t.shape[2]]
                         for o, t in zip(offsets, self._textures)], np.int32)
        pool = TexturePool(data=jnp.asarray(data, jnp.float32),
                           records=jnp.asarray(recs))

        tables = []
        counts = []
        for tname in self._type_names:
            rows = self._items[tname]
            sch = self._schemas[tname]
            n = len(rows)
            cap = max(1, 1 << (max(n, 1) - 1).bit_length())
            cols = {}
            for f, kind in sch.items():
                if kind == "float":
                    col = np.zeros((cap,), np.float32)
                elif kind.startswith("vec"):
                    col = np.zeros((cap, int(kind[3:])), np.float32)
                else:
                    col = np.zeros((cap,), np.int32)
                for ri, r in enumerate(rows):
                    if r is not None:
                        col[ri] = np.asarray(r[f], col.dtype).reshape(
                            col.shape[1:])
                cols[f] = jnp.asarray(col)
            tables.append(cols)
            counts.append(n)

        self._static = StaticMultiTypeSet(
            tables=tuple(tables), counts=jnp.asarray(counts, jnp.int32),
            textures=pool)
        self._dirty = False
        return self._static

    @property
    def n_slots(self) -> int:
        return len(self._type_names)

    def __len__(self):
        return sum(sum(1 for r in rows if r is not None)
                   for rows in self._items.values())

    def __repr__(self):
        parts = [f"{t}: {sum(1 for r in self._items[t] if r is not None)}"
                 for t in self._type_names]
        return f"MultiTypeSet({', '.join(parts)})"

"""Persistent per-(scene-shape, engine, query-shape) capacity hints.

The regroup engine auto-sizes its worklist capacities from one totals
readback and remembers the result in a process-local cache
(`pallas_regroup._CAPACITY_CACHE`). That memory is what `accel.dispatch`
consults to auto-route big queries to the regrouped engine — but a
process-local cache means every FRESH process pays the tile-worklist path
on query 1 unless it calls `rc.prewarm`.

This module persists those hints to a small JSON file beside the JAX
persistent compile cache (utils/cache.py). The disk key drops the
process-local `id(scene.tri_feats)` component: two scenes with the same
tri_feats shape and content fingerprint share predictions. That is safe —
capacity predictions are validated post-hoc by every engine (packed
totals readback; overflow retries with doubling; the fused one-dispatch
path falls back to two-stage on any miss), so a stale or wrong hint costs
one fallback dispatch, never correctness. Compiled executables are
likewise recovered from the persistent compile cache.

Disable with RAYCORE_PERSIST_CAPACITY=0; RAYCORE_CAPACITY_DIR moves the
file.
"""
from __future__ import annotations

import json
import os
import threading

_LOCK = threading.Lock()
_LOADED: dict | None = None
_LOADED_PATH: str | None = None


def _enabled() -> bool:
    return os.environ.get("RAYCORE_PERSIST_CAPACITY", "1") != "0"


def _path() -> str | None:
    if not _enabled():
        return None
    from ..utils.cache import cache_dir
    d = os.environ.get("RAYCORE_CAPACITY_DIR") or cache_dir()
    return os.path.join(d, "raycore_capacity_hints.json")


def _load() -> dict:
    global _LOADED, _LOADED_PATH
    p = _path()
    if p is None:
        return {}
    with _LOCK:
        if _LOADED is not None and _LOADED_PATH == p:
            return _LOADED
        try:
            with open(p) as f:
                _LOADED = json.load(f)
        except (OSError, ValueError):
            _LOADED = {}
        _LOADED_PATH = p
        return _LOADED


_FP_CACHE: dict = {}


def scene_fingerprint(scene) -> str:
    """Cheap content fingerprint: the scene's root AABB bytes + padded
    feats shape. Two scenes with the same SHAPES but different geometry
    (the 1M heightfield and the 1M blobby both pad to (8192, 16, 512))
    must NOT share persisted capacity hints: hints are sticky-max and
    never shrink, so the denser scene's counts would permanently inflate
    the sparser scene's worklist capacities. One tiny device
    readback per scene per process, cached by id with a weakref
    staleness guard."""
    key = id(scene.tri_feats)
    ent = _FP_CACHE.get(key)
    if ent is not None:
        ref, fp = ent
        if ref is None or ref() is scene.tri_feats:
            return fp
        del _FP_CACHE[key]
    import hashlib
    import weakref
    import numpy as np
    raw = np.asarray(scene.root_aabb, np.float32).tobytes()
    fp = hashlib.sha1(raw).hexdigest()[:12]
    try:
        ref = weakref.ref(scene.tri_feats)
    except TypeError:
        ref = None
    if len(_FP_CACHE) > 256:
        _FP_CACHE.pop(next(iter(_FP_CACHE)))
    _FP_CACHE[key] = (ref, fp)
    return fp


def persist_key(ck: tuple, scene=None) -> str:
    """Disk key for an engine cache key: drop the leading process-local
    id(), keep everything shape/param-shaped, tag with the backend (a
    CPU-interpret warmup must not convince a GPU process it is warm)
    and with the scene's content fingerprint (see scene_fingerprint)."""
    import jax
    fp = scene_fingerprint(scene) if scene is not None else ""
    return repr((jax.default_backend(), fp) + tuple(ck[1:]))


def load_hint(ck: tuple, scene=None) -> dict | None:
    """Persisted capacity fields for this key, or None."""
    ent = _load().get(persist_key(ck, scene))
    return dict(ent) if isinstance(ent, dict) else None


def save_hint(ck: tuple, ent: dict, scene=None) -> None:
    """Write-through one hint (sticky-max merge with what's on disk).
    Last-writer-wins across processes; hints are advisory so a lost
    update is harmless."""
    p = _path()
    if p is None:
        return
    fields = {k: int(v) for k, v in ent.items()
              if isinstance(v, (int, float)) and k != "ref"}
    if not fields:
        return
    pk = persist_key(ck, scene)
    with _LOCK:
        try:
            try:
                with open(p) as f:
                    cur = json.load(f)
            except (OSError, ValueError):
                cur = {}
            old = cur.get(pk)
            if isinstance(old, dict):
                for k, v in old.items():
                    if isinstance(v, (int, float)):
                        fields[k] = max(fields.get(k, 0), int(v))
            if old == fields:
                return
            cur[pk] = fields
            if len(cur) > 512:      # FIFO bound, mirrors the RAM caches
                for k in list(cur)[:len(cur) - 512]:
                    del cur[k]
            os.makedirs(os.path.dirname(p), exist_ok=True)
            tmp = p + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(cur, f)
            os.replace(tmp, p)
            global _LOADED, _LOADED_PATH
            _LOADED, _LOADED_PATH = cur, p
        except OSError:
            pass

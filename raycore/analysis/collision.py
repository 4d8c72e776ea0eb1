"""Broad-phase instance collision detection over the TLAS tree.

JAX counterpart of the reference's collision module (reference:
src/collision.jl): leaf-vs-tree AABB overlap, two passes (count ->
prefix-sum -> write at precomputed offsets), pairs deduplicated by
``instance_b > instance_a``. The reference's per-leaf GPU threads become a
batched lane-parallel while_loop; `AK.accumulate!` becomes `jnp.cumsum`.

Contact indices are 0-based original instance indices (the reference
returns 1-based).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..accel.types import StaticTLAS, f32_as_i32, i32_as_f32

_INVALID = jnp.int32(-1)


@struct.dataclass
class CollisionResult:
    """(contacts (M, 2) int32, num_contacts int) — M is the exact total
    (reference CollisionResult; the reusable-cache field is unnecessary
    under XLA's allocator)."""
    contacts: jnp.ndarray
    num_contacts: int = struct.field(pytree_node=False)


def _tlas_leaf_blocks(scene: StaticTLAS):
    icap = scene.instance_capacity
    nodes = scene.unified_nodes[: 2 * icap - 1]
    return nodes, icap


def _collide_pass(nodes, icap, mask, offsets, max_contacts: int,
                  stack_size: int = 32):
    """One lane per TLAS leaf; traverses the TLAS testing AABB overlap.
    If max_contacts == 0 this is the counting pass; otherwise writes pairs
    at offsets[lane] + local_count."""
    L = icap
    leaf_rows = jnp.arange(icap - 1, 2 * icap - 1, dtype=jnp.int32)
    leafi = jnp.take(nodes, leaf_rows, axis=0)          # int32 packed
    leaff = i32_as_f32(leafi[:, :6])
    a_min, a_max = leaff[:, 0:3], leaff[:, 3:6]
    inst_a = leafi[:, 13]
    a_real = jnp.take(mask, jnp.clip(inst_a, 0, icap - 1))

    write = max_contacts > 0
    contacts = jnp.full((max(max_contacts, 1), 2), -1, jnp.int32)

    init = dict(
        node=jnp.where(a_real, 0, _INVALID),   # padded lanes never traverse
        stack=jnp.full((L, stack_size), _INVALID, jnp.int32),
        sptr=jnp.zeros((L,), jnp.int32),
        count=jnp.zeros((L,), jnp.int32),
        contacts=contacts,
    )
    slots = jnp.arange(stack_size, dtype=jnp.int32)[None, :]

    def cond(s):
        return jnp.any(s["node"] != _INVALID)

    def body(s):
        node = s["node"]
        active = node != _INVALID
        row = jnp.clip(node, 0, nodes.shape[0] - 1)
        nfi = jnp.take(nodes, row, axis=0)
        nf = i32_as_f32(nfi[:, :12])
        c0 = nfi[:, 12]
        c1 = nfi[:, 13]
        is_leaf = c0 == _INVALID

        def overlaps(bmin, bmax):
            return jnp.all((a_max >= bmin) & (a_min <= bmax), axis=-1)

        ov0 = overlaps(nf[:, 0:3], nf[:, 3:6]) & active & ~is_leaf
        ov1 = overlaps(nf[:, 6:9], nf[:, 9:12]) & active & ~is_leaf

        # Leaf: count the pair once (b > a) if both are real instances.
        inst_b = c1
        b_real = jnp.take(mask, jnp.clip(inst_b, 0, icap - 1))
        pair = active & is_leaf & (inst_b > inst_a) & b_real \
            & overlaps(nf[:, 0:3], nf[:, 3:6])
        count = s["count"] + pair.astype(jnp.int32)

        contacts = s["contacts"]
        if write:
            w_idx = jnp.where(pair, offsets + s["count"], jnp.int32(1 << 30))
            pairs = jnp.stack([inst_a, inst_b], -1)
            contacts = contacts.at[w_idx].set(pairs, mode="drop")

        # Descend: both -> push c1 visit c0; one -> visit it; none -> pop.
        both = ov0 & ov1
        sptr1 = jnp.where(both, s["sptr"] + 1, s["sptr"])
        wmask = (slots == jnp.clip(sptr1, 0, stack_size - 1)[:, None]) \
            & both[:, None]
        stack = jnp.where(wmask, c1[:, None], s["stack"])

        descend = ov0 | ov1
        next_desc = jnp.where(ov0, c0, c1)
        need_pop = active & ~descend
        top = jnp.take_along_axis(
            stack, jnp.clip(sptr1, 0, stack_size - 1)[:, None], axis=1)[:, 0]
        popped_ok = need_pop & (s["sptr"] + both.astype(jnp.int32) > 0)
        node_next = jnp.where(descend, next_desc,
                              jnp.where(need_pop,
                                        jnp.where(sptr1 > 0, top, _INVALID),
                                        node))
        sptr_next = jnp.where(need_pop & (sptr1 > 0), sptr1 - 1, sptr1)
        del popped_ok
        return dict(node=node_next, stack=stack, sptr=sptr_next,
                    count=count, contacts=contacts)

    out = jax.lax.while_loop(cond, body, init)
    return out["count"], out["contacts"]


@partial(jax.jit, static_argnames=())
def _count_pass(nodes, icap_arr, mask):
    icap = mask.shape[0]
    counts, _ = _collide_pass(nodes, icap, mask,
                              jnp.zeros((icap,), jnp.int32), 0)
    return counts


@partial(jax.jit, static_argnames=("max_contacts",))
def _write_pass(nodes, mask, offsets, max_contacts):
    icap = mask.shape[0]
    _, contacts = _collide_pass(nodes, icap, mask, offsets, max_contacts)
    return contacts


def collide_instances(scene: StaticTLAS) -> CollisionResult:
    """All instance pairs whose world AABBs overlap (reference
    collide_instances, src/collision.jl:189-233). Exact two-pass:
    count -> cumsum -> write, sized to the true total."""
    nodes, icap = _tlas_leaf_blocks(scene)
    mask = scene.instances.mask
    counts = _count_pass(nodes, jnp.int32(icap), mask)
    offsets = jnp.cumsum(counts) - counts
    total = int(jnp.sum(counts))
    if total == 0:
        return CollisionResult(contacts=jnp.zeros((0, 2), jnp.int32),
                               num_contacts=0)
    contacts = _write_pass(nodes, mask, offsets.astype(jnp.int32), total)
    return CollisionResult(contacts=contacts, num_contacts=total)


def collide_instances_any(tlas, handle_a, handle_b) -> bool:
    """Early-exit broad-phase test between two handles' instance groups
    (reference collide_instances_any, src/collision.jl:241-261). Host-side
    AABB math over the handful of instances involved."""
    from ..scene.tlas import TLAS  # noqa: F401 (type only)
    scene = tlas.sync()
    wmins, wmaxs = _instance_aabbs_host(tlas, scene)
    for ia in tlas._require(handle_a):
        for ib in tlas._require(handle_b):
            if np.all(wmaxs[ia] >= wmins[ib]) and np.all(wmins[ia] <= wmaxs[ib]):
                return True
    return False


def _instance_aabbs_host(tlas, scene: StaticTLAS):
    from ..accel.tlas_build import instance_world_aabbs
    wmin, wmax = instance_world_aabbs(scene.instances, scene.blas_root_aabb)
    return np.asarray(wmin), np.asarray(wmax)

"""TLAS topology construction (instance-level LBVH).

JAX counterpart of the reference's TLAS build (reference:
src/instanced-bvh.jl:1449-1651 + src/instanced-bvh-kernels.jl:316-428):
per-instance world AABBs from the 8 transformed BLAS root corners, degenerate
extent clamping, Morton sort, shared Karras topology, leaves storing the
world AABB + the ORIGINAL instance index (instances are not permuted), and
fixpoint refit instead of atomic bottom-up walks.

Padding instances (mask False) carry far-away AABBs (PAD_COORD) so all
shapes stay static; the single-instance special case of the reference
(src/instanced-bvh.jl:1553-1570) disappears because capacity >= 2.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.transforms import transform_point_3x4
from . import morton as _morton
from .lbvh import MAX_DEPTH, karras_topology, refit_aabbs
from .types import (INVALID_NODE, NODE_COLS, PAD_COORD, Instances,
                    f32_as_i32, i32_as_f32)

DEGENERATE_EXTENT = 1e-6  # reference clamp (src/instanced-bvh.jl:1517-1521)


def instance_world_aabbs(instances: Instances, blas_root_aabb):
    """World AABB per instance: transform the 8 corners of the BLAS root
    AABB (reference compute_instance_aabbs_kernel!,
    src/instanced-bvh-kernels.jl:65-78). Padding instances land at PAD_COORD."""
    root = jnp.take(blas_root_aabb, jnp.clip(instances.blas_index, 0, blas_root_aabb.shape[0] - 1), axis=0)  # (I,2,3)
    lo, hi = root[:, 0], root[:, 1]
    corners = jnp.stack([
        jnp.stack([jnp.where(jnp.asarray(c) == 1, hi[:, k], lo[:, k])
                   for k, c in enumerate(((i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1))], axis=-1)
        for i in range(8)], axis=1)                     # (I, 8, 3)
    world = transform_point_3x4(instances.transform[:, None, :, :], corners)
    wmin = jnp.min(world, axis=1)
    wmax = jnp.max(world, axis=1)
    pad = ~instances.mask
    wmin = jnp.where(pad[:, None], PAD_COORD, wmin)
    wmax = jnp.where(pad[:, None], PAD_COORD, wmax)
    return wmin, wmax


def build_tlas_nodes(instances: Instances, blas_root_aabb):
    """Build the packed TLAS node matrix (2*icap-1, 16) plus the scene AABB
    over real instances. Fully jit-compatible, static shapes."""
    wmin, wmax = instance_world_aabbs(instances, blas_root_aabb)
    icap = wmin.shape[0]

    # Scene AABB over real instances (masked reduce).
    big = jnp.float32(jnp.inf)
    m = instances.mask[:, None]
    scene_min = jnp.min(jnp.where(m, wmin, big), axis=0)
    scene_max = jnp.max(jnp.where(m, wmax, -big), axis=0)
    # Degenerate-extent clamp so Morton normalization stays finite.
    extent = jnp.maximum(scene_max - scene_min, DEGENERATE_EXTENT)

    centers = 0.5 * (wmin + wmax)
    codes = _morton.morton_code_30bit((centers - scene_min) / extent)

    order = jnp.arange(icap, dtype=jnp.int32)
    codes_sorted, perm = jax.lax.sort((codes, order), num_keys=1,
                                      is_stable=True)
    smin = jnp.take(wmin, perm, axis=0)
    smax = jnp.take(wmax, perm, axis=0)

    child0, child1, parent = karras_topology(codes_sorted)
    node_min, node_max = refit_aabbs(child0, child1, smin, smax,
                                     n_passes=min(MAX_DEPTH, icap))

    a0min = jnp.take(node_min, child0, axis=0)
    a0max = jnp.take(node_max, child0, axis=0)
    a1min = jnp.take(node_min, child1, axis=0)
    a1max = jnp.take(node_max, child1, axis=0)
    internal = jnp.concatenate(
        [f32_as_i32(jnp.concatenate([a0min, a0max, a1min, a1max], axis=1)),
         child0[:, None], child1[:, None], parent[: icap - 1][:, None],
         jnp.zeros((icap - 1, 1), jnp.int32)], axis=1)

    # Leaves: world AABB in the aabb0 slots + ORIGINAL instance index in
    # child1 (reference create_tlas_leaf_nodes_kernel!,
    # src/instanced-bvh-kernels.jl:360-375). Int32-packed like the BLAS
    # nodes (see types.py: NaN-canonicalization hazard).
    leaves = jnp.concatenate(
        [f32_as_i32(jnp.concatenate(
            [smin, smax, jnp.zeros((icap, 6), jnp.float32)], axis=1)),
         jnp.full((icap, 1), INVALID_NODE, jnp.int32),
         perm[:, None], parent[icap - 1:][:, None],
         jnp.zeros((icap, 1), jnp.int32)], axis=1)

    nodes = jnp.concatenate([internal, leaves], axis=0)
    root_aabb = jnp.stack([scene_min, scene_max])
    return nodes, root_aabb

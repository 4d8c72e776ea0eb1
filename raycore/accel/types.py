"""Acceleration-structure data types.

Array-parallel redesign of the reference's node/descriptor types (reference:
src/instanced-bvh.jl:28-168). Differences, by design:

- Nodes are NOT 64-byte AoS structs; they are rows of a packed ``(N, 16)``
  **int32** SoA matrix (float fields bitcast to int32), so one traversal
  step costs one row gather. The matrix is int-typed end-to-end because
  float paths may canonicalize NaNs, and the int sentinel -1 bitcast to
  f32 IS a NaN — storing ints and bitcasting slices to f32 *after* the
  gather keeps every bit pattern intact. Layout per row:

      cols 0:3   aabb0_min   | leaf: v0            (BVH2IL inline vertices)
      cols 3:6   aabb0_max   | leaf: v1
      cols 6:9   aabb1_min   | leaf: v2
      cols 9:12  aabb1_max   | TLAS leaf: unused; BLAS leaf: unused
      col  12    child0 (bitcast int32; INVALID_NODE => leaf)
      col  13    child1 (bitcast int32; leaf: prim idx (BLAS, sorted order)
                                              / original instance idx (TLAS))
      col  14    parent (bitcast int32; root: INVALID_NODE)
      col  15    padding

- Indices are 0-based int32; ``INVALID_NODE = -1`` (the reference uses
  uint32 0xffffffff), ``TOP_LEVEL_SENTINEL = -2``.
- Array capacities are padded to powers of two with far-away sentinel
  geometry (vertices at ``PAD_COORD``), so every build/traversal shape is
  static and the n==1 special cases of the reference disappear.
- Node layout: for capacity n, internal nodes occupy rows [0, n-2] (root is
  row 0), leaves [n-1, 2n-2] (reference leaf_index, src/instanced-bvh.jl:1293).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core.triangle import Triangle

INVALID_NODE = jnp.int32(-1)
TOP_LEVEL_SENTINEL = jnp.int32(-2)
PAD_COORD = 1.0e30          # padding geometry lives here; never intersected
NODE_COLS = 16

# Bit-level helpers -----------------------------------------------------------

def i32_as_f32(x):
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.int32), jnp.float32)


def f32_as_i32(x):
    return jax.lax.bitcast_convert_type(jnp.asarray(x, jnp.float32), jnp.int32)


def next_pow2(n: int) -> int:
    n = max(int(n), 2)
    return 1 << (n - 1).bit_length()


# Containers ------------------------------------------------------------------

@struct.dataclass
class BLAS:
    """Bottom-level acceleration structure over one mesh (frozen).

    ``prims`` are stored in Morton-sorted order (leaf child1 indexes into
    them); capacity-padded rows hold far-away sentinel triangles.
    """

    nodes: jnp.ndarray          # (2*cap-1, 16) int32 packed (f32 bitcast)
    prims: Triangle             # (cap, ...) sorted SoA
    root_aabb: jnp.ndarray      # (2, 3) float32 over REAL prims only
    n_prims: int = struct.field(pytree_node=False)   # real count
    capacity: int = struct.field(pytree_node=False)

    @property
    def n_nodes(self) -> int:
        return 2 * self.capacity - 1


@struct.dataclass
class Instances:
    """SoA instance descriptors (reference InstanceDescriptor,
    src/instanced-bvh.jl:74-96): row-major 3x4 transform + cached affine
    inverse, BLAS index, and the Vulkan-style ``instance_id`` override
    (0 = inherit from triangle metadata, nonzero forwarded verbatim)."""

    transform: jnp.ndarray      # (I, 3, 4) float32
    inv_transform: jnp.ndarray  # (I, 3, 4) float32
    blas_index: jnp.ndarray     # (I,) int32
    instance_id: jnp.ndarray    # (I,) uint32
    mask: jnp.ndarray           # (I,) bool — real (non-padding) instances


@struct.dataclass
class StaticTLAS:
    """Immutable, kernel-ready scene (reference StaticTLAS,
    src/instanced-bvh.jl:142-168): TLAS tree + flat concatenated BLAS
    node/prim arrays with integer offsets (no pointers).

    ``unified_nodes`` = [TLAS nodes; all BLAS nodes] so traversal uses a
    single gather array; ``blas_nodes_offset`` values already include the
    TLAS block, i.e. they are absolute row bases into ``unified_nodes``.
    """

    unified_nodes: jnp.ndarray      # (2*icap-1 + sum nodes_b, 16) int32 packed
    instances: Instances            # (icap, ...)
    prims: Triangle                 # (sum cap_b, ...) all BLAS prims, sorted
    blas_nodes_offset: jnp.ndarray  # (B,) int32 — absolute base rows
    blas_prims_offset: jnp.ndarray  # (B,) int32
    blas_root_aabb: jnp.ndarray     # (B, 2, 3) float32
    root_aabb: jnp.ndarray          # (2, 3) float32 over real instances
    n_instances: int = struct.field(pytree_node=False)  # real count
    instance_capacity: int = struct.field(pytree_node=False)
    n_blas: int = struct.field(pytree_node=False)

    @property
    def n_tlas_nodes(self) -> int:
        return 2 * self.instance_capacity - 1


def pad_triangles(tris: Triangle, capacity: int) -> Triangle:
    """Pad a Triangle SoA to ``capacity`` rows with far-away sentinels.

    Sentinel triangles are points at PAD_COORD: their AABB never intersects
    real rays and the Möller–Trumbore determinant is 0 => guaranteed miss.
    """
    n = tris.vertices.shape[0]
    if n == capacity:
        return tris
    pad = capacity - n

    def pad_leaf(a, fill):
        shape = (pad,) + a.shape[1:]
        return jnp.concatenate([a, jnp.full(shape, fill, a.dtype)], axis=0)

    return Triangle(
        vertices=pad_leaf(tris.vertices, PAD_COORD),
        normals=pad_leaf(tris.normals, 0),
        tangents=pad_leaf(tris.tangents, 0),
        uv=pad_leaf(tris.uv, 0),
        metadata=pad_leaf(tris.metadata, 0),
    )

"""Morton (Z-order) coding for LBVH construction.

JAX counterpart of the reference's Morton layer (reference:
src/instanced-bvh.jl:1177-1206). All ops are vectorized uint32 bit
arithmetic — elementwise, no gathers.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def expand_bits(x):
    """3-dilate the low 10 bits of x (reference expand_bits,
    src/instanced-bvh.jl:1177-1183)."""
    x = jnp.asarray(x, jnp.uint32)
    x = (x * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    x = (x * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    x = (x * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    x = (x * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return x


def morton_code_30bit(p):
    """30-bit Morton code from a normalized point in [0,1]^3, 1024^3 grid
    with clamping (reference morton_code_30bit, src/instanced-bvh.jl:1189-1200).
    Bit order: x gets the top bit of each triad (x << 2 | y << 1 | z)."""
    p = jnp.asarray(p, jnp.float32)
    side = jnp.float32(1024.0)
    q = jnp.clip(p * side, 0.0, side - 1.0).astype(jnp.uint32)
    return (expand_bits(q[..., 0]) << 2) | (expand_bits(q[..., 1]) << 1) \
        | expand_bits(q[..., 2])


def clz32(x):
    """Count leading zeros of a uint32 (reference clz32; here the hardware
    instruction via lax.clz)."""
    return jax.lax.clz(jnp.asarray(x, jnp.uint32)).astype(jnp.int32)

"""Vectorized 64-bit column hashing.

Role of the reference's per-type hash methods (IColumn::updateHashWithValue /
WeakHash, src/Columns/IColumn.h:297) and the hash used for shard routing and
hash tables.  We use a splitmix64-style finalizer — a strong, multiply/xor
mixer that vectorizes cleanly and is far cheaper than the gather traffic it
feeds.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

__all__ = ["hash64", "hash_combine", "hash_columns", "bucket_of",
           "bitcast_f64_to_u64", "bitcast_u64_to_f64", "sortable_bits",
           "f64_token", "f64_from_token", "f32_token"]

_M1 = jnp.uint64(0xBF58476D1CE4E5B9)
_M2 = jnp.uint64(0x94D049BB133111EB)
_GOLDEN = jnp.uint64(0x9E3779B97F4A7C15)


def hash64(x: jax.Array) -> jax.Array:
    """splitmix64 finalizer over a u64 (or bit-castable) array."""
    z = _to_u64(x)
    z = (z + _GOLDEN).astype(jnp.uint64)
    z = (z ^ (z >> jnp.uint64(30))) * _M1
    z = (z ^ (z >> jnp.uint64(27))) * _M2
    z = z ^ (z >> jnp.uint64(31))
    return z


def bitcast_f64_to_u64(x: jax.Array) -> jax.Array:
    """f64 -> u64 IEEE bit pattern (via two u32 bitcasts, which XLA lowers
    on every backend)."""
    halves = jax.lax.bitcast_convert_type(x, jnp.uint32)  # (..., 2)
    lo = halves[..., 0].astype(jnp.uint64)
    hi = halves[..., 1].astype(jnp.uint64)
    return (hi << jnp.uint64(32)) | lo


def bitcast_u64_to_f64(x: jax.Array) -> jax.Array:
    """Inverse of bitcast_f64_to_u64 (same u32-halves decomposition)."""
    lo = x.astype(jnp.uint32)                      # wrapping: low 32 bits
    hi = (x >> jnp.uint64(32)).astype(jnp.uint32)
    pair = jnp.stack([lo, hi], axis=-1)
    return jax.lax.bitcast_convert_type(pair, jnp.float64)


def _bitcast_u32_to_f32(x: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _order_map32(b: jax.Array) -> jax.Array:
    """IEEE f32 bit pattern (u32) -> u64 whose unsigned order is the float
    total order (negative: flip all bits; positive: set the sign bit)."""
    sign = b >> jnp.uint32(31)
    t = jnp.where(sign == 1, ~b, b | jnp.uint32(0x80000000))
    return t.astype(jnp.uint64)


def _order_unmap32(t: jax.Array) -> jax.Array:
    t = t.astype(jnp.uint32)
    sign = t >> jnp.uint32(31)
    return jnp.where(sign == 1, t & jnp.uint32(0x7FFFFFFF), ~t)


def f64_token(x: jax.Array) -> jax.Array:
    """Total-order injective u64 encoding of an f64 column.

    This is THE device representation of float keys for sorting, grouping,
    joining and hashing (role of the raw 8-byte key in the reference's hash
    tables, src/Columns/ColumnVector.h updateHashWithValue): the exact IEEE
    bit pattern, order-mapped so unsigned-ascending equals the float total
    order.  Every distinct bit pattern is its own key: -0.0 < +0.0 (distinct
    keys, like the reference's byte-keyed hash tables), denormals and
    values beyond the f32 range keep all 53 bits, equal-representation
    NaNs collapse into one key and positive NaNs sort last.
    """
    bits = bitcast_f64_to_u64(x)
    sign = bits >> jnp.uint64(63)
    return jnp.where(sign == 1, ~bits, bits | jnp.uint64(1 << 63))


def f64_from_token(t: jax.Array) -> jax.Array:
    """Inverse of `f64_token` (bit-exact)."""
    sign = t >> jnp.uint64(63)
    bits = jnp.where(sign == 1, t & ~jnp.uint64(1 << 63), ~t)
    return bitcast_u64_to_f64(bits)


def _f32_from_token(t: jax.Array) -> jax.Array:
    return _bitcast_u32_to_f32(_order_unmap32(t >> jnp.uint64(32)))


def f32_token(x: jax.Array) -> jax.Array:
    """f32 counterpart of `f64_token`: the order-mapped 32-bit pattern in
    the high half of a u64 (low half zero)."""
    hb = jax.lax.bitcast_convert_type(x, jnp.uint32)
    return _order_map32(hb) << jnp.uint64(32)


def sortable_bits(x: jax.Array):
    """(encoded, decoder) so float keys sort, group and join as integers.

    The encoding is `f64_token` / `f32_token`: injective (equal tokens <=>
    equal bit patterns, -0.0 and +0.0 distinct, equal-representation NaNs
    collapse into one, matching the reference's byte-keyed hash-table
    GROUP BY / join semantics) and order-preserving.  decoder is None for
    non-floats.
    """
    if x.dtype == jnp.float64:
        return f64_token(x), f64_from_token
    if x.dtype == jnp.float32:
        return f32_token(x), _f32_from_token
    return x, None


def _to_u64(x: jax.Array) -> jax.Array:
    dt = x.dtype
    if dt == jnp.uint64:
        return x
    if dt in (jnp.int64, jnp.int8, jnp.int16, jnp.int32, jnp.uint8,
              jnp.uint16, jnp.uint32, jnp.bool_):
        # Wrapping conversion == bit pattern for signed types.
        return x.astype(jnp.uint64)
    if dt == jnp.float64:
        return f64_token(x)      # injective; see f64_token
    if dt == jnp.float32:
        return f32_token(x)
    raise TypeError(f"hash64: unsupported dtype {dt}")


def hash_combine(h: jax.Array, x: jax.Array) -> jax.Array:
    """Order-dependent combiner (boost-style): h' = mix(h ^ (x + c + h<<6 + h>>2))."""
    x = hash64(x)
    return hash64(h ^ (x + _GOLDEN + (h << jnp.uint64(6)) + (h >> jnp.uint64(2))))


def hash_columns(arrays: Sequence[jax.Array]) -> jax.Array:
    """One u64 hash per row over multiple key columns."""
    assert arrays, "hash_columns requires at least one column"
    h = hash64(arrays[0])
    for a in arrays[1:]:
        h = hash_combine(h, a)
    return h


def bucket_of(h: jax.Array, num_buckets: int) -> jax.Array:
    """Exchange bucket = high hash bits (the reference's two-level convention:
    TwoLevelHashTable.h:32 selects sub-table by high bits)."""
    assert num_buckets & (num_buckets - 1) == 0, "num_buckets must be a power of 2"
    shift = jnp.uint64(64 - num_buckets.bit_length() + 1)
    return (h >> shift).astype(jnp.int32)

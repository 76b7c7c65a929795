"""ORDER BY / LIMIT kernels.

Replaces the reference's three-stage sort (PartialSortingTransform ->
MergeSortingTransform -> MergingSortedTransform, SortingStep.cpp:208-463) with
single large device sorts: XLA's device sort is already a multi-pass
network over the whole array, so the reference's block/merge staging
collapses into one `lax.sort` over the whole (padded) column set.  Top-N uses `lax.top_k`
on an order-encoded key when the key fits 64 bits (the reference's special
top-N row-filter path, SortingStep.cpp:339).

Order encoding: every sort key column is mapped to a u64 *token* whose
unsigned order equals the desired row order (direction + NULL placement
folded in) — the device analog of comparator dispatch in sortBlock
(src/Interpreters/sortBlock.cpp:336).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = ["order_token", "sort_permutation", "topk_permutation",
           "topk_key32", "topk_permutation32"]


def order_token(x: jax.Array, *, descending: bool = False,
                validity: Optional[jax.Array] = None,
                nulls_last: bool = True,
                rank: Optional[jax.Array] = None) -> jax.Array:
    """Monotone map of a column into u64 so unsigned-ascending == desired order.

    rank -- optional precomputed i32/i64 ordering rank (used for dictionary
            strings, where codes are not ordered after merges: host computes
            dictionary ranks, device gathers them here).
    """
    if rank is not None:
        x = rank
    dt = x.dtype
    if dt in (jnp.float64, jnp.float32):
        # f64_token/f32_token are total-order maps of the IEEE bits already
        from .hash_ops import f32_token, f64_token
        tok = f64_token(x) if dt == jnp.float64 else f32_token(x)
    elif dt == jnp.uint64:
        tok = x
    elif dt == jnp.bool_:
        tok = x.astype(jnp.uint64)
    elif jnp.issubdtype(dt, jnp.unsignedinteger):
        tok = x.astype(jnp.uint64)
    else:  # signed ints: wrapping cast keeps the bit pattern; flip sign bit
        tok = x.astype(jnp.int64).astype(jnp.uint64) ^ jnp.uint64(1 << 63)
    if descending:
        tok = ~tok
    if validity is not None:
        null_tok = jnp.uint64(2**64 - 1) if nulls_last else jnp.uint64(0)
        # Reserve the extreme value; shift real tokens inward by one to avoid
        # collision with the sentinel.
        tok = jnp.where(nulls_last, jnp.minimum(tok, jnp.uint64(2**64 - 2)),
                        jnp.maximum(tok, jnp.uint64(1)))
        tok = jnp.where(validity.astype(jnp.bool_), tok, null_tok)
    return tok


def sort_permutation(tokens: Sequence[jax.Array], row_valid: jax.Array
                     ) -> jax.Array:
    """Permutation sorting rows by the token columns; padding rows sink last."""
    cap = tokens[0].shape[0]
    rowid = jnp.arange(cap, dtype=jnp.int32)
    invalid = jnp.logical_not(row_valid)
    sorted_ops = jax.lax.sort([invalid] + list(tokens) + [rowid],
                              num_keys=1 + len(tokens), is_stable=True)
    return sorted_ops[-1]


def topk_key32(cv, descending: bool) -> Optional[jax.Array]:
    """u32 order key (unsigned-ascending == desired order) when the sort
    value provably fits 32 bits: f32 expressions and <=32-bit integer
    storage.  None otherwise (and for nullable columns — NULL ordering
    needs the u64 sentinel).  Feeds the lax.top_k fast path."""
    if cv.validity is not None or cv.dictionary is not None:
        return None
    x = cv.data
    dt_ = x.dtype
    if dt_ == jnp.float32:
        from .hash_ops import _order_map32
        key = _order_map32(jax.lax.bitcast_convert_type(
            x, jnp.uint32)).astype(jnp.uint32)
    elif dt_ == jnp.bool_:
        key = x.astype(jnp.uint32)
    elif jnp.issubdtype(dt_, jnp.unsignedinteger) and x.dtype.itemsize <= 4:
        key = x.astype(jnp.uint32)
    elif jnp.issubdtype(dt_, jnp.signedinteger) and x.dtype.itemsize <= 4:
        key = jax.lax.bitcast_convert_type(
            x.astype(jnp.int32), jnp.uint32) ^ jnp.uint32(1 << 31)
    elif jnp.issubdtype(dt_, jnp.integer) \
            and getattr(cv, "bounds", None) is not None \
            and int(cv.bounds[1]) - int(cv.bounds[0]) < 2**32 - 1:
        # wide storage but interval analysis proves a 32-bit span: shift
        # into u32 (the scan carries part-minmax bounds)
        key = (x.astype(jnp.int64)
               - jnp.int64(int(cv.bounds[0]))).astype(jnp.uint32)
    else:
        return None
    if descending:
        key = ~key
    return key


def topk_permutation32(key32: jax.Array, row_valid: jax.Array, k: int
                       ) -> jax.Array:
    """Indices of the k smallest u32 keys among valid rows via tiled
    lax.top_k — one specialized selection pass instead of full tile
    sorts (the Q8/Q3 lever; same clamp-the-extreme discipline as
    order_token's NULL sentinel)."""
    n = key32.shape[0]
    k32 = jnp.minimum(key32, jnp.uint32(2**32 - 2))
    k32 = jnp.where(row_valid.astype(jnp.bool_), k32,
                    jnp.uint32(2**32 - 1))
    # top_k takes LARGEST: complement, then map u32 order onto i32 order
    ikey = jax.lax.bitcast_convert_type(
        (~k32) ^ jnp.uint32(1 << 31), jnp.int32)
    CH = 16384
    pad = (-n) % CH
    if pad:
        ikey = jnp.concatenate(
            [ikey, jnp.full((pad,), -(2**31), jnp.int32)])
    rows = ikey.shape[0] // CH
    kk = min(k, CH)
    v2, i2 = jax.lax.top_k(ikey.reshape(rows, CH), kk)
    flat_v = v2.reshape(-1)
    flat_i = (i2.astype(jnp.int32)
              + (jnp.arange(rows, dtype=jnp.int32) * CH)[:, None]
              ).reshape(-1)
    _, i3 = jax.lax.top_k(flat_v, min(k, flat_v.shape[0]))
    out = flat_i[i3]
    return jnp.minimum(out, n - 1)


def topk_permutation(token: jax.Array, row_valid: jax.Array, k: int
                     ) -> jax.Array:
    """Indices of the k smallest tokens among valid rows (ascending order).

    Single-token fast path for `ORDER BY ... LIMIT k` (k << n).  Large
    inputs use a hierarchical two-level selection (per-chunk sort-and-take,
    then combine), avoiding the flat full-length sort.

    Validity is a SEPARATE sort key, never folded into the token: tokens
    legitimately occupy the full u64 range (a DESC UInt64 value 0 and a
    NULLS-LAST null both map to 2^64-1), so any clamp/bias scheme that makes
    room for a padding sentinel inside 64 bits collides two real values.
    The original index is a third key so ties resolve deterministically
    (first-occurrence order, matching stable sort_permutation).
    """
    n = token.shape[0]
    invalid = jnp.logical_not(row_valid)
    rowid = jnp.arange(n, dtype=jnp.int32)
    CHUNK = 8192
    if n >= (1 << 20) and k <= CHUNK:
        pad = (-n) % CHUNK
        if pad:
            token = jnp.concatenate(
                [token, jnp.full((pad,), 2**64 - 1, jnp.uint64)])
            invalid = jnp.concatenate(
                [invalid, jnp.ones((pad,), jnp.bool_)])
            # Padding indices point at row 0; rows past the valid count are
            # masked by the caller, so the value never surfaces.
            rowid = jnp.concatenate([rowid, jnp.zeros((pad,), jnp.int32)])
        rows = token.shape[0] // CHUNK
        inv2 = invalid.reshape(rows, CHUNK)
        tok2 = token.reshape(rows, CHUNK)
        id2 = rowid.reshape(rows, CHUNK)
        s_inv, s_tok, s_id = jax.lax.sort(
            [inv2, tok2, id2], num_keys=3, is_stable=False)
        kk = min(k, CHUNK)
        cand = [s_inv[:, :kk].reshape(-1), s_tok[:, :kk].reshape(-1),
                s_id[:, :kk].reshape(-1)]
        f = jax.lax.sort(cand, num_keys=3, is_stable=False)
        return f[2][:k]
    s = jax.lax.sort([invalid, token, rowid], num_keys=3, is_stable=False)
    return s[2][:k]

"""Vectorized searchsorted: binary search or a two-sort merge.

`jnp.searchsorted`'s default binary search does len(v) * log2(len(a))
data-dependent gathers.  For large query sets `searchsorted_via_sort`
computes the same answer as a two-sort merge (the classic sort-join
formulation, cf. the reference's sortedness-exploiting joins in
MergeJoinTransform), with no random access at all:

  1. sort concat(a, v) with a tie-flag so queries land on the correct side
     of equal table entries; the answer for each query is the number of
     table entries before it (a cumsum, not a gather);
  2. sort back by original position to restore query order.

Which of the two is faster depends on the device and the sizes, so the
threshold below is a tuning choice, not an invariant.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["searchsorted", "searchsorted_via_sort", "searchsorted_seg"]

# Below this many queries the O(N log G) binary search wins (sort cost is
# O(N + G) but with a bigger constant and a compile-time hit).
_SORT_MIN_QUERIES = 1 << 18


def searchsorted_via_sort(a: jax.Array, v: jax.Array, side: str = "left"
                          ) -> jax.Array:
    """Two-sort merge searchsorted; returns int32 indices into `a`."""
    G = a.shape[0]
    N = v.shape[0]
    cd = jnp.promote_types(a.dtype, v.dtype)
    key = jnp.concatenate([a.astype(cd), v.astype(cd)])
    # side='left': queries sort BEFORE equal table entries (table flag 1);
    # side='right': after (table flag 0).  Within an equal-(key, flag) run
    # all queries see the same table-entry count, so stability is irrelevant.
    tflag = jnp.bool_(side == "left")
    flag = jnp.concatenate([jnp.full((G,), tflag),
                            jnp.full((N,), ~tflag)])
    idx = jnp.arange(G + N, dtype=jnp.int32)
    _, _, idx_s = jax.lax.sort([key, flag, idx], num_keys=2, is_stable=False)
    is_table = (idx_s < G).astype(jnp.int32)
    before = jnp.cumsum(is_table) - is_table          # exclusive count
    _, res = jax.lax.sort([idx_s, before], num_keys=1, is_stable=False)
    return res[G:]


def searchsorted_seg(seg: jax.Array, key: jax.Array, qseg: jax.Array,
                     qkey: jax.Array, side: str = "left") -> jax.Array:
    """Two-key merge searchsorted: position of each (qseg, qkey) query in an
    array sorted lexicographically by (seg, key).  Returns the GLOBAL index
    (int32) — for segmented data the result lands inside the query's
    segment.  Used by RANGE OFFSET window frames (the reference walks peers
    sequentially, src/Processors/Transforms/WindowTransform.cpp:695; here
    every row's frame boundary is found in one merge)."""
    G = seg.shape[0]
    N = qseg.shape[0]
    sd = jnp.promote_types(seg.dtype, qseg.dtype)
    kd = jnp.promote_types(key.dtype, qkey.dtype)
    s = jnp.concatenate([seg.astype(sd), qseg.astype(sd)])
    k = jnp.concatenate([key.astype(kd), qkey.astype(kd)])
    tflag = jnp.bool_(side == "left")
    flag = jnp.concatenate([jnp.full((G,), tflag), jnp.full((N,), ~tflag)])
    idx = jnp.arange(G + N, dtype=jnp.int32)
    _, _, _, idx_s = jax.lax.sort([s, k, flag, idx], num_keys=3,
                                  is_stable=False)
    is_table = (idx_s < G).astype(jnp.int32)
    before = jnp.cumsum(is_table) - is_table
    _, res = jax.lax.sort([idx_s, before], num_keys=1, is_stable=False)
    return res[G:]


def searchsorted(a: jax.Array, v: jax.Array, side: str = "left") -> jax.Array:
    """Drop-in for jnp.searchsorted(a, v, side): the two-sort merge for
    large integer query sets, binary search otherwise.

    Returns int32 (all call sites index arrays < 2^31 rows).
    """
    if (v.ndim == 1 and v.shape[0] >= _SORT_MIN_QUERIES
            and not jnp.issubdtype(a.dtype, jnp.floating)
            and not jnp.issubdtype(v.dtype, jnp.floating)):
        return searchsorted_via_sort(a, v, side)
    return jnp.searchsorted(a, v, side=side).astype(jnp.int32)

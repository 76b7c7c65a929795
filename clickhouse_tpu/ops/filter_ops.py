"""Filter: predicate mask -> compacted block.

Replacement for FilterTransform + IColumn::filter
(src/Processors/Transforms/FilterTransform.cpp:128, SIMD compaction loops at
src/Columns/ColumnsCommon.cpp:145-235).  Output capacity equals input capacity
(static shapes); the surviving-row count is a device scalar — no host sync on
the hot path (SURVEY.md §7 "Dynamic shapes").
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import search

__all__ = ["gather_compaction_indices", "compact_arrays", "count_mask"]


def count_mask(mask: jax.Array) -> jax.Array:
    """Number of selected rows (device scalar, int64)."""
    return jnp.sum(mask.astype(jnp.int64))


def gather_compaction_indices(mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Source row index for each output slot of a stream compaction.

    Returns (src_idx, count): output slot j takes input row src_idx[j]
    (garbage for j >= count).  Gather-only formulation: the usual
    scatter-compaction is inverted into "for output j, binary-search the
    j-th set bit" (cumsum + searchsorted).
    """
    c = jnp.cumsum(mask.astype(jnp.int64))
    count = c[-1]
    cap = mask.shape[0]
    j = jnp.arange(cap, dtype=jnp.int64)
    src = search.searchsorted(c, j + 1, side="left")
    return jnp.clip(src, 0, cap - 1).astype(jnp.int32), count


def compact_arrays(arrays: Sequence[jax.Array], mask: jax.Array
                   ) -> Tuple[list, jax.Array]:
    """Compact each array by the mask into the leading slots (gather-based).

    Slots beyond count hold repeated garbage; consumers must respect count.
    """
    src, count = gather_compaction_indices(mask)
    return [a[src] for a in arrays], count

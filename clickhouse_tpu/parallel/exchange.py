"""Repartitioning exchange over the device mesh.

The device-mesh replacement for the reference's TCP scatter/gather data plane
(RemoteQueryExecutor + DistributedSink, SURVEY.md §2.7): rows move between
shards as an XLA `all_to_all` between devices, routed by key hash — the same role
the 256-bucket two-level aggregation convention plays in the reference's
memory-efficient distributed merge (MergingAggregatedMemoryEfficientTransform).

All shapes are static: each shard packs its outgoing rows into a fixed
(n_shards, capacity) send buffer; overflow is detected via a returned count.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..ops import hash_ops

__all__ = ["exchange_by_key", "all_gather_rows", "psum_scalar"]


def exchange_by_key(keys: Sequence[jax.Array], payloads: Sequence[jax.Array],
                    valid: jax.Array, axis_name: str, n_shards: int,
                    send_capacity: int,
                    salt: Optional[jax.Array] = None, salt_mod: int = 1
                    ) -> Tuple[List[jax.Array], List[jax.Array], jax.Array,
                               jax.Array]:
    """Route rows to shards by key hash; returns received rows.

    keys/payloads -- per-row arrays (local capacity,)
    valid         -- bool mask of live local rows
    send_capacity -- max rows this shard may send to ONE destination
    salt/salt_mod -- salted-key skew splitting (BASELINE requirement; the
        reference's heavy-hitter answer is two-level bucketed state,
        src/Common/HashTable/TwoLevelHashTable.h:32).  With salt_mod = S
        (must divide n_shards), the key hash picks one of n_shards/S shard
        GROUPS and the per-row ``salt`` (in 0..S-1) picks the shard within
        the group — a hot key's rows spread across S shards instead of
        serializing on one.

    Returns (keys_rx, payloads_rx, valid_rx, overflow) where the received
    arrays have capacity n_shards*send_capacity and overflow is a device
    scalar: max rows any destination needed (must be <= send_capacity).
    """
    cap = keys[0].shape[0]
    h = hash_ops.hash_columns(list(keys))
    if salt_mod > 1 and salt is not None:
        assert n_shards % salt_mod == 0, "salt_mod must divide n_shards"
        groups = n_shards // salt_mod
        base = (h % jnp.uint64(groups)).astype(jnp.int32) * salt_mod
        dest = base + (salt.astype(jnp.int32) % salt_mod)
    else:
        dest = (h % jnp.uint64(n_shards)).astype(jnp.int32)
    dest = jnp.where(valid, dest, n_shards)          # padding -> dropped

    # Stable-sort rows by destination, then fill each destination's block of
    # the send buffer by GATHERING from the sorted order (the inverse
    # mapping slot -> sorted row is direct).
    rowid = jnp.arange(cap, dtype=jnp.int32)
    dest_s, row_s = jax.lax.sort([dest, rowid], num_keys=1, is_stable=True)
    # per-dest row ranges via binary search over the sorted destinations
    d = jnp.arange(n_shards, dtype=dest_s.dtype)
    starts = jnp.searchsorted(dest_s, d, side="left").astype(jnp.int64)
    ends = jnp.searchsorted(dest_s, d, side="right").astype(jnp.int64)
    counts = ends - starts
    overflow = jnp.max(counts)

    flat_cap = n_shards * send_capacity
    slot_dest = (jnp.arange(flat_cap, dtype=jnp.int64) // send_capacity)
    slot_pos = jnp.arange(flat_cap, dtype=jnp.int64) % send_capacity
    src_idx = jnp.clip(starts[slot_dest] + slot_pos, 0, cap - 1)
    slot_live = slot_pos < counts[slot_dest]

    def pack(arr):
        src = arr[row_s][src_idx]
        live = slot_live if src.ndim == 1 else slot_live[:, None]
        src = jnp.where(live, src, jnp.zeros((), src.dtype))
        # trailing state-width axes (2D sketch states) ride along untouched
        return src.reshape((n_shards, send_capacity) + src.shape[1:])

    sent_valid = slot_live.reshape(n_shards, send_capacity)

    keys_tx = [pack(k) for k in keys]
    payloads_tx = [pack(p) for p in payloads]

    def a2a(x):
        return jax.lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0,
                                  tiled=False)

    keys_rx = [a2a(k).reshape(flat_cap) for k in keys_tx]
    payloads_rx = [a2a(p).reshape((flat_cap,) + p.shape[2:])
                   for p in payloads_tx]
    valid_rx = a2a(sent_valid).reshape(flat_cap)
    return keys_rx, payloads_rx, valid_rx, overflow


def all_gather_rows(arrays: Sequence[jax.Array], valid: jax.Array,
                    axis_name: str) -> Tuple[List[jax.Array], jax.Array]:
    """Replicate all shards' rows everywhere (broadcast-join/gather path)."""
    out = [jax.lax.all_gather(a, axis_name, axis=0, tiled=True)
           for a in arrays]
    v = jax.lax.all_gather(valid, axis_name, axis=0, tiled=True)
    return out, v


def psum_scalar(x: jax.Array, axis_name: str) -> jax.Array:
    return jax.lax.psum(x, axis_name)

"""Grouping machinery: sort-based, dense direct-array, and trivial GROUP BY.

Replacement for the reference Aggregator's 143 hash-table variants
(src/Interpreters/Aggregator.h:71, AggregatedDataVariants.h:20-137).  Three
grouping kinds, all scatter-free (see scan_ops.py):

  * sort    -- generic: multi-operand device sort, segment boundaries,
               reductions via segmented scans + searchsorted gathers;
  * dense   -- provably-small key space (interval analysis): slot computed
               from the key; sum/count reductions as one-hot matmuls
               (mxu_segsum.py) — the FixedHashMap analog;
  * trivial -- GROUP BY (): plain masked whole-array reductions
               (Aggregator::executeWithoutKey analog).

The mergeable-state algebra (reference: IAggregateFunction::merge +
WithMergeableState) is preserved: states are ordinary columns; the
distributed two-stage aggregation re-groups and merges them after an
all_to_all keyed by bucket.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import hash_ops, mxu_segsum, scan_ops

__all__ = ["Grouping", "group_by_sort", "group_by_dense", "group_trivial"]


@dataclasses.dataclass
class Grouping:
    """Dense group-id assignment for each (valid) row.

    kind='sort':   rows are key-sorted; group_ids ascending dense ranks;
                   perm maps sorted position -> original row.
    kind='dense':  slot is a function of the key; rows keep original order
                   (perm=None); empty slots possible (`present` mask).
    kind='trivial': single global group at slot 0.

    group_ids carry num_groups_cap for padding/invalid rows (dropped by all
    reductions).
    """
    kind: str
    group_ids: jax.Array              # int32, in sorted order for 'sort'
    num_groups: jax.Array             # int64 device scalar
    unique_keys: List[jax.Array]      # each (num_groups_cap,)
    num_groups_cap: int
    perm: Optional[jax.Array] = None  # int32 (sort only)
    boundary: Optional[jax.Array] = None   # bool, sorted order (sort only)
    starts: Optional[jax.Array] = None     # (cap_g,) int64 (sort only)
    ends: Optional[jax.Array] = None       # (cap_g,) int64 (sort only)
    present: Optional[jax.Array] = None    # (cap_g,) bool (dense only)
    # the row_valid the grouping was built with (identity-checked fast paths)
    row_valid_ref: Optional[jax.Array] = None
    # payload registry: arrays already carried into sorted order (trace-time
    # identity cache; raw refs are held so ids stay unique)
    payload_raw: list = dataclasses.field(default_factory=list)
    payload_sorted: list = dataclasses.field(default_factory=list)
    _inv_perm: Optional[jax.Array] = None

    # -- row-order plumbing --------------------------------------------------
    def take(self, array: jax.Array) -> jax.Array:
        """Raw row order -> the grouping's working (sorted) order.

        Registered payloads (carried through the grouping sort) are free;
        everything else is permuted.  Large arrays permute via a 2-operand
        sort by the inverse permutation: a streaming sort instead of a
        random gather x[perm] from ~2^18 rows.
        Results are cached by identity (one permute per distinct array).
        """
        if self.perm is None:
            return array
        for r, s in zip(self.payload_raw, self.payload_sorted):
            if array is r:
                return s
        if array.shape[0] >= (1 << 18):
            if self._inv_perm is None:
                cap = self.perm.shape[0]
                _, self._inv_perm = jax.lax.sort(
                    [self.perm, jnp.arange(cap, dtype=jnp.int32)],
                    num_keys=1, is_stable=False)
            enc, dec = hash_ops.sortable_bits(array)
            _, s = jax.lax.sort([self._inv_perm, enc], num_keys=1,
                                is_stable=False)
            if dec is not None:
                s = dec(s)
        else:
            s = array[self.perm]
        self.payload_raw.append(array)
        self.payload_sorted.append(s)
        return s

    def group_valid(self) -> jax.Array:
        if self.present is not None:
            return self.present
        return jnp.arange(self.num_groups_cap, dtype=jnp.int64) \
            < self.num_groups

    # -- reductions ----------------------------------------------------------
    def reduce(self, op: str, data_raw: jax.Array, mask_raw: jax.Array,
               value_bounds=None) -> jax.Array:
        """Per-group reduction; data/mask in RAW row order."""
        mask = self.take(mask_raw) if mask_raw is not None else None
        return self.reduce_sorted(op, self.take(data_raw), mask, value_bounds)

    def reduce_sorted(self, op: str, data: jax.Array, mask: jax.Array,
                      value_bounds=None) -> jax.Array:
        """Per-group reduction; data/mask already in working order."""
        if self.kind == "trivial":
            return self._reduce_trivial(op, data, mask)
        if self.kind == "dense":
            return self._reduce_dense(op, data, mask, value_bounds)
        return scan_ops.seg_reduce_sorted(
            op, data, self.group_ids, self.boundary, self.starts, self.ends,
            self.num_groups_cap, mask_sorted=mask)

    def count_rows(self, mask_raw: jax.Array) -> jax.Array:
        """Rows per group (int64)."""
        if self.kind == "dense":
            return self.dense_counts(mask_raw)
        if self.kind == "sort" and mask_raw is self.row_valid_ref:
            # the grouping already segregated exactly these rows: counts are
            # segment extents — no pass over the data (5.9s -> 0 at 100M)
            return self.ends - self.starts
        # sum the mask itself (no ones column to permute)
        return self.reduce_sorted("sum", self.take(mask_raw), None)

    def _reduce_trivial(self, op, data, mask):
        cap_g = self.num_groups_cap
        if mask is None:
            mask = jnp.ones(data.shape, jnp.bool_)
        if op == "sum":
            acc = data
            if acc.dtype in (jnp.int8, jnp.int16, jnp.int32, jnp.bool_):
                acc = acc.astype(jnp.int64)
            elif acc.dtype in (jnp.uint8, jnp.uint16, jnp.uint32):
                acc = acc.astype(jnp.uint64)
            elif acc.dtype == jnp.float32:
                acc = acc.astype(jnp.float64)
            v = jnp.sum(jnp.where(mask, acc, jnp.zeros((), acc.dtype)))
        elif op in ("min", "max"):
            if jnp.issubdtype(data.dtype, jnp.integer) \
                    or data.dtype == jnp.bool_:
                ident = (jnp.iinfo(data.dtype).max if op == "min"
                         else jnp.iinfo(data.dtype).min)
                ident = jnp.asarray(ident, data.dtype)
            else:
                ident = jnp.asarray(jnp.inf if op == "min" else -jnp.inf,
                                    data.dtype)
            fn = jnp.min if op == "min" else jnp.max
            v = fn(jnp.where(mask, data, ident))
            v = jnp.where(jnp.any(mask), v, jnp.zeros((), data.dtype))
        elif op == "any":
            # first masked-in value: argmax of mask is the first True
            idx = jnp.argmax(mask)
            v = jnp.where(jnp.any(mask), data[idx],
                          jnp.zeros((), data.dtype))
        elif op in ("bor", "band", "bxor"):
            fn = {"bor": jnp.bitwise_or, "band": jnp.bitwise_and,
                  "bxor": jnp.bitwise_xor}[op]
            ident = jnp.zeros((), data.dtype)
            if op == "band":
                ident = ~ident
            acc = jnp.where(mask, data, ident)
            v = jax.lax.reduce(acc, ident, fn, (0,))
            v = jnp.where(jnp.any(mask), v, jnp.zeros((), data.dtype))
        else:
            raise ValueError(op)
        out = jnp.zeros((cap_g,), v.dtype)
        return out.at[0].set(v)      # static index: dynamic-update-slice

    def _reduce_dense(self, op, data, mask, value_bounds=None):
        if op != "sum":
            raise ValueError(f"dense grouping cannot reduce '{op}'")
        ids = jnp.minimum(self.group_ids, self.num_groups_cap - 1)
        m = mask & (self.group_ids < self.num_groups_cap)
        signed = not jnp.issubdtype(data.dtype, jnp.unsignedinteger)
        if not jnp.issubdtype(data.dtype, jnp.integer):
            if data.dtype == jnp.bool_:
                data = data.astype(jnp.int64)
                signed = True
                value_bounds = (0, 1)
            else:
                raise ValueError("dense grouping sums integers only")
        counts, sums = mxu_segsum.mxu_counts_and_sums(
            ids, m, [(data, signed)], self.num_groups_cap, [value_bounds])
        return sums[0]

    def dense_counts(self, mask) -> jax.Array:
        ids = jnp.minimum(self.group_ids, self.num_groups_cap - 1)
        m = mask & (self.group_ids < self.num_groups_cap)
        counts, _ = mxu_segsum.mxu_counts_and_sums(
            ids, m, [], self.num_groups_cap)
        return counts


def group_by_sort(keys: Sequence[jax.Array], row_valid: jax.Array,
                  num_groups_cap: int,
                  secondary: Sequence[jax.Array] = (),
                  payloads: Sequence[jax.Array] = ()) -> Grouping:
    """Generic grouping via multi-operand sort (scatter-free throughout).

    keys      -- storage arrays of the GROUP BY columns
    row_valid -- bool mask (False rows excluded, sink to the end)
    secondary -- extra sort operands ordering rows *within* groups without
                 affecting boundaries (holistic aggregates)
    payloads  -- arrays carried into sorted order for free (registered so
                 later Grouping.take of the same array costs nothing: one
                 extra sort operand instead of a random gather)
    """
    cap = keys[0].shape[0]
    rowid = jnp.arange(cap, dtype=jnp.int32)
    invalid = jnp.logical_not(row_valid)
    # floats enter the sort as order-mapped bit patterns (exact key
    # equality, -0.0 != +0.0) and are decoded on the way out
    encoded, decoders = [], []
    for a in list(keys) + list(secondary) + list(payloads):
        enc, dec = hash_ops.sortable_bits(a)
        encoded.append(enc)
        decoders.append(dec)
    operands = [invalid] + encoded[:len(keys) + len(secondary)] + [rowid] \
        + encoded[len(keys) + len(secondary):]
    nk = 1 + len(keys) + len(secondary)
    sorted_ops = jax.lax.sort(operands, num_keys=nk, is_stable=True)
    inv_s = sorted_ops[0]
    perm = sorted_ops[nk]
    outs = list(sorted_ops[1:nk]) + list(sorted_ops[nk + 1:])
    outs = [o if d is None else d(o) for o, d in zip(outs, decoders)]
    keys_s = outs[:len(keys)]
    payload_raw = [row_valid] + list(secondary) + list(payloads)
    payload_sorted = [jnp.logical_not(inv_s)] + outs[len(keys):]

    # boundaries compare the ENCODED keys: bit equality is total (NaN keys
    # form one group; float != would split every NaN into its own group)
    boundary = jnp.zeros(cap, dtype=jnp.bool_).at[0].set(True)
    for ks in sorted_ops[1:1 + len(keys)]:
        boundary = boundary | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), ks[1:] != ks[:-1]])
    boundary = boundary | jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), inv_s[1:] != inv_s[:-1]])

    gid = jnp.cumsum(boundary.astype(jnp.int32)) - 1
    valid_s = jnp.logical_not(inv_s)
    num_groups = jnp.max(jnp.where(valid_s, gid, -1)).astype(jnp.int64) + 1
    gid = jnp.where(valid_s, gid, num_groups_cap)

    starts, ends = scan_ops.segment_starts_ends_dense(gid, num_groups_cap)
    first_row = jnp.clip(starts, 0, cap - 1)
    unique_keys = [ks[first_row] for ks in keys_s]
    return Grouping(kind="sort", group_ids=gid, num_groups=num_groups,
                    unique_keys=unique_keys, num_groups_cap=num_groups_cap,
                    perm=perm, boundary=boundary, starts=starts, ends=ends,
                    row_valid_ref=row_valid, payload_raw=payload_raw,
                    payload_sorted=payload_sorted)


def group_by_dense(keys: Sequence[jax.Array],
                   dims: Sequence[Tuple[int, int]],
                   row_valid: jax.Array, num_groups_cap: int,
                   present: Optional[jax.Array] = None) -> Grouping:
    """Direct-array grouping: slot computed from the key, no sort, no scatter.

    dims[i] = (lo_i, size_i) proven bounds per key array (interval analysis;
    the generalized FixedHashMap dispatch).  `present`/num_groups are filled
    in by the caller from the (always computed) dense counts.
    """
    cap = keys[0].shape[0]
    slot = jnp.zeros((cap,), jnp.int64)
    stride = 1
    total = 1
    for k, (lo, size) in zip(keys, dims):
        d = jnp.clip(k.astype(jnp.int64) - lo, 0, size - 1)
        slot = slot + d * stride
        stride *= size
        total *= size
    assert total <= num_groups_cap, "dense grouping exceeds capacity"
    ids = jnp.where(row_valid, slot, num_groups_cap).astype(jnp.int32)
    uks = []
    idx = jnp.arange(num_groups_cap, dtype=jnp.int64)
    stride = 1
    for k, (lo, size) in zip(keys, dims):
        uks.append(((idx // stride) % size + lo).astype(k.dtype))
        stride *= size
    if present is None:
        present = jnp.zeros((num_groups_cap,), jnp.bool_)
    return Grouping(kind="dense", group_ids=ids,
                    num_groups=jnp.sum(present.astype(jnp.int64)),
                    unique_keys=uks, num_groups_cap=num_groups_cap,
                    present=present)


def group_trivial(row_valid: jax.Array, num_groups_cap: int = 1024
                  ) -> Grouping:
    """GROUP BY (): one global group, plain masked reductions."""
    cap = row_valid.shape[0]
    gid = jnp.where(row_valid, 0, num_groups_cap).astype(jnp.int32)
    num_groups = jnp.any(row_valid).astype(jnp.int64)
    uk = jnp.zeros((num_groups_cap,), jnp.int32)
    return Grouping(kind="trivial", group_ids=gid, num_groups=num_groups,
                    unique_keys=[uk], num_groups_cap=num_groups_cap)

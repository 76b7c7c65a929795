"""Scatter-free segment reductions over key-sorted rows.

The engine does not scatter on hot paths: after the rows are key-sorted,
every per-group reduction becomes:

  * sums: plain cumsum + boundary differences (exact modulo 2^64 for
    integers; for floats XLA's native log-depth prefix sum behaves like
    pairwise summation — per-group error ~log2(n)*eps of the running
    prefix, far tighter than naive sequential accumulation over 100M rows);
  * min/max/any: ONE extra sort of (group_id, order_token) pairs, then the
    per-group extremum sits at the segment head/tail — picked by small
    gathers at starts/ends;
  * group start positions via merge-searchsorted on the sorted group-id
    array (ops/search.py).

`lax.associative_scan` is deliberately absent: over ~33M-element operands it
is costly to compile, so every reduction here lowers to native
sort/cumsum/cummax primitives only.  (running_reduce — the
window-function path — still uses associative_scan; window partitions are
far smaller than GROUP BY inputs.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from . import search, sort_ops

__all__ = ["segment_starts_ends", "segment_starts_ends_dense",
           "seg_reduce_sorted", "running_reduce"]


def segment_starts_ends(group_ids_sorted: jax.Array, num_groups_cap: int
                        ) -> Tuple[jax.Array, jax.Array]:
    """starts[g], ends[g): row range of group g in sorted order (gather-only).

    group_ids_sorted must be ascending *integers* with padding rows at the
    end carrying id >= num_groups_cap.  Empty groups get starts==ends.
    One searchsorted suffices: for integer ids count(x <= g-1) == count(x < g),
    so starts[g] = ends[g-1] exactly.
    """
    g = jnp.arange(num_groups_cap, dtype=group_ids_sorted.dtype)
    ends = search.searchsorted(group_ids_sorted, g, side="right") \
        .astype(jnp.int64)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int64), ends[:-1]])
    return starts, ends


def segment_starts_ends_dense(group_ids_sorted: jax.Array,
                              num_groups_cap: int
                              ) -> Tuple[jax.Array, jax.Array]:
    """segment_starts_ends for DENSE ascending rank ids (0..num_groups-1
    with no holes, padding >= num_groups_cap) — the shape group_by_sort
    emits.  One small 2-operand sort replaces the 100M-row merge
    searchsorted: each group's first-row position sorts directly into its
    rank slot (ranks are unique), and ends[g] = starts[g+1] — no scatter
    over all rows and no binary search per row."""
    n = group_ids_sorted.shape[0]
    gid = group_ids_sorted
    boundary = jnp.concatenate([jnp.ones((1,), jnp.bool_),
                                gid[1:] != gid[:-1]])
    in_range = gid.astype(jnp.int64) < num_groups_cap
    key = jnp.where(boundary & in_range, gid.astype(jnp.int32),
                    jnp.int32(num_groups_cap))
    pos = jnp.arange(n, dtype=jnp.int32)
    _, bpos = jax.lax.sort([key, pos], num_keys=1, is_stable=False)
    starts_raw = bpos[:num_groups_cap].astype(jnp.int64) if \
        n >= num_groups_cap else jnp.concatenate(
            [bpos.astype(jnp.int64),
             jnp.zeros((num_groups_cap - n,), jnp.int64)])
    n_valid = jnp.sum(in_range.astype(jnp.int64))
    num_groups = jnp.max(jnp.where(in_range, gid.astype(jnp.int64), -1)) + 1
    slots = jnp.arange(num_groups_cap, dtype=jnp.int64)
    starts = jnp.where(slots < num_groups, starts_raw, n_valid)
    ends = jnp.concatenate([starts[1:], jnp.full((1,), 0, jnp.int64)])
    ends = jnp.where(slots < num_groups - 1, ends, n_valid)
    ends = jnp.where(slots < num_groups, ends, n_valid)
    return starts, ends


def _segmented_scan(op, data: jax.Array, boundary: jax.Array) -> jax.Array:
    """Inclusive segmented scan: combine resets at rows where boundary=True."""
    flags = boundary.astype(jnp.bool_)

    def combine(a, b):
        av, af = a
        bv, bf = b
        v = jnp.where(bf, bv, op(av, bv))
        return v, af | bf

    out, _ = jax.lax.associative_scan(combine, (data, flags))
    return out


def running_reduce(op: str, data: jax.Array, boundary: jax.Array,
                   mask: Optional[jax.Array] = None) -> jax.Array:
    """Per-row inclusive running reduction within segments (window frames:
    UNBOUNDED PRECEDING .. CURRENT ROW).  Masked rows pass the carry through.

    op: sum | min | max | first | last
    """
    if op == "sum":
        acc = data
        if acc.dtype in (jnp.int8, jnp.int16, jnp.int32, jnp.bool_):
            acc = acc.astype(jnp.int64)
        elif acc.dtype in (jnp.uint8, jnp.uint16, jnp.uint32):
            acc = acc.astype(jnp.uint64)
        if mask is not None:
            acc = jnp.where(mask, acc, jnp.zeros((), acc.dtype))
        return _segmented_scan(jnp.add, acc, boundary)
    if op in ("min", "max"):
        if jnp.issubdtype(data.dtype, jnp.integer) or data.dtype == jnp.bool_:
            ident = jnp.iinfo(data.dtype).max if op == "min" \
                else jnp.iinfo(data.dtype).min
            ident = jnp.asarray(ident, data.dtype)
        else:
            ident = jnp.asarray(jnp.inf if op == "min" else -jnp.inf,
                                data.dtype)
        acc = jnp.where(mask, data, ident) if mask is not None else data
        fn = jnp.minimum if op == "min" else jnp.maximum
        return _segmented_scan(fn, acc, boundary)
    if op in ("first", "last"):
        m = mask if mask is not None else jnp.ones(data.shape, jnp.bool_)
        keep_first = op == "first"

        def combine(a, b):
            av, ah, af = a
            bv, bh, bf = b
            if keep_first:
                v = jnp.where(bf, bv, jnp.where(ah, av, bv))
            else:
                v = jnp.where(bf, bv, jnp.where(bh, bv, av))
            h = jnp.where(bf, bh, ah | bh)
            return v, h, af | bf

        out, _, _ = jax.lax.associative_scan(
            combine, (data, m, boundary.astype(jnp.bool_)))
        return out
    raise ValueError(op)


def seg_reduce_sorted(op: str, data: jax.Array, group_ids_sorted: jax.Array,
                      boundary: jax.Array, starts: jax.Array,
                      ends: jax.Array, num_groups_cap: int,
                      mask_sorted: Optional[jax.Array] = None) -> jax.Array:
    """Per-group reduction over key-sorted rows; returns (num_groups_cap,).

    op           -- sum | min | max | any (first masked-in value)
    data         -- values in sorted-row order
    boundary     -- True at each segment's first row
    mask_sorted  -- rows to include (False rows contribute the identity)
    Empty groups get 0 (sum) / dtype identity (min/max).
    """
    cap = data.shape[0]
    last = jnp.maximum(ends - 1, 0)
    have = ends > starts

    if op == "sum":
        acc = data
        if acc.dtype in (jnp.int8, jnp.int16, jnp.int32):
            acc = acc.astype(jnp.int64)
        elif acc.dtype in (jnp.uint8, jnp.uint16, jnp.uint32):
            acc = acc.astype(jnp.uint64)
        elif acc.dtype == jnp.bool_:
            acc = acc.astype(jnp.int64)
        elif acc.dtype == jnp.float32:
            acc = acc.astype(jnp.float64)
        zero = jnp.zeros((), acc.dtype)
        if mask_sorted is not None:
            acc = jnp.where(mask_sorted, acc, zero)
        # cumsum + boundary difference: exact mod 2^64 for integers; for
        # floats the native log-depth prefix sum keeps per-group error at
        # ~log2(n)*eps of the prefix magnitude (cf. module docstring)
        c = jnp.cumsum(acc)
        total = c[last]
        before = jnp.where(starts > 0, c[jnp.maximum(starts - 1, 0)], zero)
        return jnp.where(have, total - before, zero)

    if op in ("min", "max"):
        cnt = _masked_counts(mask_sorted, starts, ends, last, have)
        havem = have & (cnt > 0)
        # one sort of (gid, order-token) pairs; segment ranges [starts, ends)
        # are unchanged (gid is the primary key), masked-out rows carry the
        # token sentinel and sink to each segment's tail.  The data itself
        # does NOT ride the sort; a position payload + two small gathers
        # fetch the value.
        tok = sort_ops.order_token(data, validity=mask_sorted)
        rowpos = jnp.arange(cap, dtype=jnp.int32)
        _, _, pos2 = jax.lax.sort([group_ids_sorted, tok, rowpos],
                                  num_keys=2, is_stable=False)
        at = starts if op == "min" else starts + cnt - 1
        out = data[pos2[jnp.clip(at, 0, cap - 1)]]
        return jnp.where(havem, out, jnp.zeros((), data.dtype))

    if op == "any":
        # first masked-in value per segment: masked-in rows sort (stably,
        # via original position) to the segment head
        cnt = _masked_counts(mask_sorted, starts, ends, last, have)
        havem = have & (cnt > 0)
        if mask_sorted is None:
            out = data[jnp.clip(starts, 0, cap - 1)]
            return jnp.where(havem, out, jnp.zeros((), data.dtype))
        rowpos = jnp.arange(cap, dtype=jnp.int32)
        notm = jnp.logical_not(mask_sorted)
        _, _, pos2 = jax.lax.sort([group_ids_sorted, notm, rowpos],
                                  num_keys=3, is_stable=False)
        out = data[pos2[jnp.clip(starts, 0, cap - 1)]]
        return jnp.where(havem, out, jnp.zeros((), data.dtype))

    if op in ("bor", "band", "bxor", "bytemax"):
        # bitwise aggregates (reference: AggregateFunctionBitwise.h).  These
        # are associative+commutative but not order statistics, so the sort
        # trick doesn't apply; a segmented associative_scan + end-gather is
        # used instead.  groupBit* inputs are modest in practice; the scan is
        # a single fixed-width operand (the 33M-tuple compile blowup recorded
        # in the module docstring was for multi-operand tuples).
        fn = {"bor": jnp.bitwise_or, "band": jnp.bitwise_and,
              "bxor": jnp.bitwise_xor, "bytemax": bytewise_max}[op]
        ident = jnp.zeros((), data.dtype)
        if op == "band":
            ident = (~ident if jnp.issubdtype(data.dtype, jnp.integer)
                     else ident)
        acc = jnp.where(mask_sorted, data, ident) \
            if mask_sorted is not None else data
        scanned = _segmented_scan(fn, acc, boundary)
        out = scanned[last]
        cnt = _masked_counts(mask_sorted, starts, ends, last, have)
        return jnp.where(have & (cnt > 0), out, jnp.zeros((), data.dtype))

    raise ValueError(f"Unknown segmented reduction '{op}'")


def bytewise_max(a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-byte max of two uint64 arrays (HLL register-limb merge).

    8 registers pack into each u64 limb; two limb sets merge by taking the
    larger byte lane-wise.  SIMD trick (no unpacking): a byte of `a` wins
    where it is >= the corresponding byte of `b`, detected via a borrow-free
    per-byte compare using the high-bit technique.
    """
    assert a.dtype == jnp.uint64 and b.dtype == jnp.uint64
    H = jnp.uint64(0x8080808080808080)
    L = jnp.uint64(0x7F7F7F7F7F7F7F7F)
    # low-7-bit compare: (a|H) has every byte >= 0x80 and (b&L) <= 0x7F, so
    # the subtraction never borrows across byte lanes; the high bit of each
    # result byte is set iff a7 >= b7 for that lane
    ge7 = ((a | H) - (b & L)) & H
    ah, bh = a & H, b & H
    # full unsigned per-byte >=: high bits decide, ties fall back to low 7
    ge = (ah & ~bh) | (~(ah ^ bh) & ge7)
    sel = (ge >> jnp.uint64(7)) * jnp.uint64(0xFF)   # 0xFF where a wins
    return (a & sel) | (b & ~sel)


def seg_reduce_2d(op: str, data2d: jax.Array, boundary: jax.Array,
                  starts: jax.Array, ends: jax.Array) -> jax.Array:
    """Per-group elementwise reduction over a (rows, width) state matrix.

    Used to merge fixed-width sketch states (HLL register limbs, reservoir
    tags) that were concatenated row-wise from multiple sources (shards or
    stream chunks).  Row counts here are small (num_groups_cap * n_sources),
    so an associative_scan is safe.
    """
    fn = {"bor": jnp.bitwise_or, "max": jnp.maximum, "min": jnp.minimum,
          "sum": jnp.add, "bytemax": bytewise_max}[op]
    flags = boundary.astype(jnp.bool_)

    def combine(a, b):
        av, af = a
        bv, bf = b
        v = jnp.where(bf[:, None], bv, fn(av, bv))
        return v, af | bf

    out, _ = jax.lax.associative_scan(combine, (data2d, flags))
    last = jnp.maximum(ends - 1, 0)
    res = out[last]
    have = (ends > starts)[:, None]
    return jnp.where(have, res, jnp.zeros((), data2d.dtype))


def _masked_counts(mask_sorted, starts, ends, last, have):
    """Masked-in rows per segment (int64), no scan beyond a native cumsum."""
    if mask_sorted is None:
        return ends - starts
    mc = jnp.cumsum(mask_sorted.astype(jnp.int64))
    total = mc[last]
    before = jnp.where(starts > 0, mc[jnp.maximum(starts - 1, 0)],
                       jnp.zeros((), jnp.int64))
    return jnp.where(have, total - before, jnp.zeros((), jnp.int64))

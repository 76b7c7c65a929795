"""Sort-merge join kernels: build, probe, expand — zero random gathers on
the probe path.

Replacement for the reference HashJoin
(src/Interpreters/HashJoin/HashJoin.h:110, probe loops in
HashJoinMethodsImpl.h:334).  The reference builds a linear-probe hash table
with arena-allocated row lists; here probing is sort-merging, which trades
N * log G random gathers for streaming sorts.  Design:

  build:  group the build side by key (sort-based, reuses agg_ops machinery)
          -> per-group [seg_start, seg_len] into the key-sorted row order.
          No hash is ever computed: lax.sort takes the key columns as
          multi-operand sort keys directly, so there are no collisions.
  probe:  ONE sort of concat(unique build keys, probe keys) with a side flag;
          each build entry's (seg_start, seg_len) — packed into one u64 —
          reaches the probe rows of its key run via two cummax scans (run
          start + last table position; a probe row matches iff the last
          table entry at or before it is inside its own run) and a single
          near-monotone gather; a second sort restores probe order.
          (A segmented associative_scan would be gather-free, but
          lax.associative_scan over ~33M-element tuples is costly to
          compile, so the carry uses native cumulative-max ops instead.)
  expand: 1-to-N match expansion (the IColumn::replicate analog,
          src/Columns/IColumn.h:440): instead of binary-searching each
          output slot in the cumulative-length array, merge-sort
          concat(cum, iota(out_cap)); a reverse cummin of the cum entries'
          probe-row ids assigns each output slot its source row, a second
          sort restores output order, and one packed monotone gather pulls
          (seg_start, matched); within-segment offsets come from a cummax
          over the output order.  The only remaining random gathers are the
          final payload-column gathers, which are inherent to join output.

Build-side output rows are addressed in KEY-SORTED build order
(`build_pos`); callers gather payload columns through `row_order` once
(build-side sized) and then index with `build_pos` — one random gather per
output column instead of two.

LEFT joins emit one row per unmatched probe row with match_mask=0 so the
executor can null/default build-side columns (join_use_nulls semantics).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from . import agg_ops, hash_ops

__all__ = ["JoinTable", "ProbeResult", "build_join_table",
           "probe_join_table", "expand_matches", "propagate_join",
           "dense_gather_join", "PropagateResult"]


@dataclasses.dataclass
class PropagateResult:
    """Per-probe-row join result in RAW probe order (no expansion)."""
    matched: jax.Array       # (Np,) bool
    words: List[jax.Array]   # each (Np,) int32 — propagated build-side words


def dense_gather_join(build_key: jax.Array, build_valid: jax.Array,
                      probe_key: jax.Array, probe_valid: jax.Array,
                      build_words: Sequence,
                      lo: int, hi: int) -> PropagateResult:
    """N:1 join against a DENSE direct-address table — the device hash join.

    When interval analysis proves the (unique) build keys live in a static
    range [lo, hi] small enough for a device-resident table, the whole
    sort-merge machinery collapses to: scatter the build words into a
    (hi-lo+1)-slot table once (build-sized), then ONE random gather per
    packed word pair for all probe rows.  This is the direct analog of the
    reference's fixed-size key path (src/Interpreters/HashJoin — its
    FixedHashMap for 8/16-bit keys, generalized here by proven bounds), and
    it is probe-latency bound, the same wall the hash probe loop
    (HashJoinMethodsImpl.h:334) hits in DRAM.

    Requires unique build keys (or no words: semi/anti presence checks) —
    duplicate scatter slots would be nondeterministic.

    build_words -- [(int32 word array, sentinel int)]: per output word, the
        sentinel is provably outside the word's value range.
    """
    R = int(hi) - int(lo) + 1
    bidx = jnp.where(build_valid,
                     build_key.astype(jnp.int64) - lo,
                     jnp.int64(R)).astype(jnp.int32)
    pidx0 = probe_key.astype(jnp.int64) - lo
    inb = probe_valid & (pidx0 >= 0) & (pidx0 < R)
    pidx = jnp.clip(pidx0, 0, R - 1).astype(jnp.int32)

    ws = list(build_words)
    # one int32 gather per real word: slots not owned by a build row hold a
    # SENTINEL proven (by interval analysis) to be outside the word's value
    # range, so presence costs no extra gather and everything stays 4-byte
    # (half the bytes of an int64 packed table).
    # The join-key output column costs NOTHING: on a match its value equals
    # the probe key ("key"/"keyvalid" entries are synthesized, not gathered).
    matched = None
    gathered = {}
    for i, e in enumerate(ws):
        if e[0] != "word":
            continue
        _, w, sent = e
        s32 = jnp.int32(sent)
        t = jnp.full((R + 1,), s32, jnp.int32).at[bidx].set(
            w.astype(jnp.int32))[:R]
        g = t[pidx]
        if matched is None:
            matched = inb & (g != s32)
        gathered[i] = g
    if matched is None:
        pres = jnp.zeros((R + 1,), jnp.uint8).at[bidx].set(1)[:R]
        matched = inb & (pres[pidx] > 0)
    words_out: List[jax.Array] = []
    zero = jnp.int32(0)
    for i, e in enumerate(ws):
        if e[0] == "word":
            words_out.append(jnp.where(matched, gathered[i], zero))
        elif e[0] == "key":
            words_out.append(jnp.where(matched,
                                       probe_key.astype(jnp.int32), zero))
        else:                                  # "keyvalid"
            words_out.append(matched.astype(jnp.int32))
    return PropagateResult(matched=matched, words=words_out)


def propagate_join(build_keys: Sequence[jax.Array], build_valid: jax.Array,
                   probe_keys: Sequence[jax.Array], probe_valid: jax.Array,
                   build_words: Sequence[jax.Array],
                   asof_tokens: Optional[Tuple[jax.Array, jax.Array]] = None,
                   asof_strict: bool = False) -> PropagateResult:
    """Single-sort merge join with cummax payload propagation — ZERO gathers.

    For joins where each probe row takes at most ONE build row (N:1 joins
    against unique build keys, ANY strictness, SEMI/ANTI existence checks,
    and ASOF), the expansion machinery is unnecessary: sort
    concat(build, probe) by key with build rows first in each run, then each
    probe row's match is the first (ASOF: last) build row of its key run —
    propagated down the run by ONE cumulative max of (position << 32 | word)
    per 32-bit payload word.  Replaces both the reference's hash probe
    (src/Interpreters/HashJoin/HashJoinMethodsImpl.h:334) and its ASOF
    sorted-lookup (src/Interpreters/AsofRowRefs) with sort+scan primitives
    and no per-row random probe.

    build_words -- 32-bit words of the build-side output columns.
    asof_tokens -- (build_token, probe_token) u64 order tokens for ASOF: the
        match is the build row with the largest token <= the probe row's
        (callers encode direction so <=/>= both become ascending <=);
        asof_strict selects strict inequality.
    Sorted deterministically by original row id, so the propagated build row
    matches the reference's "first inserted" ANY-join choice.
    """
    G = build_keys[0].shape[0]
    Np = probe_keys[0].shape[0]
    M = G + Np
    invalid = jnp.concatenate([jnp.logical_not(build_valid),
                               jnp.logical_not(probe_valid)])
    keys = [hash_ops.sortable_bits(
                jnp.concatenate([bk, pk.astype(bk.dtype)]))[0]
            for bk, pk in zip(build_keys, probe_keys)]
    is_probe = jnp.concatenate([jnp.zeros((G,), jnp.bool_),
                                jnp.ones((Np,), jnp.bool_)])
    rowid = jnp.arange(M, dtype=jnp.int32)
    carries = [jnp.concatenate([w.astype(jnp.int32),
                                jnp.zeros((Np,), jnp.int32)])
               for w in build_words]
    ops: List[jax.Array] = [invalid] + keys
    if asof_tokens is not None:
        asof = jnp.concatenate([asof_tokens[0], asof_tokens[1]])
        if asof_strict:
            # strict '<': probe rows with an equal asof value must NOT see
            # the build row -> probe sorts before build at ties
            ops += [asof, jnp.logical_not(is_probe), rowid]
        else:
            ops += [asof, is_probe, rowid]
    else:
        ops += [is_probe, rowid]
    nk = len(ops)                       # rowid as last key: deterministic
    ops += carries
    sorted_ops = jax.lax.sort(ops, num_keys=nk, is_stable=False)
    inv_s = sorted_ops[0]
    keys_s = sorted_ops[1:1 + len(keys)]
    probe_s = sorted_ops[1 + len(keys) + (1 if asof_tokens is not None
                                          else 0)]
    if asof_strict:
        probe_s = jnp.logical_not(probe_s)
    rowid_s = sorted_ops[nk - 1]
    words_s = sorted_ops[nk:]

    # key-run boundaries (asof values do NOT split runs)
    boundary = jnp.zeros((M,), jnp.bool_).at[0].set(True)
    for ks in keys_s:
        boundary = boundary | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), ks[1:] != ks[:-1]])
    boundary = boundary | jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), inv_s[1:] != inv_s[:-1]])

    pos = jnp.arange(M, dtype=jnp.int32)
    is_build = jnp.logical_not(probe_s) & jnp.logical_not(inv_s)
    run_start = jax.lax.cummax(jnp.where(boundary, pos, 0))
    last_build = jax.lax.cummax(jnp.where(is_build, pos, -1))
    matched_s = (last_build >= run_start) & probe_s & jnp.logical_not(inv_s)

    if asof_tokens is None:
        # the reference's ANY join takes the FIRST inserted build row; build
        # rows sort to the run head, so the contributor is the run's first
        contrib = is_build & boundary
    else:
        contrib = is_build                 # ASOF: last build row <= probe
    pos64 = pos.astype(jnp.int64)
    outs = []
    for w_s in words_s:
        packed = jnp.where(contrib,
                           (pos64 << jnp.int64(32))
                           | w_s.astype(jnp.uint32).astype(jnp.int64),
                           jnp.int64(-1))
        pr = jax.lax.cummax(packed)
        outs.append(pr.astype(jnp.uint32).astype(jnp.int32))

    back = jax.lax.sort([rowid_s, matched_s.astype(jnp.int8)] + outs,
                        num_keys=1, is_stable=False)
    matched = back[1][G:].astype(jnp.bool_) & probe_valid
    words = [b[G:] for b in back[2:]]
    return PropagateResult(matched=matched, words=words)


@dataclasses.dataclass
class JoinTable:
    """Build-side index in key-sorted group order."""
    key_cols: List[jax.Array]  # each (G,) unique key values per group
    seg_start: jax.Array     # (G,) int32 start into row_order
    seg_len: jax.Array       # (G,) int32 rows per group (0 for padding)
    row_order: jax.Array     # (N,) int32 build row ids, key-sorted
    num_groups: jax.Array    # int64 device scalar

    @property
    def group_capacity(self) -> int:
        return int(self.seg_start.shape[0])


@dataclasses.dataclass
class ProbeResult:
    """Per-probe-row match info (raw probe row order)."""
    matched: jax.Array       # (N,) bool
    seg_start: jax.Array     # (N,) int32 into row_order (0 if unmatched)
    seg_len: jax.Array       # (N,) int32 matching build rows (0 if unmatched)


def build_join_table(keys: Sequence[jax.Array], row_valid: jax.Array,
                     group_capacity: int) -> JoinTable:
    g = agg_ops.group_by_sort(keys, row_valid, group_capacity)
    seg_len = (g.ends - g.starts).astype(jnp.int32)
    gidx = jnp.arange(group_capacity, dtype=jnp.int64)
    seg_len = jnp.where(gidx < g.num_groups, seg_len, 0)
    return JoinTable(key_cols=list(g.unique_keys),
                     seg_start=g.starts.astype(jnp.int32),
                     seg_len=seg_len, row_order=g.perm,
                     num_groups=g.num_groups)


def probe_join_table(table: JoinTable, probe_keys: Sequence[jax.Array],
                     probe_valid: jax.Array) -> ProbeResult:
    """Sort-merge probe: no hashing, no collisions, one monotone gather."""
    G = table.group_capacity
    N = probe_keys[0].shape[0]
    M = G + N
    gidx = jnp.arange(G, dtype=jnp.int64)
    tbl_invalid = gidx >= table.num_groups      # padding groups sink last

    invalid = jnp.concatenate([tbl_invalid, jnp.logical_not(probe_valid)])
    # float keys sort as order-mapped bit patterns (bit equality ==
    # join-key equality after sortable_bits normalization)
    keys = [hash_ops.sortable_bits(
                jnp.concatenate([tk, pk.astype(tk.dtype)]))[0]
            for tk, pk in zip(table.key_cols, probe_keys)]
    # table entries sort before equal-key probe entries
    is_probe = jnp.concatenate([jnp.zeros((G,), jnp.bool_),
                                jnp.ones((N,), jnp.bool_)])
    idx = jnp.arange(M, dtype=jnp.int32)
    # (seg_start, seg_len) packed so the carry costs ONE gather
    packed = (table.seg_start.astype(jnp.uint64) << jnp.uint64(32)) \
        | table.seg_len.astype(jnp.uint32).astype(jnp.uint64)
    packed = jnp.concatenate([packed, jnp.zeros((N,), jnp.uint64)])

    ops = [invalid] + keys + [is_probe, idx, packed]
    nk = 1 + len(keys) + 1
    sorted_ops = jax.lax.sort(ops, num_keys=nk, is_stable=False)
    inv_s = sorted_ops[0]
    keys_s = sorted_ops[1:1 + len(keys)]
    probe_s = sorted_ops[1 + len(keys)]
    idx_s = sorted_ops[nk]
    packed_s = sorted_ops[nk + 1]

    boundary = jnp.zeros((M,), jnp.bool_).at[0].set(True)
    for ks in keys_s:
        boundary = boundary | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), ks[1:] != ks[:-1]])
    boundary = boundary | jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), inv_s[1:] != inv_s[:-1]])

    # A probe row matches iff the most recent table entry at or before it
    # lies inside its own key run (each run holds at most one table entry,
    # sorted to the run head).  Two native cumulative maxes — no
    # associative_scan (compile-time bomb at this scale, see module doc).
    pos = jnp.arange(M, dtype=jnp.int32)
    is_table_row = jnp.logical_not(probe_s) & jnp.logical_not(inv_s)
    run_start = jax.lax.cummax(jnp.where(boundary, pos, 0))
    last_table = jax.lax.cummax(jnp.where(is_table_row, pos, -1))
    matched = (last_table >= run_start) & probe_s & jnp.logical_not(inv_s)
    carried = packed_s[jnp.clip(last_table, 0, M - 1)]

    # restore original order; probe rows occupy positions G..G+N-1
    _, m_r, pk_r = jax.lax.sort(
        [idx_s, matched.astype(jnp.int8), carried], num_keys=1,
        is_stable=False)
    m = m_r[G:].astype(jnp.bool_) & probe_valid
    pk_out = jnp.where(m, pk_r[G:], jnp.uint64(0))
    return ProbeResult(matched=m,
                       seg_start=(pk_out >> jnp.uint64(32)).astype(jnp.int32),
                       seg_len=pk_out.astype(jnp.uint32).astype(jnp.int32))


def expand_matches(probe: ProbeResult, probe_valid: jax.Array,
                   out_capacity: int, left: bool = False,
                   any_join: bool = False
                   ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Expand 1-to-N matches into flat output row pairs (gather-free core).

    Returns (probe_row_idx, build_pos, match_mask, out_count):
      probe_row_idx[j] -- source probe row of output row j
      build_pos[j]     -- KEY-SORTED build position (index into row_order;
                          undefined where match_mask=0)
      match_mask[j]    -- False for LEFT-join null rows and padding
      out_count        -- device scalar of real output rows
    """
    N = probe.matched.shape[0]
    lens = jnp.where(probe.matched & probe_valid, probe.seg_len, 0)
    if any_join:
        lens = jnp.minimum(lens, 1)
    if left:
        lens = jnp.where(probe_valid, jnp.maximum(lens, 1), 0)
    cum = jnp.cumsum(lens.astype(jnp.int64))         # inclusive prefix
    out_count = cum[-1]
    M = N + out_capacity

    # Merge-based replicate: output slot j belongs to probe row
    # i = searchsorted(cum, j, 'right') = the first cum entry AFTER slot j
    # in the merged order (cum entries tie-break before equal j, and among
    # themselves by ascending i — idx is a second sort key).  A reverse
    # cummin over the cum entries' row ids hands each slot that i directly.
    j64 = jnp.arange(out_capacity, dtype=jnp.int64)
    key = jnp.concatenate([cum, j64])
    idx = jnp.arange(M, dtype=jnp.int32)
    _, idx_s = jax.lax.sort([key, idx], num_keys=2, is_stable=False)
    is_cum = idx_s < N
    nxt = jax.lax.cummin(jnp.where(is_cum, idx_s, N), reverse=True)

    # back to output order: slots occupy positions N..M-1
    _, pri = jax.lax.sort([idx_s, nxt], num_keys=1, is_stable=False)
    pri = jnp.clip(pri[N:], 0, N - 1)                # row id per output slot

    # ONE packed monotone gather for (seg_start, matched)
    packed = (probe.seg_start.astype(jnp.int64) << jnp.int64(1)) \
        | (probe.matched & probe_valid).astype(jnp.int64)
    pk = packed[pri]
    ss_o = (pk >> jnp.int64(1)).astype(jnp.int32)
    mm_o = (pk & jnp.int64(1)).astype(jnp.bool_)

    # within-segment offset k: distance to the segment's first output slot
    # (where pri changes) — cummax trick, no first_out gather
    j32 = jnp.arange(out_capacity, dtype=jnp.int32)
    seg_first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), pri[1:] != pri[:-1]])
    last_start = jax.lax.cummax(jnp.where(seg_first, j32, 0))
    k = j32 - last_start

    valid_out = j64 < out_count
    match_mask = mm_o & valid_out
    build_pos = ss_o + k
    return pri, build_pos, match_mask, out_count

"""Sketch and array-valued aggregate functions.

Device-array takes on the reference's heavy aggregate tail:

* ``groupArray`` / ``groupUniqArray`` (src/AggregateFunctions/
  AggregateFunctionGroupArray.h) — per-group value collection into padded
  (num_groups, max_len) matrices via one segment-ordering sort + a strided
  gather, no scatters.
* ``topK`` (src/AggregateFunctions/AggregateFunctionTopK.h) — exact
  heavy-hitters via two sorts: (key, value) pair counts, then pairs re-sorted
  by (key, -count) so each group's top-N sits at its segment head.
* ``entropy`` (src/AggregateFunctions/AggregateFunctionEntropy.h) — Shannon
  entropy from run lengths of the (key, value)-sorted rows.
* ``uniq`` / ``uniqCombined`` / ``uniqHLL12`` (src/AggregateFunctions/
  AggregateFunctionUniq.h, uniqCombined.h) — HyperLogLog with a mergeable,
  storable state.  The twist: per-group registers live as a dense
  (num_groups, m/8) uint64 limb matrix, 8 one-byte registers per limb.
  Update never scatters: rows are sorted by (key, register, -rho) so each
  (key, register) run's head carries the register maximum, and limb values
  assemble by segmented cumsum (bytes within a limb are distinct registers,
  so bitwise-OR == sum).  Merge is a per-byte SWAR max (scan_ops.bytewise_max)
  under a segmented scan — associative, commutative, and exactly the
  reference's HLL merge semantics.

Register count m adapts to the grouping capacity so the dense (groups, m/8)
state and its (groups*m/8,) assembly index stay bounded: standard error is
1.04/sqrt(m) — 1.6% at m=4096 (the reference's uniqHLL12 precision), 3.3%
at m=1024, 6.5% at m=256.
"""
from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp

from ..core import dtypes as dt
from ..core.errors import TypeError_
from ..ops import agg_ops, hash_ops, scan_ops, sort_ops
from .aggregates import AggregateFunction

__all__ = ["GroupArrayAgg", "GroupUniqArrayAgg", "TopKAgg", "EntropyAgg",
           "HLLUniqAgg", "QuantilesExactAgg"]


def _segment_prefix_matrix(values_sorted: jax.Array, lens: jax.Array,
                           starts: jax.Array, max_len: int) -> tuple:
    """mat[g, j] = values_sorted[starts[g] + j] for j < min(lens[g], max_len).

    The rows of each segment must already lead with the wanted values (the
    caller arranges this with sort keys).  One (G, max_len) strided gather.
    """
    cap = values_sorted.shape[0]
    idx = starts[:, None] + jnp.arange(max_len, dtype=jnp.int64)[None, :]
    mat = values_sorted[jnp.clip(idx, 0, cap - 1)]
    lens_c = jnp.minimum(lens, max_len)
    live = jnp.arange(max_len, dtype=jnp.int64)[None, :] < lens_c[:, None]
    mat = jnp.where(live, mat, jnp.zeros((), mat.dtype))
    return mat, lens_c


class GroupArrayAgg(AggregateFunction):
    """groupArray([N])(x): per-group array of values in row order."""
    name = "groupArray"
    holistic = True
    unique = False

    def __init__(self, arg_types, max_size: Optional[int] = None):
        super().__init__(arg_types)
        self.max_size = int(max_size) if max_size else None

    def result_type(self):
        return dt.Array(dt.remove_nullable(self.arg_types[0]))

    def state_ops(self):
        raise TypeError_(f"{self.name} states cannot be merged; "
                         "repartition by key instead")

    def _width(self, ctx):
        if self.max_size is not None:
            return self.max_size
        s = getattr(ctx, "settings", None)
        return getattr(s, "group_array_max_size", 256) if s else 256

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        value = self._value(ctx, args[0])
        L = self._width(ctx)
        notm = jnp.logical_not(mask)
        if self.unique:
            # two sorts: (key, value) to find first occurrences, then
            # (key, not-first) to compact the kept rows to segment heads
            g1 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                       ctx.num_groups_cap,
                                       secondary=[notm, value])
            m1 = jnp.logical_not(g1.take(notm))
            v1 = hash_ops.sortable_bits(g1.take(value))[0]   # bit equality
            prev_same = jnp.concatenate(
                [jnp.zeros((1,), jnp.bool_),
                 (v1[1:] == v1[:-1]) & (g1.group_ids[1:] == g1.group_ids[:-1])])
            keep_sorted = m1 & jnp.logical_not(prev_same)
            # scatter-free raw-order recovery: sort (perm, keep) by perm
            _, keep_raw = jax.lax.sort(
                [g1.perm, keep_sorted.astype(jnp.int32)], num_keys=1,
                is_stable=False)
            keep = keep_raw.astype(jnp.bool_)
        else:
            keep = mask
        g2 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                   ctx.num_groups_cap,
                                   secondary=[jnp.logical_not(keep)]
                                   + self._order_cols(ctx, value),
                                   payloads=[value])
        keep_s = jnp.logical_not(g2.take(jnp.logical_not(keep)))
        v_s = g2.take(value)
        lens = g2.reduce_sorted("sum", keep_s.astype(jnp.int64), keep_s)
        mat, lens_c = _segment_prefix_matrix(v_s, lens, g2.starts, L)
        if self.max_size is None and getattr(ctx, "checks", None) is not None:
            from ..exec.executor import Check
            ctx.checks.append(Check(
                jnp.max(lens), L,
                f"{self.name} result exceeded group_array_max_size; "
                "raise the group_array_max_size setting",
                setting="group_array_max_size"))
        mat = self._post_matrix(mat, lens_c)
        return [mat, lens_c.astype(jnp.int32)]

    def _order_cols(self, ctx, value):
        """Extra within-group sort keys BEFORE row order (subclass hook:
        groupArraySorted orders by value, groupArrayLast by recency,
        groupArraySample by a hash token)."""
        return []

    def _post_matrix(self, mat, lens):
        """Per-group row transform after collection (subclass hook)."""
        return mat

    def merge(self, states, grouping, mask_raw):
        raise TypeError_(f"{self.name} cannot merge partial states")

    def finalize(self, states):
        mat, lens = states
        return mat, None, lens


class GroupUniqArrayAgg(GroupArrayAgg):
    """groupUniqArray(x): distinct values per group (first-seen order)."""
    name = "groupUniqArray"
    unique = True


class TopKAgg(AggregateFunction):
    """topK(N)(x): the N most frequent values, most frequent first.

    Exact (the reference's is approximate space-saving; ours is collision-
    free by construction): pair counts via (key, value) segment runs, then
    pairs re-sorted by (key, -count) so each group's head holds the top-N.
    """
    name = "topK"
    holistic = True

    def __init__(self, arg_types, k: int = 10):
        super().__init__(arg_types)
        self.k = int(k)

    def result_type(self):
        return dt.Array(dt.remove_nullable(self.arg_types[0]))

    def state_ops(self):
        raise TypeError_("topK states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        value = self._value(ctx, args[0])
        cap = ctx.row_valid.shape[0]
        notm = jnp.logical_not(mask)
        g1 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                   ctx.num_groups_cap,
                                   secondary=[notm, value])
        m1 = jnp.logical_not(g1.take(notm))
        v1 = g1.take(value)
        gid = g1.group_ids
        run_first = m1 & jnp.concatenate(
            [jnp.ones((1,), jnp.bool_),
             (v1[1:] != v1[:-1]) | (gid[1:] != gid[:-1])])
        # run lengths via segment extents over the (ascending) run ids
        run_id = jnp.where(m1, jnp.cumsum(run_first.astype(jnp.int64)) - 1,
                           cap)
        starts_r, ends_r = scan_ops.segment_starts_ends(run_id, cap)
        cnt_row = (ends_r - starts_r)[jnp.clip(run_id, 0, cap - 1)]
        # re-sort within group segments by descending run count; gid stays
        # the primary key, so each group occupies the same [starts, ends)
        # range as in g1 and g1.starts remains valid
        selkey = jnp.where(run_first, jnp.int64(cap + 1) - cnt_row,
                           jnp.int64(cap + 2))
        v_enc, v_dec = hash_ops.sortable_bits(v1)
        _, _, v2 = jax.lax.sort([gid, selkey, v_enc], num_keys=2,
                                is_stable=True)
        if v_dec is not None:
            v2 = v_dec(v2)
        nsel = g1.reduce_sorted("sum", run_first.astype(jnp.int64), run_first)
        mat, lens_c = _segment_prefix_matrix(v2, nsel, g1.starts, self.k)
        return [mat, lens_c.astype(jnp.int32)]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("topK cannot merge partial states")

    def finalize(self, states):
        mat, lens = states
        return mat, None, lens


class EntropyAgg(AggregateFunction):
    """entropy(x): Shannon entropy (bits) of the value distribution.

    H = sum over rows of log2(T / c_row) / T, where c_row is the row's
    (key, value) run length and T the group's row count — an exact
    whole-column reformulation of -sum(p log2 p).
    """
    name = "entropy"
    holistic = True

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        raise TypeError_("entropy states cannot be merged")

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        value = self._value(ctx, args[0])
        cap = ctx.row_valid.shape[0]
        notm = jnp.logical_not(mask)
        g = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                  ctx.num_groups_cap,
                                  secondary=[notm, value])
        m1 = jnp.logical_not(g.take(notm))
        v1 = g.take(value)
        gid = g.group_ids
        run_first = m1 & jnp.concatenate(
            [jnp.ones((1,), jnp.bool_),
             (v1[1:] != v1[:-1]) | (gid[1:] != gid[:-1])])
        run_id = jnp.where(m1, jnp.cumsum(run_first.astype(jnp.int64)) - 1,
                           cap)
        starts_r, ends_r = scan_ops.segment_starts_ends(run_id, cap)
        run_cnt = (ends_r - starts_r)
        c_row = run_cnt[jnp.clip(run_id, 0, cap - 1)].astype(jnp.float64)
        T = g.reduce_sorted("sum", m1.astype(jnp.int64), m1)
        t_row = T[jnp.minimum(gid, ctx.num_groups_cap - 1)].astype(jnp.float64)
        contrib = jnp.where(m1 & (c_row > 0) & (t_row > 0),
                            jnp.log2(jnp.maximum(t_row / jnp.maximum(c_row, 1.0),
                                                 1e-300)) / jnp.maximum(t_row, 1.0),
                            0.0)
        return [g.reduce_sorted("sum", contrib, m1)]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("entropy cannot merge partial states")

    def finalize(self, states):
        return states[0], None


class HLLUniqAgg(AggregateFunction):
    """uniq/uniqCombined/uniqHLL12: HyperLogLog approximate distinct count.

    Mergeable, storable state: (num_groups_cap, m/8) uint64 register limbs.
    See module docstring for the scatter-free update/merge design.
    Reference: src/AggregateFunctions/AggregateFunctionUniq.h:1,
    src/Common/HyperLogLogCounter.h.
    """
    name = "uniq"

    # total (groups x registers) assembly budget: keeps the limb-index
    # searchsorted and the dense state matrix bounded
    PAIR_BUDGET = 1 << 23
    # storable -State layout: fixed register count regardless of capacity
    STATE_M = 4096

    def __init__(self, arg_types):
        super().__init__(arg_types)
        self.fixed_m: Optional[int] = None

    def pin_state_layout(self):
        self.fixed_m = self.STATE_M

    def result_type(self):
        return dt.UInt64

    def state_ops(self):
        return ["bytemax"]

    def _m_for_cap(self, cap_g: int) -> int:
        if self.fixed_m is not None:
            return self.fixed_m
        m = 4096
        while m > 64 and cap_g * m > HLLUniqAgg.PAIR_BUDGET:
            m //= 2
        return m

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        cap = ctx.row_valid.shape[0]
        cap_g = ctx.num_groups_cap
        m = self._m_for_cap(cap_g)
        log2m = m.bit_length() - 1
        L = m // 8

        h = hash_ops.hash_columns([self._value(ctx, a) for a in args])
        reg = (h & jnp.uint64(m - 1)).astype(jnp.int32)
        w = h >> jnp.uint64(log2m)
        guard = jnp.uint64(1) << jnp.uint64(64 - log2m)
        wg = w | guard
        # count-trailing-zeros via popcount(~x & (x-1))
        rho = (jax.lax.population_count(~wg & (wg - jnp.uint64(1)))
               + jnp.uint64(1))                       # 1 .. 64-log2m+1
        reg_k = jnp.where(mask, reg, m)               # masked rows: sentinel
        neg_rho = (jnp.uint64(255) - rho).astype(jnp.uint8)
        g = agg_ops.group_by_sort(ctx.keys, ctx.row_valid, cap_g,
                                  secondary=[reg_k, neg_rho])
        reg_s = g.take(reg_k)
        rho_s = jnp.uint64(255) - g.take(neg_rho).astype(jnp.uint64)
        run_first = g.boundary | jnp.concatenate(
            [jnp.ones((1,), jnp.bool_), reg_s[1:] != reg_s[:-1]])
        contrib_row = run_first & (reg_s < m) \
            & (g.group_ids < cap_g)
        limb = (reg_s >> 3).astype(jnp.int64)
        byte = (reg_s & 7).astype(jnp.uint64)
        contrib = jnp.where(contrib_row, rho_s << (jnp.uint64(8) * byte),
                            jnp.uint64(0))
        # dense (group, limb) assembly: rows are sorted by (group, register),
        # so cid ascends; bytes within a limb are distinct registers -> sum
        # == bitwise OR
        cid = jnp.where((reg_s < m) & (g.group_ids < cap_g),
                        g.group_ids.astype(jnp.int64) * L + limb,
                        jnp.int64(cap_g) * L)
        starts_e, ends_e = scan_ops.segment_starts_ends(cid, cap_g * L)
        c = jnp.cumsum(contrib)
        zero = jnp.zeros((), jnp.uint64)
        total = c[jnp.clip(ends_e - 1, 0, cap - 1)]
        before = jnp.where(starts_e > 0,
                           c[jnp.clip(starts_e - 1, 0, cap - 1)], zero)
        limbs = jnp.where(ends_e > starts_e, total - before, zero)
        return [limbs.reshape(cap_g, L)]

    def merge(self, states, grouping, mask_raw):
        s = states[0]
        assert grouping.kind == "sort", "HLL merge requires sort grouping"
        s_sorted = s[grouping.perm]
        maskv = grouping.take(mask_raw)
        s_sorted = jnp.where(maskv[:, None], s_sorted, jnp.uint64(0))
        return [scan_ops.seg_reduce_2d("bytemax", s_sorted, grouping.boundary,
                                       grouping.starts, grouping.ends)]

    def finalize(self, states):
        limbs = states[0]                 # (G, L) u64
        L = limbs.shape[1]
        m = L * 8
        Z = jnp.zeros(limbs.shape[:1], jnp.float32)
        V = jnp.zeros(limbs.shape[:1], jnp.int32)
        for k in range(8):
            b = ((limbs >> jnp.uint64(8 * k)) & jnp.uint64(0xFF)) \
                .astype(jnp.int32)
            Z = Z + jnp.sum(jnp.exp2(-b.astype(jnp.float32)), axis=1)
            V = V + jnp.sum((b == 0).astype(jnp.int32), axis=1)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        E = alpha * m * m / jnp.maximum(Z, 1e-9)
        lc = m * jnp.log(m / jnp.maximum(V, 1).astype(jnp.float32))
        E = jnp.where((E <= 2.5 * m) & (V > 0), lc, E)
        return jnp.round(E).astype(jnp.uint64), None

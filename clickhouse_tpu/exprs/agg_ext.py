"""Extended aggregate functions: Map aggregation, ordered deltas, weighted
quantiles (reference: src/AggregateFunctions/AggregateFunctionSumMap.cpp,
AggregateFunctionDeltaSum.cpp, AggregateFunctionQuantile.cpp).

All holistic (sort-grouped) — distributed plans repartition rows by key
before running them, like every holistic aggregate here.
"""
from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import dtypes as dt
from ..core.errors import TypeError_
from ..ops import agg_ops, hash_ops, sort_ops
from .aggregates import AggregateFunction, AvgAgg
from .expr import ColVal

__all__ = ["SumMapAgg", "MinMapAgg", "MaxMapAgg", "DeltaSumAgg",
           "QuantileExactWeightedAgg", "ArrayReduceAgg", "AvgArrayAgg",
           "ForEachAgg", "make_array_combinator", "make_foreach_combinator"]


def _gid_raw(ctx) -> jax.Array:
    """Per-row group id in raw row order."""
    g = ctx.grouping
    if g.perm is None:
        return jnp.minimum(g.group_ids, ctx.num_groups_cap - 1)
    inv = jnp.argsort(g.perm)
    return jnp.minimum(g.group_ids[inv], ctx.num_groups_cap - 1)


class MapAggBase(AggregateFunction):
    """sumMap/minMap/maxMap(keys Array, values Array): per group, the
    union of keys with the op applied per key — returned as a tuple of
    (sorted keys array, values array) like the reference
    (AggregateFunctionSumMap.cpp)."""
    holistic = True
    map_op = "sum"

    def result_type(self):
        kt = dt.array_inner(dt.remove_nullable(self.arg_types[0]))
        vt = dt.array_inner(dt.remove_nullable(self.arg_types[1]))
        if self.map_op == "sum" and not vt.is_dictionary \
                and vt.np_dtype.kind in "iu":
            vt = dt.Int64 if vt.np_dtype.kind == "i" else dt.UInt64
        return dt.Tuple([dt.Array(kt), dt.Array(vt)])

    def state_ops(self):
        raise TypeError_(f"{self.name} states cannot be merged; "
                         "repartition by key instead")

    def _width(self, ctx):
        s = getattr(ctx, "settings", None)
        return getattr(s, "group_array_max_size", 256) if s else 256

    def update(self, ctx, args, cond):
        karr, varr = args[0], args[1]
        cap = ctx.row_valid.shape[0]
        mask = self._row_mask(ctx, args, cond)
        W = karr.data.shape[1]
        L = self._width(ctx)
        cap_g = ctx.num_groups_cap
        gid = _gid_raw(ctx)
        slot_ok = jnp.arange(W, dtype=jnp.int32)[None, :] \
            < karr.lengths[:, None]
        flat_valid = (mask[:, None] & slot_ok).reshape(-1)
        flat_keys = karr.data.reshape(-1)
        vdata = varr.data
        if vdata.shape[1] != W:         # ragged widths: clip to key width
            pad = W - vdata.shape[1]
            if pad > 0:
                vdata = jnp.concatenate(
                    [vdata, jnp.zeros((cap, pad), vdata.dtype)], axis=1)
            else:
                vdata = vdata[:, :W]
        flat_vals = vdata.reshape(-1)
        flat_gid = jnp.repeat(gid, W)
        cap2 = flat_keys.shape[0]
        # pairs: one group per (gid, key)
        g2 = agg_ops.group_by_sort([flat_gid, flat_keys], flat_valid, cap2)
        pair_vals = g2.reduce(self.map_op, flat_vals, flat_valid)
        pair_gid = g2.unique_keys[0]
        pair_key = g2.unique_keys[1]
        pair_valid = g2.group_valid()
        # collect pairs per ORIGINAL group, keys ascending (pairs arrive
        # sorted by (gid, key) so stable regrouping preserves key order)
        g3 = agg_ops.group_by_sort([pair_gid.astype(jnp.int64)], pair_valid,
                                   cap_g, payloads=[pair_key, pair_vals])
        keep_s = g3.take(pair_valid)
        k_s = g3.take(pair_key)
        v_s = g3.take(pair_vals)
        lens3 = g3.reduce_sorted("sum", keep_s.astype(jnp.int64), keep_s)
        from .agg_sketch import _segment_prefix_matrix
        kmat, lens_c = _segment_prefix_matrix(k_s, lens3, g3.starts, L)
        vmat, _ = _segment_prefix_matrix(v_s, lens3, g3.starts, L)
        if getattr(ctx, "checks", None) is not None:
            from ..exec.executor import Check
            ctx.checks.append(Check(
                jnp.max(lens3), L,
                f"{self.name} distinct keys exceeded group_array_max_size; "
                "raise the group_array_max_size setting",
                setting="group_array_max_size"))
        # remap g3's group numbering (present gids, ascending) back to the
        # original group ids so states align with the other aggregates
        uk = g3.unique_keys[0]
        uk = jnp.where(g3.group_valid(), uk, jnp.int64(2**62))
        slot = jnp.searchsorted(uk, jnp.arange(cap_g, dtype=uk.dtype))
        slot = jnp.clip(slot, 0, cap_g - 1)
        present = uk[slot] == jnp.arange(cap_g, dtype=uk.dtype)
        kmat = jnp.where(present[:, None], kmat[slot], 0)
        vmat = jnp.where(present[:, None], vmat[slot], 0)
        lens_o = jnp.where(present, lens_c[slot], 0).astype(jnp.int32)
        return [kmat, vmat, lens_o]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_(f"{self.name} cannot merge partial states")

    def finalize(self, states):
        # composite result: tuple of two arrays via ColVal sub-columns
        kmat, vmat, lens = states
        kt, vt = dt.tuple_inner(self.result_type())
        sub = [ColVal(kt, kmat, None, lengths=lens),
               ColVal(vt, vmat.astype(vt.jnp_dtype)
                      if vt.np_dtype.kind in "iuf" else vmat,
                      None, lengths=lens)]
        data = jnp.zeros((kmat.shape[0],), jnp.int32)
        return data, None, None, sub


class SumMapAgg(MapAggBase):
    name, map_op = "sumMap", "sum"


class MinMapAgg(MapAggBase):
    name, map_op = "minMap", "min"


class MaxMapAgg(MapAggBase):
    name, map_op = "maxMap", "max"


class DeltaSumAgg(AggregateFunction):
    """deltaSum(x): sum of positive consecutive differences in row order
    (reference: AggregateFunctionDeltaSum.h)."""
    name = "deltaSum"
    holistic = True

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        if base.np_dtype.kind == "f":
            return dt.Float64
        return dt.Int64 if base.np_dtype.kind == "i" else dt.UInt64

    def state_ops(self):
        raise TypeError_("deltaSum states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        value = self._value(ctx, args[0]).astype(
            jnp.float64 if dt.remove_nullable(self.arg_types[0])
            .np_dtype.kind == "f" else jnp.int64)
        g = ctx.grouping
        v_s = g.take(value)
        m_s = g.take(mask)
        cap = v_s.shape[0]
        # previous masked-in value within the sorted order via a segmented
        # forward-fill scan (carry = last masked row's (present, value))
        def combine(a, b):
            ap, av = a
            bp, bv = b
            return jnp.logical_or(bp, ap), jnp.where(bp, bv, av)

        pres, vals = jax.lax.associative_scan(
            combine, (m_s, jnp.where(m_s, v_s, 0)))
        # value BEFORE row i = scan result at i-1
        prev_p = jnp.concatenate([jnp.zeros((1,), jnp.bool_), pres[:-1]])
        prev_v = jnp.concatenate([jnp.zeros((1,), vals.dtype), vals[:-1]])
        # same-group check: previous row's group id
        gids = g.group_ids
        prev_g = jnp.concatenate([jnp.full((1,), -1, gids.dtype), gids[:-1]])
        # NOTE: forward-fill may cross group boundaries; a filled value from
        # another group is rejected by requiring the previous ROW to be in
        # the same group AND the fill to come from within it.  Track the
        # group id of the fill source through the same scan.
        gsrc = jnp.where(m_s, gids, -1)
        _, src_g = jax.lax.associative_scan(
            combine, (m_s, gsrc))
        prev_src_g = jnp.concatenate([jnp.full((1,), -1, src_g.dtype),
                                      src_g[:-1]])
        ok = m_s & prev_p & (prev_src_g == gids)
        delta = jnp.where(ok & (v_s > prev_v), v_s - prev_v, 0)
        return [g.reduce_sorted("sum", delta, m_s)]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("deltaSum cannot merge partial states")

    def finalize(self, states):
        want = self.result_type().jnp_dtype
        return states[0].astype(want), None


class QuantileExactWeightedAgg(AggregateFunction):
    """quantileExactWeighted(q)(x, w): the value at the q-th point of the
    weight-cumulative distribution (reference:
    AggregateFunctionQuantile.cpp QuantileExactWeighted)."""
    name = "quantileExactWeighted"
    holistic = True

    def __init__(self, arg_types, q: float = 0.5):
        super().__init__(arg_types)
        self.q = float(q)

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def state_ops(self):
        raise TypeError_("quantileExactWeighted states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        cap = ctx.row_valid.shape[0]
        value = self._value(ctx, args[0])
        weight = self._value(ctx, args[1]).astype(jnp.float64)
        tok = sort_ops.order_token(value)
        mask = self._row_mask(ctx, args, cond)
        g2 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                   ctx.num_groups_cap, secondary=[tok],
                                   payloads=[mask, value, weight])
        m_s = g2.take(mask)
        v_s = g2.take(value)
        w_s = jnp.where(m_s, g2.take(weight), 0.0)
        total = g2.reduce_sorted("sum", w_s, m_s)
        # running weight within the group
        cw = jnp.cumsum(w_s)
        gid = jnp.minimum(g2.group_ids, ctx.num_groups_cap - 1)
        before = jnp.where(g2.starts > 0,
                           cw[jnp.maximum(g2.starts - 1, 0)], 0.0)
        run = cw - before[gid]
        # first row whose cumulative weight reaches q * total
        need = self.q * total[gid]
        hit = m_s & (run >= need - 1e-12)
        rowid = jnp.arange(cap, dtype=jnp.int64)
        first_hit = agg_ops.group_by_sort  # noqa: F841 (readability)
        pick = g2.reduce_sorted("min", jnp.where(hit, rowid, cap), m_s)
        pick = jnp.clip(pick, 0, cap - 1)
        return [v_s[pick]]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("quantileExactWeighted cannot merge partial states")

    def finalize(self, states):
        return states[0], None


# -- combinators ---------------------------------------------------------------

class ArrayReduceAgg(AggregateFunction):
    """-Array combinator for reducible ops: per-row reduction over the
    array's elements feeds the scalar aggregate (sumArray, minArray, ...)."""
    holistic = False

    def __init__(self, inner: AggregateFunction, arg_types, row_op: str):
        self.inner = inner
        self.row_op = row_op
        super().__init__(arg_types)
        self.name = inner.name + "Array"

    def result_type(self):
        return self.inner.result_type()

    def state_ops(self):
        return self.inner.state_ops()

    @property
    def sum_only(self):
        return False

    def _scalarize(self, ctx, cv: ColVal):
        data = cv.data
        W = data.shape[1]
        live = jnp.arange(W, dtype=jnp.int32)[None, :] < cv.lengths[:, None]
        if self.row_op == "sum":
            acc = data.astype(jnp.float64) if data.dtype.kind == "f" \
                else data.astype(jnp.int64)
            red = jnp.sum(jnp.where(live, acc, 0), axis=1)
        elif self.row_op == "min":
            big = jnp.asarray(jnp.inf if data.dtype.kind == "f"
                              else jnp.iinfo(jnp.int64).max,
                              jnp.float64 if data.dtype.kind == "f"
                              else jnp.int64)
            red = jnp.min(jnp.where(live, data.astype(big.dtype), big),
                          axis=1)
        else:                                 # max
            small = jnp.asarray(-jnp.inf if data.dtype.kind == "f"
                                else jnp.iinfo(jnp.int64).min,
                                jnp.float64 if data.dtype.kind == "f"
                                else jnp.int64)
            red = jnp.max(jnp.where(live, data.astype(small.dtype), small),
                          axis=1)
        nonempty = cv.lengths > 0
        validity = cv.validity
        v = nonempty.astype(jnp.uint8) if validity is None \
            else (validity.astype(jnp.bool_) & nonempty).astype(jnp.uint8)
        inner_t = dt.array_inner(dt.remove_nullable(self.arg_types[0]))
        return ColVal(dt.make_nullable(inner_t), red, v)

    def update(self, ctx, args, cond):
        return self.inner.update(ctx, [self._scalarize(ctx, args[0])], cond)

    def merge(self, states, grouping, mask_raw):
        return self.inner.merge(states, grouping, mask_raw)

    def finalize(self, states):
        return self.inner.finalize(states)


class AvgArrayAgg(AggregateFunction):
    """avgArray(arr): mean over all elements of all arrays in the group."""
    name = "avgArray"

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        return ["sum", "sum"]

    def update(self, ctx, args, cond):
        cv = args[0]
        mask = self._row_mask(ctx, args, cond)
        W = cv.data.shape[1]
        live = jnp.arange(W, dtype=jnp.int32)[None, :] < cv.lengths[:, None]
        sums = jnp.sum(jnp.where(live, cv.data.astype(jnp.float64), 0.0),
                       axis=1)
        cnts = cv.lengths.astype(jnp.int64)
        g = ctx.grouping
        return [g.reduce("sum", sums, mask),
                g.reduce("sum", jnp.where(mask, cnts, 0), mask)]

    def merge(self, states, grouping, mask_raw):
        return [grouping.reduce("sum", states[0], mask_raw),
                grouping.reduce("sum", states[1], mask_raw)]

    def finalize(self, states):
        s, c = states
        return s / jnp.maximum(c, 1).astype(jnp.float64), None


class ForEachAgg(AggregateFunction):
    """-ForEach combinator: positional aggregation over array elements —
    out[j] = op over element j of the group's rows (sum/min/max/count/avg,
    reference: AggregateFunctionForEach.h)."""
    holistic = True

    def __init__(self, inner_name: str, arg_types):
        self.op = inner_name            # sum | min | max | count | avg
        super().__init__(arg_types)
        self.name = inner_name + "ForEach"

    def result_type(self):
        inner = dt.array_inner(dt.remove_nullable(self.arg_types[0]))
        if self.op == "count":
            return dt.Array(dt.UInt64)
        if self.op == "avg":
            return dt.Array(dt.Float64)
        if self.op == "sum" and inner.np_dtype.kind in "iu":
            return dt.Array(dt.Int64 if inner.np_dtype.kind == "i"
                            else dt.UInt64)
        return dt.Array(inner)

    def state_ops(self):
        raise TypeError_("ForEach states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        cv = args[0]
        mask = self._row_mask(ctx, args, cond)
        g = ctx.grouping
        W = cv.data.shape[1]
        live = (jnp.arange(W, dtype=jnp.int32)[None, :]
                < cv.lengths[:, None]) & mask[:, None]

        def col_reduce(op, col, m):
            return g.reduce(op, col, m)

        cols = []
        for j in range(W):              # static width: unrolled reduces
            m_j = live[:, j]
            if self.op == "count":
                cols.append(g.reduce("sum", m_j.astype(jnp.int64), m_j))
            elif self.op == "avg":
                s = g.reduce("sum", jnp.where(
                    m_j, cv.data[:, j].astype(jnp.float64), 0.0), mask)
                c = g.reduce("sum", m_j.astype(jnp.int64), mask)
                cols.append(s / jnp.maximum(c, 1).astype(jnp.float64))
            elif self.op == "sum":
                acc = cv.data[:, j].astype(
                    jnp.float64 if cv.data.dtype.kind == "f" else jnp.int64)
                cols.append(g.reduce("sum", jnp.where(m_j, acc, 0), mask))
            else:
                cols.append(g.reduce(self.op,
                                     cv.data[:, j], m_j))
        mat = jnp.stack(cols, axis=1)
        lens = g.reduce("max", cv.lengths.astype(jnp.int64), mask)
        return [mat, jnp.clip(lens, 0, W).astype(jnp.int32)]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("ForEach cannot merge partial states")

    def finalize(self, states):
        mat, lens = states
        want = dt.array_inner(self.result_type()).jnp_dtype
        return mat.astype(want), None, lens


class DistinctAgg(AggregateFunction):
    """-Distinct combinator: the inner aggregate sees only the first
    occurrence of each argument value within its group (reference:
    AggregateFunctionDistinct.h)."""
    holistic = True

    def __init__(self, inner: AggregateFunction):
        self.inner = inner
        super().__init__(inner.arg_types)
        self.name = inner.name + "Distinct"

    def result_type(self):
        return self.inner.result_type()

    def state_ops(self):
        raise TypeError_("-Distinct states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        import dataclasses
        value = self._value(ctx, args[0]) if args \
            else jnp.zeros(ctx.row_valid.shape, jnp.int32)
        mask = self._row_mask(ctx, args, cond)
        notm = jnp.logical_not(mask)
        g1 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                   ctx.num_groups_cap,
                                   secondary=[notm, value])
        m1 = jnp.logical_not(g1.take(notm))
        v1 = hash_ops.sortable_bits(g1.take(value))[0]       # bit equality
        prev_same = jnp.concatenate(
            [jnp.zeros((1,), jnp.bool_),
             (v1[1:] == v1[:-1]) & (g1.group_ids[1:] == g1.group_ids[:-1])])
        keep_sorted = m1 & jnp.logical_not(prev_same)
        _, keep_raw = jax.lax.sort(
            [g1.perm, keep_sorted.astype(jnp.int32)], num_keys=1,
            is_stable=False)
        keep = keep_raw.astype(jnp.bool_) & mask
        ctx2 = dataclasses.replace(ctx, premask=None)
        return self.inner.update(ctx2, args, keep)

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("-Distinct cannot merge partial states")

    def finalize(self, states):
        return self.inner.finalize(states)


class CountArrayAgg(AggregateFunction):
    """countArray(arr): total number of elements across the group."""
    name = "countArray"

    def result_type(self):
        return dt.UInt64

    def state_ops(self):
        return ["sum"]

    def update(self, ctx, args, cond):
        cv = args[0]
        mask = self._row_mask(ctx, args, cond)
        lens = cv.lengths.astype(jnp.int64)
        return [ctx.grouping.reduce("sum", jnp.where(mask, lens, 0), mask)]

    def merge(self, states, grouping, mask_raw):
        return [grouping.reduce("sum", states[0], mask_raw)]

    def finalize(self, states):
        return states[0].astype(jnp.uint64), None


_ARRAY_OPS = {"sum": "sum", "min": "min", "max": "max"}
_FOREACH_OPS = {"sum", "min", "max", "count", "avg"}


def make_array_combinator(base_name: str, inner_cls, arg_types):
    """-Array combinator instance, or None when unsupported."""
    if not arg_types or not dt.remove_nullable(arg_types[0]).is_array:
        return None
    inner_t = dt.array_inner(dt.remove_nullable(arg_types[0]))
    if inner_t.is_dictionary:
        return None
    if base_name == "avg":
        return AvgArrayAgg(arg_types)
    if base_name == "count":
        return CountArrayAgg(arg_types)
    if base_name not in _ARRAY_OPS:
        return None
    scalar_t = dt.make_nullable(inner_t)
    inner = inner_cls([scalar_t])
    return ArrayReduceAgg(inner, arg_types, _ARRAY_OPS[base_name])


def make_foreach_combinator(base_name: str, arg_types):
    if base_name not in _FOREACH_OPS or not arg_types \
            or not dt.remove_nullable(arg_types[0]).is_array:
        return None
    inner_t = dt.array_inner(dt.remove_nullable(arg_types[0]))
    if inner_t.is_dictionary:
        return None
    return ForEachAgg(base_name, arg_types)


class SumCountAgg(AggregateFunction):
    """sumCount(x) -> (sum, count) tuple (AggregateFunctionSumCount.cpp)."""
    name = "sumCount"
    sum_only = False

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        st = dt.Float64 if base.np_dtype.kind == "f" else (
            dt.Int64 if base.np_dtype.kind == "i" else dt.UInt64)
        return dt.Tuple([st, dt.UInt64])

    def state_ops(self):
        return ["sum", "sum"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._value(ctx, args[0])
        acc = v.astype(jnp.float64 if v.dtype.kind == "f" else jnp.int64)
        g = ctx.grouping
        return [g.reduce("sum", jnp.where(mask, acc, 0), mask),
                g.reduce("sum", mask.astype(jnp.int64), mask)]

    def merge(self, states, grouping, mask_raw):
        return [grouping.reduce("sum", states[0], mask_raw),
                grouping.reduce("sum", states[1], mask_raw)]

    def finalize(self, states):
        st, ct = dt.tuple_inner(self.result_type())
        sub = [ColVal(st, states[0].astype(st.jnp_dtype), None),
               ColVal(ct, states[1].astype(jnp.uint64), None)]
        return jnp.zeros(states[0].shape, jnp.int32), None, None, sub


class UniqUpToAgg(AggregateFunction):
    """uniqUpTo(N)(x): exact distinct count up to N, else N+1
    (AggregateFunctionUniqUpTo.h)."""
    name = "uniqUpTo"
    holistic = True

    def __init__(self, arg_types, n: int = 5):
        super().__init__(arg_types)
        self.n = int(n)

    def result_type(self):
        return dt.UInt64

    def state_ops(self):
        raise TypeError_("uniqUpTo states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        from .aggregates import UniqExactAgg
        inner = UniqExactAgg(self.arg_types)
        return inner.update(ctx, args, cond)

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("uniqUpTo cannot merge partial states")

    def finalize(self, states):
        return jnp.minimum(states[0].astype(jnp.uint64),
                           jnp.uint64(self.n + 1)), None


class SimpleLinearRegressionAgg(AggregateFunction):
    """simpleLinearRegression(x, y) -> (k, b): least-squares line from the
    sufficient sums (AggregateFunctionSimpleLinearRegression.cpp)."""
    name = "simpleLinearRegression"

    def result_type(self):
        return dt.Tuple([dt.Float64, dt.Float64])

    def state_ops(self):
        return ["sum"] * 5

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        x = self._value(ctx, args[0]).astype(jnp.float64)
        y = self._value(ctx, args[1]).astype(jnp.float64)
        g = ctx.grouping
        z = jnp.zeros((), jnp.float64)
        return [g.reduce("sum", jnp.where(mask, x, z), mask),
                g.reduce("sum", jnp.where(mask, y, z), mask),
                g.reduce("sum", jnp.where(mask, x * x, z), mask),
                g.reduce("sum", jnp.where(mask, x * y, z), mask),
                g.reduce("sum", mask.astype(jnp.float64), mask)]

    def merge(self, states, grouping, mask_raw):
        return [grouping.reduce("sum", s, mask_raw) for s in states]

    def finalize(self, states):
        sx, sy, sxx, sxy, n = states
        denom = n * sxx - sx * sx
        k = jnp.where(denom != 0, (n * sxy - sx * sy) / jnp.where(
            denom != 0, denom, 1.0), jnp.nan)
        b = jnp.where(n > 0, (sy - k * sx) / jnp.where(n > 0, n, 1.0),
                      jnp.nan)
        t1, t2 = dt.tuple_inner(self.result_type())
        sub = [ColVal(t1, k, None), ColVal(t2, b, None)]
        return jnp.zeros(k.shape, jnp.int32), None, None, sub


class _TTestBase(AggregateFunction):
    """Two-sample t-tests: value + 0/1 population index -> (t, p)
    (AggregateFunctionTTest.h).  p-value via the regularized incomplete
    beta function."""

    def result_type(self):
        return dt.Tuple([dt.Float64, dt.Float64])

    def state_ops(self):
        return ["sum"] * 6

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        x = self._value(ctx, args[0]).astype(jnp.float64)
        grp = self._value(ctx, args[1]).astype(jnp.int64)
        g = ctx.grouping
        z = jnp.zeros((), jnp.float64)
        m0 = mask & (grp == 0)
        m1 = mask & (grp != 0)
        return [g.reduce("sum", m0.astype(jnp.float64), mask),
                g.reduce("sum", jnp.where(m0, x, z), mask),
                g.reduce("sum", jnp.where(m0, x * x, z), mask),
                g.reduce("sum", m1.astype(jnp.float64), mask),
                g.reduce("sum", jnp.where(m1, x, z), mask),
                g.reduce("sum", jnp.where(m1, x * x, z), mask)]

    def merge(self, states, grouping, mask_raw):
        return [grouping.reduce("sum", s, mask_raw) for s in states]

    def _t_and_df(self, states):
        raise NotImplementedError

    def finalize(self, states):
        t, df = self._t_and_df(states)
        # two-sided p = I_{df/(df+t^2)}(df/2, 1/2)
        from jax.scipy.special import betainc
        dfc = jnp.maximum(df, 1e-9)
        xarg = dfc / (dfc + t * t)
        p = betainc(dfc / 2.0, 0.5, jnp.clip(xarg, 0.0, 1.0))
        t1, t2 = dt.tuple_inner(self.result_type())
        sub = [ColVal(t1, t, None), ColVal(t2, p, None)]
        return jnp.zeros(t.shape, jnp.int32), None, None, sub


class StudentTTestAgg(_TTestBase):
    name = "studentTTest"

    def _t_and_df(self, states):
        n0, s0, ss0, n1, s1, ss1 = states
        n0c = jnp.maximum(n0, 1.0)
        n1c = jnp.maximum(n1, 1.0)
        m0 = s0 / n0c
        m1 = s1 / n1c
        v0 = ss0 / n0c - m0 * m0
        v1 = ss1 / n1c - m1 * m1
        df = n0 + n1 - 2.0
        sp2 = (n0 * v0 + n1 * v1) / jnp.maximum(df, 1e-9)
        se = jnp.sqrt(sp2 * (1.0 / n0c + 1.0 / n1c))
        t = (m0 - m1) / jnp.maximum(se, 1e-300)
        return t, df


class WelchTTestAgg(_TTestBase):
    name = "welchTTest"

    def _t_and_df(self, states):
        n0, s0, ss0, n1, s1, ss1 = states
        n0c = jnp.maximum(n0, 1.0)
        n1c = jnp.maximum(n1, 1.0)
        m0 = s0 / n0c
        m1 = s1 / n1c
        v0 = (ss0 / n0c - m0 * m0) * n0c / jnp.maximum(n0c - 1.0, 1e-9)
        v1 = (ss1 / n1c - m1 * m1) * n1c / jnp.maximum(n1c - 1.0, 1e-9)
        a = v0 / n0c
        b = v1 / n1c
        t = (m0 - m1) / jnp.sqrt(jnp.maximum(a + b, 1e-300))
        df = (a + b) ** 2 / jnp.maximum(
            a * a / jnp.maximum(n0c - 1.0, 1e-9)
            + b * b / jnp.maximum(n1c - 1.0, 1e-9), 1e-300)
        return t, df


class GroupArrayMovingSumAgg(AggregateFunction):
    """groupArrayMovingSum(x): per-group running sums in row order
    (AggregateFunctionMovingSum)."""
    name = "groupArrayMovingSum"
    holistic = True
    moving_avg = False

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        if self.moving_avg or base.np_dtype.kind == "f":
            return dt.Array(dt.Float64)
        return dt.Array(dt.Int64 if base.np_dtype.kind == "i"
                        else dt.UInt64)

    def state_ops(self):
        raise TypeError_("moving aggregates cannot merge partial states; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        from .agg_sketch import GroupArrayAgg
        inner = GroupArrayAgg(self.arg_types)
        mat, lens = inner.update(ctx, args, cond)
        live = jnp.arange(mat.shape[1])[None, :] < lens[:, None]
        acc = jnp.cumsum(jnp.where(live, mat.astype(jnp.float64), 0.0),
                         axis=1)
        if self.moving_avg:
            acc = acc / jnp.maximum(
                jnp.arange(1, mat.shape[1] + 1)[None, :], 1)
        acc = jnp.where(live, acc, 0.0)
        return [acc, lens]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("moving aggregates cannot merge partial states")

    def finalize(self, states):
        want = dt.array_inner(self.result_type()).jnp_dtype
        return states[0].astype(want), None, states[1]


class GroupArrayMovingAvgAgg(GroupArrayMovingSumAgg):
    name = "groupArrayMovingAvg"
    moving_avg = True


class OrNullAgg(AggregateFunction):
    """-OrNull / -OrDefault combinators: empty groups yield NULL (or the
    default value) instead of the aggregate's zero state (reference:
    AggregateFunctionOrFill.h)."""

    def __init__(self, inner: AggregateFunction, null: bool):
        self.inner = inner
        self.null = null
        super().__init__(inner.arg_types)
        self.name = inner.name + ("OrNull" if null else "OrDefault")

    @property
    def holistic(self):
        return self.inner.holistic

    @property
    def sum_only(self):
        return False

    def result_type(self):
        t = self.inner.result_type()
        return dt.make_nullable(t) if self.null else t

    def state_ops(self):
        return self.inner.state_ops() + ["sum"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        states = self.inner.update(ctx, args, cond)
        cnt = ctx.grouping.reduce("sum", mask.astype(jnp.int64), mask)
        return states + [cnt]

    def merge(self, states, grouping, mask_raw):
        inner = self.inner.merge(states[:-1], grouping, mask_raw)
        return inner + [grouping.reduce("sum", states[-1], mask_raw)]

    def finalize(self, states):
        out = self.inner.finalize(states[:-1])
        cnt = states[-1]
        data, validity = out[0], out[1]
        rest = out[2:]
        if self.null:
            seen = (cnt > 0).astype(jnp.uint8)
            validity = seen if validity is None \
                else (validity.astype(jnp.bool_)
                      & (cnt > 0)).astype(jnp.uint8)
        return (data, validity) + tuple(rest)

"""Aggregate function registry with the mergeable-state algebra.

The analog of the reference's IAggregateFunction
(src/AggregateFunctions/IAggregateFunction.h:55): each function defines
  * update  -- rows -> per-group partial states (add/addBatch analog)
  * merge   -- partial states re-grouped by key -> combined states
  * finalize-- states -> result column (insertResultInto analog)
States are ordinary fixed-width columns, so partial aggregation results ship
through the exact machinery of regular blocks — the property behind two-stage
distributed aggregation (QueryProcessingStage::WithMergeableState).

All reductions go through Grouping.reduce (ops/agg_ops.py) — segmented scans
for sort grouping, one-hot matmuls for dense, plain reductions for global — so
no aggregate ever issues a scatter.

Combinators (-If; reference: AggregateFunctionCombinatorFactory) wrap the row
mask.  `holistic` functions (uniqExact, quantileExact, median) need all rows
of a group co-located; the distributed planner repartitions by key for them
(SURVEY.md §2.6 partition-parallel aggregation).  `sum_only` functions can
run on the dense (matmul) grouping.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, TypeError_, UnknownFunction
from ..ops import agg_ops, hash_ops, sort_ops
from .expr import ColVal

__all__ = ["AggregateFunction", "get_aggregate", "is_aggregate_name",
           "AGGREGATES", "GroupContext"]


@dataclasses.dataclass
class GroupContext:
    """Everything an aggregate needs to produce per-group states."""
    keys: List[jax.Array]          # raw (unsorted) key storage arrays
    row_valid: jax.Array           # raw bool mask
    grouping: agg_ops.Grouping
    num_groups_cap: int
    # per-aggregate row mask precomputed by the executor so the SAME array
    # object rides the grouping sort as a payload (Grouping.take identity
    # cache) instead of being recomputed and randomly gathered
    premask: Optional[jax.Array] = None
    # executor capacity-check sink + active settings (for size-bounded
    # aggregates like groupArray to report truncation for autotuning)
    checks: Optional[list] = None
    settings: Optional[object] = None


def _arg_valid(cv: Optional[ColVal], capacity: int):
    if cv is None or cv.validity is None:
        return None
    v = cv.validity.astype(jnp.bool_)
    if v.ndim == 0:
        v = jnp.broadcast_to(v, (capacity,))
    return v


def compose_row_mask(row_valid: jax.Array, args: List[ColVal],
                     cond: Optional[jax.Array]) -> jax.Array:
    """rows an aggregate consumes: valid & arg validities & -If condition."""
    cap = row_valid.shape[0]
    m = row_valid
    for a in args:
        av = _arg_valid(a, cap)
        if av is not None:
            m = m & av
    if cond is not None:
        m = m & cond
    return m


class AggregateFunction:
    """Base class.  Subclasses set `state_ops` (merge op per state column)."""

    name: str = ""
    holistic: bool = False
    sum_only: bool = False      # True: all reductions are sums (dense-able)

    def __init__(self, arg_types: List[dt.DType]):
        self.arg_types = arg_types

    # -- interface -----------------------------------------------------------
    def result_type(self) -> dt.DType:
        raise NotImplementedError

    def state_ops(self) -> List[str]:
        """Merge op per state column: sum|min|max|any."""
        raise NotImplementedError

    def update(self, ctx: GroupContext, args: List[ColVal],
               cond: Optional[jax.Array]) -> List[jax.Array]:
        """args are *raw* (unsorted) column values; cond is a raw bool mask
        from an -If combinator (or None)."""
        raise NotImplementedError

    def merge(self, states: List[jax.Array], grouping: agg_ops.Grouping,
              mask_raw: jax.Array) -> List[jax.Array]:
        """states are per-row partial-state columns (raw order) to combine."""
        return [grouping.reduce(op, s, mask_raw)
                for op, s in zip(self.state_ops(), states)]

    def finalize(self, states: List[jax.Array]
                 ) -> Tuple[jax.Array, Optional[jax.Array]]:
        """-> (data, validity or None), each (num_groups_cap,)."""
        raise NotImplementedError

    def pin_state_layout(self) -> None:
        """Make the state layout context-independent (required before the
        state is stored as a column value: -State/-Merge).  Functions whose
        state width adapts to the grouping capacity (HLL register count)
        override this to pin a fixed width."""

    # -- helpers -------------------------------------------------------------
    def _row_mask(self, ctx: GroupContext, args: List[ColVal],
                  cond: Optional[jax.Array]) -> jax.Array:
        if ctx.premask is not None:
            return ctx.premask
        return compose_row_mask(ctx.row_valid, args, cond)

    @staticmethod
    def _value(ctx: GroupContext, cv: ColVal) -> jax.Array:
        return cv.broadcast(ctx.row_valid.shape[0]).data


# -- concrete aggregates -----------------------------------------------------

class CountAgg(AggregateFunction):
    name = "count"
    sum_only = True

    def result_type(self):
        return dt.UInt64

    def state_ops(self):
        return ["sum"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [ctx.grouping.count_rows(mask)]

    def finalize(self, states):
        return states[0].astype(jnp.uint64), None


def _sum_state_dtype(t: dt.DType):
    t0 = dt.remove_nullable(t)
    if dt.is_float(t0):
        return jnp.float64
    if t0.np_dtype.kind == "u":
        return jnp.uint64
    return jnp.int64


class SumAgg(AggregateFunction):
    name = "sum"

    @property
    def sum_only(self):
        # float sums are served by the sort path (exactness: see mxu_segsum)
        return not dt.is_float(dt.remove_nullable(self.arg_types[0]))

    def result_type(self):
        t0 = dt.remove_nullable(self.arg_types[0])
        if dt.is_decimal(t0):
            return dt.Decimal(38, t0.decimal_scale)   # sum widens precision
        if dt.is_float(t0):
            return dt.Float64
        return dt.UInt64 if t0.np_dtype.kind == "u" else dt.Int64

    def state_ops(self):
        return ["sum"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        # no pre-cast: reduce upcasts post-permute, so the raw column array
        # stays identity-matched with the grouping's sorted payload
        v = self._value(ctx, args[0])
        s = ctx.grouping.reduce("sum", v, mask, value_bounds=args[0].bounds)
        return [s.astype(_sum_state_dtype(self.arg_types[0]))]

    def finalize(self, states):
        return states[0], None


class MinMaxAgg(AggregateFunction):
    op = "min"

    def __init__(self, arg_types):
        super().__init__(arg_types)
        self._dict_order: Optional[jax.Array] = None

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def state_ops(self):
        return [self.op]

    def _prep(self, ctx, cv: ColVal):
        """For dictionary (string) args, aggregate lexicographic ranks and
        map back to codes in finalize (codes are unordered after merges)."""
        v = self._value(ctx, cv)
        if cv.dictionary is not None and len(cv.dictionary):
            vals = cv.dictionary.values.astype(str)
            order = np.argsort(vals, kind="stable")
            rank = np.empty(len(vals), np.int64)
            rank[order] = np.arange(len(vals))
            self._dict_order = jnp.asarray(order.astype(np.int32))
            return jnp.asarray(rank)[jnp.maximum(v, 0)]
        return v

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._prep(ctx, args[0])
        return [ctx.grouping.reduce(self.op, v, mask)]

    def finalize(self, states):
        s = states[0]
        if self._dict_order is not None:
            n = self._dict_order.shape[0]
            s = self._dict_order[jnp.clip(s, 0, n - 1)]
        return s, None


class MinAgg(MinMaxAgg):
    name, op = "min", "min"


class MaxAgg(MinMaxAgg):
    name, op = "max", "max"


class AvgAgg(AggregateFunction):
    name = "avg"

    @property
    def sum_only(self):
        return not dt.is_float(dt.remove_nullable(self.arg_types[0]))

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        return ["sum", "sum"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._value(ctx, args[0])
        s = ctx.grouping.reduce("sum", v, mask, value_bounds=args[0].bounds)
        c = ctx.grouping.count_rows(mask)
        return [s.astype(jnp.float64), c]

    def finalize(self, states):
        s, c = states
        safe = jnp.maximum(c, 1)
        out = s.astype(jnp.float64) / safe.astype(jnp.float64)
        t0 = dt.remove_nullable(self.arg_types[0])
        if dt.is_decimal(t0):
            out = out / float(10 ** t0.decimal_scale)
        return out, None


class AnyAgg(AggregateFunction):
    name = "any"

    def result_type(self):
        return self.arg_types[0]

    def state_ops(self):
        return ["any"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        return [ctx.grouping.reduce("any", self._value(ctx, args[0]), mask)]

    def finalize(self, states):
        return states[0], None


class AnyRespectNullsAgg(AggregateFunction):
    """any/first_value/last_value ... RESPECT NULLS: select a row of the
    group with NULLs treated as first-class values — any(x) RESPECT NULLS
    over [NULL, 1] is NULL, not 1 (ref:
    src/AggregateFunctions/AggregateFunctionAnyRespectNulls.cpp).  Two
    states pick the SAME row ('any' reduce = deterministic first masked-in
    row): the value and that row's validity."""
    name = "any_respect_nulls"
    respect_nulls = True        # executor: keep NULL rows in the premask

    def result_type(self):
        return self.arg_types[0]

    def state_ops(self):
        return ["any", "any"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        cap = ctx.row_valid.shape[0]
        v = self._value(ctx, args[0])
        av = _arg_valid(args[0], cap)
        av = (jnp.ones((cap,), jnp.int32) if av is None
              else av.astype(jnp.int32))
        return [ctx.grouping.reduce("any", v, mask),
                ctx.grouping.reduce("any", av, mask)]

    def _row_mask(self, ctx, args, cond):
        if ctx.premask is not None:
            return ctx.premask
        return compose_row_mask(ctx.row_valid, [], cond)

    def finalize(self, states):
        return states[0], states[1].astype(jnp.uint8)


class SumSquaresMixin(AggregateFunction):
    """Shared states for the variance family: [sum, sum_sq, count]."""

    def state_ops(self):
        return ["sum", "sum", "sum"]

    def result_type(self):
        return dt.Float64

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._value(ctx, args[0]).astype(jnp.float64)
        return [ctx.grouping.reduce("sum", v, mask),
                ctx.grouping.reduce("sum", v * v, mask),
                ctx.grouping.count_rows(mask)]

    def _moments(self, states):
        s, s2, c = states
        cf = jnp.maximum(c, 1).astype(jnp.float64)
        mean = s / cf
        var = s2 / cf - mean * mean
        return jnp.maximum(var, 0.0), c.astype(jnp.float64)


class VarPopAgg(SumSquaresMixin):
    name = "varPop"

    def finalize(self, states):
        var, _ = self._moments(states)
        return var, None


class VarSampAgg(SumSquaresMixin):
    name = "varSamp"

    def finalize(self, states):
        var, c = self._moments(states)
        corr = c / jnp.maximum(c - 1.0, 1.0)
        return var * corr, None


class StddevPopAgg(VarPopAgg):
    name = "stddevPop"

    def finalize(self, states):
        var, _ = self._moments(states)
        return jnp.sqrt(var), None


class StddevSampAgg(VarSampAgg):
    name = "stddevSamp"

    def finalize(self, states):
        v, _ = VarSampAgg.finalize(self, states)
        return jnp.sqrt(v), None


class ArgMinMaxAgg(AggregateFunction):
    """argMin(val, ord) / argMax: value at the extremum of ord.

    States: [best_token(u64, min-merged), value_at_best(any-merged)] — after
    the token reduce, rows at the group's best token select the value.
    """
    minimize = True

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def state_ops(self):
        return ["min", "any"]

    def update(self, ctx, args, cond):
        g = ctx.grouping
        cap = ctx.row_valid.shape[0]
        mask = self._row_mask(ctx, args, cond)
        val = self._value(ctx, args[0])
        tok = sort_ops.order_token(self._value(ctx, args[1]),
                                   descending=not self.minimize)
        ms = g.take(mask)
        ts = g.take(tok)
        best = g.reduce_sorted("min", ts, ms)
        gid = jnp.minimum(g.group_ids, g.num_groups_cap - 1)
        at_best = ms & (ts == best[gid])
        vs = g.take(val)
        value = g.reduce_sorted("any", vs, at_best)
        return [best, value]

    def merge(self, states, grouping, mask_raw):
        tok, val = states
        g = grouping
        ms = g.take(mask_raw)
        ts = g.take(tok)
        best = g.reduce_sorted("min", ts, ms)
        gid = jnp.minimum(g.group_ids, g.num_groups_cap - 1)
        at_best = ms & (ts == best[gid])
        vs = g.take(val)
        value = g.reduce_sorted("any", vs, at_best)
        return [best, value]

    def finalize(self, states):
        return states[1], None


class ArgMinAgg(ArgMinMaxAgg):
    name, minimize = "argMin", True


class ArgMaxAgg(ArgMinMaxAgg):
    name, minimize = "argMax", False


class UniqExactAgg(AggregateFunction):
    """Exact distinct count — holistic (needs all rows of a key together).

    Secondary-sorted grouping by (keys, value): distinct count per key =
    number of first-occurrence rows in the key's segment.
    """
    name = "uniqExact"
    holistic = True

    def result_type(self):
        return dt.UInt64

    def state_ops(self):
        return ["sum"]

    def update(self, ctx, args, cond):
        cap = ctx.row_valid.shape[0]
        value = self._value(ctx, args[0])
        mask = self._row_mask(ctx, args, cond)
        # masked-out rows sink below valid ones inside each key segment so
        # the first-occurrence chain below only ever sees valid neighbours
        notm = jnp.logical_not(mask)
        g2 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                   ctx.num_groups_cap,
                                   secondary=[notm, value])
        mask_s = jnp.logical_not(g2.take(notm))
        # distinct by bit pattern (float == would merge -0.0 with +0.0 and
        # split equal NaNs)
        v_s = hash_ops.sortable_bits(g2.take(value))[0]
        prev_same = jnp.concatenate(
            [jnp.zeros((1,), jnp.bool_),
             (v_s[1:] == v_s[:-1]) & (g2.group_ids[1:] == g2.group_ids[:-1])])
        is_first = mask_s & jnp.logical_not(prev_same)
        return [g2.reduce_sorted("sum", is_first.astype(jnp.int64), mask_s)]

    def finalize(self, states):
        return states[0].astype(jnp.uint64), None


class QuantileExactAgg(AggregateFunction):
    """quantileExact(q)(x) — holistic; group-locally sorts values.

    With ``qs`` set (quantiles(q1, q2, ...)(x)), produces an Array result of
    all requested quantiles from the same single segment sort."""
    name = "quantileExact"
    holistic = True

    def __init__(self, arg_types, q: float = 0.5, qs=None):
        super().__init__(arg_types)
        self.q = q
        self.qs = list(qs) if qs is not None else None

    def result_type(self):
        base = dt.remove_nullable(self.arg_types[0])
        return dt.Array(base) if self.qs is not None else base

    def state_ops(self):
        raise TypeError_("quantileExact states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        cap = ctx.row_valid.shape[0]
        value = self._value(ctx, args[0])
        tok = sort_ops.order_token(value)
        mask = self._row_mask(ctx, args, cond)
        # sort by (key, masked-out-last, value): within each key group the
        # masked-in rows come first in value order, so the q-th element sits
        # at a computable offset from the group start.
        g2 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                   ctx.num_groups_cap, secondary=[tok],
                                   payloads=[mask, value])
        mask_s = g2.take(mask)
        lens = g2.reduce_sorted("sum", mask_s.astype(jnp.int64), mask_s)
        # compact masked sorted values to rank order (gather-based)
        from ..ops import filter_ops
        v_s = g2.take(value)
        compacted, _ = filter_ops.compact_arrays([v_s], mask_s)
        # start of each group within the compacted array
        starts_c = jnp.cumsum(lens) - lens

        def pick_at(q):
            pick = starts_c + jnp.clip(
                jnp.floor(q * (lens - 1).astype(jnp.float64)).astype(jnp.int64),
                0, jnp.maximum(lens - 1, 0))
            return compacted[0][jnp.clip(pick, 0, cap - 1)]

        if self.qs is not None:
            mat = jnp.stack([pick_at(q) for q in self.qs], axis=1)
            lens_out = jnp.full(lens.shape, len(self.qs), jnp.int32)
            return [mat, lens_out]
        return [pick_at(self.q)]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("quantileExact cannot merge partial states")

    def finalize(self, states):
        if self.qs is not None:
            return states[0], None, states[1]
        return states[0], None


class MedianAgg(QuantileExactAgg):
    name = "median"

    def __init__(self, arg_types):
        super().__init__(arg_types, q=0.5)


class CovarAgg(AggregateFunction):
    """covarPop/covarSamp(x, y) — mergeable states [sxy, sx, sy, n].

    Reference: src/AggregateFunctions/AggregateFunctionStatisticsSimple.h
    (CovarMoments) — the same sums-of-products algebra, evaluated as
    whole-column segmented reductions."""
    sample = False

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        return ["sum", "sum", "sum", "sum"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        x = self._value(ctx, args[0]).astype(jnp.float64)
        y = self._value(ctx, args[1]).astype(jnp.float64)
        g = ctx.grouping
        return [g.reduce("sum", x * y, mask), g.reduce("sum", x, mask),
                g.reduce("sum", y, mask), g.count_rows(mask)]

    def finalize(self, states):
        sxy, sx, sy, n = states
        nf = n.astype(jnp.float64)
        safe = jnp.maximum(nf, 1.0)
        cov = sxy / safe - (sx / safe) * (sy / safe)
        if self.sample:
            cov = jnp.where(n > 1, cov * nf / (nf - 1.0), jnp.nan)
        return cov, None


class CovarPopAgg(CovarAgg):
    name, sample = "covarPop", False


class CovarSampAgg(CovarAgg):
    name, sample = "covarSamp", True


class CorrAgg(AggregateFunction):
    """corr(x, y) — states [sxy, sx, sy, sxx, syy, n]."""
    name = "corr"

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        return ["sum"] * 6

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        x = self._value(ctx, args[0]).astype(jnp.float64)
        y = self._value(ctx, args[1]).astype(jnp.float64)
        g = ctx.grouping
        return [g.reduce("sum", x * y, mask), g.reduce("sum", x, mask),
                g.reduce("sum", y, mask), g.reduce("sum", x * x, mask),
                g.reduce("sum", y * y, mask), g.count_rows(mask)]

    def finalize(self, states):
        sxy, sx, sy, sxx, syy, n = states
        nf = jnp.maximum(n.astype(jnp.float64), 1.0)
        num = sxy - sx * sy / nf
        den = jnp.sqrt(jnp.maximum(sxx - sx * sx / nf, 0.0)
                       * jnp.maximum(syy - sy * sy / nf, 0.0))
        return jnp.where(den > 0, num / den, jnp.nan), None


class MomentsAgg(AggregateFunction):
    """Base for skewness/kurtosis: states [s1, s2, s3, s4, n]."""

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        return ["sum"] * 5

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        x = self._value(ctx, args[0]).astype(jnp.float64)
        x2 = x * x
        g = ctx.grouping
        return [g.reduce("sum", x, mask), g.reduce("sum", x2, mask),
                g.reduce("sum", x2 * x, mask), g.reduce("sum", x2 * x2, mask),
                g.count_rows(mask)]

    def _central(self, states):
        s1, s2, s3, s4, n = states
        nf = jnp.maximum(n.astype(jnp.float64), 1.0)
        m = s1 / nf
        m2 = s2 / nf - m * m
        m3 = s3 / nf - 3 * m * s2 / nf + 2 * m ** 3
        m4 = s4 / nf - 4 * m * s3 / nf + 6 * m * m * s2 / nf - 3 * m ** 4
        var_samp = jnp.where(n > 1, m2 * nf / (nf - 1.0), jnp.nan)
        return jnp.maximum(m2, 0.0), m3, m4, var_samp, n


class SkewPopAgg(MomentsAgg):
    name = "skewPop"

    def finalize(self, states):
        m2, m3, _, _, n = self._central(states)
        return jnp.where(m2 > 0, m3 / m2 ** 1.5, jnp.nan), None


class SkewSampAgg(MomentsAgg):
    name = "skewSamp"

    def finalize(self, states):
        _, m3, _, vs, n = self._central(states)
        return jnp.where(vs > 0, m3 / vs ** 1.5, jnp.nan), None


class KurtPopAgg(MomentsAgg):
    name = "kurtPop"

    def finalize(self, states):
        m2, _, m4, _, n = self._central(states)
        return jnp.where(m2 > 0, m4 / (m2 * m2), jnp.nan), None


class KurtSampAgg(MomentsAgg):
    name = "kurtSamp"

    def finalize(self, states):
        _, _, m4, vs, n = self._central(states)
        return jnp.where(vs > 0, m4 / (vs * vs), jnp.nan), None


class AvgWeightedAgg(AggregateFunction):
    """avgWeighted(x, w) — states [sum(x*w), sum(w)]."""
    name = "avgWeighted"

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        return ["sum", "sum"]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        x = self._value(ctx, args[0]).astype(jnp.float64)
        w = self._value(ctx, args[1]).astype(jnp.float64)
        g = ctx.grouping
        return [g.reduce("sum", x * w, mask), g.reduce("sum", w, mask)]

    def finalize(self, states):
        s, w = states
        return jnp.where(w != 0, s / w, jnp.nan), None


class SumWithOverflowAgg(SumAgg):
    """sum that keeps the argument type (wrapping), like the reference's
    sumWithOverflow (src/AggregateFunctions/AggregateFunctionSum.h)."""
    name = "sumWithOverflow"

    def result_type(self):
        return dt.remove_nullable(self.arg_types[0])

    def finalize(self, states):
        want = dt.remove_nullable(self.arg_types[0]).jnp_dtype
        return states[0].astype(want), None


class GroupBitAgg(AggregateFunction):
    """groupBitAnd/Or/Xor — bitwise reductions over integer columns.

    Reference: src/AggregateFunctions/AggregateFunctionBitwise.h.  Runs on
    the sort grouping via segmented bitwise scans (scan_ops)."""
    bit_op = "bor"

    def result_type(self):
        t0 = dt.remove_nullable(self.arg_types[0])
        if not dt.is_integer(t0):
            raise TypeError_(f"{self.name} requires an integer argument")
        return t0

    def state_ops(self):
        return [self.bit_op]

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        v = self._value(ctx, args[0])
        return [ctx.grouping.reduce(self.bit_op, v, mask)]

    def finalize(self, states):
        want = dt.remove_nullable(self.arg_types[0]).jnp_dtype
        return states[0].astype(want), None


class GroupBitAndAgg(GroupBitAgg):
    name, bit_op = "groupBitAnd", "band"


class GroupBitOrAgg(GroupBitAgg):
    name, bit_op = "groupBitOr", "bor"


class GroupBitXorAgg(GroupBitAgg):
    name, bit_op = "groupBitXor", "bxor"


# -- registry ----------------------------------------------------------------

def _register_base() -> Dict[str, type]:
    from . import agg_sketch as sk
    base: Dict[str, type] = {}
    for _cls in [CountAgg, SumAgg, MinAgg, MaxAgg, AvgAgg, AnyAgg, VarPopAgg,
                 VarSampAgg, StddevPopAgg, StddevSampAgg, ArgMinAgg,
                 ArgMaxAgg, UniqExactAgg, MedianAgg, CovarPopAgg,
                 CovarSampAgg, CorrAgg, SkewPopAgg, SkewSampAgg, KurtPopAgg,
                 KurtSampAgg, AvgWeightedAgg, SumWithOverflowAgg,
                 GroupBitAndAgg, GroupBitOrAgg, GroupBitXorAgg,
                 sk.GroupArrayAgg, sk.GroupUniqArrayAgg, sk.TopKAgg,
                 sk.EntropyAgg, sk.HLLUniqAgg]:
        base[_cls.name.lower()] = _cls
    base["anylast"] = AnyAgg
    base["countdistinct"] = UniqExactAgg
    base["var_pop"] = VarPopAgg
    base["var_samp"] = VarSampAgg
    base["stddev_pop"] = StddevPopAgg
    base["stddev_samp"] = StddevSampAgg
    base["covar_pop"] = CovarPopAgg
    base["covar_samp"] = CovarSampAgg
    base["sumkahan"] = SumAgg           # segmented f64 sums are pairwise-exact
    base["anyheavy"] = AnyAgg           # heavy-hitter approximation
    base["uniqcombined"] = sk.HLLUniqAgg
    base["uniqcombined64"] = sk.HLLUniqAgg
    base["uniqhll12"] = sk.HLLUniqAgg
    base["grouparraydistinct"] = sk.GroupUniqArrayAgg
    base["quantile"] = QuantileExactAgg
    base["quantileexact"] = QuantileExactAgg
    base["quantileexactlow"] = QuantileExactAgg
    base["quantiles"] = QuantileExactAgg
    base["quantilesexact"] = QuantileExactAgg
    from . import agg_ext as ax
    for _cls in [ax.SumMapAgg, ax.MinMapAgg, ax.MaxMapAgg, ax.DeltaSumAgg,
                 ax.QuantileExactWeightedAgg, ax.SumCountAgg, ax.UniqUpToAgg,
                 ax.SimpleLinearRegressionAgg, ax.StudentTTestAgg,
                 ax.WelchTTestAgg, ax.GroupArrayMovingSumAgg,
                 ax.GroupArrayMovingAvgAgg]:
        base[_cls.name.lower()] = _cls
    from . import agg_ext2 as ax2
    for _cls in [ax2.WindowFunnelAgg, ax2.SequenceMatchAgg, ax2.RetentionAgg,
                 ax2.RankCorrAgg, ax2.BoundingRatioAgg]:
        base[_cls.name.lower()] = _cls
    from . import agg_ext3 as ax3
    for _cls in [ax3.ExponentialMovingAverageAgg,
                 ax3.ExponentialTimeDecayedSumAgg,
                 ax3.ExponentialTimeDecayedCountAgg,
                 ax3.ExponentialTimeDecayedAvgAgg,
                 ax3.ExponentialTimeDecayedMaxAgg,
                 ax3.IntervalLengthSumAgg, ax3.MaxIntersectionsAgg,
                 ax3.MaxIntersectionsPositionAgg, ax3.MeanZTestAgg,
                 ax3.MannWhitneyUTestAgg, ax3.CramersVAgg,
                 ax3.CramersVBiasCorrectedAgg, ax3.TheilsUAgg,
                 ax3.ContingencyAgg, ax3.SingleValueOrNullAgg,
                 ax3.GroupArraySortedAgg, ax3.GroupArrayLastAgg,
                 ax3.GroupArraySampleAgg]:
        base[_cls.name.lower()] = _cls
    base["varpopstable"] = VarPopAgg
    base["varsampstable"] = VarSampAgg
    base["stddevpopstable"] = StddevPopAgg
    base["stddevsampstable"] = StddevSampAgg
    base["covarpopstable"] = CovarPopAgg
    base["covarsampstable"] = CovarSampAgg
    base["corrstable"] = CorrAgg
    # documented approximation substitutions (APPROX_ALIASES below): the
    # sort-based holistic path computes these exactly, so the approximate
    # reference algorithms are unnecessary here — results are exact, which
    # may differ from the reference's approximate outputs
    base["quantiletdigest"] = QuantileExactAgg
    base["quantiledeterministic"] = QuantileExactAgg
    base["quantiletiming"] = QuantileExactAgg
    base["quantilebfloat16"] = QuantileExactAgg
    base["quantileinterpolatedweighted"] = ax.QuantileExactWeightedAgg
    base["quantiletimingweighted"] = ax.QuantileExactWeightedAgg
    base["quantiletdigestweighted"] = ax.QuantileExactWeightedAgg
    base["uniqtheta"] = sk.HLLUniqAgg
    base["first_value"] = AnyAgg
    base["last_value"] = AnyAgg      # insertion-order last ≈ any (no order)
    base["any_value"] = AnyAgg
    base["medianexact"] = MedianAgg
    base["mediantdigest"] = MedianAgg
    base["mediantiming"] = MedianAgg
    # further quantile spellings: all served exactly by the sort path
    base["quantileexacthigh"] = QuantileExactAgg
    base["quantileexactexclusive"] = QuantileExactAgg
    base["quantileexactinclusive"] = QuantileExactAgg
    base["quantilegk"] = QuantileExactAgg
    base["quantilesexactexclusive"] = QuantileExactAgg
    base["quantilesexactinclusive"] = QuantileExactAgg
    base["quantilesexactlow"] = QuantileExactAgg
    base["quantilesexacthigh"] = QuantileExactAgg
    base["quantilesbfloat16"] = QuantileExactAgg
    base["quantilesdeterministic"] = QuantileExactAgg
    base["quantilesinterpolated"] = QuantileExactAgg
    base["quantilesgk"] = QuantileExactAgg
    base["quantilestiming"] = QuantileExactAgg
    base["quantilestdigest"] = QuantileExactAgg
    base["medianexactlow"] = MedianAgg
    base["medianexacthigh"] = MedianAgg
    base["medianbfloat16"] = MedianAgg
    base["mediandeterministic"] = MedianAgg
    base["medianexactweighted"] = ax.QuantileExactWeightedAgg
    base["mediantimingweighted"] = ax.QuantileExactWeightedAgg
    base["mediantdigestweighted"] = ax.QuantileExactWeightedAgg
    base["medianinterpolatedweighted"] = ax.QuantileExactWeightedAgg
    # batch 4 (agg_ext4.py)
    from . import agg_ext4 as ax4
    for _cls in [ax4.TopKWeightedAgg, ax4.DeltaSumTimestampAgg,
                 ax4.KolmogorovSmirnovTestAgg, ax4.AnalysisOfVarianceAgg,
                 ax4.NothingAgg, ax4.AggThrowAgg]:
        base[_cls.name.lower()] = _cls
    base["anova"] = ax4.AnalysisOfVarianceAgg
    base["kolmogorovsmirnovtest"] = ax4.KolmogorovSmirnovTestAgg
    # exact/canonical substitutions for further reference spellings
    # (documented in APPROX_ALIASES + system.functions)
    base["stochasticlinearregression"] = base["simplelinearregression"]
    base["uniqthetasketch"] = base["uniqexact"]
    base["quantiledd"] = QuantileExactAgg
    base["quantilesdd"] = QuantileExactAgg
    base["mediandd"] = MedianAgg
    base["quantileinterpolated"] = QuantileExactAgg
    # *MappedArrays spellings = the map aggregates over (keys, values)
    # array pairs (ref: AggregateFunctionSumMap.cpp registration)
    base["summappedarrays"] = base["summap"]
    base["minmappedarrays"] = base["minmap"]
    base["maxmappedarrays"] = base["maxmap"]
    base["any_value"] = AnyAgg            # ANSI spelling
    base["corrstable"] = base["corr"]
    base["covarpopstable"] = base["covarpop"]
    base["covarsampstable"] = base["covarsamp"]
    base["quantiletdigestweighted"] = ax.QuantileExactWeightedAgg
    base["quantilebfloat16weighted"] = ax.QuantileExactWeightedAgg
    base["quantilesexactweighted"] = base.get("quantilesexact",
                                              QuantileExactAgg)
    # RESPECT NULLS spellings: NULL rows are selectable values (advisor r03
    # fix — these differ from any() whenever the selected row is NULL)
    base["any_respect_nulls"] = AnyRespectNullsAgg
    base["anylast_respect_nulls"] = AnyRespectNullsAgg
    base["first_value_respect_nulls"] = AnyRespectNullsAgg
    base["last_value_respect_nulls"] = AnyRespectNullsAgg
    # groupBitmap = cardinality of an integer set (bitmap structure is an
    # implementation detail; exact distinct count here)
    base["groupbitmap"] = UniqExactAgg
    return base


# Approximate reference algorithms this engine substitutes with EXACT
# computation (possible because grouping is a device sort, so per-group
# order statistics are cheap).  Documented here and surfaced through
# system.functions: cross-engine results may differ where the reference
# answers approximately.
APPROX_ALIASES = {
    "quantileTDigest": "exact quantile (sort-based)",
    "quantileTDigestWeighted": "exact weighted quantile",
    "quantileTiming": "exact quantile (sort-based)",
    "quantileTimingWeighted": "exact weighted quantile",
    "quantileBFloat16": "exact quantile (sort-based)",
    "quantileDeterministic": "exact quantile (sort-based)",
    "quantileInterpolatedWeighted": "exact weighted quantile",
    "uniqTheta": "HyperLogLog sketch",
    "uniqCombined": "HyperLogLog sketch",
    "uniqCombined64": "HyperLogLog sketch",
    "uniqHLL12": "HyperLogLog sketch",
    "anyHeavy": "any (first value)",
    "topK": "exact top-K by frequency (space-saving unnecessary)",
    "sumKahan": "pairwise-exact segmented f64 sum",
    "quantileGK": "exact quantile (GK sketch accuracy param ignored)",
    "quantilesGK": "exact quantiles (GK sketch accuracy param ignored)",
    "groupBitmap": "exact distinct count (no roaring bitmap state)",
    "groupArraySample": "deterministic position-hash sample (no RNG seed)",
    "mannWhitneyUTest": "normal approximation with tie correction",
    "stochasticLinearRegression": "exact OLS fit (no SGD)",
    "quantileDD": "exact quantile (DD sketch accuracy param ignored)",
    "quantilesDD": "exact quantiles (DD sketch accuracy param ignored)",
    "medianDD": "exact median",
    "uniqThetaSketch": "exact distinct count",
    "topKWeighted": "exact top-K by weight (space-saving unnecessary)",
    "kolmogorovSmirnovTest": "asymptotic Kolmogorov p-value",
    "groupBitmap": "exact distinct count (roaring container elided)",
}


_BASE: Dict[str, type] = _register_base()
_MULTI_Q = {"quantiles", "quantilesexact", "quantilesexactexclusive",
            "quantilesexactinclusive", "quantilesgk", "quantilestiming",
            "quantilestdigest", "quantilesexactlow", "quantilesexacthigh",
            "quantilesbfloat16", "quantilesdeterministic", "quantilesdd",
            "quantilesinterpolated"}
_SIZED = {"grouparray", "groupuniqarray", "grouparraydistinct", "topk",
          "topkweighted",
          "grouparraysorted", "grouparraylast", "grouparraysample"}

AGGREGATES = _BASE


def is_aggregate_name(name: str) -> bool:
    base = name.lower()
    if base in _BASE:
        return True
    changed = True
    while changed and base not in _BASE:
        changed = False
        for suf in ("if", "state", "merge", "array", "foreach", "distinct",
                    "ornull", "ordefault"):
            if base.endswith(suf) and len(base) > len(suf) \
                    and (suf in ("if", "state", "merge")
                         or base[:-len(suf)] in _BASE):
                base = base[:-len(suf)]
                changed = True
                break
    return base in _BASE


# -- -State / -Merge combinators ---------------------------------------------
# The reference stores partial aggregation states as first-class column
# values (src/Columns/ColumnAggregateFunction.h, -State/-Merge in
# AggregateFunctionCombinatorFactory).  Here a state is the function's
# mergeable state columns packed byte-wise into a fixed-width (rows, B)
# uint8 matrix — ordinary block data, so states flow through joins, storage,
# the Native format, and the distributed exchange unchanged.

_STATE_SPEC_CACHE: Dict[tuple, list] = {}


def state_spec(inst: AggregateFunction) -> list:
    """[(np.dtype, width)] layout of the state columns, via shape-only
    tracing of update() (jax.eval_shape — no device compute)."""
    extra = tuple(sorted(
        (k, tuple(v) if isinstance(v, list) else v)
        for k, v in inst.__dict__.items()
        if k != "arg_types" and isinstance(v, (int, float, str, bool,
                                               tuple, list, type(None)))))
    key = (type(inst).__name__, tuple(str(t) for t in inst.arg_types), extra)
    hit = _STATE_SPEC_CACHE.get(key)
    if hit is not None:
        return hit
    from ..core.settings import Settings

    def probe():
        cap = 8
        rv = jnp.ones((cap,), jnp.bool_)
        g = agg_ops.group_by_sort([jnp.zeros((cap,), jnp.int32)], rv, cap)
        ctx = GroupContext([jnp.zeros((cap,), jnp.int32)], rv, g, cap,
                           checks=[], settings=Settings())
        args = [ColVal(t, jnp.zeros((cap,),
                                    dt.remove_nullable(t).jnp_dtype),
                       None, None) for t in inst.arg_types]
        return tuple(inst.update(ctx, args, None))

    shapes = jax.eval_shape(probe)
    spec = []
    for s in shapes:
        d = np.dtype(s.dtype) if s.dtype != jnp.bool_ else np.dtype("uint8")
        spec.append((d, 1 if len(s.shape) == 1 else int(s.shape[1])))
    _STATE_SPEC_CACHE[key] = spec
    return spec


def state_width_bytes(spec) -> int:
    return sum(d.itemsize * w for d, w in spec)


def pack_state_columns(states: Sequence[jax.Array]) -> jax.Array:
    """State columns -> (rows, B) uint8 byte matrix (little-endian limbs)."""
    cap = states[0].shape[0]
    parts = []
    for s in states:
        if s.dtype == jnp.bool_:
            s = s.astype(jnp.uint8)
        s2 = s[:, None] if s.ndim == 1 else s
        if s2.dtype == jnp.uint8:
            parts.append(s2)
        else:
            parts.append(jax.lax.bitcast_convert_type(s2, jnp.uint8)
                         .reshape(cap, -1))
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1)


def unpack_state_columns(packed: jax.Array, spec) -> List[jax.Array]:
    cap = packed.shape[0]
    out, off = [], 0
    for d, w in spec:
        nb = d.itemsize * w
        chunk = packed[:, off:off + nb]
        off += nb
        if d.itemsize == 1:
            arr = chunk if w > 1 else chunk[:, 0].astype(jnp.dtype(d))
        else:
            arr = jax.lax.bitcast_convert_type(
                chunk.reshape(cap, w, d.itemsize), jnp.dtype(d))
            if w == 1:
                arr = arr[:, 0]
        out.append(arr)
    return out


class StateAgg(AggregateFunction):
    """-State: aggregate normally but emit the packed state, not the value."""

    def __init__(self, inner: AggregateFunction, params=()):
        super().__init__(list(inner.arg_types))
        inner.pin_state_layout()
        self.inner = inner
        self.name = inner.name + "State"
        self.holistic = inner.holistic
        self._params = tuple(params or ())

    @property
    def sum_only(self):
        return False          # dense (matmul) stage cannot pack states

    def result_type(self):
        return dt.AggregateState(self.inner.name, self.inner.arg_types,
                                 self._params)

    def state_ops(self):
        return self.inner.state_ops()

    def update(self, ctx, args, cond):
        return self.inner.update(ctx, args, cond)

    def merge(self, states, grouping, mask_raw):
        return self.inner.merge(states, grouping, mask_raw)

    def finalize(self, states):
        return pack_state_columns(states), None


class MergeAgg(AggregateFunction):
    """-Merge: rows carry packed states of the inner function; update()
    unpacks and merges them by group."""

    def __init__(self, inner: AggregateFunction, spec,
                 arg_types: List[dt.DType]):
        super().__init__(arg_types)
        inner.pin_state_layout()
        self.inner = inner
        self.spec = spec
        self.name = inner.name + "Merge"
        self.holistic = inner.holistic

    def result_type(self):
        return self.inner.result_type()

    def state_ops(self):
        return self.inner.state_ops()

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        packed = args[0].broadcast(ctx.row_valid.shape[0]).data
        states = unpack_state_columns(packed, self.spec)
        return self.inner.merge(states, ctx.grouping, mask)

    def merge(self, states, grouping, mask_raw):
        return self.inner.merge(states, grouping, mask_raw)

    def finalize(self, states):
        return self.inner.finalize(states)


def make_merge_for_dtype(state_dtype: dt.DType) -> "MergeAgg":
    """Instantiate the -Merge aggregate for an AggregateFunction(...) column
    dtype (used by AggregatingMergeTree FINAL folds and finalizeAggregation)."""
    st = dt.remove_nullable(state_dtype)
    fn_name, arg_names, sparams = st.agg_state
    inner_args = [dt.parse_type_name(a) for a in arg_names]
    inner, _ = get_aggregate(fn_name, inner_args,
                             list(sparams) if sparams else None)
    inner.pin_state_layout()
    return MergeAgg(inner, state_spec(inner), [state_dtype])


def get_aggregate(name: str, arg_types: List[dt.DType],
                  params: Optional[list] = None
                  ) -> Tuple[AggregateFunction, bool]:
    """-> (instance, has_if_combinator).  Raises UnknownFunction.

    Combinator suffixes peel right-to-left: -If, -State, -Merge
    (AggregateFunctionCombinatorFactory analog)."""
    lname = name.lower()
    has_if = False
    mode = None
    comb = None                     # array | foreach | distinct
    while lname not in _BASE:
        if lname.endswith("if") and len(lname) > 2:
            has_if = True
            lname = lname[:-2]
        elif lname.endswith("state") and mode is None and len(lname) > 5:
            mode = "state"
            lname = lname[:-5]
        elif lname.endswith("merge") and mode is None and len(lname) > 5:
            mode = "merge"
            lname = lname[:-5]
        elif lname.endswith("array") and comb is None \
                and lname[:-5] in _BASE:
            comb = "array"
            lname = lname[:-5]
        elif lname.endswith("foreach") and comb is None \
                and lname[:-7] in _BASE:
            comb = "foreach"
            lname = lname[:-7]
        elif lname.endswith("distinct") and comb is None \
                and lname[:-8] in _BASE:
            comb = "distinct"
            lname = lname[:-8]
        elif lname.endswith("ornull") and lname[:-6] in _BASE:
            comb = (comb, "ornull")
            lname = lname[:-6]
        elif lname.endswith("ordefault") and lname[:-9] in _BASE:
            comb = (comb, "ordefault")
            lname = lname[:-9]
        else:
            break
    if has_if:
        arg_types = arg_types[:-1]  # last arg is the condition
    if lname not in _BASE:
        raise UnknownFunction(f"Unknown aggregate function '{name}'")
    if comb is not None and mode is None:
        from . import agg_ext as ax
        orfill = None
        if isinstance(comb, tuple):
            comb, orfill = comb[0], comb[1]
        if comb is None:
            inst, _ = get_aggregate(lname, arg_types, params)
            return ax.OrNullAgg(inst, orfill == "ornull"), has_if
        if comb == "array":
            inst = ax.make_array_combinator(lname, _BASE[lname], arg_types)
        elif comb == "foreach":
            inst = ax.make_foreach_combinator(lname, arg_types)
        else:
            base_inst, _ = get_aggregate(lname, arg_types, params)
            inst = ax.DistinctAgg(base_inst)
        if inst is None:
            raise NotImplementedError_(
                f"Combinator '-{comb.capitalize()}' does not apply to "
                f"'{lname}' with these argument types")
        if orfill is not None:
            inst = ax.OrNullAgg(inst, orfill == "ornull")
        return inst, has_if
    if mode == "merge":
        st = dt.remove_nullable(arg_types[0]) if arg_types else None
        if st is None or not dt.is_agg_state(st):
            raise TypeError_(
                f"{name} requires an AggregateFunction(...) argument, got "
                f"{arg_types[0] if arg_types else 'none'}")
        fn_name, arg_names, sparams = st.agg_state
        if fn_name.lower() != lname:
            raise TypeError_(
                f"{name} cannot merge a state of '{fn_name}'")
        inner_args = [dt.parse_type_name(a) for a in arg_names]
        inner, _ = get_aggregate(fn_name, inner_args,
                                 list(sparams) if sparams else None)
        inner.state_ops()      # raises TypeError_ for non-mergeable states
        inner.pin_state_layout()
        return MergeAgg(inner, state_spec(inner), list(arg_types)), has_if
    cls = _BASE[lname]
    from . import agg_ext as _ax
    if lname in ("quantilegk", "quantilesgk") and params:
        params = params[1:]        # leading param is the GK sketch accuracy
    if lname in _MULTI_Q:
        qs = [float(p) for p in params] if params else [0.5]
        inst = QuantileExactAgg(arg_types, qs=qs)
    elif cls is QuantileExactAgg:
        q = float(params[0]) if params else 0.5
        inst = QuantileExactAgg(arg_types, q)
    elif cls is _ax.QuantileExactWeightedAgg:
        q = float(params[0]) if params else 0.5
        inst = _ax.QuantileExactWeightedAgg(arg_types, q)
    elif cls is _ax.UniqUpToAgg:
        inst = _ax.UniqUpToAgg(arg_types, int(params[0]) if params else 5)
    elif lname in _SIZED:
        size = int(params[0]) if params else None
        if lname in ("topk", "topkweighted"):
            inst = cls(arg_types, size or 10)
        else:
            inst = cls(arg_types, size)
    elif getattr(cls, "param_ctor", False):
        inst = cls(arg_types, params)
    else:
        inst = cls(arg_types)
    if mode == "state":
        inst.state_ops()       # raises TypeError_ for non-mergeable states
        for t in arg_types:
            if dt.remove_nullable(t).is_dictionary:
                raise NotImplementedError_(
                    f"{name}: -State over String/dictionary arguments is "
                    "not supported yet")
        inst = StateAgg(inst, params)
    return inst, has_if

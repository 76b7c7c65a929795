"""Plan executor: lowers the logical plan onto device kernels.

The role of QueryPlan::buildQueryPipeline + PipelineExecutor
(src/Processors/QueryPlan/QueryPlan.cpp:166, Executors/PipelineExecutor.cpp:125)
— with the fundamental inversion (SURVEY.md §7): instead of a
dynamic processor graph driven by a thread scheduler, the whole plan is a
single functional JAX computation over padded device arrays.  XLA is the
scheduler; operators exchange *masked blocks* (validity masks instead of
compaction), so Filter is an AND, and row movement happens only inside
sort/join/aggregate kernels that need it.

The executor is trace-compatible: running it under jax.jit compiles the whole
query into one fused XLA program (the Session decides when to jit).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import Column, Dictionary, pad_to
from ..core.errors import (CapacityError, ExecutionError, NotImplementedError_)
from ..core.settings import Settings
from ..exprs import aggregates as agg_reg
from ..exprs.expr import (BoundColumn, ColVal, colval_from_column, evaluate)
from ..exprs.functions import _string_codes_common
from ..ops import agg_ops, filter_ops, join_ops, sort_ops
from ..ops import search as search_ops
from ..plan import logical as L

__all__ = ["ExecBlock", "ExecContext", "execute_plan", "materialize"]


@dataclasses.dataclass
class ExecBlock:
    """A masked block: full-capacity columns + row validity mask.

    sharded=True means the block's rows are partitioned across the mesh axis
    (each shard holds a disjoint subset) — the executor's operators insert
    collectives where global semantics require them (SURVEY.md §2.6).
    """
    cols: Dict[str, ColVal]        # field id -> ColVal
    valid: jax.Array               # bool (capacity,)
    capacity: int
    sharded: bool = False

    def env(self) -> Dict[str, ColVal]:
        env = dict(self.cols)
        # reserved key: the block row mask, for mask-aware functions
        # (throwIf must ignore padding rows)
        env["__row_valid__"] = ColVal(dt.UInt8,
                                      self.valid.astype(jnp.uint8), None)
        return env

    def colval(self, field: L.Field) -> ColVal:
        return self.cols[field.id]


@dataclasses.dataclass
class Check:
    value: Any                     # device scalar
    limit: int
    message: str
    # setting that bounds this capacity: the session's autotuner re-plans
    # with it raised when the check trips (None = not tunable)
    setting: Optional[str] = None


class ExecContext:
    def __init__(self, table_blocks: Dict[Tuple[str, str], Block],
                 settings: Settings,
                 axis_name: Optional[str] = None, n_shards: int = 1,
                 sharded_tables: Optional[set] = None):
        self.table_blocks = table_blocks
        self.settings = settings
        self.checks: List[Check] = []
        self.profile: Dict[str, int] = {}
        # WITH TOTALS: a single-row block flowing beside the main pipeline
        # (the reference's totals port, IProcessor totals stream)
        self.totals_block: Optional["ExecBlock"] = None
        # distributed execution (inside shard_map over `axis_name`)
        self.axis_name = axis_name
        self.n_shards = n_shards
        self.sharded_tables = sharded_tables or set()
        # interval-analysis facts: field id -> (lo, hi), filled at scans from
        # part minmax stats and propagated through projections
        self.field_bounds: Dict[str, Tuple[int, int]] = {}
        # blocks injected by the streaming driver (BlockSourceNode)
        self.injected: Dict[str, "ExecBlock"] = {}

    @property
    def distributed(self) -> bool:
        return self.axis_name is not None and self.n_shards > 1

    def count(self, name: str, value: int = 1):
        self.profile[name] = self.profile.get(name, 0) + value


# -- helpers -----------------------------------------------------------------

def _bool_mask(cv: ColVal, capacity: int) -> jax.Array:
    """Predicate ColVal -> bool mask (NULL -> False)."""
    cv = cv.broadcast(capacity)
    m = cv.data != jnp.zeros((), cv.data.dtype)
    if cv.validity is not None:
        m = m & cv.validity.astype(jnp.bool_)
    return m


def _key_arrays(cvs: Sequence[ColVal], capacity: int
                ) -> Tuple[List[jax.Array], List[Optional[ColVal]]]:
    """GROUP BY / join key storage arrays.  Nullable keys contribute their
    validity as an extra key column (NULLs form their own group, matching the
    reference's nullable key handling) with data normalized to 0."""
    arrays: List[jax.Array] = []
    metas: List[Optional[ColVal]] = []
    for cv in cvs:
        cv = cv.broadcast(capacity)
        data = cv.data
        if cv.validity is not None:
            v = cv.validity.astype(jnp.bool_)
            data = jnp.where(v, data, jnp.zeros((), data.dtype))
            arrays.append(v)
            metas.append(None)
        arrays.append(data)
        metas.append(cv)
    return arrays, metas


def _gather_colval(cv: ColVal, idx: jax.Array, capacity: int) -> ColVal:
    cv = cv.broadcast(capacity)
    data = cv.data[idx]
    validity = cv.validity[idx] if cv.validity is not None else None
    lengths = cv.lengths[idx] if cv.lengths is not None else None
    out = ColVal(cv.dtype, data, validity, cv.dictionary, lengths=lengths)
    if cv.sub is not None:          # composite: gather sub-columns along
        out.sub = [_gather_colval(s, idx, capacity) for s in cv.sub]
    return out


# -- node execution ----------------------------------------------------------

def execute_plan(node: L.PlanNode, ctx: ExecContext) -> ExecBlock:
    fn = _DISPATCH.get(type(node))
    if fn is None:
        raise NotImplementedError_(f"No executor for {type(node).__name__}")
    return fn(node, ctx)


def _exec_scan(node: L.ScanNode, ctx: ExecContext) -> ExecBlock:
    blk = ctx.table_blocks[(node.database, node.table)]
    cols = {}
    for f, storage_name in zip(node.schema, node.column_names):
        cols[f.id] = colval_from_column(blk[storage_name])
    cap = blk.capacity
    if node.column_stats:
        ctx.field_bounds.update(node.column_stats)
    sharded = (node.database, node.table) in ctx.sharded_tables
    if "__row_valid" in blk.columns:
        # distributed tables carry an explicit per-row validity column
        # (per-shard row counts differ; a single scalar cannot express them)
        valid = blk["__row_valid"].data.astype(jnp.bool_)
    else:
        n = blk.num_rows
        valid = jnp.arange(cap) < jnp.asarray(n)
        ctx.count("rows_scanned",
                  int(n) if isinstance(n, (int, np.integer)) else 0)
    eb = ExecBlock(cols, valid, cap, sharded=sharded)
    if node.final:
        eb = _apply_final(node, eb, ctx)
    return eb


def _apply_final(node: L.ScanNode, eb: ExecBlock, ctx: ExecContext
                 ) -> ExecBlock:
    """FINAL read: fold rows with equal sort key at read time — the
    reference's merge-algorithm family applied on SELECT
    (Replacing/Summing *SortedAlgorithm.cpp; SURVEY.md §2.5)."""
    from ..storage.table import base_engine
    engine = base_engine(node.engine).lower()
    if engine not in ("replacingmergetree", "summingmergetree",
                      "aggregatingmergetree", "collapsingmergetree",
                      "versionedcollapsingmergetree") \
            or not node.order_by_cols:
        return eb
    cap = eb.capacity
    key_ids = [f.id for f, n in zip(node.schema, node.column_names)
               if n in node.order_by_cols]
    if not key_ids:
        return eb            # sort key columns were pruned away entirely
    if engine in ("collapsingmergetree", "versionedcollapsingmergetree"):
        return _apply_final_collapsing(node, eb, ctx, engine, key_ids)
    key_cvs = [eb.cols[i] for i in key_ids]
    key_arrays, _ = _key_arrays(key_cvs, cap)
    cap_g = pad_to(min(cap, ctx.settings.max_groups))
    # secondary: newest insertion first within each key group
    anti_rowid = -jnp.arange(cap, dtype=jnp.int64)
    g = agg_ops.group_by_sort(key_arrays, eb.valid, cap_g,
                              secondary=[anti_rowid])
    keep_sorted = g.boundary & (g.group_ids < cap_g)
    inv = jnp.argsort(g.perm)
    keep = keep_sorted[inv]
    cols = eb.cols
    if engine == "summingmergetree":
        gid_raw = g.group_ids[inv]
        gid_c = jnp.minimum(gid_raw, cap_g - 1)
        cols = dict(eb.cols)
        for f in node.schema:
            if f.id in key_ids:
                continue
            cv = cols[f.id].broadcast(cap)
            if cv.dtype.is_dictionary \
                    or cv.dtype.np_dtype.kind not in ("i", "u", "f"):
                continue
            sums = g.reduce("sum", cv.data, eb.valid)
            data = sums[gid_c].astype(cv.data.dtype)
            cols[f.id] = ColVal(cv.dtype, data, cv.validity, cv.dictionary)
    elif engine == "aggregatingmergetree":
        # fold AggregateFunction columns by merging their states per sort
        # key (reference: AggregatingSortedAlgorithm.cpp)
        gid_raw = g.group_ids[inv]
        gid_c = jnp.minimum(gid_raw, cap_g - 1)
        cols = dict(eb.cols)
        for f in node.schema:
            if f.id in key_ids or f.dtype.agg_state is None:
                continue
            m = agg_reg.make_merge_for_dtype(f.dtype)
            cv = cols[f.id].broadcast(cap)
            states = agg_reg.unpack_state_columns(cv.data, m.spec)
            merged = m.inner.merge(states, g, eb.valid)
            packed_g = agg_reg.pack_state_columns(merged)   # (cap_g, B)
            cols[f.id] = ColVal(cv.dtype, packed_g[gid_c], None)
    return ExecBlock(cols, eb.valid & keep, cap, sharded=eb.sharded)


def _apply_final_collapsing(node: L.ScanNode, eb: ExecBlock,
                            ctx: ExecContext, engine: str,
                            key_ids) -> ExecBlock:
    """FINAL fold for the Collapsing family, on device (reference:
    CollapsingSortedAlgorithm.cpp:88-114 — p>n keeps the last positive,
    p<n the first negative, p==n with a trailing positive keeps both;
    VersionedCollapsingAlgorithm.cpp — ±1 annihilation per (key, version),
    the |p-n| surplus rows of the majority sign survive)."""
    cap = eb.capacity
    args = list(node.engine_args)
    name_to_fid = {n: f.id for f, n in zip(node.schema, node.column_names)}
    sign_fid = name_to_fid.get(args[0] if args else "sign")
    if sign_fid is None:
        return eb
    key_cvs = [eb.cols[i] for i in key_ids]
    if engine == "versionedcollapsingmergetree":
        ver_fid = name_to_fid.get(args[1]) if len(args) > 1 else None
        if ver_fid is None:
            return eb
        key_cvs = key_cvs + [eb.cols[ver_fid]]
    key_arrays, _ = _key_arrays(key_cvs, cap)
    cap_g = pad_to(min(cap, ctx.settings.max_groups))
    g = agg_ops.group_by_sort(key_arrays, eb.valid, cap_g)
    inv = jnp.argsort(g.perm)
    gid = jnp.minimum(g.group_ids[inv], cap_g - 1)       # per original row
    rowid = jnp.arange(cap, dtype=jnp.int64)
    sign = eb.cols[sign_fid].broadcast(cap).data.astype(jnp.int64)
    isp = eb.valid & (sign > 0)
    isn = eb.valid & (sign < 0)
    p = g.reduce("sum", isp.astype(jnp.int64), eb.valid)
    n_ = g.reduce("sum", isn.astype(jnp.int64), eb.valid)
    if engine == "collapsingmergetree":
        last_pos = g.reduce("max", rowid, isp)
        first_neg = g.reduce("min", rowid, isn)
        last_row = g.reduce("max", rowid, eb.valid)
        pr, nr = p[gid], n_[gid]
        last_is_positive = (last_pos == last_row)[gid] & (pr > 0)
        keepable = (last_is_positive | (pr != nr)) & ((pr > 0) | (nr > 0))
        keep = keepable & (
            ((pr <= nr) & (rowid == first_neg[gid]) & isn)
            | ((pr >= nr) & (rowid == last_pos[gid]) & isp))
        return ExecBlock(eb.cols, eb.valid & keep, cap, sharded=eb.sharded)
    # versioned: the last |p-n| rows of the majority sign survive
    surplus = p - n_
    gid_s = jnp.minimum(g.group_ids, cap_g - 1)          # sorted order
    keep_sorted = jnp.zeros((cap,), jnp.bool_)
    for s_mask, cnt in ((isp, surplus), (isn, -surplus)):
        ms = g.take(s_mask)
        c = jnp.cumsum(ms.astype(jnp.int64))
        before = jnp.where(g.starts > 0, c[jnp.maximum(g.starts - 1, 0)], 0)
        pos_in = c - 1 - before[gid_s]
        total = g.reduce("sum", s_mask.astype(jnp.int64), eb.valid)
        from_end = total[gid_s] - 1 - pos_in
        keep_sorted = keep_sorted | (
            ms & (from_end < jnp.maximum(cnt, 0)[gid_s]))
    keep = keep_sorted[inv]
    return ExecBlock(eb.cols, eb.valid & keep, cap, sharded=eb.sharded)


def _exec_blocksource(node: L.BlockSourceNode, ctx: ExecContext) -> ExecBlock:
    return ctx.injected[node.key]


def _exec_onerow(node: L.OneRowNode, ctx: ExecContext) -> ExecBlock:
    cap = 1024
    f = node.schema[0]
    cols = {f.id: ColVal(f.dtype, jnp.zeros((cap,), f.dtype.jnp_dtype))}
    valid = jnp.arange(cap) < 1
    return ExecBlock(cols, valid, cap)


def _exec_numbers(node: L.NumbersNode, ctx: ExecContext) -> ExecBlock:
    cap = pad_to(node.count)
    f = node.schema[0]
    data = (jnp.arange(cap, dtype=jnp.uint64) + jnp.uint64(node.start))
    valid = jnp.arange(cap) < node.count
    b = (node.start, node.start + max(node.count - 1, 0))
    ctx.field_bounds[f.id] = b
    return ExecBlock({f.id: ColVal(f.dtype, data, bounds=b)}, valid, cap)


def _exec_filter(node: L.FilterNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    pred = evaluate(node.predicate, child.env())
    mask = _bool_mask(pred, child.capacity)
    return ExecBlock(child.cols, child.valid & mask, child.capacity,
                     sharded=child.sharded)


def _exec_project(node: L.ProjectNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    from ..plan import ranges
    env = child.env()
    for name, cv0 in env.items():   # expose interval analysis to functions
        if cv0.bounds is None and name in ctx.field_bounds:
            cv0.bounds = ctx.field_bounds[name]
    cols = {}
    for f, e in zip(node.schema, node.exprs):
        cv = evaluate(e, env)
        cols[f.id] = cv.broadcast(child.capacity)
        b = ranges.infer_bounds(e, ctx.field_bounds)
        if b is not None:
            ctx.field_bounds[f.id] = b
    if ctx.totals_block is not None:
        t = ctx.totals_block
        tcols = {}
        for f, e in zip(node.schema, node.exprs):
            try:
                tcols[f.id] = evaluate(e, t.env()).broadcast(t.capacity)
            except Exception:
                tcols[f.id] = ColVal(f.dtype,
                                     jnp.zeros((t.capacity,),
                                               f.dtype.jnp_dtype))
        ctx.totals_block = ExecBlock(tcols, t.valid, t.capacity)
    return ExecBlock(cols, child.valid, child.capacity,
                     sharded=child.sharded)


def _gather_block(eb: ExecBlock, ctx: ExecContext) -> ExecBlock:
    """Replicate a sharded block on every shard (all_gather over the mesh)."""
    if not eb.sharded or not ctx.distributed:
        return eb
    ax = ctx.axis_name
    cols = {}
    for fid, cv in eb.cols.items():
        cv = cv.broadcast(eb.capacity)
        data = jax.lax.all_gather(cv.data, ax, axis=0, tiled=True)
        validity = (jax.lax.all_gather(cv.validity, ax, axis=0, tiled=True)
                    if cv.validity is not None else None)
        cols[fid] = ColVal(cv.dtype, data, validity, cv.dictionary)
    valid = jax.lax.all_gather(eb.valid, ax, axis=0, tiled=True)
    return ExecBlock(cols, valid, eb.capacity * ctx.n_shards, sharded=False)


def _repartition_block(eb: ExecBlock, key_arrays: List[jax.Array],
                       ctx: ExecContext, salt: Optional[jax.Array] = None,
                       salt_mod: int = 1) -> ExecBlock:
    """Exchange raw rows across shards by key hash (each key ends up wholly
    on one shard — the reference's partition-parallel aggregation route,
    useDataParallelAggregation.cpp, used for holistic aggregates).

    With salt/salt_mod, a key's rows spread over salt_mod shards of its hash
    group (heavy-hitter splitting; see exchange_by_key)."""
    from ..parallel import exchange as ex
    cap = eb.capacity
    fids = list(eb.cols.keys())
    payloads = []
    layout = []            # (fid, has_validity)
    for fid in fids:
        cv = eb.cols[fid].broadcast(cap)
        payloads.append(cv.data)
        if cv.validity is not None:
            payloads.append(cv.validity)
            layout.append((fid, True))
        else:
            layout.append((fid, False))
    keys_rx, payloads_rx, valid_rx, overflow = ex.exchange_by_key(
        key_arrays, payloads, eb.valid, ctx.axis_name, ctx.n_shards, cap,
        salt=salt, salt_mod=salt_mod)
    ctx.checks.append(Check(overflow, cap,
                            "repartition shuffle overflowed per-shard "
                            "capacity (skewed keys); raise capacity"))
    cols = {}
    i = 0
    for fid, has_v in layout:
        cv = eb.cols[fid]
        data = payloads_rx[i]
        i += 1
        validity = None
        if has_v:
            validity = payloads_rx[i]
            i += 1
        cols[fid] = ColVal(cv.dtype, data, validity, cv.dictionary)
    return ExecBlock(cols, valid_rx, valid_rx.shape[0], sharded=True)


def _tile_block(eb: ExecBlock, key_arrays: List[jax.Array], times: int
                ) -> Tuple[ExecBlock, List[jax.Array]]:
    """Replicate every row `times` times (row i of replica r at r*cap + i).
    Used to fan a join build side out to all salts of its shard group."""
    def t(a):
        reps = (times,) + (1,) * (a.ndim - 1)
        return jnp.tile(a, reps)
    cap = eb.capacity
    cols = {}
    for fid, cv in eb.cols.items():
        cv = cv.broadcast(cap)
        validity = t(cv.validity) if cv.validity is not None else None
        cols[fid] = ColVal(cv.dtype, t(cv.data), validity, cv.dictionary)
    return (ExecBlock(cols, t(eb.valid), cap * times, sharded=eb.sharded),
            [t(k) for k in key_arrays])


def _agg_key_arrays(node: L.AggregateNode, child: ExecBlock,
                    ctx: ExecContext):
    """-> (key_cvs, key_arrays, dense_dims or None, global_agg)."""
    from ..plan import ranges
    settings = ctx.settings
    cap = child.capacity
    key_cvs = [evaluate(e, child.env()) for _, e in node.keys]
    if not key_cvs:
        return key_cvs, [jnp.zeros((cap,), jnp.int32)], None, True
    arrays: List[jax.Array] = []
    dims: List = []
    dense_ok = True
    total = 1
    for (f, e), cv in zip(node.keys, key_cvs):
        cv = cv.broadcast(cap)
        data = cv.data
        if cv.validity is not None:
            v = cv.validity.astype(jnp.bool_)
            data = jnp.where(v, data, jnp.zeros((), data.dtype))
            arrays.append(v)
            dims.append((0, 2))
            total *= 2
        b = None
        if cv.dtype.is_dictionary:
            d = cv.dictionary
            b = (0, max(len(d) - 1, 0)) if d is not None else None
        elif cv.dtype.np_dtype.kind in ("i", "u", "b"):
            b = ranges.infer_bounds(e, ctx.field_bounds)
        # narrow 64-bit keys to i32 when bounds prove they fit: the grouping
        # sort then moves half the bytes per operand
        if b is not None and np.dtype(data.dtype).kind in ("i", "u") \
                and np.dtype(data.dtype).itemsize == 8 \
                and -2**31 <= b[0] and b[1] < 2**31:
            data = data.astype(jnp.int32)
        arrays.append(data)
        if b is None:
            dense_ok = False
            dims.append(None)
        else:
            size = b[1] - b[0] + 1
            dims.append((b[0], size))
            total *= size
    from ..ops.mxu_segsum import MAX_DENSE_GROUPS
    if not dense_ok or total <= 0 \
            or total > min(settings.max_groups, MAX_DENSE_GROUPS) \
            or settings.group_by_algorithm == "sort":
        dims = None
    return key_cvs, arrays, dims, False


def _exec_aggregate(node: L.AggregateNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    key_cvs, key_arrays, dims, global_agg = _agg_key_arrays(
        node, child, ctx)
    holistic = any(a.fn.holistic for a in node.aggregates)
    if holistic or not all(a.fn.sum_only for a in node.aggregates):
        # dense (matmul) grouping serves sum-family aggregates only; holistic
        # aggregates additionally need sort-rank group ids
        dims = None

    if child.sharded and ctx.distributed:
        # partition-parallel aggregation: when a GROUP BY key IS the
        # sharding key, every group is fully local to one shard — skip the
        # exchange/merge entirely (reference: useDataParallelAggregation.cpp,
        # optimize_distributed_group_by_sharding_key)
        colocated = (
            bool(node.keys) and not global_agg
            and ctx.settings.optimize_distributed_group_by_sharding_key
            and any(isinstance(e, BoundColumn)
                    and e.name in getattr(ctx, "colocated_agg", {})
                    .get(id(node), ())
                    for _, e in node.keys))
        if holistic:
            if colocated:
                pass                         # rows already partitioned by key
            elif node.keys:
                child = _repartition_block(child, _rekey(node, child), ctx)
            else:
                child = _gather_block(child, ctx)
            key_cvs, key_arrays, dims, global_agg = _agg_key_arrays(
                node, child, ctx)
            return _aggregate_local(node, child, key_cvs, key_arrays, None,
                                    global_agg, ctx,
                                    sharded_out=bool(node.keys))
        if node.with_totals:
            ctx.totals_block = _aggregate_totals(node, child, ctx)
        if colocated:
            ctx.profile["ColocatedAggregations"] = \
                ctx.profile.get("ColocatedAggregations", 0) + 1
            return _aggregate_local(node, child, key_cvs, key_arrays, dims,
                                    global_agg, ctx, sharded_out=True)
        return _aggregate_two_stage(node, child, key_cvs, key_arrays, dims,
                                    global_agg, ctx)
    if node.with_totals and not global_agg:
        ctx.totals_block = _aggregate_totals(node, child, ctx)
    return _aggregate_local(node, child, key_cvs, key_arrays, dims,
                            global_agg, ctx, sharded_out=child.sharded)


def _aggregate_totals(node: L.AggregateNode, child: ExecBlock,
                      ctx: ExecContext) -> ExecBlock:
    """WITH TOTALS: the same aggregates over all rows as one global group;
    key columns carry their defaults (reference: TotalsHavingTransform)."""
    cap = child.capacity
    key_cvs = [evaluate(e, child.env()) for _, e in node.keys]
    tnode = dataclasses.replace(node, keys=[], with_totals=False,
                                schema=[a.field for a in node.aggregates])
    zeros = [jnp.zeros((cap,), jnp.int32)]
    if child.sharded and ctx.distributed:
        tot = _aggregate_two_stage(tnode, child, [], zeros, None, True, ctx)
    else:
        tot = _aggregate_local(tnode, child, [], zeros, None, True,
                               ctx, sharded_out=False)
    # replace the (meaningless) key outputs with default values
    for (f, _), cv in zip(node.keys, key_cvs):
        cv_b = cv.broadcast(cap)
        data = jnp.zeros((tot.capacity,), cv_b.data.dtype)
        tot.cols[f.id] = ColVal(f.dtype, data, None, cv_b.dictionary)
    return tot


def _rekey(node: L.AggregateNode, child: ExecBlock) -> List[jax.Array]:
    key_cvs = [evaluate(e, child.env()) for _, e in node.keys]
    arrays, _ = _key_arrays(key_cvs, child.capacity)
    return arrays


def _stage1(node: L.AggregateNode, child: ExecBlock,
            key_arrays: List[jax.Array], dims, cap_g: int, ctx: ExecContext,
            global_agg: bool = False):
    """Local grouping + per-aggregate partial states (WithMergeableState)."""
    cap = child.capacity
    from ..plan import ranges
    per_agg_inputs = []
    for item in node.aggregates:
        arg_cvs = []
        for a in item.args:
            cv = evaluate(a, child.env()).broadcast(cap)
            if cv.bounds is None:
                cv.bounds = ranges.infer_bounds(a, ctx.field_bounds)
            arg_cvs.append(cv)
        cond = None
        if item.cond is not None:
            cond = _bool_mask(evaluate(item.cond, child.env()), cap)
        # RESPECT NULLS selectors consume NULL rows as first-class values:
        # their row mask must not AND in the argument validities
        mask_args = [] if getattr(item.fn, "respect_nulls", False) else arg_cvs
        premask = agg_reg.compose_row_mask(child.valid, mask_args, cond)
        per_agg_inputs.append((item, arg_cvs, cond, premask))

    if global_agg:
        # GROUP BY (): one masked reduction, never a sort
        # (Aggregator::executeWithoutKey analog)
        grouping = agg_ops.group_trivial(child.valid, cap_g)
    elif dims is not None:
        # provably-small key space: direct-array grouping, no sort
        grouping = agg_ops.group_by_dense(key_arrays, dims, child.valid,
                                          cap_g)
    else:
        # aggregate operands and masks ride the grouping sort as payloads —
        # one extra sort operand each instead of a per-array random gather
        payloads, seen = [], {id(child.valid)}
        for _, arg_cvs, cond, premask in per_agg_inputs:
            for arr in ([premask] + [cv.data for cv in arg_cvs
                                     if cv.data.ndim == 1
                                     and cv.data.shape[0] == cap]):
                if id(arr) not in seen:
                    seen.add(id(arr))
                    payloads.append(arr)
        grouping = agg_ops.group_by_sort(key_arrays, child.valid, cap_g,
                                         payloads=payloads)
    gctx = agg_reg.GroupContext(keys=key_arrays, row_valid=child.valid,
                                grouping=grouping, num_groups_cap=cap_g,
                                checks=ctx.checks, settings=ctx.settings)

    if grouping.kind == "dense":
        group_counts, states_per_agg = _dense_stage1(
            grouping, child, gctx,
            [(item, arg_cvs, cond)
             for item, arg_cvs, cond, _ in per_agg_inputs])
        grouping.present = group_counts > 0
        grouping.num_groups = jnp.sum(grouping.present.astype(jnp.int64))
        return grouping, group_counts, states_per_agg

    group_counts = grouping.count_rows(child.valid)
    states_per_agg = [
        (item, arg_cvs,
         item.fn.update(dataclasses.replace(gctx, premask=premask),
                        arg_cvs, cond))
        for item, arg_cvs, cond, premask in per_agg_inputs]
    return grouping, group_counts, states_per_agg


def _dense_stage1(grouping, child: ExecBlock, gctx, per_agg_inputs):
    """All dense (sum-family) aggregates batched into ONE matmul pass."""
    from ..ops import mxu_segsum
    cap_g = grouping.num_groups_cap
    base = child.valid & (grouping.group_ids < cap_g)
    ids = jnp.minimum(grouping.group_ids, cap_g - 1)

    count_masks: List = [None]           # [0] = the group row counts
    sum_specs: List = []
    plan = []                            # per agg: list of ('c'|'s', index)
    for item, arg_cvs, cond in per_agg_inputs:
        fn = item.fn
        mask = fn._row_mask(gctx, arg_cvs, cond)
        mask = None if mask is child.valid else mask
        if isinstance(fn, agg_reg.CountAgg):
            plan.append([("c", len(count_masks))])
            count_masks.append(mask)
        elif isinstance(fn, agg_reg.SumAgg):
            v = fn._value(gctx, arg_cvs[0]).astype(
                agg_reg._sum_state_dtype(fn.arg_types[0]))
            signed = not jnp.issubdtype(v.dtype, jnp.unsignedinteger)
            sum_specs.append((v, signed, arg_cvs[0].bounds, mask))
            plan.append([("s", len(sum_specs) - 1)])
        elif isinstance(fn, agg_reg.AvgAgg):
            v = fn._value(gctx, arg_cvs[0]).astype(
                agg_reg._sum_state_dtype(
                    dt.remove_nullable(fn.arg_types[0])))
            signed = not jnp.issubdtype(v.dtype, jnp.unsignedinteger)
            sum_specs.append((v, signed, arg_cvs[0].bounds, mask))
            steps = [("s", len(sum_specs) - 1), ("c", len(count_masks))]
            count_masks.append(mask)
            plan.append(steps)
        else:                            # unexpected: per-agg fallback
            plan.append([("u", (item, arg_cvs, cond))])

    counts, sums = mxu_segsum.mxu_group_reduce(
        ids, base, count_masks, sum_specs, cap_g)

    states_per_agg = []
    for (item, arg_cvs, cond), steps in zip(per_agg_inputs, plan):
        states = []
        for kind, ref in steps:
            if kind == "c":
                states.append(counts[ref])
            elif kind == "s":
                states.append(sums[ref])
            else:
                states = item.fn.update(gctx, *ref[1:])
                break
        if isinstance(item.fn, agg_reg.AvgAgg):
            # AvgAgg state order: [sum(f64 for floats / int), count]
            states = [states[0], states[1]]
        states_per_agg.append((item, arg_cvs, states))
    return counts[0], states_per_agg


def _finalize(node: L.AggregateNode, key_cvs, unique_keys, num_groups,
              group_counts, states_per_agg, cap_g, global_agg,
              sharded_out: bool, ctx: ExecContext,
              group_valid=None) -> ExecBlock:
    cols: Dict[str, ColVal] = {}
    ki = 0
    for (f, _), cv in zip(node.keys, key_cvs):
        if cv.validity is not None:
            uk_validity = unique_keys[ki].astype(jnp.uint8)
            ki += 1
        else:
            uk_validity = None
        uk = unique_keys[ki]
        ki += 1
        want = dt.remove_nullable(f.dtype).jnp_dtype
        if not f.dtype.is_dictionary and uk.dtype != want \
                and np.dtype(uk.dtype).kind in ("i", "u") \
                and np.dtype(want).kind in ("i", "u"):
            uk = uk.astype(want)     # widen keys narrowed for the sort
        cols[f.id] = ColVal(f.dtype, uk, uk_validity, cv.dictionary)
    for item, arg_cvs, states in states_per_agg:
        out = item.fn.finalize(states)
        data, validity = out[0], out[1]
        lengths = out[2] if len(out) > 2 else None
        sub = out[3] if len(out) > 3 else None
        if sub is not None:
            # composite (tuple-of-arrays) aggregate result: sub-columns
            # carry the data; the scalar data column is a placeholder
            cols[item.field.id] = ColVal(item.field.dtype, data, validity,
                                         None, lengths=lengths)
            cols[item.field.id].sub = sub
            continue
        if not isinstance(item.fn, agg_reg.CountAgg):
            zero = jnp.zeros((), data.dtype)
            if data.ndim == 2:      # Array-valued aggregate / packed -State
                data = jnp.where((group_counts > 0)[:, None], data, zero)
                if lengths is not None:
                    lengths = jnp.where(group_counts > 0, lengths,
                                        jnp.zeros((), lengths.dtype))
            else:
                data = jnp.where(group_counts > 0, data, zero)
        dict_ = arg_cvs[0].dictionary if (item.args
                                          and item.field.dtype.is_dictionary) \
            else None
        cols[item.field.id] = ColVal(item.field.dtype, data, validity, dict_,
                                     lengths=lengths)
    if group_valid is None:
        if global_agg:
            num_groups = jnp.maximum(num_groups, 1)
        group_valid = jnp.arange(cap_g, dtype=jnp.int64) < num_groups
    return ExecBlock(cols, group_valid, cap_g, sharded=sharded_out)


def _agg_capacity(child: ExecBlock, dims, global_agg: bool,
                  s: Settings) -> int:
    if global_agg:
        return 1024
    if dims is not None:
        total = 1
        for d in dims:
            total *= d[1]
        return pad_to(total)
    return pad_to(min(child.capacity, s.max_groups))


def _aggregate_local(node: L.AggregateNode, child: ExecBlock, key_cvs,
                     key_arrays, dims, global_agg: bool, ctx: ExecContext,
                     sharded_out: bool) -> ExecBlock:
    s = ctx.settings
    cap_g = _agg_capacity(child, dims, global_agg, s)
    grouping, group_counts, states_per_agg = _stage1(
        node, child, key_arrays, dims, cap_g, ctx, global_agg)
    if not global_agg and dims is None:
        ctx.checks.append(Check(grouping.num_groups, cap_g,
                                "GROUP BY cardinality exceeded max_groups; "
                                "raise the max_groups setting",
                                setting="max_groups"))
    return _finalize(node, key_cvs, grouping.unique_keys,
                     grouping.num_groups, group_counts, states_per_agg,
                     cap_g, global_agg, sharded_out, ctx,
                     group_valid=None if global_agg
                     else grouping.group_valid())


def _aggregate_two_stage(node: L.AggregateNode, child: ExecBlock, key_cvs,
                         key_arrays, dims, global_agg: bool, ctx: ExecContext
                         ) -> ExecBlock:
    """Distributed mergeable aggregation: local partial states -> exchange
    (all_to_all by key hash; all_gather for the single global group) ->
    regroup -> merge -> finalize.  The device-mesh translation of the reference's
    two-stage WithMergeableState flow (SURVEY.md §2.6)."""
    from ..parallel import exchange as ex
    s = ctx.settings
    cap_g = _agg_capacity(child, dims, global_agg, s)
    grouping, group_counts, states_per_agg = _stage1(
        node, child, key_arrays, dims, cap_g, ctx, global_agg)

    group_valid = grouping.group_valid()
    flat_states: List[jax.Array] = [group_counts]
    arity = [1]
    for item, _, states in states_per_agg:
        flat_states.extend(states)
        arity.append(len(states))

    if global_agg:
        keys_rx, v = ex.all_gather_rows(grouping.unique_keys, group_valid,
                                        ctx.axis_name)
        states_rx, _ = ex.all_gather_rows(flat_states, group_valid,
                                          ctx.axis_name)
        valid_rx = v
        sharded_out = False
    else:
        keys_rx, states_rx, valid_rx, overflow = ex.exchange_by_key(
            grouping.unique_keys, flat_states, group_valid,
            ctx.axis_name, ctx.n_shards, cap_g)
        ctx.checks.append(Check(overflow, cap_g,
                                "aggregation state exchange overflowed "
                                "per-shard capacity; raise max_groups"))
        sharded_out = True

    # Regroup received partial states by key and merge.
    g2 = agg_ops.group_by_sort(keys_rx, valid_rx, cap_g)
    ctx.checks.append(Check(g2.num_groups, cap_g,
                            "GROUP BY cardinality exceeded max_groups; "
                            "raise the max_groups setting",
                            setting="max_groups"))
    merged_counts = g2.reduce("sum", states_rx[0], valid_rx)
    i = 1
    merged_per_agg = []
    for item, arg_cvs, states in states_per_agg:
        ss = states_rx[i:i + len(states)]
        i += len(states)
        merged = item.fn.merge(ss, g2, valid_rx)
        merged_per_agg.append((item, arg_cvs, merged))

    return _finalize(node, key_cvs, g2.unique_keys, g2.num_groups,
                     merged_counts, merged_per_agg, cap_g, global_agg,
                     sharded_out, ctx,
                     group_valid=None if global_agg else g2.group_valid())


def _token_for_sort(cv: ColVal, item: L.SortItem, capacity: int) -> jax.Array:
    cv = cv.broadcast(capacity)
    rank = None
    if cv.dtype.is_dictionary:
        d = cv.dictionary
        if d is not None and len(d):
            vals = d.values.astype(str)
            order = np.argsort(vals, kind="stable")
            r = np.empty(len(vals), np.int64)
            r[order] = np.arange(len(vals))
            rank = jnp.asarray(r)[jnp.maximum(cv.data, 0)]
        else:
            rank = jnp.zeros(cv.data.shape, jnp.int64)
    return sort_ops.order_token(cv.data, descending=item.descending,
                                validity=cv.validity,
                                nulls_last=(item.nulls_last
                                            if not item.descending
                                            else item.nulls_last),
                                rank=rank)


def _exec_sort(node: L.SortNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    if any(i.fill is not None for i in node.items):
        if child.sharded and ctx.distributed:
            child = _gather_block(child, ctx)
        return _sort_with_fill(node, child, ctx)
    if child.sharded and ctx.distributed:
        # Distributed sort/top-N (reference: shard-local sort + initiator
        # k-way merge, SortingStep.cpp:339): shrink locally via top-k when a
        # LIMIT hint exists, then gather and finish globally.
        if (node.limit_hint is not None and len(node.items) == 1
                and node.limit_hint <= ctx.settings.limit_pushdown_threshold
                and node.limit_hint < child.capacity):
            child = _sort_block(node, child, ctx)     # local top-k shrink
        child = _gather_block(child, ctx)
    return _sort_block(node, child, ctx)


def _sort_with_fill(node: L.SortNode, child: ExecBlock, ctx: ExecContext
                    ) -> ExecBlock:
    """ORDER BY x WITH FILL [FROM a] [TO b] [STEP s]: append a grid of
    generated rows (other columns take default values), sort everything
    together, and drop grid points that collide with existing rows —
    the reference's FillingTransform
    (src/Processors/Transforms/FillingTransform.cpp) as one concat + sort."""
    item = node.items[0]
    if item.fill is None or any(i.fill is not None for i in node.items[1:]):
        raise NotImplementedError_(
            "WITH FILL is supported on the primary ORDER BY key only")
    if not isinstance(item.expr, BoundColumn):
        raise NotImplementedError_(
            "WITH FILL requires a plain column ORDER BY key")
    cap = child.capacity
    cv = evaluate(item.expr, child.env()).broadcast(cap)
    if cv.dtype.is_dictionary or cv.dtype.is_array:
        raise NotImplementedError_("WITH FILL requires a numeric key")
    f_from, f_to, f_step = item.fill
    desc = item.descending
    step = f_step if f_step is not None else (-1 if desc else 1)
    capf = pad_to(ctx.settings.fill_max_rows)
    is_f = jnp.issubdtype(cv.data.dtype, jnp.floating)
    wt = cv.data.dtype if is_f else jnp.int64
    data = cv.data.astype(wt)
    dvalid = child.valid if cv.validity is None \
        else child.valid & cv.validity.astype(jnp.bool_)
    big = jnp.asarray(jnp.inf if is_f else jnp.iinfo(jnp.int64).max, wt)
    vmin = jnp.min(jnp.where(dvalid, data, big))
    vmax = jnp.max(jnp.where(dvalid, data, -big))
    any_row = jnp.any(dvalid)
    lo = jnp.asarray(f_from, wt) if f_from is not None \
        else (vmax if desc else vmin)
    series = lo + jnp.arange(capf, dtype=wt) * jnp.asarray(step, wt)
    if desc:
        ok = (series > jnp.asarray(f_to, wt)) if f_to is not None \
            else (series >= vmin)
        ok = ok & (series <= lo)
    else:
        ok = (series < jnp.asarray(f_to, wt)) if f_to is not None \
            else (series <= vmax)
        ok = ok & (series >= lo)
    if f_from is None or f_to is None:
        ok = ok & any_row
    # extended block: original rows then the grid
    fill_fid = item.expr.name
    cols = {}
    for fid, c in child.cols.items():
        c = c.broadcast(cap)
        if fid == fill_fid:
            fdata = jnp.concatenate(
                [c.data, series.astype(c.data.dtype)])
            fv = None if c.validity is None else jnp.concatenate(
                [c.validity, jnp.ones((capf,), jnp.uint8)])
            cols[fid] = ColVal(c.dtype, fdata, fv, c.dictionary)
        else:
            pad_data = jnp.zeros((capf,) + c.data.shape[1:], c.data.dtype)
            fdata = jnp.concatenate([c.data, pad_data])
            if c.dtype.nullable:
                v0 = c.validity if c.validity is not None \
                    else jnp.ones((cap,), jnp.uint8)
                fv = jnp.concatenate([v0, jnp.zeros((capf,), jnp.uint8)])
            elif c.validity is not None:
                fv = jnp.concatenate([c.validity,
                                      jnp.ones((capf,), jnp.uint8)])
            else:
                fv = None
            lens = None
            if c.lengths is not None:
                l0 = c.lengths if getattr(c.lengths, "ndim", 0) == 1 \
                    else jnp.broadcast_to(c.lengths, (cap,))
                lens = jnp.concatenate([l0, jnp.zeros((capf,), l0.dtype)])
            cols[fid] = ColVal(c.dtype, fdata, fv, c.dictionary,
                               lengths=lens)
    ext_cap = cap + capf
    valid = jnp.concatenate([child.valid, ok])
    is_fill = jnp.concatenate([jnp.zeros((cap,), jnp.bool_),
                               jnp.ones((capf,), jnp.bool_)])
    eb = ExecBlock(cols, valid, ext_cap)

    tokens = [_token_for_sort(evaluate(i.expr, eb.env()), i, ext_cap)
              for i in node.items]
    tokens.append(is_fill.astype(jnp.uint8))    # originals first at ties
    perm = sort_ops.sort_permutation(tokens, valid)
    out_cols = {fid: _gather_colval(c, perm, ext_cap)
                for fid, c in eb.cols.items()}
    n_valid = jnp.sum(valid.astype(jnp.int64))
    in_range = jnp.arange(ext_cap, dtype=jnp.int64) < n_valid
    # drop grid points equal to an existing row (sorted adjacency)
    kv = out_cols[fill_fid].data
    isf_s = is_fill[perm]
    dup = isf_s & jnp.concatenate(
        [jnp.zeros((1,), jnp.bool_), kv[1:] == kv[:-1]])
    return ExecBlock(out_cols, in_range & jnp.logical_not(dup), ext_cap)


def _sort_block(node: L.SortNode, child: ExecBlock, ctx: ExecContext
                ) -> ExecBlock:
    cap = child.capacity
    tokens = [_token_for_sort(evaluate(i.expr, child.env()), i, cap)
              for i in node.items]
    n_valid = jnp.sum(child.valid.astype(jnp.int64))

    s = ctx.settings
    if (node.limit_hint is not None and len(tokens) == 1
            and node.limit_hint <= s.limit_pushdown_threshold
            and node.limit_hint < cap):
        k = int(node.limit_hint)
        it0 = node.items[0]
        cv0 = evaluate(it0.expr, child.env()).broadcast(cap)
        key32 = sort_ops.topk_key32(cv0, it0.descending)
        if key32 is not None and cap >= (1 << 16) and k <= 4096:
            idx = sort_ops.topk_permutation32(key32, child.valid, k)
        else:
            idx = sort_ops.topk_permutation(tokens[0], child.valid, k)
        out_cap = pad_to(k)
        pad_idx = jnp.zeros((out_cap,), jnp.int32)
        idx_full = pad_idx.at[:k].set(idx)
        cols = {fid: _gather_colval(cv, idx_full, cap)
                for fid, cv in child.cols.items()}
        valid = jnp.arange(out_cap, dtype=jnp.int64) < jnp.minimum(n_valid, k)
        return ExecBlock(cols, valid, out_cap, sharded=child.sharded)

    perm = sort_ops.sort_permutation(tokens, child.valid)
    cols = {fid: _gather_colval(cv, perm, cap)
            for fid, cv in child.cols.items()}
    valid = jnp.arange(cap, dtype=jnp.int64) < n_valid
    return ExecBlock(cols, valid, cap, sharded=child.sharded)


def _exec_array_join(node: L.ArrayJoinNode, ctx: ExecContext) -> ExecBlock:
    """Row expansion: one output row per array element (ArrayJoinTransform
    analog) via the gather-only replicate scheme."""
    child = execute_plan(node.child, ctx)
    cap = child.capacity
    arr = evaluate(node.array_expr, child.env()).broadcast(cap)
    lens = jnp.where(child.valid, arr.lengths.astype(jnp.int64), 0)
    cum = jnp.cumsum(lens)
    first = cum - lens
    total = cum[-1]
    max_len = arr.data.shape[-1]
    if ctx.settings.max_array_join_rows > 0:
        out_cap = pad_to(ctx.settings.max_array_join_rows)
    else:
        out_cap = pad_to(min(cap * max_len, max(cap * 4, 1 << 16)))
    ctx.checks.append(Check(total, out_cap,
                            "arrayJoin expansion exceeded capacity",
                            setting="max_array_join_rows"))
    j = jnp.arange(out_cap, dtype=jnp.int64)
    row = jnp.clip(search_ops.searchsorted(cum, j, side="right"), 0, cap - 1) \
        .astype(jnp.int32)
    k = jnp.clip(j - first[row], 0, max_len - 1).astype(jnp.int32)
    cols = {fid: _gather_colval(cv, row, cap)
            for fid, cv in child.cols.items()}
    elem = jnp.take_along_axis(arr.data[row], k[:, None], axis=-1)[:, 0]
    # literal/bounded source arrays: the element column inherits value
    # bounds (lets range(k)/bit-width fast paths fire after arrayJoin)
    ebounds = arr.bounds
    if ebounds is None and not isinstance(arr.data, jax.core.Tracer) \
            and arr.dictionary is None \
            and arr.data.dtype.kind in ("i", "u") and arr.data.size:
        import numpy as _np
        host = _np.asarray(jax.device_get(arr.data))
        ebounds = (int(host.min()), int(host.max()))
    cols[node.out_field.id] = ColVal(node.out_field.dtype, elem, None,
                                     arr.dictionary, bounds=ebounds)
    valid = j < total
    return ExecBlock(cols, valid, out_cap, sharded=child.sharded)


def _window_frame_agg(item: L.WindowItem, fn: str, child: ExecBlock,
                      g, gid: jax.Array, pb: jax.Array,
                      tokens: List[jax.Array], mask_s: jax.Array,
                      argmask_s: jax.Array, v_s: Optional[jax.Array],
                      cap: int, ctx: ExecContext):
    """Aggregate window functions over an arbitrary frame, evaluated in
    SORTED partition order (WindowTransform analog,
    src/Processors/Transforms/WindowTransform.cpp:695 — the reference walks
    frame boundaries row by row; here every row's [lo, hi] frame indices are
    computed at once and aggregates become prefix/suffix scans, index
    gathers, or a sparse range-min table).

    Frames: "running" = RANGE UNBOUNDED PRECEDING..CURRENT ROW (peers of the
    current row included, the SQL default), "full", or ("rows"|"range", lo,
    hi) with lo/hi None = unbounded / 0 = current row / signed offset.
    """
    from ..ops import scan_ops
    from ..ops import search as search_ops
    frame = item.frame
    if frame == "full":
        mode, lo, hi = "rows", None, None
    elif frame == "running":
        mode, lo, hi = "range", None, 0
    else:
        mode, lo, hi = frame
    if mode == "range" and (lo not in (None, 0) or hi not in (None, 0)):
        if len(item.order_by) != 1:
            raise ExecutionError("RANGE OFFSET frames require exactly one "
                                 "ORDER BY expression")
        if item.order_by and evaluate(item.order_by[0].expr,
                                      child.env()).dtype.is_dictionary:
            raise ExecutionError("RANGE OFFSET frames require a numeric "
                                 "ORDER BY expression")

    i_arr = jnp.arange(cap, dtype=jnp.int64)
    s_row = jnp.clip(g.starts, 0, cap - 1)[gid].astype(jnp.int64)
    e_row = jnp.clip(g.ends - 1, 0, cap - 1)[gid].astype(jnp.int64)

    def tie_bounds():
        tie_b = pb
        for t in tokens:
            ts = g.take(t)
            tie_b = tie_b | jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), ts[1:] != ts[:-1]])
        r = jnp.cumsum(tie_b.astype(jnp.int32)) - 1
        rs, re2 = scan_ops.segment_starts_ends(r, cap)
        return (jnp.clip(rs, 0, cap - 1)[r].astype(jnp.int64),
                (jnp.clip(re2, 1, cap) - 1)[r].astype(jnp.int64))

    def range_edge(off: int, side: str) -> jax.Array:
        """Sorted index of the first/last row whose ORDER BY value is within
        `off` of the current row's (RANGE OFFSET bound, one merge sort)."""
        si = item.order_by[0]
        cv = evaluate(si.expr, child.env()).broadcast(cap)
        delta = off if not si.descending else -off
        data = cv.data
        if jnp.issubdtype(data.dtype, jnp.integer):
            info = jnp.iinfo(data.dtype)
            d = jnp.asarray(delta, data.dtype)
            if delta >= 0:
                sh = jnp.where(data > info.max - d, info.max, data + d)
            else:
                sh = jnp.where(data < info.min - d, info.min, data + d)
        else:
            sh = data + delta
        qtok = _token_for_sort(ColVal(cv.dtype, sh, cv.validity,
                                      cv.dictionary), si, cap)
        pos = search_ops.searchsorted_seg(
            g.group_ids, g.take(tokens[0]), g.group_ids, g.take(qtok),
            side=side).astype(jnp.int64)
        return pos if side == "left" else pos - 1

    tie_first = tie_last = None
    if mode == "range" and (0 in (lo, hi)):
        tie_first, tie_last = tie_bounds()
    if mode == "rows":
        lo0 = s_row if lo is None else i_arr + lo
        hi0 = e_row if hi is None else i_arr + hi
    else:
        lo0 = s_row if lo is None else (
            tie_first if lo == 0 else range_edge(lo, "left"))
        hi0 = e_row if hi is None else (
            tie_last if hi == 0 else range_edge(hi, "right"))
    nonempty = (lo0 <= hi0) & (lo0 <= e_row) & (hi0 >= s_row)
    lo_idx = jnp.clip(jnp.maximum(lo0, s_row), 0, cap - 1)
    hi_idx = jnp.clip(jnp.minimum(hi0, e_row), 0, cap - 1)
    lo_prev = jnp.maximum(lo_idx - 1, 0)

    def frame_sum(acc: jax.Array, m: Optional[jax.Array]) -> jax.Array:
        """Per-partition inclusive prefix scan, differenced at the frame
        edges (exact for UNBOUNDED PRECEDING frames: no subtraction)."""
        pre = scan_ops.running_reduce("sum", acc, pb, m)
        prev = jnp.where(lo_idx > s_row, pre[lo_prev],
                         jnp.zeros((), pre.dtype))
        return jnp.where(nonempty, pre[hi_idx] - prev,
                         jnp.zeros((), pre.dtype))

    fcnt = frame_sum(argmask_s.astype(jnp.int64), None)

    validity_out = None
    dict_ = None
    if fn == "count":
        return fcnt, None, None

    cv0 = evaluate(item.args[0], child.env())
    if fn in ("sum", "avg"):
        st = dt.remove_nullable(item.field.dtype).jnp_dtype
        acc = v_s.astype(jnp.float64 if fn == "avg"
                         or jnp.issubdtype(st, jnp.floating)
                         else (jnp.uint64 if jnp.issubdtype(
                             v_s.dtype, jnp.unsignedinteger)
                             else jnp.int64))
        out_s = frame_sum(acc, argmask_s)
        if fn == "avg":
            out_s = jnp.where(
                fcnt > 0,
                out_s.astype(jnp.float64)
                / jnp.maximum(fcnt, 1).astype(jnp.float64),
                jnp.nan)
        return out_s, None, None

    rev_pb = jnp.concatenate([pb[1:], jnp.ones((1,), jnp.bool_)])[::-1]

    def suffix_scan(op: str, data: jax.Array, m: Optional[jax.Array]
                    ) -> jax.Array:
        rm = m[::-1] if m is not None else None
        return scan_ops.running_reduce(op, data[::-1], rev_pb, rm)[::-1]

    if fn in ("min", "max"):
        dict_ = cv0.dictionary
        if lo is None:
            out_s = scan_ops.running_reduce(fn, v_s, pb, argmask_s)[hi_idx]
        elif hi is None:
            out_s = suffix_scan(fn, v_s, argmask_s)[lo_idx]
        else:
            # both edges move: sparse range-min table, ceil(log2(W))+1
            # doubling levels; per-row level pick covers [lo, hi] with two
            # overlapping power-of-two spans
            if mode == "rows":
                W = hi - lo + 1
            else:
                W = cap
            if jnp.issubdtype(v_s.dtype, jnp.integer) \
                    or v_s.dtype == jnp.bool_:
                base = v_s.astype(jnp.int64) if v_s.dtype == jnp.bool_ \
                    else v_s
                ident = jnp.asarray(jnp.iinfo(base.dtype).max if fn == "min"
                                    else jnp.iinfo(base.dtype).min,
                                    base.dtype)
            else:
                base = v_s
                ident = jnp.asarray(jnp.inf if fn == "min" else -jnp.inf,
                                    base.dtype)
            fnop = jnp.minimum if fn == "min" else jnp.maximum
            m0 = jnp.where(argmask_s, base, ident)
            levels = [m0]
            K = max(1, int(W).bit_length())
            for k in range(1, K):
                step = 1 << (k - 1)
                prev_l = levels[-1]
                shifted = jnp.concatenate(
                    [prev_l[step:], jnp.full((step,), ident, prev_l.dtype)])
                levels.append(fnop(prev_l, shifted))
            M = jnp.stack(levels).reshape(-1)
            length = jnp.maximum(hi_idx - lo_idx + 1, 1)
            kk = jnp.clip(jnp.floor(jnp.log2(length.astype(jnp.float64)))
                          .astype(jnp.int64), 0, K - 1)
            pw = jnp.int64(1) << kk
            a1 = M[kk * cap + lo_idx]
            a2 = M[kk * cap + jnp.maximum(hi_idx - pw + 1, lo_idx)]
            out_s = fnop(a1, a2).astype(v_s.dtype)
        out_s = jnp.where(nonempty & (fcnt > 0), out_s,
                          jnp.zeros((), out_s.dtype))
        return out_s, None, dict_

    if fn in ("any", "first_value", "last_value"):
        dict_ = cv0.dictionary
        argv = g.take(cv0.validity.astype(jnp.bool_)) \
            if cv0.validity is not None else None
        if fn == "any":
            # first NON-NULL value in the frame (AggregateFunctionAny)
            nxt = suffix_scan("min",
                              jnp.where(argmask_s, i_arr, jnp.int64(cap)),
                              None)
            idx0 = jnp.clip(nxt[lo_idx], 0, cap - 1)
            ok = nonempty & (nxt[lo_idx] <= hi_idx)
        else:
            idx0 = lo_idx if fn == "first_value" else hi_idx
            ok = nonempty
            if argv is not None:
                ok = ok & argv[idx0]
        out_s = jnp.where(ok, v_s[idx0], jnp.zeros((), v_s.dtype))
        if argv is not None or item.field.dtype.nullable:
            validity_out = ok.astype(jnp.uint8)
        return out_s, validity_out, dict_

    raise NotImplementedError_(f"window function '{fn}'")


def _exec_window(node: L.WindowNode, ctx: ExecContext) -> ExecBlock:
    """Window functions over sorted partitions (WindowTransform analog):
    partition = sort grouping with the ORDER BY tokens as secondary sort;
    frames are segmented scans; results return to original row order via the
    inverse permutation (gathers only)."""
    from ..ops import scan_ops
    child = execute_plan(node.child, ctx)
    if child.sharded and ctx.distributed:
        child = _gather_block(child, ctx)   # round-1: centralize windows
    cap = child.capacity
    cols = dict(child.cols)

    for item in node.items:
        if item.partition_by:
            pcvs = [evaluate(e, child.env()) for e in item.partition_by]
            pk, _ = _key_arrays(pcvs, cap)
        else:
            pk = [jnp.zeros((cap,), jnp.int32)]
        tokens = [_token_for_sort(evaluate(si.expr, child.env()), si, cap)
                  for si in item.order_by]
        cap_g = pad_to(min(cap, ctx.settings.max_groups))
        g = agg_ops.group_by_sort(pk, child.valid, cap_g, secondary=tokens)
        mask_s = g.take(child.valid)
        inv = jnp.argsort(g.perm)
        gid = jnp.minimum(g.group_ids, cap_g - 1)
        pb = g.boundary

        v_s = None
        argmask_s = mask_s
        if item.args:
            cv0 = evaluate(item.args[0], child.env()).broadcast(cap)
            v_s = g.take(cv0.data)
            if cv0.validity is not None:
                argmask_s = mask_s & g.take(cv0.validity.astype(jnp.bool_))

        # running count of valid rows per partition (basis for numbering)
        c = jnp.cumsum(mask_s.astype(jnp.int64))
        before = jnp.where(g.starts > 0, c[jnp.maximum(g.starts - 1, 0)], 0)
        rownum = c - before[gid]                 # 1-based among valid rows

        validity_out = None
        fn = item.fn
        st = dt.remove_nullable(item.field.dtype).jnp_dtype
        dict_ = None
        if fn == "row_number":
            out_s = rownum
        elif fn in ("rank", "dense_rank"):
            tie_b = pb
            for t in tokens:
                ts = g.take(t)
                tie_b = tie_b | jnp.concatenate(
                    [jnp.ones((1,), jnp.bool_), ts[1:] != ts[:-1]])
            if fn == "rank":
                out_s = scan_ops.running_reduce("first", rownum, tie_b,
                                                mask_s)
            else:
                rfirst = scan_ops.running_reduce(
                    "first", jnp.arange(cap, dtype=jnp.int64), tie_b, mask_s)
                is_new = mask_s & (rfirst == jnp.arange(cap, dtype=jnp.int64))
                out_s = scan_ops.running_reduce(
                    "sum", is_new.astype(jnp.int64), pb, mask_s)
        elif fn in ("lag", "lead"):
            shift = item.shift if fn == "lag" else -item.shift
            idx = jnp.arange(cap, dtype=jnp.int64) - shift
            ok = (idx >= 0) & (idx < cap)
            idx_c = jnp.clip(idx, 0, cap - 1)
            ok = ok & (gid[idx_c] == gid) & mask_s & g.take(child.valid)[idx_c]
            out_s = jnp.where(ok, v_s[idx_c], jnp.zeros((), v_s.dtype))
            validity_out = ok.astype(jnp.uint8)
            cv0 = evaluate(item.args[0], child.env())
            dict_ = cv0.dictionary
        elif fn in ("count", "sum", "avg", "min", "max",
                    "any", "first_value", "last_value"):
            out_s, validity_out, dict_ = _window_frame_agg(
                item, fn, child, g, gid, pb, tokens, mask_s, argmask_s,
                v_s, cap, ctx)
        else:
            raise NotImplementedError_(f"window function '{fn}'")

        out_raw = out_s[inv].astype(st) if out_s.dtype != st \
            else out_s[inv]
        v_raw = validity_out[inv] if validity_out is not None else None
        cols[item.field.id] = ColVal(item.field.dtype, out_raw, v_raw, dict_)

    return ExecBlock(cols, child.valid, cap, sharded=child.sharded)


def _exec_limit(node: L.LimitNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    if child.sharded and ctx.distributed:
        child = _gather_block(child, ctx)   # LIMIT needs a global row order
    rank = jnp.cumsum(child.valid.astype(jnp.int64)) - 1
    keep = child.valid & (rank >= node.offset)
    if node.limit >= 0:
        keep = keep & (rank < node.offset + node.limit)
    return ExecBlock(child.cols, keep, child.capacity)


def _exec_limit_by(node: L.LimitByNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    if child.sharded and ctx.distributed:
        child = _gather_block(child, ctx)
    cap = child.capacity
    key_cvs = [evaluate(e, child.env()) for e in node.keys]
    key_arrays, _ = _key_arrays(key_cvs, cap)
    cap_g = pad_to(min(cap, ctx.settings.max_groups))
    g = agg_ops.group_by_sort(key_arrays, child.valid, cap_g)
    mask_s = g.take(child.valid)
    # rank of each valid row within its group (stream order preserved by
    # the stable sort): running count of valid rows minus the count before
    # the group's first row
    c = jnp.cumsum(mask_s.astype(jnp.int64))
    gid = jnp.minimum(g.group_ids, cap_g - 1)
    before = jnp.where(g.starts > 0, c[jnp.maximum(g.starts - 1, 0)], 0)
    pos_in_group = c - 1 - before[gid]
    keep_sorted = mask_s & (pos_in_group >= node.offset) \
        & (pos_in_group < node.offset + node.n)
    # back to original row order via the inverse permutation (a sort, not a
    # scatter)
    inv = jnp.argsort(g.perm)
    keep = keep_sorted[inv]
    return ExecBlock(child.cols, child.valid & keep, cap)


def _exec_distinct(node: L.DistinctNode, ctx: ExecContext) -> ExecBlock:
    child = execute_plan(node.child, ctx)
    sharded_out = False
    if child.sharded and ctx.distributed:
        # distribute DISTINCT like a keyed aggregation: LOCAL dedup first
        # (each shard then sends at most one row per distinct key, so a
        # heavy-hitter row costs n_shards received copies instead of all of
        # them — the skew answer for DISTINCT), then repartition by row hash
        # so equal rows co-locate, then a second local dedup (output stays
        # sharded and globally distinct)
        child = _local_distinct(node, child, ctx, sharded=True)
        cvs0 = [child.cols[f.id] for f in node.schema]
        keys0, _ = _key_arrays(cvs0, child.capacity)
        child = _repartition_block(child, keys0, ctx)
        sharded_out = True
    return _local_distinct(node, child, ctx, sharded=sharded_out)


def _local_distinct(node: L.DistinctNode, child: ExecBlock,
                    ctx: ExecContext, sharded: bool) -> ExecBlock:
    cap = child.capacity
    cvs = [child.cols[f.id] for f in node.schema]
    key_arrays, _ = _key_arrays(cvs, cap)
    cap_g = pad_to(min(cap, ctx.settings.max_groups))
    g = agg_ops.group_by_sort(key_arrays, child.valid, cap_g)
    ctx.checks.append(Check(g.num_groups, cap_g,
                            "DISTINCT cardinality exceeded max_groups",
                            setting="max_groups"))
    cols = {}
    ki = 0
    for f, cv in zip(node.schema, cvs):
        cv_b = cv.broadcast(cap)
        if cv_b.validity is not None:
            uv = g.unique_keys[ki].astype(jnp.uint8)
            ki += 1
            cols[f.id] = ColVal(cv_b.dtype, g.unique_keys[ki], uv,
                                cv_b.dictionary)
        else:
            cols[f.id] = ColVal(cv_b.dtype, g.unique_keys[ki], None,
                                cv_b.dictionary)
        ki += 1
    valid = jnp.arange(cap_g, dtype=jnp.int64) < g.num_groups
    return ExecBlock(cols, valid, cap_g, sharded=sharded)


def _unify_join_keys(lk: ColVal, rk: ColVal, lcap: int, rcap: int):
    """Common representation of one join key pair (dictionary unification
    for strings, numeric supertype cast otherwise)."""
    lk = lk.broadcast(lcap)
    rk = rk.broadcast(rcap)
    if lk.dtype.is_dictionary and rk.dtype.is_dictionary:
        la, ra, _merged = _string_codes_common(lk, rk)
        return la, ra, lk.validity, rk.validity
    ct = np.promote_types(lk.data.dtype, rk.data.dtype)
    return lk.data.astype(ct), rk.data.astype(ct), lk.validity, rk.validity


def _colval_words(cv: ColVal, capacity: int, bounds=None):
    """Decompose a ColVal into 32-bit words + a reassembler (for carrying
    build columns through the propagate-join sorts as i32 operands)."""
    cv = cv.broadcast(capacity)
    data = cv.data
    kind = np.dtype(data.dtype).kind
    itemsize = np.dtype(data.dtype).itemsize
    words: List[jax.Array] = []
    if kind in ("i", "u", "b") and itemsize <= 4:
        words.append(data.astype(jnp.int32))

        def rebuild(ws, dt_=data.dtype):
            return ws[0].astype(dt_)
    elif kind in ("i", "u"):
        if bounds is not None and -2**31 <= bounds[0] and bounds[1] < 2**31:
            words.append(data.astype(jnp.int32))

            def rebuild(ws, dt_=data.dtype):
                return ws[0].astype(dt_)
        else:
            words.append(data.astype(jnp.uint32).astype(jnp.int32))  # lo
            words.append((data.astype(jnp.int64)
                          >> jnp.int64(32)).astype(jnp.int32))       # hi

            def rebuild(ws, dt_=data.dtype):
                lo = ws[0].astype(jnp.uint32).astype(jnp.uint64)
                hi = ws[1].astype(jnp.int64).astype(jnp.uint64)
                return ((hi << jnp.uint64(32)) | lo).astype(dt_)
    elif data.dtype == jnp.float32:
        words.append(jax.lax.bitcast_convert_type(data, jnp.int32))

        def rebuild(ws):
            return jax.lax.bitcast_convert_type(ws[0], jnp.float32)
    elif data.dtype == jnp.float64:
        from ..ops.hash_ops import f64_from_token, f64_token
        bits = f64_token(data)
        words.append(bits.astype(jnp.uint32).astype(jnp.int32))
        words.append((bits >> jnp.uint64(32)).astype(jnp.uint32)
                     .astype(jnp.int32))

        def rebuild(ws):
            lo = ws[0].astype(jnp.uint32).astype(jnp.uint64)
            hi = ws[1].astype(jnp.uint32).astype(jnp.uint64)
            return f64_from_token((hi << jnp.uint64(32)) | lo)
    else:
        return None
    if cv.validity is not None:
        words.append(cv.validity.astype(jnp.int32))
    return words, rebuild


def _propagate_ok(node: L.JoinNode, right: ExecBlock) -> bool:
    """Can this join run on the propagate (no-expansion) path?"""
    if node.kind == "cross":
        return False
    if node.strictness in ("semi", "anti", "any", "asof"):
        ok_kinds = True
    elif node.strictness == "all" and node.kind in ("inner", "left") \
            and node.build_unique:
        ok_kinds = True
    else:
        return False
    left_ids = {f.id for f in node.left.schema}
    for f in node.schema:
        if f.id in left_ids:
            continue
        cv = right.cols.get(f.id)
        if cv is None or cv.dtype.is_array or getattr(
                cv.data, "ndim", 1) > 1:
            return False
    return ok_kinds


def _join_propagate(node: L.JoinNode, left: ExecBlock, right: ExecBlock,
                    lkeys, rkeys, probe_ok, build_ok,
                    ctx: ExecContext) -> ExecBlock:
    """Propagate-join execution: output capacity == probe capacity."""
    s = ctx.settings
    lcap, rcap = left.capacity, right.capacity
    # build-side output columns -> 32-bit words
    left_ids = {f.id for f in node.left.schema}
    right_fields = [f for f in node.schema if f.id not in left_ids]
    per_field = []           # (field, cv, n_data_words, rebuild)
    build_words: List[jax.Array] = []
    for f in right_fields:
        cv = right.cols[f.id]
        dec = _colval_words(cv, rcap, bounds=ctx.field_bounds.get(f.id))
        assert dec is not None, "checked by _propagate_ok"
        words, rebuild = dec
        cvb = cv.broadcast(rcap)
        n_data = len(words) - (1 if cvb.validity is not None else 0)
        per_field.append((f, cvb, n_data, rebuild))
        build_words.extend(words)

    asof_tokens = None
    asof_strict = False
    if node.strictness == "asof":
        lt = evaluate(node.asof_left, left.env()).broadcast(lcap)
        rt = evaluate(node.asof_right, right.env()).broadcast(rcap)
        ct = np.promote_types(np.dtype(lt.data.dtype),
                              np.dtype(rt.data.dtype))
        # left <= right: candidates have right >= left, best = SMALLEST right
        # -> descending tokens turn that into "last token <= probe token"
        desc = node.asof_op in ("<", "<=")
        bt = sort_ops.order_token(rt.data.astype(ct), descending=desc)
        pt = sort_ops.order_token(lt.data.astype(ct), descending=desc)
        asof_tokens = (bt, pt)
        asof_strict = node.asof_op in ("<", ">")
        if lt.validity is not None:
            probe_ok = probe_ok & lt.validity.astype(jnp.bool_)
        if rt.validity is not None:
            build_ok = build_ok & rt.validity.astype(jnp.bool_)

    # Dense direct-address fast path: unique build keys in a small proven
    # range turn the join into one scatter + ONE int32 gather per payload
    # word (bound by random-probe latency).  Each word needs a sentinel
    # value outside its proven range.
    pr = None
    if (asof_tokens is None and len(rkeys) == 1
            and s.join_dense_gather
            and (node.build_unique or node.strictness in ("semi", "anti"))
            and np.dtype(rkeys[0].dtype).kind in ("i", "u")):
        from ..plan import ranges
        rb = ranges.infer_bounds(node.right_keys[0], ctx.field_bounds)
        dense_words = None
        key_field = node.right_keys[0].name \
            if isinstance(node.right_keys[0], BoundColumn) else None
        if rb is not None \
                and rb[1] - rb[0] + 1 <= s.join_dense_table_entries:
            dense_words = []
            n_gathers = 0
            wi = 0
            for f, cvb, n_data, rebuild in per_field:
                fb = ctx.field_bounds.get(f.id)
                has_v = cvb.validity is not None
                n_words = n_data + (1 if has_v else 0)
                fws = build_words[wi:wi + n_words]
                wi += n_words
                is_key = f.id == key_field and n_data == 1
                for j, w in enumerate(fws):
                    if dense_words is None:
                        continue
                    if is_key:                    # value == probe key: free
                        dense_words.append(("key",) if j < n_data
                                           else ("keyvalid",))
                    elif j >= n_data:             # validity word in {0, 1}
                        dense_words.append(("word", w, 2))
                        n_gathers += 1
                    elif n_data == 1 and fb is not None:
                        lo_, hi_ = int(fb[0]), int(fb[1])
                        if lo_ > -(2 ** 31) + 1:
                            dense_words.append(("word", w, lo_ - 1))
                        elif hi_ < 2 ** 31 - 2:
                            dense_words.append(("word", w, hi_ + 1))
                        else:
                            dense_words = None    # no sentinel available
                        n_gathers += 1
                    else:
                        dense_words = None        # unbounded / multi-word
            if dense_words is not None \
                    and n_gathers > s.join_dense_gather_max_words:
                dense_words = None
        if dense_words is not None:
            ctx.count("DenseGatherJoins")
            pr = join_ops.dense_gather_join(rkeys[0], build_ok, lkeys[0],
                                            probe_ok, dense_words,
                                            rb[0], rb[1])
    if pr is None:
        pr = join_ops.propagate_join(rkeys, build_ok, lkeys, probe_ok,
                                     build_words, asof_tokens=asof_tokens,
                                     asof_strict=asof_strict)

    if node.strictness in ("semi", "anti"):
        keep = pr.matched if node.strictness == "semi" else ~pr.matched
        return ExecBlock(left.cols, left.valid & keep, lcap,
                         sharded=left.sharded)

    left_outer = node.kind == "left"
    mmask = pr.matched
    cols: Dict[str, ColVal] = {}
    for f in node.schema:
        if f.id in left_ids:
            cols[f.id] = left.cols[f.id]
            continue
    wi = 0
    for f, cv, nw, rebuild in per_field:
        has_v = cv.validity is not None
        ws = pr.words[wi:wi + nw]
        wi += nw + (1 if has_v else 0)
        data = rebuild(ws)
        validity = (pr.words[wi - 1].astype(jnp.uint8) & jnp.uint8(1)) \
            if has_v else None
        if left_outer:
            if s.join_use_nulls or cv.dtype.nullable:
                v = validity if validity is not None \
                    else jnp.ones(data.shape, jnp.uint8)
                validity = jnp.where(mmask, v, 0).astype(jnp.uint8)
            else:
                data = jnp.where(mmask, data, _default_scalar(cv))
        else:
            data = jnp.where(mmask, data, jnp.zeros((), data.dtype))
        cols[f.id] = ColVal(cv.dtype, data, validity, cv.dictionary)

    valid = left.valid if left_outer else (left.valid & mmask)
    out = ExecBlock(cols, valid, lcap, sharded=left.sharded)
    if node.residual is not None:
        pred = evaluate(node.residual, out.env())
        out = ExecBlock(out.cols, out.valid & _bool_mask(pred, lcap),
                        lcap, sharded=left.sharded)
    return out


def _exec_join(node: L.JoinNode, ctx: ExecContext) -> ExecBlock:
    left = execute_plan(node.left, ctx)
    right = execute_plan(node.right, ctx)
    if right.sharded and ctx.distributed:
        # Broadcast join: replicate the (dim) build side on every shard —
        # the reference's GLOBAL JOIN / all-gather path (SURVEY.md §2.6).
        # Shuffle join (repartition both sides by unified key hash) when
        # requested via join_algorithm='shuffle'.
        use_shuffle = (not node.is_global and left.sharded
                       and node.kind != "cross"
                       and ctx.settings.join_algorithm == "shuffle")
        if not use_shuffle:
            right = _gather_block(right, ctx)
        else:
            lkey_cvs = [evaluate(e, left.env()) for e in node.left_keys]
            rkey_cvs = [evaluate(e, right.env()) for e in node.right_keys]
            lroute, rroute = [], []
            for lk_cv, rk_cv in zip(lkey_cvs, rkey_cvs):
                la, ra, _, _ = _unify_join_keys(lk_cv, rk_cv,
                                                left.capacity, right.capacity)
                lroute.append(la)
                rroute.append(ra)
            # Salted-key skew splitting (BASELINE requirement): spread each
            # probe key's rows over S shards of its hash group (salt =
            # rowid % S) and replicate each build row to all S salts, so a
            # heavy-hitter join key no longer serializes one shard.  Only
            # probe-outer kinds: replicating build rows would duplicate
            # RIGHT/FULL unmatched-build output.  S = n_shards degenerates
            # to a broadcast join; S = 1 is the plain shuffle.
            S = 1
            if node.kind in ("inner", "left") \
                    and node.strictness in ("all", "any", "semi", "anti"):
                S = max(1, min(ctx.settings.skew_salt_factor, ctx.n_shards))
                while ctx.n_shards % S:
                    S -= 1
            if S > 1:
                psalt = jnp.arange(left.capacity, dtype=jnp.int32) % S
                left = _repartition_block(left, lroute, ctx,
                                          salt=psalt, salt_mod=S)
                right, rroute = _tile_block(right, rroute, S)
                bsalt = (jnp.arange(right.capacity, dtype=jnp.int32)
                         // (right.capacity // S))
                right = _repartition_block(right, rroute, ctx,
                                           salt=bsalt, salt_mod=S)
            else:
                left = _repartition_block(left, lroute, ctx)
                right = _repartition_block(right, rroute, ctx)
    lcap, rcap = left.capacity, right.capacity
    s = ctx.settings

    if node.kind == "cross":
        lkeys = [jnp.zeros((lcap,), jnp.int32)]
        rkeys = [jnp.zeros((rcap,), jnp.int32)]
        probe_ok = left.valid
        build_ok = right.valid
    else:
        from ..plan import ranges
        lkey_cvs = [evaluate(e, left.env()) for e in node.left_keys]
        rkey_cvs = [evaluate(e, right.env()) for e in node.right_keys]
        lkeys, rkeys = [], []
        probe_ok = left.valid
        build_ok = right.valid
        for le, re_, lk_cv, rk_cv in zip(node.left_keys, node.right_keys,
                                         lkey_cvs, rkey_cvs):
            la, ra, lv, rv = _unify_join_keys(lk_cv, rk_cv, lcap, rcap)
            # narrow 64-bit keys to i32 when interval analysis proves both
            # sides fit: half the bytes per sort operand
            if np.dtype(la.dtype).kind in ("i", "u") \
                    and np.dtype(la.dtype).itemsize == 8:
                lb = ranges.infer_bounds(le, ctx.field_bounds)
                rb = ranges.infer_bounds(re_, ctx.field_bounds)
                if lb is not None and rb is not None \
                        and min(lb[0], rb[0]) >= -2**31 \
                        and max(lb[1], rb[1]) < 2**31:
                    la = la.astype(jnp.int32)
                    ra = ra.astype(jnp.int32)
            lkeys.append(la)
            rkeys.append(ra)
            if lv is not None:     # NULL keys never match
                probe_ok = probe_ok & lv.astype(jnp.bool_)
            if rv is not None:
                build_ok = build_ok & rv.astype(jnp.bool_)

    if _propagate_ok(node, right):
        return _join_propagate(node, left, right, lkeys, rkeys,
                               probe_ok, build_ok, ctx)
    if node.strictness == "asof":
        raise NotImplementedError_(
            "ASOF JOIN with Array-typed right columns is not supported")

    cap_g = pad_to(min(rcap, s.max_join_build_rows))
    table = join_ops.build_join_table(rkeys, build_ok, cap_g)
    pr = join_ops.probe_join_table(table, lkeys, probe_ok)

    if node.strictness in ("semi", "anti"):
        keep = pr.matched if node.strictness == "semi" else ~pr.matched
        return ExecBlock(left.cols, left.valid & keep, lcap,
                         sharded=left.sharded)

    left_outer = node.kind == "left"
    any_join = node.strictness == "any"
    if node.kind == "cross":
        out_cap = pad_to(min(lcap * rcap, 1 << 24))
    elif s.max_joined_rows > 0:
        out_cap = pad_to(s.max_joined_rows)
    else:
        out_cap = pad_to(lcap + rcap)
    p_idx, b_pos, mmask, out_count = join_ops.expand_matches(
        pr, left.valid, out_cap, left=left_outer, any_join=any_join)
    ctx.checks.append(Check(out_count, out_cap,
                            "JOIN result exceeded the output capacity; raise "
                            "the max_joined_rows setting",
                            setting="max_joined_rows"))

    # b_pos addresses the KEY-SORTED build order: pre-permute each build
    # column once (build-sized gather), then one output-sized gather —
    # instead of two chained output-sized random gathers per column.
    b_idx = jnp.clip(b_pos, 0, rcap - 1)
    cols: Dict[str, ColVal] = {}
    left_ids = {f.id for f in node.left.schema}
    for f in node.schema:
        if f.id in left_ids:
            cols[f.id] = _gather_colval(left.cols[f.id], p_idx, lcap)
        else:
            cv = right.cols[f.id].broadcast(rcap)
            data = cv.data[table.row_order][b_idx]
            validity = cv.validity[table.row_order][b_idx] \
                if cv.validity is not None else None
            lengths = cv.lengths[table.row_order][b_idx] \
                if cv.lengths is not None else None
            if left_outer:
                # join_use_nulls=0 semantics: unmatched -> default value
                if s.join_use_nulls or cv.dtype.nullable:
                    v = validity if validity is not None \
                        else jnp.ones(data.shape[:1], jnp.uint8)
                    validity = jnp.where(mmask, v, 0).astype(jnp.uint8)
                else:
                    default = _default_scalar(cv)
                    mm = mmask if getattr(data, "ndim", 1) == 1 \
                        else mmask[:, None]
                    data = jnp.where(mm, data, default)
                if lengths is not None:
                    lengths = jnp.where(mmask, lengths, 0)
            cols[f.id] = ColVal(cv.dtype, data, validity, cv.dictionary,
                                lengths=lengths)

    j = jnp.arange(out_cap, dtype=jnp.int64)
    valid = j < out_count
    if node.kind != "left":
        valid = valid & mmask
    out = ExecBlock(cols, valid, out_cap, sharded=left.sharded)

    if node.residual is not None:
        pred = evaluate(node.residual, out.env())
        out = ExecBlock(out.cols, out.valid & _bool_mask(pred, out_cap),
                        out_cap, sharded=left.sharded)
    return out


def _default_scalar(cv: ColVal):
    if cv.dtype.is_dictionary:
        # default string is '' — ensure the dictionary has it
        d = cv.dictionary
        if d is not None:
            code = d.lookup("")
            if code < 0:
                d.values = np.append(d.values, "")
                d._index = None
                code = len(d.values) - 1
            return jnp.asarray(code, cv.data.dtype)
        return jnp.zeros((), cv.data.dtype)
    return jnp.zeros((), cv.data.dtype)


def _exec_union(node: L.UnionNode, ctx: ExecContext,
                _blocks=None) -> ExecBlock:
    blocks = _blocks if _blocks is not None \
        else [execute_plan(c, ctx) for c in node.inputs]
    if ctx.distributed and any(b.sharded for b in blocks) \
            and not all(b.sharded for b in blocks):
        # mixed shardedness: replicate everything (sharded ∪ sharded keeps
        # the concatenation sharded — disjoint by construction)
        blocks = [_gather_block(b, ctx) for b in blocks]
    out_cap = sum(b.capacity for b in blocks)
    cols: Dict[str, ColVal] = {}
    for i, f in enumerate(node.schema):
        pieces, vals, dicts = [], [], []
        for b, child in zip(blocks, node.inputs):
            cf = child.schema[i]
            cv = b.cols[cf.id].broadcast(b.capacity)
            pieces.append(cv)
            dicts.append(cv.dictionary)
        is_arr = dt.remove_nullable(f.dtype).is_array

        def _pad_w(x, W):
            if getattr(x, "ndim", 0) >= 2 and x.shape[-1] < W:
                return jnp.pad(x, ((0, 0), (0, W - x.shape[-1])))
            return x

        W = max((cv.data.shape[-1] for cv in pieces
                 if getattr(cv.data, "ndim", 0) >= 2), default=0) \
            if is_arr else 0
        if f.dtype.is_dictionary:
            # unify all dictionaries (host, trace-time)
            merged = None
            recoded = []
            for cv in pieces:
                d = cv.dictionary or Dictionary(np.asarray([], object))
                x0 = _pad_w(cv.data, W) if is_arr else cv.data
                if merged is None:
                    merged = d
                    recoded.append(x0)
                else:
                    merged, ra, rb = Dictionary.unify(merged, d)
                    lut = jnp.asarray(rb)
                    # empty remap = that side's dictionary was empty; its
                    # codes are padding only, keep them inert at 0
                    recoded = [(jnp.asarray(ra)[jnp.maximum(x, 0)]
                                if len(ra) else jnp.zeros_like(x))
                               for x in recoded]
                    recoded.append(lut[jnp.maximum(x0, 0)]
                                   if len(rb) else x0)
            data = jnp.concatenate(recoded)
            dict_ = merged
        else:
            st = dt.remove_nullable(f.dtype).jnp_dtype
            data = jnp.concatenate([_pad_w(cv.data.astype(st), W)
                                    if is_arr else cv.data.astype(st)
                                    for cv in pieces])
            dict_ = None
        if any(cv.validity is not None for cv in pieces):
            validity = jnp.concatenate(
                [cv.validity if cv.validity is not None
                 else jnp.ones((cv.data.shape[0],), jnp.uint8)
                 for cv in pieces])
        else:
            validity = None
        lengths = None
        if is_arr:
            lens_pieces = []
            for cv in pieces:
                lv = cv.lengths
                if lv is None:         # full-width rows
                    lv = jnp.full((cv.data.shape[0],),
                                  cv.data.shape[-1], jnp.int32)
                elif getattr(lv, "ndim", 0) == 0:
                    lv = jnp.broadcast_to(lv, (cv.data.shape[0],))
                lens_pieces.append(lv.astype(jnp.int32))
            lengths = jnp.concatenate(lens_pieces)
        cols[f.id] = ColVal(f.dtype, data, validity, dict_,
                            lengths=lengths)
    valid = jnp.concatenate([b.valid for b in blocks])
    return ExecBlock(cols, valid, out_cap,
                     sharded=any(b.sharded for b in blocks))


def _exec_setop(node: L.SetOpNode, ctx: ExecContext) -> ExecBlock:
    """INTERSECT / EXCEPT with multiset (ALL) or DISTINCT semantics.

    The reference counts rows in a hash table per side
    (src/Processors/Transforms/IntersectOrExceptTransform.cpp); here ONE
    sort co-locates identical rows of both sides, then the i-th left
    occurrence of a value survives iff i < right-count (INTERSECT ALL) /
    i >= right-count (EXCEPT ALL)."""
    left = execute_plan(node.left, ctx)
    right = execute_plan(node.right, ctx)
    if ctx.distributed and (left.sharded or right.sharded):
        # set membership needs the global row multiset on both sides
        left = _gather_block(left, ctx)
        right = _gather_block(right, ctx)
    u = L.UnionNode([node.left, node.right], node.schema)
    eb = _exec_union(u, ctx, _blocks=[left, right])
    cap = eb.capacity
    is_left = jnp.arange(cap) < left.capacity
    cvs = [eb.cols[f.id] for f in node.schema]
    keys, _ = _key_arrays(cvs, cap)
    cap_g = pad_to(min(cap, ctx.settings.max_groups))
    g = agg_ops.group_by_sort(keys, eb.valid, cap_g)
    ctx.checks.append(Check(g.num_groups, cap_g,
                            f"{node.op.upper()} cardinality exceeded "
                            "max_groups", setting="max_groups"))
    mask_s = g.take(eb.valid)
    left_s = g.take(is_left)
    gid = jnp.minimum(g.group_ids, cap_g - 1)
    cnt_b = g.reduce("sum", jnp.logical_not(is_left).astype(jnp.int64),
                     eb.valid)[gid]
    # 0-based occurrence index of each LEFT row within its value group
    la = mask_s & left_s
    c = jnp.cumsum(la.astype(jnp.int64))
    before = jnp.where(g.starts > 0, c[jnp.maximum(g.starts - 1, 0)], 0)
    pos = c - 1 - before[gid]
    if node.distinct:
        first = pos == 0
        keep_s = la & first & ((cnt_b > 0) if node.op == "intersect"
                               else (cnt_b == 0))
    elif node.op == "intersect":
        keep_s = la & (pos < cnt_b)
    else:
        keep_s = la & (pos >= cnt_b)
    inv = jnp.argsort(g.perm)
    keep = keep_s[inv]
    cols = {}
    for f, lf in zip(node.schema, node.left.schema):
        cols[f.id] = eb.cols[f.id]
    return ExecBlock(cols, eb.valid & is_left & keep, cap)


_DISPATCH: Dict[type, Callable] = {
    L.ScanNode: _exec_scan,
    L.BlockSourceNode: _exec_blocksource,
    L.OneRowNode: _exec_onerow,
    L.NumbersNode: _exec_numbers,
    L.FilterNode: _exec_filter,
    L.ProjectNode: _exec_project,
    L.AggregateNode: _exec_aggregate,
    L.SortNode: _exec_sort,
    L.WindowNode: _exec_window,
    L.ArrayJoinNode: _exec_array_join,
    L.LimitNode: _exec_limit,
    L.LimitByNode: _exec_limit_by,
    L.DistinctNode: _exec_distinct,
    L.JoinNode: _exec_join,
    L.UnionNode: _exec_union,
    L.SetOpNode: _exec_setop,
}


# -- materialization ---------------------------------------------------------

def materialize(block: ExecBlock, schema: List[L.Field],
                ctx: ExecContext) -> Dict[str, np.ndarray]:
    """Pull the visible rows to host, in order (first host sync point)."""
    valid_np = np.asarray(jax.device_get(block.valid))
    for check in ctx.checks:
        actual = int(jax.device_get(check.value))
        if actual > check.limit:
            raise CapacityError(f"{check.message} (needed {actual}, "
                                f"capacity {check.limit})",
                                setting=check.setting, needed=actual)
    out: Dict[str, np.ndarray] = {}
    used = {}
    for f in schema:
        cv = block.cols[f.id].broadcast(block.capacity)
        data = np.asarray(jax.device_get(cv.data))[valid_np]
        if cv.dtype.map_types is not None and cv.sub is not None:
            # Map output: render per-row dicts from keys/values sub-arrays
            keys_cv, vals_cv = cv.sub
            subs = []
            for scv in (keys_cv, vals_cv):
                tmp = ExecBlock({"x": scv.broadcast(block.capacity)},
                                block.valid, block.capacity)
                fld = L.Field("x", "x", scv.dtype)
                subs.append(materialize(tmp, [fld],
                                        ExecContext({}, ctx.settings))["x"])
            rows = np.empty(len(subs[0]), object)
            for i in range(len(rows)):
                rows[i] = dict(zip(subs[0][i], subs[1][i]))
            name = f.display
            if name in out:
                k = 1
                while f"{name}_{k}" in out:
                    k += 1
                name = f"{name}_{k}"
            out[name] = rows
            continue
        if cv.dtype.tuple_types is not None and cv.sub is not None:
            # Tuple output: render per-row python tuples from sub-columns
            subs = []
            for scv in cv.sub:
                tmp = ExecBlock({"x": scv}, block.valid, block.capacity)
                fld = L.Field("x", "x", scv.dtype)
                subs.append(materialize(tmp, [fld],
                                        ExecContext({}, ctx.settings))["x"])
            rows = np.empty(len(subs[0]) if subs else 0, object)
            for i in range(len(rows)):
                rows[i] = tuple(s[i] for s in subs)
            name = f.display
            if name in out:
                k = 1
                while f"{name}_{k}" in out:
                    k += 1
                name = f"{name}_{k}"
            out[name] = rows
            continue
        if cv.dtype.agg_state is not None:
            rows = np.empty(len(data), object)
            for i in range(len(data)):
                rows[i] = data[i].astype(np.uint8).tobytes()
            name = f.display
            if name in out:
                k = 1
                while f"{name}_{k}" in out:
                    k += 1
                name = f"{name}_{k}"
            out[name] = rows
            continue
        if cv.dtype.is_array:
            if cv.lengths is None:     # full-width rows (no ragged mask)
                _lv = np.full(valid_np.shape,
                              int(np.asarray(cv.data).shape[-1]))
            else:
                _lv = np.asarray(jax.device_get(cv.lengths))
                if _lv.ndim == 0:      # constant array: scalar length
                    _lv = np.full(valid_np.shape, int(_lv))
            lens = _lv[valid_np]
            d = cv.dictionary
            rows = np.empty(len(data), object)
            from ..core import typed
            try:
                inner = dt.array_inner(cv.dtype)
            except ValueError:
                inner = None
            for i in range(len(data)):
                elems = data[i][:lens[i]]
                if cv.dtype.is_dictionary and d is not None:
                    rows[i] = [str(d.values[c]) if 0 <= c < len(d) else ""
                               for c in elems]
                elif inner is not None and typed.needs_decode(inner):
                    rows[i] = list(typed.decode_for_display(
                        inner, np.asarray([x.item() for x in elems],
                                          object)))
                else:
                    rows[i] = [x.item() for x in elems]
            name = f.display
            out[name] = rows
            continue
        if cv.dtype.is_dictionary:
            codes = data.astype(np.int64)
            vals = np.empty(len(codes), object)
            d = cv.dictionary
            ok = (codes >= 0) & (codes < (len(d) if d else 0))
            if d is not None and len(d):
                vals[ok] = d.values[codes[ok]]
            vals[~ok] = ""
            data = vals
        if cv.validity is not None:
            v = np.asarray(jax.device_get(cv.validity))[valid_np]
            if data.dtype != object:
                data = data.astype(object)
            else:
                data = data.copy()
            data[v == 0] = None
        from ..core import typed
        if typed.needs_decode(cv.dtype):
            data = typed.decode_for_display(cv.dtype, data)
        name = f.display
        if name in out:   # duplicate display names: disambiguate
            k = 1
            while f"{name}_{k}" in out:
                k += 1
            name = f"{name}_{k}"
        out[name] = data
    return out

"""Multi-host distributed execution over a JAX device mesh.

The replacement for the reference's distributed stack (StorageDistributed +
ClusterProxy + RemoteQueryExecutor, SURVEY.md §2.6/§2.7): tables are
hash-partitioned across the mesh axis, and the *same* plan executor runs
inside `shard_map` on every shard — collective-aware operators (two-stage
aggregation via all_to_all, broadcast/shuffle joins, distributed top-k)
insert device collectives exactly where the reference ships blocks over TCP.

Design notes:
  * one mesh axis ("shards") = the host/data-parallel axis; within-chip
    parallelism belongs to XLA;
  * per-shard row counts differ, so sharded tables carry an explicit
    __row_valid column instead of a scalar row count;
  * the whole distributed query compiles to ONE XLA program (shard_map under
    jit) — plan dispatch is the only host round-trip, like the reference's
    single scatter/gather exchange per query.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import dtypes as dt
from ..core.block import Block
from ..core.column import Column, Dictionary, pad_to
from ..core.settings import Settings
from ..exec.executor import (Check, ExecBlock, ExecContext, _gather_block,
                             execute_plan, materialize)
from ..exec.session import Session
from ..exprs.expr import ColVal
from ..ops import hash_ops
from ..storage.table import Table

__all__ = ["DistributedSession", "make_mesh"]

AXIS = "shards"


def shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15))
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


class ShardedChunkStream:
    """Host-side per-shard chunk feed for a Distributed table: the same
    shard assignment as the device layout (_shard_parts_into), chunked
    within each shard so a table larger than per-device memory streams through
    the sharded program chunk by chunk (reference: per-shard spill compose,
    MergingAggregatedMemoryEfficientTransform.h:24-45)."""

    def __init__(self, session: "DistributedSession", table: Table,
                 columns, chunk_rows: int):
        from ..storage.table import ChunkSource
        self.columns = list(columns)
        self.chunk_rows = chunk_rows
        self.n_shards = session.n_shards
        # chunk-invariant physical layout + global dictionaries
        self.layout = ChunkSource(table, self.columns, chunk_rows)
        st = {"part_ids": [], "chunks": [
            {nm: [] for nm in table.schema}
            for _ in range(self.n_shards)], "rr": 0}
        session._shard_parts_into(st, table.parts, table)
        self.shard_cols: List[Dict[str, np.ndarray]] = []
        self.counts: List[int] = []
        for s_i in range(self.n_shards):
            cols = {}
            for nm in self.columns:
                t = table.schema[nm]
                pieces = st["chunks"][s_i][nm]
                if pieces:
                    cols[nm] = np.concatenate(
                        [np.asarray(p, object if t.is_dictionary else None)
                         for p in pieces]) if len(pieces) > 1 \
                        else np.asarray(pieces[0])
                else:
                    cols[nm] = np.zeros(
                        0, object if t.is_dictionary else t.np_dtype)
            self.shard_cols.append(cols)
            self.counts.append(
                len(cols[self.columns[0]]) if self.columns else 0)
        self.total_rows = sum(self.counts)
        self.num_chunks = max(1, -(-max(self.counts + [0]) // chunk_rows))

    def chunk(self, i: int):
        """-> ({name: (data(n*cap,), validity or None)}, num_rows(n,))."""
        cap = self.chunk_rows
        n = self.n_shards
        nrows = np.zeros(n, np.int64)
        per_shard = []
        for s_i in range(n):
            lo = i * cap
            hi = min(lo + cap, self.counts[s_i])
            nrows[s_i] = max(hi - lo, 0)
            per_shard.append((lo, hi))
        out = {}
        for nm in self.columns:
            datas, valids = [], []
            any_v = False
            for s_i in range(n):
                lo, hi = per_shard[s_i]
                raw = self.shard_cols[s_i][nm][lo:max(hi, lo)]
                d, v = self.layout.encode_column(nm, raw, cap)
                datas.append(d)
                valids.append(v)
                any_v = any_v or v is not None
            data = np.concatenate(datas)
            validity = None
            if any_v:
                validity = np.concatenate(
                    [v if v is not None else np.zeros(cap, np.uint8)
                     for v in valids])
            out[nm] = (data, validity)
        return out, nrows


class DistributedStreamProgram:
    """Out-of-core ∘ distributed: each shard streams its rows chunk by
    chunk through the per-chunk partial-aggregation program (local, no
    collectives), carries mergeable states per shard, and the two-stage
    exchange (all_to_all by key hash) runs ONCE over the carried states in
    the finalizer — the reference's memory-efficient distributed merge
    (src/Processors/Transforms/MergingAggregatedMemoryEfficientTransform.h)."""

    def __init__(self, session: "DistributedSession", split, settings,
                 table: Table, cap_c: int):
        from ..exec.streaming import (_chunk_rows_for, _merge_carry,
                                      _rebuild_blocks, _stage1_on_chunk,
                                      _widen_carry, _STREAM_KEY)
        from ..exec.executor import _finalize
        from . import exchange as ex
        self.split = split
        self.settings = settings
        self.cap_c = cap_c
        self.mesh = session.mesh
        axis = self.axis = session.axis
        n = self.n_shards = session.n_shards
        catalog = session.catalog
        self.small_lower = {k: catalog.get_table(*k).read_block()
                            for k in split.lower_scan_keys}
        self.small_upper = {k: catalog.get_table(*k).read_block()
                            for k in split.upper_scan_keys}
        columns = list(split.scan.column_names)
        chunk_rows = pad_to(max(
            _chunk_rows_for(table, columns, settings) // n, 1024))
        self.stream = ShardedChunkStream(session, table, columns, chunk_rows)
        struct = self.struct = {}
        split_ = split
        src = self.stream.layout

        def init_local(chunk_args, small_args):
            keys_u, gvalid, flat, lchecks, groups = _stage1_on_chunk(
                split_, settings, src, table, self.small_lower,
                chunk_args, small_args, struct)
            keys, valid, states = _widen_carry(keys_u, gvalid, flat,
                                               struct["cap_g"], cap_c)
            return {"keys": keys, "valid": valid, "states": states,
                    "chunk_groups": jnp.reshape(groups, (1,)),
                    "lower_checks": [jnp.reshape(c, (1,))
                                     for c in lchecks]}

        def step_local(carry, chunk_args, small_args):
            keys_u, gvalid, flat, lchecks, groups = _stage1_on_chunk(
                split_, settings, src, table, self.small_lower,
                chunk_args, small_args, struct)
            merged = _merge_carry(carry, keys_u, gvalid, flat,
                                  struct["items"], struct["arity"], cap_c)
            merged.pop("num_groups")
            merged["chunk_groups"] = jnp.maximum(
                carry["chunk_groups"], jnp.reshape(groups, (1,)))
            merged["lower_checks"] = [
                jnp.maximum(a, jnp.reshape(b, (1,)))
                for a, b in zip(carry["lower_checks"], lchecks)]
            return merged

        def fin_local(carry, upper_args):
            from ..ops import agg_ops
            from ..exec.executor import Check
            agg = split_.agg
            ctx = ExecContext(_rebuild_blocks(self.small_upper, upper_args),
                              settings, axis_name=axis, n_shards=n)
            if struct["global_agg"]:
                keys_rx, valid_rx = ex.all_gather_rows(
                    carry["keys"], carry["valid"], axis)
                states_rx, _ = ex.all_gather_rows(
                    carry["states"], carry["valid"], axis)
                sharded_out = False
            else:
                keys_rx, states_rx, valid_rx, overflow = ex.exchange_by_key(
                    carry["keys"], carry["states"], carry["valid"],
                    axis, n, cap_c)
                ctx.checks.append(Check(
                    overflow, cap_c,
                    "streamed aggregation state exchange overflowed "
                    "per-shard capacity; raise max_groups",
                    setting="max_groups"))
                sharded_out = True
            g2 = agg_ops.group_by_sort(keys_rx, valid_rx, cap_c)
            if not struct["global_agg"]:
                ctx.checks.append(Check(
                    g2.num_groups, cap_c,
                    "GROUP BY cardinality exceeded max_groups; raise the "
                    "max_groups setting", setting="max_groups"))
            merged_counts = g2.reduce("sum", states_rx[0], valid_rx)
            fake_keys = []
            for (f, _), (has_v, dic) in zip(agg.keys, struct["key_meta"]):
                fake_keys.append(ColVal(
                    f.dtype, jnp.zeros((1,), jnp.int32),
                    jnp.ones((1,), jnp.uint8) if has_v else None, dic))
            states_per_agg = []
            i = 1
            for item, dic, cnt in zip(struct["items"], struct["agg_dicts"],
                                      struct["arity"][1:]):
                ss = states_rx[i:i + cnt]
                i += cnt
                mstates = item.fn.merge(ss, g2, valid_rx)
                fake_args = [ColVal(item.field.dtype,
                                    jnp.zeros((1,), jnp.int32), None, dic)] \
                    if item.args else []
                states_per_agg.append((item, fake_args, mstates))
            merged_eb = _finalize(
                agg, fake_keys, g2.unique_keys, g2.num_groups,
                merged_counts, states_per_agg, cap_c,
                struct["global_agg"], sharded_out, ctx,
                group_valid=None if struct["global_agg"]
                else g2.group_valid())
            ctx.injected[_STREAM_KEY] = merged_eb
            out = execute_plan(split_.upper, ctx)
            out = _gather_block(out, ctx)
            data_leaves, validity_leaves, dicts, length_leaves = \
                {}, {}, {}, {}
            for f in split_.upper.schema:
                cv = out.cols[f.id].broadcast(out.capacity)
                data_leaves[f.id] = cv.data
                if cv.validity is not None:
                    validity_leaves[f.id] = cv.validity
                if cv.lengths is not None:
                    length_leaves[f.id] = cv.lengths
                dicts[f.id] = cv.dictionary
            struct["out_dicts"] = dicts
            struct["capacity"] = out.capacity
            struct["fin_checks"] = [(c.limit, c.message, c.setting)
                                    for c in ctx.checks]
            checks = [jax.lax.pmax(jnp.asarray(c.value), axis)
                      for c in ctx.checks]
            carry_checks = [jax.lax.pmax(carry["chunk_groups"][0], axis)] \
                + [jax.lax.pmax(c[0], axis) for c in carry["lower_checks"]]
            return {"valid": out.valid, "data": data_leaves,
                    "validity": validity_leaves, "lengths": length_leaves,
                    "checks": checks, "carry_checks": carry_checks}

        P_ = P(axis)
        self.init_fn = jax.jit(shard_map(
            init_local, self.mesh, in_specs=(P_, P()), out_specs=P_))
        self.step_fn = jax.jit(shard_map(
            step_local, self.mesh, in_specs=(P_, P_, P()), out_specs=P_),
            donate_argnums=(0,))
        self.fin_fn = jax.jit(shard_map(
            fin_local, self.mesh, in_specs=(P_, P()), out_specs=P()))

    def run(self, session):
        from ..exec.executor import Check
        spec = NamedSharding(self.mesh, P(self.axis))

        def to_dev(data, nrows):
            cols = {}
            for nm, (d, v) in data.items():
                e = {"data": jax.device_put(d, spec)}
                if v is not None:
                    e["validity"] = jax.device_put(v, spec)
                cols[nm] = e
            return {"cols": cols,
                    "num_rows": jax.device_put(nrows, spec)}

        lower_args = Session._block_args(self.small_lower)
        upper_args = Session._block_args(self.small_upper)
        carry = None
        for i in range(self.stream.num_chunks):
            args = to_dev(*self.stream.chunk(i))
            carry = self.init_fn(args, lower_args) if carry is None \
                else self.step_fn(carry, args, lower_args)
        leaves = self.fin_fn(carry, upper_args)

        struct = self.struct
        ctx = ExecContext({}, self.settings)
        cvals = leaves["carry_checks"]
        ctx.checks.append(Check(
            cvals[0], struct["cap_g"],
            "per-chunk GROUP BY cardinality exceeded max_groups; raise "
            "the max_groups setting", setting="max_groups"))
        for val, (limit, msg, setting) in zip(cvals[1:],
                                              struct["lower_checks"]):
            ctx.checks.append(Check(val, limit, msg, setting))
        for val, (limit, msg, setting) in zip(leaves["checks"],
                                              struct["fin_checks"]):
            ctx.checks.append(Check(val, limit, msg, setting))
        cols = {}
        for f in self.split.upper.schema:
            cols[f.id] = ColVal(f.dtype, leaves["data"][f.id],
                                leaves["validity"].get(f.id),
                                struct["out_dicts"][f.id],
                                lengths=leaves["lengths"].get(f.id))
        out = ExecBlock(cols, leaves["valid"], struct["capacity"])
        cols_np = materialize(out, self.split.upper.schema, ctx)
        ctx.profile["rows_scanned"] = self.stream.total_rows
        ctx.profile["StreamedDistributedQueries"] = 1
        return cols_np, ctx


class DistributedSession(Session):
    """Session whose Distributed-engine tables are sharded over a mesh."""

    _streaming_enabled = True      # out-of-core composes with sharding

    def __init__(self, mesh: Optional[Mesh] = None,
                 settings: Optional[Settings] = None, **kw):
        super().__init__(settings=settings, **kw)
        self.mesh = mesh or make_mesh()
        self.axis = self.mesh.axis_names[0]
        self.n_shards = self.mesh.shape[self.axis]
        # (db, table) -> (table, version, device layout): one live layout
        # per distributed table, so a join does not re-lay out its sides
        self._sharded_cache: Dict[Tuple[str, str], Tuple[Table, int, Block]] = {}

    # -- which tables are distributed ---------------------------------------
    def _is_distributed(self, db: str, name: str) -> bool:
        try:
            t = self.catalog.get_table(db, name)
        except Exception:
            return False
        return t.engine.lower() == "distributed" \
            or getattr(t, "distributed", False)

    def _sharded_block(self, db: str, name: str) -> Block:
        t = self.catalog.get_table(db, name)
        hit = self._sharded_cache.get((db, name))
        blk = hit[2] if hit and hit[0] is t and hit[1] == t.version else None
        if blk is None:
            cols_np, valid_np, per_cap = self._layout_incremental(db, name, t)
            spec = NamedSharding(self.mesh, P(self.axis))
            cols: Dict[str, Column] = {}
            from ..core.column import column_from_numpy
            cap = self.n_shards * per_cap
            for cname, vals in cols_np.items():
                col = column_from_numpy(vals, t.schema[cname], capacity=cap)
                col.data = jax.device_put(col.data, spec)
                if col.validity is not None:
                    col.validity = jax.device_put(col.validity, spec)
                cols[cname] = col
            vcol = Column(dt.UInt8, jax.device_put(jnp.asarray(valid_np), spec))
            cols["__row_valid"] = vcol
            blk = Block(cols, int(valid_np.sum()))
            self._sharded_cache[(db, name)] = (t, t.version, blk)
        return blk

    # -- incremental sharding (DistributedSink analog) -----------------------
    # Appends shard only the NEW parts' rows (hash + bucket once per row
    # ever) instead of re-laying-out the whole table per insert
    # (reference: src/Storages/Distributed/DistributedSink.cpp routes each
    # insert block to per-shard queues).

    def _layout_incremental(self, db: str, name: str, t: Table):
        states = getattr(self, "_layout_states", None)
        if states is None:
            states = self._layout_states = {}
        st = states.get((db, name))
        part_ids = [id(p) for p in t.parts]
        if st is not None and len(part_ids) >= len(st["part_ids"]) \
                and part_ids[:len(st["part_ids"])] == st["part_ids"]:
            new_parts = t.parts[len(st["part_ids"]):]
        else:
            st = {"part_ids": [], "chunks": [
                {n: [] for n in t.schema} for _ in range(self.n_shards)],
                "rr": 0}
            new_parts = t.parts
        if new_parts:
            self._shard_parts_into(st, new_parts, t)
        st["part_ids"] = part_ids
        states[(db, name)] = st
        return self._assemble_layout(st, t)

    def _shard_parts_into(self, st, parts, t: Table) -> None:
        shard_key = next((c for c in t.order_by if c in t.schema), None)
        for p in parts:
            n = p.num_rows
            if not n:
                continue
            if shard_key is not None:
                kv = np.asarray(p.columns[shard_key])
                if kv.dtype == object:
                    assign = np.asarray(
                        [hash(str(x)) for x in kv]) % self.n_shards
                else:
                    assign = _splitmix64_np(
                        kv.astype(np.uint64)) % self.n_shards
                assign = assign.astype(np.int64)
            else:
                assign = (np.arange(n, dtype=np.int64)
                          + st["rr"]) % self.n_shards
                st["rr"] += n
            for s in range(self.n_shards):
                sel = np.flatnonzero(assign == s)     # stable, row order
                if not len(sel):
                    continue
                for cname in t.schema:
                    st["chunks"][s][cname].append(
                        np.asarray(p.columns[cname])[sel])

    def _assemble_layout(self, st, t: Table):
        counts = [sum(len(ch) for ch in st["chunks"][s][next(iter(t.schema))])
                  if t.schema else 0 for s in range(self.n_shards)]
        per_cap = pad_to(max(counts) if any(counts) else 1)
        total_cap = self.n_shards * per_cap
        valid = np.zeros(total_cap, np.uint8)
        for s, c in enumerate(counts):
            valid[s * per_cap:s * per_cap + c] = 1
        out = {}
        for cname, ctype in t.schema.items():
            if ctype.is_dictionary:
                g = np.empty(total_cap, object)
                g[:] = ""
            else:
                g = np.zeros(total_cap, ctype.np_dtype)
            for s in range(self.n_shards):
                chunks = st["chunks"][s][cname]
                if chunks:
                    merged = np.concatenate(
                        [np.asarray(ch, object if ctype.is_dictionary
                                    else None) for ch in chunks]) \
                        if len(chunks) > 1 else np.asarray(chunks[0])
                    g[s * per_cap:s * per_cap + len(merged)] = merged
            out[cname] = g
        return out, valid, per_cap

    # -- execution override --------------------------------------------------
    def _collect_table_blocks(self, plan, out=None):
        from ..plan import logical as L
        if out is None:
            out = {}
        if isinstance(plan, L.ScanNode):
            key = (plan.database, plan.table)
            if key not in out:
                if self._is_distributed(*key):
                    out[key] = self._sharded_block(*key)
                else:
                    out[key] = self.catalog.get_table(*key).read_block()
        for c in plan.children():
            self._collect_table_blocks(c, out)
        return out

    def _execute(self, plan, settings: Settings):
        blocks = self._collect_table_blocks(plan)
        sharded_keys = {k for k in blocks if self._is_distributed(*k)}
        if not sharded_keys:
            return super()._execute(plan, settings)
        return self._execute_sharded(plan, blocks, sharded_keys, settings)

    def _try_streaming(self, stmt, settings: Settings, sql: str):
        """Mesh-aware streaming: a Distributed table over the device budget
        streams per-shard chunks through the sharded partial-aggregation
        program with ONE exchange over the carried states; non-distributed
        big tables fall back to the local streaming engine (correct, just
        not mesh-parallel)."""
        from ..exec import streaming as strm
        thr = strm._stream_threshold(settings)
        catalog = self.catalog
        over_any = False
        for db in catalog.databases.values():
            for t in db.tables.values():
                if t.num_rows and t.physical_bytes() > thr:
                    over_any = True
                    break
            if over_any:
                break
        if not over_any:
            return None

        import json
        skey = json.dumps(settings.as_dict(), sort_keys=True, default=str) \
            + "@" + catalog.current_database
        cache = getattr(self, "_dist_stream_cache", None)
        if cache is None:
            cache = self._dist_stream_cache = {}
        hit = cache.get((sql, skey)) if sql else None
        if hit is not None:
            prog, sig0 = hit
            sig = tuple(sorted(
                (db, tbl, catalog.get_table(db, tbl).version)
                for (db, tbl) in ([prog.split.big_key]
                                  + prog.split.lower_scan_keys
                                  + prog.split.upper_scan_keys)))
            if sig == sig0:
                cols, ctx = prog.run(self)
                return prog.split.upper, cols, ctx

        plan = self._plan(stmt, settings)
        scans = []
        strm._collect_scans(plan, scans)
        over: Dict[Tuple[str, str], int] = {}
        for s in scans:
            key = (s.database, s.table)
            try:
                t = catalog.get_table(*key)
            except Exception:
                continue
            b = t.physical_bytes(set(s.column_names)) if t.num_rows else 0
            if b > thr:
                over[key] = max(over.get(key, 0), b)
        dist_over = [k for k in over if self._is_distributed(*k)]
        if len(dist_over) == 1 and len(over) == 1:
            big = dist_over[0]
            split = strm.find_split(plan, big)
            # small lower/upper tables must not themselves be distributed
            # (they are read whole + replicated into the sharded program)
            if split is not None and not any(
                    self._is_distributed(*k)
                    for k in split.lower_scan_keys + split.upper_scan_keys):
                table = catalog.get_table(*big)
                from ..core.column import pad_to as _pad
                cap_c = _pad(min(table.num_rows, settings.max_groups))
                prog = DistributedStreamProgram(self, split, settings,
                                                table, cap_c)
                cols, ctx = prog.run(self)
                if sql:
                    sig = tuple(sorted(
                        (db, tbl, catalog.get_table(db, tbl).version)
                        for (db, tbl) in ([big] + split.lower_scan_keys
                                          + split.upper_scan_keys)))
                    if len(cache) > 32:
                        cache.clear()
                    cache[(sql, skey)] = (prog, sig)
                return split.upper, cols, ctx
        if dist_over:
            # distributed big table without a distributed streaming plan:
            # fall back to the local streaming engine (reads the same parts)
            return strm.try_streaming(self, stmt, settings, sql)
        return super()._try_streaming(stmt, settings, sql)

    def _execute_compiled(self, stmt, settings: Settings, sql: str):
        # Distributed plans always go through the shard_map runner (itself
        # jitted); reuse the uncompiled dispatch to decide.
        plan = self._plan(stmt, settings)
        cols, ctx = self._execute(plan, settings)
        return plan, cols, ctx

    # -- partition-parallel aggregation (shuffle elision) ---------------------
    def _shard_key_column(self, db: str, name: str) -> Optional[str]:
        """The column whose hash assigns rows to shards (see
        _shard_parts_into); None for round-robin layouts."""
        try:
            t = self.catalog.get_table(db, name)
        except Exception:
            return None
        return next((c for c in t.order_by if c in t.schema), None)

    def _colocated_fids(self, plan) -> frozenset:
        """Field ids provably hash-partition-aligned with the shard layout:
        rows with equal values of these fields live on one shard, so a
        GROUP BY containing one of them needs no exchange (reference:
        src/Processors/QueryPlan/Optimizations/useDataParallelAggregation.cpp,
        optimize_distributed_group_by_sharding_key)."""
        from ..plan import logical as L
        from ..exprs.expr import BoundColumn

        def walk(n) -> frozenset:
            if isinstance(n, L.ScanNode):
                if not self._is_distributed(n.database, n.table):
                    return frozenset()
                key_col = self._shard_key_column(n.database, n.table)
                if key_col is None:
                    return frozenset()
                return frozenset(
                    f.id for f, nm in zip(n.schema, n.column_names)
                    if nm == key_col)
            if isinstance(n, L.FilterNode):
                return walk(n.child)         # filters keep rows in place
            if isinstance(n, L.ProjectNode):
                s = walk(n.child)
                return frozenset(
                    f.id for f, e in zip(n.schema, n.exprs)
                    if isinstance(e, BoundColumn) and e.name in s)
            return frozenset()               # joins/limits/etc. may move rows

        # alignment is a property of each aggregate's own subtree; collect
        # per-AggregateNode so nested aggregations resolve independently
        out = {}

        def visit(n):
            if isinstance(n, L.AggregateNode):
                out[id(n)] = walk(n.child)
            for c in n.children():
                visit(c)

        visit(plan)
        return out

    def _execute_sharded(self, plan, blocks, sharded_keys, settings):
        axis, n = self.axis, self.n_shards
        meta = dict(blocks)
        struct: Dict[str, Any] = {}
        colocated = self._colocated_fids(plan)

        arg_specs = {}
        args = {}
        for k, blk in meta.items():
            akey = f"{k[0]}.{k[1]}"
            spec = P(axis) if k in sharded_keys else P()
            cols, specs = {}, {}
            for cname, col in blk.columns.items():
                e = {"data": col.data}
                es = {"data": spec}
                if col.validity is not None:
                    e["validity"] = col.validity
                    es["validity"] = spec
                if col.lengths is not None:
                    e["lengths"] = col.lengths
                    es["lengths"] = spec
                cols[cname] = e
                specs[cname] = es
            args[akey] = cols
            arg_specs[akey] = specs

        def fn(a):
            blocks2 = {}
            for k, blk in meta.items():
                akey = f"{k[0]}.{k[1]}"
                cols = {}
                for cname, col in blk.columns.items():
                    e = a[akey][cname]
                    cols[cname] = Column(col.dtype, e["data"],
                                         e.get("validity"), col.dictionary,
                                         lengths=e.get("lengths"))
                local_cap = next(iter(cols.values())).capacity
                blocks2[k] = Block(cols, local_cap)
            ctx = ExecContext(blocks2, settings, axis_name=axis, n_shards=n,
                              sharded_tables=sharded_keys)
            ctx.colocated_agg = colocated
            out = execute_plan(plan, ctx)
            out = _gather_block(out, ctx)
            data_leaves, validity_leaves, dicts = {}, {}, {}
            length_leaves = {}
            for f in plan.schema:
                cv = out.cols[f.id].broadcast(out.capacity)
                data_leaves[f.id] = cv.data
                if cv.validity is not None:
                    validity_leaves[f.id] = cv.validity
                if cv.lengths is not None:
                    length_leaves[f.id] = cv.lengths
                dicts[f.id] = cv.dictionary
            struct["dicts"] = dicts
            struct["checks"] = [(c.limit, c.message, c.setting)
                                for c in ctx.checks]
            struct["capacity"] = out.capacity
            struct["profile"] = dict(ctx.profile)
            checks = [jax.lax.pmax(jnp.asarray(c.value), axis)
                      for c in ctx.checks]
            return {"valid": out.valid, "data": data_leaves,
                    "validity": validity_leaves, "lengths": length_leaves,
                    "checks": checks}

        from ..core.failpoints import fail_point
        fail_point("exchange_before_all_to_all")
        mapped = shard_map(fn, mesh=self.mesh, in_specs=(arg_specs,),
                           out_specs=P())
        leaves = jax.jit(mapped)(args)

        ctx2 = ExecContext({}, settings)
        for val, (limit, msg, setting) in zip(leaves["checks"],
                                              struct["checks"]):
            ctx2.checks.append(Check(val, limit, msg, setting))
        for k, v in struct.get("profile", {}).items():
            ctx2.profile[k] = ctx2.profile.get(k, 0) + v
        cols = {}
        for f in plan.schema:
            cols[f.id] = ColVal(f.dtype, leaves["data"][f.id],
                                leaves["validity"].get(f.id),
                                struct["dicts"][f.id],
                                lengths=leaves.get("lengths", {}).get(f.id))
        out = ExecBlock(cols, leaves["valid"], struct["capacity"])
        cols_np = materialize(out, plan.schema, ctx2)
        return cols_np, ctx2

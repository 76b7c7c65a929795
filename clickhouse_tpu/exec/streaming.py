"""Out-of-core streaming execution: tables larger than the device-block
budget stream through the engine chunk by chunk.

The device translation of the reference's external aggregation
(src/Interpreters/Aggregator.h:273 writeToTemporaryFile +
src/Interpreters/TemporaryDataOnDisk.cpp): instead of spilling hash-table
state to disk and merging bucket streams, the plan is split at the
aggregation pipeline breaker —

    upper  (ORDER BY / HAVING / LIMIT / projections over the merged groups)
    -------- AggregateNode ----------------------------- breaker
    lower  (scan -> filter -> project -> probe-side joins)

— and the lower part runs once per fixed-capacity chunk inside ONE compiled
XLA program whose carried state is the per-group mergeable aggregation
states (the reference's WithMergeableState algebra).  Each step re-groups
`carry ++ chunk_partials` with the collision-free sort grouping and merges;
this is the sequential twin of the distributed two-stage exchange
(executor._aggregate_two_stage).  Probe-side joins against small build
tables stream for free: the build block is an ordinary argument of the
per-chunk program, so grace-style partitioning is only needed when BOTH
sides exceed device memory.

Chunks come from host RAM (host memory plays the role disk plays for the
reference) with chunk-invariant physical dtypes and global dictionaries
(storage/table.py ChunkSource) so every chunk reuses the same program.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.block import Block
from ..core.column import Column, pad_to
from ..core.errors import CapacityError, MemoryLimitExceeded
from ..core.settings import Settings
from ..core import dtypes as dt
from ..exprs.expr import ColVal, evaluate
from ..plan import logical as L
from ..ops import agg_ops, sort_ops
from .executor import (Check, ExecBlock, ExecContext, execute_plan,
                       materialize, _agg_key_arrays, _agg_capacity,
                       _finalize, _stage1, _token_for_sort, _gather_colval)

__all__ = ["try_streaming", "estimate_plan_scan_bytes"]

_STREAM_KEY = "__stream__"

# join kinds safe to evaluate independently per probe-side chunk: every
# output row is decided by the probe row alone (right/full joins would need
# cross-chunk matched-build-row tracking)
_STREAMABLE_JOIN_KINDS = ("inner", "left", "semi", "anti", "cross")


@dataclasses.dataclass
class StreamSplit:
    agg: L.AggregateNode
    upper: L.PlanNode             # plan with agg replaced by BlockSourceNode
    scan: L.ScanNode              # the big streamed scan
    big_key: Tuple[str, str]
    lower_scan_keys: List[Tuple[str, str]]   # small tables under the breaker
    upper_scan_keys: List[Tuple[str, str]]   # small tables above the breaker
    # root..scan path + index of the streamable chain head (grace detection)
    path: Optional[list] = None
    lower_i: int = 0


@dataclasses.dataclass
class GenericSplit:
    """Non-aggregate streaming breakers.

    kind = "topk":    ORDER BY ... LIMIT k — per-chunk device top-k rows
                      carried across chunks, k-way merged on device (the
                      reference's external sort for the top-N case,
                      src/Processors/Transforms/MergeSortingTransform.h:31-49
                      with the special-cased top-N row filter,
                      SortingStep.cpp:339).
    kind = "collect": any other shape — surviving lower-plan rows stream to
                      host RAM (the role disk plays for the reference's
                      TemporaryDataOnDisk), and the remaining upper plan runs
                      on the collected block (device when it fits the budget,
                      host sort/limit fallbacks otherwise)."""
    kind: str
    lower: L.PlanNode             # per-chunk streamable subplan
    upper: L.PlanNode             # plan with the breaker subtree replaced
    scan: L.ScanNode
    big_key: Tuple[str, str]
    lower_scan_keys: List[Tuple[str, str]]
    upper_scan_keys: List[Tuple[str, str]]
    sort_items: Optional[list] = None        # topk
    k_total: int = 0                         # topk: limit + offset
    limit_total: Optional[int] = None        # collect: early-stop row count
    path: Optional[list] = None
    lower_i: int = 0


def find_generic_split(plan: L.PlanNode, big_key: Tuple[str, str],
                       settings: Settings) -> Optional[GenericSplit]:
    """Stream any plan shape: top-k breaker when the streamable chain feeds
    ORDER BY with an effective LIMIT, collect-to-host otherwise."""
    r = _stream_path(plan, big_key)
    if r is None:
        return None
    scan, path, j = r
    lower = path[j]
    for f in lower.schema:
        if dt.is_composite(f.dtype) or f.dtype.agg_state is not None:
            return None          # composite leaves can't cross the pytree
    lower_scans: List[L.ScanNode] = []
    _collect_scans(lower, lower_scans)
    lower_keys = [(s.database, s.table) for s in lower_scans if s is not scan]
    parent = path[j - 1] if j > 0 else None

    if isinstance(parent, L.SortNode) and parent.child is lower \
            and not any(i.fill is not None for i in parent.items):
        k = parent.limit_hint
        if k is None and j >= 2 and isinstance(path[j - 2], L.LimitNode) \
                and path[j - 2].limit >= 0:
            k = path[j - 2].limit + path[j - 2].offset
        if k is not None and 0 < k <= settings.stream_topk_max:
            upper = _replace_node(
                plan, parent, L.BlockSourceNode(parent.schema, _STREAM_KEY))
            upper_scans: List[L.ScanNode] = []
            _collect_scans(upper, upper_scans)
            return GenericSplit(
                "topk", lower, upper, scan, big_key, lower_keys,
                [(s.database, s.table) for s in upper_scans],
                sort_items=list(parent.items), k_total=int(k),
                path=path, lower_i=j)

    if lower is plan:
        upper: L.PlanNode = L.BlockSourceNode(lower.schema, _STREAM_KEY)
    else:
        upper = _replace_node(plan, lower,
                              L.BlockSourceNode(lower.schema, _STREAM_KEY))
    limit_total = None
    if isinstance(parent, L.LimitNode) and parent.limit >= 0:
        limit_total = parent.limit + parent.offset
    upper_scans2: List[L.ScanNode] = []
    _collect_scans(upper, upper_scans2)
    return GenericSplit(
        "collect", lower, upper, scan, big_key, lower_keys,
        [(s.database, s.table) for s in upper_scans2],
        limit_total=limit_total, path=path, lower_i=j)


def _collect_scans(node: L.PlanNode, out: List[L.ScanNode]) -> None:
    if isinstance(node, L.ScanNode):
        out.append(node)
    for c in node.children():
        _collect_scans(c, out)


def _path_to(root: L.PlanNode, target: L.PlanNode) -> Optional[List[L.PlanNode]]:
    if root is target:
        return [root]
    for c in root.children():
        p = _path_to(c, target)
        if p is not None:
            return [root] + p
    return None


def _replace_node(root: L.PlanNode, old: L.PlanNode,
                  new: L.PlanNode) -> L.PlanNode:
    """Clone the spine from root to `old`, swapping `old` for `new`."""
    if root is old:
        return new
    for f in dataclasses.fields(root):
        v = getattr(root, f.name)
        if isinstance(v, L.PlanNode):
            if _path_to(v, old) is not None:
                return dataclasses.replace(
                    root, **{f.name: _replace_node(v, old, new)})
        elif isinstance(v, list) and v and isinstance(v[0], L.PlanNode):
            for i, item in enumerate(v):
                if _path_to(item, old) is not None:
                    nv = list(v)
                    nv[i] = _replace_node(item, old, new)
                    return dataclasses.replace(root, **{f.name: nv})
    raise AssertionError("old node not under root")


def _prune_parts(lower_root: L.PlanNode, scan: L.ScanNode, table, session):
    """Part-level minmax pruning for the streamed scan (the IO-skipping
    KeyCondition role): parts whose stats refute every row of a filter are
    never read off the host.  -> tuple of surviving part indices, or None
    (= all parts) when there is nothing to prune on."""
    from ..plan import ranges as R
    # filters whose ONLY source is the streamed scan
    preds = []

    def walk(n):
        if isinstance(n, L.FilterNode):
            ss: List[L.ScanNode] = []
            _collect_scans(n, ss)
            if len(ss) == 1 and ss[0] is scan:
                preds.append(n.predicate)
        for c in n.children():
            walk(c)

    walk(lower_root)
    if not preds:
        return None, None
    col_of = {f.id: nm for f, nm in zip(scan.schema, scan.column_names)}
    keep = []
    pruned = 0
    for i, p in enumerate(table.parts):
        fb = {}
        for fid, nm in col_of.items():
            mm = p.minmax.get(nm)
            t = table.schema.get(nm)
            if mm is not None and t is not None                     and t.np_dtype.kind in ("i", "u"):
                fb[fid] = (int(mm[0]), int(mm[1]))
        if all(R.predicate_may_hold(pr, fb) for pr in preds):
            keep.append(i)
        else:
            pruned += 1
    if pruned:
        session.profile_events["PrunedParts"] = \
            session.profile_events.get("PrunedParts", 0) + pruned
        part_idx = tuple(keep)
    else:
        part_idx = None
        keep = list(range(len(table.parts)))
    spans = _prune_granules(preds, col_of, table, keep, session)
    return part_idx, spans


class _NotHostEval(Exception):
    pass


# operators whose numpy semantics provably match the device engine's
# (comparisons, boolean algebra, wrapping int arithmetic); anything else —
# modulo/division sign rules, float edge cases, string ops — stays on
# device, where the filter re-runs over the survivors anyway
_HOST_CMP = {"equals": np.equal, "notequals": np.not_equal,
             "greater": np.greater, "less": np.less,
             "greaterorequals": np.greater_equal,
             "lessorequals": np.less_equal}
_HOST_ARITH = {"plus": np.add, "minus": np.subtract,
               "multiply": np.multiply}


def _host_eval(e, cols):
    """Evaluate a bound predicate over raw host part columns; raises
    _NotHostEval for anything outside the proven-identical subset."""
    from ..exprs.expr import (BoundCall, BoundColumn, BoundInList,
                              BoundLiteral)
    if isinstance(e, BoundColumn):
        a = cols.get(e.name)
        if a is None or a.dtype == object or a.dtype.kind not in "iufb":
            raise _NotHostEval
        return a
    if isinstance(e, BoundLiteral):
        if isinstance(e.value, bool) or isinstance(e.value,
                                                   (int, float, np.number)):
            return e.value
        raise _NotHostEval
    if isinstance(e, BoundInList):
        base = _host_eval(e.arg, cols)
        vals = np.asarray(e.values)
        if vals.dtype == object or vals.dtype.kind not in "iufb":
            raise _NotHostEval
        m = np.isin(base, vals)
        return ~m if e.negated else m
    if isinstance(e, BoundCall):
        n = e.name.lower()
        if n in _HOST_CMP and len(e.args) == 2:
            return _HOST_CMP[n](_host_eval(e.args[0], cols),
                                _host_eval(e.args[1], cols))
        if n in _HOST_ARITH and len(e.args) == 2:
            with np.errstate(over="ignore"):
                return _HOST_ARITH[n](_host_eval(e.args[0], cols),
                                      _host_eval(e.args[1], cols))
        if n == "and":
            out = None
            for a in e.args:
                v = _host_eval(a, cols)
                out = v if out is None else (out & v)
            return out
        if n == "or":
            out = None
            for a in e.args:
                v = _host_eval(a, cols)
                out = v if out is None else (out | v)
            return out
        if n == "not" and len(e.args) == 1:
            v = _host_eval(e.args[0], cols)
            return ~np.asarray(v, bool)
    raise _NotHostEval


def _pred_conjuncts(pred):
    from ..exprs.expr import BoundCall
    if isinstance(pred, BoundCall) and pred.name == "and":
        for a in pred.args:
            yield from _pred_conjuncts(a)
    else:
        yield pred


def host_prewhere_sel(lower_root: L.PlanNode, scan: L.ScanNode, table,
                      part_idx, spans, session, settings):
    """Host-side PREWHERE for streamed scans (the two-pass read of
    src/Storages/MergeTree/MergeTreeRangeReader.h recast for the
    host->device wire): predicate columns are read on the HOST — where
    bandwidth is ~free relative to the transfer link — and only surviving
    rows of the scan columns are transferred.  The device filter re-runs
    over the survivors, so host evaluation only ever has to agree with the
    engine on the conjuncts it claims (see _HOST_CMP/_HOST_ARITH); any
    non-provable conjunct simply stays device-side.

    -> (row_sel per surviving part, sel_key) or (None, None) when nothing
    is host-evaluable or the predicate is unselective (survivors > 7/8:
    the zero-copy aligned-chunk path wins)."""
    if not settings.optimize_move_to_prewhere:
        return None, None
    preds = []

    def walk(n):
        if isinstance(n, L.FilterNode):
            ss: List[L.ScanNode] = []
            _collect_scans(n, ss)
            if len(ss) == 1 and ss[0] is scan:
                preds.append(n.predicate)
        for c in n.children():
            walk(c)

    walk(lower_root)
    conjs = [c for p in preds for c in _pred_conjuncts(p)]
    if not conjs:
        return None, None
    col_of = {f.id: nm for f, nm in zip(scan.schema, scan.column_names)}
    parts = table.parts if part_idx is None \
        else [table.parts[i] for i in part_idx]
    spans_of: Dict[int, list] = {}
    if spans is not None:
        for pi, lo, hi in spans:
            spans_of.setdefault(pi, []).append((lo, hi))
    sel, total, kept = [], 0, 0
    any_eval = False
    for pi, p in enumerate(parts):
        ranges = spans_of.get(pi, [(0, p.num_rows)]) if spans is not None \
            else [(0, p.num_rows)]
        idxs = []
        for lo, hi in ranges:
            if hi <= lo:
                continue
            total += hi - lo
            cols = {}
            for fid, nm in col_of.items():
                c = p.columns.get(nm)
                cols[fid] = c[lo:hi] if c is not None else None
            mask = None
            for c in conjs:
                try:
                    m = _host_eval(c, cols)
                except _NotHostEval:
                    continue
                any_eval = True
                m = np.asarray(m, bool)
                mask = m if mask is None else (mask & m)
            if mask is None:
                idxs.append(np.arange(lo, hi, dtype=np.int64))
                kept += hi - lo
            else:
                w = np.nonzero(mask)[0] + lo
                idxs.append(w)
                kept += len(w)
        sel.append(np.concatenate(idxs) if idxs
                   else np.zeros(0, np.int64))
    if not any_eval or total == 0 or kept * 8 > total * 7:
        return None, None
    session.profile_events["PrewhereStreamedScans"] = \
        session.profile_events.get("PrewhereStreamedScans", 0) + 1
    session.profile_events["PrewhereRowsDropped"] = \
        session.profile_events.get("PrewhereRowsDropped", 0) \
        + (total - kept)
    # the selection itself is the cache identity: any two predicates that
    # survive to the same row set can safely share the chunk source
    import hashlib
    h = hashlib.sha1()
    for s in sel:
        h.update(s.tobytes())
    sel_key = ("prewhere", h.hexdigest(), part_idx, spans)
    return sel, sel_key


def _equality_constraints(pred, col_of):
    """Flatten a predicate's top-level conjuncts into (column_name, values)
    membership constraints usable by set/bloom granule summaries: conjuncts
    of the form col = lit and col IN (lits)."""
    from ..exprs.expr import BoundCall, BoundColumn, BoundLiteral, BoundInList
    out = []

    def conjuncts(e):
        if isinstance(e, BoundCall) and e.name == "and":
            for a in e.args:
                yield from conjuncts(a)
        else:
            yield e

    for c in conjuncts(pred):
        if isinstance(c, BoundCall) and c.name == "equals" \
                and len(c.args) == 2:
            a, b = c.args
            if isinstance(b, BoundColumn) and isinstance(a, BoundLiteral):
                a, b = b, a
            if isinstance(a, BoundColumn) and isinstance(b, BoundLiteral) \
                    and a.name in col_of:
                out.append((col_of[a.name], frozenset([b.value])))
        elif isinstance(c, BoundInList) and not c.negated \
                and isinstance(c.arg, BoundColumn) and c.arg.name in col_of:
            try:
                vals = frozenset(np.asarray(c.values).tolist())
            except TypeError:
                continue
            out.append((col_of[c.arg.name], vals))
    return out


def _substring_constraints(pred, col_of):
    """Top-level conjuncts -> (column_name, kind, payload) text constraints
    for token/ngram bloom pruning (reference: MergeTreeConditionBloomFilterText
    extracting LIKE/hasToken/equality atoms):
      ("token", tok)                  — tok must appear as a whole token
      ("substr", s, anchl, anchr)     — s must appear as a substring;
                                        anchl/anchr: value-start/end anchored
    """
    from ..exprs.expr import BoundCall, BoundColumn, BoundLiteral
    out = []

    def conjuncts(e):
        if isinstance(e, BoundCall) and e.name == "and":
            for a in e.args:
                yield from conjuncts(a)
        else:
            yield e

    for c in conjuncts(pred):
        if not isinstance(c, BoundCall) or len(c.args) != 2:
            continue
        a, b = c.args
        if c.name == "equals" and isinstance(b, BoundColumn) \
                and isinstance(a, BoundLiteral):
            a, b = b, a
        if not (isinstance(a, BoundColumn) and isinstance(b, BoundLiteral)
                and a.name in col_of and isinstance(b.value, str)):
            continue
        nm = col_of[a.name]
        if c.name == "equals":
            out.append((nm, "substr", (b.value, True, True)))
        elif c.name == "hasToken":
            out.append((nm, "token", b.value))
        elif c.name in ("startsWith",):
            out.append((nm, "substr", (b.value, True, False)))
        elif c.name in ("endsWith",):
            out.append((nm, "substr", (b.value, False, True)))
        elif c.name == "like":
            pat = b.value
            if "\\" in pat or "_" in pat:
                continue                  # escapes/single-char: stay safe
            segs = pat.split("%")
            for k, seg in enumerate(segs):
                if not seg:
                    continue
                anchl = (k == 0)
                anchr = (k == len(segs) - 1)
                out.append((nm, "substr", (seg, anchl, anchr)))
    return out


def _required_tokens(payloads, ngram: Optional[int]):
    """Tokens/ngrams that must ALL be present in a granule for the
    constraints to hold."""
    import re
    req = set()
    for kind, payload in payloads:
        if ngram:
            s = payload if kind == "token" else payload[0]
            for i in range(len(s) - ngram + 1):
                req.add(s[i:i + ngram])
            continue
        if kind == "token":
            req.add(payload)
            continue
        s, anchl, anchr = payload
        for m in re.finditer(r"[0-9A-Za-z_]+", s):
            # a run is a complete token only when bounded by non-token
            # chars inside the substring — or by an anchored value edge
            if (m.start() > 0 or anchl) and (m.end() < len(s) or anchr):
                req.add(m.group(0))
    return req


def _granule_span(gi, g_rows, gran_base, ngr):
    """Granule gi of width g_rows -> [a, b) range in base-granule units."""
    a = gi * g_rows // gran_base
    b = min(-(-((gi + 1) * g_rows) // gran_base), ngr)
    return a, b


def _prune_granules(preds, col_of, table, part_indices, session):
    """Skip-index granule pruning within surviving parts (reference:
    MergeTreeDataSelectExecutor filters granule ranges through
    MergeTreeIndex* conditions, src/Storages/MergeTree/
    MergeTreeDataSelectExecutor.cpp).  -> spans
    ((pos_in_pruned_part_list, lo, hi), ...) or None when nothing pruned."""
    from ..plan import ranges as R
    from ..storage.table import Part, SkipIndex
    idxs = list(getattr(table, "skip_indexes", []) or [])
    # the sort key's leading column gets an implicit minmax skip index —
    # the primary-index KeyCondition analog (parts are sorted on insert)
    order_cols = [c for c in (table.order_by or []) if c in table.schema]
    for c in order_cols[:1]:
        if not any(ix.column == c and ix.kind == "minmax" for ix in idxs):
            idxs.append(SkipIndex(f"_pk_{c}", c, "minmax"))
    idxs = [ix for ix in idxs if ix.column in col_of.values()]
    if not idxs:
        return None
    name_to_fid = {nm: fid for fid, nm in col_of.items()}
    eq_constraints = []
    str_constraints = []
    for pr in preds:
        eq_constraints.extend(_equality_constraints(pr, col_of))
        str_constraints.extend(_substring_constraints(pr, col_of))
    gran_base = max(int(getattr(table, "index_granularity", 8192)), 1)
    spans = []
    pruned_granules = 0
    any_pruned = False
    for pos, pi in enumerate(part_indices):
        p = table.parts[pi]
        n = p.num_rows
        if n == 0:
            continue
        ngr = -(-n // gran_base)
        keep = np.ones(ngr, bool)
        for ix in idxs:
            g_rows = gran_base * max(ix.granularity, 1)
            if ix.kind == "minmax":
                t = table.schema.get(ix.column)
                if t is None or t.np_dtype.kind not in ("i", "u"):
                    continue
                mm = p.granule_minmax(ix.column, g_rows)
                if mm is None:
                    continue
                fid = name_to_fid[ix.column]
                for gi, (lo_v, hi_v) in enumerate(mm):
                    fb = {fid: (int(lo_v), int(hi_v))}
                    if not all(R.predicate_may_hold(pr, fb)
                               for pr in preds):
                        a, b = _granule_span(gi, g_rows, gran_base, ngr)
                        keep[a:b] = False
            elif ix.kind == "set" and eq_constraints:
                max_vals = int(ix.params[0]) if ix.params and ix.params[0] \
                    else Part.SET_INDEX_DEFAULT_MAX
                sets = p.granule_sets(ix.column, g_rows, max_vals)
                if sets is None:
                    continue
                for gi, sset in enumerate(sets):
                    if sset is None:
                        continue
                    for nm, vals in eq_constraints:
                        if nm == ix.column and not (vals & sset):
                            a, b = _granule_span(gi, g_rows, gran_base, ngr)
                            keep[a:b] = False
                            break
            elif ix.kind == "bloom_filter" and eq_constraints:
                consts = [vals for nm, vals in eq_constraints
                          if nm == ix.column]
                if not consts:
                    continue
                blooms = p.granule_blooms(ix.column, g_rows)
                if blooms is None:
                    continue
                for gi, bits in enumerate(blooms):
                    refuted = False
                    for vals in consts:
                        posn = Part._bloom_positions(
                            sorted(vals, key=repr))
                        # a value may be present iff ALL its k bits are set;
                        # the constraint may hold iff ANY value may be there
                        if not bits[posn].all(axis=1).any():
                            refuted = True
                            break
                    if refuted:
                        a, b = _granule_span(gi, g_rows, gran_base, ngr)
                        keep[a:b] = False
            elif ix.kind in ("tokenbf_v1", "full_text", "text", "gin",
                             "inverted", "ngrambf_v1") and str_constraints:
                payloads = [(k, pl) for nm, k, pl in str_constraints
                            if nm == ix.column]
                if not payloads:
                    continue
                ngram = None
                if ix.kind == "ngrambf_v1":
                    ngram = int(ix.params[0]) if ix.params else 3
                req = _required_tokens(payloads, ngram)
                if not req:
                    continue
                blooms = p.granule_token_blooms(ix.column, g_rows, ngram)
                if blooms is None:
                    continue
                bpos = Part._bloom_positions(sorted(req))
                for gi, bits in enumerate(blooms):
                    # EVERY required token must be possibly-present;
                    # one definite miss refutes the whole granule
                    if not bits[bpos].all(axis=1).all():
                        a, b = _granule_span(gi, g_rows, gran_base, ngr)
                        keep[a:b] = False
        if keep.all():
            spans.append((pos, 0, n))
            continue
        any_pruned = True
        pruned_granules += int((~keep).sum())
        gi = 0
        while gi < ngr:                    # merge kept granules into spans
            if not keep[gi]:
                gi += 1
                continue
            gj = gi
            while gj + 1 < ngr and keep[gj + 1]:
                gj += 1
            spans.append((pos, gi * gran_base,
                          min((gj + 1) * gran_base, n)))
            gi = gj + 1
    if not any_pruned:
        return None
    session.profile_events["PrunedGranules"] = \
        session.profile_events.get("PrunedGranules", 0) + pruned_granules
    return tuple(spans)


def _stream_path(plan: L.PlanNode, big_key: Tuple[str, str]):
    """-> (scan, path root..scan, index j of the highest per-chunk
    streamable ancestor of the scan), or None.  Nodes on the streamable
    chain are Filter/Project and probe-side (left) joins — every output row
    of the chain is decided by one scanned row alone."""
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    big_scans = [s for s in scans
                 if (s.database, s.table) == big_key]
    if len(big_scans) != 1:
        return None
    scan = big_scans[0]
    if scan.final:
        return None                      # FINAL folds need the whole table
    path = _path_to(plan, scan)
    if path is None:
        return None
    j = len(path) - 1
    for i in range(len(path) - 2, -1, -1):
        node = path[i]
        if isinstance(node, (L.FilterNode, L.ProjectNode)):
            j = i
            continue
        if isinstance(node, L.JoinNode) and node.left is path[i + 1] \
                and node.kind in _STREAMABLE_JOIN_KINDS:
            # the big table is the probe (left) side; the build side is an
            # ordinary small block argument of the per-chunk program
            j = i
            continue
        break
    return scan, path, j


def find_split(plan: L.PlanNode, big_key: Tuple[str, str]
               ) -> Optional[StreamSplit]:
    """Locate the aggregation breaker for streaming the scan of big_key."""
    r = _stream_path(plan, big_key)
    if r is None:
        return None
    scan, path, j = r
    if j == 0:
        return None
    agg = path[j - 1]
    if not isinstance(agg, L.AggregateNode) or agg.with_totals:
        return None
    if any(a.fn.holistic for a in agg.aggregates):
        return None                      # needs raw rows per group (v1)
    for f in agg.schema:
        if dt.is_composite(f.dtype):
            return None                  # sub-columns can't cross the carry
    lower_scans: List[L.ScanNode] = []
    _collect_scans(agg.child, lower_scans)
    lower_keys = [(s.database, s.table) for s in lower_scans
                  if s is not scan]
    upper = _replace_node(plan, agg,
                          L.BlockSourceNode(agg.schema, _STREAM_KEY))
    upper_scans: List[L.ScanNode] = []
    _collect_scans(upper, upper_scans)
    upper_keys = [(s.database, s.table) for s in upper_scans]
    split = StreamSplit(agg, upper, scan, big_key, lower_keys, upper_keys)
    split.path = path
    split.lower_i = j
    return split


# -- grace partitioned join (both sides exceed the device budget) -------------
# Reference: src/Interpreters/GraceHashJoin.cpp — hash-partition BOTH sides
# into buckets so each bucket's build side fits, then join bucket by bucket.
# Here host RAM plays the role of the reference's disk buckets, and the
# per-chunk compiled program is reused across buckets: only the build-side
# block argument changes, so XLA compiles once.

@dataclasses.dataclass
class GraceJoin:
    join: L.JoinNode
    build_scan: L.ScanNode
    build_key: Tuple[str, str]
    probe_cols: List[str]         # big-table storage columns hashed
    build_cols: List[str]         # build-table storage columns hashed
    kinds: List[str]              # per key pair: int | float | str
    n_buckets: int = 0


def _colmap(node: L.PlanNode) -> Dict[str, tuple]:
    """field id -> (ScanNode, storage column name) through Filter/Project
    renames and join concatenation (grace key-column resolution)."""
    from ..exprs.expr import BoundColumn
    if isinstance(node, L.ScanNode):
        return {f.id: (node, nm)
                for f, nm in zip(node.schema, node.column_names)}
    if isinstance(node, L.FilterNode):
        return _colmap(node.child)
    if isinstance(node, L.ProjectNode):
        m = _colmap(node.child)
        out = {}
        for f, e in zip(node.schema, node.exprs):
            if isinstance(e, BoundColumn) and e.name in m:
                out[f.id] = m[e.name]
        return out
    if isinstance(node, L.JoinNode):
        m = dict(_colmap(node.left))
        m.update(_colmap(node.right))
        return m
    return {}


_GRACE_JOIN_KINDS = ("inner", "left", "semi", "anti")


def _detect_grace(split, scan: L.ScanNode, catalog, thr: int, settings):
    """Find over-threshold build sides on the streamable chain.
    -> (GraceJoin or None, compatible: bool)."""
    from ..exprs.expr import BoundColumn
    path, j = split.path, split.lower_i
    graces = []
    for i in range(j, len(path) - 1):
        node = path[i]
        if not isinstance(node, L.JoinNode):
            continue
        rscans: List[L.ScanNode] = []
        _collect_scans(node.right, rscans)
        over = []
        for s in rscans:
            try:
                t = catalog.get_table(s.database, s.table)
            except Exception:
                continue
            if t.num_rows and t.physical_bytes(set(s.column_names)) > thr:
                over.append(s)
        if not over:
            continue
        if len(over) != 1 or not isinstance(node.right, L.ScanNode) \
                or node.kind not in _GRACE_JOIN_KINDS \
                or node.asof_left is not None or not node.left_keys:
            return None, False
        bscan = node.right
        if bscan.final:
            return None, False
        lmap = _colmap(node.left)
        bmap = {f.id: nm for f, nm in zip(bscan.schema, bscan.column_names)}
        big_t = catalog.get_table(scan.database, scan.table)
        build_t = catalog.get_table(bscan.database, bscan.table)
        probe_cols, build_cols, kinds = [], [], []
        for le, re_ in zip(node.left_keys, node.right_keys):
            if not (isinstance(le, BoundColumn)
                    and isinstance(re_, BoundColumn)):
                return None, False
            lm = lmap.get(le.name)
            rn = bmap.get(re_.name)
            if lm is None or lm[0] is not scan or rn is None:
                return None, False
            lt = big_t.schema[lm[1]]
            rt = build_t.schema[rn]
            lk = "str" if lt.is_dictionary else lt.np_dtype.kind
            rk = "str" if rt.is_dictionary else rt.np_dtype.kind
            if (lk == "str") != (rk == "str"):
                return None, False
            if lk == "str":
                kind = "str"
            elif "f" in (lk, rk):
                kind = "float"
            else:
                kind = "int"
            probe_cols.append(lm[1])
            build_cols.append(rn)
            kinds.append(kind)
        graces.append(GraceJoin(node, bscan,
                                (bscan.database, bscan.table),
                                probe_cols, build_cols, kinds))
    if len(graces) > 1:
        return None, False
    return (graces[0] if graces else None), True


def _hash_values_u64(v: np.ndarray, kind: str) -> np.ndarray:
    """Stable per-row u64 for host bucket assignment; equal join-key values
    hash equal regardless of storage dtype (ints via int64, floats via f64
    bits, strings via crc/adler pair).  NULLs -> 0 (bucket 0; they never
    match inside any bucket)."""
    import zlib
    n = len(v)
    h = np.zeros(n, np.uint64)
    if kind == "str":
        for i, x in enumerate(v):
            if x is None:
                continue
            b = str(x).encode()
            h[i] = np.uint64(zlib.crc32(b)) \
                | (np.uint64(zlib.adler32(b)) << np.uint64(32))
        return h
    if v.dtype == object:
        mask = np.asarray([x is not None for x in v], bool)
        vals = np.zeros(n, np.float64 if kind == "float" else np.int64)
        if mask.any():
            vals[mask] = np.asarray(
                [x for x in v if x is not None],
                np.float64 if kind == "float" else np.int64)
        h = (vals.view(np.uint64) if kind == "float"
             else vals.astype(np.uint64))
        h[~mask] = 0
        return h
    if kind == "float":
        return v.astype(np.float64).view(np.uint64)
    with np.errstate(over="ignore"):
        return v.astype(np.int64).astype(np.uint64)


def _bucket_of(cols: List[np.ndarray], kinds: List[str], P: int
               ) -> np.ndarray:
    from ..parallel.distributed import _splitmix64_np
    h = np.zeros(len(cols[0]), np.uint64)
    with np.errstate(over="ignore"):
        for v, kind in zip(cols, kinds):
            h = _splitmix64_np(h ^ _splitmix64_np(_hash_values_u64(v, kind)))
    return (h % np.uint64(P)).astype(np.int32)


def _partition_rows(parts, cols: List[str], kinds: List[str], P: int):
    """Per part: row-index arrays per bucket.  -> sel[bucket][part]."""
    sel = [[] for _ in range(P)]
    for p in parts:
        if p.num_rows == 0:
            for b in range(P):
                sel[b].append(np.zeros(0, np.int64))
            continue
        a = _bucket_of([np.asarray(p.columns[c]) for c in cols], kinds, P)
        order = np.argsort(a, kind="stable")
        counts = np.bincount(a, minlength=P)
        off = 0
        for b in range(P):
            c = int(counts[b])
            sel[b].append(order[off:off + c])
            off += c
    return sel


def _grace_build_buckets(table, columns: List[str], sel_per_bucket):
    """-> (meta Block for tracing, per-bucket small-args entries).  All
    buckets share one capacity, dtype layout, and global dictionaries so a
    single compiled program serves every bucket; args stay host numpy until
    their bucket runs (device residency is one bucket at a time)."""
    from ..storage.table import ChunkSource
    P = len(sel_per_bucket)
    bucket_rows = [sum(len(s) for s in sels) for sels in sel_per_bucket]
    cap = pad_to(max(max(bucket_rows), 1))
    meta_block = None
    args = []
    donor = None
    for b in range(P):
        # pack=False: bucket args feed Block columns directly (no traced
        # unpack step runs over them)
        src = ChunkSource(table, columns, cap, row_sel=sel_per_bucket[b],
                          layout_donor=donor, pack=False)
        donor = donor or src
        data, n = src.chunk(0)
        cols_meta: Dict[str, Column] = {}
        cols_args = {}
        for name in columns:
            t = table.schema[name]
            d, v = data[name]
            ctype = dt.make_nullable(t) if (v is not None
                                            and not t.nullable) else t
            e = {"data": d}
            if v is not None:
                e["validity"] = v
            cols_args[name] = e
            if meta_block is None:
                cols_meta[name] = Column(ctype, d, v,
                                         src.dictionaries.get(name))
        if meta_block is None:
            meta_block = Block(cols_meta, n)
        args.append({"cols": cols_args,
                     "num_rows": np.int64(n)})
    return meta_block, args


def _grace_bucket_count(build_bytes: int, thr: int, settings) -> int:
    if settings.grace_join_buckets > 0:
        return int(settings.grace_join_buckets)
    # each build bucket targets <= thr/4 so build block + probe chunk +
    # intermediates stay well under the device budget
    target = max(thr // 4, 1)
    P = 1
    while P * target < build_bytes and P < 256:
        P *= 2
    return max(P, 2)


# -- per-chunk program construction -------------------------------------------

def _chunk_block(chunk_args, src, table) -> Block:
    cols: Dict[str, Column] = {}
    for name in src.columns:
        t = table.schema[name]
        e = chunk_args["cols"][name]
        validity = e.get("validity")
        ctype = dt.make_nullable(t) if (validity is not None
                                        and not t.nullable) else t
        data = e["data"]
        pk = getattr(src, "packed", {}).get(name)
        if pk is not None:
            # bit-packed transport: unpack inside the traced program.
            # Strided u32 byte lanes, never a widened (cap, bpp) matrix —
            # a reshape+astype formulation materializes 8x-the-bytes
            # intermediates at 100M-row chunks.
            w4, off, bpp = pk
            n8 = data.shape[0]
            lanes = [jax.lax.slice(data, (k,), (n8,), (bpp,))
                     .astype(jnp.uint32) for k in range(bpp)]
            mask = jnp.uint32((1 << w4) - 1)
            v0 = jnp.zeros_like(lanes[0])
            v1 = jnp.zeros_like(lanes[0])
            for k in range(bpp):
                if 8 * k < w4:
                    v0 = v0 | (lanes[k] << (8 * k))
                sh = 8 * k - w4
                if 8 * (k + 1) > w4:
                    v1 = v1 | (lanes[k] << sh if sh >= 0
                               else lanes[k] >> (-sh))
            st = src.storage[name]
            offv = jnp.asarray(off, st)
            v0 = (v0 & mask).astype(st) + offv
            v1 = (v1 & mask).astype(st) + offv
            # half packing: v0 is rows [0, cap/2), v1 is [cap/2, cap)
            data = jnp.concatenate([v0, v1])
        cols[name] = Column(ctype, data, validity,
                            src.dictionaries.get(name))
    return Block(cols, chunk_args["num_rows"])


def _rebuild_blocks(meta_blocks, args) -> Dict[Tuple[str, str], Block]:
    out = {}
    for k, blk in meta_blocks.items():
        akey = f"{k[0]}.{k[1]}"
        cols = {}
        for name, col in blk.columns.items():
            e = args[akey]["cols"][name]
            cols[name] = Column(col.dtype, e["data"], e.get("validity"),
                                col.dictionary, lengths=e.get("lengths"))
        out[k] = Block(cols, args[akey]["num_rows"])
    return out


def _carry_cap(split: StreamSplit, table, settings: Settings) -> int:
    """Carried-state capacity for the streamed aggregation: the provable
    group-cardinality bound when interval analysis can compute one (a
    `x % 1024` key carries 1024 groups, not pad(min(rows, max_groups)) =
    millions — the r03 Q5b gap was largely carry merges at 4M capacity),
    else min(rows, max_groups).  Sound either way: the merged-groups
    capacity check still raises CapacityError -> autotune replan."""
    if not split.agg.keys:
        return 1024
    from ..plan import ranges as R
    fb: Dict[str, Tuple[int, int]] = {}

    def walk(n):
        if isinstance(n, L.ScanNode) and getattr(n, "column_stats", None):
            fb.update(n.column_stats)
        for c in n.children():
            walk(c)

    walk(split.agg.child)
    total = 1
    for f, e in split.agg.keys:
        b = R.infer_bounds(e, fb)
        if b is None:
            total = None
            break
        lo, hi = b
        span = int(hi) - int(lo) + 1
        if span <= 0 or span > (1 << 22):
            total = None
            break
        total *= span
        if f.dtype.nullable:
            total *= 2
        if total > settings.max_groups:
            total = None
            break
    if total is not None:
        return pad_to(min(max(total, 1), settings.max_groups))
    return pad_to(min(table.num_rows, settings.max_groups))


def _stage1_on_chunk(split: StreamSplit, settings: Settings, src, table,
                     small_meta, chunk_args, small_args, struct: dict):
    """Trace the lower plan on one chunk -> grouped partial states."""
    agg = split.agg
    blocks = _rebuild_blocks(small_meta, small_args)
    blocks[split.big_key] = _chunk_block(chunk_args, src, table)
    ctx = ExecContext(blocks, settings)
    child = execute_plan(agg.child, ctx)
    key_cvs, key_arrays, dims, global_agg = _agg_key_arrays(agg, child, ctx)
    if not all(a.fn.sum_only for a in agg.aggregates):
        dims = None
    cap_g = _agg_capacity(child, dims, global_agg, settings)
    grouping, counts, states_per_agg = _stage1(
        agg, child, key_arrays, dims, cap_g, ctx, global_agg)

    flat: List[jax.Array] = [counts]
    arity: List[int] = [1]
    for item, _, states in states_per_agg:
        flat.extend(states)
        arity.append(len(states))

    # trace-time structure shared by init/step/fin (identical every chunk:
    # dictionaries are global, bounds are table-wide)
    struct["arity"] = arity
    struct["items"] = [item for item, _, _ in states_per_agg]
    struct["key_meta"] = [(cv.broadcast(child.capacity).validity is not None,
                           cv.dictionary) for cv in key_cvs]
    struct["agg_dicts"] = [
        (arg_cvs[0].dictionary if item.args else None)
        for item, arg_cvs, _ in states_per_agg]
    struct["global_agg"] = global_agg
    struct["cap_g"] = cap_g
    struct["lower_checks"] = [(c.limit, c.message, c.setting)
                              for c in ctx.checks]
    lower_check_vals = [jnp.asarray(c.value, jnp.int64) for c in ctx.checks]
    chunk_groups = jnp.asarray(grouping.num_groups, jnp.int64)
    return (grouping.unique_keys, grouping.group_valid(), flat,
            lower_check_vals, chunk_groups)


def _merge_carry(carry, keys_u, gvalid, flat, items, arity, cap_c):
    """carry ++ chunk partial states -> re-grouped, merged carry."""
    keys_cat = [jnp.concatenate([ck, uk.astype(ck.dtype)])
                for ck, uk in zip(carry["keys"], keys_u)]
    valid_cat = jnp.concatenate([carry["valid"], gvalid])
    states_cat = [jnp.concatenate([cs, s.astype(cs.dtype)])
                  for cs, s in zip(carry["states"], flat)]
    g2 = agg_ops.group_by_sort(keys_cat, valid_cat, cap_c)
    merged = [g2.reduce("sum", states_cat[0], valid_cat)]
    i = 1
    for item, n in zip(items, arity[1:]):
        merged.extend(item.fn.merge(states_cat[i:i + n], g2, valid_cat))
        i += n
    return {"keys": [uk for uk in g2.unique_keys],
            "valid": g2.group_valid(),
            "states": merged,
            "num_groups": jnp.asarray(g2.num_groups, jnp.int64)}


def _widen_carry(keys_u, gvalid, flat, cap_g, cap_c):
    """Pad stage-1 outputs (cap_g) up to the carry capacity (cap_c)."""
    if cap_c == cap_g:
        return list(keys_u), gvalid, list(flat)
    pad = cap_c - cap_g
    keys = [jnp.concatenate([k, jnp.zeros((pad,), k.dtype)])
            for k in keys_u]
    valid = jnp.concatenate([gvalid, jnp.zeros((pad,), jnp.bool_)])
    states = [jnp.concatenate([s, jnp.zeros((pad,), s.dtype)])
              for s in flat]
    return keys, valid, states


def _device_prefetch(it, depth: int = 2, stats: Optional[dict] = None):
    """Run an iterator on a feeder thread with a bounded handoff queue:
    the feeder's device_put of chunk i+1 (and its host slice/encode work)
    overlaps the consumer's compute on chunk i.  depth bounds extra
    device-resident chunks (each ≤ stream_chunk_bytes).  `stats`
    accumulates the consumer's blocking wait ("wait_s" — pipeline
    starvation = transfer-bound) for system.processors_profile_log."""
    import queue as _queue
    import threading as _threading
    import time as _time
    q: "_queue.Queue" = _queue.Queue(maxsize=max(depth, 1))
    done = object()
    err: list = []
    stop = [False]

    def feed():
        try:
            for x in it:
                if stop[0]:
                    return
                q.put(x)
        except BaseException as e:      # noqa: BLE001 — re-raised below
            err.append(e)
        finally:
            q.put(done)

    t = _threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        while True:
            t0 = _time.perf_counter()
            x = q.get()
            if stats is not None:
                stats["wait_s"] = stats.get("wait_s", 0.0) \
                    + (_time.perf_counter() - t0)
            if x is done:
                break
            yield x
        t.join()
        if err:
            raise err[0]
    finally:
        # consumer abandoned the stream (capacity retune, error): unblock
        # the feeder so it can exit instead of parking on a full queue
        stop[0] = True
        while t.is_alive():
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            t.join(timeout=0.05)


def _to_device(data, n):
    cols = {}
    for name, (d, v) in data.items():
        e = {"data": jax.device_put(d)}
        if v is not None:
            e["validity"] = jax.device_put(v)
        cols[name] = e
    return {"cols": cols, "num_rows": jnp.asarray(n, jnp.int64)}


class _StreamProgramBase:
    """Shared scaffolding: small-table blocks, per-source lower args
    (grace buckets swap the build-side entry), chunk iteration with the
    optional work-stealing read pool."""

    def __init__(self, session, settings: Settings, sources, table,
                 lower_scan_keys, upper_scan_keys, big_key,
                 grace: Optional[tuple] = None):
        # sources: [(ChunkSource, bucket_index or None)]
        # grace: (build_key, meta Block, per-bucket args) or None
        self.settings = settings
        self.sources = sources
        self.table = table
        self.big_key = big_key
        self.grace = grace
        self.struct: Dict[str, Any] = {}
        catalog = session.catalog
        gk = grace[0] if grace else None
        self.small_lower = {}
        for k in lower_scan_keys:
            if gk is not None and k == gk:
                self.small_lower[k] = grace[1]
            else:
                self.small_lower[k] = catalog.get_table(*k).read_block()
        self.small_upper = {k: catalog.get_table(*k).read_block()
                            for k in upper_scan_keys}
        self.total_rows = sum(src.total_rows for src, _ in sources)
        # transfer-vs-compute split for system.processors_profile_log
        self.io_stats = {"transfer_s": 0.0, "prep_s": 0.0, "wait_s": 0.0,
                         "chunks": 0}

    def _record_io(self, session, loop_s: float, fin_s: float) -> None:
        """Publish this run's stage timings (ProcessorsProfileLog analog):
        StreamTransfer = host->device device_put (feeder thread, overlapped
        with compute), StreamHostPrep = chunk slice/encode, StreamStepWait =
        consumer starvation (transfer-bound when high), StreamLoop = whole
        chunk loop wall, StreamFinalize = merge/fin + materialize.  The
        StreamedPackedColumns event counts columns that rode the link
        bit-packed."""
        from .profiler import record_processor
        s = self.io_stats
        rows = self.total_rows
        n_packed = len(getattr(self.src, "packed", {}))
        session.profile_events["StreamedPackedColumns"] = \
            session.profile_events.get("StreamedPackedColumns", 0) + n_packed
        record_processor(session, "StreamTransfer", s["transfer_s"],
                         input_rows=rows)
        if s["prep_s"]:
            record_processor(session, "StreamHostPrep", s["prep_s"],
                             input_rows=rows)
        record_processor(session, "StreamStepWait", s["wait_s"],
                         input_rows=rows)
        record_processor(session, "StreamLoop", loop_s, input_rows=rows,
                         output_rows=s["chunks"])
        record_processor(session, "StreamFinalize", fin_s)

    def small_args(self, blocks) -> Dict[str, Any]:
        from .session import Session
        return Session._block_args(blocks)

    def _lower_args_for(self, base_args, bucket: Optional[int]):
        if self.grace is None or bucket is None:
            return base_args
        gk, _, bucket_args = self.grace
        out = dict(base_args)
        out[f"{gk[0]}.{gk[1]}"] = bucket_args[bucket]
        return out

    def _iter_chunks(self, src):
        """Yield device-ready chunk args in index order.

        The host->device transfer of chunk i+1 runs on a feeder thread
        UNDER chunk i's device compute (_device_prefetch): without the
        overlap, transfer and per-chunk compute serialize and the streamed
        throughput is their SUM, not their MAX (the r03 Q5b gap)."""
        import time as _time
        from .session import active_session
        n_readers = max(int(self.settings.stream_readers), 1)
        stats = self.io_stats
        sess = active_session()

        def _limits():
            if sess is not None:
                sess.check_limits()     # KILL QUERY / max_execution_time

        def instrumented():
            if n_readers > 1 and src.num_chunks > 1:
                # work-stealing read pool: host chunk prep overlaps device
                # compute (MergeTreeReadPool analog, storage/read_pool.py);
                # index order preserved so float merges stay deterministic.
                # Buffered chunks capped by the host-RAM budget.
                from ..storage.read_pool import ParallelChunkReader
                chunk_b = max(int(self.settings.stream_chunk_bytes), 1)
                budget = max(int(self.settings.stream_buffer_bytes)
                             // chunk_b, 1)
                reader = ParallelChunkReader(src, n_readers,
                                             max_buffered=min(n_readers + 2,
                                                              budget))
                for _i, data, n in reader.iter_ordered():
                    _limits()
                    t1 = _time.perf_counter()
                    args = _to_device(data, n)
                    jax.block_until_ready(args)
                    stats["transfer_s"] += _time.perf_counter() - t1
                    stats["chunks"] += 1
                    yield args
            else:
                for i in range(src.num_chunks):
                    _limits()
                    t0 = _time.perf_counter()
                    data, n = src.chunk(i)
                    t1 = _time.perf_counter()
                    args = _to_device(data, n)
                    jax.block_until_ready(args)
                    t2 = _time.perf_counter()
                    stats["prep_s"] += t1 - t0
                    stats["transfer_s"] += t2 - t1
                    stats["chunks"] += 1
                    yield args

        if src.num_chunks > 1:
            yield from _device_prefetch(instrumented(), depth=2,
                                        stats=stats)
        else:
            yield from instrumented()


class StreamProgram(_StreamProgramBase):
    """Compiled init/step/fin triple for the aggregation breaker."""

    def __init__(self, session, split: StreamSplit, settings: Settings,
                 sources, table, cap_c: int,
                 grace: Optional[tuple] = None):
        super().__init__(session, settings, sources, table,
                         split.lower_scan_keys, split.upper_scan_keys,
                         split.big_key, grace)
        self.split = split
        self.src = sources[0][0]
        src = self.src
        self.cap_c = cap_c
        struct = self.struct
        split_ = split

        def init_fn(chunk_args, small_args):
            keys_u, gvalid, flat, lchecks, groups = _stage1_on_chunk(
                split_, settings, src, table, self.small_lower,
                chunk_args, small_args, struct)
            # the carry can never be narrower than one chunk's group
            # capacity (the merge concatenates into it); the bounds-derived
            # cap_c and the chunk-level cap_g may disagree by padding or a
            # signedness margin — resolve at first trace, before step/fin
            # trace (trace order: init -> step -> fin)
            self.cap_c = max(self.cap_c, struct["cap_g"])
            keys, valid, states = _widen_carry(keys_u, gvalid, flat,
                                               struct["cap_g"], self.cap_c)
            return {"keys": keys, "valid": valid, "states": states,
                    "num_groups": jnp.asarray(groups, jnp.int64),
                    "chunk_groups": groups,
                    "lower_checks": lchecks}

        def step_fn(carry, chunk_args, small_args):
            keys_u, gvalid, flat, lchecks, groups = _stage1_on_chunk(
                split_, settings, src, table, self.small_lower,
                chunk_args, small_args, struct)
            merged = _merge_carry(carry, keys_u, gvalid, flat,
                                  struct["items"], struct["arity"],
                                  self.cap_c)
            merged["chunk_groups"] = jnp.maximum(carry["chunk_groups"],
                                                 groups)
            merged["lower_checks"] = [jnp.maximum(a, b) for a, b in
                                      zip(carry["lower_checks"], lchecks)]
            return merged

        def fin_fn(carry, small_args):
            agg = split_.agg
            ctx = ExecContext(_rebuild_blocks(self.small_upper, small_args),
                              settings)
            fake_keys = []
            for (f, _), (has_v, dic) in zip(agg.keys, struct["key_meta"]):
                fake_keys.append(ColVal(
                    f.dtype, jnp.zeros((1,), jnp.int32),
                    jnp.ones((1,), jnp.uint8) if has_v else None, dic))
            states_per_agg = []
            i = 1
            for item, dic, n in zip(struct["items"], struct["agg_dicts"],
                                    struct["arity"][1:]):
                fake_args = [ColVal(item.field.dtype,
                                    jnp.zeros((1,), jnp.int32), None, dic)] \
                    if item.args else []
                states_per_agg.append(
                    (item, fake_args, carry["states"][i:i + n]))
                i += n
            merged_eb = _finalize(
                agg, fake_keys, carry["keys"], carry["num_groups"],
                carry["states"][0], states_per_agg, self.cap_c,
                struct["global_agg"], False, ctx,
                group_valid=None if struct["global_agg"]
                else carry["valid"])
            ctx.injected[_STREAM_KEY] = merged_eb
            out = execute_plan(split_.upper, ctx)
            data_leaves, validity_leaves, dicts, length_leaves = {}, {}, {}, {}
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
            return {"valid": out.valid, "data": data_leaves,
                    "validity": validity_leaves, "lengths": length_leaves,
                    "checks": [c.value for c in ctx.checks],
                    "carry_checks": ([carry["chunk_groups"],
                                      carry["num_groups"]]
                                     + carry["lower_checks"])}

        self.init_fn = jax.jit(init_fn)
        self.step_fn = jax.jit(step_fn, donate_argnums=(0,))
        self.fin_fn = jax.jit(fin_fn)

    def run(self, session) -> Tuple[Dict[str, np.ndarray], ExecContext]:
        import time as _time
        base_args = self.small_args(self.small_lower)
        upper_args = self.small_args(self.small_upper)

        t_loop = _time.perf_counter()
        carry = None
        for src, bucket in self.sources:
            lower_args = self._lower_args_for(base_args, bucket)
            if src.total_rows == 0 and carry is not None:
                continue
            for args in self._iter_chunks(src):
                carry = self.init_fn(args, lower_args) if carry is None \
                    else self.step_fn(carry, args, lower_args)
        if carry is None:                     # fully empty source set
            src0 = self.sources[0][0]
            carry = self.init_fn(
                _to_device(*src0.chunk(0)),
                self._lower_args_for(base_args, self.sources[0][1]))
        t_loop = _time.perf_counter() - t_loop
        t_fin = _time.perf_counter()
        leaves = self.fin_fn(carry, upper_args)

        struct = self.struct
        settings = self.settings
        ctx = ExecContext({}, settings)
        # carry checks: [chunk-level groups vs cap_g, merged groups vs cap_c,
        #                *lower-plan checks (max over chunks)]
        cvals = leaves["carry_checks"]
        ctx.checks.append(Check(
            cvals[0], struct["cap_g"],
            "per-chunk GROUP BY cardinality exceeded max_groups; raise the "
            "max_groups setting", setting="max_groups"))
        if not struct["global_agg"]:
            ctx.checks.append(Check(
                cvals[1], self.cap_c,
                "GROUP BY cardinality exceeded max_groups; raise the "
                "max_groups setting", setting="max_groups"))
        for val, (limit, msg, setting) in zip(cvals[2:],
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
        ctx.profile["rows_scanned"] = self.total_rows
        self._record_io(session, t_loop, _time.perf_counter() - t_fin)
        return cols_np, ctx


def _lower_on_chunk(split: GenericSplit, settings: Settings, src, table,
                    small_meta, chunk_args, small_args):
    """Trace the per-chunk streamable subplan on one chunk."""
    blocks = _rebuild_blocks(small_meta, small_args)
    blocks[split.big_key] = _chunk_block(chunk_args, src, table)
    ctx = ExecContext(blocks, settings)
    eb = execute_plan(split.lower, ctx)
    return eb, ctx


def _extract_out_leaves(out: ExecBlock, schema, ctx: ExecContext,
                        struct: dict):
    """Trace-time leaf extraction for a finalizer's output block."""
    data_leaves, validity_leaves, dicts, length_leaves = {}, {}, {}, {}
    for f in schema:
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
    return {"valid": out.valid, "data": data_leaves,
            "validity": validity_leaves, "lengths": length_leaves,
            "checks": [c.value for c in ctx.checks]}


class TopKProgram(_StreamProgramBase):
    """Streamed ORDER BY ... LIMIT k: each chunk's device top-k rows merge
    into a carried top-k (sorted-run carry + k-way merge, the reference's
    MergeSortingTransform/MergingSortedAlgorithm pair collapsed onto the
    device because k rows always fit)."""

    def __init__(self, session, split: GenericSplit, settings: Settings,
                 sources, table, grace: Optional[tuple] = None):
        super().__init__(session, settings, sources, table,
                         split.lower_scan_keys, split.upper_scan_keys,
                         split.big_key, grace)
        self.split = split
        self.src = sources[0][0]
        src = self.src
        k_total = split.k_total
        k_cap = pad_to(max(k_total, 1))
        self.k_cap = k_cap
        struct = self.struct
        split_ = split
        settings_ = settings

        def chunk_topk(eb: ExecBlock):
            cap = eb.capacity
            tokens = [_token_for_sort(evaluate(it.expr, eb.env()), it, cap)
                      for it in split_.sort_items]
            if len(tokens) == 1 and cap >= (1 << 16):
                idx0 = sort_ops.topk_permutation(tokens[0], eb.valid,
                                                 min(k_cap, cap))
            else:
                idx0 = sort_ops.sort_permutation(tokens, eb.valid)[:k_cap]
            if idx0.shape[0] < k_cap:
                idx = jnp.zeros((k_cap,), idx0.dtype).at[:idx0.shape[0]] \
                    .set(idx0)
            else:
                idx = idx0
            n_valid = jnp.sum(eb.valid.astype(jnp.int64))
            data, validity, lengths = {}, {}, {}
            dicts = {}
            for f in split_.lower.schema:
                cv = _gather_colval(eb.cols[f.id], idx, cap)
                data[f.id] = cv.data
                if cv.validity is not None:
                    validity[f.id] = cv.validity
                if cv.lengths is not None:
                    lengths[f.id] = cv.lengths
                dicts[f.id] = cv.dictionary
            struct["lower_dicts"] = dicts
            count = jnp.minimum(jnp.minimum(n_valid, k_total),
                                idx0.shape[0])
            return data, validity, lengths, count

        def init_fn(chunk_args, small_args):
            eb, ctx = _lower_on_chunk(split_, settings_, src, table,
                                      self.small_lower, chunk_args,
                                      small_args)
            struct["lower_checks"] = [(c.limit, c.message, c.setting)
                                      for c in ctx.checks]
            lchecks = [jnp.asarray(c.value, jnp.int64) for c in ctx.checks]
            data, validity, lengths, count = chunk_topk(eb)
            return {"data": data, "validity": validity, "lengths": lengths,
                    "count": count, "lower_checks": lchecks}

        def step_fn(carry, chunk_args, small_args):
            eb, ctx = _lower_on_chunk(split_, settings_, src, table,
                                      self.small_lower, chunk_args,
                                      small_args)
            lchecks = [jnp.asarray(c.value, jnp.int64) for c in ctx.checks]
            data, validity, lengths, count = chunk_topk(eb)
            cat_cap = 2 * k_cap
            cols = {}
            for f in split_.lower.schema:
                d = jnp.concatenate([carry["data"][f.id], data[f.id]])
                v = None
                if f.id in validity:
                    v = jnp.concatenate([carry["validity"][f.id],
                                         validity[f.id]])
                ln = None
                if f.id in lengths:
                    ln = jnp.concatenate([carry["lengths"][f.id],
                                          lengths[f.id]])
                cols[f.id] = ColVal(f.dtype, d, v,
                                    struct["lower_dicts"][f.id], lengths=ln)
            ar = jnp.arange(k_cap, dtype=jnp.int64)
            valid = jnp.concatenate([ar < carry["count"], ar < count])
            eb2 = ExecBlock(cols, valid, cat_cap)
            tokens = [_token_for_sort(evaluate(it.expr, eb2.env()), it,
                                      cat_cap)
                      for it in split_.sort_items]
            idx = sort_ops.sort_permutation(tokens, valid)[:k_cap]
            ndata, nvalidity, nlengths = {}, {}, {}
            for f in split_.lower.schema:
                cv = _gather_colval(cols[f.id], idx, cat_cap)
                ndata[f.id] = cv.data
                if cv.validity is not None:
                    nvalidity[f.id] = cv.validity
                if cv.lengths is not None:
                    nlengths[f.id] = cv.lengths
            return {"data": ndata, "validity": nvalidity,
                    "lengths": nlengths,
                    "count": jnp.minimum(carry["count"] + count, k_total),
                    "lower_checks": [jnp.maximum(a, b) for a, b in
                                     zip(carry["lower_checks"], lchecks)]}

        def fin_fn(carry, small_args):
            ctx = ExecContext(_rebuild_blocks(self.small_upper, small_args),
                              settings_)
            cols = {}
            for f in split_.lower.schema:
                cols[f.id] = ColVal(f.dtype, carry["data"][f.id],
                                    carry["validity"].get(f.id),
                                    struct["lower_dicts"][f.id],
                                    lengths=carry["lengths"].get(f.id))
            valid = jnp.arange(k_cap, dtype=jnp.int64) < carry["count"]
            ctx.injected[_STREAM_KEY] = ExecBlock(cols, valid, k_cap)
            out = execute_plan(split_.upper, ctx)
            leaves = _extract_out_leaves(out, split_.upper.schema, ctx,
                                         struct)
            leaves["carry_checks"] = list(carry["lower_checks"])
            return leaves

        self.init_fn = jax.jit(init_fn)
        self.step_fn = jax.jit(step_fn, donate_argnums=(0,))
        self.fin_fn = jax.jit(fin_fn)

    def run(self, session) -> Tuple[Dict[str, np.ndarray], ExecContext]:
        import time as _time
        base_args = self.small_args(self.small_lower)
        upper_args = self.small_args(self.small_upper)
        t_loop = _time.perf_counter()
        carry = None
        for src, bucket in self.sources:
            lower_args = self._lower_args_for(base_args, bucket)
            if src.total_rows == 0 and carry is not None:
                continue
            for args in self._iter_chunks(src):
                carry = self.init_fn(args, lower_args) if carry is None \
                    else self.step_fn(carry, args, lower_args)
        if carry is None:
            src0 = self.sources[0][0]
            carry = self.init_fn(
                _to_device(*src0.chunk(0)),
                self._lower_args_for(base_args, self.sources[0][1]))
        t_loop = _time.perf_counter() - t_loop
        t_fin = _time.perf_counter()
        leaves = self.fin_fn(carry, upper_args)

        struct = self.struct
        ctx = ExecContext({}, self.settings)
        for val, (limit, msg, setting) in zip(leaves["carry_checks"],
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
        ctx.profile["rows_scanned"] = self.total_rows
        self._record_io(session, t_loop, _time.perf_counter() - t_fin)
        return cols_np, ctx


class CollectProgram(_StreamProgramBase):
    """Streamed plain SELECT: surviving lower-plan rows are compacted to
    host RAM chunk by chunk (host RAM plays the reference's
    TemporaryDataOnDisk role); the remaining upper plan runs on the
    collected block — on device when it fits the budget, with host
    sort/limit fallbacks when it does not (external sort)."""

    def __init__(self, session, split: GenericSplit, settings: Settings,
                 sources, table, grace: Optional[tuple] = None):
        super().__init__(session, settings, sources, table,
                         split.lower_scan_keys, split.upper_scan_keys,
                         split.big_key, grace)
        self.split = split
        self.src = sources[0][0]
        src = self.src
        struct = self.struct
        split_ = split
        settings_ = settings

        def chunk_fn(chunk_args, small_args):
            eb, ctx = _lower_on_chunk(split_, settings_, src, table,
                                      self.small_lower, chunk_args,
                                      small_args)
            data, validity, lengths, dicts = {}, {}, {}, {}
            for f in split_.lower.schema:
                cv = eb.cols[f.id].broadcast(eb.capacity)
                data[f.id] = cv.data
                if cv.validity is not None:
                    validity[f.id] = cv.validity
                if cv.lengths is not None:
                    lengths[f.id] = cv.lengths
                dicts[f.id] = cv.dictionary
            struct["dicts"] = dicts
            struct["lower_checks"] = [(c.limit, c.message, c.setting)
                                      for c in ctx.checks]
            return {"valid": eb.valid, "data": data, "validity": validity,
                    "lengths": lengths,
                    "checks": [c.value for c in ctx.checks]}

        self.chunk_fn = jax.jit(chunk_fn)

    def run(self, session) -> Tuple[Dict[str, np.ndarray], ExecContext]:
        base_args = self.small_args(self.small_lower)
        schema = self.split.lower.schema
        import time as _time
        acc = {f.id: [] for f in schema}
        acc_v = {f.id: [] for f in schema}
        acc_l = {f.id: [] for f in schema}
        total = 0
        limit_total = self.split.limit_total
        struct = self.struct
        stop = False
        t_loop = _time.perf_counter()
        for src, bucket in self.sources:
            if stop:
                break
            lower_args = self._lower_args_for(base_args, bucket)
            if src.total_rows == 0 and total:
                continue
            for args in self._iter_chunks(src):
                leaves = self.chunk_fn(args, lower_args)
                for val, (limit, msg, setting) in zip(
                        leaves["checks"], struct["lower_checks"]):
                    actual = int(jax.device_get(val))
                    if actual > limit:
                        raise CapacityError(
                            f"{msg} (needed {actual}, capacity {limit})",
                            setting=setting, needed=actual)
                valid = np.asarray(jax.device_get(leaves["valid"]))
                idx = np.nonzero(valid)[0]
                if limit_total is not None \
                        and total + len(idx) > limit_total:
                    idx = idx[:limit_total - total]
                if "np_dtypes" not in struct:
                    struct["np_dtypes"] = {
                        f.id: np.asarray(
                            jax.device_get(leaves["data"][f.id])).dtype
                        for f in schema}
                    struct["has_validity"] = {
                        f.id: f.id in leaves["validity"] for f in schema}
                    struct["has_lengths"] = {
                        f.id: f.id in leaves["lengths"] for f in schema}
                    struct["data_shapes"] = {
                        f.id: np.asarray(
                            jax.device_get(leaves["data"][f.id])).shape[1:]
                        for f in schema}
                if len(idx):
                    for f in schema:
                        fid = f.id
                        d = np.asarray(jax.device_get(leaves["data"][fid]))
                        acc[fid].append(d[idx])
                        if fid in leaves["validity"]:
                            acc_v[fid].append(np.asarray(jax.device_get(
                                leaves["validity"][fid]))[idx])
                        if fid in leaves["lengths"]:
                            acc_l[fid].append(np.asarray(jax.device_get(
                                leaves["lengths"][fid]))[idx])
                    total += len(idx)
                if limit_total is not None and total >= limit_total:
                    stop = True
                    break
        t_loop = _time.perf_counter() - t_loop
        t_fin = _time.perf_counter()
        out = self._finalize(session, acc, acc_v, acc_l, total)
        self._record_io(session, t_loop, _time.perf_counter() - t_fin)
        return out

    # -- collected-rows finalization ------------------------------------------
    def _host_arrays(self, acc, acc_v, acc_l, total):
        struct = self.struct
        schema = self.split.lower.schema
        data, validity, lengths = {}, {}, {}
        for f in schema:
            fid = f.id
            if acc[fid]:
                data[fid] = np.concatenate(acc[fid])
            else:
                data[fid] = np.zeros((0,) + struct["data_shapes"][fid],
                                     struct["np_dtypes"][fid])
            if struct["has_validity"][fid]:
                validity[fid] = np.concatenate(acc_v[fid]) if acc_v[fid] \
                    else np.zeros((0,), np.uint8)
            if struct["has_lengths"][fid]:
                lengths[fid] = np.concatenate(acc_l[fid]) if acc_l[fid] \
                    else np.zeros((0,), np.int32)
        return data, validity, lengths

    def _block_of(self, data, validity, lengths, n, pad: bool,
                  device: bool) -> ExecBlock:
        struct = self.struct
        schema = self.split.lower.schema
        cap = pad_to(max(n, 1)) if pad else max(n, 1)
        cols = {}
        for f in schema:
            fid = f.id
            d = data[fid]
            if len(d) < cap:
                d = np.concatenate(
                    [d, np.zeros((cap - len(d),) + d.shape[1:], d.dtype)])
            v = None
            if fid in validity:
                v = validity[fid]
                if len(v) < cap:
                    v = np.concatenate(
                        [v, np.zeros((cap - len(v),), v.dtype)])
            ln = None
            if fid in lengths:
                ln = lengths[fid]
                if len(ln) < cap:
                    ln = np.concatenate(
                        [ln, np.zeros((cap - len(ln),), ln.dtype)])
            if device:
                d = jax.device_put(d)
                v = jax.device_put(v) if v is not None else None
                ln = jax.device_put(ln) if ln is not None else None
            cols[fid] = ColVal(f.dtype, d, v, struct["dicts"][fid],
                               lengths=ln)
        valid = np.arange(cap) < n
        if device:
            valid = jax.device_put(valid)
        return ExecBlock(cols, valid, cap)

    def _finalize(self, session, acc, acc_v, acc_l, total):
        data, validity, lengths = self._host_arrays(acc, acc_v, acc_l, total)
        split = self.split
        settings = self.settings
        upper = split.upper
        ctx = ExecContext({}, settings)
        ctx.profile["rows_scanned"] = self.total_rows

        def mat(eb: ExecBlock, schema):
            cols_np = materialize(eb, schema, ctx)
            return cols_np, ctx

        if isinstance(upper, L.BlockSourceNode):
            eb = self._block_of(data, validity, lengths, total, pad=False,
                                device=False)
            return mat(eb, upper.schema)
        if isinstance(upper, L.LimitNode) \
                and isinstance(upper.child, L.BlockSourceNode):
            lo = upper.offset
            hi = lo + upper.limit if upper.limit >= 0 else total
            data = {k: v[lo:hi] for k, v in data.items()}
            validity = {k: v[lo:hi] for k, v in validity.items()}
            lengths = {k: v[lo:hi] for k, v in lengths.items()}
            eb = self._block_of(data, validity, lengths,
                                max(min(hi, total) - lo, 0), pad=False,
                                device=False)
            return mat(eb, upper.schema)

        est = sum(d.nbytes for d in data.values()) \
            + sum(v.nbytes for v in validity.values())
        budget = max(int(settings.max_device_memory_bytes), 1)
        if est <= budget:
            # collected rows fit the device: run the remaining plan normally
            eb = self._block_of(data, validity, lengths, total, pad=True,
                                device=True)
            ectx = ExecContext(
                {k: session.catalog.get_table(*k).read_block()
                 for k in split.upper_scan_keys}, settings)
            ectx.injected[_STREAM_KEY] = eb
            out = execute_plan(upper, ectx)
            cols_np = materialize(out, upper.schema, ectx)
            ectx.profile["rows_scanned"] = self.total_rows
            return cols_np, ectx

        # over-budget: host sort fallback for Sort [-> Limit] chains
        chain = []
        node = upper
        while not isinstance(node, L.BlockSourceNode):
            chain.append(node)
            kids = node.children()
            if len(kids) != 1:
                break
            node = kids[0]
        if not isinstance(node, L.BlockSourceNode) \
                or not all(isinstance(c, (L.SortNode, L.LimitNode))
                           for c in chain) \
                or sum(isinstance(c, L.SortNode) for c in chain) != 1:
            raise MemoryLimitExceeded(
                f"collected streamed rows need ~{est >> 20} MiB on device "
                f"(budget {budget >> 20} MiB) and the remaining plan is not "
                "a host-executable Sort/Limit chain; raise "
                "max_device_memory_bytes or add a LIMIT")
        for c in reversed(chain):       # bottom-up: Sort first, then Limit
            if isinstance(c, L.SortNode):
                perm = _np_order(c.items, self.split.lower.schema,
                                 data, validity, self.struct["dicts"])
                data = {k: v[perm] for k, v in data.items()}
                validity = {k: v[perm] for k, v in validity.items()}
                lengths = {k: v[perm] for k, v in lengths.items()}
            else:
                lo = c.offset
                hi = lo + c.limit if c.limit >= 0 else total
                data = {k: v[lo:hi] for k, v in data.items()}
                validity = {k: v[lo:hi] for k, v in validity.items()}
                lengths = {k: v[lo:hi] for k, v in lengths.items()}
                total = max(min(hi, total) - lo, 0)
        n = len(next(iter(data.values()))) if data else 0
        eb = self._block_of(data, validity, lengths, n, pad=False,
                            device=False)
        return mat(eb, upper.schema)


def _np_order(items, schema, data, validity, dicts) -> np.ndarray:
    """Host permutation for ORDER BY over collected rows (external-sort
    finalizer).  Sort keys must be plain columns of the collected block."""
    from ..exprs.expr import BoundColumn
    keys: List[np.ndarray] = []
    for it in items:
        if not isinstance(it.expr, BoundColumn) \
                or it.expr.name not in data:
            raise MemoryLimitExceeded(
                "host external sort requires plain column ORDER BY keys")
        fid = it.expr.name
        v = data[fid]
        f = next(f for f in schema if f.id == fid)
        if f.dtype.is_dictionary:
            d = dicts[fid]
            vals = d.values.astype(str) if d is not None and len(d) \
                else np.zeros(0, str)
            order = np.argsort(vals, kind="stable")
            rank = np.empty(len(vals), np.int64)
            rank[order] = np.arange(len(vals))
            tok = rank[np.maximum(v.astype(np.int64), 0)] \
                if len(vals) else np.zeros(len(v), np.int64)
        elif v.dtype.kind == "f":
            bits = v.astype(np.float64).view(np.uint64)
            sign = (bits >> np.uint64(63)).astype(bool)
            tok = np.where(sign, ~bits,
                           bits | np.uint64(1 << 63)).astype(np.uint64)
        elif v.dtype.kind == "u":
            tok = v.astype(np.uint64)
        else:
            with np.errstate(over="ignore"):
                tok = v.astype(np.int64).astype(np.uint64) \
                    ^ np.uint64(1 << 63)
        if it.descending:
            tok = ~tok
        if fid in validity:
            is_null = validity[fid] == 0
            tok = np.where(is_null,
                           np.uint64(2**64 - 1) if it.nulls_last
                           else np.uint64(0),
                           np.clip(tok, np.uint64(1),
                                   np.uint64(2**64 - 2)))
        keys.append(tok)
    return np.lexsort(tuple(reversed(keys)))   # last key = primary


# -- entry point ---------------------------------------------------------------

def _stream_threshold(settings: Settings) -> int:
    thr = settings.max_device_block_bytes
    ext = settings.max_bytes_before_external_group_by
    if ext > 0:
        thr = min(thr, ext) if thr > 0 else ext
    return thr if thr > 0 else (2 << 30)


def _chunk_rows_for(table, columns, settings: Settings) -> int:
    if settings.stream_chunk_rows > 0:
        return pad_to(settings.stream_chunk_rows)
    n = max(table.num_rows, 1)
    row_bytes = max(table.physical_bytes(columns) // n, 1)
    return pad_to(min(settings.stream_chunk_bytes // row_bytes, n))


def try_streaming(session, stmt, settings: Settings, sql: str):
    """Streaming SELECT entry: None when the plan isn't streamable."""
    from ..storage.table import NotStreamable

    thr = _stream_threshold(settings)
    catalog = session.catalog
    # cheap gate: nothing in the catalog is over the threshold
    over = False
    for db in catalog.databases.values():
        if db.name == _TMP_DB:
            continue              # hidden materialized numbers() sequences
        for t in db.tables.values():
            if t.num_rows and t.physical_bytes() > thr:
                over = True
                break
        if over:
            break
    if not over:
        return None

    import json
    skey = json.dumps(settings.as_dict(), sort_keys=True, default=str) \
        + "@" + catalog.current_database
    cache = getattr(session, "_stream_cache", None)
    if cache is None:
        cache = session._stream_cache = {}
    hit = cache.get((sql, skey)) if sql else None
    if hit is not None:
        prog, sig0 = hit
        sig = tuple(sorted(
            (db, tbl, catalog.get_table(db, tbl).version)
            for (db, tbl) in ([prog.split.big_key]
                              + prog.split.lower_scan_keys
                              + prog.split.upper_scan_keys)))
        if sig == sig0:
            cols, ctx = prog.run(session)
            return prog.split.upper, cols, ctx

    plan = session._plan(stmt, settings)
    built = _build_stream_program(session, plan, settings, thr)
    if built is None:
        # memory governor: a plan that cannot stream and cannot fit the
        # device budget fails with a catchable error BEFORE dispatch rather
        # than aborting the process inside the XLA allocator (reference:
        # MemoryTracker hard limits, src/Common/MemoryTracker.cpp)
        budget = effective_memory_budget(settings)
        est = estimate_plan_device_bytes(plan, catalog, settings)
        if est > budget:
            raise MemoryLimitExceeded(
                f"query would need ~{est >> 20} MiB of device memory "
                f"(budget {budget >> 20} MiB) and "
                "no streaming rewrite applies to this plan shape")
        return None
    prog = built
    cols, ctx = prog.run(session)
    if sql:
        sig = tuple(sorted(
            (db, tbl, catalog.get_table(db, tbl).version)
            for (db, tbl) in ([prog.split.big_key]
                              + prog.split.lower_scan_keys
                              + prog.split.upper_scan_keys)))
        if len(cache) > 64:
            cache.clear()
        cache[(sql, skey)] = (prog, sig)
    return prog.split.upper, cols, ctx


def estimate_plan_scan_bytes(plan: L.PlanNode, catalog) -> int:
    """First-order device footprint: bytes of every distinct scanned table
    (scanned columns only, narrow-storage aware)."""
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    cols_by_table: Dict[Tuple[str, str], set] = {}
    for s in scans:
        cols_by_table.setdefault((s.database, s.table),
                                 set()).update(s.column_names)
    total = 0
    for key, cols in cols_by_table.items():
        try:
            t = catalog.get_table(*key)
        except Exception:
            continue
        if t.num_rows:
            total += t.physical_bytes(cols)
    return total


def _field_est_bytes(f: L.Field) -> int:
    t = f.dtype
    if t.is_dictionary:
        return 4
    if t.is_array:
        return 8 * 16            # heuristic: avg 16 elements per row
    if t.agg_state is not None:
        return 64
    try:
        return t.np_dtype.itemsize
    except Exception:
        return 8


def estimate_plan_device_bytes(plan: L.PlanNode, catalog,
                               settings: Settings) -> int:
    """Scan bytes + the largest operator intermediate (capacity x row
    width).  First-order but catches the catastrophic shapes — cross-join
    blowups, arrayJoin expansion — before the XLA allocator does."""
    caps: Dict[int, int] = {}

    def cap_of(node: L.PlanNode) -> int:
        hit = caps.get(id(node))
        if hit is not None:
            return hit
        if isinstance(node, L.ScanNode):
            try:
                v = max(catalog.get_table(node.database,
                                          node.table).num_rows, 1)
            except Exception:
                v = 1
        elif isinstance(node, L.NumbersNode):
            v = max(node.count, 1)
        else:
            kids = [cap_of(c) for c in node.children()]
            if isinstance(node, L.JoinNode):
                v = kids[0] * kids[1] if node.kind == "cross" \
                    else max(kids[0], 1)
            elif isinstance(node, L.AggregateNode):
                v = min(kids[0], settings.max_groups)
            elif isinstance(node, L.ArrayJoinNode):
                v = kids[0] * 16
            elif isinstance(node, L.UnionNode):
                v = sum(kids)
            else:
                v = max(kids) if kids else 1024
        caps[id(node)] = v
        return v

    peak = 0

    def walk(n: L.PlanNode):
        nonlocal peak
        row = sum(_field_est_bytes(f) for f in n.schema)
        peak = max(peak, cap_of(n) * row)
        for c in n.children():
            walk(c)

    walk(plan)
    return estimate_plan_scan_bytes(plan, catalog) + peak


def effective_memory_budget(settings: Settings) -> int:
    """Device budget for the governor: max_device_memory_bytes, further
    capped by the reference-compatible max_memory_usage when set."""
    budget = max(int(settings.max_device_memory_bytes), 1)
    if settings.max_memory_usage > 0:
        budget = min(budget, int(settings.max_memory_usage))
    return budget


# -- expanding-join (blowup) streaming ----------------------------------------
# A plan can exceed the budget through an operator INTERMEDIATE — a cross
# join's output — while every stored input is small.  Chunking the probe
# side bounds each per-chunk joined block, the role
# max_joined_block_size_rows plays in the reference's JoiningTransform
# (src/Interpreters/HashJoin/HashJoin.cpp joined-block splitting).

def _subtree_rows(node: L.PlanNode, catalog, settings: Settings) -> int:
    """First-order output-row estimate of a subtree (build sides)."""
    if isinstance(node, L.ScanNode):
        try:
            return max(catalog.get_table(node.database,
                                         node.table).num_rows, 1)
        except Exception:
            return 1
    if isinstance(node, L.NumbersNode):
        return max(node.count, 1)
    kids = [_subtree_rows(c, catalog, settings) for c in node.children()]
    if isinstance(node, L.JoinNode):
        return kids[0] * kids[1] if node.kind == "cross" else max(kids[0], 1)
    if isinstance(node, L.AggregateNode):
        return min(kids[0], settings.max_groups)
    if isinstance(node, L.ArrayJoinNode):
        return kids[0] * 16
    if isinstance(node, L.UnionNode):
        return sum(kids)
    return max(kids) if kids else 1


def _chain_blowup(split, catalog, settings: Settings) -> Tuple[int, int]:
    """-> (output rows per probe row, widest chain row bytes) over the
    streamable chain between the breaker and the streamed scan."""
    path = getattr(split, "path", None)
    j = getattr(split, "lower_i", None)
    if path is None or j is None:
        return 1, 8
    f, row = 1, 8
    for i in range(j, len(path) - 1):
        node = path[i]
        row = max(row, sum(_field_est_bytes(fl) for fl in node.schema))
        if isinstance(node, L.JoinNode) and node.kind == "cross" \
                and node.left is path[i + 1]:
            f *= _subtree_rows(node.right, catalog, settings)
    return f, row


def _blowup_chunk_rows(split, catalog, settings: Settings,
                       chunk_rows: int) -> int:
    """Shrink the streamed chunk so per-chunk expanding-join blocks fit the
    budget; refuse (reference MEMORY_LIMIT_EXCEEDED) when even a single
    max_joined_block_size_rows-row block cannot."""
    f, row = _chain_blowup(split, catalog, settings)
    if f <= 1:
        return chunk_rows
    budget = effective_memory_budget(settings)
    mjbsr = max(int(settings.max_joined_block_size_rows), 1)
    try:
        probe_rows = max(catalog.get_table(*split.big_key).num_rows, 1)
    except Exception:
        probe_rows = chunk_rows
    # one joined block: max_joined_block_size_rows rows, or the whole output
    # when smaller; our floor is one tile-padded probe chunk's expansion.
    blk = min(mjbsr, f * probe_rows)
    floor = pad_to(1) * f
    if max(blk, floor) * row > budget * 2:      # 2x: tile-padding slack
        raise MemoryLimitExceeded(
            f"expanding join emits blocks of ~{max(blk, floor)} rows "
            f"(~{(max(blk, floor) * row) >> 20} MiB each; "
            f"max_joined_block_size_rows={mjbsr}), over the "
            f"{budget >> 20} MiB memory budget")
    cap = max((budget // 2) // (f * row), 1)
    return pad_to(min(chunk_rows, cap))


_NUMBERS_MAT_LIMIT = 1 << 27     # rows; 1 GiB host for a u64 sequence
_TMP_DB = "_stream_tmp"


def _collect_numbers(node: L.PlanNode, out: List[L.NumbersNode]) -> None:
    if isinstance(node, L.NumbersNode):
        out.append(node)
    for c in node.children():
        _collect_numbers(c, out)


def _materialize_numbers(session, nn: L.NumbersNode) -> None:
    """Hidden catalog table backing a numbers() source so ChunkSource can
    stream it (generated sequences have no parts of their own)."""
    from ..storage.table import Table, Database
    catalog = session.catalog
    db = catalog.databases.get(_TMP_DB)
    if db is None:
        db = catalog.databases[_TMP_DB] = Database(_TMP_DB)
    name = f"numbers_{nn.start}_{nn.count}"
    if name in db.tables:
        return
    if len(db.tables) >= 4:
        db.tables.clear()           # tiny cache: sequences rebuild cheaply
    t = Table(name, [("number", dt.UInt64)])
    t.insert_pydict({"number": np.arange(nn.start, nn.start + nn.count,
                                         dtype=np.uint64)})
    db.tables[name] = t


def try_blowup_streaming(session, stmt, settings: Settings, sql: str):
    """Second-chance streaming after a governor refusal: when the overflow
    is an operator intermediate (cross-join expansion) rather than a big
    stored table, chunk the probe side of the expanding chain.  numbers()
    probe sources are materialized into hidden tables first.  Returns
    (upper_plan, cols, ctx) or None (caller re-raises the refusal)."""
    from ..storage.table import NotStreamable
    catalog = session.catalog
    plan = session._plan(stmt, settings)
    budget = effective_memory_budget(settings)
    if estimate_plan_device_bytes(plan, catalog, settings) <= budget:
        return None
    # chunking candidates: stored scans (largest first), then numbers()
    cands: List[tuple] = []
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
    seen = set()
    for s in scans:
        key = (s.database, s.table)
        if key in seen:
            continue
        seen.add(key)
        try:
            t = catalog.get_table(*key)
        except Exception:
            continue
        b = t.physical_bytes(set(s.column_names)) if t.num_rows else 0
        cands.append((b, None, key))
    cands.sort(key=lambda c: -c[0])
    nums: List[L.NumbersNode] = []
    _collect_numbers(plan, nums)
    for nn in nums:
        if nn.count <= _NUMBERS_MAT_LIMIT:
            cands.append((nn.count * 8, nn, None))
    for _, nn, key in cands:
        if nn is not None:
            scan2 = L.ScanNode(_TMP_DB, f"numbers_{nn.start}_{nn.count}",
                               list(nn.schema), ["number"])
            plan2 = _replace_node(plan, nn, scan2)
            key2 = (scan2.database, scan2.table)
        else:
            plan2, key2 = plan, key
        split = find_split(plan2, key2)
        if split is None:
            split = find_generic_split(plan2, key2, settings)
        if split is None:
            continue
        if nn is not None:
            _materialize_numbers(session, nn)
        try:
            table = catalog.get_table(*key2)
        except Exception:
            continue
        columns = list(split.scan.column_names)
        try:
            chunk_rows = _chunk_rows_for(table, columns, settings)
            if isinstance(split, GenericSplit) and split.kind == "topk":
                chunk_rows = max(chunk_rows, pad_to(split.k_total))
            chunk_rows = _blowup_chunk_rows(split, catalog, settings,
                                            chunk_rows)
            f, row = _chain_blowup(split, catalog, settings)
            other = estimate_plan_scan_bytes(plan2, catalog) \
                - (table.physical_bytes(set(columns)) if table.num_rows
                   else 0)
            # 2x slack: chunk_rows is padded up to the tile multiple
            if other + chunk_rows * max(f, 1) * row > budget * 2:
                continue      # chunking can't pull this plan under budget
            src = table.chunk_source(columns, chunk_rows)
        except NotStreamable:
            continue
        sources = [(src, None)]
        if isinstance(split, StreamSplit):
            cap_c = _carry_cap(split, table, settings)
            prog = StreamProgram(session, split, settings, sources, table,
                                 cap_c, None)
        elif split.kind == "topk":
            prog = TopKProgram(session, split, settings, sources, table,
                               None)
        else:
            prog = CollectProgram(session, split, settings, sources, table,
                                  None)
        cols, ctx = prog.run(session)
        session.profile_events["BlowupStreamedQueries"] = \
            session.profile_events.get("BlowupStreamedQueries", 0) + 1
        return split.upper, cols, ctx
    return None


def _build_stream_program(session, plan: L.PlanNode, settings: Settings,
                          thr: int):
    """Pick the streamed table + breaker + (optional) grace partitioning and
    construct the program.  None when no streaming rewrite applies."""
    from ..storage.table import ChunkSource, NotStreamable
    catalog = session.catalog
    scans: List[L.ScanNode] = []
    _collect_scans(plan, scans)
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
    if not over:
        return None

    for big in sorted(over, key=lambda k: -over[k]):
        split = find_split(plan, big)
        if split is None:
            split = find_generic_split(plan, big, settings)
        if split is None:
            continue
        table = catalog.get_table(*big)
        grace_j, compatible = _detect_grace(split, split.scan, catalog, thr,
                                            settings)
        if not compatible:
            continue
        others = set(over) - {big}
        if grace_j is not None:
            others.discard(grace_j.build_key)
            # the build table must appear ONLY as that join's build side
            if grace_j.build_key in split.upper_scan_keys \
                    or split.lower_scan_keys.count(grace_j.build_key) != 1:
                continue
        if others:
            continue                  # some other huge table is unstreamable

        columns = list(split.scan.column_names)
        lower_root = split.agg.child if isinstance(split, StreamSplit) \
            else split.lower
        part_idx, spans = _prune_parts(lower_root, split.scan, table,
                                       session)
        try:
            chunk_rows = _chunk_rows_for(table, columns, settings)
            if isinstance(split, GenericSplit) and split.kind == "topk":
                chunk_rows = max(chunk_rows, pad_to(split.k_total))
            chunk_rows = _blowup_chunk_rows(split, catalog, settings,
                                            chunk_rows)
            grace = None
            if grace_j is None:
                psel, sel_key = host_prewhere_sel(
                    lower_root, split.scan, table, part_idx, spans,
                    session, settings)
                src = table.chunk_source(columns, chunk_rows,
                                         part_idx=part_idx, spans=spans,
                                         row_sel=psel, sel_key=sel_key)
                sources = [(src, None)]
            else:
                build_table = catalog.get_table(*grace_j.build_key)
                build_cols = list(grace_j.build_scan.column_names)
                P = _grace_bucket_count(
                    build_table.physical_bytes(set(build_cols)), thr,
                    settings)
                grace_j.n_buckets = P
                parts = table.parts if part_idx is None \
                    else [table.parts[i] for i in part_idx]
                probe_sel = _partition_rows(parts, grace_j.probe_cols,
                                            grace_j.kinds, P)
                build_sel = _partition_rows(build_table.parts,
                                            grace_j.build_cols,
                                            grace_j.kinds, P)
                meta_blk, bucket_args = _grace_build_buckets(
                    build_table, build_cols, build_sel)
                donor = None
                sources = []
                for b in range(P):
                    src_b = ChunkSource(table, columns, chunk_rows,
                                        part_idx=part_idx,
                                        row_sel=probe_sel[b],
                                        layout_donor=donor)
                    donor = donor or src_b
                    sources.append((src_b, b))
                grace = (grace_j.build_key, meta_blk, bucket_args)
                session.profile_events["GraceJoinBuckets"] = \
                    session.profile_events.get("GraceJoinBuckets", 0) + P
        except NotStreamable:
            continue
        if isinstance(split, StreamSplit):
            # global aggregates carry one group; keyed ones size the carry
            # by the group cardinality bound
            cap_c = _carry_cap(split, table, settings)
            return StreamProgram(session, split, settings, sources, table,
                                 cap_c, grace)
        if split.kind == "topk":
            return TopKProgram(session, split, settings, sources, table,
                               grace)
        return CollectProgram(session, split, settings, sources, table,
                              grace)
    return None

"""MergeTree projections: precomputed per-part aggregations.

The reference stores projections as nested aggregate parts inside each data
part and rewrites matching queries onto them
(src/Storages/MergeTree/MergeTreeDataSelectExecutor + ProjectionDescription,
src/Processors/QueryPlan/Optimizations/optimizeUseAggregateProjection.cpp).

Translation: a projection is a hidden table of PACKED MERGEABLE STATES
(the -State machinery) keyed by the projection's GROUP BY columns.  Each
insert into the base table appends a partially-aggregated slice; a matching
query scans the hidden table and -Merges — strictly less work than scanning
the base rows, and exact regardless of how many slices exist.  Mutations on
the base table rebuild the projection (the reference drops + rematerializes
projections on mutation too).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..core.errors import AnalysisError
from ..sql import ast

__all__ = ["ProjectionDef", "parse_projection_select", "storage_name",
           "state_column_name"]

PROJ_DB = "_projections"


@dataclasses.dataclass
class ProjectionDef:
    name: str
    key_cols: Tuple[str, ...]             # GROUP BY columns (base names)
    aggs: Tuple[Tuple[str, str], ...]     # (fn_lower, arg_col or "")
    select_text: str                      # original SELECT


def state_column_name(fn: str, arg: str) -> str:
    return f"{fn}State({arg})" if arg else f"{fn}State()"


def storage_name(db: str, table: str, proj: str) -> str:
    return f"{db}.{table}.{proj}"


def parse_projection_select(sel) -> Tuple[Tuple[str, ...],
                                          Tuple[Tuple[str, str], ...]]:
    """Validate + extract (key_cols, aggs) from a projection SELECT.

    Supported shape (covers the reference's aggregate projections):
      SELECT k1, ..., agg1(col), agg2(col), ... GROUP BY k1, ...
    """
    if not isinstance(sel, ast.Select):
        raise AnalysisError("PROJECTION must be a plain SELECT")
    if sel.from_ is not None or sel.where is not None or sel.joins:
        raise AnalysisError("PROJECTION SELECT takes no FROM/WHERE/JOIN")
    keys: List[str] = []
    for g in (sel.group_by or []):
        if not isinstance(g, ast.Identifier):
            raise AnalysisError("PROJECTION GROUP BY must list plain "
                                "columns")
        keys.append(g.name)
    aggs: List[Tuple[str, str]] = []
    for item in sel.items:
        e = item.expr
        if isinstance(e, ast.Identifier):
            if e.name not in keys:
                raise AnalysisError(
                    f"PROJECTION column '{e.name}' must be in GROUP BY")
            continue
        if isinstance(e, ast.FuncCall):
            if len(e.args) == 0:
                aggs.append((e.name.lower(), ""))
                continue
            if len(e.args) == 1 and isinstance(e.args[0], ast.Identifier):
                aggs.append((e.name.lower(), e.args[0].name))
                continue
        raise AnalysisError("PROJECTION items must be GROUP BY columns or "
                            "single-column aggregates")
    if not aggs:
        raise AnalysisError("PROJECTION needs at least one aggregate")
    return tuple(keys), tuple(aggs)

"""Bound (typed) expressions and their evaluation over blocks.

The analog of ActionsDAG -> ExpressionActions (src/Interpreters/ActionsDAG.h:51,
ExpressionActions.cpp:747): an analyzer-produced DAG of column transforms,
lowered here into a JAX computation over the block's device arrays.  Because
evaluation happens *during jit tracing*, XLA plays the role of the reference's
optional LLVM JIT fusion (src/Interpreters/JIT/compileFunction.cpp) — every
expression chain fuses into the surrounding operator for free.

Dictionary-encoded string columns carry a host-side Dictionary; string
functions compute per-code lookup tables with numpy *at trace time* (the
dictionary is query metadata, never traced) and emit only device gathers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core import dtypes as dt
from ..core.column import Column, Dictionary
from ..core.errors import TypeError_, UnknownIdentifier

__all__ = ["ColVal", "BoundExpr", "BoundColumn", "BoundLiteral", "BoundCall",
           "BoundInList", "evaluate", "colval_from_column", "colval_to_column"]


@dataclasses.dataclass
class ColVal:
    """A column value during evaluation: device data + metadata.

    data may be a full (capacity,) array or a scalar (constants broadcast
    lazily, the reference's ColumnConst analog).
    """
    dtype: dt.DType
    data: Any                          # jax array (scalar or (cap,))
    validity: Optional[Any] = None     # None = all valid
    dictionary: Optional[Dictionary] = None
    # proven integer value range (interval analysis), if known
    bounds: Optional[tuple] = None
    # Array(T): per-row element counts ((cap,) int32)
    lengths: Optional[Any] = None
    # host-side python value(s) for constants (set for literals so trace-time
    # consumers — transform, IN, range — can read them under jit)
    host: Any = None
    # Tuple values: one ColVal per element (struct-of-columns)
    sub: Optional[list] = None

    @property
    def is_const(self) -> bool:
        nd = getattr(self.data, "ndim", 0)
        if self.dtype.is_array:
            return nd <= 1
        return nd == 0

    def broadcast(self, capacity: int) -> "ColVal":
        data = self.data
        lengths = self.lengths
        if self.is_const:
            if self.dtype.is_array:
                data = jnp.broadcast_to(data, (capacity, data.shape[-1]))
                if lengths is not None and getattr(lengths, "ndim", 0) == 0:
                    lengths = jnp.broadcast_to(lengths, (capacity,))
            else:
                data = jnp.broadcast_to(data, (capacity,))
        v = self.validity
        if v is not None and getattr(v, "ndim", 0) == 0:
            v = jnp.broadcast_to(v, (capacity,))
        if data is self.data and v is self.validity \
                and lengths is self.lengths:
            return self
        return ColVal(self.dtype, data, v, self.dictionary, self.bounds,
                      lengths, sub=self.sub)


def colval_from_column(col: Column) -> ColVal:
    data = col.data
    if not col.dtype.is_dictionary and not col.dtype.is_array:
        want = dt.remove_nullable(col.dtype).jnp_dtype
        if data.dtype != want and data.dtype.kind in ("i", "u", "f"):
            # narrow physical storage (core/column.py narrow_storage): widen
            # lazily — the cast fuses into consumers, so scans stream the
            # narrow bytes at HBM roofline
            data = data.astype(want)
    return ColVal(col.dtype, data, col.validity, col.dictionary,
                  lengths=col.lengths)


def colval_to_column(cv: ColVal, capacity: int) -> Column:
    cv = cv.broadcast(capacity)
    validity = cv.validity
    if cv.dtype.nullable and validity is None:
        validity = jnp.ones((capacity,), jnp.uint8)
    if validity is not None and validity.dtype != jnp.uint8:
        validity = validity.astype(jnp.uint8)
    return Column(cv.dtype, cv.data, validity, cv.dictionary)


# -- bound expression nodes --------------------------------------------------

class BoundExpr:
    """Base: every node knows its result dtype after analysis."""
    dtype: dt.DType

    def children(self) -> Sequence["BoundExpr"]:
        return ()


@dataclasses.dataclass
class BoundColumn(BoundExpr):
    name: str
    dtype: dt.DType


@dataclasses.dataclass
class BoundLiteral(BoundExpr):
    value: Any
    dtype: dt.DType


@dataclasses.dataclass
class BoundCall(BoundExpr):
    name: str                      # resolved function name
    args: List[BoundExpr]
    dtype: dt.DType

    def children(self):
        return self.args


@dataclasses.dataclass
class BoundDictGet(BoundExpr):
    """dictGet('dict', 'attr', key): in-memory key->attribute lookup
    (reference: src/Dictionaries/ hashed layout + FunctionDictGet).

    The dictionary's data is query metadata: sorted keys + attribute values
    become device constants; the lookup is a vectorized binary search."""
    key: BoundExpr
    sorted_keys: "np.ndarray"        # host int64, sorted
    values: "np.ndarray"             # host attribute values (aligned)
    default: Any
    dtype: dt.DType

    def children(self):
        return (self.key,)


def _evaluate_dict_get(expr: "BoundDictGet", env) -> ColVal:
    k = evaluate(expr.key, env)
    keys_c = jnp.asarray(expr.sorted_keys)
    n = len(expr.sorted_keys)
    data = k.data.astype(jnp.int64)
    if n == 0:
        if expr.dtype.is_dictionary:
            d = Dictionary(np.asarray([str(expr.default)], object))
            return ColVal(expr.dtype, jnp.zeros_like(data, jnp.int32) * 0,
                          k.validity, d)
        return ColVal(expr.dtype,
                      jnp.full_like(data, expr.default,
                                    dtype=expr.dtype.jnp_dtype), k.validity)
    from ..ops.search import searchsorted as _ss
    pos = jnp.clip(_ss(keys_c, data), 0, n - 1)
    hit = keys_c[pos] == data
    if expr.dtype.is_dictionary:
        vals = np.asarray(expr.values, object)
        uniq, codes = np.unique(
            np.append(vals.astype(str), str(expr.default)),
            return_inverse=True)
        lut = jnp.asarray(codes[:-1].astype(np.int32))
        default_code = int(codes[-1])
        out = jnp.where(hit, lut[pos], default_code)
        return ColVal(expr.dtype, out, k.validity,
                      Dictionary(uniq.astype(object), sorted_=True))
    vals_c = jnp.asarray(np.asarray(expr.values)
                         .astype(expr.dtype.np_dtype))
    out = jnp.where(hit, vals_c[pos],
                    jnp.asarray(expr.default, expr.dtype.jnp_dtype))
    return ColVal(expr.dtype, out, k.validity)


@dataclasses.dataclass
class BoundArrayLambda(BoundExpr):
    """Higher-order array function: arrayMap/Filter/Exists/All/Count/Sum...

    The lambda body is an ordinary bound expression evaluated ONCE over the
    whole (rows, max_len) element matrix — the vectorized translation of the
    reference's per-row lambda loop (src/Functions/array/FunctionArrayMapped.h):
    element-wise jnp ops broadcast over the matrix, outer row columns enter
    as (rows, 1) so they broadcast across elements.
    """
    op: str                          # map|filter|exists|all|count|sum|avg|min|max|first|first_index
    param_ids: List[str]             # generated field ids of lambda params
    body: BoundExpr
    arrays: List[BoundExpr]
    dtype: dt.DType

    def children(self):
        return [self.body] + list(self.arrays)


def _evaluate_array_fold(expr: "BoundArrayLambda",
                         env: Dict[str, ColVal]) -> ColVal:
    """arrayFold(acc, x -> body, arr..., init): the one higher-order
    function whose lambda is inherently SEQUENTIAL — evaluated as a
    lax.scan over the element axis, re-tracing the bound body once with
    the accumulator carried (ref: src/Functions/array/arrayFold.cpp)."""
    init = evaluate(expr.arrays[-1], env)
    arrs = [evaluate(a, env) for a in expr.arrays[:-1]]
    cap = None
    for a in arrs + [init]:
        if not a.is_const:
            cap = a.data.shape[0]
            break
    if cap is None:
        for cv in env.values():
            if getattr(cv.data, "ndim", 0) == 1:
                cap = cv.data.shape[0]
                break
    const_out = cap is None
    if const_out:
        cap = 1
    L = max(a.data.shape[-1] for a in arrs)
    mats = []
    for a in arrs:
        m = a.data
        if m.ndim == 1:
            m = jnp.broadcast_to(m[None, :], (cap, m.shape[0]))
        if m.shape[-1] < L:
            m = jnp.pad(m, ((0, 0), (0, L - m.shape[-1])))
        mats.append(m)
    lengths = arrs[0].lengths
    if lengths is None:
        lengths = jnp.full((cap,), arrs[0].data.shape[-1], jnp.int32)
    if getattr(lengths, "ndim", 0) == 0:
        lengths = jnp.broadcast_to(jnp.asarray(lengths, jnp.int32), (cap,))
    acc0 = init.data
    if getattr(acc0, "ndim", 0) == 0:
        acc0 = jnp.broadcast_to(acc0, (cap,))
    acc0 = acc0.astype(expr.dtype.np_dtype.name)
    acc_id = expr.param_ids[0]
    elem_ids = expr.param_ids[1:]
    elem_dts = [dt.array_inner(a.dtype) for a in arrs]
    dicts = [a.dictionary for a in arrs]

    def step(acc, i):
        env2 = dict(env)
        env2[acc_id] = ColVal(expr.dtype, acc, None, init.dictionary)
        for pid, m, edt, dic in zip(elem_ids, mats, elem_dts, dicts):
            env2[pid] = ColVal(edt, m[:, i], None, dic)
        out = evaluate(expr.body, env2)
        od = out.data
        if getattr(od, "ndim", 0) == 0:
            od = jnp.broadcast_to(od, (cap,))
        new = jnp.where(i < lengths, od.astype(acc.dtype), acc)
        return new, None

    acc, _ = jax.lax.scan(step, acc0, jnp.arange(L, dtype=jnp.int32))
    if const_out:
        return ColVal(expr.dtype, acc[0], None, init.dictionary)
    return ColVal(expr.dtype, acc, init.validity, init.dictionary)


def _evaluate_array_lambda(expr: "BoundArrayLambda",
                           env: Dict[str, ColVal]) -> ColVal:
    if expr.op == "fold":
        return _evaluate_array_fold(expr, env)
    arrs = [evaluate(a, env) for a in expr.arrays]
    # row capacity: from the first non-const array, else any block column
    cap = None
    for a in arrs:
        if not a.is_const:
            cap = a.data.shape[0]
            break
    if cap is None:
        for cv in env.values():
            if getattr(cv.data, "ndim", 0) == 1:
                cap = cv.data.shape[0]
                break
    const_out = cap is None
    if const_out:
        cap = 1
    L = max(a.data.shape[-1] for a in arrs)
    mats = []
    for a in arrs:
        m = a.data
        if m.ndim == 1:
            m = jnp.broadcast_to(m[None, :], (cap, m.shape[0]))
        if m.shape[-1] < L:
            m = jnp.pad(m, ((0, 0), (0, L - m.shape[-1])))
        mats.append(m)
    lengths = arrs[0].lengths
    if lengths is None:
        lengths = jnp.full((cap,), arrs[0].data.shape[-1], jnp.int32)
    if getattr(lengths, "ndim", 0) == 0:
        lengths = jnp.broadcast_to(jnp.asarray(lengths, jnp.int32), (cap,))
    elem_ok = jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None]

    env2: Dict[str, ColVal] = {}
    for k, cv in env.items():
        nd = getattr(cv.data, "ndim", 0)
        if nd == 1:       # outer row column -> broadcast across elements
            v2 = cv.validity[:, None] if cv.validity is not None else None
            env2[k] = ColVal(cv.dtype, cv.data[:, None], v2, cv.dictionary,
                             cv.bounds)
        else:
            env2[k] = cv
    for pid, a, m in zip(expr.param_ids, arrs, mats):
        inner = dt.array_inner(a.dtype) if a.dtype.is_array else a.dtype
        env2[pid] = ColVal(inner, m, None, a.dictionary)
    out = evaluate(expr.body, env2)
    odata = out.data
    if getattr(odata, "ndim", 0) < 2:     # element-independent body
        odata = jnp.broadcast_to(jnp.asarray(odata), (cap, L)) \
            if getattr(odata, "ndim", 0) == 0 \
            else jnp.broadcast_to(odata[:, None], (cap, L))

    def finish(cv: ColVal) -> ColVal:
        if not const_out:
            return cv
        if cv.dtype.is_array:      # constant array result: 1D + scalar len
            return ColVal(cv.dtype, cv.data[0], cv.validity, cv.dictionary,
                          lengths=cv.lengths[0])
        return ColVal(cv.dtype, cv.data[0], cv.validity, cv.dictionary)

    op = expr.op
    if op == "map":
        return finish(ColVal(expr.dtype,
                             jnp.where(elem_ok, odata,
                                       jnp.zeros((), odata.dtype)),
                             None, out.dictionary, lengths=lengths))
    if op == "filter":
        keep = elem_ok & (odata != 0)
        src = mats[0]
        # stable per-row compaction: sort each row by drop-flag (kept
        # elements first, original order preserved)
        drop = jnp.logical_not(keep).astype(jnp.int32)
        _, compact = jax.lax.sort([drop, src], num_keys=1, is_stable=True,
                                  dimension=-1)
        new_len = jnp.sum(keep, axis=-1).astype(jnp.int32)
        zero = jnp.zeros((), compact.dtype)
        compact = jnp.where(
            jnp.arange(L, dtype=jnp.int32)[None, :] < new_len[:, None],
            compact, zero)
        return finish(ColVal(expr.dtype, compact, None,
                             arrs[0].dictionary, lengths=new_len))
    pred = elem_ok & (odata != 0)
    if op == "exists":
        return finish(ColVal(expr.dtype,
                             jnp.any(pred, axis=-1).astype(jnp.uint8), None))
    if op == "all":
        ok = jnp.all(jnp.logical_not(elem_ok) | (odata != 0), axis=-1)
        return finish(ColVal(expr.dtype, ok.astype(jnp.uint8), None))
    if op == "count":
        return finish(ColVal(expr.dtype,
                             jnp.sum(pred, axis=-1).astype(jnp.uint64),
                             None))
    if op == "sum":
        acc = odata.astype(expr.dtype.jnp_dtype)
        s = jnp.sum(jnp.where(elem_ok, acc, jnp.zeros((), acc.dtype)),
                    axis=-1)
        return finish(ColVal(expr.dtype, s, None))
    if op == "first_index":
        idx = jnp.argmax(pred, axis=-1).astype(jnp.uint32) + 1
        has = jnp.any(pred, axis=-1)
        return finish(ColVal(expr.dtype,
                             jnp.where(has, idx, 0).astype(jnp.uint32),
                             None))
    if op == "last_index":
        rev = jnp.flip(pred, axis=-1)
        idx = (L - jnp.argmax(rev, axis=-1)).astype(jnp.uint32)
        has = jnp.any(pred, axis=-1)
        return finish(ColVal(expr.dtype,
                             jnp.where(has, idx, 0).astype(jnp.uint32),
                             None))
    if op in ("first", "first_or_null", "last", "last_or_null"):
        p = pred if op.startswith("first") else jnp.flip(pred, axis=-1)
        src = mats[0] if op.startswith("first") \
            else jnp.flip(mats[0], axis=-1)
        idx = jnp.argmax(p, axis=-1)
        has = jnp.any(p, axis=-1)
        val = jnp.take_along_axis(src, idx[:, None], axis=-1)[:, 0]
        default = jnp.asarray(-1, val.dtype) if arrs[0].dictionary \
            is not None else jnp.zeros((), val.dtype)
        data = jnp.where(has, val, default)
        validity = has.astype(jnp.uint8) if op.endswith("null") else None
        return finish(ColVal(expr.dtype, data, validity,
                             arrs[0].dictionary))
    if op in ("min", "max", "avg"):
        acc = odata.astype(jnp.float64) if op == "avg" \
            else odata
        if op == "min":
            big = jnp.asarray(jnp.finfo(acc.dtype).max
                              if jnp.issubdtype(acc.dtype, jnp.floating)
                              else jnp.iinfo(acc.dtype).max, acc.dtype)
            out_v = jnp.min(jnp.where(elem_ok, acc, big), axis=-1)
            out_v = jnp.where(jnp.any(elem_ok, axis=-1), out_v,
                              jnp.zeros((), acc.dtype))
            return finish(ColVal(expr.dtype, out_v, None, out.dictionary))
        if op == "max":
            small = jnp.asarray(jnp.finfo(acc.dtype).min
                                if jnp.issubdtype(acc.dtype, jnp.floating)
                                else jnp.iinfo(acc.dtype).min, acc.dtype)
            out_v = jnp.max(jnp.where(elem_ok, acc, small), axis=-1)
            out_v = jnp.where(jnp.any(elem_ok, axis=-1), out_v,
                              jnp.zeros((), acc.dtype))
            return finish(ColVal(expr.dtype, out_v, None, out.dictionary))
        s = jnp.sum(jnp.where(elem_ok, acc, 0.0), axis=-1)
        n = jnp.maximum(jnp.sum(elem_ok, axis=-1), 1)
        return finish(ColVal(expr.dtype, s / n, None))
    if op in ("sort", "rsort"):
        # sort row elements by the lambda key; invalid slots ride last
        key = odata
        enc = key.astype(jnp.float64)
        if op == "rsort":
            enc = -enc
        big = jnp.asarray(jnp.finfo(jnp.float64).max)
        enc = jnp.where(elem_ok, enc, big)
        _, sorted_src = jax.lax.sort([enc, mats[0]], num_keys=1,
                                     is_stable=True, dimension=-1)
        zero = jnp.zeros((), sorted_src.dtype)
        sorted_src = jnp.where(elem_ok, sorted_src, zero)
        return finish(ColVal(expr.dtype, sorted_src, None,
                             arrs[0].dictionary, lengths=lengths))
    if op in ("fill", "rfill"):
        # arrayFill: where the predicate is FALSE, carry the nearest
        # preceding (following for reverse) element whose predicate holds
        iota = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :],
                                pred.shape)
        if op == "fill":
            marked = jnp.where(pred, iota, jnp.int32(-1))
            src_idx = jax.lax.associative_scan(jnp.maximum, marked,
                                               axis=-1)
        else:
            marked = jnp.where(pred, iota, jnp.int32(2**30))
            src_idx = jnp.flip(jax.lax.associative_scan(
                jnp.minimum, jnp.flip(marked, axis=-1), axis=-1), axis=-1)
        ok_idx = (src_idx >= 0) & (src_idx < L)
        gath = jnp.take_along_axis(
            mats[0], jnp.clip(src_idx, 0, L - 1), axis=-1)
        data = jnp.where(ok_idx, gath, mats[0])
        zero = jnp.zeros((), data.dtype)
        data = jnp.where(elem_ok, data, zero)
        return finish(ColVal(expr.dtype, data, None, arrs[0].dictionary,
                             lengths=lengths))
    if op in ("cumsum", "cumsum_nonneg"):
        inner = dt.array_inner(dt.remove_nullable(expr.dtype))
        acc = odata.astype(inner.jnp_dtype)
        acc = jnp.where(elem_ok, acc, jnp.zeros((), acc.dtype))
        if op == "cumsum":
            data = jnp.cumsum(acc, axis=-1, dtype=acc.dtype)
        else:
            def step(carry, x):
                nxt = jnp.maximum(carry + x, jnp.zeros((), x.dtype))
                return nxt, nxt
            _, data = jax.lax.scan(step,
                                   jnp.zeros(acc.shape[0], acc.dtype),
                                   acc.T)
            data = data.T
        zero = jnp.zeros((), data.dtype)
        data = jnp.where(elem_ok, data, zero)
        return finish(ColVal(expr.dtype, data, None, lengths=lengths))
    raise TypeError_(f"Unknown array lambda op '{op}'")


@dataclasses.dataclass
class BoundInList(BoundExpr):
    """expr IN (v1, v2, ...) with a materialized host-side value set.

    The reference builds IN-sets eagerly as Set objects
    (src/Interpreters/Set.cpp); here the set becomes a device constant and
    membership is a vectorized isin.
    """
    arg: BoundExpr
    values: "np.ndarray"           # host values (numeric or object strings)
    negated: bool
    dtype: dt.DType

    def children(self):
        return (self.arg,)


def evaluate(expr: BoundExpr, env: Dict[str, ColVal]) -> ColVal:
    """Evaluate a bound expression against a block environment.

    env maps column name -> ColVal.  Runs under jit tracing; host-side numpy
    work on dictionaries executes at trace time.
    """
    if isinstance(expr, BoundColumn):
        if expr.name not in env:
            raise UnknownIdentifier(f"Column '{expr.name}' not in block "
                                    f"(have: {list(env)})")
        return env[expr.name]
    if isinstance(expr, BoundLiteral):
        return _literal_colval(expr)
    if isinstance(expr, BoundCall):
        from . import functions
        fn = functions.get(expr.name)
        args = [evaluate(a, env) for a in expr.args]
        if getattr(fn, "wants_row_mask", False):
            return fn.execute(args, expr.dtype,
                              row_mask=env.get("__row_valid__"))
        return fn.execute(args, expr.dtype)
    if isinstance(expr, BoundInList):
        return _evaluate_in_list(expr, env)
    if isinstance(expr, BoundDictGet):
        return _evaluate_dict_get(expr, env)
    if isinstance(expr, BoundArrayLambda):
        return _evaluate_array_lambda(expr, env)
    raise TypeError_(f"Cannot evaluate expression node {expr!r}")


def _evaluate_in_list(expr: "BoundInList", env: Dict[str, ColVal]) -> ColVal:
    arg = evaluate(expr.arg, env)
    vals = expr.values
    if arg.dtype.is_dictionary:
        d = arg.dictionary
        codes = [d.lookup(str(v)) for v in vals] if d is not None else []
        codes = [c for c in codes if c >= 0]
        set_arr = jnp.asarray(np.asarray(codes, np.int32)) if codes else None
        data = arg.data
    else:
        t0 = dt.remove_nullable(arg.dtype)
        clean = [v for v in vals if v is not None]
        if clean:
            from ..core import typed
            if typed.needs_decode(t0):
                enc = typed.encode_for_storage(
                    t0, np.asarray(clean, object))
                set_arr = jnp.asarray(enc)
            else:
                set_arr = jnp.asarray(np.asarray(clean).astype(t0.np_dtype))
        else:
            set_arr = None
        data = arg.data
    if set_arr is None:
        member = jnp.zeros(getattr(data, "shape", (1,)), jnp.bool_)
    else:
        member = jnp.isin(data, set_arr)
    if expr.negated:
        member = jnp.logical_not(member)
        if arg.validity is not None:
            # NULL NOT IN (...) stays NULL-ish: mask as invalid below
            pass
    return ColVal(expr.dtype, member.astype(jnp.uint8), arg.validity)


def _literal_colval(expr: BoundLiteral) -> ColVal:
    v = expr.value
    t = expr.dtype
    if v is None:
        return ColVal(t, jnp.zeros((), t.jnp_dtype), jnp.zeros((), jnp.uint8))
    if t.is_dictionary:
        d = Dictionary(np.asarray([v], dtype=object))
        # np-backed concrete zero (jnp.zeros would trace under jit and hide
        # the constant from trace-time consumers)
        return ColVal(t, jnp.asarray(np.int32(0)), None, d, host=v)
    bounds = (int(v), int(v)) if isinstance(v, (int, np.integer)) \
        and not isinstance(v, bool) else None
    return ColVal(t, jnp.asarray(v, t.jnp_dtype), bounds=bounds, host=v)

"""Device-resident columns.

The device-array analog of the reference's ``IColumn`` hierarchy
(src/Columns/IColumn.h:80).  Differences, by design (SURVEY.md §7):

* Arrays are immutable JAX buffers — COW is free.
* Shapes are static: a column owns a padded device array of ``capacity``
  elements; the number of *valid* rows is tracked by the enclosing Block.
* Strings are dictionary codes (int32) on device + a host-side numpy array of
  the unique values (the reference's ColumnLowCardinality made mandatory).
* Nullability is a separate uint8 validity mask (1 = valid), mirroring
  ColumnNullable's null-map (src/Columns/ColumnNullable.h) but kept as its own
  device array.

The vectorized primitives of IColumn (filter/permute/index/replicate,
src/Columns/IColumn.h:314,327,331,440) live in ``clickhouse_tpu.ops`` as
whole-column JAX/Pallas transforms; a Column is pure data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import dtypes as dt

__all__ = ["Column", "Dictionary", "column_from_numpy", "PAD_MULTIPLE", "pad_to"]

# Pad every column's capacity up to a multiple of this, so that tables of
# nearby row counts share array shapes and hit the same compiled program.
PAD_MULTIPLE = 1024


def pad_to(n: int, multiple: int = PAD_MULTIPLE) -> int:
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


class Dictionary:
    """Host-side dictionary for String columns: unique byte strings.

    values[code] -> python str.  Code -1 is reserved for NULL at the storage
    boundary (device-side NULLs use the validity mask).

    `sorted_` marks dictionaries produced by np.unique (lexicographically
    sorted): lookups become binary searches, rank LUTs become identity, and
    unify against small dictionaries vectorizes — the properties that keep
    100M-distinct string columns tractable.

    `device_bytes()` exposes the values as a device-resident fixed-width
    byte matrix — the device ColumnString (reference: offsets+chars
    src/Columns/ColumnString.h): hot string predicates (startsWith /
    LIKE 'p%' / equality) compute per-UNIQUE on the device and reach rows
    through the code gather, so per-row work never leaves the chip.
    """

    __slots__ = ("values", "_index", "sorted_", "_values_str",
                 "_dev_bytes", "_dev_rev", "_hash_sorted")

    # device byte-matrix width cap (prefix ops beyond this fall back to host)
    DEVICE_BYTES_MAX_W = 64
    # byte budget for device-resident dictionary bytes
    DEVICE_BYTES_BUDGET = 4 << 30

    def __init__(self, values: np.ndarray, sorted_: bool = False):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[dict] = None
        self.sorted_ = sorted_
        self._values_str: Optional[np.ndarray] = None
        self._dev_bytes = None
        self._dev_rev = None
        # hash-token dictionaries (factorize_strings): uniq CityHash128
        # tokens sorted as (lo, hi) structs, aligned with `values` — lookups
        # hash the needle and binary-search here instead of building a
        # python dict over tens of millions of entries
        self._hash_sorted: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.values)

    def values_str(self) -> np.ndarray:
        """Cached numpy-U view of the values (C-speed vectorized ops)."""
        if self._values_str is None:
            self._values_str = self.values.astype(str)
        return self._values_str

    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def lookup(self, value: str) -> int:
        """Code for value, or -1 if absent."""
        if self.sorted_ and len(self) > 4096:
            vs = self.values_str()
            i = int(np.searchsorted(vs, value))
            return i if i < len(vs) and vs[i] == value else -1
        if self._hash_sorted is not None:
            hv = _hash_struct(hash_tokens128(
                np.asarray([value], object)))[0]
            i = int(np.searchsorted(self._hash_sorted, hv))
            return i if i < len(self.values) \
                and self._hash_sorted[i] == hv else -1
        return self.index().get(value, -1)

    # -- device byte matrix (device ColumnString view) ------------------------
    # Cached as HOST numpy (trace-safe); jnp conversion happens at each use
    # site, where XLA hoists the matrix as a program constant — one buffer
    # per compiled program, resident on the device across calls.
    def device_bytes(self):
        """-> (u8 matrix (U, W) np, byte lengths (U,) np int32, W) or
        None when over budget."""
        if self._dev_bytes is not None:
            return self._dev_bytes or None
        u = max(len(self), 1)
        enc = np.char.encode(self.values_str(), "utf-8") \
            if len(self) else np.asarray([b""], "S1")
        full_w = max(enc.dtype.itemsize, 1)
        w = min(full_w, self.DEVICE_BYTES_MAX_W)
        if u * w > self.DEVICE_BYTES_BUDGET:
            self._dev_bytes = False
            return None
        lens = np.char.str_len(enc).astype(np.int32)
        mat = enc.view(np.uint8).reshape(u, full_w)[:, :w]
        self._dev_bytes = (np.ascontiguousarray(mat), lens, w)
        return self._dev_bytes

    def device_bytes_reversed(self):
        """Per-value byte-reversed matrix (endsWith / LIKE '%suffix')."""
        if self._dev_rev is not None:
            return self._dev_rev or None
        db = self.device_bytes()
        if db is None:
            self._dev_rev = False
            return None
        mat, lens, w = db
        idx = np.clip(lens[:, None] - 1
                      - np.arange(w, dtype=np.int32)[None, :], 0, w - 1)
        rev = np.take_along_axis(mat, idx, axis=1)
        rev = np.where(np.arange(w)[None, :] < lens[:, None], rev, 0) \
            .astype(np.uint8)
        self._dev_rev = (rev, lens, w)
        return self._dev_rev

    @staticmethod
    def unify(a: "Dictionary", b: "Dictionary"):
        """Merged dictionary + recode tables (host-side, numpy).

        Returns (merged, recode_a, recode_b) where recode_x maps old codes to
        merged codes.  Mirrors ColumnLowCardinality dictionary merging on
        insertRangeFrom (src/Columns/ColumnLowCardinality.cpp).
        """
        if a is b:
            n = len(a)
            ident = np.arange(n, dtype=np.int32)
            return a, ident, ident
        if a.sorted_ and len(a) >= 4096 and len(b) * 16 < len(a):
            # vectorized path: binary-search the small side into the big
            # sorted side; misses append at the tail (big dict stays intact
            # so its cached device bytes/index survive)
            va = a.values_str()
            vb = b.values_str() if len(b) else np.zeros(0, str)
            pos = np.searchsorted(va, vb).clip(0, len(va) - 1) \
                if len(va) else np.zeros(len(vb), np.int64)
            found = (va[pos] == vb) if len(va) else np.zeros(len(vb), bool)
            recode_b = np.where(found, pos, 0).astype(np.int32)
            miss = ~found
            if miss.any():
                extra = vb[miss]
                merged = Dictionary(np.concatenate(
                    [a.values, extra.astype(object)]))
                recode_b[miss] = len(a) + np.arange(int(miss.sum()),
                                                    dtype=np.int32)
            else:
                merged = a
            return merged, np.arange(len(a), dtype=np.int32), recode_b
        merged_vals = list(a.values)
        idx = dict(a.index())
        recode_b = np.empty(len(b), dtype=np.int32)
        for i, v in enumerate(b.values):
            j = idx.get(v)
            if j is None:
                j = len(merged_vals)
                merged_vals.append(v)
                idx[v] = j
            recode_b[i] = j
        merged = Dictionary(np.asarray(merged_vals, dtype=object))
        merged._index = idx
        recode_a = np.arange(len(a), dtype=np.int32)
        return merged, recode_a, recode_b


@dataclasses.dataclass
class Column:
    """A typed, padded device array (+ optional validity, dictionary).

    Array(T) columns hold data of shape (capacity, max_len) plus per-row
    `lengths` — the reference's size0+data substreams with a static width.
    """

    dtype: dt.DType
    data: jax.Array                      # (capacity,) or (capacity, max_len)
    validity: Optional[jax.Array] = None  # shape (capacity,), uint8, 1=valid
    dictionary: Optional[Dictionary] = None
    lengths: Optional[jax.Array] = None   # (capacity,) int32, arrays only

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def with_data(self, data, validity="__keep__") -> "Column":
        v = self.validity if validity == "__keep__" else validity
        return Column(self.dtype, data, v, self.dictionary)

    # -- host transfer -------------------------------------------------------
    def to_numpy(self, num_rows: Optional[int] = None) -> np.ndarray:
        """Materialize valid rows on host as a numpy array (decoded)."""
        raw = np.asarray(jax.device_get(self.data))
        if not self.dtype.is_dictionary and not self.dtype.is_array:
            want = dt.remove_nullable(self.dtype).np_dtype
            if raw.dtype != want and raw.dtype.kind in ("i", "u", "f"):
                raw = raw.astype(want)      # widen narrow physical storage
        if num_rows is not None:
            raw = raw[:num_rows]
        if self.dtype.is_array:
            lens = np.asarray(jax.device_get(self.lengths))
            if num_rows is not None:
                lens = lens[:num_rows]
            out = np.empty(len(raw), object)
            for i in range(len(raw)):
                out[i] = list(raw[i][:lens[i]])
            return out
        if self.dtype.is_dictionary:
            assert self.dictionary is not None
            codes = raw.astype(np.int64)
            out = np.empty(len(codes), dtype=object)
            valid_codes = codes >= 0
            out[valid_codes] = self.dictionary.values[codes[valid_codes]]
            out[~valid_codes] = None
            raw = out
        if self.dtype.nullable and self.validity is not None:
            mask = np.asarray(jax.device_get(self.validity))
            if num_rows is not None:
                mask = mask[:num_rows]
            out = raw.astype(object) if raw.dtype != object else raw.copy()
            out[mask == 0] = None
            return out
        return raw


def narrow_storage(data_np: np.ndarray) -> np.ndarray:
    """Pick the narrowest exact physical dtype for a host column.

    A scan is bound by the bytes it reads, so columns store the narrowest
    width that holds their min/max; scans widen lazily (the cast fuses into consumers).  The moral
    equivalent of the reference's T64 codec (src/Compression/
    CompressionCodecT64.cpp) applied at the memory layout level.
    """
    k = data_np.dtype.kind
    if k == "i" and data_np.dtype.itemsize > 1 and len(data_np):
        lo, hi = int(data_np.min()), int(data_np.max())
        for cand in (np.int8, np.int16, np.int32):
            info = np.iinfo(cand)
            if cand().itemsize < data_np.dtype.itemsize \
                    and info.min <= lo and hi <= info.max:
                return data_np.astype(cand)
    elif k == "u" and data_np.dtype.itemsize > 1 and len(data_np):
        hi = int(data_np.max())
        for cand in (np.uint8, np.uint16, np.uint32):
            if cand().itemsize < data_np.dtype.itemsize \
                    and hi <= np.iinfo(cand).max:
                return data_np.astype(cand)
    elif data_np.dtype == np.float64 and len(data_np):
        with np.errstate(over="ignore"):     # beyond f32: not lossless
            f32 = data_np.astype(np.float32)
        if np.array_equal(f32.astype(np.float64), data_np):
            return f32
    return data_np


# above this many rows, string factorization switches from the
# lexicographic np.unique (a full string sort) to 128-bit hash tokens:
# CityHash128 per row at C speed, unique/inverse over the 16-byte hashes,
# representative values gathered at first occurrence.  This is what keeps
# ~100M-row / ~50M-distinct string GROUP BY off the host sort path — the
# grouping itself always runs on device over the int32 codes (reference:
# src/Columns/ColumnString.h ColumnString + low-cardinality hash grouping).
# Known caveat: strings differing only in TRAILING NUL bytes ('a' vs
# 'a\x00') share a hash token (the fixed-width 'S' encoding trims them).
HASH_FACTORIZE_MIN_ROWS = 8_000_000


def hash_tokens128(values: np.ndarray) -> np.ndarray:
    """(n, 2) uint64 CityHash128 tokens of a string array (C loop)."""
    from ..native import cityhash128_rows
    try:
        s = values.astype(bytes)               # ascii fast path
    except (UnicodeEncodeError, UnicodeDecodeError, ValueError):
        s = np.char.encode(values.astype(str), "utf-8")
    if s.dtype.itemsize == 0:
        s = s.astype("S1")
    return cityhash128_rows(s)


def _hash_struct(h: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(h).view(
        [("lo", "<u8"), ("hi", "<u8")]).reshape(-1)


def factorize_strings(values: np.ndarray):
    """-> (codes int32 (n,), Dictionary).  Sorted-unique for small inputs;
    hash-token factorization beyond HASH_FACTORIZE_MIN_ROWS."""
    n = len(values)
    if n < HASH_FACTORIZE_MIN_ROWS:
        uniq, codes = np.unique(values.astype(str), return_inverse=True)
        return codes.astype(np.int32), \
            Dictionary(uniq.astype(object), sorted_=True)
    hv = _hash_struct(hash_tokens128(values))
    uniq_h, first, codes = np.unique(hv, return_index=True,
                                     return_inverse=True)
    uniq = np.asarray(values[first], object)
    dic = Dictionary(uniq, sorted_=False)
    dic._hash_sorted = uniq_h          # hash->code lookups stay O(log U)
    return codes.astype(np.int32), dic


def column_from_numpy(values: np.ndarray, dtype: Optional[dt.DType] = None,
                      capacity: Optional[int] = None) -> Column:
    """Build a Column from host data, dictionary-encoding strings.

    Host-side ingest path — the analog of reference format parsers producing
    IColumn (src/Processors/Formats/IInputFormat.h:20) but targeting device
    arrays with padded static shapes.
    """
    values = np.asarray(values)
    n = len(values)
    cap = capacity or pad_to(n)

    # AggregateFunction(...): object array of bytes -> (cap, B) uint8
    if dtype is not None and dtype.agg_state is not None:
        widths = [len(v) for v in values if isinstance(v, (bytes, bytearray))]
        if widths:
            B = max(widths)
        else:
            from ..exprs.aggregates import make_merge_for_dtype
            from ..exprs.aggregates import state_width_bytes
            B = state_width_bytes(make_merge_for_dtype(dtype).spec)
        mat = np.zeros((cap, B), np.uint8)
        for i, v in enumerate(values):
            if isinstance(v, (bytes, bytearray)):
                mat[i, :len(v)] = np.frombuffer(bytes(v), np.uint8)
        return Column(dtype, jnp.asarray(mat), None)

    # Array(T): uniform 2-D numeric matrix fast path (vector columns —
    # 10M x 128 embeddings must not take a per-element python loop)
    if values.ndim == 2 and values.dtype != object \
            and (dtype is None or dtype.is_array):
        if dtype is None:
            inner0 = dt.Float64 if values.dtype.kind == "f" else dt.Int64
            dtype = dt.Array(inner0)
        inner = dt.array_inner(dtype)
        d = values.shape[1]
        max_len = max(((d + 7) // 8) * 8, 8)
        mat = np.zeros((cap, max_len), inner.np_dtype)
        mat[:n, :d] = values.astype(inner.np_dtype, copy=False)
        lens = np.zeros(cap, np.int32)
        lens[:n] = d
        return Column(dtype, jnp.asarray(mat), None,
                      lengths=jnp.asarray(lens))

    # Array(T): object array of python lists -> (cap, max_len) + lengths
    if (dtype is not None and dtype.is_array) or (
            values.dtype == object and n > 0
            and all(isinstance(v, (list, tuple, np.ndarray))
                    for v in values)):
        lists = [list(v) if v is not None else [] for v in values]
        max_len = max((len(v) for v in lists), default=0)
        max_len = max(((max_len + 7) // 8) * 8, 8)
        if dtype is None:
            flat = [x for v in lists for x in v]
            inner = dt.String if any(isinstance(x, str) for x in flat) \
                else (dt.Float64 if any(isinstance(x, float) for x in flat)
                      else dt.Int64)
            dtype = dt.Array(inner)
        inner = dt.array_inner(dtype)
        lens = np.zeros(cap, np.int32)
        lens[:n] = [len(v) for v in lists]
        if inner.is_dictionary:
            flat_vals = np.asarray([str(x) for v in lists for x in v] or [""],
                                   object)
            uniq, codes = np.unique(flat_vals.astype(str),
                                    return_inverse=True)
            mat = np.zeros((cap, max_len), np.int32)
            pos = 0
            for i, v in enumerate(lists):
                k = len(v)
                mat[i, :k] = codes[pos:pos + k]
                pos += k
            return Column(dtype, jnp.asarray(mat), None,
                          Dictionary(uniq.astype(object), sorted_=True),
                          lengths=jnp.asarray(lens))
        mat = np.zeros((cap, max_len), inner.np_dtype)
        for i, v in enumerate(lists):
            if v:
                mat[i, :len(v)] = np.asarray(v, inner.np_dtype)
        return Column(dtype, jnp.asarray(mat), None,
                      lengths=jnp.asarray(lens))

    validity_np = None
    if values.dtype == object:
        none_mask = np.array([v is None for v in values], dtype=bool)
        if none_mask.any():
            validity_np = (~none_mask).astype(np.uint8)
            # Replace Nones with a placeholder for encoding below.
            values = values.copy()
            sample = next((v for v in values if v is not None), "")
            values[none_mask] = sample if isinstance(sample, str) else 0
        # All-string object arrays -> String; temporal objects -> epoch
        # storage; else numeric object -> float64
        import datetime as _dtime
        if all(isinstance(v, str) for v in values):
            values = values.astype(object)
        elif len(values) and all(isinstance(v, (_dtime.datetime,
                                                _dtime.date)) for v in values):
            import calendar as _cal
            scale = 1
            if dtype is not None and dtype.name.startswith("DateTime64"):
                scale = 10 ** (dtype.decimal_scale or 3)

            def to_num(v):
                if isinstance(v, _dtime.datetime):
                    return int(_cal.timegm(v.timetuple())) * scale \
                        + (v.microsecond * scale // 1_000_000)
                return (v - _dtime.date(1970, 1, 1)).days
            values = np.asarray([to_num(v) for v in values], np.int64)
        else:
            values = values.astype(np.float64)

    if values.dtype.kind in ("U", "S", "O"):
        if dtype is None:
            dtype = dt.String
        codes, dic = factorize_strings(values)
        data_np = np.full(cap, -1, dtype=np.int32)
        data_np[:n] = codes
        col = Column(dtype if validity_np is None else dt.make_nullable(dtype),
                     jnp.asarray(data_np), dictionary=dic)
    else:
        if dtype is None:
            if values.dtype.kind == "b":
                dtype = dt.Boolean
                values = values.astype(np.uint8)
            else:
                dtype = dt.from_numpy_dtype(values.dtype)
        storage = dtype.np_dtype
        data_np = np.zeros(cap, dtype=storage)
        data_np[:n] = values.astype(storage)
        data_np = narrow_storage(data_np)
        col = Column(dtype if validity_np is None else dt.make_nullable(dtype),
                     jnp.asarray(data_np))

    if validity_np is not None:
        v = np.zeros(cap, dtype=np.uint8)
        v[:n] = validity_np
        col.validity = jnp.asarray(v)
    elif col.dtype.nullable:
        v = np.zeros(cap, dtype=np.uint8)
        v[:n] = 1
        col.validity = jnp.asarray(v)
    return col

"""In-memory columnar tables built from immutable parts.

The MergeTree skeleton (reference: src/Storages/MergeTree/):
INSERT creates an immutable *part*; parts carry per-column min/max statistics
used for pruning (the reference's minmax index + KeyCondition,
src/Storages/MergeTree/KeyCondition.cpp).  Device residency: part columns are
host numpy until first scan, then cached on device as one concatenated padded
block (granule streaming comes with the out-of-core path).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..core import dtypes as dt
from ..core.block import Block, block_from_pydict
from ..core.column import Column, Dictionary, column_from_numpy, pad_to
from ..core.errors import AnalysisError, EngineError, UnknownTable

__all__ = ["Part", "Table", "Database", "Catalog", "SkipIndex"]


@dataclasses.dataclass(frozen=True)
class SkipIndex:
    """Granule skip index declaration (reference:
    src/Storages/MergeTree/MergeTreeIndices.h).  Only single-column index
    expressions participate in pruning; others are stored but inert.
    granularity counts index granules of ``index_granularity`` rows each."""
    name: str
    column: Optional[str]              # None for unsupported expressions
    kind: str                          # minmax | set | bloom_filter | ...
    params: tuple = ()
    granularity: int = 1


@dataclasses.dataclass
class Part:
    """Immutable sorted-insert unit (IMergeTreeDataPart analog)."""
    columns: Dict[str, np.ndarray]       # host values (object for strings)
    num_rows: int
    minmax: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    # lazy per-column uniqueness stat (None = not computed yet)
    _unique: Dict[str, bool] = dataclasses.field(default_factory=dict)

    # columns larger than this skip the uniqueness stat (host np.unique cost)
    UNIQUE_STAT_MAX_ROWS = 64_000_000

    def is_unique(self, name: str) -> Optional[bool]:
        """True iff this part's values in `name` are all distinct (the
        planner's N:1-join statistic; computed lazily, cached).  None when
        unknown (too large / non-numeric)."""
        if name in self._unique:
            return self._unique[name]
        v = self.columns.get(name)
        if v is None or v.dtype == object \
                or v.dtype.kind not in ("i", "u", "f") \
                or len(v) > self.UNIQUE_STAT_MAX_ROWS:
            return None
        u = bool(len(np.unique(v)) == len(v))
        self._unique[name] = u
        return u

    def f32_lossless(self, name: str) -> bool:
        """True iff this part's float64 column round-trips through float32
        (narrow-storage eligibility; lazy, cached)."""
        cache = getattr(self, "_f32_ok", None)
        if cache is None:
            cache = self._f32_ok = {}
        if name in cache:
            return cache[name]
        v = self.columns.get(name)
        ok = False
        if v is not None and v.dtype == np.float64:
            ok = bool(np.array_equal(v.astype(np.float32).astype(np.float64),
                                     v, equal_nan=True))
        cache[name] = ok
        return ok

    # -- granule summaries (skip-index backing) --------------------------------
    # One summary per `granule_rows` span of this part; computed lazily and
    # cached (merged parts get fresh summaries automatically).  Reference:
    # MergeTreeDataPartWriterWide writes index blocks per granularity step
    # (src/Storages/MergeTree/MergeTreeDataPartWriterWide.h:20).

    def _granule_cache_get(self, key):
        cache = getattr(self, "_granules", None)
        if cache is None:
            cache = self._granules = {}
        return cache, cache.get(key)

    def granule_minmax(self, name: str, granule_rows: int):
        """-> list of (min, max) per granule, or None if unsupported."""
        cache, hit = self._granule_cache_get(("minmax", name, granule_rows))
        if hit is not None:
            return hit
        v = self.columns.get(name)
        if v is None or v.dtype == object or v.dtype.kind not in "iuf" \
                or not len(v):
            return None
        out = []
        for lo in range(0, self.num_rows, granule_rows):
            g = v[lo:lo + granule_rows]
            out.append((g.min(), g.max()))
        cache[("minmax", name, granule_rows)] = out
        return out

    # set(N) summaries with more distinct values than this are recorded as
    # None (no pruning from that granule), like the reference's max_rows=0
    SET_INDEX_DEFAULT_MAX = 1024

    def granule_sets(self, name: str, granule_rows: int, max_values: int):
        """-> list of frozenset per granule (None = too many distinct)."""
        key = ("set", name, granule_rows, max_values)
        cache, hit = self._granule_cache_get(key)
        if hit is not None:
            return hit
        v = self.columns.get(name)
        if v is None or not len(v):
            return None
        out = []
        for lo in range(0, self.num_rows, granule_rows):
            g = v[lo:lo + granule_rows]
            if g.dtype == object:
                uniq = set(x for x in g.tolist())
            else:
                u = np.unique(g)
                if len(u) > max_values:
                    out.append(None)
                    continue
                uniq = set(u.tolist())
            out.append(frozenset(uniq) if len(uniq) <= max_values else None)
        cache[key] = out
        return out

    BLOOM_BITS = 4096                  # per-granule bitset width
    _BLOOM_HASHES = 3

    @staticmethod
    def _bloom_positions(values) -> np.ndarray:
        """Deterministic k-hash bit positions for each value (splitmix64
        avalanche over a stable per-value u64)."""
        h = np.zeros(len(values), np.uint64)
        for i, x in enumerate(values):
            if x is None:
                continue
            if isinstance(x, (bytes, str)):
                import zlib
                b = x.encode() if isinstance(x, str) else x
                h[i] = np.uint64(zlib.crc32(b)) | (np.uint64(
                    zlib.adler32(b)) << np.uint64(32))
            elif isinstance(x, float) and not float(x).is_integer():
                h[i] = np.float64(x).view(np.uint64)
            else:
                h[i] = np.uint64(np.int64(x))
        pos = np.empty((len(values), Part._BLOOM_HASHES), np.int64)
        z = h.copy()
        for k in range(Part._BLOOM_HASHES):
            z = z + np.uint64(0x9E3779B97F4A7C15)
            t = z
            t = (t ^ (t >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            t = (t ^ (t >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            t = t ^ (t >> np.uint64(31))
            pos[:, k] = (t % np.uint64(Part.BLOOM_BITS)).astype(np.int64)
        return pos

    def granule_blooms(self, name: str, granule_rows: int):
        """-> list of per-granule bloom bitsets (np.bool_(BLOOM_BITS,))."""
        key = ("bloom", name, granule_rows)
        cache, hit = self._granule_cache_get(key)
        if hit is not None:
            return hit
        v = self.columns.get(name)
        if v is None or not len(v):
            return None
        out = []
        for lo in range(0, self.num_rows, granule_rows):
            g = v[lo:lo + granule_rows]
            vals = (list(dict.fromkeys(g.tolist())) if g.dtype == object
                    else np.unique(g).tolist())
            bits = np.zeros(Part.BLOOM_BITS, bool)
            if vals:
                pos = Part._bloom_positions(vals)
                bits[pos.reshape(-1)] = True
            out.append(bits)
        cache[key] = out
        return out

    @staticmethod
    def _tokenize(s: str):
        """Alphanumeric token split (reference TokenExtractor,
        src/Interpreters/ITokenExtractor.h)."""
        import re
        return re.findall(r"[0-9A-Za-z_]+", s)

    def granule_token_blooms(self, name: str, granule_rows: int,
                             ngram: Optional[int] = None):
        """Per-granule bloom bitsets over string TOKENS (tokenbf_v1 /
        full_text) or character n-grams (ngrambf_v1) — reference:
        MergeTreeIndexBloomFilterText granule builder."""
        key = ("tokbloom", name, granule_rows, ngram)
        cache, hit = self._granule_cache_get(key)
        if hit is not None:
            return hit
        v = self.columns.get(name)
        if v is None or v.dtype != object or not len(v):
            return None
        out = []
        for lo in range(0, self.num_rows, granule_rows):
            toks = set()
            for s in v[lo:lo + granule_rows].tolist():
                if not isinstance(s, str):
                    continue
                if ngram:
                    for i in range(len(s) - ngram + 1):
                        toks.add(s[i:i + ngram])
                else:
                    toks.update(Part._tokenize(s))
            bits = np.zeros(Part.BLOOM_BITS, bool)
            if toks:
                pos = Part._bloom_positions(sorted(toks))
                bits[pos.reshape(-1)] = True
            out.append(bits)
        cache[key] = out
        return out

    @staticmethod
    def from_pydict(data: Dict[str, np.ndarray], schema) -> "Part":
        n = len(next(iter(data.values()))) if data else 0
        minmax = {}
        for name, vals in data.items():
            v = np.asarray(vals)
            if v.dtype != object and v.dtype.kind in "iuf" and len(v):
                minmax[name] = (float(v.min()), float(v.max()))
        return Part({k: np.asarray(v) for k, v in data.items()}, n, minmax)


def _normalize_json_column(v: np.ndarray) -> np.ndarray:
    """Dicts / JSON strings / None -> canonical serialized documents
    (sorted keys, compact separators) so equal documents dictionary-encode
    to one code regardless of the input spelling."""
    import json as _json
    out = np.empty(len(v), object)
    for i, x in enumerate(v):
        if x is None:
            out[i] = "{}"
        elif isinstance(x, (dict, list)):
            out[i] = _json.dumps(x, sort_keys=True,
                                 separators=(",", ":"))
        else:
            try:
                out[i] = _json.dumps(_json.loads(str(x)), sort_keys=True,
                                     separators=(",", ":"))
            except ValueError:
                raise AnalysisError(
                    f"Cannot parse JSON value: {str(x)[:80]!r}")
    return out


def _json_flatten(doc, prefix: str, out: dict) -> None:
    """Scalar paths of one document: nested dicts recurse with dotted
    prefixes; arrays and nulls stay in the full-document residue only."""
    if not isinstance(doc, dict):
        return
    for k, val in doc.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(val, dict):
            _json_flatten(val, path, out)
        elif isinstance(val, (int, float, str, bool)) and val is not None:
            out[path] = val


def _variant_canon(v) -> Optional[str]:
    """Canonical serialized form of one Variant/Dynamic value: ints as
    digits, floats via repr, strings JSON-quoted (so 42 and '42' stay
    distinct variants), arrays/maps as compact JSON, None as NULL."""
    import json as _json
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, (list, tuple, np.ndarray, dict)):
        return _json.dumps(
            v.tolist() if isinstance(v, np.ndarray) else
            list(v) if isinstance(v, tuple) else v,
            separators=(",", ":"))
    return _json.dumps(str(v))


def _normalize_variant_column(v: np.ndarray) -> np.ndarray:
    """Raw python values -> canonical forms.  Strings ALWAYS canonize as
    String variants (a str "42" is a String, not an Int64 — insert inputs
    are raw values; canonical round-trips only happen at the part level,
    which bypasses this normalizer)."""
    out = np.empty(len(v), object)
    for i, x in enumerate(np.asarray(v, object)):
        out[i] = _variant_canon(x)
    return out


def _variant_tag(s: Optional[str]) -> Optional[str]:
    """Type tag of a canonical value: i/f/s/a/b."""
    if s is None:
        return None
    c = s[0] if s else ""
    if c == '"':
        return "s"
    if c in "[{":
        return "a"
    if s in ("true", "false"):
        return "b"
    try:
        int(s)
        return "i"
    except ValueError:
        pass
    try:
        float(s)
        return "f"
    except ValueError:
        return "s"


_VARIANT_TAG_DTYPE = {"i": "Int64", "f": "Float64", "s": "String",
                      "b": "Bool", "a": "Array(Int64)"}


def variant_shred(part: Part, name: str):
    """-> (type-name object array ('None' for NULL), {tag: object array
    of decoded values (None where inactive)}) — cached per part
    (ColumnVariant discriminators + variants analog)."""
    import json as _json
    cache = getattr(part, "_variant_shred", None)
    if cache is None:
        cache = part._variant_shred = {}
    if name in cache:
        return cache[name]
    raw = np.asarray(part.columns[name], object)
    n = len(raw)
    vtype = np.empty(n, object)
    subs: Dict[str, np.ndarray] = {}
    for i, s in enumerate(raw):
        tag = _variant_tag(s if isinstance(s, str) or s is None
                           else _variant_canon(s))
        if tag is None:
            vtype[i] = "None"
            continue
        vtype[i] = _VARIANT_TAG_DTYPE[tag]
        col = subs.get(tag)
        if col is None:
            col = subs[tag] = np.full(n, None, object)
        if tag == "i":
            col[i] = int(s)
        elif tag == "f":
            col[i] = float(s)
        elif tag == "b":
            col[i] = 1 if s == "true" else 0
        elif tag == "a":
            try:
                col[i] = _json.loads(s)
            except ValueError:
                col[i] = []
        else:
            try:
                col[i] = _json.loads(s) if s[:1] == '"' else s
            except ValueError:
                col[i] = s
    cache[name] = (vtype, subs)
    return cache[name]


def json_shred(part: Part, name: str):
    """-> ({path: object array (None = missing)}, {path: type tag}) for a
    part's JSON column; parsed once, cached on the part.  Type tags:
    'i' int, 'f' float, 'b' bool, 's' str — mixed numeric widens to 'f',
    any other mix widens to 's' (the Dynamic-ish least-surprise rule)."""
    import json as _json
    cache = getattr(part, "_json_shred", None)
    if cache is None:
        cache = part._json_shred = {}
    if name in cache:
        return cache[name]
    raw = part.columns[name]
    n = len(raw)
    rows = []
    for x in raw:
        flat: dict = {}
        try:
            _json_flatten(_json.loads(x), "", flat)
        except ValueError:
            pass
        rows.append(flat)
    paths: Dict[str, str] = {}
    for flat in rows:
        for path, val in flat.items():
            tag = ("b" if isinstance(val, bool) else
                   "i" if isinstance(val, int) else
                   "f" if isinstance(val, float) else "s")
            prev = paths.get(path)
            if prev is None or prev == tag:
                paths[path] = tag
            elif {prev, tag} <= {"i", "f", "b"}:
                paths[path] = "f" if "f" in (prev, tag) else "i"
            else:
                paths[path] = "s"
    cols: Dict[str, np.ndarray] = {}
    for path, tag in paths.items():
        arr = np.empty(n, object)
        for i, flat in enumerate(rows):
            val = flat.get(path)
            if val is None:
                arr[i] = None
            elif tag == "s":
                arr[i] = val if isinstance(val, str) else _json.dumps(val)
            elif tag == "b":
                arr[i] = bool(val)
            elif tag == "f":
                arr[i] = float(val)
            else:
                arr[i] = int(val)
        cols[path] = arr
    cache[name] = (cols, paths)
    return cache[name]


_JSON_TAG_DTYPE = {"i": "Int64", "f": "Float64", "b": "Bool",
                   "s": "String"}


def base_engine(name: str) -> str:
    """Replicated<X> merges like <X> locally (coordination is orthogonal)."""
    if name.startswith("Replicated"):
        return name[len("Replicated"):] or "MergeTree"
    return name


class Table:
    """A named table: schema + list of parts + device cache."""

    _NEXT_UID = 0

    def __init__(self, name: str, schema: List[Tuple[str, dt.DType]],
                 engine: str = "Memory",
                 order_by: Optional[List[str]] = None,
                 partition_by: Optional[str] = None,
                 skip_indexes: Optional[List[SkipIndex]] = None,
                 index_granularity: int = 8192):
        self.name = name
        self.schema: Dict[str, dt.DType] = dict(schema)
        self.engine = engine
        self.order_by = order_by or []
        self.partition_by = partition_by
        self.skip_indexes: List[SkipIndex] = list(skip_indexes or [])
        self.index_granularity = int(index_granularity)
        self.parts: List[Part] = []
        self.codecs: Dict[str, str] = {}   # column -> codec chain text
        self._version = 0
        # unique instance id: DROP+CREATE restarts version at 0, so compile
        # caches keyed on (name, version) alone would alias the old schema
        Table._NEXT_UID += 1
        self.uid = Table._NEXT_UID
        self._device_cache: Optional[Block] = None
        self._lock = threading.Lock()
        # replication state machine (storage/replication.py) for
        # Replicated* engines; None for local tables
        self.replication = None
        # durable-store binding (storage/persist.py attach_store); None for
        # RAM-resident tables
        self._store = None
        self._store_db = None
        self._store_files: List[str] = []

    # -- metadata ------------------------------------------------------------
    @property
    def version(self) -> int:
        # replicated tables pull pending log entries before any versioned
        # read (lazy sync; SYSTEM SYNC REPLICA forces it eagerly)
        if self.replication is not None:
            self.replication.pull()
        return self._version

    @version.setter
    def version(self, v: int) -> None:
        self._version = v

    def sync(self) -> None:
        if self.replication is not None:
            self.replication.pull()

    def schema_items(self) -> List[Tuple[str, dt.DType]]:
        return list(self.schema.items())

    @property
    def num_rows(self) -> int:
        self.sync()
        return sum(p.num_rows for p in self.parts)

    # -- writes --------------------------------------------------------------
    def insert_pydict(self, data: Dict[str, np.ndarray], quorum: int = 0):
        if self.engine == "Null":
            return                        # StorageNull: writes vanish
        if self.replication is not None:
            bid = self.replication.begin_insert(data)
            if bid is None:
                return                    # deduplicated retry
            if quorum and quorum > 1 \
                    and self.replication.confirming_replicas() < quorum:
                # quorum unreachable (stopped fetches / missing replicas):
                # the reference raises UNKNOWN_STATUS_OF_INSERT and
                # sequential-consistency reads never see the part
                # (ReplicatedMergeTreeSink::waitForQuorum timeout)
                self.replication.abort_insert(bid)
                from ..core.errors import ExecutionError
                raise ExecutionError(
                    f"UNKNOWN_STATUS_OF_INSERT: quorum {quorum} is "
                    f"unreachable ({self.replication.confirming_replicas()} "
                    f"replica(s) can confirm)")
            self._insert_local(data)
            self.replication.log_insert(data, bid)
            return
        self._insert_local(data)

    def _insert_local(self, data: Dict[str, np.ndarray]):
        cols = {}
        n = None
        for name, ctype in self.schema.items():
            if name in data:
                v = np.asarray(data[name])
            else:
                v = None
            if n is None and v is not None:
                n = len(v)
        if n is None:
            n = 0
        for name, ctype in self.schema.items():
            if name in data:
                v = np.asarray(data[name])
                if len(v) != n:
                    raise AnalysisError("INSERT column length mismatch")
                if ctype.is_json:
                    v = _normalize_json_column(v)
                elif ctype.variant_types is not None:
                    v = _normalize_variant_column(v)
            else:  # missing column -> default value
                if ctype.is_json:
                    v = np.asarray(["{}"] * n, dtype=object)
                elif ctype.is_dictionary:
                    v = np.asarray([""] * n, dtype=object)
                else:
                    v = np.zeros(n, ctype.np_dtype)
            cols[name] = v
        from ..core.failpoints import fail_point
        fail_point("insert_before_commit_part")
        with self._lock:
            part = Part.from_pydict(cols, self.schema)
            self.parts.append(part)
            self._version += 1
            self._device_cache = None
            if self._store is not None:
                # durability: part blob first, manifest publish second
                # (write-tmp-then-rename discipline, MergeTreeDataWriter.h:67)
                fname = self._store.save_part(self._store_db, self, part)
                self._store_files.append(fname)
                self._store.publish(self._store_db, self.name,
                                    self._store_files)

    def truncate(self):
        with self._lock:
            self.parts = []
            self._version += 1
            self._device_cache = None
            if self._store is not None:
                self._store_files = []
                self._store.publish(self._store_db, self.name, [])

    def repersist(self):
        """Rewrite every persisted part (schema-changing ALTERs)."""
        if self._store is None:
            return
        with self._lock:
            self._store.save_meta(self._store_db, self)
            files = [self._store.save_part(self._store_db, self, p)
                     for p in self.parts]
            self._store_files = files
            self._store.publish(self._store_db, self.name, files)

    def optimize(self, final: bool = False):
        """Merge all parts into one, applying the engine's fold semantics
        (MergeTask analog: horizontal merge + *SortedAlgorithm fold,
        numpy implementation in storage/merges.py)."""
        from ..core.failpoints import fail_point
        from .merges import fold_merge
        fail_point("merge_before_commit")
        with self._lock:
            if not self.parts:
                return
            cols = {}
            for name in self.schema:
                pieces = [p.columns[name] for p in self.parts]
                if self.schema[name].is_dictionary:
                    cols[name] = np.concatenate(
                        [np.asarray(p, object) for p in pieces])
                else:
                    cols[name] = np.concatenate(pieces)
            cols = fold_merge(cols, self.schema, base_engine(self.engine),
                              self.order_by,
                              list(getattr(self, "engine_args", []) or []))
            self.parts = [Part.from_pydict(cols, self.schema)]
            self._version += 1
            self._device_cache = None
            if self._store is not None:
                fname = self._store.save_part(self._store_db, self,
                                              self.parts[0])
                self._store_files = [fname]
                self._store.publish(self._store_db, self.name,
                                    self._store_files)

    # -- reads ---------------------------------------------------------------
    def read_block(self, columns: Optional[Sequence[str]] = None) -> Block:
        """Whole-table device block (concatenated parts, padded).

        Deliberately UNPRUNED: the block is a shared device-resident cache
        amortized across every query on this version; per-query part
        pruning would fragment it.  IO pruning pays off exactly when data
        exceeds the device — the streamed path (exec/streaming.py
        _prune_parts) prunes parts and granules there."""
        self.sync()
        with self._lock:
            if self._device_cache is None:
                self._device_cache = self._build_device_block()
            blk = self._device_cache
        if columns is not None:
            return blk.select(list(columns))
        return blk

    def variant_subcols(self, name: str) -> Dict[str, "dt.DType"]:
        """Shredded subcolumns of a Variant/Dynamic column: "__vtype"
        (String discriminator) + one decoded column per ACTIVE type tag
        (derived from the data — reload-safe)."""
        out: Dict[str, "dt.DType"] = {"__vtype": dt.String}
        tags: set = set()
        for p in self.parts:
            _, subs = variant_shred(p, name)
            tags |= set(subs)
        for tag in sorted(tags):
            tn = _VARIANT_TAG_DTYPE[tag]
            out[tn] = dt.make_nullable(dt.parse_type_name(tn))
        return out

    def json_paths(self, name: str) -> Dict[str, "dt.DType"]:
        """Discovered scalar paths of a JSON column, unioned across parts
        (always derived from the data — reload-safe); {path: Nullable(T)}.
        The analyzer turns these into ordinary scan fields so `j.path`
        reads a typed device column (ColumnObject shredding analog)."""
        tags: Dict[str, str] = {}
        for p in self.parts:
            _, ptags = json_shred(p, name)
            for path, tag in ptags.items():
                prev = tags.get(path)
                if prev is None or prev == tag:
                    tags[path] = tag
                elif {prev, tag} <= {"i", "f", "b"}:
                    tags[path] = "f" if "f" in (prev, tag) else "i"
                else:
                    tags[path] = "s"
        return {path: dt.make_nullable(
            dt.parse_type_name(_JSON_TAG_DTYPE[tag]))
            for path, tag in sorted(tags.items())}

    def _build_device_block(self) -> Block:
        total = self.num_rows
        cap = pad_to(total)
        cols: Dict[str, Column] = {}
        for name, ctype in self.schema.items():
            pieces = [p.columns[name] for p in self.parts] or \
                [np.zeros(0, ctype.np_dtype if not ctype.is_dictionary
                          else object)]
            if ctype.is_dictionary:
                merged = np.concatenate([np.asarray(p, dtype=object)
                                         for p in pieces])
            else:
                merged = np.concatenate(pieces)
            cols[name] = column_from_numpy(merged, ctype, capacity=cap)
            if ctype.variant_types is not None:
                # discriminator + per-type decoded subcolumns ride the
                # block as "<col>.__vtype" / "<col>.<Type>"
                for sub, sdt in self.variant_subcols(name).items():
                    vals = []
                    for p in self.parts:
                        vt, subs = variant_shred(p, name)
                        if sub == "__vtype":
                            vals.append(vt)
                            continue
                        tag = next((k for k, v2 in _VARIANT_TAG_DTYPE
                                    .items() if v2 == sub), None)
                        arr = subs.get(tag)
                        if arr is None:
                            arr = np.full(p.num_rows, None, object)
                        vals.append(arr)
                    merged_s = np.concatenate(vals) if vals \
                        else np.zeros(0, object)
                    cols[f"{name}.{sub}"] = column_from_numpy(
                        merged_s, sdt, capacity=cap)
            if ctype.is_json:
                # shredded typed subcolumns ride the block as ordinary
                # columns named "<col>.<path>"
                for path, pdt in self.json_paths(name).items():
                    vals = []
                    for p in self.parts:
                        shred, _ = json_shred(p, name)
                        arr = shred.get(path)
                        if arr is None:
                            arr = np.full(p.num_rows, None, object)
                        vals.append(arr)
                    merged_p = np.concatenate(vals) if vals \
                        else np.zeros(0, object)
                    cols[f"{name}.{path}"] = column_from_numpy(
                        merged_p, pdt, capacity=cap)
        return Block(cols, total)

    def part_stats(self):
        """Per-part minmax for scan pruning."""
        return [(p.num_rows, p.minmax) for p in self.parts]

    # -- chunked (out-of-core) reads ------------------------------------------
    def chunk_source(self, columns: Sequence[str], chunk_rows: int,
                     part_idx: Optional[tuple] = None,
                     spans: Optional[tuple] = None,
                     row_sel: Optional[list] = None,
                     sel_key=None) -> "ChunkSource":
        """Chunked read plan: fixed-capacity host chunks with table-wide
        consistent physical dtypes and global dictionaries, so one compiled
        per-chunk XLA program serves every chunk (the streaming analog of the
        reference's MergeTreeReadPool, src/Storages/MergeTree/
        MergeTreeReadPool.h:22).  ``spans`` restricts the read to granule
        row ranges surviving skip-index pruning: ((part_i, lo, hi), ...).
        ``row_sel`` (one int index array per surviving part) restricts the
        read to an explicit row subset — the grace-join bucket path."""
        if row_sel is not None and sel_key is None:
            return ChunkSource(self, list(columns), chunk_rows,
                               part_idx=part_idx, row_sel=row_sel)
        # sel_key: identity of a deterministic row selection (host PREWHERE
        # predicate text) — lets repeated queries reuse the source and its
        # encode cache
        key = (self.version, tuple(sorted(columns)), chunk_rows, part_idx,
               spans, sel_key)
        cached = getattr(self, "_chunk_source_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        src = ChunkSource(self, list(columns), chunk_rows,
                          part_idx=part_idx, spans=spans, row_sel=row_sel)
        self._chunk_source_cache = (key, src)
        return src

    def physical_bytes(self, columns: Optional[Sequence[str]] = None) -> int:
        """Estimated device bytes of a full-table scan (narrow storage)."""
        n = self.num_rows
        total = 0
        for name, t in self.schema.items():
            if columns is not None and name not in columns:
                continue
            if t.is_dictionary:
                total += 4 * n
            elif t.is_array:
                total += 8 * n * 8      # rough: 8-wide padded matrix
            else:
                b = self.column_bounds(name)
                if b is not None:
                    total += _narrow_itemsize(t.np_dtype, b) * n
                else:
                    total += t.np_dtype.itemsize * n
        return total

    def column_unique(self, name: str) -> bool:
        """Whole-table uniqueness of a column: every part unique AND part
        minmax ranges pairwise disjoint (cheap conservative check)."""
        if not self.parts:
            return True
        ranges = []
        for p in self.parts:
            if p.num_rows == 0:
                continue
            if p.is_unique(name) is not True:
                return False
            mm = p.minmax.get(name)
            if mm is None:
                return len([q for q in self.parts if q.num_rows]) == 1
            ranges.append(mm)
        ranges.sort()
        for (lo_a, hi_a), (lo_b, hi_b) in zip(ranges, ranges[1:]):
            if lo_b <= hi_a:
                return False
        return True

    def column_bounds(self, name: str):
        """Integer (lo, hi) over all parts, or None (minmax-index analog)."""
        t = self.schema.get(name)
        if t is None or t.is_dictionary or t.np_dtype.kind not in ("i", "u"):
            return None
        lo = hi = None
        for p in self.parts:
            mm = p.minmax.get(name)
            if mm is None:
                if p.num_rows:
                    return None
                continue
            lo = mm[0] if lo is None else min(lo, mm[0])
            hi = mm[1] if hi is None else max(hi, mm[1])
        if lo is None:
            return None
        return (int(lo), int(hi))


def _pick_narrow_int(base: np.dtype, bounds: Tuple[int, int]):
    """Narrowest exact integer dtype for the proven [lo, hi] interval
    (table-wide analog of core/column.py narrow_storage)."""
    lo, hi = bounds
    if base.kind == "i":
        for cand in (np.int8, np.int16, np.int32):
            info = np.iinfo(cand)
            if cand().itemsize < base.itemsize \
                    and info.min <= lo and hi <= info.max:
                return cand
    elif base.kind == "u":
        for cand in (np.uint8, np.uint16, np.uint32):
            if cand().itemsize < base.itemsize \
                    and hi <= np.iinfo(cand).max:
                return cand
    return base.type


def _narrow_itemsize(np_dtype: np.dtype, bounds: Tuple[int, int]) -> int:
    return np.dtype(_pick_narrow_int(np_dtype, bounds)).itemsize


class ChunkSource:
    """Chunked host reads with chunk-invariant physical layout.

    The whole-table read path narrows dtypes and builds dictionaries per
    block; a streaming scan must instead fix ONE physical dtype and ONE
    dictionary per column across every chunk, or each chunk would need its
    own XLA program.  Table-wide decisions are made here once (narrowing from
    part minmax stats, global dictionaries via one unique pass) and cached on
    the table."""

    def __init__(self, table: Table, columns: List[str], chunk_rows: int,
                 part_idx: Optional[tuple] = None,
                 spans: Optional[tuple] = None,
                 row_sel: Optional[list] = None,
                 layout_donor: Optional["ChunkSource"] = None,
                 pack: bool = True):
        chunk_rows += chunk_rows & 1      # even capacity: bit-packed
        self.table = table                # transport pairs values
        self.columns = columns
        self.chunk_rows = chunk_rows
        # minmax-pruned scans stream a subset of parts (KeyCondition analog:
        # parts whose stats refute the filter are never read)
        self.parts = table.parts if part_idx is None \
            else [table.parts[i] for i in part_idx]
        # skip-index pruned scans stream a subset of granule row ranges
        # within the surviving parts: (part_index_into_self.parts, lo, hi)
        self.spans = None if spans is None else list(spans)
        # explicit per-part row subsets (grace-join buckets)
        self.row_sel = row_sel
        # chunk plan: when reading whole parts, chunks NEVER cross part
        # boundaries so every column slice is a zero-copy numpy view (the
        # cross-part concatenate was the dominant host cost of streaming)
        self._chunk_plan = None            # [(part_i, lo, hi)] per chunk
        if row_sel is not None:
            self.spans = None
            self.total_rows = sum(len(s) for s in row_sel)
        elif self.spans is not None:
            self.total_rows = sum(hi - lo for _, lo, hi in self.spans)
        else:
            self.total_rows = sum(p.num_rows for p in self.parts)
            plan = []
            for pi, p in enumerate(self.parts):
                for lo in range(0, p.num_rows, chunk_rows):
                    plan.append((pi, lo, min(lo + chunk_rows, p.num_rows)))
            self._chunk_plan = plan or [(0, 0, 0)]
        if self._chunk_plan is not None:
            self.num_chunks = len(self._chunk_plan)
        else:
            self.num_chunks = max(
                1, -(-self.total_rows // chunk_rows))  # ceil div
        if layout_donor is not None:
            # physical layout decisions (narrowed dtypes, global
            # dictionaries) are table-wide: bucket sources of one grace join
            # share the donor's one-pass results
            self.storage = layout_donor.storage
            self.dictionaries = layout_donor.dictionaries
            self._sorted_dict_values = layout_donor._sorted_dict_values
            self._dict_hashes = layout_donor._dict_hashes
            self.nullable = layout_donor.nullable
            self.packed = layout_donor.packed
            return
        self.storage: Dict[str, np.dtype] = {}
        self.dictionaries: Dict[str, "Dictionary"] = {}
        self._sorted_dict_values: Dict[str, np.ndarray] = {}
        self._dict_hashes: Dict[str, np.ndarray] = {}
        self.nullable: Dict[str, bool] = {}
        # name -> (nibble_width, lo_offset, bytes_per_pair): bit-packed
        # host->device transport for bounded int columns
        self.packed: Dict[str, tuple] = {}
        for name in columns:
            t = table.schema.get(name)
            if t is None:
                # JSON shredded subcolumn: exists only in device blocks
                raise NotStreamable(f"derived subcolumn '{name}'")
            if t.is_array:
                raise NotStreamable(f"Array column '{name}'")
            parts = [p for p in self.parts if p.num_rows]
            obj_parts = [p for p in parts
                         if p.columns[name].dtype == object]
            self.nullable[name] = bool(t.nullable) or bool(obj_parts)
            if t.is_dictionary:
                vals = [np.asarray(p.columns[name], object) for p in parts]
                flat = np.concatenate(vals) if vals \
                    else np.zeros(0, object)
                non_null = flat[np.asarray(
                    [v is not None for v in flat], bool)] \
                    if self.nullable[name] else flat
                from ..core.column import (HASH_FACTORIZE_MIN_ROWS,
                                           _hash_struct, hash_tokens128)
                if len(non_null) >= HASH_FACTORIZE_MIN_ROWS:
                    # hash-token dictionary: no lexicographic string sort;
                    # per-chunk encode is a hash + binary search over u128
                    # tokens (core/column.py factorize_strings)
                    hv = _hash_struct(hash_tokens128(non_null))
                    uniq_h, first = np.unique(hv, return_index=True)
                    dic = Dictionary(np.asarray(non_null, object)[first],
                                     sorted_=False)
                    dic._hash_sorted = uniq_h
                    self.dictionaries[name] = dic
                    self._dict_hashes[name] = uniq_h
                    self.storage[name] = np.dtype(np.int32)
                    continue
                uniq = np.unique(non_null.astype(str)) if len(non_null) \
                    else np.zeros(0, str)
                self._sorted_dict_values[name] = uniq
                self.dictionaries[name] = Dictionary(uniq.astype(object), sorted_=True)
                self.storage[name] = np.dtype(np.int32)
                continue
            base = t.np_dtype
            if obj_parts:
                self.storage[name] = base     # no narrowing for ragged parts
                continue
            if base.kind in ("i", "u"):
                b = table.column_bounds(name)
                if b is not None:
                    nar = np.dtype(_pick_narrow_int(base, b))
                    self.storage[name] = nar
                    # bit-packed transport (VERDICT r04 item 6): values
                    # spanning w bits ride the host->device link as
                    # nibble-aligned pairs (2 values in 2*ceil(w/4)/2
                    # bytes) when that beats the narrow byte dtype —
                    # x < 2^20 moves 2.5 B/row instead of 4
                    if pack and not self.nullable[name]:
                        lo, hi = b
                        w4 = -(-max((hi - lo).bit_length(), 1) // 4) * 4
                        bpp = w4 // 4            # bytes per value PAIR
                        if w4 <= 28 and bpp < nar.itemsize * 2:
                            self.packed[name] = (w4, int(lo), bpp)
                else:
                    self.storage[name] = base
            elif base == np.float64:
                lossless = all(p.f32_lossless(name) for p in parts)
                self.storage[name] = np.dtype(np.float32) if lossless \
                    else base
            else:
                self.storage[name] = base

    # host-RAM budget for cached ENCODED chunks (narrow dtype, ready for
    # device_put) — the page-cache analog: repeat streamed scans skip the
    # slice+cast host pass entirely
    ENCODE_CACHE_BYTES = 8 << 30

    def chunk(self, i: int):
        """-> ({name: (data_np(cap,), validity_np or None)}, num_rows)."""
        cache = getattr(self, "_enc_cache", None)
        if cache is None:
            cache = self._enc_cache = {}
            self._enc_cache_bytes = 0
        hit = cache.get(i)
        if hit is not None:
            return hit
        out, n = self._chunk_uncached(i)
        sz = sum(d.nbytes + (v.nbytes if v is not None else 0)
                 for d, v in out.values())
        if self._enc_cache_bytes + sz <= self.ENCODE_CACHE_BYTES:
            cache[i] = (out, n)
            self._enc_cache_bytes += sz
        return out, n

    def _chunk_uncached(self, i: int):
        cap = self.chunk_rows
        out = {}
        if self._chunk_plan is not None:
            pi, lo, hi = self._chunk_plan[i]
            n = hi - lo
            for name in self.columns:
                raw = self.parts[pi].columns[name][lo:hi] if n else \
                    np.zeros(0, object
                             if self.table.schema[name].is_dictionary
                             else self.table.schema[name].np_dtype)
                out[name] = self.encode_column(name, raw, cap)
            return out, n
        lo = i * self.chunk_rows
        hi = min(lo + self.chunk_rows, self.total_rows)
        n = max(hi - lo, 0)
        for name in self.columns:
            raw = self._slice_column(name, lo, hi)
            out[name] = self.encode_column(name, raw, cap)
        return out, n

    def encode_column(self, name: str, raw: np.ndarray, cap: int):
        """Encode a raw host slice into this source's chunk-invariant
        physical layout: (data_np(cap,), validity_np or None)."""
        n = len(raw)
        t = self.table.schema[name]
        storage = self.storage[name]
        validity = None
        if self.nullable[name] and raw.dtype == object:
            none_mask = np.asarray([v is None for v in raw], bool)
            validity = np.zeros(cap, np.uint8)
            validity[:n] = ~none_mask
            raw = raw.copy()
            if t.is_dictionary:
                raw[none_mask] = ""
            else:
                raw[none_mask] = 0
        elif self.nullable[name]:
            validity = np.zeros(cap, np.uint8)
            validity[:n] = 1
        if t.is_dictionary:
            data = np.zeros(cap, np.int32)
            if n:
                hs = self._dict_hashes.get(name)
                if hs is not None:
                    from ..core.column import _hash_struct, hash_tokens128
                    chv = _hash_struct(hash_tokens128(
                        np.asarray(raw, object)))
                    data[:n] = np.searchsorted(hs, chv).astype(np.int32)
                else:
                    data[:n] = np.searchsorted(
                        self._sorted_dict_values[name], raw.astype(str)
                    ).astype(np.int32)
        elif name in self.packed:
            # nibble-aligned HALF packing: value j pairs with value
            # j + cap/2, so the device unpack is a 1-D concat of two
            # contiguous halves rather than a strided (N,2) layout
            w4, off, bpp = self.packed[name]
            half = cap // 2
            data = np.zeros(half * bpp, np.uint8)
            if n:
                v = np.zeros(cap, np.uint64)
                v[:n] = (np.asarray(raw).astype(np.int64) - off
                         ).astype(np.uint64)
                pairs = v[:half] | (v[half:] << np.uint64(w4))
                by = pairs.astype("<u8").view(np.uint8).reshape(-1, 8)[:,
                                                                       :bpp]
                data[:by.size] = by.ravel()
        elif n == cap:
            # full aligned chunk: one cast at most, zero-copy when the part
            # is already stored at the streaming dtype
            data = np.ascontiguousarray(np.asarray(raw).astype(storage,
                                                               copy=False))
        else:
            data = np.zeros(cap, storage)
            if n:
                data[:n] = np.asarray(raw).astype(storage, copy=False)
        return data, validity

    def _slice_column(self, name: str, lo: int, hi: int) -> np.ndarray:
        pieces = []
        off = 0
        if self.row_sel is not None:
            # logical row space = concatenation of per-part selected rows
            for p, sel in zip(self.parts, self.row_sel):
                sp_lo, sp_hi = off, off + len(sel)
                off = sp_hi
                if sp_hi <= lo or sp_lo >= hi:
                    continue
                idx = sel[max(lo - sp_lo, 0):min(hi - sp_lo, len(sel))]
                pieces.append(p.columns[name][idx])
            if not pieces:
                t = self.table.schema[name]
                return np.zeros(0, object if t.is_dictionary
                                else t.np_dtype)
            return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
        if self.spans is not None:
            # logical row space = concatenation of surviving spans
            for pi, s_lo, s_hi in self.spans:
                sp_lo, sp_hi = off, off + (s_hi - s_lo)
                off = sp_hi
                if sp_hi <= lo or sp_lo >= hi:
                    continue
                a = s_lo + max(lo - sp_lo, 0)
                b = s_lo + min(hi - sp_lo, s_hi - s_lo)
                pieces.append(self.parts[pi].columns[name][a:b])
            if not pieces:
                t = self.table.schema[name]
                return np.zeros(0, object if t.is_dictionary
                                else t.np_dtype)
            return pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
        for p in self.parts:
            p_lo, p_hi = off, off + p.num_rows
            off = p_hi
            if p_hi <= lo or p_lo >= hi:
                continue
            a, b = max(lo - p_lo, 0), min(hi - p_lo, p.num_rows)
            pieces.append(p.columns[name][a:b])
        if not pieces:
            t = self.table.schema[name]
            return np.zeros(0, object if t.is_dictionary else t.np_dtype)
        if len(pieces) == 1:
            return pieces[0]
        return np.concatenate(pieces)


class NotStreamable(Exception):
    """This plan/table cannot run in streaming mode (driver falls back)."""


@dataclasses.dataclass
class ViewDef:
    """A stored SELECT (StorageView) or insert-trigger pipeline
    (StorageMaterializedView, reference: src/Storages/StorageMaterializedView)."""
    name: str
    query: object                  # ast.Select / ast.Union
    materialized: bool = False
    source: Optional[Tuple[str, str]] = None   # (db, table) trigger source
    to_table: Optional[str] = None


@dataclasses.dataclass
class DictionaryDef:
    """External dictionary: key -> attributes, refreshed from a source table
    (reference: src/Dictionaries/, hashed layout)."""
    name: str
    key_column: str
    source_db: str
    source_table: str
    attributes: Dict[str, object]      # attr name -> DType


class Database:
    def __init__(self, name: str):
        self.name = name
        self.tables: Dict[str, Table] = {}
        self.views: Dict[str, ViewDef] = {}
        self.dictionaries: Dict[str, DictionaryDef] = {}


class Catalog:
    """Databases/tables registry (DatabaseCatalog analog)."""

    def __init__(self):
        self.databases: Dict[str, Database] = {"default": Database("default"),
                                               "system": Database("system"),
                                               "_files": Database("_files")}
        self.current_database = "default"
        self._file_cache: Dict[Tuple[str, float], str] = {}
        # extra system.* table providers registered by the session
        self.system_providers: Dict[str, "callable"] = {}
        # durable store (storage/persist.py); None = RAM-resident catalog
        self.store = None
        # named disks (storage/disks.py DiskRegistry), lazily created
        self.disks = None
        # ProcessList analog: running queries across every session of this
        # catalog; KILL QUERY flips the kill flag, checked at host sync
        # points (streamed chunk boundaries, plan retries)
        self.running_queries: Dict[str, dict] = {}

    # -- durability (storage/persist.py) -------------------------------------
    def enable_persistence(self, disk) -> None:
        """Attach a durable store on `disk` and reload every table that
        survived a previous process (DatabaseCatalog loadTables analog)."""
        from .persist import TableStore
        self.store = TableStore(disk)
        for db, name in self.store.list_tables():
            self.create_database(db, if_not_exists=True)
            if name not in self.databases[db].tables:
                self.databases[db].tables[name] = \
                    self.store.load_table(db, name)

    def attach_table(self, database: str, name: str) -> None:
        """ATTACH TABLE: reload from the durable store, or re-attach the
        in-memory detached object (Memory-engine DETACH keeps data)."""
        det = getattr(self, "_detached_tables", {}).pop((database, name),
                                                        None)
        if det is not None and self.store is None:
            self.create_database(database, if_not_exists=True)
            self.databases[database].tables[name] = det
            return
        if self.store is None:
            dbo = self.databases.get(database)
            if dbo is not None and name in dbo.tables:
                # already attached (ATTACH after a restartless CREATE):
                # the reference raises TABLE_ALREADY_EXISTS — callers with
                # IF NOT EXISTS swallow this
                raise UnknownTable(
                    f"Table '{database}.{name}' already exists")
            raise UnknownTable("No durable store configured")
        self.create_database(database, if_not_exists=True)
        self.databases[database].tables[name] = \
            self.store.load_table(database, name)

    def detach_table(self, database: str, name: str,
                     if_exists: bool = False) -> None:
        """DETACH TABLE: drop from the catalog, keep the on-disk data."""
        db = self.databases.get(database)
        if db is None or name not in db.tables:
            if if_exists:
                return
            raise UnknownTable(f"Unknown table '{database}.{name}'")
        if not hasattr(self, "_detached_tables"):
            self._detached_tables = {}
        self._detached_tables[(database, name)] = db.tables[name]
        del db.tables[name]

    def file_table(self, path: str, fmt: Optional[str] = None,
                   files_root: Optional[str] = None) -> Table:
        """file() table function backing: read once per (path, mtime)."""
        import os
        from . import formats
        from .table import Table as _T
        path = formats.confine_path(path, files_root)
        mtime = os.path.getmtime(path)
        key = (path, mtime)
        name = self._file_cache.get(key)
        db = self.databases["_files"]
        if name is not None and name in db.tables:
            return db.tables[name]
        data = formats.read_file(path, fmt)
        schema = []
        for cname, vals in data.items():
            v = np.asarray(vals)
            if v.dtype == object:
                non_null = [x for x in v if x is not None]
                nullable = len(non_null) < len(v)
                if all(isinstance(x, str) for x in non_null):
                    t = dt.String
                elif all(isinstance(x, (int, np.integer)) for x in non_null):
                    t = dt.Int64
                else:
                    t = dt.Float64
                if nullable:
                    t = dt.make_nullable(t)
            else:
                t = dt.from_numpy_dtype(v.dtype)
            schema.append((cname, t))
        name = f"f{len(db.tables)}_{abs(hash(key)) % 10**8}"
        t = _T(name, schema, engine="File")
        t.insert_pydict(data)
        db.tables[name] = t
        self._file_cache[key] = name
        return t

    def inline_format_table(self, fmt: str, text: str,
                            schema=None) -> Table:
        """format() table function backing (reference:
        src/TableFunctions/TableFunctionFormat.cpp): parse an inline data
        literal with the named input format.  Reuses the file readers via a
        temp file; columns without a declared structure get the file()
        inference (c1..cN for headerless formats)."""
        import os
        import tempfile
        from . import formats
        from .table import Table as _T
        db = self.databases["_files"]
        key = ("__format__", fmt, text)
        name = self._file_cache.get(key)
        if name is not None and name in db.tables:
            return db.tables[name]
        suffix = ".bin" if fmt.lower().startswith("rowbinary") else ".txt"
        fd, path = tempfile.mkstemp(suffix=suffix)
        try:
            mode = "wb" if suffix == ".bin" else "w"
            with os.fdopen(fd, mode) as fh:
                fh.write(text.encode("latin-1") if mode == "wb" else text)
            data = formats.read_file(path, fmt)
        finally:
            os.unlink(path)
        if schema is None:
            schema = []
            for cname, vals in data.items():
                v = np.asarray(vals)
                if v.dtype == object:
                    non_null = [x for x in v if x is not None]
                    nullable = len(non_null) < len(v)
                    if all(isinstance(x, str) for x in non_null):
                        t = dt.String
                    elif all(isinstance(x, (int, np.integer))
                             for x in non_null):
                        t = dt.Int64
                    else:
                        t = dt.Float64
                    if nullable:
                        t = dt.make_nullable(t)
                else:
                    t = dt.from_numpy_dtype(v.dtype)
                schema.append((cname, t))
        name = f"fmt{len(db.tables)}_{abs(hash(key)) % 10**8}"
        t = _T(name, schema, engine="File")
        if data:
            ins = {c: data[c] for c, _ in schema if c in data}
            if not ins and len(data) == len(schema):
                # declared structure + headerless format: the reader names
                # columns c1..cN — map positionally onto the structure
                ins = {c: v for (c, _), v in zip(schema, data.values())}
            t.insert_pydict(ins)
        db.tables[name] = t
        self._file_cache[key] = name
        return t

    GENERATE_RANDOM_ROWS = 1 << 17     # enough for typical `LIMIT n` uses

    def generate_random_table(self, schema, seed=None, max_str=10,
                              max_arr=10) -> Table:
        """generateRandom('structure'[, seed[, max_string_len[,
        max_array_len]]]) backing (reference:
        src/Storages/StorageGenerateRandom.cpp).  A fixed-size random block:
        the engine has no infinite-stream scans, so callers LIMIT within
        GENERATE_RANDOM_ROWS rows."""
        from .table import Table as _T
        rng = np.random.default_rng(0 if seed is None else int(seed) & (2**63 - 1))
        n = self.GENERATE_RANDOM_ROWS
        alphabet = np.array(list(
            "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"))

        def gen_scalar(t, rows):
            k = t.np_dtype.kind
            if t.is_dictionary:
                lens = rng.integers(0, max(1, max_str) + 1, rows)
                return np.asarray(
                    ["".join(rng.choice(alphabet, ln)) for ln in lens],
                    dtype=object)
            if k in "iu":
                info = np.iinfo(t.np_dtype)
                return rng.integers(info.min, info.max, rows,
                                    dtype=t.np_dtype, endpoint=False)
            if k == "f":
                return rng.standard_normal(rows).astype(t.np_dtype) * 1e3
            if k == "b":
                return rng.integers(0, 2, rows).astype(bool)
            raise EngineError(
                f"generateRandom: unsupported type {t.name}")

        data = {}
        for cname, t in schema:
            if t.is_array:
                inner = dt.array_inner(t)
                lens = rng.integers(0, max(1, max_arr) + 1, n)
                flat = gen_scalar(inner, int(lens.sum()))
                out = np.empty(n, dtype=object)
                off = 0
                for i, ln in enumerate(lens):
                    out[i] = list(flat[off:off + ln])
                    off += ln
                data[cname] = out
            elif t.nullable:
                vals = gen_scalar(dt.remove_nullable(t), n)
                mask = rng.random(n) < 0.1
                out = np.asarray(vals, dtype=object)
                out[mask] = None
                data[cname] = out
            else:
                data[cname] = gen_scalar(t, n)
        db = self.databases["_files"]
        name = f"genrand_{len(db.tables)}"
        t = _T(name, list(schema), engine="GenerateRandom")
        t.insert_pydict(data)
        db.tables[name] = t
        return t

    @staticmethod
    def _expand_shards(addr: str) -> List[str]:
        """Expand one `{a,b}` / `{lo..hi}` brace group into shard addresses
        (reference: parseRemoteDescription, src/Common/parseRemoteDescription
        .cpp) — each element of the comma list / range is a separate SHARD;
        '|' inside an element separates failover replicas."""
        # top-level commas (outside braces) separate shards too:
        # '127.0.0.1,127.0.0.2' is two shards
        tops, depth, cur = [], 0, []
        for ch in addr:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
            if ch == "," and depth == 0:
                tops.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        tops.append("".join(cur))
        out: List[str] = []
        for one in tops:
            one = one.strip()
            lo = one.find("{")
            hi = one.find("}", lo + 1)
            if lo < 0 or hi < 0:
                out.append(one)
                continue
            head, body, tail = one[:lo], one[lo + 1:hi], one[hi + 1:]
            parts: List[str] = []
            for piece in body.split(","):
                if ".." in piece:
                    a, _, b = piece.partition("..")
                    width = len(a) if a.startswith("0") else 0
                    for i in range(int(a), int(b) + 1):
                        parts.append(str(i).zfill(width))
                else:
                    parts.append(piece)
            out.extend(head + p + tail for p in parts)
        return out

    @staticmethod
    def _is_loopback(host: str) -> bool:
        return host in ("localhost", "") or host.startswith("127.")

    def _local_snapshot(self, target: str) -> Tuple[list, Dict[str, np.ndarray]]:
        """Read a local table's raw column data (plain scan: parts
        concatenated, no FINAL) for loopback remote()/cluster() shards."""
        if "." in target:
            db, _, name = target.partition(".")
        else:
            db, name = self.current_database, target
        t = self.get_table(db, name)
        t.sync()
        schema = list(t.schema_items())
        data: Dict[str, np.ndarray] = {}
        for cname, _ in schema:
            arrs = [p.columns[cname] for p in t.parts if cname in p.columns]
            if arrs:
                data[cname] = np.concatenate(arrs)
            else:
                data[cname] = np.asarray([], dtype=object)
        return schema, data

    def remote_table(self, addr: str, target: str, user: str = "default",
                     password: str = "") -> Table:
        """remote() backing: pull `db.table` (or a bare table in the remote
        default database) from another server over the native TCP protocol
        into a local _files table.  `addr` may list failover replicas
        separated by '|' (ConnectionPoolWithFailover analog: tried in
        order, first healthy one wins, errors accounted) and shard brace
        patterns `127.0.0.{1,2}` — each shard's rows are concatenated
        (reference: TableFunctionRemote multi-shard read).  Loopback
        addresses read the local catalog in-process (the reference's own
        stateless tests treat 127.0.0.x as self)."""
        shard_addrs = self._expand_shards(addr)

        def serve_in_process(rep: str) -> bool:
            # loopback reads the LOCAL catalog only when the table exists
            # here; an explicit port with no such local table means a real
            # separate server (server<->server pull tests)
            if not self._is_loopback(rep.partition(":")[0]):
                return False
            tgt = target if "." in target \
                else f"{self.current_database}.{target}"
            db, _, nm = tgt.partition(".")
            return self.has_table(db, nm)

        if len(shard_addrs) > 1 or serve_in_process(
                shard_addrs[0].split("|")[0].strip()):
            blocks = []
            schema = None
            for sa in shard_addrs:
                rep = sa.split("|")[0].strip()
                if serve_in_process(rep):
                    schema, data = self._local_snapshot(target)
                    blocks.append(data)
                else:
                    t = self._remote_fetch(sa, target, user, password)
                    schema = list(t.schema_items())
                    blocks.append({c: np.concatenate(
                        [p.columns[c] for p in t.parts]) if t.parts
                        else np.asarray([], dtype=object)
                        for c, _ in schema})
            name = f"remote_{abs(hash((addr, target))) % 10**10}"
            out = Table(name, schema, engine="Remote")
            for data in blocks:
                if len(next(iter(data.values()), ())):
                    out.insert_pydict(data)
            self.databases["_files"].tables[name] = out
            return out
        return self._remote_fetch(addr, target, user, password)

    @staticmethod
    def _hedged_fetch(replicas, fetch_one, errors, stagger_s, addr):
        """Hedged request runner (HedgedConnections analog,
        src/Client/HedgedConnections.h:29): start the best replica; every
        ``stagger_s`` without an answer, start a duplicate request on the
        next replica; first success wins, failures are accounted and
        trigger an immediate hedge."""
        import queue as _queue
        import threading as _threading
        results: "_queue.Queue" = _queue.Queue()

        def run(rep: str) -> None:
            try:
                results.put(("ok", rep, fetch_one(rep)))
            except (OSError, EngineError) as e:   # replica failure: hedge
                results.put(("err", rep, e))
            except BaseException as e:  # noqa: BLE001 — programming error:
                results.put(("bug", rep, e))      # propagate, don't retry

        started = 0
        pending = 0
        last_err = None

        def launch_next():
            nonlocal started, pending
            _threading.Thread(target=run, args=(replicas[started],),
                              daemon=True).start()
            started += 1
            pending += 1

        launch_next()
        while True:
            try:
                timeout = stagger_s if started < len(replicas) else None
                kind, rep, val = results.get(timeout=timeout)
            except _queue.Empty:
                launch_next()            # primary is slow: hedge
                continue
            pending -= 1
            if kind == "ok":
                return val               # late losers are daemon threads
            if kind == "bug":
                raise val                # not a replica failure
            errors[rep] = errors.get(rep, 0) + 1
            last_err = val
            if started < len(replicas):
                launch_next()            # failure: hedge immediately
            elif pending == 0:
                raise EngineError(
                    f"remote(): all replicas of '{addr}' failed: "
                    f"{last_err}")

    def remote_query(self, addr: str, sql_text: str, user: str = "default",
                     password: str = "", local_exec=None,
                     table_name: Optional[str] = None):
        """Cross-process distributed query execution, data path: run
        `sql_text` on every shard of `addr` over the native TCP wire (the
        RemoteQueryExecutor analog — the QUERY ships to the data; rows or
        mergeable -State columns come back), concatenate the shard results,
        and register them as a `_files` table.  Loopback shards run
        in-process through `local_exec(sql) -> (cols, types)`.  Returns
        (Table, wire_bytes_received).  Ref:
        src/QueryPipeline/RemoteQueryExecutor.cpp,
        src/Interpreters/ClusterProxy/executeQuery.cpp."""
        from ..core import dtypes as dtm
        shard_addrs = self._expand_shards(addr)
        per_shard: list = [None] * len(shard_addrs)
        wire_bytes = [0]

        def is_local(sa: str) -> bool:
            return local_exec is not None and \
                self._is_loopback(sa.split("|")[0].strip()
                                  .partition(":")[0])

        def run_shard(i: int, sa: str) -> None:
            if is_local(sa):
                per_shard[i] = local_exec(sql_text)
            else:
                cols, types, nbytes = self._fetch_sql(sa, sql_text, user,
                                                      password)
                per_shard[i] = (cols, types)
                wire_bytes[0] += nbytes

        if len(shard_addrs) == 1:
            run_shard(0, shard_addrs[0])
        else:
            import threading as _th
            errs: list = []

            def guard(i, sa):
                try:
                    run_shard(i, sa)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)
            ts = [_th.Thread(target=guard, args=(i, sa), daemon=True)
                  for i, sa in enumerate(shard_addrs)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            if errs:
                raise errs[0]
        types = next(t for _, t in per_shard if t is not None)
        schema = [(n, dtm.parse_type_name(t)) for n, t in types]
        name = table_name or \
            f"remoteq_{abs(hash((addr, sql_text))) % 10**10}"
        t = Table(name, schema, engine="Remote")
        for cols, stypes in per_shard:
            if cols and len(next(iter(cols.values()), ())):
                t.insert_pydict({n: cols[n] for n, _ in stypes})
        self.databases["_files"].tables[name] = t
        return t, wire_bytes[0]

    def _fetch_sql(self, addr: str, sql_text: str, user: str = "default",
                   password: str = ""):
        """Run one SQL text against a '|'-failover replica list; ->
        (cols, types, wire_bytes).  Hedged duplicates per settings."""
        from ..server.tcp_server import NativeTcpClient
        errors = getattr(self, "_remote_errors", None)
        if errors is None:
            errors = self._remote_errors = {}
        replicas = [a.strip() for a in addr.split("|") if a.strip()]
        replicas.sort(key=lambda a: errors.get(a, 0))
        nbytes = [0]

        def fetch_one(rep: str):
            host, _, port = rep.partition(":")
            client = NativeTcpClient(host, int(port or 9000), user=user,
                                     password=password, compression=True)
            try:
                return client.execute(sql_text)
            finally:
                nbytes[0] += client.bytes_received
                client.close()

        from ..exec.session import active_session
        s = active_session()
        hedge = s is not None and s.settings.use_hedged_requests \
            and len(replicas) > 1
        stagger_s = (s.settings.hedged_connection_timeout_ms / 1000.0
                     if s is not None else 0.1)
        if hedge:
            cols, types = self._hedged_fetch(replicas, fetch_one, errors,
                                             stagger_s, addr)
        else:
            last_err = None
            cols = types = None
            for rep in replicas:
                try:
                    cols, types = fetch_one(rep)
                    last_err = None
                    break
                except (OSError, EngineError) as e:
                    errors[rep] = errors.get(rep, 0) + 1
                    last_err = e
            if last_err is not None:
                raise EngineError(
                    f"remote(): all replicas of '{addr}' failed: "
                    f"{last_err}")
        return cols, types, nbytes[0]

    def _remote_fetch(self, addr: str, target: str, user: str = "default",
                      password: str = "") -> Table:
        from ..server.tcp_server import NativeTcpClient
        from ..core import dtypes as dtm
        import time as _time
        cache = getattr(self, "_remote_cache", None)
        if cache is None:
            cache = self._remote_cache = {}
        key = (addr, target, user)
        hit = cache.get(key)
        # short TTL: the several analysis passes of ONE query share a
        # snapshot; the next query re-fetches fresh remote data
        if hit is not None and hit[0] in self.databases["_files"].tables \
                and _time.monotonic() - hit[1] < 3.0:
            return self.databases["_files"].tables[hit[0]]
        errors = getattr(self, "_remote_errors", None)
        if errors is None:
            errors = self._remote_errors = {}
        replicas = [a.strip() for a in addr.split("|") if a.strip()]
        # failover order: fewest accumulated errors first, declared order
        # as the tie-break (reference: ConnectionPoolWithFailover)
        replicas.sort(key=lambda a: errors.get(a, 0))

        def fetch_one(rep: str):
            host, _, port = rep.partition(":")
            client = NativeTcpClient(host, int(port or 9000), user=user,
                                     password=password, compression=True)
            try:
                return client.execute(f"SELECT * FROM {target}")
            finally:
                client.close()

        from ..exec.session import active_session
        s = active_session()
        hedge = s is not None and s.settings.use_hedged_requests \
            and len(replicas) > 1
        stagger_s = (s.settings.hedged_connection_timeout_ms / 1000.0
                     if s is not None else 0.1)
        if hedge:
            cols, types = self._hedged_fetch(replicas, fetch_one, errors,
                                             stagger_s, addr)
        else:
            last_err = None
            cols = types = None
            for rep in replicas:
                try:
                    cols, types = fetch_one(rep)
                    last_err = None
                    break
                except (OSError, EngineError) as e:
                    errors[rep] = errors.get(rep, 0) + 1
                    last_err = e
            if last_err is not None:
                raise EngineError(
                    f"remote(): all replicas of '{addr}' failed: "
                    f"{last_err}")
        schema = [(n, dtm.parse_type_name(t)) for n, t in types]
        name = f"remote_{abs(hash(key)) % 10**10}"
        t = Table(name, schema, engine="Remote")
        if cols:
            t.insert_pydict({n: cols[n] for n, _ in types})
        self.databases["_files"].tables[name] = t
        cache[key] = (name, _time.monotonic())
        return t

    def get_table(self, database: str, name: str) -> Table:
        db = self.databases.get(database)
        if db is None:
            raise UnknownTable(f"Unknown database '{database}'")
        t = db.tables.get(name)
        if t is None:
            # system tables are generated on demand
            if database == "system":
                t = self._system_table(name)
                if t is not None:
                    return t
            raise UnknownTable(f"Unknown table '{database}.{name}'")
        return t

    def get_view(self, database: str, name: str) -> Optional[ViewDef]:
        db = self.databases.get(database)
        if db is None:
            return None
        return db.views.get(name)

    def has_table(self, database: str, name: str) -> bool:
        try:
            self.get_table(database, name)
            return True
        except UnknownTable:
            return False

    def create_table(self, database: str, table: Table,
                     if_not_exists: bool = False):
        db = self.databases.get(database)
        if db is None:
            raise UnknownTable(f"Unknown database '{database}'")
        if table.name in db.tables:
            if if_not_exists:
                return
            raise AnalysisError(f"Table '{database}.{table.name}' already exists")
        db.tables[table.name] = table
        if self.store is not None:
            from .persist import attach_store, persisted_engine
            if persisted_engine(table.engine):
                attach_store(table, self.store, database)
                self.store.save_meta(database, table)
                if table.parts:          # CTAS data inserted pre-attach
                    table.repersist()

    def drop_table(self, database: str, name: str, if_exists: bool = False):
        db = self.databases.get(database)
        if db is not None and name in getattr(db, "views", {}):
            del db.views[name]
            return
        if db is not None and name in getattr(db, "dictionaries", {}):
            del db.dictionaries[name]
            return
        if db is None or name not in db.tables:
            if if_exists:
                return
            raise UnknownTable(f"Unknown table '{database}.{name}'")
        t = db.tables.pop(name)
        if self.store is not None and getattr(t, "_store", None) is not None:
            self.store.drop_table(database, name)

    def create_database(self, name: str, if_not_exists: bool = False):
        if name in self.databases:
            if if_not_exists:
                return
            raise AnalysisError(f"Database '{name}' already exists")
        self.databases[name] = Database(name)

    def drop_database(self, name: str, if_exists: bool = False):
        if name not in self.databases:
            if if_exists:
                return
            raise UnknownTable(f"Unknown database '{name}'")
        del self.databases[name]

    # -- system tables (self-observation, reference: src/Storages/System/) --
    def _system_table(self, name: str) -> Optional[Table]:
        provider = self.system_providers.get(name)
        if provider is not None:
            return provider()
        if name == "one":
            t = Table("one", [("dummy", dt.UInt8)])
            t.insert_pydict({"dummy": np.zeros(1, np.uint8)})
            return t
        if name == "tables":
            rows_db, rows_name, rows_engine, rows_rows = [], [], [], []
            for dbn, db in self.databases.items():
                for tn, tbl in db.tables.items():
                    rows_db.append(dbn)
                    rows_name.append(tn)
                    rows_engine.append(tbl.engine)
                    rows_rows.append(tbl.num_rows)
            t = Table("tables", [("database", dt.String), ("name", dt.String),
                                 ("engine", dt.String),
                                 ("total_rows", dt.UInt64)])
            t.insert_pydict({
                "database": np.asarray(rows_db, object),
                "name": np.asarray(rows_name, object),
                "engine": np.asarray(rows_engine, object),
                "total_rows": np.asarray(rows_rows, np.uint64),
            })
            return t
        if name == "databases":
            t = Table("databases", [("name", dt.String)])
            t.insert_pydict({"name": np.asarray(list(self.databases), object)})
            return t
        if name == "numbers":
            return None   # handled as a virtual source by the planner
        return None

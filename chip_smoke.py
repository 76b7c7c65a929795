"""Smoke run of the engine's main path on one GPU, checked against numpy.

    python chip_smoke.py               # one GPU, full size
    python chip_smoke.py --chips 4     # the sharded path over four GPUs
    python chip_smoke.py --scale 0.01  # every row count scaled down

One process opens the card once, loads tables generated from `--seed` and
answers queries through `clickhouse_tpu.connect()` / `Session.execute` (one
phase over the HTTP server).  Sizes follow ClickBench's 100M-row `hits` and
the bench queries in bench.py.  Every answer is compared with a numpy
reference of the same semantics; a mismatch or an error in any phase stops
the run with a non-zero exit.

Every stdout line but the last names the card (`nvidia-smi` name and power
limit, read by a child process) and gives a phase, its rows, the first
(compiling) run and the median of three warm runs, each ending with the
result on the host.  The last line is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Off the GPU the script exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np

WARM_RUNS = 3


@dataclasses.dataclass(frozen=True)
class Sizes:
    rows: int = 100_000_000            # hits / fact rows (per card on 4)
    x_range: int = 1_000_003           # x Int64 in [0, x_range)
    dim_rows: int = 1_000_000          # join dimension, unique key
    f_distinct: int = 1_000_000        # distinct Float64 keys of f
    str_rows: int = 10_000_000
    str_distinct: int = 5_000_000
    vec_rows: int = 10_000_000
    vec_dim: int = 128
    stream_block_bytes: int = 256 << 20
    stream_chunk_bytes: int = 128 << 20
    search_keys: int = 1 << 22
    search_queries: int = 1 << 24

    def scaled(self, f: float) -> "Sizes":
        if f == 1.0:
            return self
        n = lambda v, lo=1024: max(int(v * f), lo)          # noqa: E731
        return dataclasses.replace(
            self, rows=n(self.rows), dim_rows=n(self.dim_rows),
            f_distinct=n(self.f_distinct), str_rows=n(self.str_rows),
            str_distinct=n(self.str_distinct, 512),
            vec_rows=max(n(self.vec_rows), 1 << 16),
            stream_block_bytes=n(self.stream_block_bytes, 4096),
            stream_chunk_bytes=n(self.stream_chunk_bytes, 2048),
            search_keys=n(self.search_keys), search_queries=n(
                self.search_queries, 1 << 18))


class Mismatch(AssertionError):
    pass


def expect(phase: str, ok, detail: str) -> None:
    if not bool(ok):
        raise Mismatch(f"{phase}: {detail}")


# -- reporting -------------------------------------------------------------

def card_name() -> str:
    """`nvidia-smi` name and power limit of every card, from a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "; ".join(line.strip() for line in out.splitlines()
                     if line.strip())


class Report:
    def __init__(self, card: str):
        self.card = card

    def line(self, **fields) -> None:
        body = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[{self.card}] {body}", flush=True)


def timed(fn):
    """(result, first run s, median of the warm runs s); `fn` returns its
    result on the host, so each clock stops after the fetch."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    warm = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        out = fn()
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm)


def run_query(rep: Report, s, phase: str, rows: int, sql: str):
    res, first, med = timed(lambda: s.execute(sql))
    rep.line(phase=phase, rows=rows, first_s=first, warm_median_s=med)
    return res


def cols(res):
    return list(res.columns.values())


# -- data ------------------------------------------------------------------

def f64_pool(rng, n: int) -> np.ndarray:
    """`n` doubles, distinct by bit pattern: magnitudes 1e-310..1e300
    (denormals included) of both signs, values beyond the float32 range,
    neighbours one ulp apart, +-0.0, +-inf and NaN."""
    specials = np.array([
        0.0, -0.0, np.inf, -np.inf, np.nan, 5e-324, -5e-324, 1.0,
        np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0), 3.5e38,
        np.nextafter(3.5e38, np.inf), -1e300, 1e-310, 1e300])
    mag = 10.0 ** rng.uniform(-310.0, 300.0, n)
    base = np.where(rng.random(n) < 0.5, -mag, mag)
    ulp_up = np.nextafter(base[:n // 4], np.inf)
    cand = np.concatenate([specials, ulp_up, base])
    _, first = np.unique(cand.view(np.uint64), return_index=True)
    pool = cand[np.sort(first)[:n]]
    assert len(pool) == n
    return pool


def order_bits(a: np.ndarray) -> np.ndarray:
    """The engine's Float64 key order (ops/hash_ops.py f64_token): IEEE
    bits, order-mapped so unsigned order is the float total order."""
    b = np.ascontiguousarray(a, np.float64).view(np.uint64)
    neg = (b >> np.uint64(63)) == 1
    return np.where(neg, ~b, b | np.uint64(1 << 63))


def make_hits(sizes: Sizes, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = sizes.rows
    pool = f64_pool(rng, sizes.f_distinct)
    fidx = rng.integers(0, len(pool), n)
    return {
        "x": rng.integers(0, sizes.x_range, n),
        "k": rng.integers(0, sizes.dim_rows * 11 // 10, n),
        "v": rng.random(n),
        "fidx": fidx, "pool": pool, "f": pool[fidx],
    }


def load_hits(s, data: dict, sizes: Sizes, seed: int) -> None:
    rng = np.random.default_rng(seed + 1)
    s.execute("CREATE TABLE hits (x Int64, k Int64, v Float64, f Float64)")
    s.insert_pydict("hits", {c: data[c] for c in ("x", "k", "v", "f")})
    s.execute("CREATE TABLE dim (dk Int64, label Int64)")
    data["label_of_key"] = rng.integers(0, 100, sizes.dim_rows)
    perm = rng.permutation(sizes.dim_rows)
    s.insert_pydict("dim", {"dk": perm.astype(np.int64),
                            "label": data["label_of_key"][perm]})
    # Float64-keyed dimension: half of f's values, half their ulp
    # neighbours that f never holds
    pool = data["pool"]
    half = sizes.dim_rows // 2
    sel = rng.permutation(len(pool))
    near = np.nextafter(pool[sel[:half]], -np.inf)
    near = near[~np.isin(near.view(np.uint64), pool.view(np.uint64))]
    fk = np.concatenate([pool[sel[half:2 * half]], near])
    _, first = np.unique(fk.view(np.uint64), return_index=True)
    fk = fk[np.sort(first)]
    flabel = rng.integers(0, 100, len(fk))
    s.execute("CREATE TABLE fdim (fk Float64, flabel Int64)")
    s.insert_pydict("fdim", {"fk": fk, "flabel": flabel})
    data["fdim"] = (fk, flabel)


# -- probes: plain-JAX formulations against their XLA alternatives -----------

def _probe(rep, name, rows, fns, args):
    import jax
    outs = []
    for formulation, fn in fns:
        jf = jax.jit(fn)
        out, first, med = timed(lambda: jax.device_get(jf(*args)))
        rep.line(probe=name, formulation=formulation, rows=rows,
                 first_s=first, warm_median_s=med)
        outs.append(out)
    ref = jax.tree_util.tree_leaves(outs[0])
    for out in outs[1:]:
        for a, b in zip(ref, jax.tree_util.tree_leaves(out)):
            expect(f"probe {name}", np.array_equal(np.asarray(a),
                                                   np.asarray(b)),
                   "formulations disagree")


def run_probes(rep: Report, data: dict, sizes: Sizes, seed: int) -> None:
    import jax
    import jax.numpy as jnp
    from clickhouse_tpu.ops import mxu_segsum, search

    S = 1024
    x32 = jnp.asarray(data["x"].astype(np.int32))

    def dense(x):
        ids = (x % S).astype(jnp.int32)
        c, s = mxu_segsum.mxu_group_reduce(
            ids, jnp.ones(x.shape, bool), [None],
            [(x.astype(jnp.int64), True, (0, sizes.x_range - 1), None)], S)
        return c[0], s[0]

    def scatter(x):
        ids = (x % S).astype(jnp.int32)
        c = jax.ops.segment_sum(jnp.ones(x.shape, jnp.int64), ids, S)
        return c, jax.ops.segment_sum(x.astype(jnp.int64), ids, S)

    _probe(rep, "group_reduce", sizes.rows,
           [("mxu_group_reduce", dense), ("segment_sum", scatter)], (x32,))

    rng = np.random.default_rng(seed + 2)
    keys = jnp.asarray(np.sort(rng.integers(0, 1 << 31, sizes.search_keys,
                                            dtype=np.int32)))
    queries = jnp.asarray(rng.integers(0, 1 << 31, sizes.search_queries,
                                       dtype=np.int32))
    _probe(rep, "searchsorted", sizes.search_queries,
           [("searchsorted_via_sort", search.searchsorted_via_sort),
            ("jnp.searchsorted", lambda a, v: jnp.searchsorted(a, v).astype(
                jnp.int32))], (keys, queries))
    del keys, queries

    count = lambda a: jnp.sum(a > 500000)                    # noqa: E731
    _probe(rep, "count_int32", sizes.rows, [("int32", count)], (x32,))
    x64 = x32.astype(jnp.int64)
    _probe(rep, "count_int64", sizes.rows, [("int64", count)], (x64,))
    del x32, x64


# -- one-card phases ---------------------------------------------------------

SCAN_SQL = "SELECT count() FROM hits WHERE x > 500000"
DENSE_SQL = ("SELECT x % 1024 AS g, count() AS c, sum(x) AS s FROM hits "
             "GROUP BY g ORDER BY g")


def check_scan(res, data) -> None:
    expect("scan", cols(res)[0][0] == (data["x"] > 500000).sum(),
           f"count {cols(res)[0][0]}")


def check_dense(res, data) -> None:
    g = data["x"] % 1024
    counts = np.bincount(g, minlength=1024)
    sums = np.bincount(g, weights=data["x"], minlength=1024)
    present = np.nonzero(counts)[0]
    got_g, got_c, got_s = cols(res)
    expect("group_dense", np.array_equal(got_g, present), "group keys")
    expect("group_dense", np.array_equal(got_c, counts[present]), "counts")
    expect("group_dense", np.array_equal(got_s, sums[present].astype(
        np.int64)), "sums")


def phase_scan(rep, s, data, sizes):
    check_scan(run_query(rep, s, "scan", sizes.rows, SCAN_SQL), data)


def phase_group_dense(rep, s, data, sizes):
    check_dense(run_query(rep, s, "group_dense", sizes.rows, DENSE_SQL),
                data)


def phase_group_sort(rep, s, data, sizes):
    res = run_query(rep, s, "group_sort", sizes.rows,
                    "SELECT x AS g, count() AS c FROM hits GROUP BY g "
                    "ORDER BY c DESC, g LIMIT 10 "
                    "SETTINGS max_groups = 2097152")
    counts = np.bincount(data["x"], minlength=sizes.x_range)
    top = np.lexsort((np.arange(len(counts)), -counts))[:10]
    got_g, got_c = cols(res)
    expect("group_sort", np.array_equal(got_g, top), f"keys {got_g}")
    expect("group_sort", np.array_equal(got_c, counts[top]), "counts")


def phase_group_f64(rep, s, data, sizes):
    pool, fidx = data["pool"], data["fidx"]
    counts = np.bincount(fidx, minlength=len(pool))
    sums = np.bincount(fidx, weights=data["k"], minlength=len(pool)
                       ).astype(np.int64)
    present = np.nonzero(counts)[0]
    tok = order_bits(pool)

    res = run_query(rep, s, "group_f64.group_by", sizes.rows,
                    "SELECT f, count() AS c, sum(k) AS s FROM hits "
                    "GROUP BY f")
    got_f, got_c, got_s = cols(res)
    got_order = np.argsort(order_bits(got_f))
    ref = present[np.argsort(tok[present])]
    expect("group_f64", len(got_f) == len(ref),
           f"{len(got_f)} groups, expected {len(ref)}")
    expect("group_f64", np.array_equal(
        got_f[got_order].view(np.uint64), pool[ref].view(np.uint64)),
        "group keys differ by bit pattern")
    expect("group_f64", np.array_equal(got_c[got_order], counts[ref]),
           "counts")
    expect("group_f64", np.array_equal(got_s[got_order], sums[ref]), "sums")

    res = run_query(rep, s, "group_f64.count_distinct", sizes.rows,
                    "SELECT count(DISTINCT f) FROM hits")
    expect("group_f64", cols(res)[0][0] == len(present),
           f"count(DISTINCT f) {cols(res)[0][0]}")

    res = run_query(rep, s, "group_f64.order_by", sizes.rows,
                    "SELECT f FROM hits ORDER BY f LIMIT 1000")
    want = np.repeat(pool[ref], counts[ref])[:1000]
    expect("group_f64", np.array_equal(cols(res)[0].view(np.uint64),
                                       want.view(np.uint64)),
           "ORDER BY f differs by bit pattern")

    fk, flabel = data["fdim"]
    res = run_query(rep, s, "group_f64.join", sizes.rows,
                    "SELECT count() AS c, sum(flabel) AS s FROM hits "
                    "INNER JOIN fdim ON hits.f = fdim.fk")
    label_of_pool = np.full(len(pool), -1, np.int64)
    fk_bits = fk.view(np.uint64)
    order = np.argsort(fk_bits)
    pos = np.searchsorted(fk_bits[order], pool.view(np.uint64))
    pos = np.minimum(pos, len(fk) - 1)
    hit = fk_bits[order][pos] == pool.view(np.uint64)
    label_of_pool[hit] = flabel[order][pos[hit]]
    row_label = label_of_pool[fidx]
    matched = row_label >= 0
    c, sm = cols(res)
    expect("group_f64", c[0] == matched.sum(),
           f"join count {c[0]}, expected {matched.sum()}")
    expect("group_f64", sm[0] == row_label[matched].sum(), "join sum")


def phase_topn(rep, s, data, sizes):
    res = run_query(rep, s, "topn", sizes.rows,
                    "SELECT x FROM hits ORDER BY x LIMIT 100")
    want = np.sort(np.partition(data["x"], 99)[:100])
    expect("topn", np.array_equal(cols(res)[0], want), "top 100")


def phase_join(rep, s, data, sizes):
    res = run_query(rep, s, "join", sizes.rows,
                    "SELECT count() AS c, sum(label) AS s FROM hits "
                    "INNER JOIN dim ON hits.k = dim.dk")
    k = data["k"]
    m = k < sizes.dim_rows
    c, sm = cols(res)
    expect("join", c[0] == m.sum(), f"count {c[0]}")
    expect("join", sm[0] == data["label_of_key"][k[m]].sum(), "sum")


def phase_strings(rep, s, data, sizes, seed):
    rng = np.random.default_rng(seed + 3)
    n, d = sizes.str_rows, sizes.str_distinct
    # every id at least once, the rest skewed towards small ids
    extra = (rng.pareto(1.2, n - d) * 64).astype(np.int64) % d
    ids = rng.permutation(np.concatenate([np.arange(d), extra]))
    prefix = "https://example.com/page/"
    id_str = ids.astype(str)
    urls = np.char.add(prefix, id_str)
    s.execute("CREATE TABLE strs (url String)")
    s.insert_pydict("strs", {"url": urls})
    del urls

    res = run_query(rep, s, "strings.group_by", n,
                    "SELECT url, count() AS c FROM strs GROUP BY url "
                    "ORDER BY c DESC, url LIMIT 10")
    counts = np.bincount(ids, minlength=d)
    tenth = np.partition(counts, d - 10)[d - 10]
    cand = np.nonzero(counts >= tenth)[0]
    want = sorted(((-int(counts[i]), prefix + str(i)) for i in cand))[:10]
    got_u, got_c = cols(res)
    expect("strings", [(-int(c), str(u)) for u, c in zip(got_u, got_c)]
           == want, f"top urls {list(zip(got_u, got_c))[:3]}")

    res = run_query(rep, s, "strings.distinct", n,
                    "SELECT count() FROM (SELECT url, count() AS c "
                    "FROM strs GROUP BY url) SETTINGS max_groups = 67108864")
    expect("strings", cols(res)[0][0] == d, f"groups {cols(res)[0][0]}")

    res = run_query(rep, s, "strings.starts_with", n,
                    f"SELECT count() FROM strs "
                    f"WHERE startsWith(url, '{prefix}1')")
    expect("strings", cols(res)[0][0] == np.char.startswith(id_str, "1")
           .sum(), f"startsWith count {cols(res)[0][0]}")
    s.execute("DROP TABLE strs")


def phase_vectors(rep, s, data, sizes, seed):
    rng = np.random.default_rng(seed + 4)
    n, w = sizes.vec_rows, sizes.vec_dim
    vecs = rng.standard_normal((n, w), dtype=np.float32)
    q = rng.standard_normal(w, dtype=np.float32)
    s.execute("CREATE TABLE vecs (id Int64, v Array(Float32))")
    s.insert_pydict("vecs", {"id": np.arange(n, dtype=np.int64), "v": vecs})
    qs = "[" + ",".join(repr(float(e)) for e in q) + "]"
    res = run_query(rep, s, "vectors", n,
                    f"SELECT id, cosineDistance(v, CAST({qs} AS "
                    f"Array(Float32))) AS d FROM vecs ORDER BY d LIMIT 10")
    q64 = q.astype(np.float64)
    ref = np.empty(n)
    for lo in range(0, n, 1 << 20):
        blk = vecs[lo:lo + (1 << 20)].astype(np.float64)
        ref[lo:lo + len(blk)] = 1.0 - (blk @ q64) / (
            np.linalg.norm(blk, axis=1) * np.linalg.norm(q64))
    best = np.sort(np.partition(ref, 10)[:10])
    got_id, got_d = cols(res)
    tol = 1e-5
    expect("vectors", len(set(got_id.tolist())) == 10, "ids not distinct")
    expect("vectors", np.all(np.abs(got_d - ref[got_id])
                             <= tol * np.abs(ref[got_id])),
           "distances off the float64 reference")
    # the j-th id may differ from the reference's j-th only among
    # candidates whose reference distances lie within the tolerance
    expect("vectors", np.all(np.abs(ref[got_id] - best)
                             <= tol * np.abs(best)),
           f"ids {got_id} are not the nearest 10")
    s.execute("DROP TABLE vecs")


def phase_streamed(rep, s, data, sizes):
    extra = (f" SETTINGS max_device_block_bytes = {sizes.stream_block_bytes}"
             f", stream_chunk_bytes = {sizes.stream_chunk_bytes}"
             f", stream_readers = 2")
    for name, sql, check in (("streamed.scan", SCAN_SQL, check_scan),
                             ("streamed.group_dense", DENSE_SQL,
                              check_dense)):
        before = dict(s.profile_events)
        res = run_query(rep, s, name, sizes.rows, sql + extra)
        runs = 1 + WARM_RUNS
        for event in ("StreamedQueries", "StreamedPackedColumns"):
            expect(name, s.profile_events.get(event, 0)
                   - before.get(event, 0) >= runs, f"no {event}")
        check(res, data)
        plain = s.execute(sql)
        for a, b in zip(cols(res), cols(plain)):
            expect(name, np.array_equal(a, b), "differs from in-memory")


def phase_http(rep, s, data, sizes):
    from clickhouse_tpu.server.http_server import HttpServer
    from clickhouse_tpu.storage import formats
    sql = ("SELECT x % 7 AS g, count() AS c, min(v) AS lo, max(v) AS hi "
           "FROM hits GROUP BY g ORDER BY g")
    srv = HttpServer(s, port=0).start_background()
    try:
        url = f"http://127.0.0.1:{srv.port}/"

        def post():
            req = urllib.request.Request(url, data=sql.encode())
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.read().decode()
        body, first, med = timed(post)
        rep.line(phase="http", rows=sizes.rows, first_s=first,
                 warm_median_s=med)
    finally:
        srv.shutdown()
    res = s.execute(sql)
    expect("http", body == formats.format_rows_text(res.columns, "TSV"),
           "HTTP body differs from Session.execute")
    g = data["x"] % 7
    got_g, got_c, got_lo, got_hi = cols(res)
    for i in range(7):
        vi = data["v"][g == i]
        expect("http", (got_g[i], got_c[i], got_lo[i], got_hi[i])
               == (i, len(vi), vi.min(), vi.max()), f"group {i}")


def one_card(rep: Report, sizes: Sizes, seed: int) -> None:
    import clickhouse_tpu as ch
    t0 = time.perf_counter()
    data = make_hits(sizes, seed)
    s = ch.connect()
    load_hits(s, data, sizes, seed)
    rep.line(phase="load", rows=sizes.rows,
             seconds=time.perf_counter() - t0)
    run_probes(rep, data, sizes, seed)
    phase_scan(rep, s, data, sizes)
    phase_group_dense(rep, s, data, sizes)
    phase_group_sort(rep, s, data, sizes)
    phase_group_f64(rep, s, data, sizes)
    phase_topn(rep, s, data, sizes)
    phase_join(rep, s, data, sizes)
    phase_strings(rep, s, data, sizes, seed)
    phase_vectors(rep, s, data, sizes, seed)
    phase_streamed(rep, s, data, sizes)
    phase_http(rep, s, data, sizes)


# -- four-card path ----------------------------------------------------------

def four_cards(rep: Report, sizes: Sizes, seed: int, n_dev: int = 4) -> None:
    """Filter -> broadcast join -> two-stage GROUP BY over all_to_all ->
    distributed top-k, and one shuffle join, over hash-partitioned
    tables of `sizes.rows` rows per card."""
    from clickhouse_tpu.parallel import DistributedSession, make_mesh
    rng = np.random.default_rng(seed)
    n = sizes.rows * n_dev
    t0 = time.perf_counter()
    fact = {"k": rng.integers(0, sizes.dim_rows * 11 // 10, n),
            "amount": rng.integers(-100, 100, n),
            "v": rng.random(n)}
    label_of_key = rng.integers(0, 100, sizes.dim_rows)
    s = DistributedSession(mesh=make_mesh(n_dev))
    s.execute("CREATE TABLE fact (k Int64, amount Int64, v Float64) "
              "ENGINE = Distributed ORDER BY k")
    s.insert_pydict("fact", fact)
    s.execute("CREATE TABLE dim (dk Int64, label Int64) "
              "ENGINE = Distributed ORDER BY dk")
    s.insert_pydict("dim", {"dk": np.arange(sizes.dim_rows),
                            "label": label_of_key})
    rep.line(phase="load", rows=n, seconds=time.perf_counter() - t0)

    k, amount, v = fact["k"], fact["amount"], fact["v"]
    res = run_query(rep, s, "mesh.join_group_topk", n,
                    "SELECT label, sum(amount) AS s, count() AS c FROM fact "
                    "INNER JOIN dim ON fact.k = dim.dk WHERE v > 0.5 "
                    "GROUP BY label ORDER BY s DESC, label LIMIT 10")
    for name in ("fact", "dim"):
        blk = s._sharded_block(s.catalog.current_database, name)
        for cname, col in blk.columns.items():
            expect("mesh", len(col.data.sharding.device_set) == n_dev,
                   f"{name}.{cname} is not spread over {n_dev} devices")
    m = (v > 0.5) & (k < sizes.dim_rows)
    lab = label_of_key[k[m]]
    sums = np.bincount(lab, weights=amount[m], minlength=100).astype(np.int64)
    cnts = np.bincount(lab, minlength=100)
    labels = np.nonzero(cnts)[0]
    top = labels[np.lexsort((labels, -sums[labels]))][:10]
    got_l, got_s, got_c = cols(res)
    expect("mesh", np.array_equal(got_l, top), f"labels {got_l}")
    expect("mesh", np.array_equal(got_s, sums[top]), "sums")
    expect("mesh", np.array_equal(got_c, cnts[top]), "counts")

    res = run_query(rep, s, "mesh.shuffle_join", n,
                    "SELECT count() AS c, sum(label) AS s FROM fact "
                    "INNER JOIN dim ON fact.k = dim.dk "
                    "SETTINGS join_algorithm = 'shuffle'")
    mk = k < sizes.dim_rows
    c, sm = cols(res)
    expect("mesh", c[0] == mk.sum(), f"shuffle join count {c[0]}")
    expect("mesh", sm[0] == label_of_key[k[mk]].sum(), "shuffle join sum")

    res = run_query(rep, s, "mesh.topk", n,
                    "SELECT k, amount FROM fact ORDER BY amount DESC, k "
                    "LIMIT 10")
    order = np.lexsort((k, -amount))[:10]
    got_k, got_a = cols(res)
    expect("mesh", np.array_equal(got_k, k[order])
           and np.array_equal(got_a, amount[order]), "top-k")


# -- entry point -------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scale", type=float, default=1.0,
                   help="scale every row count (1.0 = full size)")
    args = p.parse_args(argv)

    import jax
    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu" or len(devices) < args.chips:
        print(f"chip_smoke: needs {args.chips} GPU(s); JAX found "
              f"{len(devices)} {platform} device(s)", file=sys.stderr)
        return 2
    devices = devices[:args.chips]

    from clickhouse_tpu import native
    from clickhouse_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    rep = Report(card_name())
    sizes = Sizes().scaled(args.scale)
    if args.chips == 4:
        four_cards(rep, sizes, args.seed)
    else:
        one_card(rep, sizes, args.seed)

    for d in devices:
        rep.line(device=d.id, peak_bytes_in_use=d.memory_stats()[
            "peak_bytes_in_use"])
    native.lz4_decompress(native.lz4_compress(b"smoke" * 64), 320)
    rep.line(native_loaded=native.HAVE_NATIVE)
    if not native.HAVE_NATIVE:
        print("chip_smoke: the native library did not build or load",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

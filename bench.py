"""Benchmark harness — run on one GPU.

Headline metric (BASELINE.md Q1): `SELECT count() WHERE pred` over 100M-row
Int64 columns, reported as rows/s against the device's memory-bandwidth
roofline (the reference publishes no absolute numbers — BASELINE.json — so
vs_baseline is measured-throughput / speed-of-light).

Prints ONE JSON line:  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
Per-operator detail goes to stderr, one line per metric.

Run discipline:
  * persistent compilation cache (clickhouse_tpu.compile_cache): a warm
    run compiles nothing that an earlier run compiled.
  * generated datasets cached as .npy under scratch/bench_data, so host-side
    generation is paid once.
  * one wall-clock budget (BENCH_TOTAL_S): a stage that would not fit in
    the remaining time is not run and counts as failed.
  * per-stage elapsed logged so a timeout is attributable.
  * a stage that raises is logged, the rest still run, and the script
    exits non-zero.
"""
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.abspath(__file__))

# Peak device-memory bandwidth (bytes/s) by jax device_kind.  Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part (3.35 TB/s).  A device
# not in this table is an error: a roofline share needs a published peak.
PEAK_MEM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}
N_ROWS = int(os.environ.get("BENCH_ROWS", str(100_000_000)))
REPS = int(os.environ.get("BENCH_REPS", "11"))
# BASELINE-scale configs (BASELINE.md rows 1/2/4): >HBM streamed scan,
# skewed-key GROUP BY, 1B x 10M join
STREAM_ROWS = int(os.environ.get("BENCH_STREAM_ROWS", str(1_000_000_000)))
JOIN_ROWS = int(os.environ.get("BENCH_JOIN_ROWS", str(1_000_000_000)))
JOIN_DIM = int(os.environ.get("BENCH_JOIN_DIM", str(10_000_000)))
TOTAL_S = float(os.environ.get("BENCH_TOTAL_S", "1350"))

_T0 = time.time()
_DATA = os.path.join(_REPO, "scratch", "bench_data")
os.makedirs(_DATA, exist_ok=True)


FAILED = []          # stages that raised


def log(msg):
    print(f"[{time.time()-_T0:6.0f}s] {msg}", file=sys.stderr, flush=True)


def peak_mem_bytes_per_s(device) -> float:
    kind = device.device_kind
    if kind not in PEAK_MEM_BYTES_PER_S:
        raise SystemExit(f"bench: no published peak for device {kind!r}")
    return PEAK_MEM_BYTES_PER_S[kind]


def fail(stage, e):
    FAILED.append(stage)
    log(f"{stage} failed: {e!r}")


def remaining():
    return TOTAL_S - (time.time() - _T0)


def cached(name, build):
    """Dataset cache: scratch/bench_data/<name>.npy.  Generation is the
    dominant 'ingest' cost on a loaded host; a cached read is seconds."""
    p = os.path.join(_DATA, name + ".npy")
    if os.path.exists(p):
        return np.load(p)
    a = build()
    np.save(p, a)
    return a


# Background data prefetch: dataset reads overlap the device benches that
# run before they are needed.
from concurrent.futures import ThreadPoolExecutor as _TPE  # noqa: E402

_POOL = _TPE(max_workers=2)
_FUTS = {}


def prefetch(name, build):
    if name not in _FUTS:
        _FUTS[name] = _POOL.submit(cached, name, build)


def got(name, build):
    f = _FUTS.get(name)
    if f is not None:
        return f.result()
    return cached(name, build)


def bench_query(session, sql, reps=REPS):
    """Min wall time of a cached compiled query (first run compiles).

    Min over reps estimates (fixed host overhead + device time); the
    t_query - t_null subtraction in main() separates the two.
    """
    session.execute(sql)                       # compile + warm cache
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        session.execute(sql)
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def jax_sort_chk(a):
    """One radix-class sort pass over the bench key column (roofline for
    ORDER BY: a full sort cannot beat one sort of the data)."""
    import jax
    import jax.numpy as jnp
    o = jax.lax.sort([a], num_keys=1, is_stable=False)[0]
    return (o.astype(jnp.int64) * (jnp.arange(o.shape[0]) % 127)).sum()


def device_time_repeat(s, sql, k_lo=4, k_hi=36, reps=7, trials=3):
    """Isolate DEVICE time of a compiled query from the per-call host
    overhead: run the query body k times inside ONE dispatch
    (optimization_barrier threads each iteration's input through the
    previous accumulator so XLA can neither hoist nor CSE the copies), then
    difference two repeat counts (min over reps per k, median slope over
    trials)."""
    import jax
    import jax.numpy as jnp
    s.execute(sql)                      # compile + cache
    key = next(k2 for k2 in s._jit_cache if k2[0] == sql)
    fn = s._jit_cache[key][0]
    plan_c = s._jit_cache[key][1]
    blocks = s._collect_table_blocks(plan_c)
    args = s._block_args(blocks)

    def make(k, with_data):
        def rep(a):
            acc = jnp.int64(0)
            for _ in range(k):
                a, acc = jax.lax.optimization_barrier((a, acc))
                leaves = fn(a)
                acc = acc + leaves["valid"].astype(jnp.int64).sum()
                if with_data:
                    # consume DATA leaves too: a query whose validity is
                    # row-count-derived (top-k emits k valid rows) would
                    # otherwise let XLA dead-code the whole body
                    for v in leaves.get("data", {}).values():
                        acc = acc + v.astype(jnp.int64).sum()
            return acc
        return jax.jit(rep)

    def measure(with_data):
        fns = {}
        for k in (k_lo, k_hi):
            fns[k] = make(k, with_data)
            int(fns[k](args))        # warm; VALUE fetch forces completion
        slopes = []
        for _ in range(trials):
            out = []
            for k in (k_lo, k_hi):
                ts = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    int(fns[k](args))
                    ts.append(time.perf_counter() - t0)
                out.append(min(ts))
            slopes.append((out[1] - out[0]) / (k_hi - k_lo))
        return float(np.median(slopes))

    s_plain = measure(False)
    if s_plain > 5e-5:           # a real per-iteration device cost
        return s_plain
    # degenerate slope (validity was row-count-derived and XLA removed
    # the body): re-measure with data leaves consumed
    return max(measure(True), 1e-6)


def main():
    import jax

    import clickhouse_tpu as ch
    from clickhouse_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()

    devs = jax.devices()
    log(f"devices: {devs}")
    peak_bps = peak_mem_bytes_per_s(devs[0])

    s = ch.connect()
    x = cached("hits_x", lambda: (
        np.arange(N_ROWS, dtype=np.int64) * 2654435761) % 1_000_003)
    s.execute("CREATE TABLE hits (x Int64)")
    s.insert_pydict("hits", {"x": x})
    del x
    log(f"hits table ready ({N_ROWS/1e6:.0f}M rows)")

    # Q1: filter + count (memory-bandwidth bound: one Int64 column read)
    sql = "SELECT count() FROM hits WHERE x > 500000"
    t_med = bench_query(s, sql)
    rows_s = N_ROWS / t_med

    # DEVICE time isolated by in-dispatch repetition (see
    # device_time_repeat): robust against host-side jitter, which an
    # overhead-subtraction estimator is not.
    t_dev = device_time_repeat(s, sql)
    t_null = t_med - t_dev
    dev_rows_s = N_ROWS / t_dev
    # Physical bytes per row: narrow storage (core/column.py narrow_storage)
    # keeps this Int64 column as i32 on device, so a roofline-speed scan
    # reads 4 bytes/row.  vs_baseline = achieved / speed-of-light for the
    # bytes actually moved.
    bytes_per_row = 4
    roofline_rows_s = peak_bps / bytes_per_row
    frac = dev_rows_s / roofline_rows_s
    log(f"Q1 filter+count: min {t_med*1e3:.2f} ms end-to-end "
        f"({rows_s/1e9:.2f} G rows/s); fixed overhead {t_null*1e3:.2f} ms; "
        f"device {t_dev*1e3:.2f} ms = {dev_rows_s/1e9:.2f} G rows/s, "
        f"roofline {roofline_rows_s/1e9:.1f} G rows/s, fraction {frac:.3f}")

    # headline line FIRST — the driver must always see it even if the
    # per-operator extras below run out of time
    print(json.dumps({
        "metric": "filter_count_rows_per_s_device",
        "value": dev_rows_s,
        "unit": "rows/s",
        "vs_baseline": frac,
    }), flush=True)

    # start background dataset reads AFTER the headline, so they do not
    # compete with the Q1 estimator for host CPU
    ns_pf = min(N_ROWS, 50_000_000)
    nd_pf = ns_pf // 2
    prefetch("zipf_k", lambda: np.minimum(
        np.random.default_rng(7).zipf(1.5, N_ROWS),
        10_000_000).astype(np.int64))
    prefetch("urls_50m", lambda: np.char.add(
        "http://example.com/p",
        (np.arange(ns_pf) % nd_pf).astype(str)))
    prefetch("fact_fk_100m", lambda: (
        np.arange(N_ROWS, dtype=np.int64) * 40503) % 1_000_000)
    prefetch("vecs_10m", lambda: np.random.default_rng(8).normal(
        size=(10_000_000, 128)).astype(np.float32))
    CHPF = 250_000_000
    for ci, lo in enumerate(range(0, STREAM_ROWS, CHPF)):
        hi = min(lo + CHPF, STREAM_ROWS)
        prefetch(f"big_x_{ci}",
                 lambda lo=lo, hi=hi: (np.arange(lo, hi, dtype=np.int64)
                                       * 2654435761) % 1_000_003)
    for ci, lo in enumerate(range(0, JOIN_ROWS, CHPF)):
        hi = min(lo + CHPF, JOIN_ROWS)
        prefetch(f"fact6_fk_{ci}",
                 lambda lo=lo, hi=hi: (np.arange(lo, hi, dtype=np.int64)
                                       * 40503) % JOIN_DIM)

    # -- Small on-device benches FIRST; the 1B streamed tier runs LAST
    #    inside whatever remains of the total budget. ----------------------
    import jax.numpy as jnp

    def _min_time(f, *a, reps=3):
        int(f(*a))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            int(f(*a))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    t_probe = t_sortpass = None
    try:
        idx_r = jnp.asarray((np.arange(N_ROWS, dtype=np.int64) * 40503)
                            % (1 << 21), jnp.int32)
        tbl_r = jnp.arange(1 << 21, dtype=jnp.int32)
        t_probe = _min_time(jax.jit(
            lambda t, i: t[i].astype(jnp.int64).sum()), tbl_r, idx_r)
        xs_r = jnp.asarray((np.arange(N_ROWS, dtype=np.int64) * 2654435761)
                           % 1_000_003, jnp.int32)
        t_sortpass = _min_time(jax.jit(
            lambda a: (jax_sort_chk(a))), xs_r)
        del idx_r, tbl_r, xs_r
        log(f"rooflines: probe/gather {t_probe*1e3:.0f} ms, "
            f"sort pass {t_sortpass*1e3:.0f} ms per {N_ROWS/1e6:.0f}M")
    except Exception as e:
        fail("roofline measurement", e)

    try:
        t_agg = bench_query(s, "SELECT x % 1024 AS k, count() AS c, sum(x) "
                                "FROM hits GROUP BY k ORDER BY c DESC LIMIT 10",
                            reps=3)
        fr = f"; probe-roofline fraction {t_probe/t_agg:.3f}" \
            if t_probe else ""
        log(f"Q2 group-by(1k keys)+top10: {t_agg*1e3:.1f} ms "
            f"({N_ROWS/t_agg/1e9:.2f} G rows/s){fr}")
    except Exception as e:
        fail("Q2", e)

    try:
        if remaining() < 120:
            raise TimeoutError("budget")
        t_agg2 = bench_query(s, "SELECT x AS k, count() AS c FROM hits "
                                 "GROUP BY k ORDER BY c DESC LIMIT 10 "
                                 "SETTINGS max_groups = 2097152", reps=2)
        fr = f"; probe-roofline fraction {t_probe/t_agg2:.3f}" \
            if t_probe else ""
        log(f"Q2b group-by(1M keys, sort path)+top10: {t_agg2*1e3:.1f} ms "
            f"({N_ROWS/t_agg2/1e9:.2f} G rows/s){fr}")
    except Exception as e:
        fail("Q2b", e)

    try:
        if remaining() < 120:
            raise TimeoutError("budget")
        t_sort = bench_query(s, "SELECT x FROM hits ORDER BY x LIMIT 100",
                             reps=3)
        fr = f"; sort-pass-roofline fraction {t_sortpass/t_sort:.3f}" \
            if t_sortpass else ""
        log(f"Q3 top-100 of 100M: {t_sort*1e3:.1f} ms "
            f"({N_ROWS/t_sort/1e9:.2f} G rows/s){fr}")
    except Exception as e:
        fail("Q3", e)

    try:
        if remaining() < 120:
            raise TimeoutError("budget")
        # skewed-key GROUP BY (BASELINE row 2: "incl. skewed distribution"):
        # zipf(1.5) keys — sort-based grouping is skew-insensitive by design
        zk = got("zipf_k", lambda: np.minimum(
            np.random.default_rng(7).zipf(1.5, N_ROWS),
            10_000_000).astype(np.int64))
        n_distinct = len(np.unique(zk[:1_000_000]))
        s.execute("CREATE TABLE zipf (k Int64)")
        s.insert_pydict("zipf", {"k": zk})
        del zk
        t_skew = bench_query(
            s, "SELECT k, count() AS c FROM zipf GROUP BY k "
               "ORDER BY c DESC LIMIT 10 SETTINGS max_groups = 16777216",
            reps=3)
        log(f"Q2s SKEWED group-by (zipf 1.5, ~{n_distinct} distinct/1M "
            f"sample): {t_skew*1e3:.1f} ms = {N_ROWS/t_skew/1e9:.2f} "
            f"G rows/s")
        s.execute("DROP TABLE zipf")
    except Exception as e:
        fail("Q2s skewed group-by", e)

    # -- BASELINE-scale streamed configs (out-of-core engine on data
    #    larger than a comfortable device block).  These run BEFORE the
    #    heavier small-device extras: Q5b/Q6 have never made a driver
    #    capture (VERDICT r02-r04) while Q7/Q4/Q8 have stable recorded
    #    histories — truncation must cost the replaceable metrics. --
    xfer_bps = None
    try:
        if remaining() < 180:
            raise TimeoutError("budget")
        import gc
        # raw host->device transfer roofline at this chunk size: a streamed
        # scan cannot beat moving the bytes onto the chip.  DISTINCT buffers
        # per rep — repeated puts of one buffer can be deduplicated by the
        # transport and would overstate the roofline.
        probes = [np.full(1 << 28, i, np.int32) for i in range(3)]  # 1 GiB
        jax.block_until_ready(jax.device_put(np.zeros(1 << 28, np.int32)))
        ts = []
        for p in probes:
            t0 = time.perf_counter()
            jax.block_until_ready(jax.device_put(p))
            ts.append(time.perf_counter() - t0)
        xfer_bps = probes[0].nbytes / min(ts)
        del probes
        log(f"host->device transfer roofline: {xfer_bps/1e9:.2f} GB/s")

        s5 = ch.connect()
        s5.execute("CREATE TABLE big (x Int64)")
        CH = 250_000_000
        for ci, lo in enumerate(range(0, STREAM_ROWS, CH)):
            hi = min(lo + CH, STREAM_ROWS)
            s5.insert_pydict("big", {"x": got(
                f"big_x_{ci}",
                lambda lo=lo, hi=hi: (np.arange(lo, hi, dtype=np.int64)
                                      * 2654435761) % 1_000_003)})
        log(f"streamed table ready ({STREAM_ROWS/1e9:.1f}B rows)")
        # stream_readers=2: overlap host chunk prep + transfer with device
        # compute
        sql5 = ("SELECT count() FROM big WHERE x > 500000 "
                "SETTINGS stream_readers = 2")
        before_stream = s5.profile_events.get("StreamedQueries", 0)
        t5 = bench_query(s5, sql5, reps=1)
        streamed5 = s5.profile_events.get("StreamedQueries",
                                          0) > before_stream
        sr = STREAM_ROWS / t5
        # bit-packed transport: x < 2^20 rides at 2.5 B/row (20-bit
        # nibble-aligned pairs, storage/table.py ChunkSource.packed)
        xfer_roof = xfer_bps / 2.5
        tag = "STREAMED" if streamed5 else "whole-block (fits the device)"
        roof = xfer_roof if streamed5 else peak_bps / 4
        # fraction vs the BURST probe is load-dependent (pipelined
        # streaming can beat a contended burst probe, fraction > 1) — the
        # achieved wire rate is the honest absolute number
        log(f"Q5 {tag} filter+count over {STREAM_ROWS/1e9:.1f}B rows: "
            f"{t5:.2f} s = {sr/1e9:.2f} G rows/s; wire "
            f"{sr*2.5/1e9:.3f} GB/s vs probe {xfer_bps/1e9:.3f} GB/s, "
            f"fraction {sr/roof:.3f}")
        if remaining() < 60 + 2 * t5:
            raise TimeoutError("budget after Q5")
        t5b = bench_query(
            s5, "SELECT x % 1024 AS k, count() AS c, sum(x) FROM big "
                "GROUP BY k ORDER BY c DESC LIMIT 10 "
                "SETTINGS stream_readers = 2", reps=1)
        log(f"Q5b {tag} group-by(1k) over {STREAM_ROWS/1e9:.1f}B rows: "
            f"{t5b:.2f} s = {STREAM_ROWS/t5b/1e9:.2f} G rows/s, wire "
            f"{STREAM_ROWS/t5b*2.5/1e9:.3f} GB/s, "
            f"fraction {(STREAM_ROWS/t5b)/roof:.3f}")
        del s5
        gc.collect()
    except Exception as e:
        fail("Q5 streamed-1B", e)

    try:
        if remaining() < 180:
            raise TimeoutError("budget before Q6")
        import gc
        s6 = ch.connect()
        s6.execute("CREATE TABLE dim (k Int64, label Int64)")
        s6.insert_pydict("dim", {
            "k": np.arange(JOIN_DIM, dtype=np.int64),
            "label": (np.arange(JOIN_DIM, dtype=np.int64) * 7) % 97})
        s6.execute("CREATE TABLE fact (fk Int64)")
        CH = 250_000_000
        for ci, lo in enumerate(range(0, JOIN_ROWS, CH)):
            hi = min(lo + CH, JOIN_ROWS)
            s6.insert_pydict("fact", {"fk": got(
                f"fact6_fk_{ci}",
                lambda lo=lo, hi=hi: (np.arange(lo, hi, dtype=np.int64)
                                      * 40503) % JOIN_DIM)})
        log(f"join tables ready ({JOIN_ROWS/1e9:.1f}B x {JOIN_DIM/1e6:.0f}M)")
        before_stream = s6.profile_events.get("StreamedQueries", 0)
        t6 = bench_query(
            s6, "SELECT count(), sum(label) FROM fact "
                "INNER JOIN dim ON fact.fk = dim.k "
                "SETTINGS stream_readers = 2", reps=1)
        streamed6 = s6.profile_events.get("StreamedQueries",
                                          0) > before_stream
        jr = JOIN_ROWS / t6
        tag = "STREAMED" if streamed6 else "whole-block (fits the device)"
        xtra = (f"; transfer-roofline fraction {jr/(xfer_bps/4):.3f}"
                if (streamed6 and xfer_bps) else "")
        log(f"Q6 {tag} join {JOIN_ROWS/1e9:.1f}B x {JOIN_DIM/1e6:.0f}M: "
            f"{t6:.2f} s = {jr/1e9:.2f} G rows/s{xtra}")
        del s6
        gc.collect()
    except Exception as e:
        fail("Q6 streamed join", e)

    try:
        if remaining() < 150:
            raise TimeoutError("budget")
        # device-ColumnString: high-cardinality string GROUP BY + prefix
        # predicate; dictionary byte matrix is device-resident, the
        # per-unique LUT computes on device
        ns = min(N_ROWS, 50_000_000)   # host string-ingest cost bounds this
        n_distinct_s = ns // 2

        def _build_urls():
            return np.char.add(
                "http://example.com/p",
                (np.arange(ns) % n_distinct_s).astype(str))
        surl = got("urls_50m", _build_urls)
        s.execute("CREATE TABLE hits_s (url String)")
        s.insert_pydict("hits_s", {"url": surl})
        del surl
        t_sgrp = bench_query(
            s, "SELECT count() FROM (SELECT url, count() AS c FROM hits_s "
               "GROUP BY url) SETTINGS max_groups = 67108864", reps=2)
        log(f"Q7 string GROUP BY ({n_distinct_s/1e6:.0f}M distinct of "
            f"{ns/1e6:.0f}M rows): {t_sgrp*1e3:.1f} ms = "
            f"{ns/t_sgrp/1e9:.2f} G rows/s")
        t_spre = bench_query(
            s, "SELECT count() FROM hits_s "
               "WHERE startsWith(url, 'http://example.com/p1')", reps=3)
        log(f"Q7b string startsWith filter: {t_spre*1e3:.1f} ms = "
            f"{ns/t_spre/1e9:.2f} G rows/s")
        s.execute("DROP TABLE hits_s")
    except Exception as e:
        fail("Q7 string bench", e)

    try:
        if remaining() < 150:
            raise TimeoutError("budget")
        # fresh session: drop the hits table's device residency before the
        # join working set
        del s
        import gc
        gc.collect()
        s2 = ch.connect()
        n_fact = N_ROWS
        n_dim = 1_000_000
        s2.execute("CREATE TABLE dim (k Int64, label Int64)")
        s2.insert_pydict("dim", {
            "k": np.arange(n_dim, dtype=np.int64),
            "label": (np.arange(n_dim, dtype=np.int64) * 7) % 97})
        s2.execute("CREATE TABLE fact (fk Int64)")
        s2.insert_pydict("fact", {
            "fk": got("fact_fk_100m", lambda: (
                np.arange(n_fact, dtype=np.int64) * 40503) % n_dim)})
        # propagate join (ops/join_ops.py propagate_join): dim.k is unique,
        # so the planner picks the N:1 single-sort path — no expansion, no
        # gathers, output capacity == probe capacity
        t_join = bench_query(
            s2, "SELECT count(), sum(label) FROM fact "
                "INNER JOIN dim ON fact.fk = dim.k", reps=5)
        # probe/gather roofline (BASELINE: join target is probe-bound): the
        # irreducible per-row random access, measured as one raw gather of
        # n_fact indices from a device-resident table on this same device
        idx_d = jnp.asarray((np.arange(n_fact, dtype=np.int64) * 40503)
                            % n_dim, jnp.int32)
        tbl_d = jnp.arange(n_dim, dtype=jnp.int32)
        gfn = jax.jit(lambda t, i: t[i].astype(jnp.int64).sum())
        jax.block_until_ready(gfn(tbl_d, idx_d))
        tg = []
        for _ in range(3):
            t0g = time.perf_counter()
            jax.block_until_ready(gfn(tbl_d, idx_d))
            tg.append(time.perf_counter() - t0g)
        t_gather = float(np.min(tg))
        frac_j = t_gather / t_join
        log(f"Q4 join {n_fact/1e6:.0f}M x 1M: {t_join*1e3:.1f} ms "
            f"({n_fact/t_join/1e9:.2f} G rows/s); probe roofline "
            f"{t_gather*1e3:.1f} ms -> fraction {frac_j:.3f}")
        del s2, idx_d, tbl_d
        gc.collect()
    except Exception as e:
        fail("Q4", e)

    try:
        if remaining() < 150:
            raise TimeoutError("budget")
        # Q8: brute-force vector similarity as matrix products (the
        # reference answers this with an HNSW index,
        # MergeTreeIndexVectorSimilarity; here distances are (N,D)x(D,)
        # products + device top-k).  Roofline: the device-memory read of
        # the f32 vector matrix (memory-bound at D=128).
        import gc
        s8 = ch.connect()
        NV, DV = 10_000_000, 128
        V8 = got("vecs_10m", lambda: np.random.default_rng(8).normal(
            size=(NV, DV)).astype(np.float32))
        s8.execute("CREATE TABLE vecs (id Int64, v Array(Float32))")
        s8.insert_pydict("vecs", {"id": np.arange(NV, dtype=np.int64),
                                  "v": V8})
        q8 = np.random.default_rng(9).normal(size=DV).astype(np.float32)
        qs8 = ("CAST([" + ",".join(f"{x:.5f}" for x in q8)
               + "] AS Array(Float32))")
        sql8 = (f"SELECT id FROM vecs ORDER BY cosineDistance(v, {qs8}) "
                f"LIMIT 10")
        t_vec = bench_query(s8, sql8, reps=5)
        # device time isolated from the per-call host overhead (same
        # estimator as Q1)
        t_vec_dev = device_time_repeat(s8, sql8, k_lo=2, k_hi=8, reps=5,
                                       trials=3)
        if t_vec_dev < 2e-3:
            # degenerate slope: fall back to end-to-end minus the fixed
            # dispatch overhead measured at Q1
            t_vec_dev = max(t_vec - t_null, 1e-3)
        roof_vec = NV * DV * 4 / peak_bps
        log(f"Q8 vector top-10 of {NV/1e6:.0f}M x {DV}: {t_vec*1e3:.1f} ms "
            f"end-to-end, device {t_vec_dev*1e3:.1f} ms "
            f"({NV/t_vec_dev/1e9:.2f} G vecs/s); memory roofline "
            f"{roof_vec*1e3:.1f} ms -> device fraction "
            f"{roof_vec/t_vec_dev:.3f}")
        del s8, V8
        gc.collect()
    except Exception as e:
        fail("Q8 vector bench", e)

    log(f"bench complete in {time.time()-_T0:.0f}s")
    if FAILED:
        log(f"failed stages: {', '.join(FAILED)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Device-resident string predicates (core/column.py Dictionary.device_bytes
+ exprs/functions.py _device_prefix_lut).

The device ColumnString: dictionary values live as a device-resident
fixed-width byte matrix; prefix/suffix predicates compute per-unique on the
device and reach rows through the code gather (reference: ColumnString
offsets+chars + SIMD filters, src/Columns/ColumnsCommon.cpp:145).
"""
import numpy as np
import pytest

import clickhouse_tpu as ch
from clickhouse_tpu.core.column import Dictionary


def _big_url_session(n=200_000):
    s = ch.connect()
    urls = np.char.add("http://site", np.arange(n).astype(str))
    urls = np.char.add(urls, np.where(np.arange(n) % 2 == 0,
                                      "/index", "/page"))
    s.execute("CREATE TABLE h (url String, v Int64)")
    s.insert_pydict("h", {"url": urls.astype(object),
                          "v": np.arange(n, dtype=np.int64)})
    return s, urls


class TestDeviceBytes:
    def test_matrix_layout(self):
        d = Dictionary(np.asarray(["ab", "", "xyz!"], object), sorted_=True)
        mat, lens, w = d.device_bytes()
        assert w == 4 and lens.tolist() == [2, 0, 4]
        assert bytes(mat[0][:2]) == b"ab"
        assert bytes(mat[2][:4]) == b"xyz!"

    def test_reversed_matrix(self):
        d = Dictionary(np.asarray(["abc", "x"], object))
        rev, lens, w = d.device_bytes_reversed()
        assert bytes(rev[0][:3]) == b"cba"
        assert bytes(rev[1][:1]) == b"x"

    def test_width_clip(self):
        d = Dictionary(np.asarray(["a" * 200], object))
        mat, lens, w = d.device_bytes()
        assert w == Dictionary.DEVICE_BYTES_MAX_W
        assert lens.tolist() == [200]

    def test_sorted_lookup(self):
        vals = np.unique(np.char.add("k", np.arange(10_000).astype(str)))
        d = Dictionary(vals.astype(object), sorted_=True)
        assert d.lookup("k42") == int(np.searchsorted(vals, "k42"))
        assert d.lookup("missing_zz") == -1

    def test_unify_vectorized_big_sorted(self):
        vals = np.unique(np.char.add("v", np.arange(8192).astype(str)))
        a = Dictionary(vals.astype(object), sorted_=True)
        b = Dictionary(np.asarray(["v100", "not_there"], object))
        merged, ra, rb = Dictionary.unify(a, b)
        assert merged.values[rb[0]] == "v100"
        assert merged.values[rb[1]] == "not_there"
        assert len(merged) == len(a) + 1


class TestDeviceStringPredicates:
    """Large dictionaries route through the device byte matrix."""

    @pytest.fixture(scope="class")
    def sess(self):
        return _big_url_session()

    def test_startswith(self, sess):
        s, urls = sess
        got = s.execute("SELECT count() FROM h "
                        "WHERE startsWith(url, 'http://site1')").scalar()
        assert got == int(np.char.startswith(urls, "http://site1").sum())

    def test_endswith(self, sess):
        s, urls = sess
        got = s.execute("SELECT count() FROM h "
                        "WHERE endsWith(url, '/index')").scalar()
        assert got == len(urls) // 2

    def test_like_prefix_and_suffix(self, sess):
        s, urls = sess
        got = s.execute("SELECT count() FROM h "
                        "WHERE url LIKE 'http://site99%'").scalar()
        assert got == int(np.char.startswith(urls, "http://site99").sum())
        got2 = s.execute("SELECT count() FROM h "
                         "WHERE url LIKE '%/page'").scalar()
        assert got2 == len(urls) // 2

    def test_not_like(self, sess):
        s, urls = sess
        got = s.execute("SELECT count() FROM h "
                        "WHERE url NOT LIKE 'http://site1%'").scalar()
        assert got == int((~np.char.startswith(urls, "http://site1")).sum())

    def test_group_by_high_cardinality(self, sess):
        s, urls = sess
        got = s.execute(
            "SELECT count() FROM (SELECT url, count() AS c FROM h "
            "GROUP BY url) SETTINGS max_groups = 262144").scalar()
        assert got == len(np.unique(urls))

    def test_prefix_filter_then_group(self, sess):
        s, urls = sess
        rows = s.execute(
            "SELECT endsWith(url, '/index') AS e, count() FROM h "
            "WHERE startsWith(url, 'http://site12') "
            "GROUP BY e ORDER BY e").rows()
        m = np.char.startswith(urls, "http://site12")
        idx = int((m & np.char.endswith(urls, "/index")).sum())
        pg = int((m & np.char.endswith(urls, "/page")).sum())
        assert rows == [(0, pg), (1, idx)]

    def test_small_dict_host_path_agrees(self):
        # under the device threshold the host LUT answers; same semantics
        s = ch.connect()
        s.execute("CREATE TABLE t (s String)")
        s.execute("INSERT INTO t VALUES ('apple'), ('apricot'), ('banana')")
        assert s.execute("SELECT count() FROM t "
                         "WHERE startsWith(s, 'ap')").scalar() == 2
        assert s.execute("SELECT count() FROM t "
                         "WHERE endsWith(s, 'a')").scalar() == 1

    def test_utf8_prefix(self):
        s = ch.connect()
        s.execute("CREATE TABLE t (s String)")
        s.execute("INSERT INTO t VALUES ('héllo'), ('hello'), ('héllo2')")
        assert s.execute("SELECT count() FROM t "
                         "WHERE startsWith(s, 'héllo')").scalar() == 2


class TestHashTokenDictionary:
    """Hash-token factorization for high-cardinality strings
    (core/column.py factorize_strings): beyond HASH_FACTORIZE_MIN_ROWS the
    dictionary is built from 128-bit CityHash tokens (no lexicographic
    string sort); grouping stays on int32 codes on device, literal lookups
    binary-search the sorted token array."""

    @pytest.fixture()
    def hash_session(self, monkeypatch):
        from clickhouse_tpu.core import column as C
        monkeypatch.setattr(C, "HASH_FACTORIZE_MIN_ROWS", 64)
        s = ch.connect()
        s.execute("CREATE TABLE ht (u String, k Int64)")
        n = 4000
        s.insert_pydict("ht", {
            "u": np.array([f"http://e.com/p{i % 900}" for i in range(n)],
                          object),
            "k": np.arange(n, dtype=np.int64) % 5})
        return s

    def test_group_by_and_lookup(self, hash_session):
        s = hash_session
        t = s.catalog.get_table("default", "ht")
        blk = t.read_block()
        dic = blk.columns["u"].dictionary
        assert dic is not None and not dic.sorted_
        assert dic._hash_sorted is not None        # hash-token mode engaged
        assert s.execute("SELECT count(DISTINCT u) FROM ht").rows() \
            == [(900,)]
        top = s.execute("SELECT u, count() AS c FROM ht GROUP BY u "
                        "ORDER BY c DESC, u LIMIT 2").rows()
        assert top[0][1] >= top[1][1]
        assert s.execute(
            "SELECT count() FROM ht WHERE u = 'http://e.com/p7'"
        ).rows() == [(5,)]
        assert s.execute(
            "SELECT count() FROM ht WHERE u = 'missing'").rows() == [(0,)]

    def test_streamed_group_by_on_hash_tokens(self, hash_session):
        s = hash_session
        st = {"max_device_block_bytes": 1, "stream_chunk_rows": 1024}
        plain = s.execute(
            "SELECT u, count() AS c FROM ht GROUP BY u "
            "ORDER BY c DESC, u LIMIT 5").rows()
        streamed = s.execute(
            "SELECT u, count() AS c FROM ht GROUP BY u "
            "ORDER BY c DESC, u LIMIT 5", settings=st).rows()
        assert plain == streamed

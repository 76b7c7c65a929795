"""Float64 keys are exact: GROUP BY, DISTINCT, ORDER BY and JOIN over keys
that differ by one ulp, lie beyond the float32 range, are denormal, or are
+-0.0 / NaN, against numpy.

The engine's key semantics (ops/hash_ops.py f64_token): two keys are equal
iff their IEEE bit patterns are equal (-0.0 != +0.0, a NaN equals a NaN of
the same bits), and keys order by the float total order with NaN last.
"""
import numpy as np
import pytest

import clickhouse_tpu as ch

KEY_SETS = {
    "ulp_adjacent": [v for b in (1.0, 1e-3, -7.25, 1e200, 123456.789)
                     for v in (np.nextafter(b, -np.inf), b,
                               np.nextafter(b, np.inf))],
    "beyond_f32": [3.5e38, np.nextafter(3.5e38, np.inf), 1e300, -1e300,
                   1e39, -1e39, 1.7976931348623157e308, 1e-50, 1e-46],
    "denormal": [5e-324, -5e-324, 1e-310, np.nextafter(1e-310, 0.0),
                 2.2250738585072009e-308, 2.2250738585072014e-308, 1e-320],
    "signed_zero_nan": [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0],
}


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.uint64)


def _order(a):
    b = _bits(a)
    return np.where(b >> np.uint64(63) == 1, ~b, b | np.uint64(1 << 63))


def _table(name):
    keys = np.asarray(KEY_SETS[name], np.float64)
    rng = np.random.default_rng(len(keys))
    idx = rng.integers(0, len(keys), 400)
    idx[:len(keys)] = np.arange(len(keys))        # every key present
    f = keys[idx]
    k = rng.integers(0, 1000, len(f))
    s = ch.connect()
    s.execute("CREATE TABLE t (f Float64, k Int64)")
    s.insert_pydict("t", {"f": f, "k": k})
    dim_keys = keys[::2]                          # ulp neighbours miss
    labels = np.arange(len(dim_keys), dtype=np.int64) + 1
    s.execute("CREATE TABLE d (fk Float64, label Int64)")
    s.insert_pydict("d", {"fk": dim_keys, "label": labels})
    return s, keys, idx, f, k, dim_keys, labels


@pytest.mark.parametrize("op", ["group_by", "distinct", "order_by", "join"])
@pytest.mark.parametrize("key_set", sorted(KEY_SETS))
def test_float64_keys_exact(key_set, op):
    s, keys, idx, f, k, dim_keys, labels = _table(key_set)
    assert len(np.unique(_bits(keys))) == len(keys)
    if op == "group_by":
        got = s.execute("SELECT f, count() AS c, sum(k) AS s FROM t "
                        "GROUP BY f").columns
        gf, gc, gs = got["f"], got["c"], got["s"]
        o = np.argsort(_order(gf))
        want = np.argsort(_order(keys))
        np.testing.assert_array_equal(_bits(gf[o]), _bits(keys[want]))
        np.testing.assert_array_equal(
            gc[o], np.bincount(idx, minlength=len(keys))[want])
        np.testing.assert_array_equal(
            gs[o], np.bincount(idx, weights=k, minlength=len(keys))
            .astype(np.int64)[want])
    elif op == "distinct":
        got = s.execute("SELECT DISTINCT f FROM t").columns["f"]
        assert sorted(_bits(got).tolist()) == sorted(_bits(keys).tolist())
        n = s.execute("SELECT count(DISTINCT f) FROM t").scalar()
        assert n == len(keys)
    elif op == "order_by":
        got = s.execute("SELECT f, k FROM t ORDER BY f, k").columns
        o = np.lexsort((k, _order(f)))
        np.testing.assert_array_equal(_bits(got["f"]), _bits(f[o]))
        np.testing.assert_array_equal(got["k"], k[o])
    else:
        got = s.execute("SELECT count() AS c, sum(label) AS s FROM t "
                        "INNER JOIN d ON t.f = d.fk").columns
        label_of = dict(zip(_bits(dim_keys).tolist(), labels.tolist()))
        hits = [label_of[b] for b in _bits(f).tolist() if b in label_of]
        assert got["c"][0] == len(hits)
        assert got["s"][0] == sum(hits)

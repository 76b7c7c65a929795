"""Kernel-level tests for the ops layer (filter/group/sort/join cores).

Golden results computed with numpy/pandas — the role the reference's
.reference files play for its stateless SQL tests (SURVEY.md §4).
"""
import numpy as np
import pandas as pd
import pytest

import jax
import jax.numpy as jnp

from clickhouse_tpu.ops import agg_ops, filter_ops, hash_ops, join_ops, sort_ops
from clickhouse_tpu.core.column import pad_to

RNG = np.random.default_rng(42)


def _padded(arr, cap=None, fill=0):
    arr = np.asarray(arr)
    cap = cap or pad_to(len(arr))
    out = np.full(cap, fill, dtype=arr.dtype)
    out[:len(arr)] = arr
    return jnp.asarray(out), len(arr)


def _valid_mask(n, cap):
    return jnp.arange(cap) < n


class TestHash:
    def test_distinct_values_distinct_hashes(self):
        x = jnp.asarray(np.arange(10000, dtype=np.int64))
        h = np.asarray(hash_ops.hash64(x))
        assert len(np.unique(h)) == 10000

    def test_dtype_stability(self):
        a = hash_ops.hash64(jnp.asarray(np.array([1, 2, 3], np.int32)))
        b = hash_ops.hash64(jnp.asarray(np.array([1, 2, 3], np.int64)))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_multi_column_order_matters(self):
        x = jnp.asarray(np.array([1, 2], np.int64))
        y = jnp.asarray(np.array([2, 1], np.int64))
        h1 = np.asarray(hash_ops.hash_columns([x, y]))
        h2 = np.asarray(hash_ops.hash_columns([y, x]))
        assert h1[0] != h2[0]

    def test_buckets_in_range(self):
        x = jnp.asarray(RNG.integers(0, 1 << 60, 5000).astype(np.int64))
        b = np.asarray(hash_ops.bucket_of(hash_ops.hash64(x), 256))
        assert b.min() >= 0 and b.max() < 256
        # reasonably uniform
        counts = np.bincount(b, minlength=256)
        assert counts.min() > 0

    def test_f64_token_total_order_and_roundtrip(self):
        """Token order == float total order, -0.0 < +0.0, NaN last; decode
        is the bit-exact inverse."""
        vals = np.concatenate([
            RNG.standard_normal(20000) * 10.0 ** RNG.integers(-300, 300,
                                                              20000),
            np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
                      1.7976931348623157e308, 5e-324, np.nan])])
        tok = np.asarray(jax.jit(hash_ops.f64_token)(jnp.asarray(vals)))
        dec = np.asarray(hash_ops.f64_from_token(jnp.asarray(tok)))
        np.testing.assert_array_equal(dec.view(np.uint64),
                                      vals.view(np.uint64))
        order = np.argsort(tok, kind="stable")
        sv = vals[order]
        finite = sv[~np.isnan(sv)]
        assert (np.diff(finite) >= 0).all()
        assert np.isnan(sv[-1])          # NaN sorts last
        # -0.0 strictly before +0.0
        tn = np.asarray(hash_ops.f64_token(jnp.asarray([-0.0, 0.0])))
        assert tn[0] < tn[1]


class TestFilter:
    def test_compaction_matches_numpy(self):
        vals = RNG.integers(-100, 100, 3000).astype(np.int64)
        data, n = _padded(vals)
        cap = data.shape[0]
        mask = (data > 0) & _valid_mask(n, cap)
        out, count = filter_ops.compact_arrays([data], mask)
        expected = vals[vals > 0]
        assert int(count) == len(expected)
        np.testing.assert_array_equal(np.asarray(out[0])[:len(expected)], expected)

    def test_empty_selection(self):
        data, n = _padded(np.arange(100, dtype=np.int64))
        mask = jnp.zeros(data.shape[0], bool)
        out, count = filter_ops.compact_arrays([data], mask)
        assert int(count) == 0

    def test_all_selected(self):
        vals = np.arange(50, dtype=np.float64)
        data, n = _padded(vals)
        mask = _valid_mask(n, data.shape[0])
        out, count = filter_ops.compact_arrays([data], mask)
        assert int(count) == 50
        np.testing.assert_array_equal(np.asarray(out[0])[:50], vals)


class TestGroupBy:
    def test_single_key_sum_count(self):
        n = 5000
        keys = RNG.integers(0, 37, n).astype(np.int64)
        vals = RNG.normal(size=n)
        kd, _ = _padded(keys)
        vd, _ = _padded(vals)
        cap = kd.shape[0]
        valid = _valid_mask(n, cap)
        g = agg_ops.group_by_sort([kd], valid, num_groups_cap=1024)
        assert int(g.num_groups) == 37
        sums = g.reduce("sum", vd, valid)
        counts = g.count_rows(valid)
        df = pd.DataFrame({"k": keys, "v": vals}).groupby("k").agg(
            s=("v", "sum"), c=("v", "count")).reset_index().sort_values("k")
        got_keys = np.asarray(g.unique_keys[0])[:37]
        order = np.argsort(got_keys)
        np.testing.assert_array_equal(got_keys[order], df["k"].values)
        np.testing.assert_allclose(np.asarray(sums)[:37][order],
                                   df["s"].values, rtol=1e-9)
        np.testing.assert_array_equal(np.asarray(counts)[:37][order],
                                      df["c"].values)

    def test_multi_key(self):
        n = 2000
        k1 = RNG.integers(0, 5, n).astype(np.int64)
        k2 = RNG.integers(0, 7, n).astype(np.int32)
        kd1, _ = _padded(k1)
        kd2, _ = _padded(k2)
        cap = kd1.shape[0]
        valid = _valid_mask(n, cap)
        g = agg_ops.group_by_sort([kd1, kd2], valid, num_groups_cap=256)
        expected = len(set(zip(k1, k2)))
        assert int(g.num_groups) == expected

    def test_min_max(self):
        n = 3000
        keys = RNG.integers(0, 11, n).astype(np.int64)
        vals = RNG.integers(-1000, 1000, n).astype(np.int64)
        kd, _ = _padded(keys)
        vd, _ = _padded(vals)
        cap = kd.shape[0]
        valid = _valid_mask(n, cap)
        g = agg_ops.group_by_sort([kd], valid, 64)
        mins = g.reduce("min", vd, valid)
        maxs = g.reduce("max", vd, valid)
        df = pd.DataFrame({"k": keys, "v": vals}).groupby("k").agg(
            mn=("v", "min"), mx=("v", "max")).reset_index()
        got_keys = np.asarray(g.unique_keys[0])[:11]
        order = np.argsort(got_keys)
        np.testing.assert_array_equal(np.asarray(mins)[:11][order], df["mn"].values)
        np.testing.assert_array_equal(np.asarray(maxs)[:11][order], df["mx"].values)

    def test_empty_input(self):
        kd, _ = _padded(np.array([], np.int64), cap=1024)
        valid = jnp.zeros(1024, bool)
        g = agg_ops.group_by_sort([kd], valid, 16)
        assert int(g.num_groups) == 0


class TestSort:
    def test_order_token_int_order(self):
        vals = np.array([-5, 3, 0, -1, 7, np.iinfo(np.int64).min,
                         np.iinfo(np.int64).max], np.int64)
        tok = np.asarray(sort_ops.order_token(jnp.asarray(vals)))
        assert list(np.argsort(tok)) == list(np.argsort(vals, kind="stable"))

    def test_order_token_float_order(self):
        # Note -0.0 < 0.0 under the total order (SQL allows either tie order).
        vals = np.array([-1.5, 2.25, 0.0, -0.0, 1e300, -1e300, 3.5], np.float64)
        tok = np.asarray(sort_ops.order_token(jnp.asarray(vals)))
        np.testing.assert_array_equal(vals[np.argsort(tok)], np.sort(vals))

    def test_sort_permutation_multikey_desc(self):
        n = 1000
        a = RNG.integers(0, 10, n).astype(np.int64)
        b = RNG.normal(size=n)
        ad, _ = _padded(a)
        bd, _ = _padded(b)
        cap = ad.shape[0]
        valid = _valid_mask(n, cap)
        t1 = sort_ops.order_token(ad)
        t2 = sort_ops.order_token(bd, descending=True)
        perm = np.asarray(sort_ops.sort_permutation([t1, t2], valid))[:n]
        df = pd.DataFrame({"a": a, "b": b}).sort_values(
            ["a", "b"], ascending=[True, False], kind="stable")
        np.testing.assert_array_equal(a[perm], df["a"].values)
        np.testing.assert_allclose(b[perm], df["b"].values)

    def test_topk(self):
        n = 5000
        vals = RNG.integers(0, 10**9, n).astype(np.int64)
        vd, _ = _padded(vals)
        valid = _valid_mask(n, vd.shape[0])
        tok = sort_ops.order_token(vd)
        idx = np.asarray(sort_ops.topk_permutation(tok, valid, 10))
        np.testing.assert_array_equal(vals[idx], np.sort(vals)[:10])


class TestJoin:
    def _join_df(self, lk, lv, rk, rv, how):
        left = pd.DataFrame({"k": lk, "lv": lv})
        right = pd.DataFrame({"k": rk, "rv": rv})
        return left.merge(right, on="k", how=how)

    @pytest.mark.parametrize("how", ["inner", "left"])
    def test_unique_build_keys(self, how):
        np_rng = np.random.default_rng(7)
        rk = np.arange(100, dtype=np.int64)
        rv = np_rng.normal(size=100)
        lk = np_rng.integers(-20, 120, 4000).astype(np.int64)
        lv = np_rng.normal(size=4000)

        rkd, rn = _padded(rk)
        lkd, ln = _padded(lk)
        rvalid = _valid_mask(rn, rkd.shape[0])
        lvalid = _valid_mask(ln, lkd.shape[0])

        table = join_ops.build_join_table([rkd], rvalid, group_capacity=256)
        pr = join_ops.probe_join_table(table, [lkd], lvalid)
        out_cap = lkd.shape[0]
        p_idx, b_pos, mmask, count = join_ops.expand_matches(
            pr, lvalid, out_cap, left=(how == "left"))
        b_idx = np.asarray(table.row_order)[
            np.clip(np.asarray(b_pos), 0, rkd.shape[0] - 1)]

        expected = self._join_df(lk, lv, rk, rv, how)
        cnt = int(count)
        assert cnt == len(expected)
        p_idx = np.asarray(p_idx)[:cnt]
        b_idx = b_idx[:cnt]
        mmask = np.asarray(mmask)[:cnt]
        got = pd.DataFrame({
            "k": lk[p_idx], "lv": lv[p_idx],
            "rv": np.where(mmask, rv[np.clip(b_idx, 0, 99)], np.nan),
        })
        got = got.sort_values(["k", "lv"]).reset_index(drop=True)
        expected = expected.sort_values(["k", "lv"]).reset_index(drop=True)
        np.testing.assert_array_equal(got["k"].values, expected["k"].values)
        np.testing.assert_allclose(
            got["rv"].values, expected["rv"].values, equal_nan=True)

    def test_duplicate_build_keys_expansion(self):
        rk = np.array([1, 1, 2, 3, 3, 3], np.int64)
        rv = np.array([10, 11, 20, 30, 31, 32], np.int64)
        lk = np.array([1, 2, 3, 4], np.int64)
        lv = np.array([100, 200, 300, 400], np.int64)

        rkd, rn = _padded(rk)
        lkd, ln = _padded(lk)
        rvalid = _valid_mask(rn, rkd.shape[0])
        lvalid = _valid_mask(ln, lkd.shape[0])

        table = join_ops.build_join_table([rkd], rvalid, 16)
        pr = join_ops.probe_join_table(table, [lkd], lvalid)
        p_idx, b_pos, mmask, count = join_ops.expand_matches(
            pr, lvalid, out_capacity=lkd.shape[0])
        cnt = int(count)
        assert cnt == 6  # 2 + 1 + 3
        p = np.asarray(p_idx)[:cnt]
        b = np.asarray(table.row_order)[
            np.clip(np.asarray(b_pos), 0, rkd.shape[0] - 1)][:cnt]
        got = sorted(zip(lk[p], rv[b]))
        assert got == [(1, 10), (1, 11), (2, 20), (3, 30), (3, 31), (3, 32)]

    def test_multi_key_join(self):
        rk1 = np.array([1, 1, 2], np.int64)
        rk2 = np.array([10, 20, 10], np.int64)
        lk1 = np.array([1, 1, 2, 2], np.int64)
        lk2 = np.array([10, 30, 10, 20], np.int64)

        rk1d, rn = _padded(rk1)
        rk2d, _ = _padded(rk2)
        lk1d, ln = _padded(lk1)
        lk2d, _ = _padded(lk2)
        rvalid = _valid_mask(rn, rk1d.shape[0])
        lvalid = _valid_mask(ln, lk1d.shape[0])

        table = join_ops.build_join_table([rk1d, rk2d], rvalid, 16)
        pr = join_ops.probe_join_table(table, [lk1d, lk2d], lvalid)
        p_idx, b_pos, mmask, count = join_ops.expand_matches(
            pr, lvalid, out_capacity=lk1d.shape[0])
        assert int(count) == 2  # (1,10) and (2,10)

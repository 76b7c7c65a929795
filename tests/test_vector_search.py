"""Vector similarity as matrix products (exprs/functions_ext.py
_register_distance matmul paths — the answer to the reference's HNSW index,
ref src/Storages/MergeTree/MergeTreeIndexVectorSimilarity.cpp): distances
over a big (N, D) vector column become f32 matmuls; ORDER BY distance
LIMIT k is matmul -> device top-k, exact (no graph approximation)."""
import numpy as np
import pytest

import clickhouse_tpu as ch


@pytest.fixture(scope="module")
def session():
    s = ch.connect()
    s.execute("CREATE TABLE vecs (id Int64, v Array(Float32), "
              "INDEX vidx v TYPE vector_similarity('hnsw', "
              "'cosineDistance') GRANULARITY 4) "
              "ENGINE = MergeTree ORDER BY id")
    rng = np.random.default_rng(0)
    N, D = 100_000, 32               # above the matmul fast-path threshold
    V = rng.normal(size=(N, D)).astype(np.float32)
    s.insert_pydict("vecs", {"id": np.arange(N, dtype=np.int64), "v": V})
    return s, V


def _query(D, seed=1):
    q = np.random.default_rng(seed).normal(size=D).astype(np.float32)
    qq = np.array([float(f"{x:.5f}") for x in q], np.float64)
    return "[" + ",".join(f"{x:.5f}" for x in q) + "]", qq


def test_cosine_top_k_exact(session):
    s, V = session
    qs, qq = _query(V.shape[1])
    rows = s.execute(
        f"SELECT id FROM vecs ORDER BY cosineDistance(v, {qs}) "
        f"LIMIT 5").rows()
    Vf = V.astype(np.float64)
    d = 1 - (Vf @ qq) / (np.linalg.norm(Vf, axis=1)
                         * np.linalg.norm(qq))
    assert [r[0] for r in rows] == np.argsort(d)[:5].tolist()


def test_l2_top_k_exact(session):
    s, V = session
    qs, qq = _query(V.shape[1], seed=2)
    rows = s.execute(
        f"SELECT id FROM vecs ORDER BY L2Distance(v, {qs}) "
        f"LIMIT 5").rows()
    d = np.linalg.norm(V.astype(np.float64) - qq, axis=1)
    assert [r[0] for r in rows] == np.argsort(d)[:5].tolist()


def test_index_registered(session):
    s, _ = session
    assert s.execute(
        "SELECT name, type FROM system.data_skipping_indices "
        "WHERE table = 'vecs'").rows() == [("vidx", "vector_similarity")]


def test_distance_with_filter(session):
    s, V = session
    qs, qq = _query(V.shape[1], seed=3)
    rows = s.execute(
        f"SELECT id FROM vecs WHERE id < 1000 "
        f"ORDER BY cosineDistance(v, {qs}) LIMIT 3").rows()
    Vf = V[:1000].astype(np.float64)
    d = 1 - (Vf @ qq) / (np.linalg.norm(Vf, axis=1)
                         * np.linalg.norm(qq))
    assert [r[0] for r in rows] == np.argsort(d)[:3].tolist()


def test_small_n_stays_exact_f64():
    s = ch.connect()
    s.execute("CREATE TABLE sm (v Array(Float64))")
    s.execute("INSERT INTO sm VALUES ([1.0, 0.0]), ([0.6, 0.8])")
    rows = s.execute(
        "SELECT cosineDistance(v, [1.0, 0.0]) FROM sm").rows()
    assert rows[0][0] == pytest.approx(0.0, abs=1e-12)
    assert rows[1][0] == pytest.approx(0.4, abs=1e-12)

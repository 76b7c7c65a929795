"""What the engine reads from or sets on its device and host: memory
budgets scaled to the device, the persistent compile cache's directory,
full-precision vector distances, and the native library's build key."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import clickhouse_tpu as ch
from clickhouse_tpu import compile_cache
from clickhouse_tpu.core import dtypes as dt
from clickhouse_tpu.core.settings import Settings
from clickhouse_tpu.exprs.expr import ColVal
from clickhouse_tpu.exprs.functions_ext import (_MATMUL_DISTANCE_MIN_ROWS,
                                                _matmul_dist_parts)
from clickhouse_tpu.native import build as native_build

BUDGETS = ("max_device_memory_bytes", "max_device_block_bytes",
           "stream_chunk_bytes")


# -- device memory budgets -------------------------------------------------

def test_budgets_scale_with_bytes_limit():
    limit = 60 << 30
    s = Settings().with_device_budgets({"bytes_limit": limit})
    assert s.max_device_memory_bytes == limit * 12 // 16
    assert s.max_device_block_bytes == limit * 2 // 16
    assert s.stream_chunk_bytes == limit // 32


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 5}])
def test_budgets_keep_defaults_without_bytes_limit(stats, monkeypatch):
    class Dev:
        def memory_stats(self):
            return stats
    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    s = Settings().with_device_budgets()
    for name in BUDGETS:
        assert getattr(s, name) == getattr(Settings(), name)


def test_budgets_keep_user_values():
    s = Settings(max_device_block_bytes=123).with_device_budgets(
        {"bytes_limit": 64 << 30})
    assert s.max_device_block_bytes == 123
    assert s.max_device_memory_bytes == 48 << 30


def test_session_derives_budgets_and_query_settings_override(monkeypatch):
    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 32 << 30}
    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    s = ch.connect()
    assert s.settings.max_device_block_bytes == 4 << 30
    monkeypatch.undo()
    s.execute("CREATE TABLE t (x Int64)")
    s.insert_pydict("t", {"x": np.arange(5000, dtype=np.int64)})

    def streamed(sql):
        before = s.profile_events.get("StreamedQueries", 0)
        assert s.execute(sql).scalar() == 2500
        return s.profile_events.get("StreamedQueries", 0) > before
    sql = "SELECT count() FROM t WHERE x >= 2500"
    assert not streamed(sql)
    assert streamed(sql + " SETTINGS max_device_block_bytes = 1, "
                    "stream_chunk_rows = 1024")


# -- compile cache -----------------------------------------------------------

@pytest.fixture
def cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_fixed_path_without_env(cache_config, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(ch.__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_compile_cache_env_sets_no_directory(cache_config, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/untouched"


# -- vector distances at full precision ---------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_distance_products_use_highest_precision(ragged):
    n, w = _MATMUL_DISTANCE_MIN_ROWS, 8
    arr = dt.Array(dt.Float32)

    def parts(a, q, lens):
        return _matmul_dist_parts([
            ColVal(arr, a, lengths=lens if ragged else jnp.int32(w)),
            ColVal(arr, q, lengths=jnp.int32(w))])

    jaxpr = jax.make_jaxpr(parts)(
        jax.ShapeDtypeStruct((n, w), jnp.float32),
        jax.ShapeDtypeStruct((w,), jnp.float32),
        jax.ShapeDtypeStruct((n,), jnp.int32))
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,
                                         jax.lax.Precision.HIGHEST)


# -- native library build key -------------------------------------------------

def test_native_library_keyed_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "a.cpp"
    src.write_text("int x;\n")
    monkeypatch.setattr(native_build, "SRC", str(src))
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "b"))
    first = native_build.lib_path()
    os.utime(src, (0, 0))                       # mtime alone changes nothing
    assert native_build.lib_path() == first
    src.write_text("int y;\n")
    assert native_build.lib_path() != first
    assert os.path.dirname(first) == str(tmp_path / "b")

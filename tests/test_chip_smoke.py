"""chip_smoke.py's phases at a tiny size on the CPU, each against its numpy
reference, and its refusal to report a result off the GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

TINY = cs.Sizes(rows=50_000, dim_rows=5_000, f_distinct=5_000,
                str_rows=20_000, str_distinct=10_000,
                vec_rows=1 << 16, vec_dim=16,
                stream_block_bytes=64 << 10, stream_chunk_bytes=32 << 10,
                search_keys=1 << 12, search_queries=1 << 18)
SEED = 3
REP = cs.Report("cpu")


@pytest.fixture(scope="module")
def loaded():
    import clickhouse_tpu as ch
    data = cs.make_hits(TINY, SEED)
    s = ch.connect()
    cs.load_hits(s, data, TINY, SEED)
    return s, data


PHASES = {
    "scan": cs.phase_scan,
    "group_dense": cs.phase_group_dense,
    "group_sort": cs.phase_group_sort,
    "group_f64": cs.phase_group_f64,
    "topn": cs.phase_topn,
    "join": cs.phase_join,
    "strings": lambda r, s, d, z: cs.phase_strings(r, s, d, z, SEED),
    "vectors": lambda r, s, d, z: cs.phase_vectors(r, s, d, z, SEED),
    "streamed": cs.phase_streamed,
    "http": cs.phase_http,
}


@pytest.mark.parametrize("phase", list(PHASES))
def test_phase_matches_reference(loaded, phase):
    s, data = loaded
    PHASES[phase](REP, s, data, TINY)


def test_probes_agree(loaded):
    _, data = loaded
    cs.run_probes(REP, data, TINY, SEED)


def test_four_card_path_on_virtual_devices():
    import jax
    assert len(jax.devices()) >= 4, "conftest forces 8 CPU devices"
    cs.four_cards(REP, cs.Sizes(rows=20_000, dim_rows=2_000), SEED)


def test_f64_pool_is_distinct_and_covers_the_edges():
    pool = cs.f64_pool(np.random.default_rng(0), 4096)
    bits = pool.view(np.uint64)
    assert len(np.unique(bits)) == len(pool) == 4096
    assert np.isnan(pool).any() and np.isinf(pool).sum() == 2
    zeros = bits[pool == 0]
    assert {0, 1 << 63} <= set(zeros.tolist())        # +0.0 and -0.0
    tiny = np.abs(pool[np.isfinite(pool)])
    assert ((tiny > 0) & (tiny < 2.2250738585072014e-308)).any()
    assert (tiny > 3.5e38).any()
    # neighbours one ulp apart
    fin = np.sort(pool[np.isfinite(pool)])
    assert (np.nextafter(fin[:-1], np.inf) == fin[1:]).any()


def test_scaled_sizes_shrink_rows_only():
    small = cs.Sizes().scaled(0.01)
    assert small.rows == 1_000_000 and small.vec_dim == 128
    assert small.x_range == cs.Sizes().x_range
    assert cs.Sizes().scaled(1.0) == cs.Sizes()


def test_main_refuses_without_gpu(capsys):
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_phases_on_gpu(gpu):
    """The same tiny phases on the card (compiled for it, no interpreter)."""
    import clickhouse_tpu as ch
    data = cs.make_hits(TINY, SEED)
    s = ch.connect()
    cs.load_hits(s, data, TINY, SEED)
    for phase in PHASES.values():
        phase(REP, s, data, TINY)

# Generated from tests/test_external_sort.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite external_sort); do not edit.
"""External (out-of-core) full ORDER BY: device scans tiles, host holds
and merges the runs (reference: sorted-run spill + merger,
src/common/sorting/sorted_run_merger.hpp)."""

from ddb_tpu_torch.testing import refsuite
import numpy as np
import pytest

import ddb_tpu_torch


@pytest.fixture()
def con():
    c = refsuite.connect()
    c.execute("SET external_threshold_rows = 20000")
    c.execute("SET tile_rows = 16384")
    return c


def _expected(con, sql):
    """Same query through the in-memory path (threshold lifted)."""
    con.execute("SET external_threshold_rows = 1000000000")
    rows = con.execute(sql).fetchall()
    con.execute("SET external_threshold_rows = 20000")
    return rows


def test_external_sort_matches_inmemory(con):
    n = 100_000
    rng = np.random.default_rng(1)
    con.register("big", {"a": np.arange(n),
                         "v": rng.integers(0, 500, n),
                         "f": rng.normal(size=n)})
    sql = "select v, a from big order by v desc, a"
    expect = _expected(con, sql)
    td = con.catalog.get_table("big")
    td.invalidate_cache()
    got = con.execute(sql).fetchall()
    assert got == expect
    assert not td._device_batches   # never materialized on device


def test_external_sort_nulls_and_projection(con):
    n = 60_000
    rng = np.random.default_rng(2)
    v = rng.integers(0, 100, n).astype(object)
    v[rng.random(n) < 0.04] = None
    con.register("big", {"a": np.arange(n), "v": v})
    sql = ("select v + 1, a from big where a % 3 = 0 "
           "order by v nulls first, a")
    expect = _expected(con, sql)
    got = con.execute(sql).fetchall()
    assert got == expect


def test_external_sort_strings(con):
    n = 50_000
    rng = np.random.default_rng(3)
    words = np.array([f"w{i:04d}" for i in range(300)])
    con.register("big", {"s": rng.choice(words, n),
                         "a": np.arange(n)})
    sql = "select s, a from big order by s desc, a"
    expect = _expected(con, sql)
    got = con.execute(sql).fetchall()
    assert got == expect

"""Out-of-core tiled execution, continued (test_torch_tiled.py holds the
comparison helpers): TPC-H 1, 6, 14 and 3 over the vendored sf0.01
tables at threshold 10,000 rows and tiles of 8,192 (lineitem's 60,175
rows stream in eight tiles), and NULLs that only the first tile holds.
Each statement must give the port's in-memory rows and the reference's
tiled rows, and take the same entry point in both packages.  Fault 3.15
is the named deviation: TPC-H Q1's averages of DECIMALs."""

import math
import os

import numpy as np
import pytest

from ddb_tpu.bench.tpch import TPCH_QUERIES, load_tbl
from test_torch_tiled import (RTOL, _carry, _pair, _rows, _same, check,
                              entries)
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "tpch_sf0.01")

assert entries      # the fixture, imported for the tests below


@pytest.fixture(scope="module")
def tpch():
    ref, port = _pair()
    for t in ("lineitem", "orders", "customer", "part"):
        load_tbl(ref, t, os.path.join(_DATA, f"{t}.csv.gz"))
        _carry(ref, port, t)
    return ref, port


@pytest.mark.parametrize("q,entry", [
    (6, "execute_tiled"), (14, "execute_tiled"),
    (3, "execute_external_join")])
def test_tpch_query_matches(tpch, entries, q, entry):
    assert check(*tpch, entries, TPCH_QUERIES[q], 10_000, 8_192, entry)


def test_fault_3_15_decimal_avg_is_divided_by_its_scale_once(tpch, entries):
    """TPC-H Q1 takes the tiled path in both packages.  The port's rows
    equal its in-memory rows; the reference's tiled avg over a
    DECIMAL(15,2) is the port's / 10^2 (avg_qty 0.254 for 25.40), and
    its other columns equal the port's exactly."""
    ref, port = tpch
    in_memory = _rows(port, TPCH_QUERIES[1])
    got = _rows(port, TPCH_QUERIES[1], 10_000, 8_192)
    want = _rows(ref, TPCH_QUERIES[1], 10_000, 8_192)
    assert entries["port"] == entries["ref"] == ["execute_tiled"]
    assert _same(in_memory, got) and len(got) == 4
    avg_cols = (6, 7, 8)
    for rw, rg in zip(want, got):
        assert _same([[v for i, v in enumerate(rw) if i not in avg_cols]],
                     [[v for i, v in enumerate(rg) if i not in avg_cols]])
        for i in avg_cols:
            assert math.isclose(rw[i] * 100, rg[i], rel_tol=RTOL)


@pytest.fixture(scope="module")
def holes():
    """140,000 rows, NULLs in the first 500 of x (the first tile only)."""
    ref, port = _pair()
    n = 140_000
    x = np.random.default_rng(4).integers(0, 50, n).tolist()
    x[:500] = [None] * 500
    ref.register("holes", {"k": np.arange(n) % 5, "x": x})
    _carry(ref, port, "holes")
    return ref, port


@pytest.mark.parametrize("sql,entry", [
    ("SELECT k, count(x), count(*), sum(x), min(x), max(x), avg(x) "
     "FROM holes GROUP BY k ORDER BY k", "execute_tiled"),
    ("SELECT x, k FROM holes WHERE x IS NULL OR x < 1 "
     "ORDER BY x NULLS FIRST, k", "execute_tiled_sort")])
def test_nulls_in_some_tiles_match(holes, entries, sql, entry):
    assert check(*holes, entries, sql, 50_000, 65_536, entry)

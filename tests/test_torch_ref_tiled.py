# Generated from tests/test_tiled.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite tiled); do not edit.
"""Out-of-core tiled execution vs in-memory results
(reference analog: external-mode operators under pragma verify_external,
src/main/client_config.hpp force_external)."""

from ddb_tpu_torch.testing import refsuite
import numpy as np
import pytest

import ddb_tpu_torch


@pytest.fixture(scope="module")
def big():
    con = refsuite.connect()
    rng = np.random.default_rng(3)
    n = 200_000
    con.register("big", {
        "g": rng.integers(0, 7, n),
        "v": rng.integers(0, 1000, n),
        "f": rng.random(n),
        "s": np.array(["alpha", "beta", "gamma", "delta"])[
            rng.integers(0, 4, n)],
    })
    return con


def _run_both(con, q):
    con.execute("SET external_threshold_rows = 100000000")
    con._plan_cache.clear()
    ref = con.execute(q).fetchall()
    con.execute("SET external_threshold_rows = 50000")
    con.execute("SET tile_rows = 65536")
    con._plan_cache.clear()
    got = con.execute(q).fetchall()
    con.execute("SET external_threshold_rows = 100000000")
    return ref, got


def _assert_close(ref, got):
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        for x, y in zip(a, b):
            if isinstance(x, float):
                assert abs(x - y) < 1e-9, (a, b)
            else:
                assert x == y, (a, b)


def test_tiled_grouped(big):
    ref, got = _run_both(big, (
        "SELECT g, count(*), sum(v), min(v), max(v), avg(f), min(s), "
        "max(s) FROM big WHERE v >= 10 GROUP BY g ORDER BY g"))
    _assert_close(ref, got)


def test_tiled_ungrouped(big):
    ref, got = _run_both(
        big, "SELECT count(*), sum(v), avg(v) FROM big WHERE g < 5")
    _assert_close(ref, got)


def test_tiled_fallback_holistic(big):
    # median is not decomposable: must fall back to in-memory, same result
    ref, got = _run_both(big, "SELECT median(v) FROM big")
    _assert_close(ref, got)


def test_tiled_with_order_limit(big):
    ref, got = _run_both(big, (
        "SELECT g, sum(v) AS s FROM big GROUP BY g ORDER BY s DESC "
        "LIMIT 3"))
    _assert_close(ref, got)


def test_tiled_topn(big):
    # out-of-core TopN: per-tile TopN kernels + final TopN over the
    # candidates (reference: physical_top_n.cpp bounded heap +
    # src/common/sort/ external sort)
    ref, got = _run_both(big, (
        "SELECT v, f, s FROM big WHERE g = 3 ORDER BY v DESC, f ASC "
        "LIMIT 25"))
    _assert_close(ref, got)


def test_tiled_topn_offset(big):
    ref, got = _run_both(big, (
        "SELECT v, s FROM big ORDER BY v, s LIMIT 10 OFFSET 7"))
    _assert_close(ref, got)


def test_tiled_topn_strings(big):
    ref, got = _run_both(big, (
        "SELECT s, v FROM big ORDER BY s DESC, v DESC LIMIT 12"))
    _assert_close(ref, got)


@pytest.fixture(scope="module")
def joined(big):
    con = big
    con.register("dim", {
        "g": np.arange(7),
        "label": np.array(["g0", "g1", "g2", "g3", "g4", "g5", "g6"]),
        "w": np.arange(7) * 10,
    })
    return con


def test_tiled_join_agg(joined):
    # big probe side streams in tiles; small build side stays resident
    ref, got = _run_both(joined, (
        "SELECT d.label, count(*), sum(b.v + d.w) FROM big b, dim d "
        "WHERE b.g = d.g AND b.v < 900 GROUP BY d.label ORDER BY d.label"))
    _assert_close(ref, got)


def test_tiled_semi_join_agg(joined):
    ref, got = _run_both(joined, (
        "SELECT count(*), sum(v) FROM big WHERE g IN "
        "(SELECT g FROM dim WHERE w >= 30)"))
    _assert_close(ref, got)

# Generated from tests/test_streaming.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite streaming); do not edit.
"""Streaming query results (reference: src/main/stream_query_result.cpp
+ main/buffered_data/): tile-by-tile result production with early LIMIT
exit; non-streamable plans fall back behind the same interface."""

from ddb_tpu_torch.testing import refsuite
import numpy as np

import ddb_tpu_torch


def test_stream_filter_projection():
    con = refsuite.connect()
    n = 200_000
    con.register("big", {"a": np.arange(n), "b": np.arange(n) % 7})
    s = con.stream("select a, b*2 from big where b = 3")
    first = s.fetchmany(5)
    assert first == [(3, 6), (10, 6), (17, 6), (24, 6), (31, 6)]
    total = len(first) + len(s.fetchall())
    assert total == sum(1 for i in range(n) if i % 7 == 3)


def test_stream_limit_offset_early_exit():
    con = refsuite.connect()
    n = 500_000
    con.register("big", {"a": np.arange(n)})
    s = con.stream("select a from big limit 3 offset 2")
    assert s.fetchall() == [(2,), (3,), (4,)]


def test_stream_does_not_materialize_device_table():
    """The streaming path must never build the whole-table device batch
    (that is the point: results larger than HBM stream through)."""
    con = refsuite.connect()
    n = 130_000
    con.register("big", {"a": np.arange(n)})
    td = con.catalog.get_table("big")
    s = con.stream("select a+1 from big where a % 2 = 0")
    assert len(s.fetchall()) == n // 2
    assert not td._device_batches


def test_stream_fallback_aggregate():
    con = refsuite.connect()
    con.register("t", {"g": [1, 1, 2], "v": [1, 2, 3]})
    s = con.stream("select g, sum(v) from t group by g order by g")
    assert s.fetchall() == [(1, 3), (2, 3)]


def test_stream_fetchone_and_iter():
    con = refsuite.connect()
    con.register("t", {"a": [1, 2, 3]})
    s = con.stream("select a from t")
    assert s.fetchone() == (1,)
    assert list(s) == [(2,), (3,)]

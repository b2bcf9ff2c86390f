"""The per-layer arithmetic on a synthetic trace, and the bytes each
query must move."""

import pytest

from portbench import columns, trace
from portbench.generators import tpch
from portbench.harness import reader
from portbench.tests.conftest import tiny


def _trace():
    # a 1,000 us window; kernels [100, 300) and [250, 400) overlap; a copy
    # [600, 700); a kernel outside the window is not counted
    return trace.Trace(
        window=(0.0, 1000.0),
        kernels=[(100.0, 300.0, "k_a"), (250.0, 400.0, "k_b"),
                 (1200.0, 1300.0, "k_late")],
        copies=[(600.0, 700.0, "Memcpy HtoD")],
        spans=[(0.0, 500.0, "q1"), (0.0, 450.0, "q1.execute"),
               (500.0, 1000.0, "q6"), (550.0, 900.0, "q6.execute")],
        queries=2, min_bytes=10**6, peak_bytes_per_s=1e9)


def test_idle_share():
    # busy: [100, 400) and [600, 700) = 400 of 1,000 us
    assert reader("device_idle_pct")(_trace()) == pytest.approx(60.0)


def test_launches_per_query():
    assert reader("kernel_launches_per_query")(_trace()) == 1.0


def test_bytes_roofline():
    # 1e6 bytes at 1e9 B/s = 1,000 us, over 300 us of kernels
    assert reader("bytes_roofline_pct")(_trace()) == pytest.approx(
        100 * 1000 / 300)


def test_readers_find_nothing_without_kernels():
    t = _trace()
    t.kernels = []
    for name in ("device_idle_pct", "kernel_launches_per_query",
                 "bytes_roofline_pct"):
        assert reader(name)(t) is None
    t = _trace()
    t.peak_bytes_per_s = None
    assert reader("bytes_roofline_pct")(t) is None


def test_breakdown_names_gaps_by_span():
    b = trace.breakdown(_trace())
    assert b["device_ops"][0] == ["k_a", pytest.approx(200e-6)]
    gaps = sorted(b["idle_gaps"], key=lambda g: g[1])
    # gaps: [0,100) in q1.execute, [400,600) at 500 -> q6 (starts at 500),
    # [700,1000) at 850 -> q6.execute
    assert [g[0] for g in gaps] == ["q1.execute", "q6", "q6.execute"]
    assert [g[1] for g in gaps] == pytest.approx([100e-6, 200e-6, 300e-6])


def test_chrome_events_parse():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 10, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "q1", "ts": 10,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 20,
         "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    t = trace.from_chrome(events)
    assert t.window == (10.0, 110.0)
    assert t.kernels == [(20.0, 25.0, "k")]
    assert t.copies == [(30.0, 35.0, "m")] and t.spans == [(10.0, 60.0, "q1")]


def test_query_bytes_follow_their_column_lists():
    mix = tiny("tpch_sf10", "scan_agg").mix
    rows = {"lineitem": 1000, "orders": 0, "customer": 0}
    # Q1: returnflag, linestatus (codes 4), quantity, extendedprice,
    # discount, tax (int64 8), shipdate (4)
    assert mix.read_bytes("q1", rows, tpch.KINDS, columns.width) == \
        1000 * (4 + 4 + 8 * 4 + 4)
    # Q6: shipdate (4), discount, quantity, extendedprice (8)
    assert mix.read_bytes("q6", rows, tpch.KINDS, columns.width) == \
        1000 * (4 + 8 * 3)
    assert mix.write_bytes("q1", 4) == 4 * 72
    join = tiny("tpch_sf10", "join").mix
    rows = {"lineitem": 1000, "orders": 100, "customer": 10}
    assert join.read_bytes("q3", rows, tpch.KINDS, columns.width) == \
        10 * 8 + 100 * 16 + 1000 * (4 + 8 + 8 + 4)
    assert join.read_bytes("q4", rows, tpch.KINDS, columns.width) == \
        100 * 12 + 1000 * 12

"""The port's spans (ddb_tpu_torch/spans.py) and the per-layer metrics
that read them (portbench/metrics/*_idle_pct.py, plan_cache_hit_pct.py).

The span tree comes from torch.profiler's Chrome trace, read by the
benchmark's own parser around a portbench.window span, on the CPU."""

import re
from pathlib import Path

import pytest
import torch

import ddb_tpu_torch
from ddb_tpu_torch import spans
from portbench import trace
from portbench.harness import load_cell, reader
from portbench.spans import innermost

ROOT = Path(__file__).resolve().parents[1]
LAYERS = ("api", "frontend", "executor", "storage")
NEW = [f"{x}_idle_pct" for x in LAYERS] + ["plan_cache_hit_pct"]
SQL = "SELECT k, sum(v) FROM t WHERE v > 0 GROUP BY k ORDER BY k"


@pytest.fixture()
def con():
    c = ddb_tpu_torch.connect("cpu")
    c.register("t", {"k": ["a", "b", "a", "c"], "v": [1, 2, 3, 4]})
    return c


def _record(fn) -> list:
    """The program's spans, (start, end, name) in order, of fn run under
    torch.profiler inside the benchmark's window span."""
    prof = trace.Profiler(cuda=False)
    with prof:
        with torch.profiler.record_function(trace.WINDOW):
            fn()
    return sorted((sp for sp in prof.trace.spans
                   if sp[2].startswith("ddb.")),
                  key=lambda sp: (sp[0], -sp[1]))


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _children(spans_, parent, name):
    return [sp for sp in spans_ if sp[2] == name and _within(sp, parent)]


def test_a_select_plans_once_then_hits_the_cache(con):
    got = _record(lambda: [con.execute(SQL) for _ in range(2)])
    calls = [sp for sp in got if sp[2] == "ddb.api.execute"]
    assert len(calls) == 2
    plans = []
    for call in calls:
        parse, = _children(got, call, "ddb.frontend.parse")
        plan, = _children(got, call, "ddb.frontend.plan")
        assert parse[1] <= plan[0]
        plans.append(plan)
        ops = [sp for sp in got if sp[2].startswith("ddb.exec.")
               and sp[0] >= plan[1]]
        assert {sp[2] for sp in ops} >= {"ddb.exec.Aggregate",
                                         "ddb.exec.Get"}
        assert all(_within(sp, call) for sp in ops if sp[0] < call[1])
    first, second = plans
    bind, = _children(got, first, "ddb.frontend.bind")
    optimize, = _children(got, first, "ddb.frontend.optimize")
    assert bind[1] <= optimize[0]
    assert not _children(got, second, "ddb.frontend.bind")
    assert not _children(got, second, "ddb.frontend.optimize")


def test_operator_spans_nest_as_the_plan(con):
    got = _record(lambda: con.execute(SQL))
    call, = [sp for sp in got if sp[2] == "ddb.api.execute"]
    ops = [sp for sp in got if sp[2].startswith("ddb.exec.")]
    assert ops and all(_within(sp, call) for sp in ops)
    agg, = [sp for sp in ops if sp[2] == "ddb.exec.Aggregate"]
    get, = [sp for sp in ops if sp[2] == "ddb.exec.Get"]
    assert _within(get, agg)
    # the first scan of t builds its batch: the upload inside the scan
    upload, = _children(got, get, "ddb.storage.upload")
    assert upload


def test_ctas_materialises_then_its_first_scan_uploads(con):
    def run():
        con.execute("CREATE TABLE t2 AS SELECT k, v * 2 AS w FROM t")
        con.execute("SELECT sum(w) FROM t2").fetchall()
    got = _record(run)
    ctas, select = [sp for sp in got if sp[2] == "ddb.api.execute"]
    mat, = _children(got, ctas, "ddb.storage.materialise")
    assert not _children(got, ctas, "ddb.storage.upload") or \
        _children(got, ctas, "ddb.storage.upload")[0][1] <= mat[0]
    up, = _children(got, select, "ddb.storage.upload")
    assert mat[1] <= up[0]


def test_fetches_record_the_copy_and_the_decode(con):
    res = con.execute(SQL)
    got = _record(lambda: (res.fetchall(), res.fetchnumpy()))
    fetches = [sp for sp in got if sp[2] == "ddb.api.fetch"]
    outer = [sp for sp in fetches
             if not any(o is not sp and _within(sp, o) for o in fetches)]
    # fetchall's decode holding the copy to the host, then fetchnumpy's
    # copy
    assert len(outer) == 2 and len(fetches) == 3
    assert not [sp for sp in got if sp[2] == "ddb.api.execute"]


def test_no_profiler_enters_no_record_function(con, monkeypatch):
    calls = []
    real = spans.record_function

    def counted(name):
        calls.append(name)
        return real(name)
    monkeypatch.setattr(spans, "record_function", counted)
    con.execute("CREATE TABLE t3 AS SELECT * FROM t")
    con.execute(SQL).fetchall()
    con.execute("SELECT count(*) FROM t3").fetchnumpy()
    assert calls == []
    got = _record(lambda: con.execute(SQL).fetchall())
    assert calls and len(calls) == len(got)


def test_only_spans_py_calls_record_function():
    pkg = ROOT / "ddb_tpu_torch"
    callers = sorted(str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
                     if "record_function" in p.read_text())
    assert callers == ["spans.py"]


def _tree(rows):
    return [re.sub(r"\([0-9.]+ ms, -?[0-9]+ rows\)", "()", r[0])
            for r in rows]


def test_explain_analyze_is_unchanged_under_a_profiler(con):
    sql = "EXPLAIN ANALYZE " + SQL
    plain = con.execute(sql).fetchall()
    box = []
    got = _record(lambda: box.append(con.execute(sql).fetchall()))
    assert _tree(box[0]) == _tree(plain)
    # the profiled plan's operators, inside its root (the text result is
    # scanned afterwards)
    ops = [sp for sp in got if sp[2].startswith("ddb.exec.")]
    assert len([sp for sp in ops if _within(sp, ops[0])]) == \
        sum("ms, " in r[0] for r in plain) >= 3


# ---- the readers on synthetic traces ------------------------------------

def _trace(kernels, spans_):
    return trace.Trace(window=(0.0, 1000.0), kernels=kernels,
                       spans=spans_, queries=1)


def _read(t):
    return {name: reader(name)(t) for name in NEW}


def test_one_gap_splits_exactly_across_layers():
    # idle [0, 100) and [600, 1000); the second gap lies in parse
    # [600, 700), then in the execute span alone [700, 800), then in an
    # operator [800, 1000)
    t = _trace([(100.0, 600.0, "k")],
               [(0.0, 1000.0, "q1.execute"),
                (50.0, 1000.0, "ddb.api.execute"),
                (600.0, 700.0, "ddb.frontend.parse"),
                (800.0, 1000.0, "ddb.exec.Join")])
    got = _read(t)
    # [0, 50) is the harness's alone
    assert got["api_idle_pct"] == pytest.approx(5.0 + 10.0)
    assert got["frontend_idle_pct"] == pytest.approx(10.0)
    assert got["executor_idle_pct"] == pytest.approx(20.0)
    assert got["storage_idle_pct"] == 0.0
    assert got["plan_cache_hit_pct"] is None


def test_idle_time_of_harness_spans_or_none_counts_nowhere():
    t = _trace([(100.0, 200.0, "k")],
               [(0.0, 50.0, "q1.fetch"),
                (200.0, 300.0, "ddb.storage.upload")])
    got = _read(t)
    assert got["storage_idle_pct"] == pytest.approx(10.0)
    assert got["api_idle_pct"] == got["frontend_idle_pct"] == \
        got["executor_idle_pct"] == 0.0
    assert reader("device_idle_pct")(t) == pytest.approx(90.0)


def test_the_four_shares_sum_to_the_idle_share_inside_the_program():
    t = _trace([(120.0, 180.0, "k"), (410.0, 470.0, "k"),
                (460.0, 520.0, "k2")],
               [(0.0, 1000.0, "ddb.api.execute"),
                (100.0, 200.0, "ddb.frontend.plan"),
                (110.0, 130.0, "ddb.frontend.bind"),
                (300.0, 900.0, "ddb.exec.Aggregate"),
                (350.0, 600.0, "ddb.exec.Get"),
                (360.0, 450.0, "ddb.storage.upload"),
                (950.0, 990.0, "ddb.api.fetch")])
    got = _read(t)
    shares = sum(got[f"{x}_idle_pct"] for x in LAYERS)
    assert shares == pytest.approx(reader("device_idle_pct")(t))
    # idle in the upload: [360, 410); in the plan and its bind: [100, 120)
    # and [180, 200)
    assert got["storage_idle_pct"] == pytest.approx(5.0)
    assert got["frontend_idle_pct"] == pytest.approx(4.0)


def test_the_plan_cache_hit_rate():
    plan = "ddb.frontend.plan"
    t = _trace([(0.0, 1.0, "k")],
               [(0.0, 100.0, plan), (10.0, 20.0, "ddb.frontend.bind"),
                (200.0, 210.0, plan), (300.0, 310.0, plan),
                (400.0, 500.0, plan), (420.0, 430.0, "ddb.frontend.bind"),
                (600.0, 610.0, "ddb.frontend.bind")])
    assert reader("plan_cache_hit_pct")(t) == pytest.approx(50.0)


def test_readers_find_nothing_without_the_programs_spans():
    # the parent program records only the harness's spans
    t = _trace([(100.0, 200.0, "k")], [(0.0, 1000.0, "q1.execute")])
    assert all(v is None for v in _read(t).values())
    t = _trace([], [(0.0, 1000.0, "ddb.api.execute")])
    assert all(v is None for v in _read(t).values())


def test_innermost_cuts_a_span_at_its_parents_end():
    got = innermost([(0.0, 10.0, "a"), (5.0, 15.0, "b"), (20.0, 30.0, "c"),
                     (20.0, 25.0, "d")])
    assert got == [(0.0, 5.0, "a"), (5.0, 10.0, "b"), (20.0, 25.0, "d"),
                   (25.0, 30.0, "c")]


@pytest.mark.parametrize("cell", ["tpch_sf10.scan_agg", "tpch_sf10.join",
                                  "h2oai_G1_1e8_1e2_0_0.basic"])
def test_every_cell_reports_the_new_metrics(cell):
    assert set(NEW) <= {m["name"] for m in load_cell(cell).per_layer}

"""The port's sort spans: one ddb.exec.sort for each torch.sort over a
batch-length operand (ops/order.py:sort_pass), each inside the operator
that sorts, and the per-layer metric of every cell that counts them.

The spans come from torch.profiler's Chrome trace, read by the
benchmark's own parser around a portbench.window span, on the CPU."""

import numpy as np
import pytest
import torch

import ddb_tpu_torch
from ddb_tpu_torch import spans
from ddb_tpu_torch.ops import join, order
from ddb_tpu_torch.ops.sortkey import encode_key
from ddb_tpu_torch.types import DOUBLE
from portbench import trace
from portbench.harness import ROOT, load_cell

SORT = "ddb.exec.sort"
ROWS = 3000


@pytest.fixture()
def con():
    rng = np.random.default_rng(7)
    c = ddb_tpu_torch.connect("cpu")
    c.register("t", {"k": rng.integers(0, 40, ROWS).tolist(),
                     "i": rng.integers(0, 1000, ROWS).tolist(),
                     "d": (rng.random(ROWS) * 200 - 100).tolist()})
    return c


def _record(fn) -> list:
    """The program's spans, (start, end, name) in order of start, of fn
    run under torch.profiler inside the benchmark's window span."""
    prof = trace.Profiler(cuda=False)
    with prof:
        with torch.profiler.record_function(trace.WINDOW):
            fn()
    return sorted((sp for sp in prof.trace.spans
                   if sp[2].startswith("ddb.")),
                  key=lambda sp: (sp[0], -sp[1]))


def _operator(got, sp):
    """The innermost operator span (ddb.exec.<Node>) holding sp."""
    around = [o for o in got if o[2].startswith("ddb.exec.")
              and o[2] != SORT and o[0] <= sp[0] and sp[1] <= o[1]]
    return around[-1][2] if around else None


def _operands(kinds):
    rng = torch.Generator().manual_seed(3)
    out = []
    for kind in kinds:
        if kind == "small":
            out.append(torch.randint(0, 40, (ROWS,), generator=rng))
        else:   # a DOUBLE key of both signs as the executor encodes it:
            # its span takes all 64 bits
            d = torch.rand(ROWS, generator=rng, dtype=torch.float64) - 0.5
            out += encode_key(d, None, DOUBLE)
    return out


@pytest.mark.parametrize("kinds, passes", [
    (("small",), 1),                    # keys and row id share a word
    (("small", "small"), 1),
    (("small", "double"), 2),           # a DOUBLE fills a word alone
    (("double",), 2),
    (("double", "double"), 3),
    (("small", "small", "double", "double"), 3),
], ids=lambda x: "-".join(x) if isinstance(x, tuple) else str(x))
def test_sort_permutation_records_one_span_a_pass(kinds, passes):
    ops = _operands(kinds)
    sel = torch.ones(ROWS, dtype=torch.bool)
    box = []
    got = _record(lambda: box.append(order.sort_permutation(ops, sel)))
    assert [sp[2] for sp in got] == [SORT] * passes
    # the permutation is the lexicographic order of the operands
    keys = np.stack([o.numpy() for o in reversed(ops)])
    assert box[0].tolist() == np.lexsort(keys).tolist()


@pytest.mark.parametrize("arg, passes", [("d", 3), ("i", 2)])
def test_a_grouped_median_sorts_once_a_word_inside_its_aggregate(
        con, arg, passes):
    # the GROUP BY's sort (keys, live flag and row id in one word), then
    # the median's over (k, value): two words with a DOUBLE, one without
    sql = f"SELECT k, median({arg}) FROM t GROUP BY k"
    box = []
    got = _record(lambda: box.append(con.execute(sql).fetchall()))
    sorts = [sp for sp in got if sp[2] == SORT]
    assert len(sorts) == passes
    assert {_operator(got, sp) for sp in sorts} == {"ddb.exec.Aggregate"}
    assert len(box[0]) == 40


@pytest.mark.parametrize("sql, passes, node", [
    ("SELECT i, row_number() OVER (PARTITION BY k ORDER BY d DESC) "
     "FROM t", 2, "ddb.exec.Window"),
    ("SELECT count(*) FROM t a JOIN t b ON a.i = b.i", 1, "ddb.exec.Join"),
    ("SELECT k, i FROM t ORDER BY k, i", 1, "ddb.exec.Order"),
    ("SELECT i FROM t USING SAMPLE 10 ROWS", 1, "ddb.exec.Sample"),
])
def test_window_join_and_order_sort_inside_their_operator(con, sql, passes,
                                                          node):
    got = _record(lambda: con.execute(sql).fetchall())
    sorts = [sp for sp in got if sp[2] == SORT]
    assert len(sorts) == passes
    assert {_operator(got, sp) for sp in sorts} == {node}


def test_join_build_and_lexsort_record_a_span_a_pass():
    key = torch.tensor([5, 3, 5, 1, 3])
    sel = torch.ones(5, dtype=torch.bool)
    box = []
    got = _record(lambda: box.append(join.build(key, None, sel)))
    assert [sp[2] for sp in got] == [SORT]
    assert box[0].skey.tolist() == [1, 3, 3, 5, 5]
    keys = [torch.tensor([2, 1, 2, 1]), torch.tensor([0, 9, 4, 3])]
    got = _record(lambda: box.append(join._lexsort(keys)))
    assert [sp[2] for sp in got] == [SORT] * 2
    assert box[-1].tolist() == [3, 1, 0, 2]


def test_compact_permutation_records_its_pass():
    sel = torch.tensor([False, True, False, True])
    box = []
    got = _record(lambda: box.append(order.compact_permutation(sel)))
    assert [sp[2] for sp in got] == [SORT]
    assert box[0].tolist() == [1, 3, 0, 2]


def test_without_a_profiler_no_sort_span_is_entered(con, monkeypatch):
    calls = []
    real = spans.record_function

    def counted(name):
        calls.append(name)
        return real(name)
    monkeypatch.setattr(spans, "record_function", counted)
    con.execute("SELECT k, median(d) FROM t GROUP BY k").fetchall()
    con.execute("SELECT count(*) FROM t a JOIN t b ON a.i = b.i").fetchall()
    assert calls == []
    _record(lambda: con.execute(
        "SELECT k, median(d) FROM t GROUP BY k").fetchall())
    assert calls.count(SORT) == 3


def test_only_sort_pass_sorts_a_batch_in_the_sorting_operators():
    # every torch.sort of a batch that an operator makes goes through
    # sort_pass (its own call is the one in order.py), so each records
    # its span; sketch.py's other sort merges two digests of DIGEST_K
    # centroids, not a batch
    pkg = ROOT / "ddb_tpu_torch"
    want = {"ops/order.py": 1, "ops/join.py": 0, "ops/sketch.py": 1,
            "ops/window.py": 0, "ops/aggregate.py": 0,
            "plan/physical.py": 0, "parallel/executor.py": 0,
            "parallel/exchange.py": 0}
    for path, n in want.items():
        text = (pkg / path).read_text()
        assert text.count("torch.sort(") == n, path
        assert "torch.argsort(" not in text, path


@pytest.mark.parametrize("cell", ["tpch_sf10.scan_agg", "tpch_sf10.join",
                                  "h2oai_G1_1e8_1e2_0_0.basic",
                                  "h2oai_G1_1e8_1e2_0_0.advanced"])
def test_every_cell_reports_the_sort_metrics(cell):
    names = {m["name"] for m in load_cell(cell).per_layer}
    assert {"sort_passes_per_query", "sort_busy_pct"} <= names

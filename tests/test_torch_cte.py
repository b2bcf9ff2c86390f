"""Shared and recursive CTEs in ddb_tpu_torch against ddb_tpu on the CPU:
the CTE statements of bench/select_cases.py through both packages'
connect(), a CTE read twice computed once, UNION and UNION ALL
recursion, and the recursion limit.

Rows must match exactly, floats to 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch import types as PT
from ddb_tpu_torch.batch import (Batch, Column, Field, Schema, bind_device,
                                  make_batch)
from ddb_tpu_torch.bench import select_cases
from ddb_tpu_torch.plan import logical as L
from ddb_tpu_torch.plan import physical

from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401


@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, cols in select_cases.tables().items():
        ref.register(name, cols)
        port.register(name, cols)
    return ref, port


@pytest.mark.parametrize("name", list(select_cases.CTE))
def test_cte_sql_matches_reference(cons, name):
    ref, port = cons
    sql = select_cases.CTE[name]
    want, got = ref.execute(sql), port.execute(sql)
    assert got.column_names == want.column_names
    assert first_difference(want.fetchall(),
                                         got.fetchall()) is None
    assert len(got.fetchall()) > 0
    # a cached plan gives the same rows again, and keeps no batch
    assert port.execute(sql).fetchall() == got.fetchall()


def _plan_nodes(node):
    yield node
    for c in node.children():
        yield from _plan_nodes(c)


def test_materialized_cte_runs_once_a_query(cons, monkeypatch):
    _, port = cons
    sql = select_cases.CTE["cte_twice_join"]
    port.execute(sql)
    plan = port._plan_cache[sql][1]
    mats = [n for n in _plan_nodes(plan) if isinstance(n, L.Materialize)]
    assert len(mats) == 2 and mats[0] is mats[1]      # one node, two parents
    calls = []
    inner = physical._EXEC[L.Aggregate]

    def counting(node, ctx):
        calls.append(node)
        return inner(node, ctx)

    monkeypatch.setitem(physical._EXEC, L.Aggregate, counting)
    first = port.execute(sql).fetchall()
    assert len(calls) == 1          # the CTE's aggregate, not once a reference
    # the memo lives for one query: the next one computes again
    assert port.execute(sql).fetchall() == first
    assert len(calls) == 2
    assert not hasattr(mats[0], "batch") and not hasattr(mats[0], "memo")


def test_context_memo_is_per_query():
    a, b = physical.ExecContext("cpu"), physical.ExecContext("cpu")
    assert a.memo == {} and a.memo is not b.memo
    assert a.device == torch.device("cpu")


def _ints(values, nulls=None):
    return make_batch([np.asarray(values, dtype=np.int64)], [nulls],
                      device="cpu")


SCHEMA = Schema((Field("x", PT.BIGINT),))


def _live(b: Batch):
    sel = b.sel.numpy()
    d = b.columns[0].data.numpy()[sel]
    n = b.columns[0].nulls
    n = np.zeros(len(d), bool) if n is None else n.numpy()[sel]
    return [None if isn else int(v) for v, isn in zip(d, n)]


def test_new_rows_are_those_not_seen_deduplicated_in_key_order():
    acc = _ints([5, 1, 9, 0], np.array([False, False, False, True]))
    res = _ints([9, 7, 7, 2, 0, 1, 3],
                np.array([False, False, False, False, True, False, False]))
    new = physical._new_rows(SCHEMA, acc, res)
    assert _live(new) == [2, 3, 7]
    assert int(new.count) == 3
    # nothing new
    assert int(physical._new_rows(SCHEMA, acc, _ints([1, 5, 5])).count) == 0
    # dead rows of either side never count
    half = Batch(res.columns, res.sel & (torch.arange(res.capacity) % 2 == 0),
                 None)
    assert _live(physical._new_rows(SCHEMA, acc, half)) == [3, 7]


def test_recursion_limit(cons, monkeypatch):
    _, port = cons
    monkeypatch.setattr(physical, "_MAX_RECURSION", 7)
    with pytest.raises(RuntimeError, match="max iteration"):
        port.execute("WITH RECURSIVE d(x) AS (SELECT 1 UNION ALL SELECT "
                     "x + 1 FROM d WHERE x < 50) SELECT count(*) FROM d")
    # within the limit the same shape runs
    assert port.execute(
        "WITH RECURSIVE d(x) AS (SELECT 1 UNION ALL SELECT x + 1 FROM d "
        "WHERE x < 6) SELECT count(*) FROM d").fetchall() == [(6,)]


def test_recursive_cell_is_cleared_after_the_query(cons):
    _, port = cons
    sql = select_cases.CTE["recursive_rows"]
    port.execute(sql)
    plan = port._plan_cache[sql][1]
    recs = [n for n in _plan_nodes(plan) if isinstance(n, L.RecursiveCTE)]
    assert len(recs) == 1 and recs[0].cell.batch is None


def test_union_all_keeps_duplicates_and_union_drops_them(cons):
    ref, port = cons
    all_ = ("WITH RECURSIVE d(x) AS (SELECT k FROM g WHERE k < 2 UNION ALL "
            "SELECT x + 1 FROM d WHERE x < 3) SELECT x, count(*) FROM d "
            "GROUP BY x ORDER BY x")
    dedup = all_.replace("UNION ALL", "UNION")
    for sql in (all_, dedup):
        assert port.execute(sql).fetchall() == ref.execute(sql).fetchall()
    assert [c for _, c in port.execute(dedup).fetchall()] == [1, 1, 1, 1]
    assert port.execute(all_).fetchall()[0][1] > 1


def test_bind_time_execution_names_no_device(cons):
    # the binder folds an uncorrelated scalar subquery while it binds: it
    # calls execute() without a device and reads the result on the host
    _, port = cons
    sql = select_cases.CTE["cte_once"]
    port.execute(sql)
    plan = port._plan_cache[sql][1]
    with bind_device("cpu"):
        schema, b = physical.execute(plan)
    assert b.sel.device.type == "cpu" and len(schema) == 2
    # outside a statement being bound there is no device to fall back on
    with pytest.raises(RuntimeError, match="no device"):
        physical.execute(plan)
    with pytest.raises(RuntimeError, match="no device"):
        port.catalog.get_table("g").device_batch()
    assert port.execute("SELECT (SELECT max(k) FROM g), k FROM g "
                        "WHERE k = (SELECT min(k) FROM g) LIMIT 1"
                        ).fetchall() == [(2, 0)]


def test_wide_sum_keeps_its_high_limb_through_recursion(cons):
    # a named deviation: the reference's columns have one limb, so a sum
    # beyond int64 wraps there; here both limbs go through the rounds'
    # concatenation and de-duplication
    ref, port = cons
    sql = select_cases.DEVIATIONS["recursive_over_wide_sum"]
    g = select_cases.tables()["g"]
    want = {}
    for key, v in zip(g["g"], g["v"]):
        want[key] = want.get(key, 0) + (v or 0) * 300000000000000000
    assert max(want.values()) > 2**63
    got = port.execute(sql).fetchall()
    assert got == [(k, i, want[k]) for k in sorted(want) for i in range(3)]
    assert ref.execute(sql).fetchall() != got
    # UNION ALL of a wide and a narrow column, and DISTINCT over a wide one
    rows = port.execute(
        "SELECT g, sum(v * 300000000000000000) AS t FROM g GROUP BY g "
        "UNION ALL SELECT g, 7 FROM g WHERE k = 0").fetchall()
    assert sorted(t for _, t in rows if t != 7) == sorted(want.values())
    assert port.execute(
        "SELECT count(*) FROM (SELECT DISTINCT t FROM (SELECT g, sum(v * "
        "300000000000000000) AS t FROM g GROUP BY g))").fetchall() \
        == [(len(set(want.values())),)]

# Generated from tests/test_window_over_agg.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite window_over_agg); do not edit.
"""Windows over aggregate output (TPC-DS q12/q20/q47-style ratios) plus
binder breadth fixes: IN-list const folding, VARCHAR-literal vs typed
column comparisons (reference: window binding post-aggregate in
bind_select_node.cpp; cast_rules.cpp implicit casts)."""

import pytest

from ddb_tpu_torch.testing.refsuite import Connection


@pytest.fixture()
def con():
    c = Connection()
    c.register("t", {"cls": ["a", "a", "b", "b"],
                     "item": ["i1", "i2", "i3", "i4"],
                     "v": [10, 20, 30, 40]})
    return c


def test_ratio_over_class(con):
    rows = con.execute("""
        SELECT item, sum(v) * 100.0 / sum(sum(v)) OVER (PARTITION BY cls)
        FROM t GROUP BY item, cls ORDER BY item""").fetchall()
    vals = [round(r[1], 6) for r in rows]
    assert vals == [round(x, 6) for x in
                    (100 / 3, 200 / 3, 300 / 7, 400 / 7)]


def test_rank_over_aggregate(con):
    rows = con.execute("""
        SELECT cls, sum(v) AS s, rank() OVER (ORDER BY sum(v) DESC) AS r
        FROM t GROUP BY cls ORDER BY cls""").fetchall()
    assert rows == [("a", 30, 2), ("b", 70, 1)]


def test_window_partition_by_group_col(con):
    rows = con.execute("""
        SELECT item, avg(sum(v)) OVER (PARTITION BY cls) AS m
        FROM t GROUP BY item, cls ORDER BY item""").fetchall()
    assert [r[1] for r in rows] == [15.0, 15.0, 35.0, 35.0]


def test_having_before_window(con):
    rows = con.execute("""
        SELECT item, sum(sum(v)) OVER () AS tot
        FROM t GROUP BY item HAVING sum(v) > 15 ORDER BY item""").fetchall()
    assert rows == [("i2", 90), ("i3", 90), ("i4", 90)]


def test_in_list_arith_folding(con):
    c = Connection()
    c.register("y", {"yr": [2000, 2001, 2002, 2003]})
    assert c.execute("SELECT count(*) FROM y WHERE yr IN "
                     "(2000, 2000+1, 2000+2)").fetchall() == [(3,)]


def test_varchar_literal_vs_date():
    c = Connection()
    c.execute("CREATE TABLE d (dt DATE)")
    c.execute("INSERT INTO d VALUES (DATE '2000-01-15'), "
              "(DATE '2000-03-01')")
    assert c.execute("SELECT count(*) FROM d WHERE dt BETWEEN "
                     "'2000-01-01' AND '2000-02-01'").fetchall() == [(1,)]
    assert c.execute("SELECT count(*) FROM d WHERE dt = '2000-03-01'"
                     ).fetchall() == [(1,)]


def test_stddev_dense_path():
    c = Connection()
    c.register("g", {"k": [1, 1, 2, 2], "x": [1.0, 3.0, 5.0, 9.0]})
    rows = c.execute("SELECT k, stddev_samp(x), var_pop(x) FROM g "
                     "GROUP BY k ORDER BY k").fetchall()
    assert [round(r[1], 9) for r in rows] == [
        round(2 ** 0.5, 9), round(8 ** 0.5, 9)]
    assert [r[2] for r in rows] == [1.0, 4.0]

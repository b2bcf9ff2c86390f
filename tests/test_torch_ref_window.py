# Generated from tests/test_window.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite window); do not edit.
"""Window function tests (reference: test/sql/window/*)."""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture(scope="module")
def con():
    c = refsuite.connect()
    c.register("t", {"g": ["a", "a", "a", "b", "b"],
                     "x": [3, 1, 2, 10, 20],
                     "v": [30, 10, 20, 100, 200]})
    return c


def q(con, sql):
    return con.execute(sql).fetchall()


def test_row_number(con):
    rows = q(con, "SELECT x, row_number() OVER (PARTITION BY g ORDER BY x)"
             " FROM t ORDER BY g, x")
    assert rows == [(1, 1), (2, 2), (3, 3), (10, 1), (20, 2)]


def test_rank_dense_rank(con):
    c = refsuite.connect()
    c.register("r", {"x": [10, 10, 20, 30, 30]})
    rows = q(c, "SELECT x, rank() OVER (ORDER BY x), "
             "dense_rank() OVER (ORDER BY x) FROM r ORDER BY x, 2")
    assert rows == [(10, 1, 1), (10, 1, 1), (20, 3, 2),
                    (30, 4, 3), (30, 4, 3)]


def test_running_sum(con):
    rows = q(con, "SELECT g, x, sum(v) OVER (PARTITION BY g ORDER BY x) "
             "FROM t ORDER BY g, x")
    assert rows == [("a", 1, 10), ("a", 2, 30), ("a", 3, 60),
                    ("b", 10, 100), ("b", 20, 300)]


def test_partition_total(con):
    rows = q(con, "SELECT g, x, sum(v) OVER (PARTITION BY g) FROM t "
             "ORDER BY g, x")
    assert rows == [("a", 1, 60), ("a", 2, 60), ("a", 3, 60),
                    ("b", 10, 300), ("b", 20, 300)]


def test_lag_lead(con):
    rows = q(con, "SELECT x, lag(x) OVER (PARTITION BY g ORDER BY x), "
             "lead(x) OVER (PARTITION BY g ORDER BY x) FROM t "
             "ORDER BY g, x")
    assert rows == [(1, None, 2), (2, 1, 3), (3, 2, None),
                    (10, None, 20), (20, 10, None)]


def test_first_last_value(con):
    rows = q(con, "SELECT x, first_value(v) OVER (PARTITION BY g ORDER BY x)"
             " FROM t ORDER BY g, x")
    assert rows == [(1, 10), (2, 10), (3, 10), (10, 100), (20, 100)]


def test_window_count_avg(con):
    rows = q(con, "SELECT x, count(*) OVER (PARTITION BY g), "
             "avg(v) OVER (PARTITION BY g) FROM t ORDER BY g, x")
    assert rows == [(1, 3, 20.0), (2, 3, 20.0), (3, 3, 20.0),
                    (10, 2, 150.0), (20, 2, 150.0)]


def test_rows_frame_moving_sum(con):
    rows = q(con, "SELECT g, x, sum(v) OVER (PARTITION BY g ORDER BY x "
             "ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) FROM t "
             "ORDER BY g, x")
    assert rows == [("a", 1, 10), ("a", 2, 30), ("a", 3, 50),
                    ("b", 10, 100), ("b", 20, 300)]


def test_rows_frame_centered_avg(con):
    rows = q(con, "SELECT x, avg(v) OVER (PARTITION BY g ORDER BY x "
             "ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM t "
             "ORDER BY g, x")
    assert rows == [(1, 15.0), (2, 20.0), (3, 25.0),
                    (10, 150.0), (20, 150.0)]


# ---- RANGE value frames (reference: function/window/window_executor.cpp
# value boundaries) ---------------------------------------------------------

def test_range_value_frame():
    c = refsuite.connect()
    c.register("wr", {"g": ["a", "a", "a", "a", "b", "b"],
                      "t": [1, 2, 4, 7, 1, 10],
                      "v": [10, 20, 30, 40, 5, 6]})
    r = c.execute(
        "SELECT g, t, sum(v) OVER (PARTITION BY g ORDER BY t "
        "RANGE BETWEEN 2 PRECEDING AND CURRENT ROW) FROM wr "
        "ORDER BY g, t").fetchall()
    assert r == [('a', 1, 10), ('a', 2, 30), ('a', 4, 50), ('a', 7, 40),
                 ('b', 1, 5), ('b', 10, 6)]
    r = c.execute(
        "SELECT t, sum(v) OVER (ORDER BY t DESC "
        "RANGE BETWEEN 2 PRECEDING AND CURRENT ROW) FROM wr "
        "WHERE g='a' ORDER BY t").fetchall()
    assert r == [(1, 30), (2, 50), (4, 30), (7, 40)]
    r = c.execute(
        "SELECT t, count(*) OVER (ORDER BY t "
        "RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING) FROM wr "
        "WHERE g='a' ORDER BY t").fetchall()
    assert r == [(1, 3), (2, 3), (4, 4), (7, 2)]
    # ROWS shorthand (no BETWEEN)
    r = c.execute(
        "SELECT t, sum(v) OVER (ORDER BY t ROWS 2 PRECEDING) FROM wr "
        "WHERE g='a' ORDER BY t").fetchall()
    assert r == [(1, 10), (2, 30), (4, 60), (7, 90)]


# ---------------------------------------------------------------------------
# QUALIFY + named WINDOW clause (reference: bind_select_node.cpp qualify
# binding; WINDOW clause resolution in the parser transformer)
# ---------------------------------------------------------------------------
def test_qualify_basic():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE q (g VARCHAR, v INTEGER)")
    c.sql("INSERT INTO q VALUES ('a',1),('a',3),('a',2),('b',5),('b',4)")
    rows = c.sql(
        "SELECT g, v FROM q QUALIFY row_number() OVER"
        " (PARTITION BY g ORDER BY v DESC) = 1 ORDER BY g").fetchall()
    assert rows == [("a", 3), ("b", 5)]


def test_qualify_alias_reference():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE q2 (g VARCHAR, v INTEGER)")
    c.sql("INSERT INTO q2 VALUES ('a',1),('a',3),('a',2),('b',5),('b',4)")
    rows = c.sql(
        "SELECT g, v, rank() OVER (PARTITION BY g ORDER BY v) r FROM q2"
        " QUALIFY r <= 2 ORDER BY g, v").fetchall()
    assert rows == [("a", 1, 1), ("a", 2, 2), ("b", 4, 1), ("b", 5, 2)]


def test_qualify_over_aggregate():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE q3 (g VARCHAR, v INTEGER)")
    c.sql("INSERT INTO q3 VALUES ('a',1),('a',3),('b',5),('b',4)")
    rows = c.sql(
        "SELECT g, sum(v) s FROM q3 GROUP BY g"
        " QUALIFY row_number() OVER (ORDER BY sum(v) DESC) = 1").fetchall()
    assert rows == [("b", 9)]


def test_named_window_clause():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE q4 (g VARCHAR, v INTEGER)")
    c.sql("INSERT INTO q4 VALUES ('a',1),('a',3),('a',2),('b',5)")
    rows = c.sql(
        "SELECT g, v, row_number() OVER win AS rn, sum(v) OVER win AS s"
        " FROM q4 WINDOW win AS (PARTITION BY g ORDER BY v)"
        " ORDER BY g, v").fetchall()
    assert rows == [("a", 1, 1, 1), ("a", 2, 2, 3), ("a", 3, 3, 6),
                    ("b", 5, 1, 5)]

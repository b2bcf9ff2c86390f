# Generated from tests/test_advice_r5.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite advice_r5); do not edit.
"""Round-5 advisor regression tests.

Reference semantics verified against the oracle CLI:
- USING/NATURAL join visible column per join type (reference:
  src/planner/binder/tableref/bind_joinref.cpp SetPrimaryBinding):
  RIGHT joins show the right-side key, FULL joins COALESCE(l, r).
- TIMESTAMP encode/decode is exact integer micros (reference stores
  int64 micros over the full range, src/common/types/timestamp.cpp).
"""

from ddb_tpu_torch.testing import refsuite
import datetime

import pytest

import ddb_tpu_torch


@pytest.fixture()
def con():
    c = refsuite.connect()
    c.execute("create table l(k int, a int)")
    c.execute("insert into l values (1,10),(2,20)")
    c.execute("create table r(k int, b int)")
    c.execute("insert into r values (2,200),(3,300)")
    return c


def test_using_right_join_key(con):
    assert con.execute(
        "select k from l right join r using(k) order by 1").fetchall() \
        == [(2,), (3,)]
    assert con.execute(
        "select * from l right join r using(k) order by 1").fetchall() \
        == [(2, 20, 200), (3, None, 300)]


def test_using_full_join_coalesce(con):
    assert con.execute(
        "select k from l full join r using(k) order by 1").fetchall() \
        == [(1,), (2,), (3,)]
    assert con.execute(
        "select * from l full join r using(k) order by 1").fetchall() \
        == [(1, 10, None), (2, 20, 200), (3, None, 300)]
    # qualified refs still reach each side
    assert con.execute(
        "select l.k, r.k from l full join r using(k) order by 1"
    ).fetchall() == [(1, None), (2, 2), (None, 3)]


def test_natural_right_join(con):
    con.execute("create table a2(k int, x int)")
    con.execute("insert into a2 values (1,1),(2,2)")
    con.execute("create table b2(k int, y int)")
    con.execute("insert into b2 values (2,22),(3,33)")
    assert con.execute(
        "select * from a2 natural right join b2 order by 1").fetchall() \
        == [(2, 2, 22), (3, None, 33)]


def test_nested_using_join_star_dedup(con):
    con.execute("create table c3(k int, z int)")
    con.execute("insert into c3 values (2,222)")
    res = con.execute(
        "select * from l join r using(k) join c3 using(k)")
    assert res.fetchall() == [(2, 20, 200, 222)]
    # the hidden duplicate survives subquery star expansion too
    assert con.execute(
        "select k from (select * from l full join r using(k)) "
        "order by 1").fetchall() == [(1,), (2,), (3,)]


def test_timestamp_exact_micros(con):
    # a micros count that float seconds cannot represent exactly
    ts = "2255-06-05 23:59:59.999999"
    out = con.execute(f"select timestamp '{ts}'").fetchall()[0][0]
    assert out == datetime.datetime(2255, 6, 5, 23, 59, 59, 999999)
    out2 = con.execute(
        "select timestamptz '2255-06-05 23:59:59.999999+00'"
    ).fetchall()[0][0]
    assert out2.replace(tzinfo=None) == \
        datetime.datetime(2255, 6, 5, 23, 59, 59, 999999)


def test_string_funcs_over_agg_results(con):
    """Runtime-filled stores (aggregate outputs) feed lazy DictLookup
    tables; before round 5 length(string_agg(...)) returned 0 because
    the per-code table was built at bind time over the empty store."""
    con.execute("create table sa(g int, v int)")
    con.execute("insert into sa values (1,10),(1,20),(2,30)")
    assert con.execute(
        "select g, length(string_agg(v, ',')) from sa group by g "
        "order by g").fetchall() == [(1, 5), (2, 2)]
    assert con.execute(
        "select g, upper(string_agg(v, 'x')) from sa group by g "
        "order by g").fetchall() == [(1, '10X20'), (2, '30')]
    assert con.execute(
        "select max(length(x)) from (select g, string_agg(v, ',') as x "
        "from sa group by g)").fetchall() == [(5,)]
    assert con.execute(
        "select g, len(list(v)) from sa group by g order by g"
    ).fetchall() == [(1, 2), (2, 1)]
    assert con.execute(
        "select cardinality(histogram(v)) from sa").fetchall() == [(3,)]


def test_string_agg_vectorized_matches_loop(con):
    con.execute("create table sv(g int, v varchar)")
    con.execute("insert into sv values (1,'a'),(1,NULL),(1,'c'),"
                "(2,'x'),(2,NULL),(3,NULL)")
    assert con.execute(
        "select g, string_agg(v, '-') from sv group by g order by g"
    ).fetchall() == [(1, 'a-c'), (2, 'x'), (3, None)]
    # ordered + distinct take the generic loop; results must agree
    assert con.execute(
        "select g, string_agg(v, '-' order by v desc) from sv "
        "group by g order by g").fetchall() \
        == [(1, 'c-a'), (2, 'x'), (3, None)]

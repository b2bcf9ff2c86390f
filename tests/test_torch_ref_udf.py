# Generated from tests/test_udf.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite udf); do not edit.
"""Python scalar UDFs (reference: duckdb.create_function,
tools/pythonpkg/src/python_udf.cpp; ours run through jax.pure_callback
inside the jitted pipeline)."""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture
def con():
    c = refsuite.connect()
    c.register("t", {"a": [1, 2, 3, None], "s": ["x", "yy", "zzz", "w"]})
    return c


def test_udf_basic(con):
    con.create_function("plus_ten", lambda x: x + 10)
    assert con.execute("SELECT a, plus_ten(a) FROM t ORDER BY a"
                       ).fetchall() == \
        [(1, 11), (2, 12), (3, 13), (None, None)]


def test_udf_varchar_arg_and_return_type(con):
    con.create_function("slen", lambda s: len(s))
    con.create_function("halve", lambda x: x / 2, "DOUBLE")
    assert con.execute("SELECT slen(s), halve(a) FROM t WHERE a = 3"
                       ).fetchall() == [(3, 1.5)]


def test_udf_none_returns_null(con):
    con.create_function("oddnull", lambda x: None if x % 2 else x)
    assert con.execute("SELECT oddnull(a) FROM t ORDER BY a"
                       ).fetchall() == [(None,), (2,), (None,), (None,)]


def test_udf_in_where_and_agg(con):
    con.create_function("plus_ten", lambda x: x + 10)
    con.create_function("slen", lambda s: len(s))
    assert con.execute(
        "SELECT sum(plus_ten(a)) FROM t WHERE slen(s) > 1"
    ).fetchall() == [(25,)]


def test_udf_listed_and_removable(con):
    con.create_function("myfn", lambda x: x)
    names = [r[0] for r in con.execute(
        "SELECT function_name FROM duckdb_functions() "
        "WHERE function_type = 'udf'").fetchall()]
    assert "myfn" in names
    con.remove_function("myfn")
    with pytest.raises(Exception):
        con.execute("SELECT myfn(1)")


def test_udf_varchar_return(con):
    """VARCHAR-returning UDFs fill a runtime dictionary (round-5;
    reference: python_udf.cpp string returns)."""
    con.create_function("tag", lambda x: f"v={x}", "VARCHAR")
    con.execute("create table uv(x int)")
    con.execute("insert into uv values (1),(2)")
    assert con.execute("select tag(x) from uv order by 1").fetchall() \
        == [("v=1",), ("v=2",)]
    assert con.execute(
        "select length(tag(x)) from uv order by 1").fetchall() \
        == [(3,), (3,)]


def test_aggregate_udf():
    # user aggregates: host init/update/finalize over group values
    # (reference: duckdb_create_aggregate_function, src/include/duckdb.h)
    import math

    import ddb_tpu_torch
    con = refsuite.connect()
    con.create_aggregate(
        "geomean",
        lambda: [0.0, 0],
        lambda st, v: (st.__setitem__(0, st[0] + math.log(v)),
                       st.__setitem__(1, st[1] + 1)),
        lambda st: math.exp(st[0] / st[1]) if st[1] else None,
        "DOUBLE")
    con.execute("CREATE TABLE t (g varchar, v double)")
    con.execute("INSERT INTO t VALUES ('a', 2.0), ('a', 8.0), "
                "('b', 5.0), ('b', NULL)")
    assert con.execute(
        "SELECT g, geomean(v) FROM t GROUP BY g ORDER BY g"
    ).fetchall() == [("a", 4.0), ("b", 4.999999999999999)]
    # ungrouped + all-NULL group -> finalize sees no values
    assert con.execute(
        "SELECT geomean(v) FROM t WHERE v IS NULL").fetchall() \
        == [(None,)]
    # VARCHAR-returning aggregate uses a runtime dictionary
    con.create_aggregate(
        "firstlast", lambda: [],
        lambda st, v: st.append(str(v)),
        lambda st: (st[0] + ".." + st[-1]) if st else None, "VARCHAR")
    assert con.execute(
        "SELECT g, firstlast(v) FROM t GROUP BY g ORDER BY g"
    ).fetchall() == [("a", "2.0..8.0"), ("b", "5.0..5.0")]
    # mixes with built-in aggregates on the host path
    assert con.execute(
        "SELECT g, geomean(v), count(*), sum(v) FROM t "
        "GROUP BY g ORDER BY g").fetchall() \
        == [("a", 4.0, 2, 10.0), ("b", 4.999999999999999, 2, 5.0)]
    con.remove_function("geomean")
    import pytest
    with pytest.raises(Exception):
        con.execute("SELECT geomean(v) FROM t")

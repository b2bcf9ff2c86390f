"""tests/test_udf.py's statements through both packages, with the
functions made by `create_function`, `create_aggregate` and
`create_table_function` and taken away by `remove_function`.

Each case is a sequence of steps run on a fresh connection of each
package over the same table; every statement's rows (or the class name
of what it raises) must be equal.  The functions run on the host with
Python values in both packages, so floats compare exactly.
"""

import math

import pytest

import ddb_tpu
import ddb_tpu_torch
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401


def _geomean():
    return ("agg", "geomean", lambda: [0.0, 0],
            lambda st, v: (st.__setitem__(0, st[0] + math.log(v)),
                           st.__setitem__(1, st[1] + 1)),
            lambda st: math.exp(st[0] / st[1]) if st[1] else None, "DOUBLE")


def _squares(n, scale=1):
    return [(i, float(i * i) * scale, f"sq{i}") for i in range(n)]


SQUARES_COLUMNS = [("n", "BIGINT"), ("sq", "DOUBLE"), ("tag", "VARCHAR")]

# name: [step]; a step is ("sql", text), ("fn", name, fn[, type]),
# ("agg", name, init, update, finalize, type), ("tf", name, fn, columns)
# or ("rm", name)
CASES = {
    "basic": [
        ("fn", "plus_ten", lambda x: x + 10),
        ("sql", "SELECT a, plus_ten(a) FROM t ORDER BY a")],
    "varchar_arg_and_return_type": [
        ("fn", "slen", lambda s: len(s)),
        ("fn", "halve", lambda x: x / 2, "DOUBLE"),
        ("sql", "SELECT slen(s), halve(a) FROM t WHERE a = 3")],
    "none_returns_null": [
        ("fn", "oddnull", lambda x: None if x % 2 else x),
        ("sql", "SELECT oddnull(a) FROM t ORDER BY a")],
    "in_where_and_agg": [
        ("fn", "plus_ten", lambda x: x + 10),
        ("fn", "slen", lambda s: len(s)),
        ("sql", "SELECT sum(plus_ten(a)) FROM t WHERE slen(s) > 1")],
    "listed_and_removable": [
        ("fn", "myfn", lambda x: x),
        ("sql", "SELECT function_name FROM duckdb_functions() "
                "WHERE function_type = 'udf'"),
        ("sql", "SELECT myfn(1)"),
        ("rm", "myfn"),
        ("sql", "SELECT myfn(1)"),
        ("sql", "SELECT function_name FROM duckdb_functions() "
                "WHERE function_type = 'udf'")],
    "remove_unknown_and_redefine": [
        ("rm", "never_made"),
        ("fn", "f", lambda x: x + 1),
        ("rm", "F"),
        ("fn", "f", lambda x: x * 3, "BIGINT"),
        ("sql", "SELECT f(a) FROM t ORDER BY a")],
    "varchar_return": [
        ("fn", "tag", lambda x: f"v={x}", "VARCHAR"),
        ("sql", "create table uv(x int)"),
        ("sql", "insert into uv values (1),(2)"),
        ("sql", "select tag(x) from uv order by 1"),
        ("sql", "select length(tag(x)) from uv order by 1")],
    "aggregate": [
        _geomean(),
        ("sql", "CREATE TABLE g (g varchar, v double)"),
        ("sql", "INSERT INTO g VALUES ('a', 2.0), ('a', 8.0), "
                "('b', 5.0), ('b', NULL)"),
        ("sql", "SELECT g, geomean(v) FROM g GROUP BY g ORDER BY g"),
        ("sql", "SELECT geomean(v) FROM g WHERE v IS NULL"),
        ("agg", "firstlast", lambda: [], lambda st, v: st.append(str(v)),
         lambda st: (st[0] + ".." + st[-1]) if st else None, "VARCHAR"),
        ("sql", "SELECT g, firstlast(v) FROM g GROUP BY g ORDER BY g"),
        ("sql", "SELECT g, geomean(v), count(*), sum(v) FROM g "
                "GROUP BY g ORDER BY g"),
        ("rm", "geomean"),
        ("sql", "SELECT geomean(v) FROM g"),
        ("sql", "SELECT g, firstlast(v) FROM g GROUP BY g ORDER BY g")],
    "table_function": [
        ("tf", "squares", _squares, SQUARES_COLUMNS),
        ("sql", "SELECT n, sq, tag FROM squares(4) WHERE n >= 1 "
                "ORDER BY n"),
        ("sql", "SELECT sum(sq) FROM squares(10)"),
        ("sql", "SELECT t.a, q.tag FROM t JOIN squares(3) q ON t.a = q.n "
                "ORDER BY t.a"),
        ("sql", "SELECT count(*) FROM squares(0)")],
    "table_function_replaced_and_kept_by_remove": [
        ("tf", "squares", _squares, SQUARES_COLUMNS),
        ("sql", "SELECT max(sq) FROM squares(5)"),
        ("tf", "Squares", lambda n: _squares(n, 2), SQUARES_COLUMNS),
        ("sql", "SELECT max(sq) FROM squares(5)"),
        ("rm", "squares"),
        ("sql", "SELECT max(sq) FROM squares(5)"),
        ("sql", "SELECT * FROM no_such_function(1)")],
}


def _run(pkg_connect, steps):
    con = pkg_connect()
    con.register("t", {"a": [1, 2, 3, None], "s": ["x", "yy", "zzz", "w"]})
    out = []
    for kind, *args in steps:
        if kind == "fn":
            assert con.create_function(*args) is con
        elif kind == "agg":
            assert con.create_aggregate(*args) is con
        elif kind == "tf":
            assert con.create_table_function(*args) is con
        elif kind == "rm":
            assert con.remove_function(*args) is con
        else:
            try:
                res = con.execute(args[0])
                out.append(None if res is None else res.fetchall())
            except Exception as e:      # the two must fail alike
                out.append(("raises", type(e).__name__))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_udf_steps_match_reference(name):
    want = _run(ddb_tpu.connect, CASES[name])
    got = _run(lambda: ddb_tpu_torch.connect("cpu"), CASES[name])
    assert got == want
    assert any(isinstance(r, list) and r for r in got)


def test_remove_function_forgets_cached_plans():
    con = ddb_tpu_torch.connect("cpu")
    con.create_function("f", lambda x: x + 1)
    assert con.execute("SELECT f(1)").fetchall() == [(2,)]
    version = con.catalog.version
    con.remove_function("f")
    assert con.catalog.version > version
    with pytest.raises(Exception):
        con.execute("SELECT f(1)")

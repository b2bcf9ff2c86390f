# Generated from tests/test_sql.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite sql); do not edit.
"""SQL end-to-end tests (parser -> binder -> optimizer -> executor).

Modeled on the reference's sqllogictest style (test/sql/**): each case is a
query + expected rows."""

from ddb_tpu_torch.testing import refsuite
import datetime
import decimal

import pytest

import ddb_tpu_torch


@pytest.fixture(scope="module")
def con():
    c = refsuite.connect()
    c.register("t1", {"a": [1, 2, 3, 4, 5],
                      "b": [10, 20, 30, 40, 50],
                      "s": ["x", "y", "x", "z", "y"]})
    c.register("t2", {"k": [2, 3, 6], "v": [200, 300, 600]})
    import pyarrow as pa
    c.register("tn", pa.table({"k": [1, 1, 2, 2],
                               "v": [10, None, None, None]}))
    return c


def q(con, sql):
    return con.execute(sql).fetchall()


def test_select_star(con):
    assert q(con, "SELECT * FROM t2") == [(2, 200), (3, 300), (6, 600)]


def test_filter_projection(con):
    assert q(con, "SELECT a+1, b*2 FROM t1 WHERE a >= 4") == \
        [(5, 80), (6, 100)]


def test_group_by(con):
    rows = q(con, "SELECT s, sum(b), count(*) FROM t1 GROUP BY s ORDER BY s")
    assert rows == [("x", 40, 2), ("y", 70, 2), ("z", 40, 1)]


def test_group_by_ordinal_alias(con):
    rows = q(con, "SELECT s AS grp, sum(a) FROM t1 GROUP BY 1 ORDER BY grp")
    assert rows == [("x", 4), ("y", 7), ("z", 4)]


def test_having(con):
    rows = q(con, "SELECT s, sum(b) AS sb FROM t1 GROUP BY s "
             "HAVING sum(b) > 40 ORDER BY s")
    assert rows == [("y", 70)]


def test_join_where_syntax(con):
    rows = q(con, "SELECT a, v FROM t1, t2 WHERE a = k ORDER BY a")
    assert rows == [(2, 200), (3, 300)]


def test_join_explicit(con):
    rows = q(con, "SELECT a, v FROM t1 JOIN t2 ON a = k ORDER BY a DESC")
    assert rows == [(3, 300), (2, 200)]


def test_left_join_sql(con):
    rows = q(con, "SELECT k, b FROM t2 LEFT JOIN t1 ON k = a ORDER BY k")
    assert rows == [(2, 20), (3, 30), (6, None)]


def test_in_list(con):
    assert q(con, "SELECT a FROM t1 WHERE a IN (1, 3, 9) ORDER BY a") == \
        [(1,), (3,)]


def test_string_like(con):
    assert q(con, "SELECT a FROM t1 WHERE s LIKE 'x%' ORDER BY a") == \
        [(1,), (3,)]


def test_string_compare(con):
    assert q(con, "SELECT a FROM t1 WHERE s > 'x' ORDER BY a") == \
        [(2,), (4,), (5,)]


def test_case_when(con):
    rows = q(con, "SELECT sum(CASE WHEN s = 'x' THEN b ELSE 0 END) FROM t1")
    assert rows == [(40,)]


def test_between(con):
    assert q(con, "SELECT a FROM t1 WHERE a BETWEEN 2 AND 4 ORDER BY a") == \
        [(2,), (3,), (4,)]


def test_order_nulls(con):
    rows = q(con, "SELECT v FROM tn ORDER BY v")
    assert rows == [(10,), (None,), (None,), (None,)]
    rows = q(con, "SELECT v FROM tn ORDER BY v DESC NULLS FIRST")
    assert rows[:3] == [(None,), (None,), (None,)]


def test_limit_offset(con):
    rows = q(con, "SELECT a FROM t1 ORDER BY a LIMIT 2 OFFSET 1")
    assert rows == [(2,), (3,)]


def test_distinct(con):
    assert q(con, "SELECT DISTINCT s FROM t1 ORDER BY s") == \
        [("x",), ("y",), ("z",)]


def test_scalar_subquery_uncorrelated(con):
    rows = q(con, "SELECT a FROM t1 WHERE a > (SELECT avg(k) FROM t2) "
             "ORDER BY a")
    assert rows == [(4,), (5,)]


def test_in_subquery(con):
    rows = q(con, "SELECT a FROM t1 WHERE a IN (SELECT k FROM t2) "
             "ORDER BY a")
    assert rows == [(2,), (3,)]


def test_exists_correlated(con):
    rows = q(con, "SELECT a FROM t1 WHERE EXISTS "
             "(SELECT 1 FROM t2 WHERE k = a) ORDER BY a")
    assert rows == [(2,), (3,)]
    rows = q(con, "SELECT a FROM t1 WHERE NOT EXISTS "
             "(SELECT 1 FROM t2 WHERE k = a) ORDER BY a")
    assert rows == [(1,), (4,), (5,)]


def test_correlated_scalar_agg(con):
    # each row of t2 vs sum of t1.b for matching key
    rows = q(con, "SELECT k FROM t2 WHERE v > "
             "(SELECT sum(b) FROM t1 WHERE a = k) ORDER BY k")
    assert rows == [(2,), (3,)]


def test_union_all(con):
    rows = q(con, "SELECT a FROM t1 WHERE a = 1 UNION ALL "
             "SELECT k FROM t2 WHERE k = 6")
    assert sorted(rows) == [(1,), (6,)]


def test_cte(con):
    rows = q(con, "WITH big AS (SELECT a, b FROM t1 WHERE b >= 30) "
             "SELECT sum(a) FROM big")
    assert rows == [(12,)]


def test_subquery_from(con):
    rows = q(con, "SELECT mx FROM (SELECT max(b) AS mx FROM t1) sub")
    assert rows == [(50,)]


def test_avg_division(con):
    rows = q(con, "SELECT avg(a), sum(a) / count(a) FROM t1")
    assert rows[0][0] == 3.0


def test_date_literal_and_extract(con):
    import pyarrow as pa
    con.register("d1", pa.table({
        "d": pa.array([datetime.date(1994, 1, 1),
                       datetime.date(1995, 6, 15),
                       datetime.date(1994, 12, 31)])}))
    rows = q(con, "SELECT count(*) FROM d1 WHERE d >= date '1994-01-01' "
             "AND d < date '1995-01-01'")
    assert rows == [(2,)]
    rows = q(con, "SELECT year(d), count(*) FROM d1 GROUP BY 1 ORDER BY 1")
    assert rows == [(1994, 2), (1995, 1)]


def test_decimal_sql(con):
    import pyarrow as pa
    con.register("dec1", pa.table({
        "p": pa.array([decimal.Decimal("10.50"), decimal.Decimal("1.25")],
                      pa.decimal128(15, 2)),
        "disc": pa.array([decimal.Decimal("0.10"), decimal.Decimal("0.00")],
                         pa.decimal128(15, 2))}))
    rows = q(con, "SELECT sum(p * (1 - disc)) FROM dec1")
    assert rows == [(decimal.Decimal("10.7000"),)]


def test_create_view(con):
    con.execute("CREATE VIEW v1 AS SELECT a, b FROM t1 WHERE a <= 2")
    assert q(con, "SELECT sum(b) FROM v1") == [(30,)]


def test_substring(con):
    c2 = refsuite.connect()
    c2.register("s1", {"s": ["hello", "world", "help"]})
    rows = q(c2, "SELECT s FROM s1 WHERE substring(s, 1, 3) = 'hel' "
             "ORDER BY s")
    assert rows == [("help",), ("hello",)] or rows == [("hello",), ("help",)]


def test_prepared_parameters(con):
    rows = con.execute("SELECT a FROM t1 WHERE a > ? AND b < ? ORDER BY a",
                       params=[2, 50]).fetchall()
    assert rows == [(3,), (4,)]
    rows = con.execute("SELECT a FROM t1 WHERE s = $1 ORDER BY a",
                       params=["x"]).fetchall()
    assert rows == [(1,), (3,)]
    import pytest as _pytest
    from ddb_tpu_torch.sql.binder import BindError
    with _pytest.raises(BindError):
        con.execute("SELECT a FROM t1 WHERE a > ?")


# ---- recursive CTEs (reference: test/sql/cte/recursive_cte*.test) -------

def test_recursive_cte_union_all(con):
    rows = con.execute("""
        WITH RECURSIVE t(n) AS (
            SELECT 1
            UNION ALL
            SELECT n + 1 FROM t WHERE n < 10
        ) SELECT sum(n), count(*), min(n), max(n) FROM t""").fetchall()
    assert rows == [(55, 10, 1, 10)]


def test_recursive_cte_union_distinct_cycle(con):
    c2 = refsuite.connect()
    c2.register("edges", {"src": [1, 2, 3, 4, 2], "dst": [2, 3, 4, 2, 1]})
    rows = c2.execute("""
        WITH RECURSIVE reach(node) AS (
            SELECT 1
            UNION
            SELECT e.dst FROM reach r JOIN edges e ON r.node = e.src
        ) SELECT node FROM reach ORDER BY node""").fetchall()
    assert rows == [(1,), (2,), (3,), (4,)]


def test_recursive_cte_multi_column(con):
    rows = con.execute("""
        WITH RECURSIVE fib(a, b) AS (
            SELECT 0, 1
            UNION ALL
            SELECT b, a + b FROM fib WHERE b < 100
        ) SELECT max(b) FROM fib""").fetchall()
    assert rows == [(144,)]


def test_cte_column_aliases(con):
    rows = con.execute(
        "WITH c(x, y) AS (SELECT 1, 2) SELECT y, x FROM c").fetchall()
    assert rows == [(2, 1)]


def test_recursive_cte_in_outer_join(con):
    rows = con.execute("""
        WITH RECURSIVE seq(n) AS (
            SELECT 1 UNION ALL SELECT n + 1 FROM seq WHERE n < 5
        ) SELECT s1.n, s2.n FROM seq s1
          JOIN seq s2 ON s2.n = s1.n + 1
          ORDER BY s1.n""").fetchall()
    assert rows == [(1, 2), (2, 3), (3, 4), (4, 5)]


# ---- explicit SEMI/ANTI/POSITIONAL join syntax (reference:
# physical_positional_join.cpp; JoinType::SEMI/ANTI/RIGHT_SEMI/RIGHT_ANTI)

def test_semi_anti_positional_join_syntax(con):
    c2 = refsuite.connect()
    c2.register("a", {"k": [1, 2, 3, 4, 5], "v": [10, 20, 30, 40, 50]})
    c2.register("b", {"k": [3, 4, 9], "w": [30, 40, 90]})
    assert c2.execute("SELECT k, v FROM a SEMI JOIN b USING (k) "
                      "ORDER BY k").fetchall() == [(3, 30), (4, 40)]
    assert c2.execute("SELECT k FROM a ANTI JOIN b USING (k) ORDER BY k"
                      ).fetchall() == [(1,), (2,), (5,)]
    assert c2.execute("SELECT b.k, w FROM a RIGHT SEMI JOIN b "
                      "ON a.k=b.k ORDER BY b.k").fetchall() == \
        [(3, 30), (4, 40)]
    assert c2.execute("SELECT b.k FROM a RIGHT ANTI JOIN b ON a.k=b.k"
                      ).fetchall() == [(9,)]
    assert c2.execute("SELECT * FROM a POSITIONAL JOIN b").fetchall() == [
        (1, 10, 3, 30), (2, 20, 4, 40), (3, 30, 9, 90),
        (4, 40, None, None), (5, 50, None, None)]


# ---- string casts (reference: src/common/operator/cast_operators.cpp,
# string_cast.cpp) ----

def test_cast_numeric_to_varchar(con):
    c2 = refsuite.connect()
    c2.register("t", {"a": [1, 22, 333], "d": [7, 18993, 10957]})
    assert c2.execute("SELECT CAST(a AS VARCHAR) FROM t").fetchall() == \
        [("1",), ("22",), ("333",)]
    assert c2.execute("SELECT a::VARCHAR || '!' FROM t").fetchall() == \
        [("1!",), ("22!",), ("333!",)]
    # lexicographic order of stringified ints: '1' < '22' < '333'
    # but '22' > '100' would sort after — dictionary must be lex-sorted
    c2.register("u", {"x": [100, 22, 3]})
    assert c2.execute("SELECT x::VARCHAR FROM u ORDER BY x::VARCHAR"
                      ).fetchall() == [("100",), ("22",), ("3",)]
    assert c2.execute("SELECT CAST(DATE '2020-01-05' AS VARCHAR)"
                      ).fetchall() == [("2020-01-05",)]


def test_cast_varchar_to_numeric(con):
    from ddb_tpu_torch.sql.binder import ConversionError
    c2 = refsuite.connect()
    c2.register("t", {"num": ["10", "20", "bad"],
                      "d": ["2020-01-05", "2021-06-30", "1999-12-31"]})
    with pytest.raises(ConversionError):
        c2.execute("SELECT CAST(num AS INTEGER) FROM t").fetchall()
    assert c2.execute("SELECT TRY_CAST(num AS INTEGER) FROM t"
                      ).fetchall() == [(10,), (20,), (None,)]
    rows = c2.execute("SELECT CAST(d AS DATE) FROM t").fetchall()
    import datetime
    assert rows[0][0] == datetime.date(2020, 1, 5)
    assert c2.execute(
        "SELECT TRY_CAST('1.7' AS INTEGER), TRY_CAST('x' AS INTEGER), "
        "CAST('1.5' AS DECIMAL(4,2))").fetchall() == \
        [(2, None, decimal.Decimal("1.50"))]


def test_recursive_cte_varchar_concat(con):
    """Recursive term grows the string dictionary each iteration
    (path enumeration); codes must not be unioned raw across
    dictionaries (reference: test/sql/cte/recursive_cte.test paths)."""
    c2 = refsuite.connect()
    c2.register("tree", {"id": [1, 2, 3, 4, 5],
                         "parent": [None, 1, 1, 2, 2],
                         "name": ["r", "a", "b", "x", "y"]})
    rows = c2.execute("""
        WITH RECURSIVE paths(id, path) AS (
            SELECT id, name FROM tree WHERE parent IS NULL
            UNION ALL
            SELECT t.id, p.path || '/' || t.name
            FROM tree t JOIN paths p ON t.parent = p.id
        ) SELECT path FROM paths ORDER BY path""").fetchall()
    assert rows == [("r",), ("r/a",), ("r/a/x",), ("r/a/y",), ("r/b",)]


def test_recursive_cte_varchar_union_distinct(con):
    c2 = refsuite.connect()
    c2.register("e", {"s": ["ab", "bc"], "d": ["bc", "ab"]})
    rows = c2.execute("""
        WITH RECURSIVE w(x) AS (
            SELECT 'ab'
            UNION
            SELECT e.d FROM w JOIN e ON w.x = e.s
        ) SELECT x FROM w ORDER BY x""").fetchall()
    assert rows == [("ab",), ("bc",)]


def test_recursive_cte_numeric_to_varchar_anchor(con):
    """VARCHAR anchor + numeric recursive term: DuckDB casts the
    recursive term to the anchor type (bind_recursive_cte_node.cpp)."""
    rows = con.execute("""
        WITH RECURSIVE t(n, s) AS (
            SELECT 1, 'x'
            UNION ALL
            SELECT n + 1, n * 10 FROM t WHERE n < 3
        ) SELECT n, s FROM t ORDER BY n""").fetchall()
    assert rows == [(1, "x"), (2, "10"), (3, "20")]


def test_recursive_cte_numeric_width_cast(con):
    """INT anchor + DOUBLE recursive term: recursive rows are cast to
    the anchor type, not silently concatenated."""
    rows = con.execute("""
        WITH RECURSIVE t(n) AS (
            SELECT 1
            UNION ALL
            SELECT n + 0.5 FROM t WHERE n < 3
        ) SELECT n FROM t ORDER BY n""").fetchall()
    vals = [r[0] for r in rows]
    assert vals[0] == 1 and len(vals) >= 3
    assert all(isinstance(v, int) for v in vals)


def test_recursive_cte_varchar_to_int_still_errors(con):
    import pytest as _pytest
    from ddb_tpu_torch.sql.binder import BindError
    with _pytest.raises(BindError):
        con.execute("""
            WITH RECURSIVE t(n) AS (
                SELECT 1 UNION ALL SELECT 'abc' FROM t WHERE n < 3
            ) SELECT n FROM t""")


# ---- range (inequality) joins (reference:
# operator/join/physical_piecewise_merge_join.cpp, physical_iejoin.cpp) ----

@pytest.fixture()
def range_con():
    c = refsuite.connect()
    c.register("lt", {"a": [1, 5, 10, None], "id": [1, 2, 3, 4]})
    c.register("rt", {"b": [3, 7, None], "rid": [1, 2, 3]})
    return c


def test_range_join_inner(range_con):
    rows = range_con.execute(
        "SELECT id, rid FROM lt JOIN rt ON a < b ORDER BY id, rid"
    ).fetchall()
    assert rows == [(1, 1), (1, 2), (2, 2)]


def test_range_join_flipped_op(range_con):
    rows = range_con.execute(
        "SELECT id, rid FROM lt JOIN rt ON b <= a ORDER BY id, rid"
    ).fetchall()
    assert rows == [(2, 1), (3, 1), (3, 2)]


def test_range_join_left_outer(range_con):
    rows = range_con.execute(
        "SELECT id, rid FROM lt LEFT JOIN rt ON a > b ORDER BY id, rid"
    ).fetchall()
    assert rows == [(1, None), (2, 1), (3, 1), (3, 2), (4, None)]


def test_range_join_full_outer(range_con):
    rows = range_con.execute(
        "SELECT id, rid FROM lt FULL JOIN rt ON a < b "
        "ORDER BY id NULLS FIRST, rid").fetchall()
    assert rows == [(None, 3), (1, 1), (1, 2), (2, 2), (3, None),
                    (4, None)]


def test_iejoin_two_inequalities(range_con):
    range_con.register("ev", {"s": [1, 4, 8], "e": [5, 6, 12],
                              "eid": [1, 2, 3]})
    range_con.register("pt", {"x": [2, 5, 9, 13], "pid": [1, 2, 3, 4]})
    rows = range_con.execute(
        "SELECT eid, pid FROM ev JOIN pt ON x >= s AND x < e "
        "ORDER BY eid, pid").fetchall()
    assert rows == [(1, 1), (2, 2), (3, 3)]


def test_exists_inequality_correlation(range_con):
    rows = range_con.execute(
        "SELECT id FROM lt WHERE EXISTS "
        "(SELECT 1 FROM rt WHERE lt.a < rt.b) ORDER BY id").fetchall()
    assert rows == [(1,), (2,)]
    rows = range_con.execute(
        "SELECT id FROM lt WHERE NOT EXISTS "
        "(SELECT 1 FROM rt WHERE lt.a < rt.b) ORDER BY id").fetchall()
    assert rows == [(3,), (4,)]


def test_negative_float_order_and_range():
    c = refsuite.connect()
    c.register("f1", {"v": [0.5, -1.5, 2.0, -0.25, None]})
    c.register("f2", {"w": [0, 1]})
    rows = c.execute("SELECT v FROM f1 ORDER BY v").fetchall()
    assert rows == [(-1.5,), (-0.25,), (0.5,), (2.0,), (None,)]
    rows = c.execute("SELECT v, w FROM f1 JOIN f2 ON v < w "
                     "ORDER BY v, w").fetchall()
    assert rows == [(-1.5, 0), (-1.5, 1), (-0.25, 0), (-0.25, 1),
                    (0.5, 1)]


# ---- ASOF joins (reference: operator/join/physical_asof_join.cpp) --------

@pytest.fixture()
def asof_con():
    c = refsuite.connect()
    c.register("trades", {"sym": ["a", "a", "b", "b", "a"],
                          "t": [3, 7, 2, 9, 1], "px": [10, 11, 20, 21, 9]})
    c.register("quotes", {"sym": ["a", "a", "b", "b"],
                          "qt": [2, 6, 2, 8], "bid": [100, 101, 200, 201]})
    return c


def test_asof_join_inner(asof_con):
    r = asof_con.execute("""
        SELECT t, px, bid FROM trades ASOF JOIN quotes
        ON trades.sym = quotes.sym AND trades.t >= quotes.qt
        ORDER BY trades.sym, t""").fetchall()
    assert r == [(3, 10, 100), (7, 11, 101), (2, 20, 200), (9, 21, 201)]


def test_asof_join_left(asof_con):
    r = asof_con.execute("""
        SELECT t, px, bid FROM trades ASOF LEFT JOIN quotes
        ON trades.sym = quotes.sym AND trades.t >= quotes.qt
        ORDER BY trades.sym, t""").fetchall()
    assert r == [(1, 9, None), (3, 10, 100), (7, 11, 101), (2, 20, 200),
                 (9, 21, 201)]


def test_asof_join_strict_and_reversed(asof_con):
    r = asof_con.execute("""
        SELECT t, bid FROM trades ASOF JOIN quotes
        ON trades.sym = quotes.sym AND trades.t > quotes.qt
        ORDER BY trades.sym, t""").fetchall()
    assert r == [(3, 100), (7, 101), (9, 201)]
    r = asof_con.execute("""
        SELECT t, bid FROM trades ASOF JOIN quotes
        ON trades.sym = quotes.sym AND trades.t <= quotes.qt
        ORDER BY trades.sym, t""").fetchall()
    assert r == [(1, 100), (3, 101), (2, 200)]


# ---- GROUPING SETS / ROLLUP / CUBE (reference: grouping-set expansion,
# src/planner/binder/query_node/bind_select_node.cpp) ----------------------

@pytest.fixture()
def gs_con():
    c = refsuite.connect()
    c.register("gs", {"g": ["a", "a", "b", "b"], "h": [1, 2, 1, 2],
                      "v": [10, 20, 30, 40]})
    return c


def test_rollup(gs_con):
    r = gs_con.execute("""SELECT g, h, sum(v) FROM gs GROUP BY ROLLUP(g, h)
        ORDER BY g NULLS LAST, h NULLS LAST""").fetchall()
    assert r == [('a', 1, 10), ('a', 2, 20), ('a', None, 30), ('b', 1, 30),
                 ('b', 2, 40), ('b', None, 70), (None, None, 100)]


def test_cube(gs_con):
    r = gs_con.execute("""SELECT g, h, sum(v) FROM gs GROUP BY CUBE(g, h)
        ORDER BY g NULLS LAST, h NULLS LAST""").fetchall()
    assert r == [('a', 1, 10), ('a', 2, 20), ('a', None, 30), ('b', 1, 30),
                 ('b', 2, 40), ('b', None, 70), (None, 1, 40),
                 (None, 2, 60), (None, None, 100)]


def test_grouping_sets(gs_con):
    r = gs_con.execute("""SELECT g, h, sum(v) FROM gs
        GROUP BY GROUPING SETS ((g), (h), ())
        ORDER BY g NULLS LAST, h NULLS LAST""").fetchall()
    assert r == [('a', None, 30), ('b', None, 70), (None, 1, 40),
                 (None, 2, 60), (None, None, 100)]


def test_topn_fusion():
    """ORDER BY + LIMIT fuses to TopN (reference: topn_optimizer.cpp);
    results identical to full sort + limit."""
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE t AS SELECT range AS a, range % 7 AS b,"
          " range % 3 AS m FROM range(500)")
    assert c.sql("SELECT a FROM t ORDER BY b DESC, a LIMIT 4").fetchall() \
        == [(6,), (13,), (20,), (27,)]
    assert c.sql("SELECT a FROM t ORDER BY a DESC LIMIT 3 OFFSET 2") \
        .fetchall() == [(497,), (496,), (495,)]
    # offset beyond row count
    assert c.sql("SELECT a FROM t ORDER BY a LIMIT 5 OFFSET 499") \
        .fetchall() == [(499,)]
    plan = c.sql("EXPLAIN SELECT a FROM t ORDER BY a LIMIT 5").fetchall()
    assert "TopN" in str(plan)


def test_string_function_breadth(oracle_differential=None):
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE s (x VARCHAR)")
    c.sql("INSERT INTO s VALUES ('Hello World'), ('foo')")
    rows = c.sql(
        "SELECT left(x,3), right(x,2), lpad(x,13,'*'), repeat(x,2),"
        " ascii(x), strpos(x,'o'), levenshtein(x,'foo'),"
        " split_part(x,' ',1), initcap(x) FROM s").fetchall()
    assert rows[0] == ("Hel", "ld", "**Hello World",
                       "Hello WorldHello World", 72, 5, 9, "Hello",
                       "Hello world")
    assert rows[1][6] == 0      # levenshtein(foo, foo)
    (h,), = c.sql("SELECT md5('abc')").fetchall()
    assert h == "900150983cd24fb0d6963f7d28e17f72"


def test_date_function_breadth():
    import datetime
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE d (x DATE)")
    c.sql("INSERT INTO d VALUES (DATE '1996-03-13'), (DATE '2000-01-01')")
    rows = c.sql("SELECT dayofyear(x), week(x), isoyear(x), last_day(x),"
                 " century(x), epoch(x), monthname(x), dayname(x)"
                 " FROM d ORDER BY x").fetchall()
    assert rows[0] == (73, 11, 1996, datetime.date(1996, 3, 31), 20,
                       826675200.0, "March", "Wednesday")
    # 2000-01-01 is ISO week 52 of 1999
    assert rows[1][1] == 52 and rows[1][2] == 1999


# ---------------------------------------------------------------------------
# LATERAL joins (reference: bind_joinref.cpp lateral handling +
# flatten_dependent_join.cpp)
# ---------------------------------------------------------------------------
@pytest.fixture()
def lateral_con():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE ll (id INTEGER, k INTEGER)")
    c.sql("INSERT INTO ll VALUES (1, 10), (2, 20), (3, 30)")
    c.sql("CREATE TABLE rr (k INTEGER, v INTEGER)")
    c.sql("INSERT INTO rr VALUES (10, 100), (10, 101), (20, 200)")
    return c


def test_lateral_equality(lateral_con):
    rows = lateral_con.sql(
        "SELECT id, t.v FROM ll, LATERAL"
        " (SELECT v FROM rr WHERE rr.k = ll.k) t"
        " ORDER BY id, t.v").fetchall()
    assert rows == [(1, 100), (1, 101), (2, 200)]


def test_lateral_outer_expr(lateral_con):
    rows = lateral_con.sql(
        "SELECT id, t.s FROM ll, LATERAL"
        " (SELECT v + ll.id AS s FROM rr WHERE rr.k = ll.k) t"
        " ORDER BY id, s").fetchall()
    assert rows == [(1, 101), (1, 102), (2, 202)]


def test_left_join_lateral(lateral_con):
    rows = lateral_con.sql(
        "SELECT id, t.v FROM ll LEFT JOIN LATERAL"
        " (SELECT v FROM rr WHERE rr.k = ll.k) t ON TRUE"
        " ORDER BY id, t.v").fetchall()
    assert rows == [(1, 100), (1, 101), (2, 200), (3, None)]


def test_lateral_aggregate(lateral_con):
    rows = lateral_con.sql(
        "SELECT id, t.c, t.m FROM ll, LATERAL"
        " (SELECT count(*) c, max(v) m FROM rr WHERE rr.k = ll.k) t"
        " ORDER BY id").fetchall()
    assert rows == [(1, 2, 101), (2, 1, 200), (3, 0, None)]


def test_lateral_on_residual(lateral_con):
    rows = lateral_con.sql(
        "SELECT id, t.v FROM ll JOIN LATERAL"
        " (SELECT v FROM rr WHERE rr.k = ll.k) t ON t.v % 2 = 0"
        " ORDER BY id").fetchall()
    assert rows == [(1, 100), (2, 200)]


def test_lateral_chained(lateral_con):
    rows = lateral_con.sql(
        "SELECT id, a.x, b.y FROM ll,"
        " LATERAL (SELECT id + 1 AS x) a,"
        " LATERAL (SELECT a.x * 10 AS y) b ORDER BY id").fetchall()
    assert rows == [(1, 2, 20), (2, 3, 30), (3, 4, 40)]


def test_lateral_inequality(lateral_con):
    rows = lateral_con.sql(
        "SELECT id, t.v FROM ll, LATERAL"
        " (SELECT v FROM rr WHERE rr.v > ll.k * 5) t"
        " ORDER BY id, v").fetchall()
    assert rows == [(1, 100), (1, 101), (1, 200), (2, 101), (2, 200),
                    (3, 200)]


def test_recursive_cte_growing_strings():
    # recursive term makes NEW strings each iteration: routes through the
    # bind-time host fixpoint with per-iteration dictionary rebind
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    rows = c.sql(
        "WITH RECURSIVE t(p, n) AS ("
        " SELECT 'a', 1 UNION ALL"
        " SELECT p || '/' || CAST(n+1 AS VARCHAR), n+1 FROM t WHERE n < 4)"
        " SELECT p, n FROM t ORDER BY n").fetchall()
    assert rows == [("a", 1), ("a/2", 2), ("a/2/3", 3), ("a/2/3/4", 4)]


def test_recursive_cte_numeric_to_varchar_anchor():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    rows = c.sql(
        "WITH RECURSIVE t(s) AS ("
        " SELECT 'x' UNION ALL SELECT 1 FROM t WHERE s = 'x')"
        " SELECT * FROM t ORDER BY s").fetchall()
    assert rows == [("1",), ("x",)]


def test_collate_nocase_noaccent():
    # reference: ICU collations (extension/icu/icu_collate.cpp); ours
    # folds the dictionary at bind time
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE cs (v VARCHAR)")
    c.sql("INSERT INTO cs VALUES ('Apple'), ('banana'), ('CHERRY'),"
          " ('äpfel')")
    assert c.sql("SELECT v FROM cs WHERE v COLLATE NOCASE = 'apple'"
                 ).fetchall() == [("Apple",)]
    assert c.sql("SELECT v FROM cs WHERE v COLLATE NOACCENT = 'apfel'"
                 ).fetchall() == [("äpfel",)]
    assert c.sql("SELECT 'ABC' COLLATE NOCASE = 'abc'").fetchall() \
        == [(True,)]
    rows = c.sql("SELECT v FROM cs ORDER BY v COLLATE NOCASE").fetchall()
    assert rows[0] == ("Apple",) and rows[1] == ("banana",)


def test_mark_join_exists_under_or():
    # EXISTS/IN below the top level plan as MARK joins (reference:
    # plan_subquery.cpp mark-join planning; TPC-DS q10/q35 shape)
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE mc (id INTEGER)")
    c.sql("INSERT INTO mc VALUES (1),(2),(3),(4)")
    c.sql("CREATE TABLE ms (cid INTEGER)")
    c.sql("INSERT INTO ms VALUES (1),(1),(3)")
    c.sql("CREATE TABLE mw (cid INTEGER)")
    c.sql("INSERT INTO mw VALUES (2)")
    assert c.sql(
        "SELECT id FROM mc WHERE EXISTS (SELECT 1 FROM ms WHERE"
        " ms.cid = mc.id) OR EXISTS (SELECT 1 FROM mw WHERE"
        " mw.cid = mc.id) ORDER BY id").fetchall() == [(1,), (2,), (3,)]
    assert c.sql(
        "SELECT id FROM mc WHERE id = 4 OR NOT EXISTS"
        " (SELECT 1 FROM ms WHERE ms.cid = mc.id) ORDER BY id"
    ).fetchall() == [(2,), (4,)]
    assert c.sql(
        "SELECT id, CASE WHEN EXISTS (SELECT 1 FROM ms WHERE"
        " ms.cid = mc.id) THEN 'y' ELSE 'n' END FROM mc ORDER BY id"
    ).fetchall() == [(1, "y"), (2, "n"), (3, "y"), (4, "n")]
    assert c.sql("SELECT id, id IN (SELECT cid FROM ms) FROM mc"
                 " ORDER BY id").fetchall() \
        == [(1, True), (2, False), (3, True), (4, False)]


def test_mode_aggregate():
    c = refsuite.connect()
    c.register("md", {"g": [1, 1, 1, 2, 2, 3, 3, 3, 3],
                      "v": [5, 1, 5, None, 7, 2, 2, 8, None],
                      "s": ["a", "b", "b", "c", None, "d", "d", "e", "d"]})
    assert c.sql("SELECT g, mode(v), mode(s) FROM md GROUP BY g "
                 "ORDER BY g").fetchall() == \
        [(1, 5, "b"), (2, 7, "c"), (3, 2, "d")]
    # ungrouped; ties break to the smallest value
    assert c.sql("SELECT mode(v) FROM md").fetchall() == [(2,)]
    assert c.sql("SELECT mode(x) FROM (SELECT 1 AS x WHERE false)"
                 ).fetchall() == [(None,)]


def test_holistic_group_alignment_all_null_group():
    # regression: a group whose payload is entirely NULL must keep its
    # slot in the group list (median/mode previously shifted results)
    c = refsuite.connect()
    c.register("hn", {"g": [1, 1, 2, 2, 3], "v": [10, 20, None, None, 30]})
    assert c.sql("SELECT g, median(v), mode(v), count(v) FROM hn "
                 "GROUP BY g ORDER BY g").fetchall() == \
        [(1, 15.0, 10, 2), (2, None, None, 0), (3, 30.0, 30, 1)]


def test_unaliased_derived_table():
    c = refsuite.connect()
    assert c.sql("SELECT * FROM (SELECT 1 AS a), (SELECT 2 AS b)"
                 ).fetchall() == [(1, 2)]


def test_correlated_limit_subquery():
    c = refsuite.connect()
    c.register("cl_t", {"g": [1, 1, 2, 2, 5], "v": [1, 2, 3, 4, 9]})
    c.register("cl_u", {"g": [1, 1, 1, 2, 2], "w": [10, 20, 30, 40, 50]})
    assert c.sql(
        "SELECT g, v, (SELECT w FROM cl_u WHERE cl_u.g = cl_t.g "
        "ORDER BY w LIMIT 1) FROM cl_t ORDER BY g, v").fetchall() == \
        [(1, 1, 10), (1, 2, 10), (2, 3, 40), (2, 4, 40), (5, 9, None)]
    assert c.sql(
        "SELECT g, (SELECT w FROM cl_u WHERE cl_u.g = cl_t.g "
        "ORDER BY w DESC LIMIT 1) FROM cl_t ORDER BY g, v").fetchall() \
        == [(1, 30), (1, 30), (2, 50), (2, 50), (5, None)]


def test_ordered_aggregates():
    c = refsuite.connect()
    c.register("oa", {"g": [1, 1, 1, 2, 2], "v": [3, 1, 2, 9, 8],
                      "s": ["c", "a", "b", "z", "y"]})
    assert c.sql("SELECT g, list(v ORDER BY v DESC), "
                 "string_agg(s, '|' ORDER BY s) FROM oa GROUP BY g "
                 "ORDER BY g").fetchall() == \
        [(1, [3, 2, 1], "a|b|c"), (2, [9, 8], "y|z")]
    assert c.sql("SELECT string_agg(s, ',' ORDER BY v DESC) FROM oa"
                 ).fetchall() == [("z,y,c,b,a",)]
    # ORDER BY on a column pruned from the projection still binds
    assert c.sql("SELECT g, list(v ORDER BY s DESC) FROM oa GROUP BY g "
                 "ORDER BY g").fetchall() == [(1, [3, 2, 1]),
                                              (2, [9, 8])]
    # order-insensitive aggregates accept and ignore the modifier
    assert c.sql("SELECT sum(v ORDER BY s) FROM oa").fetchall() == \
        [(23,)]


def test_arg_min_max():
    c = refsuite.connect()
    c.register("am", {"g": [1, 1, 1, 2, 2, 3],
                      "v": [3, 1, 2, 9, 8, None],
                      "s": ["c", "a", "b", "z", "y", "q"]})
    assert c.sql("SELECT g, arg_max(s, v), arg_min(s, v) FROM am "
                 "GROUP BY g ORDER BY g").fetchall() == \
        [(1, "c", "a"), (2, "z", "y"), (3, None, None)]
    assert c.sql("SELECT arg_max(s, v), max_by(v, s), argmin(v, v) "
                 "FROM am").fetchall() == [("z", 9, 1)]


def test_histogram_and_top_k():
    c = refsuite.connect()
    c.register("hg", {"g": [1, 1, 1, 2, 2], "v": [3, 1, 3, 9, None],
                      "s": ["c", "a", "a", "z", "z"]})
    assert c.sql("SELECT g, histogram(v) FROM hg GROUP BY g ORDER BY g"
                 ).fetchall() == [(1, {1: 1, 3: 2}), (2, {9: 1})]
    assert c.sql("SELECT histogram(s), approx_top_k(s, 2) FROM hg"
                 ).fetchall() == [({"a": 2, "c": 1, "z": 2},
                                   ["a", "z"])]


def test_product_aggregate():
    c = refsuite.connect()
    c.register("pr", {"g": [1, 1, 2, 2, 3], "v": [2.0, 3.0, 4.0, None,
                                                  None],
                      "j": [1, 1, 2, 2, 3]})
    assert c.sql("SELECT g, product(v) FROM pr GROUP BY g ORDER BY g"
                 ).fetchall() == [(1, 6.0), (2, 4.0), (3, None)]
    assert c.sql("SELECT product(v), product(DISTINCT j) FROM pr"
                 ).fetchall() == [(24.0, 6.0)]


def test_qualified_group_expressions():
    c = refsuite.connect()
    c.register("qg", {"i": [1, 2, 3, 4], "j": [4, 4, 6, 6]})
    assert c.sql("SELECT qg.j * 2 FROM qg GROUP BY j * 2 "
                 "ORDER BY j * 2").fetchall() == [(8,), (12,)]
    assert c.sql("SELECT j * 2 FROM qg GROUP BY qg.j * 2 "
                 "ORDER BY 1").fetchall() == [(8,), (12,)]


def test_nested_loop_outer_joins():
    c = refsuite.connect()
    c.register("nlo_l", {"i": [1, 2, 3]})
    c.register("nlo_r", {"j": [2, 3, 9]})
    assert c.sql("SELECT i, j FROM nlo_l LEFT JOIN nlo_r ON i > j "
                 "ORDER BY i, j").fetchall() == \
        [(1, None), (2, None), (3, 2)]
    assert c.sql("SELECT i, j FROM nlo_l RIGHT JOIN nlo_r "
                 "ON i <> j AND i + j > 4 ORDER BY j, i").fetchall() == \
        [(3, 2), (2, 3), (1, 9), (2, 9), (3, 9)]
    assert c.sql("SELECT i, j FROM nlo_l FULL JOIN nlo_r "
                 "ON i * j > 90 ORDER BY i, j").fetchall() == \
        [(1, None), (2, None), (3, None), (None, 2), (None, 3),
         (None, 9)]


def test_quantified_any_all():
    c = refsuite.connect()
    c.register("qt", {"i": [1, 2, 3]})
    c.register("qs", {"v": [2, None]})
    assert c.sql("SELECT i, i = ANY(SELECT v FROM qs) FROM qt "
                 "ORDER BY i").fetchall() == \
        [(1, None), (2, True), (3, None)]
    assert c.sql("SELECT i, i > ANY(SELECT v FROM qs) FROM qt "
                 "ORDER BY i").fetchall() == \
        [(1, None), (2, None), (3, True)]
    assert c.sql("SELECT i, i < ALL(SELECT v FROM qs) FROM qt "
                 "ORDER BY i").fetchall() == \
        [(1, None), (2, False), (3, False)]
    assert c.sql("SELECT i, i <> ALL(SELECT v FROM qs) FROM qt "
                 "ORDER BY i").fetchall() == \
        [(1, None), (2, False), (3, None)]
    assert c.sql("SELECT 5 > ANY(SELECT 1 WHERE false), "
                 "5 < ALL(SELECT 1 WHERE false)").fetchall() == \
        [(False, True)]


def test_distinct_on():
    c = refsuite.connect()
    c.register("don", {"g": [1, 1, 2, 2], "v": [30, 10, 20, 5]})
    assert c.sql("SELECT DISTINCT ON (g) g, v FROM don ORDER BY g, v"
                 ).fetchall() == [(1, 10), (2, 5)]
    assert c.sql("SELECT DISTINCT ON (g) g, v FROM don "
                 "ORDER BY g, v DESC").fetchall() == [(1, 30), (2, 20)]

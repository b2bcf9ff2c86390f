# Generated from tests/test_r4_breadth.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite r4_breadth); do not edit.
"""Round-4 front-end breadth: lambdas, comprehensions, VALUES cores,
WITHIN GROUP, histogram bins, FROM-first, strftime, verifier pragmas."""
from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture()
def con():
    return refsuite.connect()


def one(con, sql):
    return con.execute(sql).fetchall()[0][0]


def test_lambdas(con):
    assert one(con, "SELECT list_transform([1,2,3], x -> x + 1)") \
        == [2, 3, 4]
    assert one(con, "SELECT list_filter([1,2,3,4], x -> x % 2 = 0)") \
        == [2, 4]
    assert one(con, "SELECT list_reduce([1,2,3,4], (a, b) -> a + b)") \
        == 10
    assert one(con, "SELECT list_transform([1,2], lambda x: x * 10)") \
        == [10, 20]


def test_comprehension_and_array(con):
    assert one(con, "SELECT [x * 2 FOR x IN [1,2,3]]") == [2, 4, 6]
    assert one(con, "SELECT [x FOR x IN [1,2,3,4] IF x > 2]") == [3, 4]
    assert one(con, "SELECT array[7, 8]") == [7, 8]


def test_values_core(con):
    assert con.execute("VALUES (1, 'a'), (2, 'b')").fetchall() \
        == [(1, "a"), (2, "b")]
    con.execute("CREATE TABLE v AS VALUES (1.5), (2.5)")
    assert con.execute("SELECT count(*) FROM v").fetchall() == [(2,)]
    assert one(con, "SELECT 1 IN (VALUES (1), (2))") is True
    assert one(con, "SELECT 9 IN (VALUES (1), (2))") is False


def test_within_group(con):
    con.execute("CREATE TABLE g(x INTEGER)")
    con.execute("INSERT INTO g VALUES (1),(2),(3),(4)")
    assert one(con, "SELECT percentile_cont(0.5) WITHIN GROUP "
                    "(ORDER BY x) FROM g") == 2.5
    assert one(con, "SELECT percentile_disc(0.25) WITHIN GROUP "
                    "(ORDER BY x) FROM g") == 1
    assert one(con, "SELECT mode() WITHIN GROUP (ORDER BY x) FROM g") \
        == 1


def test_histogram_bins(con):
    con.execute("CREATE TABLE h AS SELECT range n FROM range(50)")
    m = one(con, "SELECT histogram(n, [10, 20, 30]) FROM h")
    assert m[10] == 11 and m[20] == 10 and m[2**63 - 1] == 19
    me = one(con, "SELECT histogram_exact(n, [5, 99]) FROM h")
    assert me == {5: 1, 99: 0}


def test_from_first_and_natural(con):
    con.execute("CREATE TABLE a(k INTEGER, v INTEGER)")
    con.execute("INSERT INTO a VALUES (1, 10)")
    con.execute("CREATE TABLE b(k INTEGER, w INTEGER)")
    con.execute("INSERT INTO b VALUES (1, 20)")
    assert con.execute("FROM a").fetchall() == [(1, 10)]
    assert con.execute("SELECT * FROM a NATURAL JOIN b").fetchall() \
        == [(1, 10, 20)]
    assert con.execute("FROM a SELECT v WHERE k = 1").fetchall() \
        == [(10,)]


def test_strftime(con):
    assert one(con, "SELECT strftime(DATE '2024-01-05', "
                    "'%Y/%m/%-d')") == "2024/01/5"
    assert one(con, "SELECT strftime('%d.%m.%Y', "
                    "DATE '1992-03-02')") == "02.03.1992"


def test_arg_null_variants(con):
    con.execute("CREATE TABLE t(a INTEGER, b INTEGER)")
    con.execute("INSERT INTO t VALUES (NULL, 5), (7, 3)")
    assert one(con, "SELECT arg_max(a, b) FROM t") == 7
    assert one(con, "SELECT arg_max_null(a, b) FROM t") is None


def test_verification_pragmas(con):
    con.execute("PRAGMA enable_verification")
    con.execute("CREATE TABLE t(a INTEGER)")
    con.execute("INSERT INTO t VALUES (3),(1)")
    assert con.execute("SELECT a + 1 FROM t ORDER BY a").fetchall() \
        == [(2,), (4,)]
    con.execute("PRAGMA disable_verification")


def test_list_funcs_over_agg_results(con):
    con.execute("CREATE TABLE z AS SELECT range i FROM range(5)")
    assert one(con, "SELECT list_sort(list(i)) FROM z") \
        == [0, 1, 2, 3, 4]
    assert one(con, "SELECT list_distinct(list(i % 2)) FROM z") \
        == [0, 1]

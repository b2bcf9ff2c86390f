# Generated from tests/test_macro.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite macro); do not edit.
"""SQL macros (reference: src/catalog/catalog_entry/macro_catalog_entry.cpp,
test/sql/catalog/function/)."""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture
def con():
    return refsuite.connect()


def test_scalar_macro(con):
    con.execute("CREATE MACRO add_one(x) AS x + 1")
    assert con.execute("SELECT add_one(41)").fetchall() == [(42,)]
    con.register("t", {"a": [1, 2, 3]})
    assert con.execute("SELECT add_one(a) FROM t ORDER BY a"
                       ).fetchall() == [(2,), (3,), (4,)]


def test_macro_default_params(con):
    con.execute("CREATE MACRO weighted(v, w := 2) AS v * w")
    assert con.execute("SELECT weighted(10), weighted(10, 3)"
                       ).fetchall() == [(20, 30)]


def test_macro_nested_and_replace(con):
    con.execute("CREATE MACRO add_one(x) AS x + 1")
    con.execute("CREATE MACRO twice(x) AS add_one(add_one(x))")
    assert con.execute("SELECT twice(5)").fetchall() == [(7,)]
    con.execute("CREATE OR REPLACE MACRO add_one(x) AS x + 100")
    assert con.execute("SELECT twice(5)").fetchall() == [(205,)]


def test_table_macro(con):
    con.execute("CREATE MACRO firstn(n) AS TABLE "
                "SELECT range AS r FROM range(n)")
    assert con.execute("SELECT * FROM firstn(3)").fetchall() == \
        [(0,), (1,), (2,)]


def test_drop_macro(con):
    con.execute("CREATE MACRO m(x) AS x")
    con.execute("DROP MACRO m")
    with pytest.raises(Exception):
        con.execute("SELECT m(1)")
    with pytest.raises(Exception):
        con.execute("DROP MACRO m")
    con.execute("DROP MACRO IF EXISTS m")


def test_macro_listed(con):
    con.execute("CREATE MACRO mx(x) AS x")
    rows = dict(con.execute(
        "SELECT function_name, function_type FROM duckdb_functions() "
        "WHERE function_type IN ('macro', 'table_macro')").fetchall())
    assert rows.get("mx") == "macro"


def test_macro_persistence(tmp_path):
    path = str(tmp_path / "m.dtb")
    c = refsuite.connect(path)
    c.execute("CREATE MACRO m1(x) AS x * 10")
    c.checkpoint()
    c2 = refsuite.connect(path)
    assert c2.execute("SELECT m1(4)").fetchall() == [(40,)]


def test_macro_wal_replay(tmp_path):
    path = str(tmp_path / "m.dtb")
    c = refsuite.connect(path)
    c.execute("CREATE MACRO m2(x) AS x - 1")
    c._wal.flush()
    c._wal = None
    c2 = refsuite.connect(path)
    assert c2.execute("SELECT m2(4)").fetchall() == [(3,)]


def test_table_function_expression_args(con):
    assert con.execute("SELECT count(*) FROM range(1 + 2)"
                       ).fetchall() == [(3,)]

# Generated from tests/test_system.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite system); do not edit.
"""Settings / introspection / EXPLAIN / profiling
(reference: src/function/table/system/*, main/query_profiler.hpp,
settings registry per common/settings.json)."""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture()
def con():
    c = refsuite.connect()
    c.register("t", {"a": [1, 2, 3], "s": ["x", "y", "x"]})
    return c


def test_duckdb_tables(con):
    rows = con.execute("SELECT table_name, column_count, estimated_size "
                       "FROM duckdb_tables()").fetchall()
    assert rows == [("t", 2, 3)]


def test_duckdb_columns(con):
    rows = con.execute(
        "SELECT column_name, data_type FROM duckdb_columns() "
        "WHERE table_name = 't' ORDER BY column_name").fetchall()
    assert rows == [("a", "BIGINT"), ("s", "VARCHAR")]


def test_settings(con):
    con.execute("SET threads = 4")
    rows = con.execute("SELECT value FROM duckdb_settings() "
                       "WHERE name = 'threads'").fetchall()
    assert rows == [("4",)]
    with pytest.raises(KeyError):
        con.execute("SET nonsense = 1")


def test_pragma_table_info(con):
    rows = con.execute("PRAGMA table_info('t')").fetchall()
    assert [r[1] for r in rows] == ["a", "s"]


def test_range_function(con):
    rows = con.execute("SELECT sum(range) FROM range(10)").fetchall()
    assert rows == [(45,)]
    rows = con.execute(
        "SELECT count(*) FROM generate_series(1, 5)").fetchall()
    assert rows == [(5,)]


def test_explain(con):
    rows = con.execute("EXPLAIN SELECT a FROM t WHERE a > 1").fetchall()
    text = "\n".join(r[0] for r in rows)
    assert "Get" in text and "Project" in text


def test_explain_analyze(con):
    rows = con.execute(
        "EXPLAIN ANALYZE SELECT s, sum(a) FROM t GROUP BY s").fetchall()
    text = "\n".join(r[0] for r in rows)
    assert "Aggregate" in text and "ms" in text


def test_profiling_setting(con):
    con.execute("PRAGMA enable_profiling")
    res = con.execute("SELECT count(*) FROM t")
    assert hasattr(res, "profile") and "Aggregate" in res.profile


def test_statement_verifier(con):
    con.execute("SET enable_verification = true")
    rows = con.execute("SELECT s, sum(a) FROM t GROUP BY s ORDER BY s") \
        .fetchall()
    assert rows == [("x", 4), ("y", 2)]
    con.execute("SET enable_verification = false")


def test_logging(con):
    con.log.clear()
    con.log.level = "debug"
    con.execute("SELECT count(*) FROM t")
    rows = con.execute("SELECT type, message FROM duckdb_logs() "
                       "WHERE type = 'query'").fetchall()
    assert rows and "executed" in rows[0][1]


def test_introspection_breadth():
    """All system table functions return (reference:
    src/function/table/system/* inventory)."""
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.sql("CREATE TABLE t (a INTEGER, s VARCHAR)")
    c.sql("INSERT INTO t VALUES (1,'x')")
    fns = ["duckdb_databases()", "duckdb_schemas()", "duckdb_keywords()",
           "duckdb_types()", "duckdb_functions()", "duckdb_constraints()",
           "duckdb_extensions()", "duckdb_optimizers()", "duckdb_memory()",
           "duckdb_temporary_files()", "pragma_database_size()",
           "pragma_storage_info('t')", "pragma_metadata_info()",
           "pragma_collations()", "pragma_version()", "test_all_types()",
           "duckdb_prepared_statements()", "duckdb_indexes()",
           "duckdb_sequences()", "duckdb_variables()"]
    for fn in fns:
        r = c.sql(f"SELECT * FROM {fn}")
        assert r.fetchall() is not None, fn
    assert c.sql("SELECT count(*) FROM duckdb_keywords()").fetchall()[0][0] > 50
    assert c.sql("SELECT count(*) FROM duckdb_functions()"
                 " WHERE function_type = 'aggregate'").fetchall()[0][0] > 10


def test_read_csv_table_function(tmp_path):
    from ddb_tpu_torch.testing.refsuite import Connection
    p = tmp_path / "x.csv"
    p.write_text("a,b\n1,x\n2,y\n")
    c = Connection()
    assert c.sql(f"SELECT * FROM read_csv('{p}') ORDER BY a").fetchall() \
        == [(1, 'x'), (2, 'y')]


# ---- secrets (reference: src/main/secret/secret_manager.cpp) -------------

def test_secret_manager():
    import ddb_tpu_torch
    con = refsuite.connect()
    con.execute("CREATE SECRET my_s3 (TYPE S3, KEY_ID 'AKIA123', "
                "SECRET 'shh', REGION 'us-east-1')")
    rows = con.execute(
        "SELECT name, type, secret_string FROM duckdb_secrets()"
    ).fetchall()
    assert rows[0][0] == "my_s3" and rows[0][1] == "s3"
    assert "shh" not in rows[0][2] and "redacted" in rows[0][2]
    assert con.secret_manager.find_for_path("s3://b/k").name == "my_s3"
    con.execute("DROP SECRET my_s3")
    assert con.execute("SELECT count(*) FROM duckdb_secrets()"
                       ).fetchall() == [(0,)]
    import pytest
    from ddb_tpu_torch.catalog import CatalogException
    with pytest.raises(CatalogException):
        con.execute("DROP SECRET nope")
    con.execute("DROP SECRET IF EXISTS nope")


def test_progress_bar_callback():
    import ddb_tpu_torch
    from ddb_tpu_torch.plan import physical
    from ddb_tpu_torch.sql import parser
    from ddb_tpu_torch.sql.binder import Binder
    con = refsuite.connect()
    con.register("t", {"a": [1, 2, 3]})
    seen = []
    plan = Binder(con.catalog, context=con).bind_select(
        parser.parse("SELECT sum(a) FROM t")[0])
    ctx = physical.ExecContext(
        refsuite.device(), progress=lambda d, t: seen.append((d, t)))
    physical.execute(plan, ctx=ctx)
    assert seen and seen[-1][0] == seen[-1][1] > 0


def test_valid_checker_invalidates_connection():
    import ddb_tpu_torch
    import pytest
    from ddb_tpu_torch.api import FatalError
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.dtb")
        con = refsuite.connect()
        con.register("t", {"a": [1]})
        con.save(p)
        with open(p, "r+b") as f:     # corrupt the payload
            f.seek(os.path.getsize(p) - 9)
            f.write(b"\xff" * 8)
        c2 = refsuite.connect()
        with pytest.raises((FatalError, IOError)):
            c2.load(p)
        if c2._invalidated is not None:
            with pytest.raises(FatalError):
                c2.execute("SELECT 1")


def test_sql_auto_complete():
    # reference: extension/autocomplete/autocomplete_extension.cpp
    import ddb_tpu_torch
    con = refsuite.connect()
    con.execute("CREATE TABLE customers (cust_id INTEGER)")
    rows = con.execute("SELECT * FROM sql_auto_complete('SEL')").fetchall()
    assert rows[0][0] == "SELECT"
    rows = con.execute(
        "SELECT suggestion FROM sql_auto_complete('SELECT * FROM cust')"
    ).fetchall()
    assert ("customers",) in rows


def test_describe_and_summarize():
    # DESCRIBE rewrite + shell SUMMARIZE (reference: relation_statement)
    import ddb_tpu_torch
    con = refsuite.connect()
    con.execute("CREATE TABLE dt (id INTEGER PRIMARY KEY, name VARCHAR)")
    con.execute("INSERT INTO dt VALUES (1, 'a'), (2, NULL)")
    rows = con.execute("DESCRIBE dt").fetchall()
    assert rows[0][:4] == ("id", "INTEGER", "NO", "PRI")
    assert rows[1][:3] == ("name", "VARCHAR", "YES")
    s = con.execute("SUMMARIZE dt").fetchall()
    assert s[0][0] == "id" and s[0][2] == "1" and s[0][3] == "2"
    assert s[1][11] == "50.00%"
    rows = con.execute("DESCRIBE SELECT id + 1 AS x FROM dt").fetchall()
    assert rows[0][0] == "x"

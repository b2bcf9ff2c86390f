# Generated from tests/test_dml.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite dml); do not edit.
"""DML, transactions, CDC, snapshots
(reference: test/sql/insert, test/sql/update, test/sql/delete; fork CDC
per SURVEY.md section 2.11)."""

from ddb_tpu_torch.testing import refsuite
import decimal

import pytest

import ddb_tpu_torch


def test_create_insert_select():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, b VARCHAR, c DECIMAL(10,2))")
    con.execute("INSERT INTO t VALUES (1, 'x', 1.50), (2, 'y', 2.25)")
    rows = con.execute("SELECT * FROM t ORDER BY a").fetchall()
    assert rows == [(1, "x", decimal.Decimal("1.50")),
                    (2, "y", decimal.Decimal("2.25"))]
    con.execute("INSERT INTO t (a) VALUES (3)")
    rows = con.execute("SELECT a, b FROM t WHERE b IS NULL").fetchall()
    assert rows == [(3, None)]


def test_insert_select():
    con = refsuite.connect()
    con.execute("CREATE TABLE src (a INTEGER, s VARCHAR)")
    con.execute("INSERT INTO src VALUES (1, 'p'), (2, 'q')")
    con.execute("CREATE TABLE dst (a INTEGER, s VARCHAR)")
    con.execute("INSERT INTO dst SELECT a + 10, s FROM src")
    assert con.execute("SELECT * FROM dst ORDER BY a").fetchall() == \
        [(11, "p"), (12, "q")]


def test_delete_update():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, v INTEGER)")
    con.execute("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
    con.execute("DELETE FROM t WHERE a = 2")
    assert con.execute("SELECT a FROM t ORDER BY a").fetchall() == \
        [(1,), (3,)]
    con.execute("UPDATE t SET v = v + 5 WHERE a = 3")
    assert con.execute("SELECT v FROM t ORDER BY a").fetchall() == \
        [(10,), (35,)]


def test_update_varchar():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, s VARCHAR)")
    con.execute("INSERT INTO t VALUES (1, 'old'), (2, 'keep')")
    con.execute("UPDATE t SET s = 'new' WHERE a = 1")
    assert con.execute("SELECT s FROM t ORDER BY a").fetchall() == \
        [("new",), ("keep",)]


def test_transaction_rollback():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER)")
    con.execute("INSERT INTO t VALUES (1)")
    con.execute("BEGIN")
    con.execute("INSERT INTO t VALUES (2)")
    assert len(con.execute("SELECT * FROM t").fetchall()) == 2
    con.execute("ROLLBACK")
    assert con.execute("SELECT * FROM t").fetchall() == [(1,)]


def test_cdc_stream():
    con = refsuite.connect()
    events = []
    con.on_change(events.append)
    con.execute("CREATE TABLE t (a INTEGER, s VARCHAR)")
    con.execute("INSERT INTO t VALUES (1, 'x'), (2, 'y')")
    con.execute("UPDATE t SET s = 'z' WHERE a = 1")
    con.execute("DELETE FROM t WHERE a = 2")
    assert [e.op for e in events] == ["insert", "update", "delete"]
    assert events[0].rows == [[1, "x"], [2, "y"]] or \
        events[0].rows == [(1, "x"), (2, "y")]
    assert events[1].old_rows == [(1, "x")]
    assert events[1].rows == [(1, "z")]
    assert events[2].rows == [(2, "y")]
    # HLC timestamps strictly increase
    assert events[0].hlc < events[1].hlc < events[2].hlc


def test_cdc_transaction_commit():
    con = refsuite.connect()
    events = []
    con.on_change(events.append)
    con.execute("CREATE TABLE t (a INTEGER)")
    con.execute("BEGIN")
    con.execute("INSERT INTO t VALUES (1)")
    assert events == []          # buffered until commit
    con.execute("COMMIT")
    assert [e.op for e in events] == ["insert"]


def test_snapshots():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER)")
    con.execute("INSERT INTO t VALUES (1), (2)")
    sid = con.create_snapshot()
    con.execute("DELETE FROM t")
    assert con.execute("SELECT count(*) FROM t").fetchall() == [(0,)]
    snap = con.snapshots.get(sid)
    assert snap["t"].num_rows == 2
    con.remove_snapshot(sid)


def test_hlc_external_advance():
    con = refsuite.connect()
    t1 = con.get_hlc_timestamp()
    con.set_hlc_timestamp(t1 + 10_000_000)
    assert con.get_hlc_timestamp() > t1 + 10_000_000


# ---------------------------------------------------------------------------
# constraint enforcement (reference: ConstraintException via ART verify,
# src/execution/index/art/art.cpp; ours: vectorized lexsort adjacent-equal)
# ---------------------------------------------------------------------------
def test_primary_key_rejects_duplicates():
    import pytest
    from ddb_tpu_torch.testing.refsuite import Connection
    from ddb_tpu_torch.storage.dml import ConstraintException
    c = Connection()
    c.sql("CREATE TABLE p (id INTEGER PRIMARY KEY, v VARCHAR)")
    c.sql("INSERT INTO p VALUES (1, 'a'), (2, 'b')")
    with pytest.raises(ConstraintException):
        c.sql("INSERT INTO p VALUES (2, 'c')")
    # failed insert rolled back
    assert c.sql("SELECT count(*) FROM p").fetchall() == [(2,)]
    with pytest.raises(ConstraintException):
        c.sql("INSERT INTO p VALUES (NULL, 'd')")   # PK implies NOT NULL
    with pytest.raises(ConstraintException):
        c.sql("UPDATE p SET id = 1 WHERE id = 2")
    assert c.sql("SELECT id FROM p ORDER BY id").fetchall() \
        == [(1,), (2,)]


def test_unique_allows_nulls():
    import pytest
    from ddb_tpu_torch.testing.refsuite import Connection
    from ddb_tpu_torch.storage.dml import ConstraintException
    c = Connection()
    c.sql("CREATE TABLE u (a INTEGER, tag VARCHAR UNIQUE)")
    c.sql("INSERT INTO u VALUES (1, 'x'), (2, NULL), (3, NULL)")
    with pytest.raises(ConstraintException):
        c.sql("INSERT INTO u VALUES (4, 'x')")
    assert c.sql("SELECT count(*) FROM u").fetchall() == [(3,)]


def test_composite_pk_and_introspection():
    import pytest
    from ddb_tpu_torch.testing.refsuite import Connection
    from ddb_tpu_torch.storage.dml import ConstraintException
    c = Connection()
    c.sql("CREATE TABLE cp (a INTEGER, b INTEGER, PRIMARY KEY (a, b))")
    c.sql("INSERT INTO cp VALUES (1, 1), (1, 2)")
    with pytest.raises(ConstraintException):
        c.sql("INSERT INTO cp SELECT 1, 2")
    rows = c.sql("SELECT constraint_type FROM duckdb_constraints()"
                 " WHERE table_name = 'cp'").fetchall()
    assert ("PRIMARY KEY",) in rows


def test_constraints_survive_save_load(tmp_path):
    import pytest
    from ddb_tpu_torch.testing.refsuite import Connection
    from ddb_tpu_torch.storage.dml import ConstraintException
    path = str(tmp_path / "k.dtb")
    c = Connection()
    c.sql("CREATE TABLE k (id INTEGER PRIMARY KEY)")
    c.sql("INSERT INTO k VALUES (1)")
    c.save(path)
    c2 = Connection()
    c2.load(path)
    with pytest.raises(ConstraintException):
        c2.sql("INSERT INTO k VALUES (1)")


def test_enum_type():
    # CREATE TYPE ... AS ENUM (reference: create_type_info.hpp; enum is a
    # dictionary type — ours: VARCHAR storage + insert-time domain check)
    import pytest
    from ddb_tpu_torch.testing.refsuite import Connection
    from ddb_tpu_torch.storage.dml import ConstraintException
    c = Connection()
    c.sql("CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')")
    c.sql("CREATE TABLE person (name VARCHAR, current_mood mood)")
    c.sql("INSERT INTO person VALUES ('a', 'happy'), ('b', NULL)")
    assert c.sql("SELECT name FROM person WHERE current_mood = 'happy'"
                 ).fetchall() == [("a",)]
    with pytest.raises(ConstraintException):
        c.sql("INSERT INTO person VALUES ('d', 'angry')")
    assert c.sql("SELECT count(*) FROM person").fetchall() == [(2,)]
    from ddb_tpu_torch.catalog import CatalogException
    with pytest.raises(CatalogException):
        # person.current_mood still depends on the type (reference:
        # dependency_manager.cpp RESTRICT semantics)
        c.sql("DROP TYPE mood")
    c.sql("DROP TABLE person")
    c.sql("DROP TYPE mood")
    with pytest.raises(Exception):
        c.sql("CREATE TABLE p2 (m mood)")
    # CASCADE drops dependent tables with the type
    c.sql("CREATE TYPE mood AS ENUM ('sad', 'ok')")
    c.sql("CREATE TABLE p3 (m mood)")
    c.sql("DROP TYPE mood CASCADE")
    with pytest.raises(Exception):
        c.sql("SELECT * FROM p3")


def test_enum_persists(tmp_path):
    import pytest
    from ddb_tpu_torch.testing.refsuite import Connection
    from ddb_tpu_torch.storage.dml import ConstraintException
    p = str(tmp_path / "e.dtb")
    c = Connection()
    c.sql("CREATE TYPE lvl AS ENUM ('lo', 'hi')")
    c.sql("CREATE TABLE t (x lvl)")
    c.sql("INSERT INTO t VALUES ('lo')")
    c.save(p)
    c2 = Connection()
    c2.load(p)
    with pytest.raises(ConstraintException):
        c2.sql("INSERT INTO t VALUES ('mid')")


def test_insert_expression_values():
    con = refsuite.connect()
    con.execute("CREATE TABLE ce (x INTEGER, y INTEGER)")
    con.execute("INSERT INTO ce VALUES (1 + 2, abs(-4)), "
                "(CAST('7' AS INTEGER), 8)")
    assert con.execute("SELECT * FROM ce ORDER BY x").fetchall() == \
        [(3, 4), (7, 8)]


def test_list_column_insert():
    con = refsuite.connect()
    con.execute("CREATE TABLE lt (l INTEGER[], s VARCHAR)")
    con.execute("INSERT INTO lt VALUES ([1,2,3], 'x'), ([4,5], 'y'), "
                "(NULL, 'z')")
    assert con.execute("SELECT l, s FROM lt ORDER BY s").fetchall() == \
        [([1, 2, 3], "x"), ([4, 5], "y"), (None, "z")]


def test_type_aliases_and_count_noargs():
    con = refsuite.connect()
    con.execute("CREATE TABLE ta (a INT32, b FLOAT64, "
                "t TIMESTAMP WITH TIME ZONE)")
    con.execute("INSERT INTO ta VALUES (1, 2.5, "
                "TIMESTAMP '2024-01-01 00:00:00')")
    assert con.execute("SELECT COUNT(), COUNT(*) FROM ta").fetchall() \
        == [(1, 1)]


def test_dml_row_count_results():
    con = refsuite.connect()
    con.execute("CREATE TABLE rc (x INTEGER)")
    assert con.execute("INSERT INTO rc VALUES (1), (2), (3)"
                       ).fetchall() == [(3,)]
    assert con.execute("UPDATE rc SET x = x + 1 WHERE x > 1"
                       ).fetchall() == [(2,)]
    assert con.execute("DELETE FROM rc WHERE x = 3").fetchall() == [(1,)]
    assert con.execute("DELETE FROM rc").fetchall() == [(2,)]


def test_struct_map_typed_columns():
    con = refsuite.connect()
    con.execute("CREATE TABLE st (s STRUCT(a INTEGER, b VARCHAR), "
                "m MAP(INTEGER, VARCHAR))")
    con.execute("INSERT INTO st VALUES ({'a': 1, 'b': 'x'}, "
                "MAP([1,2],['p','q']))")
    assert con.execute("SELECT s, m FROM st").fetchall() == \
        [({"a": 1, "b": "x"}, {1: "p", 2: "q"})]
    assert con.execute("SELECT s.a FROM st").fetchall() == [(1,)]

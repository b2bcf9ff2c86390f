# Generated from tests/test_statements.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite statements); do not edit.
"""PREPARE/EXECUTE/DEALLOCATE, ALTER TABLE, ATTACH/DETACH — statement-level
parity (reference: src/parser/statement/{prepare,execute,alter,attach}_
statement.cpp, src/execution/operator/schema/physical_alter.cpp,
src/main/attached_database.cpp)."""

import pytest

from ddb_tpu_torch.testing.refsuite import Connection
from ddb_tpu_torch.catalog import CatalogException


@pytest.fixture()
def con():
    c = Connection()
    c.sql("CREATE TABLE t (a INTEGER, b VARCHAR)")
    c.sql("INSERT INTO t VALUES (1,'x'),(2,'y'),(3,'z')")
    return c


def test_prepare_execute(con):
    con.sql("PREPARE q AS SELECT a FROM t WHERE a > $1 ORDER BY a")
    assert con.sql("EXECUTE q(1)").fetchall() == [(2,), (3,)]
    assert con.sql("EXECUTE q(2)").fetchall() == [(3,)]


def test_prepare_positional_qmark(con):
    con.sql("PREPARE q2 AS SELECT count(*) FROM t WHERE b = ?")
    assert con.sql("EXECUTE q2('x')").fetchall() == [(1,)]


def test_deallocate(con):
    con.sql("PREPARE q AS SELECT 1")
    con.sql("DEALLOCATE q")
    with pytest.raises(CatalogException):
        con.sql("EXECUTE q")


def test_alter_rename_column(con):
    con.sql("ALTER TABLE t RENAME COLUMN a TO a2")
    assert con.sql("SELECT a2 FROM t ORDER BY a2").fetchall() \
        == [(1,), (2,), (3,)]


def test_alter_add_drop_column(con):
    con.sql("ALTER TABLE t ADD COLUMN z DOUBLE")
    assert con.sql("SELECT z FROM t").fetchall() == [(None,)] * 3
    con.sql("ALTER TABLE t DROP COLUMN z")
    assert "z" not in con.sql("SELECT * FROM t").column_names


def test_alter_rename_table(con):
    con.sql("ALTER TABLE t RENAME TO t2")
    assert con.sql("SELECT count(*) FROM t2").fetchall() == [(3,)]
    with pytest.raises(CatalogException):
        con.sql("SELECT * FROM t")


def test_alter_if_exists_missing(con):
    con.sql("ALTER TABLE IF EXISTS nope RENAME TO x")   # no error


def test_attach_detach(tmp_path, con):
    path = str(tmp_path / "db.dtb")
    con.save(path)
    c2 = Connection()
    c2.sql(f"ATTACH '{path}' AS other")
    assert c2.sql("SELECT a FROM other.t ORDER BY a").fetchall() \
        == [(1,), (2,), (3,)]
    c2.sql("DETACH other")
    with pytest.raises(CatalogException):
        c2.sql("SELECT * FROM other.t")


def test_main_schema_prefix(con):
    assert con.sql("SELECT count(*) FROM main.t").fetchall() == [(3,)]

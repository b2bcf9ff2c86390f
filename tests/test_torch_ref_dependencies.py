# Generated from tests/test_dependencies.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite dependencies); do not edit.
"""Column DEFAULTs, sequences, and catalog dependency tracking
(reference: src/catalog/dependency_manager.cpp, test/sql/catalog/
dependencies, test/sql/catalog/sequence)."""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch
from ddb_tpu_torch.catalog import CatalogException


def test_default_literal_applied():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 42, "
                "s VARCHAR DEFAULT 'none')")
    con.execute("INSERT INTO t (a) VALUES (1)")
    con.execute("INSERT INTO t VALUES (2, 7, 'x')")
    assert con.execute("SELECT * FROM t ORDER BY a").fetchall() == \
        [(1, 42, "none"), (2, 7, "x")]


def test_default_keyword_in_values():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 5)")
    con.execute("INSERT INTO t VALUES (1, DEFAULT), (2, 9)")
    assert con.execute("SELECT * FROM t ORDER BY a").fetchall() == \
        [(1, 5), (2, 9)]
    # DEFAULT on a column without one inserts NULL
    con.execute("INSERT INTO t VALUES (DEFAULT, DEFAULT)")
    assert con.execute("SELECT b FROM t WHERE a IS NULL").fetchall() == \
        [(5,)]


def test_default_values_row():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER DEFAULT 3, b VARCHAR)")
    con.execute("INSERT INTO t DEFAULT VALUES")
    assert con.execute("SELECT * FROM t").fetchall() == [(3, None)]


def test_default_expression():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 2 + 3 * 4)")
    con.execute("INSERT INTO t (a) VALUES (1)")
    assert con.execute("SELECT b FROM t").fetchall() == [(14,)]


def test_sequence_default_per_row():
    con = refsuite.connect()
    con.execute("CREATE SEQUENCE s START 10")
    con.execute("CREATE TABLE t (id INTEGER DEFAULT nextval('s'), "
                "v VARCHAR)")
    con.execute("INSERT INTO t (v) VALUES ('a'), ('b'), ('c')")
    assert con.execute("SELECT id, v FROM t ORDER BY id").fetchall() == \
        [(10, "a"), (11, "b"), (12, "c")]


def test_create_default_unknown_sequence_errors():
    con = refsuite.connect()
    with pytest.raises(CatalogException):
        con.execute(
            "CREATE TABLE t (id INTEGER DEFAULT nextval('nope'))")


def test_drop_sequence_restrict_and_cascade():
    con = refsuite.connect()
    con.execute("CREATE SEQUENCE s")
    con.execute("CREATE TABLE t (id INTEGER DEFAULT nextval('s'))")
    with pytest.raises(CatalogException):
        con.execute("DROP SEQUENCE s")
    # still intact
    con.execute("INSERT INTO t DEFAULT VALUES")
    assert con.execute("SELECT id FROM t").fetchall() == [(1,)]
    con.execute("DROP SEQUENCE s CASCADE")
    with pytest.raises(CatalogException):
        con.execute("SELECT * FROM t")


def test_duckdb_dependencies_listing():
    con = refsuite.connect()
    con.execute("CREATE SEQUENCE s")
    con.execute("CREATE TYPE mood AS ENUM ('sad', 'ok')")
    con.execute("CREATE TABLE t (id INTEGER DEFAULT nextval('s'), "
                "m mood)")
    con.execute("CREATE INDEX ix ON t(id)")
    rows = set(con.execute(
        "SELECT objid_type, objid_name, refobjid_type, refobjid_name "
        "FROM duckdb_dependencies()").fetchall())
    assert ("table", "t", "sequence", "s") in rows
    assert ("table", "t", "type", "mood") in rows
    assert ("index", "ix", "table", "t") in rows


def test_duckdb_sequences_listing():
    con = refsuite.connect()
    con.execute("CREATE SEQUENCE s START 5 INCREMENT 2")
    con.execute("SELECT nextval('s')")
    rows = con.execute(
        "SELECT sequence_name, start_value, increment_by, last_value "
        "FROM duckdb_sequences()").fetchall()
    assert rows == [("s", 5, 2, 5)]


def test_sequence_persist_roundtrip(tmp_path):
    path = str(tmp_path / "db.dtb")
    con = refsuite.connect(path)
    con.execute("CREATE SEQUENCE s START 100")
    con.execute("CREATE TABLE t (id INTEGER DEFAULT nextval('s'), "
                "v INTEGER)")
    con.execute("INSERT INTO t (v) VALUES (1), (2)")
    con.checkpoint()
    con2 = refsuite.connect(path)
    con2.execute("INSERT INTO t (v) VALUES (3)")
    assert con2.execute("SELECT id, v FROM t ORDER BY id").fetchall() \
        == [(100, 1), (101, 2), (102, 3)]


def test_sequence_wal_replay(tmp_path):
    path = str(tmp_path / "db.dtb")
    con = refsuite.connect(path)
    con.execute("CREATE SEQUENCE s")
    con.execute("CREATE TABLE t (id INTEGER DEFAULT nextval('s'))")
    con.execute("INSERT INTO t DEFAULT VALUES")
    con.execute("INSERT INTO t DEFAULT VALUES")
    # crash without checkpoint
    con._wal.flush()
    con._wal = None
    con2 = refsuite.connect(path)
    con2.execute("INSERT INTO t DEFAULT VALUES")
    assert con2.execute("SELECT id FROM t ORDER BY id").fetchall() == \
        [(1,), (2,), (3,)]


def test_nextval_inside_transaction():
    con = refsuite.connect()
    con.execute("CREATE SEQUENCE s")
    con.execute("BEGIN")
    assert con.execute("SELECT nextval('s')").fetchall() == [(1,)]
    con.execute("ROLLBACK")
    # sequences are non-transactional: the value stays consumed
    assert con.execute("SELECT nextval('s')").fetchall() == [(2,)]


def test_schema_create_in_transaction_commit():
    con = refsuite.connect()
    con.execute("BEGIN")
    con.execute("CREATE SCHEMA myschema")
    con.execute("COMMIT")
    con.execute("CREATE TABLE myschema.t (a INTEGER)")
    con.execute("INSERT INTO myschema.t VALUES (1)")
    assert con.execute("SELECT * FROM myschema.t").fetchall() == [(1,)]


def test_default_survives_checkpoint(tmp_path):
    path = str(tmp_path / "db.dtb")
    con = refsuite.connect(path)
    con.execute("CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 9)")
    con.checkpoint()
    con2 = refsuite.connect(path)
    con2.execute("INSERT INTO t (a) VALUES (1)")
    assert con2.execute("SELECT * FROM t").fetchall() == [(1, 9)]


def test_drop_type_restrict_still_works():
    con = refsuite.connect()
    con.execute("CREATE TYPE mood AS ENUM ('sad', 'ok')")
    con.execute("CREATE TABLE t (m mood)")
    with pytest.raises(CatalogException):
        con.execute("DROP TYPE mood")
    con.execute("DROP TYPE mood CASCADE")
    with pytest.raises(CatalogException):
        con.execute("SELECT * FROM t")

# Generated from tests/test_foreign_key.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite foreign_key); do not edit.
"""FOREIGN KEY constraints (reference: VerifyForeignKey paths in
src/storage/data_table.cpp; test/sql/constraints/foreignkey/)."""
from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch
from ddb_tpu_torch.storage.dml import ConstraintException


def mk(con):
    con.execute("CREATE TABLE parent(id INTEGER PRIMARY KEY, "
                "name VARCHAR)")
    con.execute("INSERT INTO parent VALUES (1, 'a'), (2, 'b')")
    con.execute("CREATE TABLE child(cid INTEGER, pid INTEGER "
                "REFERENCES parent(id))")


def test_insert_valid_and_invalid():
    con = refsuite.connect()
    mk(con)
    con.execute("INSERT INTO child VALUES (10, 1), (11, 2), (12, NULL)")
    assert con.execute("SELECT count(*) FROM child").fetchall() == [(3,)]
    with pytest.raises(ConstraintException):
        con.execute("INSERT INTO child VALUES (13, 99)")
    # failed insert rolled back
    assert con.execute("SELECT count(*) FROM child").fetchall() == [(3,)]


def test_delete_restrict():
    con = refsuite.connect()
    mk(con)
    con.execute("INSERT INTO child VALUES (10, 1)")
    with pytest.raises(ConstraintException):
        con.execute("DELETE FROM parent WHERE id = 1")
    # unreferenced parent rows delete fine
    con.execute("DELETE FROM parent WHERE id = 2")
    assert con.execute("SELECT count(*) FROM parent").fetchall() \
        == [(1,)]
    # rollback left table intact
    assert con.execute("SELECT id FROM parent").fetchall() == [(1,)]
    # delete the child, then the parent row deletes
    con.execute("DELETE FROM child")
    con.execute("DELETE FROM parent WHERE id = 1")


def test_update_checks_both_sides():
    con = refsuite.connect()
    mk(con)
    con.execute("INSERT INTO child VALUES (10, 1)")
    with pytest.raises(ConstraintException):
        con.execute("UPDATE child SET pid = 42 WHERE cid = 10")
    with pytest.raises(ConstraintException):
        con.execute("UPDATE parent SET id = 5 WHERE id = 1")
    con.execute("UPDATE child SET pid = 2 WHERE cid = 10")
    con.execute("UPDATE parent SET id = 5 WHERE id = 1")


def test_table_level_fk_and_missing_pk():
    con = refsuite.connect()
    con.execute("CREATE TABLE p2(a INTEGER, b INTEGER, "
                "PRIMARY KEY (a, b))")
    con.execute("INSERT INTO p2 VALUES (1, 2)")
    con.execute("CREATE TABLE c2(x INTEGER, y INTEGER, "
                "FOREIGN KEY (x, y) REFERENCES p2(a, b))")
    con.execute("INSERT INTO c2 VALUES (1, 2)")
    with pytest.raises(ConstraintException):
        con.execute("INSERT INTO c2 VALUES (2, 1)")
    # referencing a non-keyed column errors at CREATE
    con.execute("CREATE TABLE p3(q INTEGER)")
    with pytest.raises(Exception):
        con.execute("CREATE TABLE c3(r INTEGER REFERENCES p3(q))")


def test_fk_defaults_to_parent_pk():
    con = refsuite.connect()
    con.execute("CREATE TABLE p(id INTEGER PRIMARY KEY)")
    con.execute("INSERT INTO p VALUES (7)")
    con.execute("CREATE TABLE c(pid INTEGER REFERENCES p)")
    con.execute("INSERT INTO c VALUES (7)")
    with pytest.raises(ConstraintException):
        con.execute("INSERT INTO c VALUES (8)")


def test_varchar_fk():
    con = refsuite.connect()
    con.execute("CREATE TABLE pv(k VARCHAR PRIMARY KEY)")
    con.execute("INSERT INTO pv VALUES ('x'), ('y')")
    con.execute("CREATE TABLE cv(k VARCHAR REFERENCES pv(k))")
    con.execute("INSERT INTO cv VALUES ('x')")
    with pytest.raises(ConstraintException):
        con.execute("INSERT INTO cv VALUES ('z')")
    with pytest.raises(ConstraintException):
        con.execute("DELETE FROM pv WHERE k = 'x'")
    con.execute("DELETE FROM pv WHERE k = 'y'")


def test_drop_parent_restricted():
    con = refsuite.connect()
    mk(con)
    with pytest.raises(Exception):
        con.execute("DROP TABLE parent")
    con.execute("DROP TABLE child")
    con.execute("DROP TABLE parent")


def test_drop_cascade():
    con = refsuite.connect()
    mk(con)
    con.execute("DROP TABLE parent CASCADE")
    assert not con.catalog.has_table("child")


def test_on_delete_restrict_accepted():
    con = refsuite.connect()
    con.execute("CREATE TABLE p(id INTEGER PRIMARY KEY)")
    con.execute("CREATE TABLE c(pid INTEGER REFERENCES p(id) "
                "ON DELETE RESTRICT ON UPDATE NO ACTION)")
    with pytest.raises(Exception):
        con.execute("CREATE TABLE c2(pid INTEGER REFERENCES p(id) "
                    "ON DELETE CASCADE)")


def test_fk_survives_wal_restart(tmp_path):
    db = str(tmp_path / "fk.dtb")
    con = refsuite.connect(db)
    mk(con)
    con.execute("INSERT INTO child VALUES (10, 1)")
    con.close()
    con2 = refsuite.connect(db)
    with pytest.raises(ConstraintException):
        con2.execute("INSERT INTO child VALUES (11, 42)")
    with pytest.raises(ConstraintException):
        con2.execute("DELETE FROM parent WHERE id = 1")

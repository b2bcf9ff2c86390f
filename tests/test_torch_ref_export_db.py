# Generated from tests/test_export_db.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite export_db); do not edit.
"""EXPORT DATABASE / IMPORT DATABASE round trips (reference:
src/execution/operator/persistent/physical_export.cpp)."""
from ddb_tpu_torch.testing import refsuite
import os

import pytest

import ddb_tpu_torch


def mkdb():
    con = refsuite.connect()
    con.execute("CREATE TYPE mood AS ENUM ('ok','sad')")
    con.execute("CREATE SEQUENCE sq START 5 INCREMENT 2")
    con.execute("CREATE TABLE p(id INTEGER PRIMARY KEY, "
                "name VARCHAR NOT NULL, sc DECIMAL(10,2))")
    con.execute("CREATE TABLE c(pid INTEGER REFERENCES p(id), "
                "m mood, t TIMESTAMPTZ)")
    con.execute("INSERT INTO p VALUES (1,'a',1.25), (2,'b',NULL)")
    con.execute("INSERT INTO c VALUES "
                "(1,'ok','2024-01-01 05:00:00+00'), (NULL,'sad',NULL)")
    con.execute("CREATE VIEW pv AS SELECT id FROM p WHERE id > 1")
    return con


@pytest.mark.parametrize("opts", [
    "(FORMAT csv, DELIMITER '|', HEADER false)",
    "(FORMAT csv)",
    "(FORMAT PARQUET)",
])
def test_export_import_roundtrip(tmp_path, opts):
    con = mkdb()
    d = str(tmp_path / "exp")
    con.execute(f"EXPORT DATABASE '{d}' {opts}")
    assert os.path.exists(os.path.join(d, "schema.sql"))
    assert os.path.exists(os.path.join(d, "load.sql"))
    con2 = refsuite.connect()
    con2.execute(f"IMPORT DATABASE '{d}'")
    assert con2.execute("SELECT * FROM p ORDER BY id").fetchall() \
        == con.execute("SELECT * FROM p ORDER BY id").fetchall()
    assert con2.execute("SELECT * FROM c ORDER BY pid").fetchall() \
        == con.execute("SELECT * FROM c ORDER BY pid").fetchall()
    assert con2.execute("SELECT * FROM pv").fetchall() == [(2,)]
    # constraints survive
    with pytest.raises(Exception):
        con2.execute("INSERT INTO c VALUES (99, 'ok', NULL)")
    with pytest.raises(Exception):
        con2.execute("INSERT INTO p VALUES (1, 'dup', NULL)")
    # sequence definition recreated (fresh counter at START)
    assert con2.execute("SELECT nextval('sq')").fetchall() == [(5,)]
    assert con2.execute("SELECT nextval('sq')").fetchall() == [(7,)]

# Generated from tests/test_index.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite index); do not edit.
"""Point-lookup index (ART analog): CREATE/DROP INDEX, index scans,
incremental maintenance, UNIQUE enforcement, persistence.

Reference: src/execution/index/art/art.cpp (PK/UNIQUE + index scans),
src/function/table/system/duckdb_indexes.cpp.
"""

from ddb_tpu_torch.testing import refsuite
import numpy as np
import pytest

import ddb_tpu_torch


@pytest.fixture()
def con():
    rng = np.random.default_rng(3)
    n = 20000
    c = refsuite.connect()
    c.register("big", {"id": np.arange(n),
                       "g": rng.integers(0, 50, n),
                       "v": rng.integers(0, 1000, n)})
    return c


def test_index_point_lookup_exact(con):
    before = con.execute("SELECT g, v FROM big WHERE id = 12345").fetchall()
    con.execute("CREATE INDEX idx_id ON big(id)")
    after = con.execute("SELECT g, v FROM big WHERE id = 12345").fetchall()
    assert before == after and len(after) == 1


def test_index_scan_path_used(con, monkeypatch):
    con.execute("CREATE INDEX idx_id ON big(id)")
    td = con.catalog.get_table("big")
    calls = []
    orig = type(td).device_batch_rows

    def spy(self, cols, rows, *, device):
        calls.append(len(rows))
        return orig(self, cols, rows, device=device)

    monkeypatch.setattr(type(td), "device_batch_rows", spy)
    rows = con.execute("SELECT v FROM big WHERE id = 77").fetchall()
    assert len(rows) == 1
    assert calls and calls[0] == 1   # index fed exactly one row


def test_index_range_scan(con):
    expect = con.execute(
        "SELECT count(*), sum(v) FROM big WHERE id >= 100 AND id < 200"
    ).fetchall()
    con.execute("CREATE INDEX idx_id ON big(id)")
    got = con.execute(
        "SELECT count(*), sum(v) FROM big WHERE id >= 100 AND id < 200"
    ).fetchall()
    assert got == expect == [(100, expect[0][1])]


def test_index_incremental_insert(con):
    con.execute("CREATE INDEX idx_id ON big(id)")
    con.execute("SELECT v FROM big WHERE id = 5").fetchall()  # build
    con.execute("INSERT INTO big VALUES (1000000, 1, 42)")
    got = con.execute("SELECT v FROM big WHERE id = 1000000").fetchall()
    assert got == [(42,)]


def test_index_after_delete_update(con):
    con.execute("CREATE INDEX idx_id ON big(id)")
    con.execute("SELECT v FROM big WHERE id = 10").fetchall()
    con.execute("DELETE FROM big WHERE id = 10")
    assert con.execute("SELECT v FROM big WHERE id = 10").fetchall() == []
    con.execute("UPDATE big SET v = 7 WHERE id = 11")
    assert con.execute("SELECT v FROM big WHERE id = 11").fetchall() \
        == [(7,)]


def test_unique_index_rejects_duplicates(con):
    from ddb_tpu_torch.storage.dml import ConstraintException
    con.execute("CREATE TABLE u (k INTEGER, s VARCHAR)")
    con.execute("INSERT INTO u VALUES (1, 'a'), (2, 'b')")
    con.execute("CREATE UNIQUE INDEX uk ON u(k)")
    with pytest.raises(ConstraintException):
        con.execute("INSERT INTO u VALUES (2, 'dup')")
    # rolled back
    assert con.execute("SELECT count(*) FROM u").fetchall() == [(2,)]
    con.execute("INSERT INTO u VALUES (3, 'c')")
    with pytest.raises(ConstraintException):
        con.execute("CREATE UNIQUE INDEX uk2 ON u(s)")  # no dups -> ok
        con.execute("INSERT INTO u VALUES (4, 'c')")


def test_multicol_index(con):
    con.execute("CREATE INDEX gidx ON big(g, v)")
    expect = con.execute(
        "SELECT count(*) FROM big WHERE g = 7 AND v = 500").fetchall()
    got = con.execute(
        "SELECT count(*) FROM big WHERE g = 7 AND v = 500").fetchall()
    assert got == expect


def test_duckdb_indexes_listing(con):
    con.execute("CREATE UNIQUE INDEX idx_id ON big(id)")
    rows = con.execute(
        "SELECT index_name, table_name, is_unique FROM duckdb_indexes()"
    ).fetchall()
    assert ("idx_id", "big", True) in rows


def test_drop_index(con):
    con.execute("CREATE INDEX idx_id ON big(id)")
    con.execute("DROP INDEX idx_id")
    rows = con.execute("SELECT index_name FROM duckdb_indexes()"
                       ).fetchall()
    assert ("idx_id",) not in rows
    with pytest.raises(Exception):
        con.execute("DROP INDEX idx_id")
    con.execute("DROP INDEX IF EXISTS idx_id")


def test_index_persists(tmp_path):
    path = str(tmp_path / "ix.dtb")
    c = refsuite.connect()
    c.execute("CREATE TABLE t (id INTEGER, v INTEGER)")
    c.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    c.execute("CREATE UNIQUE INDEX tid ON t(id)")
    c.save(path)
    c2 = refsuite.connect()
    c2.load(path)
    rows = c2.execute("SELECT index_name, is_unique FROM duckdb_indexes()"
                      ).fetchall()
    assert ("tid", True) in rows
    from ddb_tpu_torch.storage.dml import ConstraintException
    with pytest.raises(ConstraintException):
        c2.execute("INSERT INTO t VALUES (1, 99)")


def test_index_wal_replay(tmp_path):
    path = str(tmp_path / "wl.dtb")
    c = refsuite.connect()
    c.open_database(path)
    c.execute("CREATE TABLE t (id INTEGER)")
    c.execute("CREATE UNIQUE INDEX tid ON t(id)")
    c.execute("INSERT INTO t VALUES (5)")
    c2 = refsuite.connect()
    c2.open_database(path)
    from ddb_tpu_torch.storage.dml import ConstraintException
    with pytest.raises(ConstraintException):
        c2.execute("INSERT INTO t VALUES (5)")

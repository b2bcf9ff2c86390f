# Generated from tests/test_wal.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite wal); do not edit.
"""WAL durability tests (reference: src/storage/write_ahead_log.hpp,
wal_replay.cpp, test/sql/storage restart tests)."""

from ddb_tpu_torch.testing import refsuite
import os

import pytest

import ddb_tpu_torch


def open_db(tmp_path, name="db.dtb"):
    return refsuite.connect(str(tmp_path / name))


def reopen_without_checkpoint(con, tmp_path, name="db.dtb"):
    """Simulate a crash: drop the connection WITHOUT checkpointing."""
    con._wal.flush()
    con._wal = None     # skip close()/checkpoint-on-shutdown
    return refsuite.connect(str(tmp_path / name))


def test_insert_replay(tmp_path):
    con = open_db(tmp_path)
    con.execute("create table t (a integer, b varchar)")
    con.execute("insert into t values (1, 'x'), (2, NULL), (NULL, 'z')")
    con2 = reopen_without_checkpoint(con, tmp_path)
    assert con2.execute("select * from t order by a").fetchall() == [
        (1, "x"), (2, None), (None, "z")]


def test_delete_update_replay(tmp_path):
    con = open_db(tmp_path)
    con.execute("create table t (a integer, b double)")
    con.execute("insert into t values (1, 1.5), (2, 2.5), (3, 3.5)")
    con.execute("delete from t where a = 2")
    con.execute("update t set b = b * 2 where a = 3")
    con2 = reopen_without_checkpoint(con, tmp_path)
    assert con2.execute("select * from t order by a").fetchall() == [
        (1, 1.5), (3, 7.0)]


def test_ctas_view_drop_alter_replay(tmp_path):
    con = open_db(tmp_path)
    con.execute("create table src (a integer)")
    con.execute("insert into src values (1), (2), (3)")
    con.execute("create table t2 as select a * 10 as b from src")
    con.execute("create view v as select sum(b) as s from t2")
    con.execute("alter table t2 rename column b to c")
    con.execute("drop table src")
    con2 = reopen_without_checkpoint(con, tmp_path)
    assert con2.execute("select c from t2 order by c").fetchall() == [
        (10,), (20,), (30,)]
    assert not con2.catalog.has_table("src")


def test_checkpoint_truncates(tmp_path):
    con = open_db(tmp_path)
    con.execute("create table t (a integer)")
    con.execute("insert into t values (42)")
    con.execute("checkpoint")
    wal = str(tmp_path / "db.dtb.wal")
    assert os.path.getsize(wal) == 8        # just the magic
    con2 = reopen_without_checkpoint(con, tmp_path)
    assert con2.execute("select a from t").fetchall() == [(42,)]


def test_rollback_not_logged(tmp_path):
    con = open_db(tmp_path)
    con.execute("create table t (a integer)")
    con.execute("begin")
    con.execute("insert into t values (1)")
    con.execute("rollback")
    con.execute("begin")
    con.execute("insert into t values (2)")
    con.execute("commit")
    con2 = reopen_without_checkpoint(con, tmp_path)
    assert con2.execute("select a from t").fetchall() == [(2,)]


def test_torn_tail_ignored(tmp_path):
    con = open_db(tmp_path)
    con.execute("create table t (a integer)")
    con.execute("insert into t values (1)")
    con._wal.flush()
    wal = str(tmp_path / "db.dtb.wal")
    with open(wal, "ab") as f:              # simulate a torn write
        f.write(b"\x40\x00\x00\x00\x00\x00\x00\x00partial")
    con._wal = None
    con2 = refsuite.connect(str(tmp_path / "db.dtb"))
    assert con2.execute("select a from t").fetchall() == [(1,)]


def test_close_checkpoints(tmp_path):
    con = open_db(tmp_path)
    con.execute("create table t (a date, b decimal(12,2))")
    con.execute("insert into t values (date '2024-02-29', 10.25)")
    con.close()
    wal = str(tmp_path / "db.dtb.wal")
    assert os.path.getsize(wal) == 8
    con2 = refsuite.connect(str(tmp_path / "db.dtb"))
    import datetime
    import decimal
    assert con2.execute("select * from t").fetchall() == [
        (datetime.date(2024, 2, 29), decimal.Decimal("10.25"))]


def test_autocheckpoint(tmp_path):
    con = open_db(tmp_path)
    con.execute("set wal_autocheckpoint = 256")
    con.execute("create table t (a integer)")
    for i in range(20):
        con.execute(f"insert into t values ({i})")
    wal = str(tmp_path / "db.dtb.wal")
    assert os.path.getsize(wal) < 256       # was truncated along the way
    con2 = reopen_without_checkpoint(con, tmp_path)
    assert con2.execute("select count(*) from t").fetchall() == [(20,)]

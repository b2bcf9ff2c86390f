# Generated from tests/test_redo.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite redo); do not edit.
"""Redo-log transport + follower replication (the kafkaredo analog —
reference: extension/kafkaredo/kafkafs.cpp streams WAL writes to a redo
topic and the replica re-applies them)."""

from ddb_tpu_torch.testing import refsuite
import os

import pytest

import ddb_tpu_torch
from ddb_tpu_torch.redo import Follower, RedoReader, RedoWriter


@pytest.fixture()
def stream(tmp_path):
    return str(tmp_path / "redo.stream")


def test_redo_writer_reader_roundtrip(stream):
    w = RedoWriter(stream)
    w.append({"op": "x", "n": 1})
    w.append({"op": "y", "n": 2})
    w.flush()
    r = RedoReader(stream)
    assert [x["op"] for x in r.poll_records()] == ["x", "y"]
    assert list(r.poll_records()) == []       # nothing new
    w.append({"op": "z"})
    w.flush()
    assert [x["op"] for x in r.poll_records()] == ["z"]


def test_follower_replays_dml_and_ddl(stream):
    leader = refsuite.connect()
    leader.execute(f"SET redo_transport='{stream}'")
    leader.execute("create table t(a int, b varchar)")
    leader.execute("insert into t values (1, 'x'), (2, 'y')")
    leader.execute("update t set b = 'z' where a = 2")
    leader.execute("delete from t where a = 1")
    leader.execute("create view v as select a from t")

    f = Follower(stream, device=refsuite.device())
    assert f.poll() > 0
    assert f.con.execute("select * from t order by a").fetchall() \
        == [(2, "z")]
    assert f.con.execute("select * from v").fetchall() == [(2,)]

    # follower keeps tailing
    leader.execute("insert into t values (3, 'w')")
    assert f.poll() == 1
    assert f.con.execute("select count(*) from t").fetchall() == [(2,)]


def test_follower_transaction_atomicity(stream):
    leader = refsuite.connect()
    leader.execute(f"SET redo_transport='{stream}'")
    leader.execute("create table t(a int)")
    leader.execute("begin")
    leader.execute("insert into t values (1)")
    leader.execute("insert into t values (2)")
    leader.execute("rollback")
    leader.execute("begin")
    leader.execute("insert into t values (3)")
    leader.execute("commit")

    f = Follower(stream, device=refsuite.device())
    f.poll()
    # rolled-back rows never reach the stream
    assert f.con.execute("select * from t").fetchall() == [(3,)]


def test_follower_background_tailing(stream):
    leader = refsuite.connect()
    leader.execute(f"SET redo_transport='{stream}'")
    leader.execute("create table t(a int)")
    f = Follower(stream, device=refsuite.device()).start(interval=0.02)
    try:
        for i in range(5):
            leader.execute(f"insert into t values ({i})")
        assert f.wait_caught_up(stream, timeout=10)
        assert f.con.execute("select count(*) from t").fetchall() \
            == [(5,)]
    finally:
        f.stop()


def test_follower_tolerates_torn_tail(stream):
    leader = refsuite.connect()
    leader.execute(f"SET redo_transport='{stream}'")
    leader.execute("create table t(a int)")
    leader.execute("insert into t values (1)")
    # simulate a torn append
    with open(stream, "ab") as fh:
        fh.write(b"\x99\x00\x00\x00")
    f = Follower(stream, device=refsuite.device())
    f.poll()
    assert f.con.execute("select * from t").fetchall() == [(1,)]

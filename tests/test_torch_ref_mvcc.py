# Generated from tests/test_mvcc.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite mvcc); do not edit.
"""Concurrent-writer MVCC: multiple connections on one Database with
snapshot-isolated transactions (reference: DuckTransactionManager,
src/transaction/; test style: concurrentloop directives in
test/sql/parallelism/interquery/)."""

from ddb_tpu_torch.testing import refsuite
import threading

import pytest

import ddb_tpu_torch
from ddb_tpu_torch.api import TransactionException


def test_snapshot_isolation():
    con = refsuite.connect()
    con.execute("create table t(a int)")
    con.execute("insert into t values (1)")
    c2 = con.duplicate()
    con.execute("begin")
    con.execute("insert into t values (2)")
    assert con.execute("select count(*) from t").fetchall() == [(2,)]
    assert c2.execute("select count(*) from t").fetchall() == [(1,)]
    con.execute("commit")
    assert c2.execute("select count(*) from t").fetchall() == [(2,)]


def test_concurrent_appends_merge():
    con = refsuite.connect()
    con.execute("create table t(a int)")
    c2 = con.duplicate()
    con.execute("begin")
    c2.execute("begin")
    con.execute("insert into t values (10)")
    c2.execute("insert into t values (20)")
    con.execute("commit")
    c2.execute("commit")
    assert sorted(con.execute("select a from t").fetchall()) \
        == [(10,), (20,)]


def test_write_conflict_aborts():
    con = refsuite.connect()
    con.execute("create table u(k int primary key)")
    c2 = con.duplicate()
    con.execute("begin")
    c2.execute("begin")
    con.execute("insert into u values (5)")
    c2.execute("insert into u values (5)")
    con.execute("commit")
    with pytest.raises(TransactionException):
        c2.execute("commit")
    assert c2.execute("select k from u").fetchall() == [(5,)]
    # the aborted connection is usable again
    c2.execute("insert into u values (6)")
    assert sorted(c2.execute("select k from u").fetchall()) \
        == [(5,), (6,)]


def test_rollback_discards():
    con = refsuite.connect()
    con.execute("create table t(a int)")
    con.execute("begin")
    con.execute("insert into t values (1)")
    con.execute("rollback")
    assert con.execute("select count(*) from t").fetchall() == [(0,)]


def test_update_delete_replay():
    con = refsuite.connect()
    con.execute("create table t(a int, b int)")
    con.execute("insert into t values (1, 10), (2, 20), (3, 30)")
    c2 = con.duplicate()
    con.execute("begin")
    con.execute("update t set b = b + 1 where a = 1")
    con.execute("delete from t where a = 3")
    assert c2.execute("select count(*) from t").fetchall() == [(3,)]
    con.execute("commit")
    assert sorted(c2.execute("select a, b from t").fetchall()) \
        == [(1, 11), (2, 20)]


def test_concurrentloop_threaded_dml():
    """8 threads x 5 transactions of appends each; every committed row
    survives (the concurrentloop analog over DML)."""
    con = refsuite.connect()
    con.execute("create table t(tid int, i int)")
    errors = []

    def worker(tid):
        try:
            c = con.duplicate()
            for i in range(5):
                c.execute("begin")
                c.execute(f"insert into t values ({tid}, {i})")
                c.execute(f"insert into t values ({tid}, {i + 100})")
                c.execute("commit")
        except Exception as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:2]
    n, = con.execute("select count(*) from t").fetchone()
    assert n == 8 * 5 * 2
    per = con.execute("select tid, count(*) from t group by tid "
                      "order by tid").fetchall()
    assert per == [(k, 10) for k in range(8)]


def test_threaded_readers_during_writes():
    con = refsuite.connect()
    con.execute("create table t(a int)")
    con.execute("insert into t values (1), (2), (3)")
    stop = threading.Event()
    errors = []

    def reader():
        c = con.duplicate()
        while not stop.is_set():
            rows = c.execute("select count(*) from t").fetchall()
            if rows[0][0] < 3:
                errors.append(rows)

    rs = [threading.Thread(target=reader) for _ in range(4)]
    for r in rs:
        r.start()
    w = con.duplicate()
    for i in range(10):
        w.execute("begin")
        w.execute(f"insert into t values ({i + 10})")
        w.execute("commit")
    stop.set()
    for r in rs:
        r.join()
    assert not errors, errors[:2]
    assert con.execute("select count(*) from t").fetchone() == (13,)

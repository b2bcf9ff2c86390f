# Generated from tests/test_concurrency.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite concurrency); do not edit.
"""Inter-query concurrency (reference: sqllogictest `concurrentloop`,
test/sql/parallelism/interquery/) — concurrent reads on one connection
and DBAPI cursor surface."""

from ddb_tpu_torch.testing import refsuite
import threading

import pytest

import ddb_tpu_torch


def test_concurrent_reads():
    con = refsuite.connect()
    con.register("t", {"k": list(range(100)) * 10,
                       "v": list(range(1000))})
    errors = []
    results = []

    def worker(i):
        try:
            r = con.execute(
                f"SELECT count(*), sum(v) FROM t WHERE k >= {i % 7}"
            ).fetchall()
            results.append(r)
        except Exception as e:   # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(results) == 8


def test_cursor_dbapi():
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, s VARCHAR)")
    cur = con.cursor()
    cur.executemany("INSERT INTO t VALUES (?, ?)",
                    [[1, "x"], [2, "y"], [3, "z"]])
    cur.execute("SELECT * FROM t ORDER BY a")
    assert cur.description[0][0] == "a"
    assert cur.fetchone() == (1, "x")
    assert cur.fetchmany(2) == [(2, "y"), (3, "z")]
    assert cur.fetchone() is None
    cur.execute("SELECT count(*) FROM t")
    assert cur.fetchall() == [(3,)]

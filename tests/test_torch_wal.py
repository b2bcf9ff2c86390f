"""The write-ahead log and the redo follower through ddb_tpu.connect()
(JAX on the CPU) and ddb_tpu_torch.connect(device="cpu"): a database
file's mutations are logged (storage/wal.py), replayed after a crash,
truncated by CHECKPOINT and wal_autocheckpoint and checkpointed by
close(); a leader's redo stream (redo.py) is replayed by a Follower.  The
same steps run through both packages and every step's rows, or the class
name of the exception it raises, are compared.

Ported here: the cases of the reference's tests/test_wal.py and
tests/test_redo.py, test_fk_survives_wal_restart (test_foreign_key.py),
test_sequence_wal_replay (test_dependencies.py), test_macro_wal_replay
(test_macro.py) and test_index_wal_replay (test_index.py).  Also: a WAL
and a redo stream either package writes replay in the other."""

import os

import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.redo import Follower as RefFollower
from ddb_tpu_torch.redo import Follower, RedoReader, RedoWriter
from test_torch_dml import outcome, table_contents
from test_torch_persist import Pkg, compare, run
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401


def crash(con):
    """Drop a connection without its checkpoint on shutdown."""
    con._wal.flush()
    con._wal = None


def reopen(p, con, path):
    crash(con)
    return p.connect(path)


# ---- tests/test_wal.py -----------------------------------------------------

def insert_replay(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table t (a integer, b varchar)",
        "insert into t values (1, 'x'), (2, NULL), (NULL, 'z')")
    return run(reopen(p, con, path), "select * from t order by a")


def delete_update_replay(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table t (a integer, b double)",
        "insert into t values (1, 1.5), (2, 2.5), (3, 3.5)",
        "delete from t where a = 2", "update t set b = b * 2 where a = 3")
    return run(reopen(p, con, path), "select * from t order by a")


def ctas_view_drop_alter_replay(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table src (a integer)",
        "insert into src values (1), (2), (3)",
        "create table t2 as select a * 10 as b from src",
        "create view v as select sum(b) as s from t2",
        "alter table t2 rename column b to c", "drop table src")
    con2 = reopen(p, con, path)
    return run(con2, "select c from t2 order by c", "select * from v") \
        + [con2.catalog.has_table("src")]


def alter_type_using_replay(p):
    """An ALTER ... SET DATA TYPE ... USING evaluates its expression over
    the table again when it replays, outside execute()."""
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table t (a integer, s varchar)",
        "insert into t values (1, 'x'), (2, 'yy')",
        "alter table t alter column a set data type varchar "
        "using concat(s, '-', a)")
    return run(reopen(p, con, path), "select * from t order by s")


def checkpoint_truncates(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table t (a integer)", "insert into t values (42)",
        "checkpoint")
    size = os.path.getsize(path + ".wal")
    return [size] + run(reopen(p, con, path), "select a from t")


def rollback_not_logged(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table t (a integer)", "begin",
        "insert into t values (1)", "rollback", "begin",
        "insert into t values (2)", "commit")
    return run(reopen(p, con, path), "select a from t")


def torn_tail_ignored(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table t (a integer)", "insert into t values (1)")
    con._wal.flush()
    with open(path + ".wal", "ab") as f:
        f.write(b"\x40\x00\x00\x00\x00\x00\x00\x00partial")
    con._wal = None
    return run(p.connect(path), "select a from t")


def close_checkpoints(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "create table t (a date, b decimal(12,2))",
        "insert into t values (date '2024-02-29', 10.25)")
    con.close()
    return [os.path.getsize(path + ".wal")] \
        + run(p.connect(path), "select * from t")


def context_manager_checkpoints(p):
    path = p.path("db.dtb")
    with p.connect(path) as con:
        run(con, "create table t (a integer)", "insert into t values (7)")
    return [os.path.getsize(path + ".wal"), os.path.getsize(path) > 0] \
        + run(p.connect(path), "select * from t")


def no_checkpoint_on_shutdown(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "set checkpoint_on_shutdown = false",
        "create table t (a integer)", "insert into t values (3)")
    con.close()
    return [os.path.exists(path), os.path.getsize(path + ".wal") > 8] \
        + run(p.connect(path), "select * from t")


def autocheckpoint(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "set wal_autocheckpoint = 256", "create table t (a integer)")
    run(con, *[f"insert into t values ({i})" for i in range(20)])
    size = os.path.getsize(path + ".wal")
    return [size < 256] + run(reopen(p, con, path),
                              "select count(*) from t")


def commit_autocheckpoints_once(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "set wal_autocheckpoint = 64", "create table t (a integer)",
        "begin", *[f"insert into t values ({i})" for i in range(5)],
        "commit")
    return [os.path.getsize(path + ".wal")] \
        + run(reopen(p, con, path), "select sum(a), count(*) from t")


# ---- the cases that needed a database file ---------------------------------

def fk_survives_wal_restart(p):
    path = p.path("fk.dtb")
    con = p.connect(path)
    run(con, "CREATE TABLE parent(id INTEGER PRIMARY KEY, name VARCHAR)",
        "INSERT INTO parent VALUES (1, 'a'), (2, 'b')",
        "CREATE TABLE child(cid INTEGER, pid INTEGER REFERENCES parent(id))",
        "INSERT INTO child VALUES (10, 1)")
    con.close()
    return run(p.connect(path), "INSERT INTO child VALUES (11, 42)",
               "DELETE FROM parent WHERE id = 1",
               "SELECT * FROM child")


def sequence_wal_replay(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "CREATE SEQUENCE s",
        "CREATE TABLE t (id INTEGER DEFAULT nextval('s'))",
        "INSERT INTO t DEFAULT VALUES", "INSERT INTO t DEFAULT VALUES")
    return run(reopen(p, con, path), "INSERT INTO t DEFAULT VALUES",
               "SELECT id FROM t ORDER BY id")


def macro_wal_replay(p):
    path = p.path("m.dtb")
    c = p.connect(path)
    run(c, "CREATE MACRO m2(x) AS x - 1")
    return run(reopen(p, c, path), "SELECT m2(4)")


def index_wal_replay(p):
    path = p.path("wl.dtb")
    c = p.connect()
    c.open_database(path)
    run(c, "CREATE TABLE t (id INTEGER)", "CREATE UNIQUE INDEX tid ON t(id)",
        "INSERT INTO t VALUES (5)")
    c2 = p.connect()
    c2.open_database(path)
    return run(c2, "INSERT INTO t VALUES (5)",
               "SELECT index_name FROM duckdb_indexes()")


# ---- tests/test_redo.py ----------------------------------------------------

def follower_of(p, stream):
    if p.name == "ref":
        return RefFollower(stream)
    return Follower(stream, device="cpu")


def leader(p, stream):
    con = p.connect()
    con.execute(f"SET redo_transport='{stream}'")
    return con


def follower_replays_dml_and_ddl(p):
    stream = p.path("redo.stream")
    lead = leader(p, stream)
    run(lead, "create table t(a int, b varchar)",
        "insert into t values (1, 'x'), (2, 'y')",
        "update t set b = 'z' where a = 2", "delete from t where a = 1",
        "create view v as select a from t",
        "alter table t alter column a set data type varchar "
        "using concat(b, a)")
    f = follower_of(p, stream)
    out = [f.poll() > 0] + run(f.con, "select * from t order by a",
                               "select * from v")
    run(lead, "insert into t values ('3', 'w')")
    return out + [f.poll()] + run(f.con, "select count(*) from t")


def follower_transaction_atomicity(p):
    stream = p.path("redo.stream")
    lead = leader(p, stream)
    run(lead, "create table t(a int)", "begin", "insert into t values (1)",
        "insert into t values (2)", "rollback", "begin",
        "insert into t values (3)", "commit")
    f = follower_of(p, stream)
    f.poll()
    return run(f.con, "select * from t")


def follower_background_tailing(p):
    stream = p.path("redo.stream")
    lead = leader(p, stream)
    run(lead, "create table t(a int)")
    f = follower_of(p, stream).start(interval=0.02)
    try:
        run(lead, *[f"insert into t values ({i})" for i in range(5)])
        caught = f.wait_caught_up(stream, timeout=10)
    finally:
        f.stop()
    return [caught] + run(f.con, "select count(*) from t")


def follower_tolerates_torn_tail(p):
    stream = p.path("redo.stream")
    lead = leader(p, stream)
    run(lead, "create table t(a int)", "insert into t values (1)")
    with open(stream, "ab") as fh:
        fh.write(b"\x99\x00\x00\x00")
    f = follower_of(p, stream)
    f.poll()
    return run(f.con, "select * from t")


def follower_on_a_database_file(p):
    """A follower that opens a copy of the leader's checkpoint and then
    catches up on the stream (chip_smoke.py phase 18e)."""
    import shutil
    path, stream = p.path("lead.dtb"), p.path("redo.stream")
    lead = p.connect(path)
    run(lead, "create table t(a int, b varchar)",
        "insert into t values (1, 'x'), (2, 'y')", "checkpoint")
    shutil.copyfile(path, p.path("copy.dtb"))
    run(lead, f"SET redo_transport='{stream}'",
        "insert into t values (3, 'z')", "delete from t where a = 1")
    f = RefFollower(stream, p.path("copy.dtb")) if p.name == "ref" \
        else Follower(stream, p.path("copy.dtb"), device="cpu")
    n = [f.poll(), f.poll()]
    return n + run(f.con, "select * from t order by a")


CASES = [insert_replay, delete_update_replay, ctas_view_drop_alter_replay,
         alter_type_using_replay, checkpoint_truncates, rollback_not_logged,
         torn_tail_ignored, close_checkpoints, context_manager_checkpoints,
         no_checkpoint_on_shutdown, autocheckpoint,
         commit_autocheckpoints_once, fk_survives_wal_restart,
         sequence_wal_replay, macro_wal_replay, index_wal_replay,
         follower_replays_dml_and_ddl, follower_transaction_atomicity,
         follower_background_tailing, follower_tolerates_torn_tail,
         follower_on_a_database_file]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_matches_reference(case, tmp_path):
    compare(case, tmp_path)


def test_redo_writer_reader_roundtrip(tmp_path):
    stream = str(tmp_path / "redo.stream")
    w = RedoWriter(stream)
    w.append({"op": "x", "n": 1})
    w.append({"op": "y", "n": 2})
    w.flush()
    r = RedoReader(stream)
    assert [x["op"] for x in r.poll_records()] == ["x", "y"]
    assert list(r.poll_records()) == []
    w.append({"op": "z"})
    w.flush()
    assert [x["op"] for x in r.poll_records()] == ["z"]


_MUTATIONS = [
    "create type mood as enum ('sad', 'ok')",
    "create sequence sq start 5",
    "create table t (a integer primary key, s varchar, d decimal(12,2), "
    "m mood, k integer default nextval('sq'))",
    "insert into t (a, s, d, m) values (1, 'a', 1.25, 'ok'), "
    "(2, null, null, 'sad'), (3, 'c', -3.5, null)",
    "create unique index ts on t(s)",
    "update t set d = d * 2 where a <> 2",
    "delete from t where a = 3",
    "begin", "insert into t (a, s) values (4, 'd')", "commit",
    "create table u as select a, s from t where a < 3",
    "alter table u rename column s to name",
    "create view v as select a, d from t",
    "create macro twice(x) as 2 * x",
    "create schema s2", "create table s2.w (x integer)",
    "insert into s2.w values (9)",
]
_READS = ["select * from t order by a", "select * from u order by a",
          "select * from v order by a", "select twice(x) from s2.w",
          "insert into t (a, s) values (5, 'a')",
          "insert into t (a, s) values (6, 'f')",
          "select a, k from t order by a"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_wal_replays_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "w.dtb")
    src = ddb_tpu.connect(path) if writer == "ref" \
        else ddb_tpu_torch.connect("cpu", path)
    run(src, "create table base (x integer)", "insert into base values (1)",
        "checkpoint", *_MUTATIONS)
    crash(src)
    readers = []
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        d.mkdir()
        for ext in ("", ".wal"):
            with open(path + ext, "rb") as a, \
                    open(str(d / "w.dtb") + ext, "wb") as b:
                b.write(a.read())
        readers.append(ddb_tpu.connect(str(d / "w.dtb")) if pkg == "ref"
                       else ddb_tpu_torch.connect("cpu", str(d / "w.dtb")))
    ref, port = readers
    assert table_contents(ref) == table_contents(port)
    for step in _READS:
        assert outcome(port, step) == outcome(ref, step), step


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_redo_stream_replays_in_the_other_package(tmp_path, writer):
    stream = str(tmp_path / "redo.stream")
    src = ddb_tpu.connect() if writer == "ref" \
        else ddb_tpu_torch.connect("cpu")
    src.execute(f"SET redo_transport = 'file://{stream}'")
    run(src, *_MUTATIONS)
    ref, port = RefFollower(stream), Follower(stream, device="cpu")
    assert ref.poll() == port.poll() > 0
    assert table_contents(ref.con) == table_contents(port.con)
    for step in _READS:
        assert outcome(port.con, step) == outcome(ref.con, step), step
    src.execute("SET redo_transport = 'off'")
    assert src._redo is None

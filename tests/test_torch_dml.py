"""DDL, DML, transactions, constraints, defaults and sequences through
ddb_tpu.connect() (JAX on the CPU) and ddb_tpu_torch.connect(device=
"cpu"): the statement sequences of the reference's tests/test_dml.py,
tests/test_foreign_key.py and tests/test_dependencies.py, each step's
rows (or the class name of the exception it raises) compared, then every
table's contents.  Each sequence runs three ways: as it is, inside
BEGIN ... COMMIT, and inside BEGIN ... ROLLBACK.

The cases that need a database file, test_constraints_survive_save_load,
test_enum_persists (test_dml.py), test_fk_survives_wal_restart
(test_foreign_key.py), test_sequence_persist_roundtrip,
test_sequence_wal_replay and test_default_survives_checkpoint
(test_dependencies.py), are in tests/test_torch_persist.py and
tests/test_torch_wal.py; test_persistence_raises, which held the port to
raising there before persistence was ported, now compares save, load and
open_database with the reference.

Also here: TPC-H's refresh functions at SF 0.01 against the numpy
oracles, and the device caches dropped by every statement kind."""

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch.bench import tpch
from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

MODES = ("plain", "commit", "rollback")


def outcome(con, step):
    """What one step gives: ("rows", names, rows), ("none",) or
    ("raises", exception class name).  A step is SQL text or a callable
    of the connection, whose return value is the outcome."""
    try:
        if callable(step):
            return ("value", step(con))
        r = con.execute(step)
    except Exception as e:     # noqa: BLE001 - the class is compared
        return ("raises", type(e).__name__)
    if r is None:
        return ("none",)
    return ("rows", r.column_names, r.fetchall())


def table_contents(con):
    """{table: rows ordered by their repr} of every table in the catalog."""
    return {name: sorted(con.execute(f"SELECT * FROM {name}").fetchall(),
                         key=repr)
            for name in sorted(con.catalog.tables)}


def same_outcome(want, got, where):
    assert want[0] == got[0], (where, want, got)
    if want[0] == "rows":
        assert want[1] == got[1], (where, want[1], got[1])
        diff = first_difference(want[2], got[2])
        assert diff is None, (where, diff)
    else:
        assert want == got, (where, want, got)


def run_both(steps, mode="plain", setup=()):
    """Run `setup`, then `steps` (wrapped as `mode` says) through both
    packages, comparing every step and then every table's contents."""
    ref, port = ddb_tpu.connect(), ddb_tpu_torch.connect(device="cpu")
    wrapped = list(setup) + {
        "plain": list(steps),
        "commit": ["BEGIN"] + list(steps) + ["COMMIT"],
        "rollback": ["BEGIN"] + list(steps) + ["ROLLBACK"]}[mode]
    for i, step in enumerate(wrapped):
        same_outcome(outcome(ref, step), outcome(port, step),
                     f"step {i}: {step}")
    want, got = table_contents(ref), table_contents(port)
    assert list(want) == list(got)
    for name in want:
        assert first_difference(want[name], got[name]) is None, name
    return ref, port


# ---- tests/test_dml.py ------------------------------------------------------

DML = {
    "create_insert_select": [
        "CREATE TABLE t (a INTEGER, b VARCHAR, c DECIMAL(10,2))",
        "INSERT INTO t VALUES (1, 'x', 1.50), (2, 'y', 2.25)",
        "SELECT * FROM t ORDER BY a",
        "INSERT INTO t (a) VALUES (3)",
        "SELECT a, b FROM t WHERE b IS NULL"],
    "insert_select": [
        "CREATE TABLE src (a INTEGER, s VARCHAR)",
        "INSERT INTO src VALUES (1, 'p'), (2, 'q')",
        "CREATE TABLE dst (a INTEGER, s VARCHAR)",
        "INSERT INTO dst SELECT a + 10, s FROM src",
        "SELECT * FROM dst ORDER BY a"],
    "delete_update": [
        "CREATE TABLE t (a INTEGER, v INTEGER)",
        "INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)",
        "DELETE FROM t WHERE a = 2",
        "SELECT a FROM t ORDER BY a",
        "UPDATE t SET v = v + 5 WHERE a = 3",
        "SELECT v FROM t ORDER BY a"],
    "update_varchar": [
        "CREATE TABLE t (a INTEGER, s VARCHAR)",
        "INSERT INTO t VALUES (1, 'old'), (2, 'keep')",
        "UPDATE t SET s = 'new' WHERE a = 1",
        "SELECT s FROM t ORDER BY a"],
    "transaction_rollback": [
        "CREATE TABLE t (a INTEGER)",
        "INSERT INTO t VALUES (1)",
        "BEGIN",
        "INSERT INTO t VALUES (2)",
        "SELECT * FROM t",
        "ROLLBACK",
        "SELECT * FROM t"],
    "primary_key_rejects_duplicates": [
        "CREATE TABLE p (id INTEGER PRIMARY KEY, v VARCHAR)",
        "INSERT INTO p VALUES (1, 'a'), (2, 'b')",
        "INSERT INTO p VALUES (2, 'c')",
        "SELECT count(*) FROM p",
        "INSERT INTO p VALUES (NULL, 'd')",
        "UPDATE p SET id = 1 WHERE id = 2",
        "SELECT id FROM p ORDER BY id"],
    "unique_allows_nulls": [
        "CREATE TABLE u (a INTEGER, tag VARCHAR UNIQUE)",
        "INSERT INTO u VALUES (1, 'x'), (2, NULL), (3, NULL)",
        "INSERT INTO u VALUES (4, 'x')",
        "SELECT count(*) FROM u"],
    "composite_pk_and_introspection": [
        "CREATE TABLE cp (a INTEGER, b INTEGER, PRIMARY KEY (a, b))",
        "INSERT INTO cp VALUES (1, 1), (1, 2)",
        "INSERT INTO cp SELECT 1, 2",
        "SELECT constraint_type FROM duckdb_constraints() "
        "WHERE table_name = 'cp'"],
    "enum_type": [
        "CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')",
        "CREATE TABLE person (name VARCHAR, current_mood mood)",
        "INSERT INTO person VALUES ('a', 'happy'), ('b', NULL)",
        "SELECT name FROM person WHERE current_mood = 'happy'",
        "INSERT INTO person VALUES ('d', 'angry')",
        "SELECT count(*) FROM person",
        "DROP TYPE mood",
        "DROP TABLE person",
        "DROP TYPE mood",
        "CREATE TABLE p2 (m mood)",
        "CREATE TYPE mood AS ENUM ('sad', 'ok')",
        "CREATE TABLE p3 (m mood)",
        "DROP TYPE mood CASCADE",
        "SELECT * FROM p3"],
    "insert_expression_values": [
        "CREATE TABLE ce (x INTEGER, y INTEGER)",
        "INSERT INTO ce VALUES (1 + 2, abs(-4)), (CAST('7' AS INTEGER), 8)",
        "SELECT * FROM ce ORDER BY x"],
    "list_column_insert": [
        "CREATE TABLE lt (l INTEGER[], s VARCHAR)",
        "INSERT INTO lt VALUES ([1,2,3], 'x'), ([4,5], 'y'), (NULL, 'z')",
        "SELECT l, s FROM lt ORDER BY s"],
    "type_aliases_and_count_noargs": [
        "CREATE TABLE ta (a INT32, b FLOAT64, t TIMESTAMP WITH TIME ZONE)",
        "INSERT INTO ta VALUES (1, 2.5, TIMESTAMP '2024-01-01 00:00:00')",
        "SELECT COUNT(), COUNT(*) FROM ta"],
    "dml_row_count_results": [
        "CREATE TABLE rc (x INTEGER)",
        "INSERT INTO rc VALUES (1), (2), (3)",
        "UPDATE rc SET x = x + 1 WHERE x > 1",
        "DELETE FROM rc WHERE x = 3",
        "DELETE FROM rc"],
    "struct_map_typed_columns": [
        "CREATE TABLE st (s STRUCT(a INTEGER, b VARCHAR), "
        "m MAP(INTEGER, VARCHAR))",
        "INSERT INTO st VALUES ({'a': 1, 'b': 'x'}, MAP([1,2],['p','q']))",
        "SELECT s, m FROM st",
        "SELECT s.a FROM st"],
}

# ---- tests/test_foreign_key.py ----------------------------------------------

_MK = ["CREATE TABLE parent(id INTEGER PRIMARY KEY, name VARCHAR)",
       "INSERT INTO parent VALUES (1, 'a'), (2, 'b')",
       "CREATE TABLE child(cid INTEGER, pid INTEGER REFERENCES parent(id))"]

FOREIGN_KEY = {
    "insert_valid_and_invalid": _MK + [
        "INSERT INTO child VALUES (10, 1), (11, 2), (12, NULL)",
        "SELECT count(*) FROM child",
        "INSERT INTO child VALUES (13, 99)",
        "SELECT count(*) FROM child"],
    "delete_restrict": _MK + [
        "INSERT INTO child VALUES (10, 1)",
        "DELETE FROM parent WHERE id = 1",
        "DELETE FROM parent WHERE id = 2",
        "SELECT count(*) FROM parent",
        "SELECT id FROM parent",
        "DELETE FROM child",
        "DELETE FROM parent WHERE id = 1"],
    "update_checks_both_sides": _MK + [
        "INSERT INTO child VALUES (10, 1)",
        "UPDATE child SET pid = 42 WHERE cid = 10",
        "UPDATE parent SET id = 5 WHERE id = 1",
        "UPDATE child SET pid = 2 WHERE cid = 10",
        "UPDATE parent SET id = 5 WHERE id = 1"],
    "table_level_fk_and_missing_pk": [
        "CREATE TABLE p2(a INTEGER, b INTEGER, PRIMARY KEY (a, b))",
        "INSERT INTO p2 VALUES (1, 2)",
        "CREATE TABLE c2(x INTEGER, y INTEGER, "
        "FOREIGN KEY (x, y) REFERENCES p2(a, b))",
        "INSERT INTO c2 VALUES (1, 2)",
        "INSERT INTO c2 VALUES (2, 1)",
        "CREATE TABLE p3(q INTEGER)",
        "CREATE TABLE c3(r INTEGER REFERENCES p3(q))"],
    "fk_defaults_to_parent_pk": [
        "CREATE TABLE p(id INTEGER PRIMARY KEY)",
        "INSERT INTO p VALUES (7)",
        "CREATE TABLE c(pid INTEGER REFERENCES p)",
        "INSERT INTO c VALUES (7)",
        "INSERT INTO c VALUES (8)"],
    "varchar_fk": [
        "CREATE TABLE pv(k VARCHAR PRIMARY KEY)",
        "INSERT INTO pv VALUES ('x'), ('y')",
        "CREATE TABLE cv(k VARCHAR REFERENCES pv(k))",
        "INSERT INTO cv VALUES ('x')",
        "INSERT INTO cv VALUES ('z')",
        "DELETE FROM pv WHERE k = 'x'",
        "DELETE FROM pv WHERE k = 'y'"],
    "drop_parent_restricted": _MK + [
        "DROP TABLE parent", "DROP TABLE child", "DROP TABLE parent"],
    "drop_cascade": _MK + [
        "DROP TABLE parent CASCADE",
        lambda con: con.catalog.has_table("child")],
    "on_delete_restrict_accepted": [
        "CREATE TABLE p(id INTEGER PRIMARY KEY)",
        "CREATE TABLE c(pid INTEGER REFERENCES p(id) "
        "ON DELETE RESTRICT ON UPDATE NO ACTION)",
        "CREATE TABLE c2(pid INTEGER REFERENCES p(id) ON DELETE CASCADE)"],
}

# ---- tests/test_dependencies.py ---------------------------------------------

DEPENDENCIES = {
    "default_literal_applied": [
        "CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 42, "
        "s VARCHAR DEFAULT 'none')",
        "INSERT INTO t (a) VALUES (1)",
        "INSERT INTO t VALUES (2, 7, 'x')",
        "SELECT * FROM t ORDER BY a"],
    "default_keyword_in_values": [
        "CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 5)",
        "INSERT INTO t VALUES (1, DEFAULT), (2, 9)",
        "SELECT * FROM t ORDER BY a",
        "INSERT INTO t VALUES (DEFAULT, DEFAULT)",
        "SELECT b FROM t WHERE a IS NULL"],
    "default_values_row": [
        "CREATE TABLE t (a INTEGER DEFAULT 3, b VARCHAR)",
        "INSERT INTO t DEFAULT VALUES",
        "SELECT * FROM t"],
    "default_expression": [
        "CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 2 + 3 * 4)",
        "INSERT INTO t (a) VALUES (1)",
        "SELECT b FROM t"],
    "sequence_default_per_row": [
        "CREATE SEQUENCE s START 10",
        "CREATE TABLE t (id INTEGER DEFAULT nextval('s'), v VARCHAR)",
        "INSERT INTO t (v) VALUES ('a'), ('b'), ('c')",
        "SELECT id, v FROM t ORDER BY id"],
    "create_default_unknown_sequence_errors": [
        "CREATE TABLE t (id INTEGER DEFAULT nextval('nope'))"],
    "drop_sequence_restrict_and_cascade": [
        "CREATE SEQUENCE s",
        "CREATE TABLE t (id INTEGER DEFAULT nextval('s'))",
        "DROP SEQUENCE s",
        "INSERT INTO t DEFAULT VALUES",
        "SELECT id FROM t",
        "DROP SEQUENCE s CASCADE",
        "SELECT * FROM t"],
    "duckdb_dependencies_listing": [
        "CREATE SEQUENCE s",
        "CREATE TYPE mood AS ENUM ('sad', 'ok')",
        "CREATE TABLE t (id INTEGER DEFAULT nextval('s'), m mood)",
        "CREATE INDEX ix ON t(id)",
        "SELECT objid_type, objid_name, refobjid_type, refobjid_name "
        "FROM duckdb_dependencies() ORDER BY ALL"],
    "duckdb_sequences_listing": [
        "CREATE SEQUENCE s START 5 INCREMENT 2",
        "SELECT nextval('s')",
        "SELECT sequence_name, start_value, increment_by, last_value "
        "FROM duckdb_sequences()"],
    "nextval_inside_transaction": [
        "CREATE SEQUENCE s",
        "BEGIN",
        "SELECT nextval('s')",
        "ROLLBACK",
        "SELECT nextval('s')"],
    "schema_create_in_transaction_commit": [
        "BEGIN",
        "CREATE SCHEMA myschema",
        "COMMIT",
        "CREATE TABLE myschema.t (a INTEGER)",
        "INSERT INTO myschema.t VALUES (1)",
        "SELECT * FROM myschema.t"],
    "drop_type_restrict_still_works": [
        "CREATE TYPE mood AS ENUM ('sad', 'ok')",
        "CREATE TABLE t (m mood)",
        "DROP TYPE mood",
        "DROP TYPE mood CASCADE",
        "SELECT * FROM t"],
}

# ---- IN lists: a sorted search for integer lists of the column's type,
# the loop of comparisons for the rest (NULLs in the list, other types)

_KEYS = ", ".join(str(k) for k in range(0, 600, 3))
IN_LISTS = {
    "in_lists": [
        "CREATE TABLE n (k INTEGER, b BIGINT, d DATE, s VARCHAR, f DOUBLE)",
        "INSERT INTO n VALUES (1, 10, DATE '2020-01-01', 'a', 1.5), "
        "(2, NULL, DATE '2020-01-02', 'b', 2.0), (NULL, 30, NULL, NULL, "
        "NULL), (3, -4, DATE '1969-12-31', 'c', -0.0), "
        "(2147483647, 9007199254740993, DATE '2020-01-01', 'a', 3.0)",
        "SELECT k FROM n WHERE k IN (1, 3, 2147483647) ORDER BY k",
        "SELECT k, k NOT IN (1, 3) FROM n ORDER BY k",
        "SELECT k IN (1, NULL), k NOT IN (2, NULL) FROM n ORDER BY k",
        "SELECT k FROM n WHERE k IN (1.5, 2) ORDER BY k",
        "SELECT b FROM n WHERE b IN (-4, 9007199254740993, 10) ORDER BY b",
        "SELECT k FROM n WHERE k IN (4294967296, 1) ORDER BY k",
        "SELECT s FROM n WHERE d IN (DATE '2020-01-01', DATE '1969-12-31') "
        "ORDER BY s",
        "SELECT k FROM n WHERE s IN ('a', 'zz', 'c') ORDER BY k",
        "SELECT k FROM n WHERE f IN (0.0, 3) ORDER BY k",
        f"SELECT count(*) FROM n WHERE k IN ({_KEYS})",
        f"DELETE FROM n WHERE k IN ({_KEYS})",
        "SELECT k FROM n ORDER BY k"],
}

CASES = {**{"dml/" + k: v for k, v in DML.items()},
         **IN_LISTS,
         **{"fk/" + k: v for k, v in FOREIGN_KEY.items()},
         **{"deps/" + k: v for k, v in DEPENDENCIES.items()}}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_statement_sequence_matches_reference(name, mode):
    run_both(CASES[name], mode)


# ---- the Python API of tests/test_dml.py: CDC, snapshots, HLC ---------------

def _cdc_events(con):
    events = []
    con.on_change(events.append)
    for sql in ("CREATE TABLE t (a INTEGER, s VARCHAR)",
                "INSERT INTO t VALUES (1, 'x'), (2, 'y')",
                "UPDATE t SET s = 'z' WHERE a = 1",
                "DELETE FROM t WHERE a = 2",
                "BEGIN", "INSERT INTO t VALUES (3, 'w')"):
        con.execute(sql)
    before_commit = len(events)
    con.execute("COMMIT")
    stamps = [e.hlc for e in events]
    assert stamps == sorted(stamps) and len(set(stamps[:3])) == 3
    return before_commit, [(e.table, e.op, [tuple(r) for r in e.rows],
                            e.old_rows) for e in events]


def test_change_data_capture_matches_reference():
    run_both([_cdc_events])
    n, events = _cdc_events(ddb_tpu_torch.connect(device="cpu"))
    assert n == 3 and [e[1] for e in events] == ["insert", "update",
                                                 "delete", "insert"]
    assert events[1][2:] == ([(1, "z")], [(1, "x")])


def test_snapshots_and_clock_match_reference():
    def steps(con):
        con.execute("CREATE TABLE t (a INTEGER)")
        con.execute("INSERT INTO t VALUES (1), (2)")
        sid = con.create_snapshot()
        con.execute("DELETE FROM t")
        kept = con.snapshots.get(sid)["t"].num_rows
        con.remove_snapshot(sid)
        t1 = con.get_hlc_timestamp()
        con.set_hlc_timestamp(t1 + 10_000_000)
        return (con.execute("SELECT count(*) FROM t").fetchall(), kept,
                con.get_hlc_timestamp() > t1 + 10_000_000)

    run_both([steps])
    assert steps(ddb_tpu_torch.connect(device="cpu")) == ([(0,)], 2, True)


def test_persistence_raises(tmp_path):
    """save, load, open_database and connect(device, path), which raised
    before persistence was ported, give the reference's rows."""
    def steps(con, pkg):
        path = str(tmp_path / f"{pkg}.dtb")
        con.execute("CREATE TABLE t (a INTEGER, s VARCHAR)")
        con.execute("INSERT INTO t VALUES (1, 'x'), (2, NULL)")
        con.save(path)
        fresh = con.duplicate()
        fresh.catalog = type(con.catalog)()
        fresh.load(path)
        opened = con.duplicate()
        opened.catalog = type(con.catalog)()
        opened.open_database(path)
        opened.execute("INSERT INTO t VALUES (3, 'z')")
        opened._wal = None           # a crash: no checkpoint
        again = ddb_tpu.connect(path) if pkg == "ref" \
            else ddb_tpu_torch.connect("cpu", path)
        return [c.execute("SELECT * FROM t ORDER BY a").fetchall()
                for c in (fresh, opened, again)]

    want = steps(ddb_tpu.connect(), "ref")
    assert want[2] == [(1, "x"), (2, None), (3, "z")]
    assert steps(ddb_tpu_torch.connect(device="cpu"), "port") == want


# ---- two connections on one Database ------------------------------------------

def test_two_connections_share_one_database():
    a = ddb_tpu_torch.connect(device="cpu")
    b = a.duplicate()
    a.execute("CREATE TABLE t (k INTEGER, v INTEGER)")
    a.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    assert b.execute("SELECT sum(v) FROM t").fetchall() == [(30,)]
    b.execute("BEGIN")
    b.execute("UPDATE t SET v = v + 1")
    # a does not see b's open transaction
    assert a.execute("SELECT sum(v) FROM t").fetchall() == [(30,)]
    a.execute("INSERT INTO t VALUES (3, 30)")
    b.execute("COMMIT")
    # b's update replays onto the table that a grew
    assert a.execute("SELECT k, v FROM t ORDER BY k").fetchall() == \
        [(1, 11), (2, 21), (3, 30)]


# ---- the device caches after each statement kind ------------------------------

def _cached(con, name):
    return con.catalog.get_table(name)._device_batches


@pytest.mark.parametrize("shared", [False, True])
def test_every_statement_kind_drops_the_cached_batch(shared):
    """Each mutation is followed by a SELECT on the CPU device, with one
    connection or with a second one on the same Database reading."""
    con = ddb_tpu_torch.connect(device="cpu")
    reader = con.duplicate() if shared else con
    con.execute("CREATE TABLE t (k INTEGER, s VARCHAR, v BIGINT)")
    con.execute("CREATE INDEX t_k ON t(k)")
    q = "SELECT k, s, v FROM t ORDER BY k"
    want = []
    for sql, want in (
            ("INSERT INTO t VALUES (1, 'a', 10), (2, 'b', 20)",
             [(1, "a", 10), (2, "b", 20)]),
            ("INSERT INTO t SELECT k + 2, s || 'x', v + 1 FROM t",
             [(1, "a", 10), (2, "b", 20), (3, "ax", 11), (4, "bx", 21)]),
            ("UPDATE t SET s = 'new', v = v * 2 WHERE k = 3",
             [(1, "a", 10), (2, "b", 20), (3, "new", 22), (4, "bx", 21)]),
            ("DELETE FROM t WHERE k IN (1, 4)",
             [(2, "b", 20), (3, "new", 22)]),
            ("BEGIN; INSERT INTO t VALUES (9, 'z', 0); COMMIT",
             [(2, "b", 20), (3, "new", 22), (9, "z", 0)]),
            ("BEGIN; DELETE FROM t; ROLLBACK",
             [(2, "b", 20), (3, "new", 22), (9, "z", 0)]),
            ("ALTER TABLE t ALTER COLUMN v SET DATA TYPE INTEGER USING v + 1",
             [(2, "b", 21), (3, "new", 23), (9, "z", 1)])):
        assert reader.execute(q).fetchall() != want or sql.startswith(
            "BEGIN; DELETE")
        assert _cached(reader, "t"), sql
        con.execute(sql)
        assert reader.execute(q).fetchall() == want, sql
        assert reader.execute("SELECT s FROM t WHERE k = 3").fetchall() \
            == [(r[1],) for r in want if r[0] == 3], sql
    con.execute("ALTER TABLE t DROP COLUMN s")
    assert reader.execute("SELECT * FROM t ORDER BY k").fetchall() == \
        [(2, 21), (3, 23), (9, 1)]
    con.execute("DROP TABLE t")
    with pytest.raises(Exception, match="does not exist"):
        reader.execute(q)


def test_commit_leaves_no_plan_on_an_old_table():
    con = ddb_tpu_torch.connect(device="cpu")
    con.execute("CREATE TABLE t (k INTEGER)")
    con.execute("INSERT INTO t VALUES (1)")
    con.execute("SELECT count(*) FROM t").fetchall()
    old = con.catalog.get_table("t")
    con.execute("BEGIN; INSERT INTO t VALUES (2); COMMIT")
    assert con.catalog.get_table("t") is not old
    assert con._plan_cache == {}


# ---- TPC-H's refresh functions at SF 0.01 ------------------------------------

SF = 0.01


def _ref_tables(con, d):
    """synth_join_tables' columns as reference tables with TPC-H's
    types."""
    from ddb_tpu import types as RT
    from ddb_tpu.storage.strings import StringDictionary
    from ddb_tpu.storage.table import TableColumn, TableData
    dicts = {"c_mktsegment": tpch.MKTSEGMENTS,
             "o_orderpriority": tpch.ORDERPRIORITIES}
    for table, cols in d.items():
        tcs = []
        for name, data in cols.items():
            if name in dicts:
                tcs.append(TableColumn(name, RT.VARCHAR, data,
                                       strdict=StringDictionary(
                                           np.array(dicts[name]))))
            else:
                dt = RT.DECIMAL(15, 2) if name in (
                    "l_extendedprice", "l_discount") else (
                    RT.DATE if name.endswith("date") else RT.INTEGER)
                tcs.append(TableColumn(name, dt, data))
        con.catalog.add_table(TableData(table, tcs), or_replace=True)


def refresh(con, rf, chunk):
    """RF1 in one transaction (orders through an Appender, lines by
    INSERT ... SELECT), RF2 in chunks of literal IN lists, then the
    ACID transactions and one that rolls back.  Returns the rows of the
    point SELECTs and the counts after the ROLLBACK."""
    import datetime
    epoch = datetime.date(1970, 1, 1)
    o = rf["orders"]
    con.execute("BEGIN")
    with con.appender("orders") as app:
        for k, c, day, p, s in zip(*(o[n].tolist() for n in o)):
            app.append_row(k, c, epoch + datetime.timedelta(days=day),
                           tpch.ORDERPRIORITIES[p], s)
    con.execute("INSERT INTO lineitem SELECT * FROM rf1_lineitem")
    con.execute("COMMIT")
    keys = rf["delete_keys"].tolist()
    for lo in range(0, len(keys), chunk):
        inlist = ", ".join(map(str, keys[lo:lo + chunk]))
        for t, col in (("lineitem", "l_orderkey"), ("orders", "o_orderkey")):
            con.execute(f"DELETE FROM {t} WHERE {col} IN ({inlist})")
    seen = []
    for k, delta in rf["acid"]:
        con.execute("BEGIN")
        seen.append(con.execute(
            f"SELECT l_extendedprice, l_discount FROM lineitem "
            f"WHERE l_orderkey = {k} ORDER BY ALL").fetchall())
        con.execute(f"UPDATE lineitem SET l_extendedprice = "
                    f"l_extendedprice + {delta / 100:.2f} "
                    f"WHERE l_orderkey = {k}")
        con.execute("COMMIT")
    count = "SELECT (SELECT count(*) FROM orders), count(*), " \
        "sum(l_extendedprice) FROM lineitem"
    before = con.execute(count).fetchall()
    con.execute("BEGIN")
    con.execute(f"UPDATE lineitem SET l_extendedprice = 0 "
                f"WHERE l_orderkey = {rf['acid'][0][0]}")
    con.execute("DELETE FROM orders")
    con.execute("ROLLBACK")
    assert con.execute(count).fetchall() == before
    return seen, before


def test_refresh_functions_match_the_oracles():
    d = tpch.synth_join_tables(int(SF * tpch.SF10_CUSTOMERS / 10),
                               int(SF * tpch.SF10_ORDERS / 10), seed=3)
    rf = tpch.synth_refresh(d, SF, seed=5)
    assert len(rf["orders"]["o_orderkey"]) == 15 == len(rf["delete_keys"])
    new, old = set(rf["orders"]["o_orderkey"]), set(d["orders"]["o_orderkey"])
    assert not new & old and all((k - 1) % 32 >= 8 for k in new)
    ref = ddb_tpu.connect()
    _ref_tables(ref, {**d, "rf1_lineitem": rf["lineitem"]})
    port = ddb_tpu_torch.connect(device="cpu")
    tpch.register_synth_tables(port, {**d, "rf1_lineitem": rf["lineitem"]})
    ref.execute("CREATE INDEX lineitem_ok ON lineitem(l_orderkey)")
    port.execute("CREATE INDEX lineitem_ok ON lineitem(l_orderkey)")
    got = refresh(port, rf, chunk=4)
    assert got == refresh(ref, rf, chunk=4)
    after = tpch.apply_refresh_numpy(d, rf, rf["delete_keys"], rf["acid"])
    n_orders, n_lines, _ = got[1][0]
    assert (n_orders, n_lines) == (len(after["orders"]["o_orderkey"]),
                                   len(after["lineitem"]["l_orderkey"]))
    for q, oracle in ((3, tpch.q3_oracle), (4, tpch.q4_oracle)):
        rows = port.execute(tpch.TPCH_QUERIES[q]).fetchall()
        assert first_difference(
            ref.execute(tpch.TPCH_QUERIES[q]).fetchall(), rows) is None
        want = oracle(after)
        if q == 4:
            assert rows == want
        else:
            assert [(k, int(r * 10_000)) for k, r, _, _ in rows] == \
                [(k, r) for k, r, _, _ in want[:10]]

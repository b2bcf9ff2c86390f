"""PREPARE/EXECUTE/DEALLOCATE, ALTER, macros, PIVOT/UNPIVOT and the
session statements (SET, SET VARIABLE, PRAGMA, EXPLAIN, DESCRIBE,
SUMMARIZE, the statement verifier), the Cursor and the Appender, through
ddb_tpu.connect() and ddb_tpu_torch.connect(device="cpu") with the
harness of test_torch_dml.py: the sequences of the reference's
tests/test_statements.py, tests/test_macro.py and tests/test_pivot.py,
each run as it is, inside BEGIN ... COMMIT and inside BEGIN ... ROLLBACK.

test_attach_detach (test_statements.py), test_macro_persistence and
test_macro_wal_replay (test_macro.py) need a database file: they are in
tests/test_torch_persist.py and tests/test_torch_wal.py.

Also here: ORDER BY over a wide (two-limb) sum, where the port sorts by
the whole value and the reference by the low word, and the statements
that raise because their module is not ported."""

import decimal
import os

import pytest

import ddb_tpu
import ddb_tpu_torch
from test_torch_dml import MODES, run_both
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

_T = ["CREATE TABLE t (a INTEGER, b VARCHAR)",
      "INSERT INTO t VALUES (1,'x'),(2,'y'),(3,'z')"]

STATEMENTS = {
    "prepare_execute": [
        "PREPARE q AS SELECT a FROM t WHERE a > $1 ORDER BY a",
        "EXECUTE q(1)", "EXECUTE q(2)"],
    "prepare_positional_qmark": [
        "PREPARE q2 AS SELECT count(*) FROM t WHERE b = ?",
        "EXECUTE q2('x')",
        "SELECT name FROM duckdb_prepared_statements()"],
    "deallocate": ["PREPARE q AS SELECT 1", "DEALLOCATE q", "EXECUTE q"],
    "alter_rename_column": [
        "ALTER TABLE t RENAME COLUMN a TO a2",
        "SELECT a2 FROM t ORDER BY a2"],
    "alter_add_drop_column": [
        "ALTER TABLE t ADD COLUMN z DOUBLE", "SELECT z FROM t",
        "ALTER TABLE t DROP COLUMN z", "SELECT * FROM t"],
    "alter_rename_table": [
        "ALTER TABLE t RENAME TO t2", "SELECT count(*) FROM t2",
        "SELECT * FROM t"],
    "alter_if_exists_missing": ["ALTER TABLE IF EXISTS nope RENAME TO x"],
    "alter_types_defaults_not_null": [
        "ALTER TABLE t ALTER COLUMN a SET DATA TYPE VARCHAR",
        "SELECT a || '!' FROM t ORDER BY 1",
        "ALTER TABLE t ALTER COLUMN a SET DATA TYPE BIGINT USING a::BIGINT * 10",
        "SELECT sum(a) FROM t",
        "ALTER TABLE t ALTER COLUMN b SET DEFAULT 'd'",
        "INSERT INTO t (a) VALUES (7)", "SELECT * FROM t ORDER BY a",
        "ALTER TABLE t ALTER COLUMN b DROP DEFAULT",
        "ALTER TABLE t ALTER COLUMN a SET NOT NULL",
        "INSERT INTO t VALUES (NULL, 'n')",
        "ALTER TABLE t ALTER COLUMN a DROP NOT NULL",
        "INSERT INTO t VALUES (NULL, 'n')",
        "SELECT count(*) FROM t"],
    "main_schema_prefix": ["SELECT count(*) FROM main.t"],
    "views_and_schemas": [
        "CREATE VIEW v AS SELECT a * 2 AS d FROM t",
        "SELECT * FROM v ORDER BY d", "CREATE VIEW v AS SELECT 1",
        "CREATE OR REPLACE VIEW v AS SELECT b FROM t WHERE a = 2",
        "SELECT * FROM v", "DROP VIEW v", "SELECT * FROM v",
        "CREATE SCHEMA s1", "CREATE TABLE s1.u AS SELECT a FROM t",
        "DROP SCHEMA s1", "DROP SCHEMA s1 CASCADE",
        "SELECT * FROM s1.u", "DROP SCHEMA IF EXISTS s1"],
    "create_table_as_and_drop": [
        "CREATE TABLE c AS SELECT b, a + 1 AS a1 FROM t WHERE a < 3",
        "SELECT * FROM c ORDER BY a1", "CREATE TABLE c AS SELECT 1",
        "CREATE OR REPLACE TABLE c AS SELECT 5 AS five",
        "SELECT * FROM c", "DROP TABLE c", "DROP TABLE c",
        "DROP TABLE IF EXISTS c"],
}

MACROS = {
    "scalar_macro": [
        "CREATE MACRO add_one(x) AS x + 1", "SELECT add_one(41)",
        lambda con: con.register("m", {"a": [1, 2, 3]}) and None,
        "SELECT add_one(a) FROM m ORDER BY a"],
    "macro_default_params": [
        "CREATE MACRO weighted(v, w := 2) AS v * w",
        "SELECT weighted(10), weighted(10, 3)"],
    "macro_nested_and_replace": [
        "CREATE MACRO add_one(x) AS x + 1",
        "CREATE MACRO twice(x) AS add_one(add_one(x))",
        "SELECT twice(5)",
        "CREATE OR REPLACE MACRO add_one(x) AS x + 100",
        "SELECT twice(5)"],
    "table_macro": [
        "CREATE MACRO firstn(n) AS TABLE SELECT range AS r FROM range(n)",
        "SELECT * FROM firstn(3)"],
    "drop_macro": [
        "CREATE MACRO m(x) AS x", "DROP MACRO m", "SELECT m(1)",
        "DROP MACRO m", "DROP MACRO IF EXISTS m"],
    "macro_listed": [
        "CREATE MACRO mx(x) AS x",
        "SELECT function_name, function_type FROM duckdb_functions() "
        "WHERE function_type IN ('macro', 'table_macro')"],
    "table_function_expression_args": ["SELECT count(*) FROM range(1 + 2)"],
}

_CITIES = [
    "CREATE TABLE cities (country VARCHAR, nm VARCHAR, yr INTEGER, "
    "population INTEGER)",
    "INSERT INTO cities VALUES ('NL','Ams',2000,1005),('NL','Ams',2010,1065),"
    "('US','Sea',2000,564),('US','Sea',2010,608),"
    "('US','NY',2000,8015),('US','NY',2010,8175)"]

PIVOT = {
    "pivot_discovered_values": [
        "PIVOT cities ON yr USING sum(population)"],
    "pivot_in_list_group_by": [
        "PIVOT cities ON yr IN (2000, 2010) USING sum(population) "
        "GROUP BY country"],
    "pivot_multiple_aggs": [
        "PIVOT cities ON yr IN (2000) USING sum(population) AS s, "
        "count(*) AS c GROUP BY country"],
    "unpivot": ["UNPIVOT cities ON yr, population INTO NAME k VALUE v"],
    "union_across_dictionaries": [
        "CREATE TABLE a1 (s VARCHAR)", "INSERT INTO a1 VALUES ('x'),('y')",
        "CREATE TABLE a2 (s VARCHAR)", "INSERT INTO a2 VALUES ('y'),('z')",
        "SELECT s FROM a1 UNION SELECT s FROM a2 ORDER BY s",
        "SELECT s FROM a1 EXCEPT SELECT s FROM a2",
        "SELECT s FROM a1 INTERSECT SELECT s FROM a2"],
}


def _cursor_and_appender(con):
    cur = con.cursor()
    cur.execute("SELECT a, b FROM t ORDER BY a")
    out = [cur.description, cur.fetchone(), cur.fetchmany(5),
           cur.fetchall(), cur.rowcount]
    cur.executemany("INSERT INTO t VALUES (?, ?)", [(10, "p"), (11, None)])
    with con.appender("t") as app:
        app.append_row(20, "q")
        app.append(21).append("r").end_row()
    with pytest.raises(ValueError):
        con.appender("t").append_row(1)
    out.append(con.execute("SELECT * FROM t ORDER BY a").fetchall())
    return out


SESSION = {
    "set_and_current_setting": [
        "SET timezone = 'America/New_York'",
        "SELECT current_setting('timezone')",
        "SELECT TIMESTAMPTZ '2024-07-01 12:00:00+00'::VARCHAR",
        "SET no_such_setting = 1"],
    "set_variable": [
        "SET VARIABLE x = 40 + 2", "SELECT getvariable('x')",
        "SET VARIABLE s = 'txt'", "SELECT getvariable('s') || '!'"],
    "pragmas": [
        "PRAGMA table_info('t')", "PRAGMA show_tables",
        "PRAGMA database_size", "PRAGMA collations",
        "PRAGMA threads=4", "PRAGMA enable_object_cache",
        "PRAGMA no_such_pragma"],
    "explain_describe_summarize": [
        "EXPLAIN SELECT b, count(*) FROM t WHERE a > 1 GROUP BY b",
        "DESCRIBE t", "DESCRIBE SELECT a + 1 AS a1, b FROM t",
        "SUMMARIZE t", "SUMMARIZE SELECT a * 2 AS d FROM t"],
    "verification": [
        "PRAGMA enable_verification",
        "SELECT b, sum(a) FROM t WHERE a >= 2 GROUP BY b ORDER BY b",
        "SELECT a FROM t ORDER BY a DESC LIMIT 2",
        "PRAGMA disable_verification", "SELECT count(*) FROM t"],
    "cursor_and_appender": [_cursor_and_appender],
    # raised before the distributed executor was ported: every SELECT is
    # verified over eight shards (the reference: eight virtual devices)
    "verify_parallelism": [
        "PRAGMA verify_parallelism",
        "SELECT count(*), sum(a), max(b) FROM t",
        "PRAGMA disable_verify_parallelism", "SELECT count(*) FROM t"],
    # raised before out-of-core execution was ported: t streams in tiles
    # of two rows, and every SELECT is verified out of core
    "out_of_core": [
        "SET external_threshold_rows = 2", "SET tile_rows = 2",
        "SELECT b, sum(a), count(*) FROM t GROUP BY b ORDER BY b",
        "PRAGMA verify_external",
        "SELECT a, b FROM t ORDER BY a DESC",
        "SELECT count(*), max(b) FROM t WHERE a > 1",
        "PRAGMA disable_verify_external",
        "SELECT current_setting('external_threshold_rows')"],
}

CASES = {**{"statements/" + k: (_T, v) for k, v in STATEMENTS.items()},
         **{"macro/" + k: ((), v) for k, v in MACROS.items()},
         **{"pivot/" + k: (_CITIES, v) for k, v in PIVOT.items()},
         **{"session/" + k: (_T, v) for k, v in SESSION.items()}}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CASES))
def test_statement_sequence_matches_reference(name, mode):
    setup, steps = CASES[name]
    run_both(steps, mode, setup)


# ---- fault 3.13: ORDER BY a wide sum ------------------------------------------

BIG = decimal.Decimal("9000000000000000.99")   # raw 9.0e17 at scale 2


def test_order_by_a_wide_sum_sorts_by_the_whole_value():
    """Sums of 20, 1, 11 and 5 times BIG: three of them carry past 2^63.
    The port orders them by value; the reference orders a wide column by
    its low word alone (a named deviation), so only the rows as a set
    are held equal to its."""
    sizes = {0: 20, 1: 1, 2: 11, 3: 5}
    rows = ",".join(f"({g},{BIG})" for g, k in sizes.items()
                    for _ in range(k))
    sql = "SELECT g, sum(x) AS s FROM w GROUP BY g ORDER BY s"
    got = {}
    for pkg, con in (("ref", ddb_tpu.connect()),
                     ("port", ddb_tpu_torch.connect(device="cpu"))):
        con.execute("CREATE TABLE w (g INTEGER, x DECIMAL(18,2))")
        con.execute(f"INSERT INTO w VALUES {rows}")
        got[pkg] = con.execute(sql).fetchall()
        got[pkg + "_desc"] = con.execute(sql + " DESC").fetchall()
    want = sorted(((g, BIG * k) for g, k in sizes.items()),
                  key=lambda r: r[1])
    assert max(s for _, s in want) * 100 > 2 ** 63
    assert got["port"] == want
    assert got["port_desc"] == want[::-1]
    assert sorted(got["ref"]) == sorted(want)


# ---- EXPORT and IMPORT, which raised before the readers were ported ---------

@pytest.mark.parametrize("opts", ["", "(FORMAT csv, DELIMITER '|')"])
def test_export_then_import_matches_reference(tmp_path, opts):
    got = {}
    for pkg in ("ref", "port"):
        con = ddb_tpu.connect() if pkg == "ref" \
            else ddb_tpu_torch.connect(device="cpu")
        con.execute("CREATE TABLE t (a INTEGER, s VARCHAR, d DECIMAL(6,2))")
        con.execute("INSERT INTO t VALUES (1, 'x', 1.5), (2, NULL, -0.25)")
        con.execute(f"EXPORT DATABASE '{tmp_path / pkg}' {opts}")
        new = ddb_tpu.connect() if pkg == "ref" \
            else ddb_tpu_torch.connect(device="cpu")
        new.execute(f"IMPORT DATABASE '{tmp_path / pkg}'")
        got[pkg] = (new.execute("SELECT * FROM t ORDER BY a").fetchall(),
                    (tmp_path / pkg / "t.csv").read_bytes())
    assert got["port"] == got["ref"]


def _untimed(outcome_):
    """An outcome with the times and counts of a profile tree taken out."""
    import re
    if outcome_[0] != "rows":
        return outcome_
    return ("rows", outcome_[1],
            [tuple(re.sub(r"\([0-9.]+ ms, -?[0-9]+ rows\)", "()", v)
                   if isinstance(v, str) else v for v in r)
             for r in outcome_[2]])


# statements that raised NotImplementedError before persistence and the
# client surface were ported, each followed by a statement that reads
# what it changed; the reference's profile trees read -1 rows for every
# operator (ROADMAP fault 3.16), so EXPLAIN ANALYZE compares the tree
# without its counts
@pytest.mark.parametrize("sql", [
    "PRAGMA enable_profiling",
    "SET enable_progress_bar = true",
    "SET redo_transport = '{stream}'",
    "DETACH x",
    "DROP SECRET s",
    "EXPLAIN ANALYZE SELECT a, count(*) FROM t GROUP BY a",
])
def test_client_statements_that_raised_before_match_reference(
        tmp_path, sql):
    from test_torch_dml import outcome, same_outcome
    outs = {}
    for pkg, con in (("ref", ddb_tpu.connect()),
                     ("port", ddb_tpu_torch.connect(device="cpu"))):
        stream = str(tmp_path / f"{pkg}.redo")
        for step in _T:
            con.execute(step)
        got = _untimed(outcome(con, sql.format(stream=stream)))
        after = outcome(con, "INSERT INTO t VALUES (4, 'w')")
        outs[pkg] = (got, after,
                     outcome(con, "SELECT a, b FROM t ORDER BY a"),
                     hasattr(con.execute("SELECT count(*) FROM t"),
                             "profile"),
                     os.path.getsize(stream) if os.path.exists(stream)
                     else None)
    for i, (want, got) in enumerate(zip(outs["ref"], outs["port"])):
        if isinstance(want, tuple):
            same_outcome(want, got, f"{sql}: part {i}")
        else:
            assert want == got, (sql, i, want, got)

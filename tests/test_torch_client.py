"""The client surface through ddb_tpu.connect() (JAX on the CPU) and
ddb_tpu_torch.connect(device="cpu"): the relation API (relation.py),
streamed results (Connection.stream), EXPLAIN ANALYZE and the profiler,
the progress bar, logging, secrets, the fatal-error latch,
sql_auto_complete, the shell (python -m ddb_tpu_torch) and the
sqllogictest runner (testing/sqllogic.py).

Ported here: the cases of the reference's tests/test_relation.py and
tests/test_streaming.py, and test_explain_analyze,
test_profiling_setting, test_logging, test_secret_manager,
test_progress_bar_callback, test_valid_checker_invalidates_connection and
test_sql_auto_complete of tests/test_system.py.  The reference's profile
trees read -1 rows for every operator (ROADMAP fault 3.16); the port's
hold each operator's live count, which is checked here."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from test_torch_dml import outcome, same_outcome
from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both():
    return ddb_tpu.connect(), ddb_tpu_torch.connect(device="cpu")


def same(want, got):
    assert first_difference(want, got) is None, first_difference(want, got)


# ---- tests/test_relation.py -------------------------------------------------

def _base(con):
    con.execute("CREATE TABLE t(g VARCHAR, v INTEGER)")
    con.execute("INSERT INTO t VALUES ('a',1),('b',2),('a',3),('c',4)")
    con.execute("CREATE TABLE u(g VARCHAR, w INTEGER)")
    con.execute("INSERT INTO u VALUES ('a', 10), ('b', 20)")
    return con


RELATIONS = {
    "table_filter_aggregate": lambda c: c.table("t").filter("v > 1")
    .aggregate("g, sum(v)", "g").order("g").fetchall(),
    "project_distinct": lambda c: c.table("t").project("g").distinct()
    .order("g").fetchall(),
    "order_limit": lambda c: c.table("t").order("v").limit(2).fetchall(),
    "limit_offset": lambda c: c.table("t").order("v desc").limit(1, offset=1)
    .fetchall(),
    "join_using": lambda c: sorted(c.table("t").join(c.table("u"), "g")
                                   .order("v").fetchall()),
    "join_left": lambda c: sorted(c.table("t").join(c.table("u"), "g",
                                                    how="left").fetchall(),
                                  key=repr),
    "join_on": lambda c: sorted(c.table("t").set_alias("a").join(
        c.table("u").set_alias("b"), "a.g = b.g and w > 10").fetchall()),
    "cross": lambda c: len(c.table("t").cross(c.table("u")).fetchall()),
    "union_all": lambda c: c.table("t").filter("v <= 2").union(
        c.table("t").filter("v >= 2")).count().fetchall(),
    "union": lambda c: c.table("t").filter("v <= 2").union(
        c.table("t").filter("v >= 2"), all_=False).count().fetchall(),
    "intersect": lambda c: sorted(c.table("t").filter("v <= 2").intersect(
        c.table("t").filter("v >= 2")).fetchall()),
    "except": lambda c: sorted(c.table("t").filter("v <= 2").except_(
        c.table("t").filter("v >= 2")).fetchall()),
    "columns_types": lambda c: (c.table("t").columns, c.table("t").types,
                                "SELECT" in c.table("t").sql_query()),
    "create_insert_view": lambda c: (
        c.table("t").filter("v > 2").create("big"),
        c.execute("SELECT count(*) FROM big").fetchall(),
        c.table("t").filter("v = 1").insert_into("big"),
        c.execute("SELECT count(*) FROM big").fetchall(),
        c.table("t").aggregate("max(v)").create_view("mv").fetchall(),
        c.view("mv").fetchall()),
    "values": lambda c: (c.values([(1, "x"), (2, "y")], columns=["n", "s"])
                         .order("n").fetchall(),
                         c.values([(1, "x")], columns=["n", "s"]).columns),
    "sql_relation": lambda c: (c.sql("SELECT 41 + 1 AS answer").fetchall(),
                               c.sql("SELECT 41 + 1 AS answer").columns,
                               c.from_query("SELECT v FROM t WHERE v > 3")
                               .fetchall()),
    "sql_executes_other_statements": lambda c: (
        c.sql("CREATE TABLE z (a INTEGER)"),
        c.sql("INSERT INTO z VALUES (5)").fetchall(),
        c.query("SELECT * FROM z").fetchall()),
    "shorthands": lambda c: [c.table("t").sum("v").fetchall(),
                             c.table("t").min("v").fetchall(),
                             c.table("t").max("v").fetchall(),
                             c.table("t").count().fetchall(),
                             c.table("t").mean("v").fetchall(),
                             dict(c.table("t").value_counts("g").fetchall()),
                             sorted(c.table("t").unique("g").fetchall())],
    "fetchone_describe": lambda c: (
        c.table("t").order("v").fetchone(),
        outcome(c, lambda c2: c2.table("t").describe().fetchall())),
    "table_function": lambda c: c.table_function("range", 3).fetchall(),
    "chain_deep": lambda c: (c.table("t").filter("v >= 1")
                             .project("g", "v * 10 AS v10")
                             .filter("v10 < 40")
                             .aggregate("g, count(*) AS n", "g")
                             .order("n DESC, g").limit(2).fetchall()),
    "unknown_table_raises": lambda c: outcome(c, lambda c2: c2.table("nope")),
    "unknown_column_raises": lambda c: outcome(
        c, lambda c2: c2.sql("SELECT nope FROM t")),
}


@pytest.mark.parametrize("name", list(RELATIONS))
def test_relation_matches_reference(name):
    ref, port = both()
    want = RELATIONS[name](_base(ref))
    got = RELATIONS[name](_base(port))
    assert got == want


def test_relation_is_lazy():
    for con in both():
        _base(con)
        rel = con.table("t").filter("v > 1")
        con.execute("INSERT INTO t VALUES ('d', 100)")
        assert ("d", 100) in rel.fetchall()


def test_df_and_map():
    pd = pytest.importorskip("pandas")
    pa = pytest.importorskip("pyarrow")
    out = []
    for con in both():
        _base(con)
        df = con.table("t").order("v").df()
        con.register("arrow_t", pa.table({"x": [1, None, 3],
                                          "s": ["a", "b", None]}))
        out.append((list(df.columns), df["v"].tolist(),
                    con.from_df(pd.DataFrame({"x": [5, 6]}))
                    .sum("x").fetchall(),
                    con.table("t").map(lambda d: d.assign(v=d["v"] * 2))
                    .sum("v").fetchall(),
                    con.execute("SELECT * FROM arrow_t ORDER BY x")
                    .fetchall()))
    assert out[1] == out[0]
    assert out[0][1] == [1, 2, 3, 4] and out[0][3] == [(20,)]


def test_arrow_matches_reference():
    pytest.importorskip("pyarrow")
    tables = []
    for con in both():
        con.execute("CREATE TABLE a (i INTEGER, s VARCHAR, d DECIMAL(10,2), "
                    "dt DATE, f DOUBLE)")
        con.execute("INSERT INTO a VALUES (1, 'x', 1.25, DATE '2024-01-02', "
                    "0.5), (NULL, NULL, NULL, NULL, NULL)")
        tables.append(con.execute("SELECT * FROM a ORDER BY i").arrow()
                      .to_pylist())
    assert tables[1] == tables[0]


# ---- tests/test_streaming.py ------------------------------------------------

STREAMS = {
    "filter_projection": ("select a, b*2 from big where b = 3", None),
    "limit_offset_early_exit": ("select a from big limit 3 offset 2", None),
    "limit_across_tiles": ("select a from big where a % 5 = 0 "
                           "limit 20000 offset 7", None),
    "aggregate_materialises": ("select b, sum(a) from big group by b "
                               "order by b", None),
    "order_materialises": ("select a from big where a < 50 order by a desc",
                           None),
    "strings_and_nulls": ("select s, n from big where a < 70000 and n is "
                          "null", None),
}


def _big(con, n=200_000):
    a = np.arange(n)
    con.register("big", {"a": a, "b": a % 7,
                         "s": [f"s{i % 13}" for i in range(n)],
                         "n": [None if i % 3 == 0 else i for i in range(n)]})
    return con


@pytest.fixture(scope="module")
def big_pair():
    return tuple(_big(c) for c in both())


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_matches_reference(big_pair, name):
    ref, port = big_pair
    sql = STREAMS[name][0]
    s = port.stream(sql)
    head = s.fetchmany(5)
    rows = head + s.fetchall()
    want = ref.stream(sql).fetchall()
    same(want, rows)
    same(port.execute(sql).fetchall(), rows)


def test_stream_limit_stops_the_scan(big_pair):
    _, port = big_pair
    s = port.stream("select a from big limit 3 offset 2")
    assert s.fetchall() == [(2,), (3,), (4,)]
    assert s.tiles_scanned == 1
    s = port.stream("select a from big where a >= 131072 limit 4")
    assert s.fetchall() == [(131072,), (131073,), (131074,), (131075,)]
    assert s.tiles_scanned == 3


def test_stream_does_not_build_the_device_table():
    con = ddb_tpu_torch.connect(device="cpu")
    n = 130_000
    con.register("big", {"a": np.arange(n)})
    td = con.catalog.get_table("big")
    s = con.stream("select a+1 from big where a % 2 = 0")
    assert len(s.fetchall()) == n // 2
    assert s.tiles_scanned == 2
    assert td._device_batches == {}


def test_stream_fetchone_iter_and_refusal():
    outs = []
    for con in both():
        con.register("t", {"a": [1, 2, 3]})
        s = con.stream("select a from t")
        outs.append((s.fetchone(), list(s), s.column_names,
                     outcome(con, lambda c: c.stream("create table x (a "
                                                     "integer)"))))
    assert outs[1] == outs[0]


# ---- tests/test_system.py ---------------------------------------------------

@pytest.fixture()
def cons():
    out = both()
    for c in out:
        c.register("t", {"a": [1, 2, 3, 4], "s": ["x", "y", "x", "z"]})
    return out


def _tree(rows):
    """A profile tree's lines without times and counts."""
    return [re.sub(r"\([0-9.]+ ms, -?[0-9]+ rows\)", "()", r[0])
            for r in rows]


@pytest.mark.parametrize("sql", [
    "SELECT s, sum(a) FROM t GROUP BY s",
    "SELECT a FROM t WHERE a > 1 ORDER BY a DESC LIMIT 2",
    "SELECT t.s, count(*) FROM t JOIN t AS u ON t.a = u.a GROUP BY 1",
])
def test_explain_analyze(cons, sql):
    ref, port = cons
    want = ref.execute("EXPLAIN ANALYZE " + sql).fetchall()
    got = port.execute("EXPLAIN ANALYZE " + sql).fetchall()
    assert _tree(got) == _tree(want)
    text = "\n".join(r[0] for r in got)
    assert "ms" in text and "-1 rows" not in text


def test_profile_cardinalities_are_live_counts(cons):
    """Each operator's recorded rows equal its subtree's live count run
    unprofiled; the self times sum to no more than the wall time."""
    import time
    from ddb_tpu_torch.batch import bind_device
    from ddb_tpu_torch.plan import physical
    from ddb_tpu_torch.profiler import QueryProfiler
    from ddb_tpu_torch.sql import parser
    _, port = cons
    sql = "SELECT s, count(*) FROM t WHERE a > 1 GROUP BY s ORDER BY s"
    with bind_device("cpu"):
        plan = port._optimize(port._binder().bind_select(
            parser.parse(sql)[0]))
    prof = QueryProfiler()
    t0 = time.perf_counter()
    physical.execute(plan, ctx=physical.ExecContext("cpu", profiler=prof))
    wall = time.perf_counter() - t0

    def walk(node):
        yield node
        for c in node.children():
            yield from walk(c)

    nodes = list(walk(plan))
    assert len(nodes) == len(prof.profiles) >= 3
    for node in nodes:
        _, b = physical.execute(node, "cpu")
        assert prof.profiles[id(node)].cardinality == int(b.count)
    selfs = sum(max(prof.profiles[id(n)].seconds - sum(
        prof.profiles[id(c)].seconds for c in n.children()), 0.0)
        for n in nodes)
    assert selfs <= wall


def test_profiling_setting(cons):
    outs = []
    for con in cons:
        con.execute("PRAGMA enable_profiling")
        res = con.execute("SELECT count(*) FROM t")
        outs.append((res.fetchall(), _tree([(res.profile,)])))
        con.execute("PRAGMA disable_profiling")
        outs.append(hasattr(con.execute("SELECT count(*) FROM t"),
                            "profile"))
        con.execute("SET enable_profiling = true")
        outs.append(hasattr(con.execute("SELECT 1"), "profile"))
    assert outs[3:] == outs[:3]
    assert "Aggregate" in outs[0][1][0]


def test_logging(cons):
    outs = []
    for con in cons:
        con.log.clear()
        con.log.level = "debug"
        con.execute("SELECT count(*) FROM t")
        rows = con.execute("SELECT type, message FROM duckdb_logs() "
                           "WHERE type = 'query'").fetchall()
        outs.append((len(rows), rows[0][0], "executed" in rows[0][1]))
        con.log.clear()
        con.log.level = "info"
        con.execute("SELECT count(*) FROM t")
        outs.append(con.execute("SELECT count(*) FROM duckdb_logs()")
                    .fetchall())
    assert outs[2:] == outs[:2]
    assert outs[0] == (1, "query", True)


def test_secret_manager(tmp_path):
    outs = []
    for pkg, con in zip(("ref", "port"), both()):
        d = str(tmp_path / pkg)
        from importlib import import_module
        con.secret_manager = import_module(
            ("ddb_tpu" if pkg == "ref" else "ddb_tpu_torch") + ".secrets"
        ).SecretManager(d)
        steps = [
            "CREATE SECRET my_s3 (TYPE S3, KEY_ID 'AKIA123', SECRET 'shh', "
            "REGION 'us-east-1')",
            "SELECT name, type, provider, persistent, scope, secret_string "
            "FROM duckdb_secrets()",
            "CREATE SECRET my_s3 (TYPE S3, KEY_ID 'x')",
            "CREATE SECRET IF NOT EXISTS my_s3 (TYPE S3, KEY_ID 'x')",
            "CREATE OR REPLACE SECRET my_s3 (TYPE GCS, KEY_ID 'y')",
            "CREATE PERSISTENT SECRET keep (TYPE HTTP, TOKEN 't', "
            "SCOPE 'https://a.example/')",
            "SELECT name, type, persistent, scope, secret_string "
            "FROM duckdb_secrets() ORDER BY name",
            "DROP SECRET my_s3", "DROP SECRET nope",
            "DROP SECRET IF EXISTS nope",
            "SELECT count(*) FROM duckdb_secrets()"]
        out = [outcome(con, s) for s in steps]
        out.append(con.secret_manager.find_for_path(
            "https://a.example/x").name)
        out.append(sorted(os.listdir(d)))
        reread = type(con.secret_manager)(d)
        out.append([s.name for s in reread.list()])
        outs.append(out)
    for i, (w, g) in enumerate(zip(*outs)):
        if isinstance(w, tuple):
            same_outcome(w, g, f"secrets step {i}")
        else:
            assert w == g, (i, w, g)
    assert outs[0][0] == ("none",) and outs[0][8] == ("raises",
                                                      "CatalogException")


def test_progress_bar_callback():
    from ddb_tpu_torch.batch import bind_device
    from ddb_tpu_torch.plan import physical
    from ddb_tpu_torch.sql import parser
    con = ddb_tpu_torch.connect(device="cpu")
    con.register("t", {"a": [1, 2, 3]})
    seen = []
    with bind_device("cpu"):
        plan = con._binder().bind_select(
            parser.parse("SELECT sum(a) FROM t")[0])
    physical.execute(plan, ctx=physical.ExecContext(
        "cpu", progress=lambda d, t: seen.append((d, t))))
    assert seen and seen[-1][0] == seen[-1][1] > 0
    assert [d for d, _ in seen] == sorted(d for d, _ in seen)


def test_progress_bar_setting(capfd):
    outs = []
    for con in both():
        con.register("t", {"a": [1, 2, 3]})
        con.execute("SET enable_progress_bar = true")
        rows = con.execute("SELECT sum(a) FROM t").fetchall()
        err = capfd.readouterr().err
        outs.append((rows, err.rstrip().endswith("100.0%")))
    assert outs[1] == outs[0] == ([(6,)], True)


def test_valid_checker_invalidates_connection(tmp_path):
    from ddb_tpu_torch.api import FatalError
    p = str(tmp_path / "x.dtb")
    con = ddb_tpu_torch.connect(device="cpu")
    con.register("t", {"a": [1]})
    con.save(p)
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) - 9)
        f.write(b"\xff" * 8)
    c2 = ddb_tpu_torch.connect(device="cpu")
    with pytest.raises(FatalError):
        c2.load(p)
    assert c2._invalidated is not None
    with pytest.raises(FatalError):
        c2.execute("SELECT 1")
    r2 = ddb_tpu.connect()
    with pytest.raises(IOError):
        r2.load(p)
    assert (r2._invalidated is None) == (c2._invalidated is None)


def test_sql_auto_complete():
    outs = []
    for con in both():
        con.execute("CREATE TABLE customers (cust_id INTEGER)")
        outs.append((
            con.execute("SELECT * FROM sql_auto_complete('SEL')").fetchall(),
            con.execute("SELECT suggestion FROM sql_auto_complete("
                        "'SELECT * FROM cust')").fetchall(),
            con.execute("SELECT count(*) FROM sql_auto_complete('')")
            .fetchall()))
    assert outs[1] == outs[0]
    assert outs[0][0][0][0] == "SELECT" and ("customers",) in outs[0][1]


def test_autocomplete_completer_matches_reference():
    from ddb_tpu.autocomplete import make_readline_completer as ref_mk
    from ddb_tpu_torch.autocomplete import make_readline_completer as mk
    ref, port = both()
    for c in (ref, port):
        c.execute("CREATE TABLE orders (o_id INTEGER)")
    for text in ("SEL", "ord", "o_", "su", "zzz"):
        want = [ref_mk(lambda: ref)(text, i) for i in range(5)]
        assert [mk(lambda: port)(text, i) for i in range(5)] == want


# ---- the shell ------------------------------------------------------------

def _shell(args, script, cwd):
    return subprocess.run(
        [sys.executable, "-m", "ddb_tpu_torch", *args], input=script,
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env={**os.environ, "PYTHONPATH": _ROOT})


def test_shell_through_stdin(tmp_path):
    db = str(tmp_path / "shell.dtb")
    script = ("CREATE TABLE t (a INTEGER, s VARCHAR);\n"
              "INSERT INTO t VALUES (1, 'x'), (2, NULL);\n"
              "SELECT a, s\n  FROM t ORDER BY a;\n"
              ".tables\n.schema t\n.timer on\nSELECT 42;\n.timer off\n"
              f".save {db}\n.bogus\nSELECT nope;\n.quit\n")
    out = _shell(["--device", "cpu"], script, str(tmp_path))
    assert out.returncode == 0, out.stderr
    from ddb_tpu.__main__ import render_box
    text = out.stdout
    assert "shell on cpu" in text
    assert render_box(["a", "s"], [(1, "x"), (2, None)]) in text
    assert "D t\n" in text and "D CREATE TABLE t (a INTEGER, s VARCHAR);" \
        in text
    assert "Run Time:" in text and f"saved to {db}" in text
    assert "unknown command .bogus" in text and "Error: " in text
    # the saved file opens in the reference and in a second shell
    assert ddb_tpu.connect(db).execute("SELECT count(*) FROM t") \
        .fetchall() == [(2,)]
    out = _shell(["--device", "cpu", db],
                 "INSERT INTO t VALUES (3, 'z');\nSELECT sum(a) FROM t;\n",
                 str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "│ 6 " in out.stdout
    # closing at the end of its input checkpoints nothing: the WAL has it
    assert ddb_tpu_torch.connect("cpu", db).execute(
        "SELECT count(*) FROM t").fetchall() == [(3,)]


def test_shell_defaults_to_the_card():
    out = _shell([], "SELECT 1;\n", _ROOT)
    import torch
    if torch.cuda.is_available():
        assert out.returncode == 0
    else:
        assert out.returncode != 0 and "CUDA is not available" in out.stderr


# ---- the sqllogictest runner ------------------------------------------------

_SCRIPT = """\
# a script in the reference's sqllogictest format
statement ok
CREATE TABLE t (a INTEGER, b VARCHAR)

statement ok
INSERT INTO t VALUES (1, 'x'), (2, 'y'), (3, NULL)

query IT
SELECT a, b FROM t ORDER BY a
----
1	x
2	y
3	NULL

query I rowsort
SELECT a * 2 FROM t
----
2
4
6

query R
SELECT avg(a) FROM t
----
2.0

statement error
SELECT nope FROM t

loop i 0 3

statement ok
INSERT INTO t VALUES (${i} + 10, 'l')

endloop

query I
SELECT count(*) FROM t WHERE b = 'l'
----
3

statement ok con1
BEGIN

statement ok con1
INSERT INTO t VALUES (99, 'c')

query I
SELECT count(*) FROM t WHERE a = 99
----
0

statement ok con1
COMMIT

query I
SELECT count(*) FROM t WHERE a = 99
----
1

query T
SELECT DATE '2024-02-29' + INTERVAL 1 DAY
----
2024-03-01

query T
SELECT [1, 2, NULL]
----
[1, 2, NULL]

query I
SELECT 1
----
2

require vector_size
"""


def test_sqllogic_runner_on_an_inline_script(tmp_path):
    from ddb_tpu.testing.sqllogic import run_file as ref_run
    from ddb_tpu_torch.testing.sqllogic import run_file
    path = tmp_path / "inline.test"
    path.write_text(_SCRIPT)
    want = ref_run(ddb_tpu.connect(), str(path))
    got = run_file(ddb_tpu_torch.connect(device="cpu"), str(path))
    assert (got.ran, got.passed, got.skipped_reason) == \
        (want.ran, want.passed, want.skipped_reason)
    assert got.failures == want.failures
    # the last query's answer is wrong on purpose, and the last line skips
    assert len(got.failures) == 1 and got.skipped_reason == \
        "require vector_size"
    assert got.passed == got.ran - 1 > 10

"""The same SQL through ddb_tpu.connect() (JAX on the CPU) and
ddb_tpu_torch.connect(device="cpu") over the vendored TPC-H sf0.01
tables (lineitem has 60,175 rows).  Each table is loaded once by the
reference package and carried over with from_reference_table.  The
single-table corpus reads lineitem; TPC-H 3, 4, 5, 10, 12, 14 and 19
join up to six of the eight tables.

Integers, decimals, dates and strings must match exactly; floats
(avg, stddev, var) to 1e-12 relative, since the two sum in different
orders."""

import math
import os
import subprocess
import sys

import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.bench.tpch import TPCH_QUERIES, load_tbl
from ddb_tpu_torch.bench import select_cases
from ddb_tpu_torch.storage.table import from_reference_table
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

RTOL = 1e-12
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DATA = os.path.join(_ROOT, "tests", "data", "tpch_sf0.01")
_LINEITEM = os.path.join(_DATA, "lineitem.csv.gz")
_TABLES = ("lineitem", "orders", "customer", "part", "supplier", "nation",
           "region", "partsupp")
TPCH_JOINS = (3, 4, 5, 10, 12, 14, 19)

CORPUS = {
    "q1": TPCH_QUERIES[1],
    "q6": TPCH_QUERIES[6],
    "dense_shipmode": """
        select l_shipmode, count(*), sum(l_quantity), min(l_shipdate),
               max(l_extendedprice), avg(l_discount)
        from lineitem group by l_shipmode order by l_shipmode""",
    "sort_topn": """
        select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as rev
        from lineitem group by l_orderkey order by rev desc limit 10""",
    "filtered_avg": """
        select l_suppkey, avg(l_quantity) as aq, count(*) as c
        from lineitem where l_discount > 0.05 and l_tax <= 0.04
        group by l_suppkey order by l_suppkey""",
    "distinct": """
        select distinct l_linestatus, l_returnflag from lineitem
        order by l_linestatus, l_returnflag""",
    "between_offset": """
        select l_orderkey, l_linenumber, l_shipdate, l_extendedprice
        from lineitem
        where l_shipdate between date '1995-01-01' and date '1995-03-31'
        order by l_shipdate, l_orderkey, l_linenumber limit 25 offset 5""",
    "case_in_colcmp": """
        select sum(case when l_shipmode in ('AIR', 'REG AIR')
                        then l_quantity else 0 end) as air_qty,
               sum(case when l_commitdate < l_receiptdate
                        then 1 else 0 end) as late,
               count(*) as n
        from lineitem where l_receiptdate > l_shipdate""",
    "year_group": """
        select year(l_shipdate) as y, count(*), sum(l_extendedprice)
        from lineitem group by year(l_shipdate) order by y""",
    "stddev_var": """
        select l_returnflag, stddev_samp(l_quantity),
               var_pop(l_extendedprice)
        from lineitem group by l_returnflag order by l_returnflag""",
}

_DICT = {"k": ["b", None, "a", "b", None, "c", "a"],
         "v": [1, None, 3, 4, 5, None, -7]}
_DICT_SQL = """select k, sum(v), count(v), count(*), min(v) from t
               group by k order by k nulls last"""


@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for t in _TABLES:
        load_tbl(ref, t, os.path.join(_DATA, f"{t}.csv.gz"))
        port.catalog.add_table(from_reference_table(ref.catalog.get_table(t)))
    return ref, port


def same_value(want, got, atol=0.0) -> bool:
    """Floats to RTOL relative or atol (NaN equals NaN), everything else
    exactly and of the same type; lists, tuples and dicts element by
    element."""
    if isinstance(want, float) and isinstance(got, float):
        return (math.isnan(want) and math.isnan(got)) \
            or math.isclose(want, got, rel_tol=RTOL, abs_tol=atol)
    if isinstance(want, (list, tuple)) and type(want) is type(got):
        return len(want) == len(got) \
            and all(same_value(w, g, atol) for w, g in zip(want, got))
    if isinstance(want, dict) and isinstance(got, dict):
        return list(want) == list(got) \
            and all(same_value(want[k], got[k], atol) for k in want)
    return type(want) is type(got) and want == got


def first_difference(want_rows, got_rows, atol=0.0):
    """None when two fetchall() lists agree (`same_value`), else a short
    description of the first difference.  The other test files of the
    SELECT surface compare rows with this too."""
    if len(want_rows) != len(got_rows):
        return f"{len(want_rows)} rows against {len(got_rows)}"
    for i, (w, g) in enumerate(zip(want_rows, got_rows)):
        if not same_value(w, g, atol):
            return f"row {i}: {w!r} against {g!r}"
    return None


def _same_rows(want, got):
    assert len(want) == len(got) and len(want) > 0
    for rw, rg in zip(want, got):
        assert len(rw) == len(rg)
        for w, g in zip(rw, rg):
            if isinstance(w, float):
                assert isinstance(g, float)
                assert (math.isnan(w) and math.isnan(g)) or \
                    math.isclose(w, g, rel_tol=RTOL, abs_tol=0.0), (w, g)
            else:
                assert type(w) is type(g) and w == g, (w, g)


@pytest.mark.parametrize("name", list(CORPUS))
def test_sql_matches_reference(cons, name):
    ref, port = cons
    res = port.execute(CORPUS[name])
    assert res.batch.sel.device.type == "cpu"
    _same_rows(ref.execute(CORPUS[name]).fetchall(), res.fetchall())
    assert res.column_names == ref.execute(CORPUS[name]).column_names


@pytest.mark.parametrize("q", TPCH_JOINS)
def test_tpch_join_query_matches_reference(cons, q):
    ref, port = cons
    res = port.execute(TPCH_QUERIES[q])
    assert res.batch.sel.device.type == "cpu"
    want = ref.execute(TPCH_QUERIES[q])
    _same_rows(want.fetchall(), res.fetchall())
    assert res.column_names == want.column_names


def test_tpch_join_queries_reach_joins_of_every_kind_they_name(cons):
    from ddb_tpu_torch.plan import logical as L

    def nodes(n):
        yield n
        for attr in ("child", "left", "right"):
            c = getattr(n, attr, None)
            if isinstance(c, L.LogicalNode):
                yield from nodes(c)

    _, port = cons
    kinds = {}
    for q in TPCH_JOINS:
        port.execute(TPCH_QUERIES[q])
        kinds[q] = [n.join_type for n in
                    nodes(port._plan_cache[TPCH_QUERIES[q]][1])
                    if isinstance(n, L.Join)]
    assert kinds[3] == ["inner", "inner"] and kinds[4] == ["semi"]
    assert len(kinds[5]) == 5 and all(kinds[q] for q in TPCH_JOINS)


def test_carried_tables_keep_large_dictionaries_and_types(cons):
    ref, port = cons
    for t in _TABLES:
        want, got = ref.catalog.get_table(t), port.catalog.get_table(t)
        assert got.num_rows == want.num_rows
        for w, g in zip(want.columns, got.columns, strict=True):
            assert (w.name, w.dtype.id.name) == (g.name, g.dtype.id.name)
            assert (w.strdict is None) == (g.strdict is None)
            if w.strdict is not None:
                assert len(g.strdict) == len(w.strdict)
    # c_name is unique per customer: a dictionary as large as the table
    c_name = port.catalog.get_table("customer").columns[1]
    assert c_name.name == "c_name" and len(c_name.strdict) == 1500
    q = "select c_name, o_comment from customer, orders " \
        "where c_custkey = o_custkey and o_orderkey = 7"
    assert port.execute(q).fetchall() == ref.execute(q).fetchall() != []


def test_registered_dict_with_nulls():
    ref = ddb_tpu.connect().register("t", _DICT)
    port = ddb_tpu_torch.connect(device="cpu").register("t", _DICT)
    want = ref.execute(_DICT_SQL).fetchall()
    assert want[-1][0] is None
    _same_rows(want, port.execute(_DICT_SQL).fetchall())


def test_zone_maps_skip_row_groups():
    # 300,000 rows = 3 row groups of 122,880; the filter rules out two
    import numpy as np
    from ddb_tpu_torch.storage import table as port_table

    data = {"x": np.arange(300_000, dtype=np.int64),
            "y": np.arange(300_000, dtype=np.int64) % 7}
    q = "select count(*), sum(y), min(x) from t where x >= 250000"
    ref = ddb_tpu.connect().register("t", data)
    port = ddb_tpu_torch.connect(device="cpu").register("t", data)
    skipped = port_table.SCAN_STATS["groups_skipped"]
    _same_rows(ref.execute(q).fetchall(), port.execute(q).fetchall())
    assert port_table.SCAN_STATS["groups_skipped"] == skipped + 2


def test_port_load_tbl_matches_carried_table(cons):
    from ddb_tpu_torch.bench.tpch import load_tbl as port_load_tbl

    ref, _ = cons
    want = from_reference_table(ref.catalog.get_table("lineitem"))
    got = port_load_tbl(ddb_tpu_torch.connect(device="cpu"), "lineitem",
                        _LINEITEM).catalog.get_table("lineitem")
    for w, g in zip(want.columns, got.columns, strict=True):
        assert (w.name, w.dtype) == (g.name, g.dtype)
        assert w.data.dtype == g.data.dtype and (w.data == g.data).all()
        assert (w.nulls is None) == (g.nulls is None)
        if w.strdict is not None:
            assert list(w.strdict.values) == list(g.strdict.values)


def test_fetchone_and_fetchnumpy(cons):
    ref, port = cons
    q = "select l_returnflag, count(*) from lineitem group by 1 order by 1"
    assert port.execute(q).fetchone() == ref.execute(q).fetchone()
    got, want = port.execute(q).fetchnumpy(), ref.execute(q).fetchnumpy()
    assert list(got) == list(want)
    assert all((got[k] == want[k]).all() for k in want)


# statements that raised NotImplementedError before the file readers and
# writers were ported; each runs through both packages on lineitem, in a
# directory of each package's own, and its rows (or the bytes it wrote)
# are compared
@pytest.mark.parametrize("sql", [
    "copy lineitem to '{d}/x.csv'",
    "select * from read_parquet('{d}/x.parquet') order by all",
    "select * from read_csv('{d}/x.csv') order by all",
])
def test_statements_that_raised_before_the_readers_match_reference(
        cons, tmp_path, sql):
    if "parquet" in sql:
        pytest.importorskip("pyarrow.parquet")
    got = {}
    for pkg, con in zip(("ref", "port"), cons):
        d = tmp_path / pkg
        d.mkdir()
        src = ("select l_orderkey, l_linenumber, l_quantity, l_shipdate, "
               "l_returnflag, l_comment from lineitem where l_orderkey < 600")
        if "read_" in sql:
            con.execute(f"copy ({src}) to '{d}/x.csv'")
            con.execute(f"copy ({src}) to '{d}/x.parquet' (format parquet)")
        r = con.execute(sql.format(d=d))
        got[pkg] = ([repr(t) for t in r.column_types], r.fetchall())
        if sql.startswith("copy"):
            got[pkg] += ((d / "x.csv").read_bytes(),)
    assert got["port"] == got["ref"]
    assert got["port"][1]


# statements that raised NotImplementedError before persistence and the
# client surface were ported; each runs through both packages and its
# rows, and what it leaves in the catalog, are compared
@pytest.mark.parametrize("sql,check", [
    ("attach '{db}' as other",
     "select count(*), sum(l_quantity) from other.li"),
    ("checkpoint", "select count(*) from lineitem"),
    ("create secret s (type s3, key_id 'k')",
     "select name, type, scope, secret_string from duckdb_secrets()"),
    ("select suggestion from sql_auto_complete('SEL')",
     "select count(*) from sql_auto_complete('select * from line')"),
])
def test_statements_that_raised_before_persistence_match_reference(
        cons, tmp_path, sql, check):
    ref, port = cons
    db = str(tmp_path / "li.dtb")
    # a file the reference writes, so that ATTACH also reads it across
    ref.execute("create table li as select * from lineitem "
                "where l_orderkey < 100")
    try:
        ref.save(db)
    finally:
        ref.execute("drop table li")
    outs = []
    for con in (ref, port):
        res = con.execute(sql.format(db=db))
        outs.append((None if res is None else res.fetchall(),
                     con.execute(check).fetchall()))
        if sql.startswith("attach"):
            con.execute("detach other")
        if sql.startswith("create secret"):
            con.execute("drop secret s")
    assert outs[1] == outs[0]


# statements that raised NotImplementedError before DDL, DML and EXPLAIN
# were ported; each runs on a copy of part of lineitem, then the copy is
# read back and dropped
@pytest.mark.parametrize("sql", [
    "create table u (x integer)",
    "insert into li select * from li where l_linenumber = 1",
    "update li set l_quantity = 1 where l_orderkey < 20",
    "delete from li where l_quantity > 5",
    "explain select count(*) from li",
    # raised before out-of-core execution was ported; the limit is put
    # back below
    "set memory_limit = '1GB'",
])
def test_statements_outside_the_select_slice_match_reference(cons, sql):
    ref, port = cons
    check = "select count(*), sum(l_quantity), min(l_shipmode) from li"
    outs = []
    for con in (ref, port):
        con.execute("create table li as select * from lineitem "
                    "where l_orderkey < 200")
        try:
            res = con.execute(sql)
            outs.append((None if res is None else res.fetchall(),
                         con.execute(check).fetchall()))
        finally:
            con.execute("drop table li")
            con.execute("drop table if exists u")
            con.execute("set memory_limit = 'unlimited'")
    assert first_difference(outs[0][1], outs[1][1]) is None
    if outs[0][0] is None:
        assert outs[1][0] is None
    else:
        assert first_difference(outs[0][0], outs[1][0]) is None


# statements that raised NotImplementedError before the host aggregates,
# UNNEST, SAMPLE and the recursive CTEs were ported
@pytest.mark.parametrize("sql", [
    "select l_returnflag, string_agg(l_shipmode, ',') from lineitem "
    "where l_orderkey < 200 group by l_returnflag order by l_returnflag",
    "select list(l_suppkey) from lineitem where l_orderkey < 500",
    "select unnest([1, 2, 3])",
    "with recursive r(n) as (select 1 union all select n + 1 from r "
    "where n < 3) select * from r",
    "select mad(l_quantity) from lineitem",
    "select l_linestatus, approx_top_k(l_shipmode, 2), histogram(l_linenumber)"
    " from lineitem group by l_linestatus order by l_linestatus",
])
def test_statements_that_were_outside_the_slice_match_reference(cons, sql):
    ref, port = cons
    want, got = ref.execute(sql), port.execute(sql)
    assert got.column_names == want.column_names
    assert first_difference(want.fetchall(),
                                         got.fetchall()) is None
    assert got.fetchall()


def test_sample_returns_the_rows_asked_for(cons):
    _, port = cons
    rows = port.execute("select l_orderkey, l_linenumber from lineitem "
                        "using sample 5 rows").fetchall()
    assert len(rows) == len(set(rows)) == 5


def test_connect_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ddb_tpu_torch.connect()


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'pyarrow', 'pandas', 'ddb_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import ddb_tpu_torch\n"
        "from ddb_tpu_torch.bench.tpch import TPCH_QUERIES, "
        "register_synth_lineitem, register_synth_join_tables\n"
        "from ddb_tpu_torch.bench import cmpx_probe\n"
        "from ddb_tpu_torch.ops import cmpx, fused_agg, join\n"
        "from ddb_tpu_torch.ops import hashing, sketch, window\n"
        "from ddb_tpu_torch.bench import h2oai, window_cases\n"
        "from ddb_tpu_torch.bench.tpch import load_tpch\n"
        "con = ddb_tpu_torch.connect(device='cpu')\n"
        "h2oai.register(con, h2oai.generate(500, k=5))\n"
        "for q in sorted(h2oai.QUERIES):\n"
        "    assert con.execute(h2oai.QUERIES[q]).fetchall(), q\n"
        "load_tpch(con, 'tests/data/tpch_sf0.01', ['nation', 'region'])\n"
        "assert con.execute('select count(*) from nation, region where '\n"
        "                   'n_regionkey = r_regionkey').fetchall() "
        "== [(25,)]\n"
        "register_synth_lineitem(con, 5000, seed=1)\n"
        "(rev,), = con.execute(TPCH_QUERIES[6]).fetchall()\n"
        "assert rev > 0, rev\n"
        "register_synth_join_tables(con, 300, 3000, seed=1)\n"
        "assert con.execute(TPCH_QUERIES[4]).fetchall()\n"
        "from ddb_tpu_torch.bench import clickbench, select_cases\n"
        "from ddb_tpu_torch import table_functions, tz\n"
        "from ddb_tpu_torch.expr import bits, nestedtext\n"
        "from ddb_tpu_torch.sql import lambda_eval\n"
        "from ddb_tpu_torch.storage import lists, nested\n"
        "clickbench.register(con, clickbench.generate(2000))\n"
        "for name, q in clickbench.shapes(5, 2).items():\n"
        "    assert con.execute(q).fetchall(), name\n"
        "for name, cols in select_cases.tables().items():\n"
        "    con.register(name, cols)\n"
        "select_cases.setup(con)\n"
        "for kind in ('functions/trig', 'functions/ts_parts', "
        "'cte/cte_twice_max', 'cte/recursive_union_cycle', "
        "'lists/string_split_unnest', 'lists/lambda_over_column', "
        "'lists/struct_column_fields', 'lists/range_table', "
        "'lists/bit_operators', 'host_agg/string_agg_order_by', "
        "'host_agg/user_aggregate', 'tz/timezone_column', "
        "'tz/stringify_dates', 'tz/udf_varchar_return'):\n"
        "    assert con.execute(select_cases.all_statements()[kind])"
        ".fetchall(), kind\n"
        "assert con.execute('select count(*) from f using sample 10 rows')"
        ".fetchall() == [(10,)]\n"
        # database files, the WAL, the follower and the client surface
        "import os, tempfile\n"
        "p = os.path.join(tempfile.mkdtemp(), 'x.dtb')\n"
        "db = ddb_tpu_torch.connect('cpu', p)\n"
        "db.execute(f\"set redo_transport = '{p}.redo'\")\n"
        "db.execute('create table t (a integer)')\n"
        "db.execute('checkpoint')\n"
        "db.execute('insert into t values (1), (2)')\n"
        "db.execute('delete from t where a = 1')\n"
        "db._wal = None\n"
        "db2 = ddb_tpu_torch.connect('cpu', p)\n"
        "assert db2.execute('select * from t').fetchall() == [(2,)]\n"
        "from ddb_tpu_torch.redo import Follower\n"
        "assert Follower(p + '.redo', device='cpu').poll() == 3\n"
        "assert db2.execute('explain analyze select sum(a) from t')"
        ".fetchall()\n"
        "assert db2.stream('select a from t').fetchall() == [(2,)]\n"
        "assert db2.table('t').count().fetchall() == [(1,)]\n"
        "db2.execute(\"create secret s (type s3, key_id 'k')\")\n"
        "assert db2.execute(\"select * from sql_auto_complete('SEL')\")"
        ".fetchall()\n"
        # the file readers and writers, with pyarrow blocked
        "d = tempfile.mkdtemp()\n"
        "db2.execute(\"create table v as select * from (values (1, 'a', "
        "DATE '2020-01-02', 1.5), (2, 'b', NULL, 2.25)) t(i, s, dt, x)\")\n"
        "db2.execute(f\"copy v to '{d}/v.csv'\")\n"
        "db2.execute('create table v2 (i integer, s varchar, dt date, "
        "x decimal(4,2))')\n"
        "db2.execute(f\"copy v2 from '{d}/v.csv'\")\n"
        "assert db2.execute('select count(*) from v2').fetchall() == [(2,)]\n"
        "assert db2.execute(f\"select * from read_csv_auto('{d}/v.csv') "
        "order by i\").fetchall()[1][:2] == (2, 'b')\n"
        "assert db2.execute(f\"select * from sniff_csv('{d}/v.csv')\")"
        ".fetchall()\n"
        "assert db2.execute(f\"select * from read_csv('{d}/v.csv', "
        "delim=',', header=true)\").fetchall()\n"
        "db2.read_csv('v3', f'{d}/v.csv')\n"
        "db2.execute(f\"export database '{d}/exp'\")\n"
        "db3 = ddb_tpu_torch.connect('cpu')\n"
        "db3.execute(f\"import database '{d}/exp'\")\n"
        "assert db3.execute('select * from v order by i').fetchall() == "
        "db2.execute('select * from v order by i').fetchall()\n"
        "from ddb_tpu_torch.storage import csvscan, csvwrite, cachefs\n"
        "from ddb_tpu_torch.testing import sqllogic\n"
        "from ddb_tpu_torch import __main__ as shell\n"
        # the distributed executor over eight shards on the CPU
        "from ddb_tpu_torch.parallel import dist, exchange, executor\n"
        "from ddb_tpu_torch.parallel.mesh import Mesh\n"
        "import torch\n"
        "con.use_mesh(Mesh([torch.device('cpu')] * 8))\n"
        "assert con.execute(h2oai.QUERIES[1]).fetchall()\n"
        "con.use_mesh(None)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.split('.')[0] in ('jax', 'jaxlib', 'ddb_tpu', 'pyarrow', "
        "'pandas')]\n"
        "assert not bad, bad\n"
        "print('ok', rev)\n")
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")

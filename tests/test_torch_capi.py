"""The port's C API against the reference's (tests/test_capi.py).

`ddb_tpu_torch/capi.py` builds the port's libraries from
ddb_tpu_torch/native/ and links the reference's own smoke clients
(native/capi_smoke.c, native/adbc_smoke.c) against them.  Here, on the
CPU (DDB_CAPI_PLATFORM=cpu): the smoke clients pass; without CUDA the
default device fails instead of falling back; capi_fetch prints the same
lines over one database file through the port's library and through the
reference's (built by its Makefile); and the two capi_bridge modules
lower the same statements, settings, appends and Python-registered
functions to the same values.
"""

import math
import os
import shutil
import subprocess

import pytest
import torch

import ddb_tpu_torch
from ddb_tpu import capi_bridge as ref_bridge
from ddb_tpu_torch import capi
from ddb_tpu_torch import capi_bridge as port_bridge
from ddb_tpu_torch.bench import tpch
from test_torch_persist import _native_library  # noqa: F401
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12      # DOUBLE aggregates: the packages sum in another order
FLOAT_CODES = (7, 8)    # FLOAT, DOUBLE (a DECIMAL lowers exactly)


@pytest.fixture(scope="module")
def built():
    return capi.build()


def run(exe, args=(), platform="cpu", extra_env=None, cwd=None):
    env = capi.child_env(platform)
    env.update(extra_env or {})
    return subprocess.run([exe, *args], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=300)


@pytest.mark.parametrize("client, ok", [("capi_smoke", "capi smoke: OK"),
                                        ("adbc_smoke", "adbc smoke: OK")])
def test_reference_smoke_clients_pass_against_the_port(built, client, ok):
    r = run(built[client])
    assert r.returncode == 0, (r.stdout + r.stderr)[-2000:]
    assert ok in r.stdout


def test_the_build_writes_nothing_under_native(built):
    assert os.path.commonpath([str(built.dir), _ROOT]) == _ROOT
    assert not str(built.dir).startswith(os.path.join(_ROOT, "native"))
    names = sorted(os.listdir(built.dir))
    assert names == sorted(["libddb_tpu.so", "libddb_tpu_adbc.so",
                            "capi_fetch", "capi_smoke", "adbc_smoke"])


def test_without_cuda_the_default_device_fails(built):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device connects")
    r = run(built["capi_fetch"], [":memory:", "SELECT 1"],
            platform=None)
    assert r.returncode != 0
    assert "capi_fetch: OK" not in r.stdout
    assert "CUDA" in r.stderr


# ---------------------------------------------------------------------------
# capi_fetch over one database file, through both libraries
# ---------------------------------------------------------------------------

FETCH = [
    tpch.TPCH_QUERIES[1],
    tpch.TPCH_QUERIES[6],
    "SELECT l_orderkey, l_linenumber, l_quantity, l_extendedprice, "
    "l_discount, l_shipdate, l_returnflag, l_comment FROM lineitem "
    "WHERE l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1995-02-11' "
    "ORDER BY l_orderkey, l_linenumber",
    "SELECT count(*) AS n, min(l_shipmode) AS m, max(l_commitdate) AS d "
    "FROM lineitem WHERE l_quantity > 49",
]


@pytest.fixture(scope="module")
def lineitem_file(tmp_path_factory):
    """TPC-H SF0.01 lineitem checkpointed by the port into a database
    file, which the reference reads too."""
    d = tmp_path_factory.mktemp("capi_db")
    path = str(d / "lineitem.dtb")
    con = ddb_tpu_torch.connect("cpu", path)
    tpch.load_tpch(con, os.path.join(_ROOT, "tests", "data", "tpch_sf0.01"),
                   tables=["lineitem"])
    con.execute("CHECKPOINT")
    con.close()
    return path


@pytest.fixture(scope="module")
def reference_fetch(tmp_path_factory):
    """capi_fetch linked against the reference's libddb_tpu.so, which the
    reference's Makefile builds in a copy of native/ (two workers running
    make in native/ at once would write one file together)."""
    d = tmp_path_factory.mktemp("capi_ref")
    for f in ("Makefile", "capi.c"):
        shutil.copy(os.path.join(_ROOT, "native", f), d)
    shutil.copytree(os.path.join(_ROOT, "native", "include"), d / "include")
    r = subprocess.run(["make", "libddb_tpu.so"], cwd=d,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    _, link = capi.python_flags()
    exe = str(d / "capi_fetch")
    r = subprocess.run(
        ["cc", *capi.CFLAGS, "-o", exe,
         os.path.join(_ROOT, "ddb_tpu_torch", "native", "capi_fetch.c"),
         f"-L{d}", "-lddb_tpu", f"-Wl,-rpath,{d}", *link],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    return exe


def _stat(path):
    return [(os.path.getsize(p), os.path.getmtime(p))
            for p in (path, path + ".wal")]


def _fetch(exe, path, extra_env=None):
    before = _stat(path)
    r = run(exe, [path, "-n", "2", *FETCH], extra_env=extra_env)
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    assert r.stdout.splitlines()[-1] == "capi_fetch: OK"
    assert _stat(path) == before      # the second process wrote nothing
    return r.stdout


def _same_line(want, got, codes):
    """Lines agree exactly, but for DOUBLE cells and checksums, to
    RTOL."""
    if want == got:
        return True
    w, g = want.split(" ", 3), got.split(" ", 3)
    if w[:3] != g[:3] or w[0] not in ("row", "checksum"):
        return False
    k = int(w[1])
    if w[0] == "checksum":
        j = int(w[2])
        return codes[k][j] in FLOAT_CODES and math.isclose(
            float(w[3]), float(g[3]), rel_tol=RTOL)
    wc, gc = w[3].split("\t"), g[3].split("\t")
    return len(wc) == len(gc) and all(
        a == b or (codes[k][j] in FLOAT_CODES
                   and math.isclose(float(a), float(b), rel_tol=RTOL))
        for j, (a, b) in enumerate(zip(wc, gc)))


def test_capi_fetch_prints_the_reference_lines(built, lineitem_file,
                                               reference_fetch):
    port = capi.untimed(_fetch(built["capi_fetch"], lineitem_file))
    ref = capi.untimed(_fetch(reference_fetch, lineitem_file,
                              {"JAX_DISABLE_MOST_OPTIMIZATIONS": "1"}))
    codes = {}
    for ln in port:
        w = ln.split()
        if w[0] == "column":
            codes.setdefault(int(w[1]), {})[int(w[2])] = int(w[3])
    assert len(codes) == len(FETCH)
    assert len(port) == len(ref)
    for w, g in zip(ref, port):
        assert _same_line(w, g, codes), (w, g)
    rows = {int(ln.split()[1]): int(ln.split()[3]) for ln in port
            if ln.startswith("statement ")}
    assert rows[0] == 4 and rows[1] == 1 and rows[2] > 900


def test_capi_fetch_prints_the_bridge_lowering_of_fetchall(
        built, lineitem_file, monkeypatch):
    """The check chip_smoke.py makes on the card: capi_fetch's lines equal
    capi.fetch_lines of the in-process rows, exactly."""
    out = _fetch(built["capi_fetch"], lineitem_file)
    before = _stat(lineitem_file)
    monkeypatch.setenv("DDB_CAPI_PLATFORM", "cpu")
    con = port_bridge.connect(port_bridge.open_database(lineitem_file))
    want = []
    for k, sql in enumerate(FETCH):
        names, codes, columns, _ = port_bridge.query(con, sql)
        want += capi.fetch_lines(k, names, codes, columns)
    con.execute("SET checkpoint_on_shutdown = false")
    con.close()                       # leaves the file as it was
    assert _stat(lineitem_file) == before
    assert capi.untimed(out) == want + ["capi_fetch: OK"]
    t = capi.timings(out)
    assert set(t) == {"open", "connect", "query"}
    assert sorted(t["query"]) == list(range(len(FETCH)))
    assert all(len(v) == 2 for v in t["query"].values())


def test_fetch_lines_follow_capi_c():
    lines = capi.fetch_lines(
        3, ["b", "i", "d", "s", "n"], [1, 5, 8, 10, 12],
        [[True, False], [2**63 + 5, -7], [0.1, None], ["ab", "c"],
         [None, "2020-01-02"]])
    assert lines == [
        "statement 3 rows 2 cols 5",
        "column 3 0 1 b", "column 3 1 5 i", "column 3 2 8 d",
        "column 3 3 10 s", "column 3 4 12 n",
        "row 3 0 1\t-1\t0.10000000000000001\tab\tNULL",
        "row 3 1 0\t-7\tNULL\tc\t2020-01-02",
        "checksum 3 0 1", "checksum 3 1 -8", "checksum 3 2 "
        "0.10000000000000001", "checksum 3 3 3", "checksum 3 4 10"]


# ---------------------------------------------------------------------------
# the two bridges on the same statements
# ---------------------------------------------------------------------------

SETUP = [
    "CREATE TABLE u (x UUID)",
    "INSERT INTO u VALUES (NULL)",
    "CREATE TABLE t (id INTEGER, name VARCHAR, score DOUBLE)",
    "INSERT INTO t VALUES (1, 'alice', 3.5), (2, 'bob', NULL), "
    "(3, NULL, 1.25)",
]

CORPUS = {
    "integers": "SELECT true AS b, NULL::BOOLEAN AS nb, 1::TINYINT AS ti, "
                "2::SMALLINT AS si, 3::INTEGER AS i, 4::BIGINT AS bi",
    "hugeint": "SELECT 2::HUGEINT AS h2, sum(x) AS hs FROM (VALUES "
               "(9000000000000000000), (9000000000000000000)) v(x)",
    "floats": "SELECT 1.5::FLOAT AS f, 2.25::DOUBLE AS d, "
              "1.25::DECIMAL(9,2) AS dec, 123456789.123::DECIMAL(38,3) AS w",
    "text_and_time": "SELECT 'abc' AS v, 'x'::BLOB AS bl, "
                     "DATE '2020-01-02' AS dt, TIME '12:34:56' AS tm, "
                     "TIMESTAMP '2020-01-02 03:04:05' AS ts, "
                     "INTERVAL 3 DAY AS iv",
    "nested": "SELECT [1, 2, 3] AS l, {'a': 1, 'b': 'x'} AS s, "
              "MAP([1, 2], ['a', 'b']) AS m",
    "uuid": "SELECT x FROM u",
    "table": "SELECT id, name, score, score * 2 AS s2 FROM t ORDER BY id",
    "aggregate": "SELECT count(*) AS c, sum(score) AS s, avg(score) AS a, "
                 "max(name) AS m FROM t",
    "ddl": "CREATE TABLE e (a INTEGER)",
}


@pytest.fixture()
def bridges(monkeypatch):
    """(reference bridge, its connection), (port bridge, its connection):
    both on the CPU, each with SETUP run."""
    monkeypatch.setenv("DDB_CAPI_PLATFORM", "cpu")
    out = []
    for b in (ref_bridge, port_bridge):
        con = b.connect(b.open_database(None))
        for sql in SETUP:
            b.query(con, sql)
        out.append((b, con))
    return out


def _outcome(fn):
    try:
        return fn()
    except Exception as e:      # the two must fail alike
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("name", list(CORPUS))
def test_bridges_lower_the_same_values(bridges, name):
    (rb, rc), (pb, pc) = bridges
    want = rb.query(rc, CORPUS[name])
    got = pb.query(pc, CORPUS[name])
    assert got == want


def test_the_corpus_covers_every_type_code(bridges):
    (_, _), (pb, pc) = bridges
    codes = set()
    for sql in CORPUS.values():
        codes |= set(pb.query(pc, sql)[1])
    assert codes == set(port_bridge._TYPE_CODES.values()) == set(
        range(1, 20))
    assert port_bridge._TYPE_CODES == {
        getattr(port_bridge.TypeId, t.name): c
        for t, c in ref_bridge._TYPE_CODES.items()}


@pytest.mark.parametrize("sql, params", [
    ("SELECT ? + 1 AS a, ? AS s", [41, "x"]),
    ("SELECT name FROM t WHERE id = ?", [2]),
    ("SELECT score FROM t WHERE id = ? OR name = ? ORDER BY 1", [1, "bob"]),
    ("SELECT 1 AS one", []),
    ("SELECT * FROM nope WHERE id = ?", [1]),
])
def test_bridges_agree_with_parameters(bridges, sql, params):
    (rb, rc), (pb, pc) = bridges
    assert _outcome(lambda: pb.query_with(pc, sql, params)) == \
        _outcome(lambda: rb.query_with(rc, sql, params))
    assert _outcome(lambda: pb.execute_params(pc, sql, params)) == \
        _outcome(lambda: rb.execute_params(rc, sql, params))


def test_bridges_list_the_same_settings():
    assert port_bridge.config_settings() == ref_bridge.config_settings()


def test_open_database_config_applies_to_every_connection(bridges,
                                                          monkeypatch):
    monkeypatch.setenv("DDB_CAPI_PLATFORM", "cpu")
    sql = "SELECT current_setting('default_null_order') AS o"
    got = []
    for b in (ref_bridge, port_bridge):
        db = b.open_database(":memory:", [("default_null_order",
                                           "nulls_first")])
        got.append(b.query(b.connect(db), sql))
    assert got[0] == got[1]
    assert got[1][2] == [["nulls_first"]]


def test_bridges_append_the_same_rows(bridges):
    rows = [(4, "dora", 2.5), (5, None, None), (6, "eve", -1.0)]
    res = []
    for b, con in bridges:
        app = b.appender_create(con, "t")
        b.appender_rows(app, rows)
        b.appender_flush(app)
        res.append(b.query(con, "SELECT * FROM t ORDER BY id"))
    assert res[0] == res[1]
    assert len(res[1][2][0]) == 6


def test_bridges_register_the_same_functions(bridges):
    res = []
    for b, con in bridges:
        b.register_scalar(con, "times_plus",
                          lambda a, c: None if a is None or c is None
                          else a * 10 + c, 5)
        b.register_aggregate(con, "sumsq", lambda: [0.0],
                             lambda st, v: st.__setitem__(0, st[0] + v * v),
                             lambda st: st[0], 8)
        b.register_table(con, "squares",
                         lambda n: [(i, float(i * i), f"sq{i}")
                                    for i in range(n)],
                         ["n", "sq", "tag"], [5, 8, 10])
        res.append([
            b.query(con, "SELECT times_plus(id, 3) AS x FROM t "
                         "ORDER BY id"),
            b.query(con, "SELECT id % 2 AS g, sumsq(score) AS s FROM t "
                         "GROUP BY g ORDER BY g"),
            b.query(con, "SELECT n, sq, tag FROM squares(4) WHERE n >= 1 "
                         "ORDER BY n"),
            b.query(con, "SELECT sum(sq) AS s FROM squares(10)"),
            _outcome(lambda: b.register_scalar(con, "bad", abs, 99)),
            _outcome(lambda: b.register_table(con, "bad", list, ["a"],
                                              [99]))])
    assert res[0] == res[1]
    assert res[1][3][2] == [[285.0]]

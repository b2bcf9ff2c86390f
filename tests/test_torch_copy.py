"""COPY TO/FROM, EXPORT/IMPORT DATABASE, read_csv, sniff_csv,
read_parquet and the caching filesystem through ddb_tpu.connect() (JAX on
the CPU) and ddb_tpu_torch.connect(device="cpu").  The same statements
run through both packages; every step's rows and column types, or the
class of the exception it raises, are compared, and so are the bytes of
every file COPY TO and EXPORT write.

Ported here: every statement of the reference's tests/test_copy_arrow.py,
tests/test_export_db.py (its three option sets) and tests/test_cachefs.py,
and test_read_csv_table_function (tests/test_system.py),
test_nested_arrow_parquet_roundtrip (tests/test_lists.py) and
test_copy_nested_roundtrip (tests/test_nested_cast.py).  The CSV parse
and the writer run in torch (storage/csvscan.py, storage/csvwrite.py);
Parquet goes through pyarrow in both packages.  No tolerance: every
value compares exactly.

The writer's bytes equal the reference's for every type written here,
TIMESTAMPTZ and INTERVAL included (test_writer_zoned_stamps_and_
intervals_match); no difference remains to name.  COPY FROM appends
through storage/dml.py:append_table, which appends columns whole where
their types allow it and must leave the table the reference's row-by-row
append_table leaves (test_append_columns_equals_dml_append_table)."""

import os

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.storage import cachefs as ref_cachefs
from ddb_tpu_torch.storage import cachefs as port_cachefs
from test_torch_dml import outcome, same_outcome
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401


def outcome_of(con, step):
    """outcome(), with the port's CsvError under the name of pyarrow's
    ArrowInvalid: both are the ValueError of a text the reader rejects."""
    out = outcome(con, step)
    return ("raises", "ArrowInvalid") if out == ("raises", "CsvError") \
        else out


def typed(sql):
    """A step giving the statement's column types (by name) and rows."""
    def step(con):
        r = con.execute(sql)
        return [repr(t) for t in r.column_types], r.fetchall()
    step.__name__ = sql
    return step


class T_:
    """A typed step whose SQL names the package's directory."""

    def __init__(self, sql):
        self.sql = sql

    def __call__(self, con):          # pragma: no cover - replaced
        raise AssertionError

    def __repr__(self):
        return self.sql


# ---- tests/test_copy_arrow.py ---------------------------------------------

def test_copy_roundtrip_csv(tmp_path):
    _run(tmp_path, [
        "CREATE TABLE t (a INTEGER, s VARCHAR)",
        "INSERT INTO t VALUES (1, 'x'), (2, 'y')",
        "COPY t TO '{d}/out.csv'",
        "CREATE TABLE t2 (a INTEGER, s VARCHAR)",
        "COPY t2 FROM '{d}/out.csv'",
        T_("SELECT * FROM t2 ORDER BY a"),
    ], files=["out.csv"])


def test_copy_query_parquet(tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    _, dirs = _run(tmp_path, [
        lambda con: con.register("t", {"a": [3, 1, 2]}) and None,
        "COPY (SELECT a * 10 AS b FROM t WHERE a > 1) TO '{d}/out.parquet'",
        T_("SELECT * FROM read_parquet('{d}/out.parquet') ORDER BY b"),
    ])
    at = pq.read_table(str(dirs["port"] / "out.parquet"))
    assert sorted(at.column("b").to_pylist()) == [20, 30]


def test_arrow_export_types():
    pytest.importorskip("pyarrow")
    got = {}
    for pkg, con in (("ref", ddb_tpu.connect()),
                     ("port", ddb_tpu_torch.connect("cpu"))):
        con.execute("CREATE TABLE t (a INTEGER, s VARCHAR, d DECIMAL(10,2))")
        con.execute("INSERT INTO t VALUES (1, 'x', 1.25), (2, NULL, NULL)")
        at = con.execute("SELECT * FROM t ORDER BY a").arrow()
        got[pkg] = [(f.name, str(f.type)) for f in at.schema], at.to_pylist()
    assert got["port"] == got["ref"]


def test_fetchnumpy_after_register():
    got = {}
    for pkg, con in (("ref", ddb_tpu.connect()),
                     ("port", ddb_tpu_torch.connect("cpu"))):
        con.register("t", {"a": [1, 2, 3]})
        got[pkg] = list(con.execute("SELECT a FROM t").fetchnumpy()["a"])
    assert got["port"] == got["ref"] == [1, 2, 3]


def _files(tmp_path, name, text):
    for pkg in ("ref", "port"):
        (tmp_path / "run" / pkg).mkdir(parents=True, exist_ok=True)
        with open(tmp_path / "run" / pkg / name, "w", newline="") as f:
            f.write(text)


def _run(tmp_path, steps, files=()):
    run_dir = tmp_path / "run"
    run_dir.mkdir(exist_ok=True)
    dirs = {}
    cons = {"ref": ddb_tpu.connect(), "port": ddb_tpu_torch.connect("cpu")}
    for pkg in cons:
        dirs[pkg] = run_dir / pkg
        dirs[pkg].mkdir(exist_ok=True)
    for i, step in enumerate(steps):
        got = {}
        for pkg, con in cons.items():
            if isinstance(step, T_):
                s = typed(step.sql.format(d=dirs[pkg]))
            elif isinstance(step, str):
                s = step.format(d=dirs[pkg])
            else:
                s = step
            got[pkg] = outcome_of(con, s)
        same_outcome(got["ref"], got["port"], f"step {i}: {step}")
    for name in files:
        with open(dirs["ref"] / name, "rb") as f:
            want = f.read()
        with open(dirs["port"] / name, "rb") as f:
            assert f.read() == want, name
    return cons, dirs


def test_sniffer_pipe_no_header(tmp_path):
    _files(tmp_path, "pipe.csv", "1|foo|2020-01-01|1.5\n2|bar|2021-06-30|2.5\n")
    _run(tmp_path, [T_("SELECT * FROM read_csv('{d}/pipe.csv') ORDER BY 1"),
                    T_("SELECT * FROM sniff_csv('{d}/pipe.csv')")])


def test_sniffer_semicolon_header(tmp_path):
    _files(tmp_path, "semi.csv", "id;name;score\n1;alice;3.5\n2;bob;4.0\n")
    _run(tmp_path, [T_("SELECT id, name, score FROM read_csv("
                       "'{d}/semi.csv') ORDER BY id")])


def test_read_csv_named_args(tmp_path):
    _files(tmp_path, "t.tsv", "a\tb\n10\t20\n30\t40\n")
    _run(tmp_path, [T_("SELECT * FROM read_csv('{d}/t.tsv', delim='\t',"
                       " header=true) ORDER BY 1")])


def test_copy_from_sniffed_typed(tmp_path):
    _files(tmp_path, "pipe2.csv", "1|foo|2020-01-01|1.50\n")
    _run(tmp_path, [
        "CREATE TABLE c1 (i INTEGER, s VARCHAR, d DATE, v DECIMAL(12,2))",
        "COPY c1 FROM '{d}/pipe2.csv'",
        T_("SELECT * FROM c1")])


# ---- tests/test_export_db.py ----------------------------------------------

_MKDB = [
    "CREATE TYPE mood AS ENUM ('ok','sad')",
    "CREATE SEQUENCE sq START 5 INCREMENT 2",
    "CREATE TABLE p(id INTEGER PRIMARY KEY, name VARCHAR NOT NULL, "
    "sc DECIMAL(10,2))",
    "CREATE TABLE c(pid INTEGER REFERENCES p(id), m mood, t TIMESTAMPTZ)",
    "INSERT INTO p VALUES (1,'a',1.25), (2,'b',NULL)",
    "INSERT INTO c VALUES (1,'ok','2024-01-01 05:00:00+00'), "
    "(NULL,'sad',NULL)",
    "CREATE VIEW pv AS SELECT id FROM p WHERE id > 1",
]


@pytest.mark.parametrize("opts,ext", [
    ("(FORMAT csv, DELIMITER '|', HEADER false)", "csv"),
    ("(FORMAT csv)", "csv"),
    ("(FORMAT PARQUET)", "parquet"),
])
def test_export_import_roundtrip(tmp_path, opts, ext):
    if ext == "parquet":
        pytest.importorskip("pyarrow.parquet")
    cons, dirs = _run(tmp_path, _MKDB + [
        "EXPORT DATABASE '{d}/exp' " + opts])
    for pkg, con in cons.items():
        d = dirs[pkg] / "exp"
        assert os.path.exists(d / "schema.sql")
        assert os.path.exists(d / "load.sql")
    # the schema and every data file but the load script's paths agree
    for name in ("schema.sql",) + ((("p.csv", "c.csv")) if ext == "csv"
                                   else ()):
        want = (dirs["ref"] / "exp" / name).read_bytes()
        assert (dirs["port"] / "exp" / name).read_bytes() == want, name
    want = (dirs["ref"] / "exp" / "load.sql").read_text().replace(
        str(dirs["ref"]), "D")
    got = (dirs["port"] / "exp" / "load.sql").read_text().replace(
        str(dirs["port"]), "D")
    assert got == want
    # IMPORT into new connections of each package
    steps = ["IMPORT DATABASE '{d}/exp'",
             T_("SELECT * FROM p ORDER BY id"),
             T_("SELECT * FROM c ORDER BY pid"),
             T_("SELECT * FROM pv"),
             "INSERT INTO c VALUES (99, 'ok', NULL)",
             "INSERT INTO p VALUES (1, 'dup', NULL)",
             "SELECT nextval('sq')", "SELECT nextval('sq')"]
    cons2 = {"ref": ddb_tpu.connect(), "port": ddb_tpu_torch.connect("cpu")}
    outs = {pkg: [outcome_of(con, typed(s.sql.format(d=dirs[pkg]))
                          if isinstance(s, T_) else s.format(d=dirs[pkg]))
                  for s in steps] for pkg, con in cons2.items()}
    for i, (w, g) in enumerate(zip(outs["ref"], outs["port"])):
        same_outcome(w, g, f"import step {i}: {steps[i]}")
    assert outs["port"][3] == ("value", (["INTEGER"], [(2,)]))
    assert outs["port"][4][0] == outs["port"][5][0] == "raises"
    assert [o[2] for o in outs["port"][6:]] == [[(5,)], [(7,)]]
    # the rows read back equal the exported connection's
    for sql in ("SELECT * FROM p ORDER BY id", "SELECT * FROM c ORDER BY pid"):
        assert cons2["port"].execute(sql).fetchall() == \
            cons["port"].execute(sql).fetchall()


# ---- tests/test_cachefs.py --------------------------------------------------

class FakeFS:
    """fsspec-shaped mock 'remote' filesystem over a local directory."""

    def __init__(self, root):
        self.root = root
        self.opens = 0

    def open(self, path, mode="rb"):
        self.opens += 1
        return open(os.path.join(self.root, path), mode)

    def modified(self, path):
        return os.path.getmtime(os.path.join(self.root, path))


@pytest.fixture()
def remote(tmp_path):
    roots, fss = {}, {}
    for pkg, mod in (("ref", ref_cachefs), ("port", port_cachefs)):
        root = tmp_path / "remote" / pkg
        root.mkdir(parents=True)
        (root / "t.csv").write_text("a,b\n1,2\n3,4\n")
        fss[pkg] = FakeFS(str(root))
        roots[pkg] = root
        mod.register_filesystem("mock", fss[pkg])
    yield fss, roots
    for mod in (ref_cachefs, port_cachefs):
        mod.unregister_filesystem("mock")
        mod.clear_cache()


def test_remote_read_and_cache_hit(remote):
    fss, _ = remote
    cons = {"ref": ddb_tpu.connect(), "port": ddb_tpu_torch.connect("cpu")}
    got = {}
    for pkg, con in cons.items():
        mod = ref_cachefs if pkg == "ref" else port_cachefs
        r = outcome_of(con, typed("select * from read_csv_auto('mock://t.csv') "
                               "order by a"))
        opens = fss[pkg].opens
        before = dict(mod.STATS)
        r2 = outcome_of(con, typed("select sum(b) from "
                                "read_csv_auto('mock://t.csv')"))
        got[pkg] = (r, opens, r2, fss[pkg].opens,
                    mod.STATS["hits"] > before["hits"])
    assert got["port"] == got["ref"]
    assert got["port"][1] == got["port"][3] == 1 and got["port"][4]


def test_cache_revalidates_on_change(remote):
    fss, roots = remote
    cons = {"ref": ddb_tpu.connect(), "port": ddb_tpu_torch.connect("cpu")}
    got = {}
    for pkg, con in cons.items():
        con.execute("select * from read_csv_auto('mock://t.csv')")
        (roots[pkg] / "t.csv").write_text("a,b\n9,9\n")
        os.utime(roots[pkg] / "t.csv", (1e9, 2e9))
        got[pkg] = (outcome_of(con, typed(
            "select * from read_csv_auto('mock://t.csv')")), fss[pkg].opens)
    assert got["port"] == got["ref"]
    assert got["port"][1] == 2


def test_unregistered_scheme_errors():
    for con in (ddb_tpu.connect(), ddb_tpu_torch.connect("cpu")):
        with pytest.raises(Exception, match="no filesystem registered"):
            con.execute("select * from read_csv_auto('nope://x.csv')")


# ---- test_system.py, test_lists.py, test_nested_cast.py -------------------

def test_read_csv_table_function(tmp_path):
    _files(tmp_path, "x.csv", "a,b\n1,x\n2,y\n")
    _run(tmp_path, [T_("SELECT * FROM read_csv('{d}/x.csv') ORDER BY a")])


def test_nested_arrow_parquet_roundtrip(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pytest.importorskip("pyarrow.parquet")

    def nested_table():
        return {"id": [1, 2, 3],
                "s": [{"x": 10, "y": "a"}, {"x": 20, "y": "b"}, None],
                "m": pa.array([[("a", 1)], [("b", 2), ("c", 3)], None],
                              type=pa.map_(pa.string(), pa.int64()))}

    cons, dirs = _run(tmp_path, [
        lambda con: con.register("t", pa.table(nested_table())) and None,
        T_("SELECT id, s, m FROM t ORDER BY id"),
        "COPY (SELECT id, s, m FROM t) TO '{d}/n.parquet' (FORMAT parquet)",
        "CREATE TABLE t2 AS SELECT * FROM read_parquet('{d}/n.parquet')",
        T_("SELECT id, s.x, m['b'] FROM t2 ORDER BY id")])
    for con in cons.values():
        at = con.execute("SELECT id, s, m FROM t ORDER BY id").arrow()
        assert pa.types.is_struct(at.schema.field("s").type)
        assert pa.types.is_map(at.schema.field("m").type)
    assert cons["port"].execute("SELECT id, s.x, m['b'] FROM t2 ORDER BY id"
                                ).fetchall() == [(1, 10, None), (2, 20, 2),
                                                 (3, None, None)]


def test_copy_nested_roundtrip(tmp_path):
    cons, _ = _run(tmp_path, [
        "CREATE TABLE L AS SELECT [1,2,3] v, 'x' s",
        "COPY L TO '{d}/l.csv'",
        "CREATE TABLE L2 (v INT[], s VARCHAR)",
        "COPY L2 FROM '{d}/l.csv'",
        T_("SELECT v, s FROM L2")], files=["l.csv"])
    assert cons["port"].execute("SELECT v, s FROM L2").fetchall() == \
        [([1, 2, 3], "x")]


# ---- COPY TO: the bytes of each type, and the options ----------------------

_TYPES = [
    "CREATE TABLE w (i INTEGER, b BIGINT, t TINYINT, d DOUBLE, f FLOAT, "
    "k DECIMAL(18,3), q DECIMAL(4,0), dt DATE, ts TIMESTAMP, tm TIME, "
    "bo BOOLEAN, s VARCHAR, e mood)",
    "INSERT INTO w VALUES "
    "(1, 9223372036854775807, -128, 100.0, 1.5, -12.345, 7, '2020-01-02', "
    "'2020-01-02 03:04:05.000006', '03:04:05.5', true, 'a\"b', 'ok'), "
    "(NULL, -9223372036854775808, 0, 1e15, -0.25, 0.001, -7, '1999-12-31', "
    "'1970-01-01 00:00:00', '00:00:00', false, '', 'sad'), "
    "(-5, 0, 127, 0.00001, NULL, NULL, NULL, NULL, NULL, NULL, NULL, NULL, "
    "NULL), "
    "(0, 1, 1, -0.0, 3.4e38, 0, 0, '0001-01-01', '9999-12-31 23:59:59', "
    "'23:59:59.999999', true, 'x,y\ny', 'ok'), "
    "(2, 2, 2, 12.345678, 1e-7, 1, 1, '2024-02-29', '2024-02-29 12:00:00', "
    "'12:00:00', false, 'é', 'ok'), "
    "(3, 3, 3, 0.30000000000000004, 2.5, 2, 2, '2000-01-01', "
    "'2000-01-01 00:00:00.1', '01:02:03', true, 'NULL', 'sad')",
]


@pytest.mark.parametrize("opts", ["", "(DELIMITER '|', HEADER false)",
                                  "(HEADER false)", "(DELIMITER '\t')"])
def test_copy_to_writes_the_reference_bytes(tmp_path, opts):
    _run(tmp_path, ["CREATE TYPE mood AS ENUM ('ok','sad')"] + _TYPES + [
        "COPY w TO '{d}/w.csv' " + opts,
        "COPY (SELECT d, d * 3, d + 1, s FROM w ORDER BY i) TO "
        "'{d}/q.csv' " + opts], files=["w.csv", "q.csv"])


def test_copy_doubles_write_the_reference_bytes(tmp_path):
    """Doubles on and off the device's shortest-digits path: powers of
    ten at both ends of the positional range, subnormals, 1e+-16 and
    1e+-21, random 17-digit values and values of 6 decimals."""
    rng = np.random.default_rng(7)
    vals = [100.0, 1e15, 1e-5, -0.0, 1e20, 12.345678, 1e9, 1e10, 1e-6,
            1e-7, 5e-324, 2.2250738585072014e-308, 1e-16, 1e16, 1e-21,
            1e21, 1.7976931348623157e308, 9.5, 0.1 + 0.2, float("inf"),
            -float("inf"), float("nan")]
    vals += list(rng.uniform(-1e3, 1e3, 300))
    vals += list(np.round(rng.uniform(0, 100, 300), 6))
    vals += list(10.0 ** rng.uniform(-30, 30, 300))
    # the longest text: a minus, '0.', five zeros and 17 digits
    vals += list(-(10.0 ** rng.uniform(-6, -5, 100)))
    _run(tmp_path, [
        lambda con: con.register("f", {"x": np.array(vals)}) and None,
        "COPY f TO '{d}/f.csv'"], files=["f.csv"])


def test_writer_zoned_stamps_and_intervals_match(tmp_path):
    """TIMESTAMPTZ columns: the reference's Arrow table carries a UTC
    time zone, so its writer appends 'Z'; the port writes the same.  An
    INTERVAL without months writes its microseconds; a calendar interval
    raises in both (pyarrow has no text for month_day_nano)."""
    _run(tmp_path, [
        "CREATE TABLE z (t TIMESTAMPTZ, iv INTERVAL)",
        "INSERT INTO z VALUES ('2024-01-01 05:00:00+00', INTERVAL 3 SECOND), "
        "(NULL, NULL)",
        "COPY z TO '{d}/z.csv'",
        "CREATE TABLE z2 (iv INTERVAL)",
        "INSERT INTO z2 VALUES (INTERVAL 1 MONTH)",
        "COPY z2 TO '{d}/z2.csv'"], files=["z.csv"])


def test_copy_row_count_and_reload(tmp_path):
    _run(tmp_path, ["CREATE TYPE mood AS ENUM ('ok','sad')"] + _TYPES + [
        "COPY w TO '{d}/w.csv'",
        "CREATE TABLE w2 AS SELECT * FROM w WHERE false",
        "COPY w2 FROM '{d}/w.csv'",
        T_("SELECT * FROM w2 ORDER BY i, b"),
        T_("SELECT * FROM read_csv_auto('{d}/w.csv') ORDER BY i, b"),
        "COPY (SELECT i, s FROM w) TO '{d}/p.csv' (DELIMITER '|', "
        "HEADER false)",
        "CREATE TABLE w3 (i INTEGER, s VARCHAR)",
        "COPY w3 FROM '{d}/p.csv' (DELIMITER '|', HEADER false)",
        T_("SELECT * FROM w3 ORDER BY i, s")], files=["w.csv", "p.csv"])


def test_relation_entry_points(tmp_path):
    _files(tmp_path, "r.csv", "a,b\n1,x\n2,y\n")
    cons, dirs = _run(tmp_path, [])
    got = {pkg: con.from_csv_auto(str(dirs[pkg] / "r.csv")).fetchall()
           for pkg, con in cons.items()}
    assert got["port"] == got["ref"] == [(1, "x"), (2, "y")]
    if pytest.importorskip("pyarrow.parquet"):
        for pkg, con in cons.items():
            con.execute(f"COPY (SELECT * FROM read_csv_auto("
                        f"'{dirs[pkg]}/r.csv')) TO '{dirs[pkg]}/r.parquet'"
                        f" (FORMAT parquet)")
            con.read_parquet("rp", str(dirs[pkg] / "r.parquet"))
        got = {pkg: (con.from_parquet(str(dirs[pkg] / "r.parquet"))
                     .fetchall(),
                     con.execute("SELECT * FROM rp ORDER BY a").fetchall())
               for pkg, con in cons.items()}
        assert got["port"] == got["ref"]


# ---- COPY FROM's append: dml.append_table against the reference's --------

def _appended(dml, target, source):
    import copy
    td = copy.deepcopy(target)
    try:
        dml.append_table(td, copy.deepcopy(source).columns)
    except OverflowError as e:
        return ("raises", type(e).__name__)
    cols = []
    for c in td.columns:
        cols.append((c.name, repr(c.dtype), c.data.dtype.str,
                     c.data.tolist(),
                     None if c.nulls is None else c.nulls.tolist(),
                     None if c.strdict is None else
                     list(c.strdict.values if hasattr(c.strdict, "values")
                          else c.strdict.items),
                     repr(c.stats)))
    return cols, td.version, td.last_op


def _tables(pkg, seed, target_rows, overflow=False, nested=False):
    """(target, source) tables of `pkg` (ddb_tpu or ddb_tpu_torch), the
    same values in both packages for one seed."""
    import importlib
    T = importlib.import_module(pkg + ".types")
    StringDictionary = importlib.import_module(
        pkg + ".storage.strings").StringDictionary
    table = importlib.import_module(pkg + ".storage.table")
    lists = importlib.import_module(pkg + ".storage.lists")
    rng = np.random.default_rng(seed)

    def make(n, words, wide):
        nl = rng.random(n) < 0.2
        sd, codes, _ = StringDictionary.encode(
            [None if nl[i] else words[i % len(words)] for i in range(n)])
        days = rng.integers(-719162, 2932897, n)
        days[:2] = [-719162, 2932896][:n] if n >= 2 else days[:2]
        us = rng.integers(-62135596800000000, 253402300799999999, n)
        ints = rng.integers(-2**40, 2**40, n) if wide and overflow \
            else rng.integers(-1000, 1000, n)
        cols = [
            table.TableColumn("i", T.BIGINT if wide else T.INTEGER,
                              ints.astype(np.int64 if wide else np.int32),
                              nl.copy() if nl.any() else None),
            table.TableColumn("s", T.VARCHAR, codes,
                              nl if nl.any() else None, strdict=sd),
            table.TableColumn("d", T.DECIMAL(15, 2),
                              rng.integers(-10**6, 10**6, n)),
            table.TableColumn("dt", T.DATE, days.astype(np.int32)),
            table.TableColumn("ts", T.TIMESTAMP, us),
            table.TableColumn("x", T.DOUBLE, rng.standard_normal(n)),
            table.TableColumn("b", T.BOOLEAN, rng.random(n) < 0.5)]
        if nested:
            # a LIST column: the row-by-row path of both packages
            store = lists.ListStore()
            ids = np.array([store.add([int(v), int(v) + 1])
                            for v in rng.integers(0, 9, n)], dtype=np.int32)
            cols.append(table.TableColumn("l", T.LIST(T.BIGINT), ids,
                                          strdict=store))
        return table.TableData("t", cols)

    return make(target_rows, ["p", "q", "zz"], False), \
        make(50, ["q", "a", "é", "zz", ""], True)


@pytest.mark.parametrize("seed,target_rows,overflow,nested", [
    (1, 0, False, False), (2, 30, False, False), (3, 1, False, False),
    (4, 10, True, False), (5, 20, False, True)])
def test_append_columns_equals_dml_append_table(monkeypatch, seed,
                                                target_rows, overflow,
                                                nested):
    """COPY FROM's and INSERT ... SELECT's append (the port's
    storage/dml.py:append_table, which appends columns whole where their
    types allow it) leaves the table the reference's row-by-row
    append_table leaves, or raises as it does."""
    from ddb_tpu.storage import dml as ref_dml
    from ddb_tpu_torch.storage import dml
    want = _appended(ref_dml, *_tables("ddb_tpu", seed, target_rows,
                                       overflow, nested))
    if not nested:
        # the whole-column path: no Python values
        def refuse(*a, **k):
            raise AssertionError("row-by-row append")
        monkeypatch.setattr(dml, "insert_rows", refuse)
    got = _appended(dml, *_tables("ddb_tpu_torch", seed, target_rows,
                                  overflow, nested))
    assert got == want


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 1), (300, 2)])
def test_from_arrow_equals_the_reference(n, seed):
    """storage/table.py:from_arrow takes decimal128 words and Arrow's
    string dictionary whole: the reference's tables, NULLs included."""
    pa = pytest.importorskip("pyarrow")
    import decimal
    from ddb_tpu.storage.table import from_arrow as ref_from_arrow
    from ddb_tpu_torch.storage.table import from_arrow
    rng = np.random.default_rng(seed)
    nl = rng.random(n) < 0.3
    dec = [None if nl[i] else decimal.Decimal(int(v)).scaleb(-2)
           for i, v in enumerate(rng.integers(-10**15, 10**15, n))]
    words = ["b", "a", "é", "", "zz"]
    strs = [None if nl[i] else words[i % 5] for i in range(n)]
    at = pa.table({"d": pa.array(dec, pa.decimal128(15, 2)),
                   "s": pa.array(strs, pa.string()),
                   "s2": pa.array([w for w in strs if w is not None]
                                  + [None] * int(nl.sum()), pa.string()),
                   "ls": pa.array(strs, pa.large_string())}).slice(
        min(n, 1))
    want, got = ref_from_arrow("t", at), from_arrow("t", at)
    for w, g in zip(want.columns, got.columns, strict=True):
        assert (w.name, repr(w.dtype)) == (g.name, repr(g.dtype))
        assert w.data.dtype == g.data.dtype and \
            np.array_equal(w.data, g.data), w.name
        assert (w.nulls is None) == (g.nulls is None)
        if w.nulls is not None:
            assert np.array_equal(w.nulls, g.nulls)
        if w.strdict is not None:
            assert list(w.strdict.values) == list(g.strdict.values)
            assert w.strdict.values.dtype == g.strdict.values.dtype


# ---- VALUES in FROM, typed without pyarrow --------------------------------

VALUES_CORPUS = [
    "SELECT * FROM (VALUES (1, 'a'), (2, 'b')) t(x, y)",
    "SELECT * FROM (VALUES (1), (2.5)) t(x)",
    "SELECT * FROM (VALUES (1.5::DOUBLE), (2)) t(x)",
    "SELECT * FROM (VALUES (0.1), (123.456), (NULL)) t(x)",
    "SELECT * FROM (VALUES ('x'), (NULL), ('é')) t(x)",
    "SELECT * FROM (VALUES (DATE '2020-01-02'), (NULL)) t(x)",
    "SELECT * FROM (VALUES (TIMESTAMP '2020-01-02 03:04:05'), (NULL)) t(x)",
    "SELECT * FROM (VALUES (NULL), (NULL)) t(x)",
    "SELECT * FROM (VALUES ([1, 2]), ([3]), (NULL)) t(x)",
    "SELECT * FROM (VALUES ({'a': 1}), ({'a': 2})) t(x)",
    "SELECT * FROM (VALUES (true), (false), (NULL)) t(x)",
    "SELECT * FROM (VALUES (9223372036854775807), (-1)) t(x)",
]


def test_values_in_from_without_pyarrow():
    """The binder's VALUES seam (storage/table.py:_column_from_values):
    with pyarrow, pandas, jax and ddb_tpu blocked, the port types the
    columns of every VALUES statement as the reference does through
    pyarrow, and gives its rows."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ref = ddb_tpu.connect()
    want = []
    for sql in VALUES_CORPUS:
        r = ref.execute(sql)
        want.append(repr(([repr(t) for t in r.column_types], r.fetchall())))
    code = (
        "import sys\n"
        "for m in ('jax', 'pyarrow', 'pandas', 'ddb_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import ddb_tpu_torch, json\n"
        "con = ddb_tpu_torch.connect('cpu')\n"
        "out = []\n"
        f"for sql in {VALUES_CORPUS!r}:\n"
        "    r = con.execute(sql)\n"
        "    out.append(repr(([repr(t) for t in r.column_types], "
        "r.fetchall())))\n"
        "print(json.dumps(out))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    import json
    got = json.loads(res.stdout.strip().splitlines()[-1])
    for sql, w, g in zip(VALUES_CORPUS, want, got, strict=True):
        assert g == w, sql


@pytest.mark.parametrize("v", [5, 9 * 10**18])
def test_copy_of_a_wide_sum_matches_the_reference(tmp_path, v):
    """A SUM of BIGINTs is a HUGEINT.  Within int64 both packages write
    the same bytes; past it both raise OverflowError: the reference's
    writer takes int64 (ROADMAP fault 3.24, closed)."""
    steps = ["CREATE TABLE t (v BIGINT)",
             f"INSERT INTO t VALUES ({v}), ({v})",
             "COPY (SELECT sum(v) AS s FROM t) TO '{d}/s.csv'"]
    big = v > 2**62
    cons, dirs = _run(tmp_path, steps, files=[] if big else ["s.csv"])
    last = outcome(cons["port"], steps[-1].format(d=dirs["port"]))
    assert last == (("raises", "OverflowError") if big
                    else ("rows", ["Count"], [(1,)]))

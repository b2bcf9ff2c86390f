"""Database files through ddb_tpu.connect() (JAX on the CPU) and
ddb_tpu_torch.connect(device="cpu"): save, load, ATTACH/DETACH and
CHECKPOINT (storage/persist.py over native/dtbfile.cpp; the port's copy
differs only where it builds the library).  The same steps run through both packages and every
step's rows, or the class name of the exception it raises, are compared.

Ported here: the cases of the reference's tests/test_persist.py (but for
the two buffer-manager cases, which tests/test_torch_spill.py holds),
test_constraints_survive_save_load and test_enum_persists (test_dml.py),
test_sequence_persist_roundtrip and test_default_survives_checkpoint
(test_dependencies.py), test_attach_detach (test_statements.py),
test_macro_persistence (test_macro.py) and test_index_persists
(test_index.py).  Also: a file either package writes loads in the other
with the same rows, and the checkpoint -> WAL -> recovery sequence of
chip_smoke.py phase 18 at a small size against a numpy oracle."""

import os

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from test_torch_dml import outcome, same_outcome
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401


class Pkg:
    """One package's connect(), with file names of its own."""

    def __init__(self, name, tmp_path):
        self.name = name
        self.tmp = tmp_path

    def path(self, name):
        """`name` in a directory of this package's own."""
        (self.tmp / self.name).mkdir(exist_ok=True)
        return str(self.tmp / self.name / name)

    def connect(self, path=None):
        if self.name == "ref":
            return ddb_tpu.connect(path)
        return ddb_tpu_torch.connect("cpu", path)

    def connection(self):
        """A bare Connection, as the reference's tests build one."""
        if self.name == "ref":
            return ddb_tpu.Connection()
        return ddb_tpu_torch.Connection("cpu")


def compare(case, tmp_path):
    """Run `case(pkg)` (a list of outcomes) for both packages."""
    want = case(Pkg("ref", tmp_path))
    got = case(Pkg("port", tmp_path))
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        if isinstance(w, tuple) and w and w[0] in ("rows", "raises", "none",
                                                   "value"):
            same_outcome(w, g, f"{case.__name__}: outcome {i}")
        else:
            assert w == g, (case.__name__, i, w, g)
    return want


def run(con, *steps):
    return [outcome(con, s) for s in steps]


# ---- tests/test_persist.py -------------------------------------------------

def save_load_roundtrip(p):
    path = p.path("db.dtb")
    con = p.connect()
    out = run(con, "CREATE TABLE t (a INTEGER, s VARCHAR, d DECIMAL(10,2))",
              "INSERT INTO t VALUES (1, 'hello', 1.25), "
              "(2, NULL, 2.50), (3, 'world', NULL)",
              "CREATE VIEW v AS SELECT a FROM t WHERE a > 1")
    con.save(path)
    con2 = p.connect(path)
    return out + run(con2, "SELECT * FROM t ORDER BY a",
                     "SELECT count(*) FROM v")


def atomic_overwrite(p):
    path = p.path("db.dtb")
    con = p.connect()
    run(con, "CREATE TABLE t (a INTEGER)", "INSERT INTO t VALUES (1)")
    con.save(path)
    run(con, "INSERT INTO t VALUES (2)")
    con.save(path)
    return run(p.connect(path), "SELECT count(*) FROM t")


def corruption_detected(p):
    path = p.path("db.dtb")
    con = p.connect()
    run(con, "CREATE TABLE t (a INTEGER)", "INSERT INTO t VALUES (42)")
    con.save(path)
    data = bytearray(open(path, "rb").read())
    data[-2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    con2 = p.connect()
    with pytest.raises(IOError):
        con2.load(path)
    return [con2._invalidated is not None,
            outcome(con2, "SELECT 1")]


def missing_file(p):
    with pytest.raises(IOError):
        p.connect().load(p.path("definitely_missing.dtb"))
    return []


def compressed_blobs_roundtrip(p):
    path = p.path("c.dtb")
    con = p.connect()
    rows = ",".join(f"({i % 100},{i * 1000},'name{i % 50}')"
                    for i in range(2000))
    run(con, "CREATE TABLE t (a INTEGER, b BIGINT, s VARCHAR)",
        f"INSERT INTO t VALUES {rows}")
    con.save(path)
    con2 = p.connect()
    con2.load(path)
    return [os.path.getsize(path) < 2000 * (4 + 8 + 4) // 2,
            os.path.getsize(path)] \
        + run(con2, "SELECT count(*), sum(a), sum(b), min(s) FROM t")


def many_types(p):
    """Every physical kind a column can have: NULLs in each, dates,
    timestamps, doubles, booleans and a wide decimal.  A LIST column
    cannot be saved by either package (the copied save_database reads a
    ListStore as a string dictionary; ROADMAP fault 3.16)."""
    path = p.path("types.dtb")
    con = p.connect()
    run(con, "CREATE TABLE t (i TINYINT, s SMALLINT, b BIGINT, f DOUBLE, "
             "r REAL, k BOOLEAN, d DATE, ts TIMESTAMP, w DECIMAL(18,4), "
             "v VARCHAR)",
        "INSERT INTO t VALUES (1, 2, 3, 1.5, 2.5, true, DATE '2024-02-29', "
        "TIMESTAMP '2024-01-02 03:04:05.678', 12345678901234.5678, 'é')",
        "INSERT INTO t VALUES (NULL, NULL, NULL, NULL, NULL, NULL, NULL, "
        "NULL, NULL, NULL)",
        "INSERT INTO t VALUES (-1, -2, -3, -0.25, 0.5, false, "
        "DATE '1969-12-31', TIMESTAMP '1969-12-31 23:59:59', -0.0001, '')")
    con.save(path)
    out = run(p.connect(path), "SELECT * FROM t ORDER BY i NULLS LAST",
              "DESCRIBE t")
    run(con, "CREATE TABLE l (x INTEGER[])", "INSERT INTO l VALUES ([1])")
    return out + [outcome(con, lambda c: c.save(p.path("list.dtb")))]


# ---- the cases that needed a database file ---------------------------------

def constraints_survive_save_load(p):
    path = p.path("k.dtb")
    c = p.connection()
    run(c, "CREATE TABLE k (id INTEGER PRIMARY KEY)",
        "INSERT INTO k VALUES (1)")
    c.save(path)
    c2 = p.connection()
    c2.load(path)
    return run(c2, "INSERT INTO k VALUES (1)", "SELECT * FROM k")


def enum_persists(p):
    path = p.path("e.dtb")
    c = p.connection()
    run(c, "CREATE TYPE lvl AS ENUM ('lo', 'hi')", "CREATE TABLE t (x lvl)",
        "INSERT INTO t VALUES ('lo')")
    c.save(path)
    c2 = p.connection()
    c2.load(path)
    return run(c2, "INSERT INTO t VALUES ('mid')",
               "INSERT INTO t VALUES ('hi')", "SELECT * FROM t ORDER BY x")


def sequence_persist_roundtrip(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "CREATE SEQUENCE s START 100",
        "CREATE TABLE t (id INTEGER DEFAULT nextval('s'), v INTEGER)",
        "INSERT INTO t (v) VALUES (1), (2)")
    con.checkpoint()
    con2 = p.connect(path)
    return run(con2, "INSERT INTO t (v) VALUES (3)",
               "SELECT id, v FROM t ORDER BY id")


def default_survives_checkpoint(p):
    path = p.path("db.dtb")
    con = p.connect(path)
    run(con, "CREATE TABLE t (a INTEGER, b INTEGER DEFAULT 9)")
    con.checkpoint()
    con2 = p.connect(path)
    return run(con2, "INSERT INTO t (a) VALUES (1)", "SELECT * FROM t")


def attach_detach(p):
    path = p.path("db.dtb")
    con = p.connection()
    run(con, "CREATE TABLE t (a INTEGER, b VARCHAR)",
        "INSERT INTO t VALUES (1,'x'),(2,'y'),(3,'z')",
        "CREATE VIEW vt AS SELECT b FROM t WHERE a > 1")
    con.save(path)
    c2 = p.connection()
    return run(c2, f"ATTACH '{path}' AS other",
               "SELECT a FROM other.t ORDER BY a",
               "SELECT * FROM other.vt ORDER BY b",
               "SELECT database_name FROM duckdb_databases() ORDER BY 1",
               f"ATTACH '{path}'",
               "SELECT count(*) FROM " + os.path.basename(path)[:-4] + ".t",
               "DETACH other",
               "SELECT * FROM other.t",
               "DETACH other",
               "ATTACH ':memory:' AS scratch",
               "SELECT database_name FROM duckdb_databases() ORDER BY 1")


def macro_persistence(p):
    path = p.path("m.dtb")
    c = p.connect(path)
    run(c, "CREATE MACRO m1(x) AS x * 10")
    c.checkpoint()
    return run(p.connect(path), "SELECT m1(4)")


def index_persists(p):
    path = p.path("ix.dtb")
    c = p.connect()
    run(c, "CREATE TABLE t (id INTEGER, v INTEGER)",
        "INSERT INTO t VALUES (1, 10), (2, 20)",
        "CREATE UNIQUE INDEX tid ON t(id)")
    c.save(path)
    c2 = p.connect()
    c2.load(path)
    return run(c2, "SELECT index_name, is_unique FROM duckdb_indexes()",
               "INSERT INTO t VALUES (1, 99)", "SELECT * FROM t WHERE id = 2")


CASES = [save_load_roundtrip, atomic_overwrite, corruption_detected,
         missing_file, compressed_blobs_roundtrip, many_types,
         constraints_survive_save_load, enum_persists,
         sequence_persist_roundtrip, default_survives_checkpoint,
         attach_detach, macro_persistence, index_persists]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_matches_reference(case, tmp_path):
    compare(case, tmp_path)


def test_codecs_roundtrip_as_the_reference():
    """test_round5_codecs_roundtrip: the copied codec search picks the
    same codec and payload as the reference's on the same bytes."""
    from ddb_tpu.storage import persist as ref
    from ddb_tpu_torch.storage import persist as port
    lib = port._load_lib()
    rng = np.random.default_rng(0)
    blobs = [
        (rng.integers(1000, 1200, 50_000).astype(np.int64).tobytes(),
         "ints", 8, port._BITPACK),
        (np.round(rng.uniform(0, 1000, 50_000), 2).tobytes(), "floats", 8,
         port._ALP),
        (rng.standard_normal(20_000).tobytes(), "floats", 8, None),
        (np.where(np.arange(300_000) % 3000 == 0, 1, 0).astype(np.uint8)
         .tobytes(), "mask", 0, port._ROARING),
        (rng.integers(0, 2, 200_000).astype(np.uint8).tobytes(), "mask", 0,
         None),
        (np.arange(100_000, dtype=np.int32).tobytes(), "ints", 4,
         port._DELTA),
    ]
    for data, kind, elem, codec in blobs:
        got = port._compress_blob(lib, data, kind, elem)
        assert got == ref._compress_blob(ref._load_lib(), data, kind, elem)
        if codec is not None:
            assert got[0] == codec
        assert port._decompress_blob(lib, got[0], got[1], len(data),
                                     elem) == data


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_file_loads_in_the_other_package(tmp_path, writer):
    setup = ["CREATE TYPE mood AS ENUM ('sad', 'ok')",
             "CREATE SEQUENCE sq START 7",
             "CREATE TABLE t (a INTEGER PRIMARY KEY, s VARCHAR, "
             "d DECIMAL(12,2), m mood, x DOUBLE DEFAULT 1.5)",
             "INSERT INTO t VALUES (1, 'a', 1.25, 'ok', 0.5), "
             "(2, NULL, NULL, 'sad', NULL), (3, 'c', -3.5, NULL, 2.0)",
             "CREATE UNIQUE INDEX ts ON t(s)",
             "CREATE VIEW v AS SELECT a, d FROM t WHERE a > 1",
             "CREATE MACRO twice(x) AS 2 * x",
             "CREATE SCHEMA s2", "CREATE TABLE s2.u AS SELECT a FROM t"]
    reads = ["SELECT * FROM t ORDER BY a", "SELECT * FROM v ORDER BY a",
             "SELECT twice(a) FROM s2.u ORDER BY 1",
             "SELECT nextval('sq')",
             "INSERT INTO t (a, s) VALUES (4, 'd')",
             "SELECT a, x FROM t ORDER BY a",
             "INSERT INTO t VALUES (1, 'z', 0, 'ok', 0)",
             "INSERT INTO t VALUES (5, 'a', 0, 'ok', 0)",
             "INSERT INTO t VALUES (6, 'f', 0, 'meh', 0)"]
    path = str(tmp_path / "x.dtb")
    src = ddb_tpu.connect() if writer == "ref" \
        else ddb_tpu_torch.connect("cpu")
    run(src, *setup)
    src.save(path)
    ref, port = ddb_tpu.connect(), ddb_tpu_torch.connect("cpu")
    ref.load(path)
    port.load(path)
    for step in reads:
        same_outcome(outcome(ref, step), outcome(port, step), step)


# ---- chip_smoke.py phase 18a -> 18c at a small size ------------------------

def test_checkpoint_wal_recovery_against_numpy(tmp_path):
    """Register synthetic lineitem, CHECKPOINT, then the WAL's mutations
    (an INSERT ... SELECT, a DELETE and an UPDATE of one day each), a
    crash, and recovery: TPC-H Q1 and Q6 equal the kernels' plain
    versions over the recovered columns and the numpy oracle of the same
    mutations, streamed in tiles and resident; the reference reads the
    port's files to the same answers."""
    import chip_smoke
    from ddb_tpu_torch.ops import fused_agg as F
    rows, new = 20_000, 500
    path = str(tmp_path / "sf.dtb")
    con = ddb_tpu_torch.connect("cpu", path)
    host = chip_smoke.durable_lineitem(con, rows, new)
    con.execute("CHECKPOINT")
    ckpt = chip_smoke.q1_q6_rows(con)
    chip_smoke.durable_mutations(con, host)
    con.execute("SET checkpoint_on_shutdown = false")
    del con                                   # a crash: no close()
    assert os.path.getsize(path + ".wal") > 8
    sums, rev, n = chip_smoke.lineitem_oracle(host)
    assert n == rows + new - int(
        (np.concatenate([host["base"]["l_shipdate"],
                         host["new"].columns[4].data])
         == chip_smoke._days(chip_smoke.DURABLE_DELETE_DAY)).sum())
    rec = ddb_tpu_torch.connect("cpu", path)
    assert rec.open_stats["records"] == 3
    kin = F.lineitem_kernel_inputs(rec.catalog.get_table("lineitem"), "cpu")
    assert np.array_equal(F.q1_fused_aggregate(
        kin["qty"], kin["ext"], kin["disc"], kin["tax"], kin["ship"],
        kin["gid"], chip_smoke.Q1_CUTOFF).numpy(), sums)
    assert int(F.q6_fused_filter_sum(kin["qty"], kin["ext"], kin["disc"],
                                     kin["ship"], chip_smoke.Q6_CUT)) == rev
    for threshold in (1000, rows * 10):       # streamed, then resident
        rec.execute(f"SET external_threshold_rows = {threshold}")
        rec.execute("SET tile_rows = 4096")
        chip_smoke.check_q1_q6(str(threshold), chip_smoke.q1_q6_rows(rec),
                               sums, rev)
    # the checkpoint alone, attached, and the reference over both files
    other = ddb_tpu_torch.connect("cpu")
    other.execute(f"ATTACH '{path}' AS snap")
    assert chip_smoke.q1_q6_rows(other, "snap.lineitem") == ckpt
    chip_smoke.check_q1_q6("reference", chip_smoke.q1_q6_rows(
        ddb_tpu.connect(path)), sums, rev)


def test_load_lets_go_of_the_tables_it_replaces(tmp_path):
    """load() and open_database() replace tables outside execute(): the
    plans cached over the old tables, and with them the old tables'
    device batches, must go too (and the buffer manager holds them only
    weakly)."""
    import gc
    import weakref
    path = str(tmp_path / "r.dtb")
    con = ddb_tpu_torch.connect("cpu")
    run(con, "CREATE TABLE t (a INTEGER)", "INSERT INTO t VALUES (1), (2)")
    con.save(path)
    assert con.execute("SELECT sum(a) FROM t").fetchall() == [(3,)]
    old = con.catalog.get_table("t")
    assert old._device_batches and con._plan_cache
    gone = weakref.ref(old)
    del old
    con.load(path)
    gc.collect()
    assert gone() is None
    assert con.execute("SELECT sum(a) FROM t").fetchall() == [(3,)]


def test_builds_at_once_never_leave_a_partial_library():
    """Processes that build the database files' library at once (as
    parallel test workers on a fresh tree do) each load a whole library,
    and no temporary file stays in the build directory."""
    import subprocess
    import sys
    from ddb_tpu_torch.storage import persist
    code = ("import ctypes\n"
            "from ddb_tpu_torch.storage import persist\n"
            "ctypes.CDLL(persist.build_native(force=True))\n"
            "persist._load_lib()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 3, outs
    # the port's own build directory; native/ is the reference's
    build = os.path.realpath(os.path.dirname(persist._lib_path()))
    assert build == os.path.join(root, "ddb_tpu_torch", "_build")
    assert [f for f in os.listdir(build) if f.endswith(".tmp")] == []

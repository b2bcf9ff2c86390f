"""bench/clickbench.py:write_csv of ddb_tpu_torch against ddb_tpu's, and
the hits table loaded from that file through both packages, on the CPU.

The reference writes with Python's csv.writer (a field quoted only where
it must be, '' as an empty field, CRLF); the port formats the same bytes
with storage/csvwrite.py's "csv" dialect.  Both packages then load the
file as the reference's tests/test_clickbench.py does, `CREATE TABLE
hits AS SELECT * FROM read_csv_auto(path, nullstr='\\x00')`, and must
give the same table.  Neither honours `nullstr`: both read an empty
field as NULL, where the registered table holds ''.  The NULL counts are
pinned as equal and non-zero (ROADMAP fault 3.29, shared, not patched).
"""

import csv
import datetime
import io

import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.bench import clickbench as rcb
from ddb_tpu_torch import types as T
from ddb_tpu_torch.bench import clickbench as pcb
from ddb_tpu_torch.storage import csvwrite

from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

LOADED_ROWS = 20_000
VARCHARS = ("SearchPhrase", "Referer", "MobilePhoneModel", "URL", "Title")
EDGE = ["", ",", '"', 'a"b', "\r", "\n", "x\r\ny", " lead", "trail ",
        " both ", "café", "日本", "\U0001F600", "plain",
        '"quoted"', "a,b\"c\nd"]


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_write_csv_bytes_equal_the_reference(tmp_path):
    ref, port = tmp_path / "ref.csv", tmp_path / "port.csv"
    rcb.write_csv(rcb.generate(5000), str(ref))
    pcb.write_csv(pcb.generate(5000), str(port), device="cpu")
    got = _bytes(port)
    assert got == _bytes(ref)
    assert got.count(b"\r\n") == 5001 and b'"' not in got


def _edge_tables(n=400, seed=5):
    """(the reference's columns with object arrays, the port's with Coded
    strings): the same values."""
    rng = np.random.default_rng(seed)
    values = np.unique(np.array(EDGE))
    codes = [rng.integers(0, len(values), n).astype(np.int32)
             for _ in range(2)]
    ints = rng.integers(-(1 << 62), 1 << 62, n)
    ints[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    days = rng.integers(-719162, 2932897, n).astype(np.int32)
    days[:2] = [-719162, 2932896]         # 0001-01-01 and 9999-12-31
    # 0001-01-01 00:00:00 to 9999-12-31 23:59:59
    secs = rng.integers(-62_135_596_800, 253_402_300_800, n)
    secs[:2] = [-62_135_596_800, 253_402_300_799]
    port = {"WatchID": ints, "s": pcb.Coded(codes[0], values),
            "a,b": pcb.Coded(codes[1], values), "EventDate": days,
            "EventTime": secs}
    ref = {"WatchID": ints,
           "s": values.astype(object)[codes[0]],
           "a,b": values.astype(object)[codes[1]],
           "EventDate": days, "EventTime": secs}
    return ref, port


def test_edge_strings_give_the_reference_bytes(tmp_path):
    ref_cols, port_cols = _edge_tables()
    ref, port = tmp_path / "ref.csv", tmp_path / "port.csv"
    rcb.write_csv(ref_cols, str(ref))
    pcb.write_csv(port_cols, str(port), device="cpu")
    got = _bytes(port)
    assert got == _bytes(ref)
    # the header's one name with a comma is quoted, the others are not
    assert got.startswith(b'WatchID,s,"a,b",EventDate,EventTime\r\n')


def test_csv_dialect_timestamps_nulls_and_types(tmp_path):
    """write_host's csv dialect beyond write_csv's columns: fractions of
    a second only where not zero, NULL as an empty field, and types the
    csv module's dialect has no rule for refused."""
    us = np.array([0, 1, 999_999, -1, 1_373_760_000_123_456,
                   -86_400_000_000], dtype=np.int64)
    nulls = np.array([False, False, True, False, False, False])
    path = tmp_path / "t.csv"
    csvwrite.write_host([("t", T.TIMESTAMP, us, nulls, None),
                         ("i", T.INTEGER, np.arange(6, dtype=np.int32), None,
                          None)], str(path), device="cpu", dialect="csv")
    want = io.StringIO(newline="")
    w = csv.writer(want)
    w.writerow(["t", "i"])
    epoch = datetime.datetime(1970, 1, 1)
    for i, (x, null) in enumerate(zip(us, nulls)):
        w.writerow([None if null else (epoch + datetime.timedelta(
            microseconds=int(x))).isoformat(sep=" "), i])
    assert _bytes(path) == want.getvalue().encode()
    with pytest.raises(NotImplementedError, match="DOUBLE"):
        csvwrite.write_host([("x", T.DOUBLE, np.ones(2), None, None)],
                            str(path), device="cpu", dialect="csv")
    with pytest.raises(ValueError, match="dialect"):
        csvwrite.write_host([("i", T.INTEGER, np.ones(2, np.int32), None,
                              None)], str(path), device="cpu",
                            dialect="excel")


def test_csv_dialect_date_out_of_python_range_raises(tmp_path):
    # day -719163 is 0000-12-31: Arrow writes it, Python's date cannot
    days = np.array([0, -719163], dtype=np.int32)
    with pytest.raises(OverflowError):
        csvwrite.write_host([("d", T.DATE, days, None, None)],
                            str(tmp_path / "d.csv"), device="cpu",
                            dialect="csv")


def test_write_csv_formats_on_the_card_unless_told(tmp_path):
    import inspect
    assert inspect.signature(pcb.write_csv).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    path = tmp_path / "hits.csv"
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        pcb.write_csv(pcb.generate(100), str(path))
    assert not path.exists()


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """The reference's file of 20,000 rows, loaded by both packages."""
    path = str(tmp_path_factory.mktemp("hits") / "hits.csv")
    rcb.write_csv(rcb.generate(LOADED_ROWS), path)
    sql = (f"CREATE TABLE hits AS SELECT * FROM read_csv_auto('{path}', "
           f"nullstr='\\x00')")
    ref = ddb_tpu.connect()
    ref.execute(sql)
    port = ddb_tpu_torch.connect(device="cpu")
    port.execute(sql)
    return ref, port


def test_both_packages_load_the_same_table(loaded):
    ref, port = loaded
    want = ref.execute("DESCRIBE hits").fetchall()
    assert port.execute("DESCRIBE hits").fetchall() == want
    types = {name: t for name, t, *_ in want}
    assert types["EventDate"] == "DATE" and types["EventTime"] == "TIMESTAMP"
    assert {types[c] for c in VARCHARS} == {"VARCHAR"}
    assert types["CounterID"] == "BIGINT"       # registered as INTEGER
    assert port.execute("SELECT * FROM hits").fetchall() == \
        ref.execute("SELECT * FROM hits").fetchall()
    w, g = ref.catalog.get_table("hits"), port.catalog.get_table("hits")
    assert w.num_rows == g.num_rows == LOADED_ROWS
    for a, b in zip(w.columns, g.columns, strict=True):
        assert a.name == b.name and repr(a.dtype) == repr(b.dtype)
        assert np.array_equal(np.asarray(a.data), np.asarray(b.data)), a.name


def test_both_packages_read_empty_strings_as_null(loaded):
    """Fault 3.29: `nullstr` is ignored by both, so '' loads as NULL."""
    ref, port = loaded
    sql = "SELECT " + ", ".join(f"count(*) - count({c})"
                                for c in VARCHARS) + " FROM hits"
    want = ref.execute(sql).fetchall()
    assert port.execute(sql).fetchall() == want
    assert all(k > 0 for k in want[0])
    empties = port.execute("SELECT count(*) FROM hits WHERE "
                           "SearchPhrase = ''").fetchall()
    assert empties == [(0,)]
    # the registered table keeps them as ''
    cols = pcb.generate(LOADED_ROWS)
    reg = pcb.register(ddb_tpu_torch.connect(device="cpu"), cols)
    phrase = cols["SearchPhrase"]
    assert reg.execute("SELECT count(*) FROM hits WHERE SearchPhrase = ''"
                       ).fetchall() == [(want[0][0],)] == [
        (int((phrase.decode() == "").sum()),)]

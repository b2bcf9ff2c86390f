"""The CSV reader (storage/csvscan.py, behind the port's
storage/csv_sniffer.py:read_csv_auto) against the reference's
read_csv_auto, which parses through pyarrow, and the port's
Connection.read_csv (pyarrow's type inference) against the reference's.

Each case writes one file and reads it through both packages; the tables
must be equal exactly: names, types, values (doubles bit for bit), NULL
masks and string dictionaries.  Where pyarrow raises, the port raises
too.  Each case also runs with chunks of a few bytes, so that chunk
boundaries fall inside rows, inside quoted fields and between the two
bytes of CRLF.  No tolerance anywhere.

The one named difference: where the sniffer's dialect leaves a quote in
the middle of an unquoted field or text after a closing quote, the port
re-reads the chunk on the host by pyarrow's rules (csvscan._canonical);
the table is the same, only slower (test_odd_quoting_reads_as_pyarrow)."""

import numpy as np
import pytest

pytest.importorskip("pyarrow")

from ddb_tpu.storage import table as ref_table  # noqa: E402
from ddb_tpu.storage.csv_sniffer import read_csv_auto as ref_read  # noqa
import ddb_tpu  # noqa: E402
import ddb_tpu_torch  # noqa: E402
from ddb_tpu_torch.batch import bind_device  # noqa: E402
from ddb_tpu_torch.bench.csv_cases import (CASES, INFER,  # noqa: E402
                                           random_file)
from ddb_tpu_torch.storage import csvscan  # noqa: E402
from ddb_tpu_torch.storage.csv_sniffer import read_csv_auto as port_read  # noqa

def _compare(want, got):
    for w, g in zip(want.columns, got.columns, strict=True):
        assert (w.name, repr(w.dtype)) == (g.name, repr(g.dtype)), w.name
        assert w.data.dtype == g.data.dtype, w.name
        if w.data.dtype.kind == "f":
            assert np.array_equal(w.data.view(np.int64),
                                  g.data.view(np.int64)), w.name
        else:
            assert np.array_equal(w.data, g.data), (w.name, w.data, g.data)
        assert (w.nulls is None) == (g.nulls is None), w.name
        if w.nulls is not None:
            assert np.array_equal(w.nulls, g.nulls), w.name
        assert (w.strdict is None) == (g.strdict is None), w.name
        if w.strdict is not None:
            assert list(w.strdict.values) == list(g.strdict.values), w.name


def both(path, monkeypatch, chunk=None, **kw):
    """(reference table or its exception, port table or its exception)."""
    try:
        want = ref_table.from_arrow("read_csv", ref_read(path, **kw))
    except (ValueError, TypeError) as e:
        want = e
    if chunk:
        monkeypatch.setattr(csvscan, "CHUNK_BYTES", chunk)
    try:
        with bind_device("cpu"):
            got = port_read(path, **kw)
    except (ValueError, TypeError) as e:
        got = e
    return want, got


def check(want, got):
    if isinstance(want, Exception):
        # pyarrow's ArrowInvalid and the port's CsvError are ValueErrors;
        # a TIME column is a TypeError in both
        assert isinstance(got, Exception), got
        assert isinstance(got, ValueError) == isinstance(want, ValueError)
        return
    assert not isinstance(got, Exception), got
    _compare(want, got)


@pytest.mark.parametrize("chunk", [None, 5])
@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_corpus(tmp_path, monkeypatch, name, chunk):
    text, kw = CASES[name]
    p = tmp_path / "f.csv"
    p.write_bytes(text.encode())
    check(*both(str(p), monkeypatch, chunk=chunk, **kw))


@pytest.mark.parametrize("text", [
    'a,b\n"ab" "c",1\n', 'a,b\n"a"b"c",1\n', 'a,b\na"b,1\n',
    'a,b\n"a\nb" x,1\n', 'a,b\n"abc,1\n', 'a,b\n"a""b"c,1\n',
])
def test_odd_quoting_reads_as_pyarrow(tmp_path, monkeypatch, text):
    p = tmp_path / "f.csv"
    p.write_bytes(text.encode())
    kw = {"names": ["a", "b"], "types": {"a": "VARCHAR", "b": "VARCHAR"},
          "header": True}
    check(*both(str(p), monkeypatch, **kw))
    # the chunk went through the host's state machine, and was counted
    assert csvscan.STATS["odd_quote_chunks"] == 1


@pytest.mark.parametrize("chunk", [None, 997, 4096])
def test_seeded_file_across_chunk_boundaries(tmp_path, monkeypatch, chunk):
    text = random_file(np.random.default_rng(10), 3000)
    p = tmp_path / "r.csv"
    p.write_bytes(text.encode())
    # the declared schema, as COPY FROM passes it (the sniffer's sample
    # of this file is not the point here)
    kw = {"names": ["i", "x", "s", "d", "ts", "b"], "header": True,
          "delim": ",",
          "types": {"i": "BIGINT", "x": "DOUBLE", "s": "VARCHAR",
                    "d": "DATE", "ts": "TIMESTAMP", "b": "BOOLEAN"}}
    want, got = both(str(p), monkeypatch, chunk=chunk, **kw)
    check(want, got)
    assert got.num_rows == 3000


@pytest.mark.parametrize("chunk", [None, 997])
def test_full_precision_doubles_parse_in_one_conversion(tmp_path,
                                                        monkeypatch, chunk):
    """Doubles of 16 and 17 digits, as COPY TO writes arbitrary values,
    are off Clinger's fast path: their bytes are parsed on the host in one
    numpy conversion, never row by row, and read back bit for bit."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(2000) * 10.0 ** rng.integers(-40, 40, 2000)
    p = tmp_path / "x.csv"
    text = "x\n" + "".join(f"{float(v)!r}\n" for v in x)
    p.write_bytes(text.encode())
    want, got = both(str(p), monkeypatch, chunk=chunk, names=["x"],
                     types={"x": "DOUBLE"}, header=True)
    check(want, got)
    assert np.array_equal(got.columns[0].data.view(np.int64),
                          x.view(np.int64))
    assert csvscan.STATS["host_rows"] == 0
    assert csvscan.STATS["slow_float_rows"] > 1900


def test_a_chunk_boundary_inside_a_quoted_newline(tmp_path, monkeypatch):
    # rows of 13 bytes; a chunk of 9 ends inside every quoted field, on
    # its newline, and the reader grows the chunk to the row's end
    text = "a,b\n" + "".join(f'"v{i:02d}\nw\r\nx",{i}\n' for i in range(40))
    p = tmp_path / "q.csv"
    p.write_bytes(text.encode())
    monkeypatch.setattr(csvscan, "CHUNK_BYTES", 9)
    with bind_device("cpu"):
        got = port_read(str(p))
    assert csvscan.STATS["chunks"] >= 40
    want = ref_table.from_arrow("read_csv", ref_read(str(p)))
    _compare(want, got)


# ---- Connection.read_csv: pyarrow's inference --------------------------

def _infer_both(path, monkeypatch, chunk=None, **kw):
    got = {}
    for pkg, con in (("ref", ddb_tpu.connect()),
                     ("port", ddb_tpu_torch.connect("cpu"))):
        if pkg == "port" and chunk:
            monkeypatch.setattr(csvscan, "CHUNK_BYTES", chunk)
        try:
            con.read_csv("t", path, **kw)
            got[pkg] = con.catalog.get_table("t")
        except (ValueError, TypeError) as e:
            got[pkg] = e
    return got["ref"], got["port"]


@pytest.mark.parametrize("chunk", [None, 6])
@pytest.mark.parametrize("name", sorted(INFER))
def test_read_csv_infers_the_reference_types(tmp_path, monkeypatch, name,
                                             chunk):
    p = tmp_path / "i.csv"
    p.write_bytes(INFER[name].encode())
    want, got = _infer_both(str(p), monkeypatch, chunk=chunk)
    check(want, got)


def test_read_csv_keywords(tmp_path, monkeypatch):
    p = tmp_path / "k.csv"
    p.write_bytes(b"1|x\n2|y\n")
    check(*_infer_both(str(p), monkeypatch, delimiter="|",
                       column_names=["n", "s"]))


def test_empty_file_raises_in_both(tmp_path, monkeypatch):
    p = tmp_path / "e.csv"
    p.write_bytes(b"")
    want, got = _infer_both(str(p), monkeypatch)
    assert isinstance(want, ValueError) and isinstance(got, ValueError)


# ---- the h2oai file ----------------------------------------------------------

def test_h2oai_write_csv_formats_on_the_card_unless_told():
    import inspect
    from ddb_tpu_torch.bench import h2oai as port_h2oai
    from ddb_tpu_torch.storage import csvwrite
    sig = inspect.signature(port_h2oai.write_csv)
    assert sig.parameters["device"].default == "cuda"
    # the writer itself takes no default device
    assert inspect.signature(csvwrite.write_host).parameters[
        "device"].default is inspect.Parameter.empty

@pytest.mark.parametrize("na_pct", [0, 5])
def test_h2oai_write_csv_bytes_and_reload(tmp_path, monkeypatch, na_pct):
    from ddb_tpu.bench import h2oai as ref_h2oai
    from ddb_tpu_torch.bench import h2oai as port_h2oai
    n = 2000
    ref_path, port_path = str(tmp_path / "ref.csv"), str(tmp_path / "p.csv")
    ref_h2oai.write_csv(ref_h2oai.generate(n, k=10, na_pct=na_pct, seed=3),
                        ref_path)
    port_h2oai.write_csv(port_h2oai.generate(n, k=10, na_pct=na_pct,
                                             seed=3), port_path,
                         device="cpu")
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    check(*both(port_path, monkeypatch, chunk=4096))

# Generated from tests/test_copy_arrow.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite copy_arrow); do not edit.
"""COPY TO/FROM + arrow/numpy export (reference: physical_copy_to_file,
arrow interop in common/arrow/)."""

from ddb_tpu_torch.testing import refsuite
import decimal

import numpy as np
import pytest

import ddb_tpu_torch


def test_copy_roundtrip_csv(tmp_path):
    p = str(tmp_path / "out.csv")
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, s VARCHAR)")
    con.execute("INSERT INTO t VALUES (1, 'x'), (2, 'y')")
    con.execute(f"COPY t TO '{p}'")
    con.execute("CREATE TABLE t2 (a INTEGER, s VARCHAR)")
    con.execute(f"COPY t2 FROM '{p}'")
    assert con.execute("SELECT * FROM t2 ORDER BY a").fetchall() == \
        [(1, "x"), (2, "y")]


def test_copy_query_parquet(tmp_path):
    p = str(tmp_path / "out.parquet")
    con = refsuite.connect()
    con.register("t", {"a": [3, 1, 2]})
    con.execute(f"COPY (SELECT a * 10 AS b FROM t WHERE a > 1) TO '{p}'")
    import pyarrow.parquet as pq
    at = pq.read_table(p)
    assert sorted(at.column("b").to_pylist()) == [20, 30]


def test_arrow_export_types():
    import datetime
    import pyarrow as pa
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, s VARCHAR, d DECIMAL(10,2))")
    con.execute("INSERT INTO t VALUES (1, 'x', 1.25), (2, NULL, NULL)")
    at = con.execute("SELECT * FROM t ORDER BY a").arrow()
    assert at.column("a").to_pylist() == [1, 2]
    assert at.column("s").to_pylist() == ["x", None]
    assert at.column("d").to_pylist() == [decimal.Decimal("1.25"), None]


def test_fetchnumpy():
    con = refsuite.connect()
    con.register("t", {"a": [1, 2, 3]})
    d = con.execute("SELECT a FROM t").fetchnumpy()
    assert list(d["a"]) == [1, 2, 3]


def test_window_rank_fns():
    con = refsuite.connect()
    con.register("t", {"x": [1, 2, 2, 4]})
    rows = con.execute(
        "SELECT x, percent_rank() OVER (ORDER BY x), "
        "cume_dist() OVER (ORDER BY x), ntile(2) OVER (ORDER BY x) "
        "FROM t ORDER BY x").fetchall()
    assert rows[0][1] == 0.0 and rows[3][1] == 1.0
    assert rows[3][2] == 1.0 and abs(rows[2][2] - 0.75) < 1e-12
    assert [r[3] for r in rows] == [1, 1, 2, 2]


# ---------------------------------------------------------------------------
# CSV sniffer (reference: src/execution/operator/csv_scanner/sniffer/)
# ---------------------------------------------------------------------------
def test_sniffer_pipe_no_header(tmp_path):
    import datetime
    from ddb_tpu_torch.testing.refsuite import Connection
    p = str(tmp_path / "pipe.csv")
    open(p, "w").write("1|foo|2020-01-01|1.5\n2|bar|2021-06-30|2.5\n")
    c = Connection()
    rows = c.sql(f"SELECT * FROM read_csv('{p}') ORDER BY 1").fetchall()
    assert rows == [(1, "foo", datetime.date(2020, 1, 1), 1.5),
                    (2, "bar", datetime.date(2021, 6, 30), 2.5)]
    (d, q, e, h, cols), = c.sql(f"SELECT * FROM sniff_csv('{p}')").fetchall()
    assert d == "|" and h is False and "DATE" in cols


def test_sniffer_semicolon_header(tmp_path):
    from ddb_tpu_torch.testing.refsuite import Connection
    p = str(tmp_path / "semi.csv")
    open(p, "w").write("id;name;score\n1;alice;3.5\n2;bob;4.0\n")
    c = Connection()
    rows = c.sql(f"SELECT id, name, score FROM read_csv('{p}')"
                 " ORDER BY id").fetchall()
    assert rows == [(1, "alice", 3.5), (2, "bob", 4.0)]


def test_read_csv_named_args(tmp_path):
    from ddb_tpu_torch.testing.refsuite import Connection
    p = str(tmp_path / "t.tsv")
    open(p, "w").write("a\tb\n10\t20\n30\t40\n")
    c = Connection()
    rows = c.sql(f"SELECT * FROM read_csv('{p}', delim='\t',"
                 " header=true) ORDER BY 1").fetchall()
    assert rows == [(10, 20), (30, 40)]


def test_copy_from_sniffed_typed(tmp_path):
    import datetime
    from decimal import Decimal
    from ddb_tpu_torch.testing.refsuite import Connection
    p = str(tmp_path / "pipe2.csv")
    open(p, "w").write("1|foo|2020-01-01|1.50\n")
    c = Connection()
    c.sql("CREATE TABLE c1 (i INTEGER, s VARCHAR, d DATE,"
          " v DECIMAL(12,2))")
    c.sql(f"COPY c1 FROM '{p}'")
    assert c.sql("SELECT * FROM c1").fetchall() == \
        [(1, "foo", datetime.date(2020, 1, 1), Decimal("1.50"))]

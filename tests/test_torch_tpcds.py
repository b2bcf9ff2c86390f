"""bench/tpcds.py, the port's copy of ddb_tpu/bench/tpcds.py: the vendored
TPC-DS sf0.01 files load through both packages into the same tables, and
query_text reads NN.sql from the directory it is given."""

import os

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.bench import tpcds as ref_tpcds
from ddb_tpu_torch.bench import tpcds

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(_ROOT, "tests", "data", "tpcds_sf0.01")


@pytest.fixture(scope="module")
def loaded():
    ref, port = ddb_tpu.connect(), ddb_tpu_torch.connect(device="cpu")
    return (ref, ref_tpcds.load_tpcds(ref, DATA),
            port, tpcds.load_tpcds(port, DATA))


def test_the_same_tables_load(loaded):
    ref, ref_names, port, names = loaded
    assert names == ref_names
    assert len(names) == 24
    assert sorted(port.catalog.tables) == sorted(ref.catalog.tables)


def _nulls(col):
    return np.zeros(len(col.data), dtype=bool) if col.nulls is None \
        else np.asarray(col.nulls)


def test_every_column_equals_the_references(loaded):
    ref, names, port, _ = loaded
    for name in names:
        want = ref.catalog.tables[name]
        got = port.catalog.tables[name]
        assert got.num_rows == want.num_rows, name
        assert [c.name for c in got.columns] == \
            [c.name for c in want.columns], name
        for w, g in zip(want.columns, got.columns):
            where = f"{name}.{w.name}"
            assert str(g.dtype) == str(w.dtype), where
            assert g.data.dtype == w.data.dtype, where
            nw, ng = _nulls(w), _nulls(g)
            assert np.array_equal(ng, nw), where
            assert np.array_equal(g.data[~ng], w.data[~nw]), where
            assert (g.strdict is None) == (w.strdict is None), where
            if w.strdict is not None:
                assert np.array_equal(g.strdict.values,
                                      w.strdict.values), where


def test_a_query_over_the_loaded_tables_runs(loaded):
    _, _, port, _ = loaded
    rows = port.execute(
        "SELECT d_year, count(*) FROM store_sales, date_dim "
        "WHERE ss_sold_date_sk = d_date_sk GROUP BY d_year "
        "ORDER BY d_year").fetchall()
    assert rows and sum(c for _, c in rows) > 0


def test_only_the_named_tables_load():
    port = ddb_tpu_torch.connect(device="cpu")
    assert tpcds.load_tpcds(port, DATA, tables={"reason", "ship_mode"}) \
        == ["reason", "ship_mode"]
    assert port.catalog.tables["reason"].num_rows > 0


def test_query_text_reads_nn_sql_from_its_directory(tmp_path):
    (tmp_path / "07.sql").write_text("SELECT 7;\n")
    (tmp_path / "42.sql").write_text("SELECT 42;\n")
    assert tpcds.query_text(7, str(tmp_path)) == "SELECT 7;\n"
    assert tpcds.query_text(42, qdir=str(tmp_path)) == "SELECT 42;\n"
    with pytest.raises(FileNotFoundError):
        tpcds.query_text(8, str(tmp_path))


def test_query_dir_is_under_the_reference_root():
    assert tpcds.QUERY_DIR.endswith(os.path.join(
        "extension", "tpcds", "dsdgen", "queries"))
    assert ref_tpcds.QUERY_DIR.endswith("extension/tpcds/dsdgen/queries")

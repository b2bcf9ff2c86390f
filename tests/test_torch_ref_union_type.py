# Generated from tests/test_union_type.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite union_type); do not edit.
"""UNION logical type (reference: LogicalType::UNION,
src/common/types.cpp + common/types/union_type.cpp)."""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch

import oracle


@pytest.fixture()
def con():
    c = refsuite.connect()
    c.execute("CREATE TABLE tbl (u UNION(num INTEGER, str VARCHAR))")
    c.execute("INSERT INTO tbl VALUES (1), ('two'), "
              "(union_value(str := 'three')), (NULL)")
    return c


def test_union_values(con):
    assert con.execute("SELECT u FROM tbl").fetchall() \
        == [(1,), ("two",), ("three",), (None,)]


def test_union_tag(con):
    assert con.execute("SELECT union_tag(u) FROM tbl").fetchall() \
        == [("num",), ("str",), ("str",), (None,)]


def test_union_extract_and_dot(con):
    assert con.execute("SELECT union_extract(u, 'str') FROM tbl"
                       ).fetchall() \
        == [(None,), ("two",), ("three",), (None,)]
    assert con.execute("SELECT u.num FROM tbl").fetchall() \
        == [(1,), (None,), (None,), (None,)]


def test_union_value_scalar(con):
    assert con.execute("SELECT union_value(num := 2)").fetchall() \
        == [(2,)]


@pytest.mark.skipif(not oracle.available(), reason="oracle not built")
def test_union_vs_oracle(con):
    init = ("CREATE TABLE tbl (u UNION(num INTEGER, str VARCHAR));"
            "INSERT INTO tbl VALUES (1), ('two'), "
            "(union_value(str := 'three')), (NULL);")
    for sql in ["SELECT union_tag(u) FROM tbl",
                "SELECT union_extract(u, 'num') FROM tbl"]:
        mine = [tuple("NULL" if v is None else str(v) for v in r)
                for r in con.execute(sql).fetchall()]
        ref = [tuple(r) for r in oracle.query(sql, init)]
        assert mine == ref, (sql, mine, ref)

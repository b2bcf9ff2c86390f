# Generated from tests/test_nested_cast.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite nested_cast); do not edit.
"""VARCHAR <-> LIST/STRUCT/MAP casts and duckdb nested rendering.

Reference: src/common/types/vector/ string-cast paths
(VectorStringToList/ToStruct/ToMap) + Vector::ToString, exercised by
test/sql/cast/string_to_*.test.
"""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture
def con():
    return refsuite.connect()


def q(con, sql):
    return con.sql(sql).fetchall()


def test_string_to_list(con):
    assert q(con, "SELECT '[12,13,14]'::INT[]") == [([12, 13, 14],)]
    assert q(con, "SELECT '[[1,2],[3]]'::INT[][]") == [([[1, 2], [3]],)]
    assert q(con, "SELECT '[1, NULL, 3]'::INT[]") == [([1, None, 3],)]
    assert q(con, "SELECT '[]'::INT[]") == [([],)]
    # per-element TRY_CAST: bad elements become NULL, rows survive
    assert q(con, "SELECT TRY_CAST('[1,2,X,2]' AS INT[])") == \
        [([1, 2, None, 2],)]
    assert q(con, "SELECT TRY_CAST('[12345678901]' AS INT[])") == \
        [([None],)]
    with pytest.raises(Exception):
        q(con, "SELECT '[1, oops]'::INT[]")


def test_string_to_struct_and_map(con):
    assert q(con, "SELECT '{key_A:0}'::STRUCT(key_A INT)") == \
        [({"key_A": 0},)]
    assert q(con, "SELECT '{name: value, age: 30}'"
                  "::STRUCT(name VARCHAR, age INT)") == \
        [({"name": "value", "age": 30},)]
    assert q(con, "SELECT '{a=1, b=2}'::MAP(VARCHAR, INT)") == \
        [({"a": 1, "b": 2},)]


def test_nested_to_varchar_rendering(con):
    assert q(con, "SELECT '[1,2,NULL]'::INT[]::VARCHAR") == \
        [("[1, 2, NULL]",)]
    # element quoting rules: commas/quotes/brackets/empty quote with
    # backslash-escaped quotes; plain words stay raw
    assert q(con, "SELECT ['a,b', 'plain', '']::VARCHAR") == \
        [("['a,b', plain, '']",)]
    assert q(con, "SELECT {'a': 1}::VARCHAR") == [("{'a': 1}",)]


def test_quoted_atoms_and_operators(con):
    assert q(con, "SELECT $$['x, y', z]$$::VARCHAR[]") == \
        [(["x, y", "z"],)]
    assert q(con, "SELECT 1 == 1, 2 <> 3") == [(True, True)]
    assert q(con, "SELECT struct_pack(key_A => 42)") == \
        [({"key_A": 42},)]


def test_copy_nested_roundtrip(con, tmp_path):
    p = str(tmp_path / "l.csv")
    con.sql("CREATE TABLE L AS SELECT [1,2,3] v, 'x' s")
    con.sql(f"COPY L TO '{p}'")
    con.sql("CREATE TABLE L2 (v INT[], s VARCHAR)")
    con.sql(f"COPY L2 FROM '{p}'")
    assert q(con, "SELECT v, s FROM L2") == [([1, 2, 3], "x")]

# Generated from tests/test_lists.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite lists); do not edit.
"""LIST type, UNNEST, list()/string_agg aggregates, string_split
(reference: LogicalType::LIST, physical_unnest.cpp,
extension/core_functions/aggregate/nested/list.cpp,
scalar/string/string_split.cpp).  List payloads live host-side (no
var-len device representation on TPU); rows carry int32 list ids."""

from ddb_tpu_torch.testing import refsuite
import pytest

from ddb_tpu_torch.testing.refsuite import Connection


@pytest.fixture()
def con():
    c = Connection()
    c.sql("CREATE TABLE t (s VARCHAR, k INTEGER)")
    c.sql("INSERT INTO t VALUES ('a,b', 1), ('c', 2), ('d,e,f', 3)")
    return c


def test_list_literal(con):
    assert con.sql("SELECT [1,2,3]").fetchall() == [([1, 2, 3],)]
    assert con.sql("SELECT ['x','y']").fetchall() == [(["x", "y"],)]


def test_from_unnest_literal(con):
    assert con.sql("SELECT * FROM unnest([1,2,3])").fetchall() \
        == [(1,), (2,), (3,)]


def test_unnest_select_item(con):
    assert con.sql("SELECT unnest([10,20])").fetchall() == [(10,), (20,)]


def test_string_split_and_unnest(con):
    rows = con.sql(
        "SELECT unnest(string_split(s, ',')) AS e, k FROM t").fetchall()
    assert rows == [("a", 1), ("b", 1), ("c", 2),
                    ("d", 3), ("e", 3), ("f", 3)]


def test_array_length(con):
    assert con.sql("SELECT array_length(string_split(s, ',')) FROM t") \
        .fetchall() == [(2,), (1,), (3,)]


def test_list_contains(con):
    assert con.sql(
        "SELECT list_contains(string_split(s, ','), 'b') FROM t") \
        .fetchall() == [(True,), (False,), (False,)]


def test_list_aggregate(con):
    rows = con.sql("SELECT k % 2 AS g, list(s) FROM t GROUP BY g"
                   " ORDER BY g").fetchall()
    assert rows == [(0, ["c"]), (1, ["a,b", "d,e,f"])]


def test_list_aggregate_ungrouped(con):
    (v,), = con.sql("SELECT list(k) FROM t").fetchall()
    assert v == [1, 2, 3]


def test_string_agg(con):
    assert con.sql("SELECT string_agg(s, ';') FROM t").fetchall() \
        == [("a,b;c;d,e,f",)]


def test_string_agg_grouped(con):
    rows = con.sql("SELECT k % 2 AS g, string_agg(s, '|') FROM t"
                   " GROUP BY g ORDER BY g").fetchall()
    assert rows == [(0, "c"), (1, "a,b|d,e,f")]


def test_list_agg_mixed_with_plain(con):
    rows = con.sql("SELECT k % 2 AS g, count(*), sum(k), list(s)"
                   " FROM t GROUP BY g ORDER BY g").fetchall()
    assert rows == [(0, 1, 2, ["c"]), (1, 2, 4, ["a,b", "d,e,f"])]


def test_unnest_empty_result():
    c = Connection()
    c.sql("CREATE TABLE e (s VARCHAR)")
    assert c.sql("SELECT unnest(string_split(s, ',')) FROM e") \
        .fetchall() == []


def test_list_arrow_export(con):
    at = con.sql("SELECT list(k) AS l FROM t").arrow()
    assert at.column("l").to_pylist() == [[1, 2, 3]]


# ---------------------------------------------------------------------------
# STRUCT / MAP (store-backed nested types; reference: LogicalType::STRUCT
# and MAP, src/common/types.cpp, child vectors src/common/types/vector.cpp)
# ---------------------------------------------------------------------------
def test_struct_literal_and_access():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    assert c.sql("SELECT {'a': 1, 'b': 'x'} AS s").fetchall() \
        == [({"a": 1, "b": "x"},)]
    assert c.sql("SELECT struct_pack(a := 1, b := 2).a").fetchall() \
        == [(1,)]
    assert c.sql("SELECT {'a': 1, 'b': 'x'}['b']").fetchall() == [("x",)]
    assert c.sql("SELECT row(1, 'y') AS r").fetchall() \
        == [({"v1": 1, "v2": "y"},)]


def test_map_literal_and_access():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    assert c.sql("SELECT MAP {'k1': 10, 'k2': 20}['k2']").fetchall() \
        == [(20,)]
    assert c.sql("SELECT cardinality(MAP {'a': 1})").fetchall() == [(1,)]
    assert c.sql("SELECT map_keys(MAP {'a': 1, 'b': 2})").fetchall() \
        == [(["a", "b"],)]
    assert c.sql("SELECT map_values(MAP {'a': 1, 'b': 2})").fetchall() \
        == [([1, 2],)]
    assert c.sql("SELECT map_contains(MAP {'a': 1}, 'a'),"
                 " map_contains(MAP {'a': 1}, 'z')").fetchall() \
        == [(True, False)]


def _nested_table():
    import pyarrow as pa
    return pa.table({
        "id": [1, 2, 3],
        "s": [{"x": 10, "y": "aa"}, {"x": 20, "y": "bb"}, None],
        "l": [[1, 2], [], [3]],
        "m": pa.array([[("a", 1)], [("b", 2), ("c", 3)], []],
                      type=pa.map_(pa.string(), pa.int64())),
    })


def test_struct_column_access():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.register("t", _nested_table())
    assert c.sql("SELECT id, s.x, s.y FROM t ORDER BY id").fetchall() \
        == [(1, 10, "aa"), (2, 20, "bb"), (3, None, None)]
    assert c.sql("SELECT id, s['x'] + 1 FROM t ORDER BY id").fetchall() \
        == [(1, 11), (2, 21), (3, None)]
    assert c.sql("SELECT id, struct_extract(s, 'y') FROM t"
                 " WHERE s.x > 15").fetchall() == [(2, "bb")]
    assert c.sql("SELECT sum(s.x) FROM t").fetchall() == [(30,)]
    assert c.sql("SELECT s.x, count(*) FROM t GROUP BY s.x ORDER BY 1"
                 ).fetchall() == [(10, 1), (20, 1), (None, 1)]


def test_map_list_column_access():
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.register("t", _nested_table())
    assert c.sql("SELECT id, l[1], m['b'] FROM t ORDER BY id").fetchall() \
        == [(1, 1, None), (2, None, 2), (3, 3, None)]
    assert c.sql("SELECT id, l[-1] FROM t ORDER BY id").fetchall() \
        == [(1, 2), (2, None), (3, 3)]


def test_nested_arrow_parquet_roundtrip(tmp_path):
    import pyarrow as pa
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.register("t", _nested_table())
    at = c.sql("SELECT id, s, m FROM t ORDER BY id").arrow()
    assert pa.types.is_struct(at.schema.field("s").type)
    assert pa.types.is_map(at.schema.field("m").type)
    p = str(tmp_path / "n.parquet")
    c.sql(f"COPY (SELECT id, s, m FROM t) TO '{p}' (FORMAT parquet)")
    c.sql(f"CREATE TABLE t2 AS SELECT * FROM read_parquet('{p}')")
    assert c.sql("SELECT id, s.x, m['b'] FROM t2 ORDER BY id").fetchall() \
        == [(1, 10, None), (2, 20, 2), (3, None, None)]


def test_list_function_breadth():
    # reference: extension/core_functions/scalar/list/*
    from ddb_tpu_torch.testing.refsuite import Connection
    c = Connection()
    c.register("lt", {"l": [[3, 1, 2], [5], [], [2, None, 1]]})
    assert c.sql("SELECT list_sort(l) FROM lt").fetchall()[0] \
        == ([1, 2, 3],)
    assert c.sql("SELECT list_distinct([1,2,2,3])").fetchall() \
        == [([1, 2, 3],)]
    assert c.sql("SELECT list_unique([1,2,2,3])").fetchall() == [(3,)]
    assert c.sql("SELECT flatten([[1,2],[3]])").fetchall() \
        == [([1, 2, 3],)]
    assert c.sql("SELECT list_sum(l), list_min(l), list_avg(l) FROM lt"
                 ).fetchall()[0] == (6, 1, 2.0)
    assert c.sql("SELECT list_slice([1,2,3,4,5], 2, 4)").fetchall() \
        == [([2, 3, 4],)]
    assert c.sql("SELECT array_to_string([1,2,3], '-')").fetchall() \
        == [("1-2-3",)]
    assert c.sql("SELECT list_position([7,8,9], 8)").fetchall() == [(2,)]


def test_runtime_list_literals():
    import ddb_tpu_torch
    con = refsuite.connect()
    con.register("rl", {"i": [1, 2, None], "s": ["a", "b", "c"]})
    assert con.execute("SELECT [i, i * 2] FROM rl ORDER BY s"
                       ).fetchall() == \
        [([1, 2],), ([2, 4],), ([None, None],)]
    assert con.execute("SELECT [s, 'x'] FROM rl ORDER BY s"
                       ).fetchall() == \
        [(["a", "x"],), (["b", "x"],), (["c", "x"],)]
    assert con.execute(
        "SELECT len([i, 1]), list_sum([i, i]), "
        "list_contains([i, 4], 4) FROM rl ORDER BY s").fetchall() == \
        [(2, 2, True), (2, 4, True), (2, None, True)]

# Generated from tests/test_json.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite json); do not edit.
"""JSON scalar functions + general concat (reference: extension/json/*,
extension/core_functions scalar concat/concat_ws)."""

import pytest

from ddb_tpu_torch.testing.refsuite import Connection


@pytest.fixture()
def con():
    c = Connection()
    c.execute("CREATE TABLE j (id INTEGER, doc VARCHAR)")
    c.execute("""INSERT INTO j VALUES
        (1, '{"a": 1, "b": {"c": "x"}, "arr": [10, 20, 30]}'),
        (2, '{"a": 2, "arr": []}'),
        (3, 'not json'),
        (4, NULL)""")
    return c


def test_json_extract_arrow(con):
    rows = con.sql(
        "SELECT id, doc->'$.a', doc->>'$.b.c' FROM j ORDER BY id"
    ).fetchall()
    assert rows == [(1, "1", "x"), (2, "2", None), (3, None, None),
                    (4, None, None)]


def test_json_extract_array_index(con):
    rows = con.sql(
        "SELECT id, doc->>'$.arr[1]', doc->>'$.arr[#-1]' FROM j "
        "WHERE id = 1").fetchall()
    assert rows == [(1, "20", "30")]


def test_json_extract_function_forms(con):
    rows = con.sql(
        "SELECT json_extract(doc, '$.b'), "
        "json_extract_string(doc, '$.b.c') FROM j WHERE id = 1"
    ).fetchall()
    assert rows == [('{"c":"x"}', "x")]


def test_json_type_and_valid(con):
    rows = con.sql(
        "SELECT id, json_valid(doc), json_type(doc) FROM j ORDER BY id"
    ).fetchall()
    assert rows == [(1, True, "OBJECT"), (2, True, "OBJECT"),
                    (3, False, None), (4, None, None)]


def test_json_array_length(con):
    rows = con.sql(
        "SELECT id, json_array_length(doc, '$.arr') FROM j "
        "WHERE id < 3 ORDER BY id").fetchall()
    assert rows == [(1, 3), (2, 0)]


def test_json_structure(con):
    rows = con.sql(
        "SELECT json_structure(doc) FROM j WHERE id = 2").fetchall()
    assert rows == [('{"a":"BIGINT","arr":[]}',)] or \
        rows == [('{"a":"BIGINT","arr":["NULL"]}',)]


def test_json_keys(con):
    rows = con.sql(
        "SELECT json_keys(doc) FROM j WHERE id = 1").fetchall()
    assert rows == [(["a", "b", "arr"],)]


def test_json_merge_patch():
    c = Connection()
    rows = c.sql("""SELECT json_merge_patch('{"a":1,"b":2}',
                                            '{"b":null,"c":3}')""").fetchall()
    assert rows == [('{"a":1,"c":3}',)]


def test_json_filter_pushes_to_device(con):
    rows = con.sql(
        "SELECT count(*) FROM j WHERE json_valid(doc)").fetchall()
    assert rows == [(2,)]


# ---- concat --------------------------------------------------------------

@pytest.fixture()
def sc():
    c = Connection()
    c.execute("CREATE TABLE s (id INTEGER, a VARCHAR, b VARCHAR)")
    c.execute("INSERT INTO s VALUES (1,'x','p'), (2,'y',NULL), "
              "(3,NULL,'q')")
    return c


def test_concat_op_null_propagates(sc):
    rows = sc.sql("SELECT id, a || '_' || b FROM s ORDER BY id").fetchall()
    assert rows == [(1, "x_p"), (2, None), (3, None)]


def test_concat_fn_skips_nulls(sc):
    rows = sc.sql(
        "SELECT id, concat(a, '-', b) FROM s ORDER BY id").fetchall()
    assert rows == [(1, "x-p"), (2, "y-"), (3, "-q")]


def test_concat_two_columns(sc):
    rows = sc.sql("SELECT id, a || b FROM s ORDER BY id").fetchall()
    assert rows == [(1, "xp"), (2, None), (3, None)]


def test_concat_ws(sc):
    rows = sc.sql(
        "SELECT concat_ws(',', 'l', a) FROM s WHERE id = 1").fetchall()
    assert rows == [("l,x",)]


def test_concat_const_prefix_group_by(sc):
    rows = sc.sql(
        "SELECT 'store' || a AS k, count(*) FROM s WHERE a IS NOT NULL "
        "GROUP BY k ORDER BY k").fetchall()
    assert rows == [("storex", 1), ("storey", 1)]


def test_concat_all_constants():
    c = Connection()
    assert c.sql("SELECT 'a' || 'b' || 'c'").fetchall() == [("abc",)]
    assert c.sql("SELECT concat('a', NULL, 'c')").fetchall() == [("ac",)]
    assert c.sql("SELECT 'a' || NULL").fetchall() == [(None,)]

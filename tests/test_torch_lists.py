"""Lists, structs, maps, lambdas, UNNEST, nested casts and BIT in
ddb_tpu_torch against ddb_tpu on the CPU: the statements of
bench/select_cases.py (those of the reference package's test_lists,
test_r4_breadth, test_nested_cast, test_union_type and test_bit) through
both packages' connect(), and register() of nested Python values.

Rows must match exactly, floats to 1e-12 relative.
"""

import datetime

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch.bench import select_cases
from ddb_tpu_torch.expr import functions as pfunctions
from ddb_tpu_torch.plan import logical as L
from ddb_tpu_torch.plan import physical
from ddb_tpu_torch.storage import table as ptable

from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401


@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, cols in select_cases.tables().items():
        ref.register(name, cols)
        port.register(name, cols)
    return ref, port


@pytest.mark.parametrize("name", list(select_cases.LISTS))
def test_list_sql_matches_reference(cons, name):
    ref, port = cons
    sql = select_cases.LISTS[name]
    want, got = ref.execute(sql), port.execute(sql)
    assert got.column_names == want.column_names
    assert first_difference(want.fetchall(),
                                         got.fetchall()) is None
    assert len(got.fetchall()) > 0 or name == "unnest_empty"
    # runtime stores are refilled, not appended to, by a second run
    assert port.execute(sql).fetchall() == got.fetchall()


NESTED = {
    "ints": [[1, 2], [], None, [3, None]],
    "strings": [["a"], ["b", "c"], None, []],
    "nested": [[[1], [2, 3]], None, [[]], [[4]]],
    "structs": [{"x": 1, "y": "p"}, None, {"x": 3, "y": None},
                {"x": None, "y": "q"}],
    "blobs": [b"ab", None, b"", b"\x00\xff"],
    "stamps": [datetime.datetime(2024, 1, 2, 3, 4, 5, 6), None,
               datetime.datetime(1969, 12, 31, 23, 59, 59),
               datetime.datetime(1970, 1, 1)],
}


@pytest.mark.parametrize("col", list(NESTED))
def test_register_types_nested_values_like_the_reference(col):
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    ref.register("n", {col: NESTED[col]})
    port.register("n", {col: NESTED[col]})
    rt, = ref.catalog.get_table("n").columns
    pt, = port.catalog.get_table("n").columns
    assert repr(pt.dtype) == repr(rt.dtype)
    assert pt.dtype.id.name == rt.dtype.id.name
    assert np.array_equal(pt.data, rt.data)
    assert (pt.nulls is None) == (rt.nulls is None)
    assert pt.nulls is None or np.array_equal(pt.nulls, rt.nulls)
    sql = f"SELECT {col} FROM n"
    assert first_difference(ref.execute(sql).fetchall(),
                                         port.execute(sql).fetchall()) is None


def test_register_still_refuses_mixed_values():
    with pytest.raises(NotImplementedError, match="mixed"):
        ptable.from_pydict("m", {"a": [1, "x"]})


def test_unnest_repeats_the_other_columns_and_skips_null_and_empty(cons):
    ref, port = cons
    port2 = ddb_tpu_torch.connect(device="cpu")
    ref2 = ddb_tpu.connect()
    cols = {"k": ["a", "b", "c", "d"], "v": [1.5, None, 2.5, 3.5],
            "l": [[1, None, 2], [], None, [7]]}
    ref2.register("n", cols)
    port2.register("n", cols)
    sql = "SELECT k, v, unnest(l) FROM n"
    got = port2.execute(sql).fetchall()
    assert got == ref2.execute(sql).fetchall()
    assert got == [("a", 1.5, 1), ("a", 1.5, None), ("a", 1.5, 2),
                   ("d", 3.5, 7)]
    sql = "SELECT k, unnest(string_split(k || ',' || k, ',')) FROM n"
    assert port2.execute(sql).fetchall() == ref2.execute(sql).fetchall()


def test_list_seams_each_make_one_host_round_trip(cons):
    _, port = cons
    before = dict(pfunctions.HOST_CALLS)
    port.execute(select_cases.LISTS["runtime_list_numbers"])
    assert pfunctions.HOST_CALLS["pyudf"] == before["pyudf"] + 1
    port.execute(select_cases.LISTS["runtime_list_functions"])
    # three list literals and three functions over them
    assert pfunctions.HOST_CALLS["pyudf"] == before["pyudf"] + 7


def test_unnest_has_an_executor():
    assert L.Unnest in physical._EXEC

"""The hand-built plans of tests/test_substrate.py through both packages.

Each plan is built twice, from each package's own expr/ir.py and
plan/logical.py over each package's own tables (`Connection.table_data`),
and run with `Connection.execute_plan`: the port's rows must equal the
reference's exactly.  The one float aggregate sums 1.5, 2.5 and 3.0,
which no summation order rounds, and divides by 3 once.
"""

import datetime
import decimal
import types

import pyarrow as pa
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu import types as ref_T
from ddb_tpu.expr import ir as ref_ir
from ddb_tpu.plan import logical as ref_L
from ddb_tpu_torch import types as port_T
from ddb_tpu_torch.expr import ir as port_ir
from ddb_tpu_torch.plan import logical as port_L
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

REF = types.SimpleNamespace(T=ref_T, ir=ref_ir, L=ref_L,
                            connect=ddb_tpu.connect)
PORT = types.SimpleNamespace(T=port_T, ir=port_ir, L=port_L,
                             connect=lambda: ddb_tpu_torch.connect("cpu"))


def colref(p, table, name):
    sch = table.schema
    i = sch.index_of(name)
    f = sch.field(i)
    return p.ir.ColRef(i, f.dtype, name, f.strdict)


# name: (tables to register, plan builder(p, con) -> [plans], sort rows)
def _scan_and_filter(p, con):
    t = con.table_data("t")
    pred = p.ir.bind_comparison(">", colref(p, t, "a"),
                                p.ir.Const(2, p.T.INTEGER))
    return [p.L.Filter(p.L.Get(t, [0, 1]), pred)]


def _projection_arith(p, con):
    t = con.table_data("t")
    e = p.ir.bind_arith("+", colref(p, t, "a"), p.ir.Const(100, p.T.INTEGER))
    return [p.L.Project(p.L.Get(t, [0]), [e], ["x"])]


def _grouped_aggregate_ints(p, con):
    t = con.table_data("t")
    L = p.L
    return [L.Aggregate(
        L.Get(t, [0, 1]), groups=[colref(p, t, "k")],
        aggs=[L.AggSpec("sum", colref(p, t, "v"), p.T.BIGINT, "s"),
              L.AggSpec("count_star", None, p.T.BIGINT, "c"),
              L.AggSpec("min", colref(p, t, "v"), p.T.INTEGER, "mn"),
              L.AggSpec("max", colref(p, t, "v"), p.T.INTEGER, "mx")],
        group_names=["k"])]


def _ungrouped_aggregate(p, con):
    t = con.table_data("t")
    L = p.L
    return [L.Aggregate(
        L.Get(t, [0]), groups=[],
        aggs=[L.AggSpec("sum", colref(p, t, "v"), p.T.DOUBLE, "s"),
              L.AggSpec("avg", colref(p, t, "v"), p.T.DOUBLE, "a"),
              L.AggSpec("count_star", None, p.T.BIGINT, "c")])]


def _string_group_perfect_hash(p, con):
    t = con.table_data("t")
    L = p.L
    return [L.Aggregate(
        L.Get(t, [0, 1]), groups=[colref(p, t, "s")],
        aggs=[L.AggSpec("sum", colref(p, t, "v"), p.T.BIGINT, "s")],
        group_names=["s"])]


def _join(kind):
    def build(p, con):
        lt, rt = con.table_data("l"), con.table_data("r")
        return [p.L.Join(p.L.Get(lt, [0, 1]), p.L.Get(rt, [0, 1]), kind,
                         [p.L.JoinCond(colref(p, lt, "k"),
                                       colref(p, rt, "k"))])]
    return build


def _semi_anti_join(p, con):
    lt, rt = con.table_data("l"), con.table_data("r")
    return [p.L.Join(p.L.Get(lt, [0]), p.L.Get(rt, [0]), kind,
                     [p.L.JoinCond(colref(p, lt, "k"), colref(p, rt, "k"))])
            for kind in ("semi", "anti")]


def _order_limit(p, con):
    t = con.table_data("t")
    L = p.L
    return [L.Limit(L.Order(L.Get(t, [0]),
                            [L.OrderKey(colref(p, t, "a"), desc=True)]), 3)]


def _decimal_arith_and_sum(p, con):
    t = con.table_data("t")
    T, ir, L = p.T, p.ir, p.L
    two = ir.Const(T.encode_literal("2.0", T.DECIMAL(15, 1)),
                   T.DECIMAL(15, 1))
    prod = ir.bind_arith("*", colref(p, t, "d"), two)
    assert prod.dtype.scale == 3
    return [L.Aggregate(
        L.Project(L.Get(t, [0]), [prod], ["p"]), groups=[],
        aggs=[L.AggSpec("sum", ir.ColRef(0, prod.dtype, "p"),
                        T.DECIMAL(18, 3), "s")])]


def _nulls_in_aggregate(p, con):
    t = con.table_data("t")
    L = p.L
    return [L.Aggregate(
        L.Get(t, [0, 1]), groups=[colref(p, t, "k")],
        aggs=[L.AggSpec("sum", colref(p, t, "v"), p.T.BIGINT, "s"),
              L.AggSpec("count", colref(p, t, "v"), p.T.BIGINT, "c")],
        group_names=["k"])]


def _distinct(p, con):
    return [p.L.Distinct(p.L.Get(con.table_data("t"), [0]))]


def _case_expression(p, con):
    t = con.table_data("t")
    ir, T = p.ir, p.T
    c = ir.Case(
        whens=[(ir.bind_comparison("==", colref(p, t, "a"),
                                   ir.Const(2, T.INTEGER)),
                ir.Const(100, T.INTEGER))],
        else_=ir.Const(0, T.INTEGER), dtype=T.INTEGER)
    return [p.L.Project(p.L.Get(t, [0]), [c], ["x"])]


def _multikey_join(p, con):
    lt, rt = con.table_data("l"), con.table_data("r")
    L = p.L
    return [L.Join(L.Get(lt, [0, 1, 2]), L.Get(rt, [0, 1, 2]), "inner",
                   [L.JoinCond(colref(p, lt, "k1"), colref(p, rt, "k1")),
                    L.JoinCond(colref(p, lt, "k2"), colref(p, rt, "k2"))])]


def _dates(p, con):
    t = con.table_data("t")
    y = p.ir.Func("year", [colref(p, t, "d")], p.T.BIGINT)
    return [p.L.Project(p.L.Get(t, [0]), [y], ["y"])]


_DEC = pa.array([decimal.Decimal("1.25"), decimal.Decimal("2.50"),
                 decimal.Decimal("0.05")], pa.decimal128(15, 2))

CASES = {
    "scan_and_filter": (
        {"t": {"a": [1, 2, 3, 4, 5], "b": [10, 20, 30, 40, 50]}},
        _scan_and_filter, False),
    "projection_arith": ({"t": {"a": [1, 2, 3]}}, _projection_arith, False),
    "grouped_aggregate_ints": (
        {"t": {"k": [1, 2, 1, 2, 3], "v": [10, 20, 30, 40, 50]}},
        _grouped_aggregate_ints, True),
    "ungrouped_aggregate": ({"t": {"v": [1.5, 2.5, 3.0]}},
                            _ungrouped_aggregate, False),
    "string_group_perfect_hash": (
        {"t": {"s": ["x", "y", "x", "z", "y", "x"], "v": [1, 2, 3, 4, 5, 6]}},
        _string_group_perfect_hash, True),
    "inner_join": ({"l": {"k": [1, 2, 3, 2], "a": [10, 20, 30, 21]},
                    "r": {"k": [2, 3, 4], "b": [200, 300, 400]}},
                   _join("inner"), True),
    "left_join": ({"l": {"k": [1, 2], "a": [10, 20]},
                   "r": {"k": [2], "b": [200]}}, _join("left"), True),
    "semi_anti_join": ({"l": {"k": [1, 2, 3]}, "r": {"k": [2, 2, 5]}},
                       _semi_anti_join, True),
    "order_limit": ({"t": {"a": [3, 1, 2, 5, 4]}}, _order_limit, False),
    "decimal_arith_and_sum": ({"t": pa.table({"d": _DEC})},
                              _decimal_arith_and_sum, False),
    "nulls_in_aggregate": (
        {"t": pa.table({"k": [1, 1, 2, 2], "v": [10, None, None, None]})},
        _nulls_in_aggregate, True),
    "distinct": ({"t": {"a": [1, 2, 1, 3, 2]}}, _distinct, True),
    "case_expression": ({"t": {"a": [1, 2, 3]}}, _case_expression, False),
    "multikey_join": (
        {"l": {"k1": [1, 1, 2], "k2": [5, 6, 5], "a": [1, 2, 3]},
         "r": {"k1": [1, 2], "k2": [6, 5], "b": [10, 20]}},
        _multikey_join, True),
    "dates": ({"t": pa.table({"d": pa.array([datetime.date(1994, 1, 1),
                                             datetime.date(1995, 6, 15)])})},
              _dates, False),
}


def _rows(p, name):
    tables, build, unordered = CASES[name]
    con = p.connect()
    for t, data in tables.items():
        con.register(t, data)
    out = []
    for plan in build(p, con):
        rows = con.execute_plan(plan).fetchall()
        out.append(sorted(rows, key=repr) if unordered else rows)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_hand_built_plan_matches_reference(name):
    want = _rows(REF, name)
    got = _rows(PORT, name)
    assert got == want
    assert all(rows for rows in got)


def test_execute_plan_runs_on_the_connections_device():
    con = PORT.connect()
    con.register("t", {"a": [1, 2, 3]})
    res = con.execute_plan(_projection_arith(PORT, con)[0])
    assert res.batch.sel.device == con.device
    assert con.table_data("t") is con.catalog.get_table("t")

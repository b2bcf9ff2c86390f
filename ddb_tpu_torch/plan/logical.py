"""Bound logical plan nodes.

Analog of the reference's LogicalOperator tree
(reference: src/include/duckdb/planner/logical_operator.hpp, node types in
common/enums/logical_operator_type.hpp:18-100).  Expressions inside nodes
are bound (ddb_tpu.expr.ir) and reference child output columns by position.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..batch import Schema, Field
from ..expr import ir
from ..storage.table import TableData
from ..types import DataType
from .. import types as T


class LogicalNode:
    schema: Schema

    def children(self):
        return []


@dataclass
class Get(LogicalNode):
    """Table scan with projection + pushed-down filters
    (reference: function/table/table_scan.cpp filter/projection pushdown)."""
    table: TableData
    column_indices: List[int]
    filters: List[ir.Expr] = field(default_factory=list)  # over OUTPUT cols
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            fs = self.table.schema.fields
            self.schema = Schema(tuple(fs[i] for i in self.column_indices))


@dataclass
class Filter(LogicalNode):
    child: LogicalNode
    predicate: ir.Expr
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.child.schema

    def children(self):
        return [self.child]


@dataclass
class Project(LogicalNode):
    child: LogicalNode
    exprs: List[ir.Expr]
    names: List[str]
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = Schema(tuple(
                Field(n, e.dtype, getattr(e, "strdict", None))
                for n, e in zip(self.names, self.exprs)))

    def children(self):
        return [self.child]


@dataclass
class AggSpec:
    kind: str          # sum|min|max|count|count_star|avg|any_value|
    #                    var_*|stddev_*|covar_*|corr|median|quantile_*
    arg: Optional[ir.Expr]
    dtype: DataType
    name: str
    distinct: bool = False
    arg2: Optional[ir.Expr] = None     # corr/covar second argument
    quantile: Optional[float] = None   # median/quantile fraction
    interpolate: bool = False          # continuous quantile
    store: object = None       # ListStore/StringDictionary for collect/
    #                            string_agg results (host-side payloads)
    extra: object = None       # e.g. string_agg separator
    # agg(x ORDER BY ...): [(bound key expr, desc, nulls_last)] — only
    # order-sensitive aggregates (list/string_agg/first/last) honor it
    order_by: object = None


@dataclass
class Aggregate(LogicalNode):
    child: LogicalNode
    groups: List[ir.Expr]
    aggs: List[AggSpec]
    group_names: List[str] = None
    schema: Schema = None

    def __post_init__(self):
        if self.group_names is None:
            self.group_names = [f"g{i}" for i in range(len(self.groups))]
        if self.schema is None:
            fs = [Field(n, g.dtype, getattr(g, "strdict", None))
                  for n, g in zip(self.group_names, self.groups)]
            fs += [Field(a.name, a.dtype,
                         a.store if a.store is not None else (
                             getattr(a.arg, "strdict", None)
                             if a.kind in ("min", "max", "any_value")
                             and a.arg is not None else None))
                   for a in self.aggs]
            self.schema = Schema(tuple(fs))

    def children(self):
        return [self.child]


@dataclass
class JoinCond:
    left: ir.Expr      # over left child columns
    right: ir.Expr     # over right child columns


@dataclass
class Join(LogicalNode):
    """Equi-join; build side = right, probe side = left (matches the
    reference's PhysicalHashJoin orientation, physical_hash_join.cpp)."""
    left: LogicalNode
    right: LogicalNode
    join_type: str                 # inner|left|right|full|semi|anti|mark
    conds: List[JoinCond]
    extra: Optional[ir.Expr] = None   # residual predicate over concat schema
    mark_name: str = "mark"
    # inequality driver when conds is empty: (left_expr, op, right_expr),
    # op ∈ {<,<=,>,>=} — sort-based range join (reference:
    # physical_piecewise_merge_join.cpp / physical_iejoin.cpp); additional
    # inequalities land in `extra` (IEJoin-style residual filtering)
    range_cond: Optional[tuple] = None
    # AsOf join: conds are the (optional) equality keys and range_cond is
    # the time inequality; each probe row matches at most the nearest
    # build row (reference: physical_asof_join.cpp)
    asof: bool = False
    # 3-valued mark join: conds[0] is an IN-value condition (the rest are
    # correlation equalities); the mark column is NULL where no match was
    # found but the probe value is NULL (vs a non-empty build side) or a
    # correlation-matching build row carries a NULL IN-value (reference:
    # ScanStructure::NextMarkJoin NULL semantics, join_hashtable.cpp)
    mark_in: bool = False
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            lf = list(self.left.schema.fields)
            rf = list(self.right.schema.fields)
            if self.join_type in ("semi", "anti"):
                fs = lf
            elif self.join_type == "mark":
                fs = lf + [Field(self.mark_name, T.BOOLEAN, None)]
            else:
                fs = lf + rf
            self.schema = Schema(tuple(fs))

    def children(self):
        return [self.left, self.right]


@dataclass
class CrossProduct(LogicalNode):
    left: LogicalNode
    right: LogicalNode
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = Schema(tuple(list(self.left.schema.fields)
                                       + list(self.right.schema.fields)))

    def children(self):
        return [self.left, self.right]


@dataclass
class Positional(LogicalNode):
    """POSITIONAL JOIN: row i pairs with row i; the shorter side is
    NULL-padded (reference: physical_positional_join.cpp)."""
    left: LogicalNode
    right: LogicalNode
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = Schema(tuple(list(self.left.schema.fields)
                                       + list(self.right.schema.fields)))

    def children(self):
        return [self.left, self.right]


@dataclass
class OrderKey:
    expr: ir.Expr
    desc: bool = False
    nulls_last: bool = True


@dataclass
class WindowFn:
    kind: str                      # row_number|rank|dense_rank|sum|...
    arg: Optional[ir.Expr]
    partition: List[ir.Expr]
    order: List[OrderKey]
    dtype: DataType
    name: str
    offset: int = 1                # lag/lead offset; nth_value's n
    strdict: object = None
    # frame: (kind, preceding, following[, exclude]) with kind in
    # rows|range|groups; None component = unbounded; frame=None =>
    # dialect default (RANGE unbounded-preceding..current)
    frame: Optional[tuple] = None
    # DISTINCT aggregate argument (count/sum/avg DISTINCT over the
    # partition; reference: window_distinct_aggregator.cpp)
    distinct: bool = False


@dataclass
class Window(LogicalNode):
    """Appends one column per window function to the child's schema
    (reference: operator/aggregate/physical_window.cpp)."""
    child: LogicalNode
    fns: List[WindowFn]
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            fs = list(self.child.schema.fields) + [
                Field(f.name, f.dtype, f.strdict) for f in self.fns]
            self.schema = Schema(tuple(fs))

    def children(self):
        return [self.child]


@dataclass
class Order(LogicalNode):
    child: LogicalNode
    keys: List[OrderKey]
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.child.schema

    def children(self):
        return [self.child]


@dataclass
class Limit(LogicalNode):
    child: LogicalNode
    limit: Optional[int]
    offset: int = 0
    # LIMIT n%: keep floor(count*percent/100) rows (reference:
    # physical_limit_percent.cpp)
    percent: Optional[float] = None
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.child.schema

    def children(self):
        return [self.child]


@dataclass
class Sample(LogicalNode):
    """USING SAMPLE / TABLESAMPLE (reference:
    operator/helper/physical_reservoir_sample.cpp,
    physical_streaming_sample.cpp).  method ∈ {rows, percent}."""
    child: LogicalNode
    method: str
    amount: float             # row count or percentage
    seed: int = 42
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.child.schema

    def children(self):
        return [self.child]


@dataclass
class Distinct(LogicalNode):
    child: LogicalNode
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.child.schema

    def children(self):
        return [self.child]


@dataclass
class Union(LogicalNode):
    """UNION ALL (set-op UNION = Distinct(Union))."""
    left: LogicalNode
    right: LogicalNode
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.left.schema

    def children(self):
        return [self.left, self.right]


class CTECell:
    """Host-side mailbox carrying the recursive CTE working table between
    iterations (the analog of the reference's recurring ColumnDataCollection
    in PhysicalRecursiveCTE, operator/set/physical_recursive_cte.cpp)."""

    def __init__(self):
        self.batch = None


@dataclass
class Materialize(LogicalNode):
    """Execution barrier shared by multiple plan parents: the child runs
    ONCE per query (per-context memo) and every referencing site reads the
    same concrete result.  Used for CTEs referenced more than once, which
    otherwise re-bind, re-compile, and re-execute per reference
    (reference: materialized CTEs, operator/set/physical_cte.cpp).
    The optimizer treats it as a leaf so plan rewrites cannot clone the
    shared subtree apart."""
    child: LogicalNode
    name: str = ""
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.child.schema

    def children(self):
        return [self.child]


@dataclass
class CTERef(LogicalNode):
    """Reference to the recursive CTE's working table inside the
    recursive half of the union (reference: LOGICAL_CTE_REF /
    physical_cte_ref via operator/scan/physical_column_data_scan.cpp)."""
    name: str
    schema: Schema
    cell: CTECell = None


@dataclass
class RecursiveCTE(LogicalNode):
    """WITH RECURSIVE t AS (base UNION [ALL] recursive)
    (reference: operator/set/physical_recursive_cte.cpp) — executed as a
    host-driven fixpoint loop over jitted iteration kernels."""
    base: LogicalNode
    recursive: LogicalNode
    union_all: bool
    cell: CTECell
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.base.schema

    def children(self):
        return [self.base, self.recursive]


def explain(node: LogicalNode, indent: int = 0) -> str:
    pad = "  " * indent
    name = type(node).__name__
    extra = ""
    if isinstance(node, Get):
        extra = f" {node.table.name}{node.column_indices}" + \
            (f" filters={node.filters}" if node.filters else "")
    elif isinstance(node, Filter):
        extra = f" {node.predicate}"
    elif isinstance(node, Project):
        extra = f" {node.names}"
    elif isinstance(node, Aggregate):
        extra = f" groups={len(node.groups)} aggs={[a.kind for a in node.aggs]}"
    elif isinstance(node, Join):
        extra = f" {node.join_type}"
    out = f"{pad}{name}{extra}\n"
    for c in node.children():
        out += explain(c, indent + 1)
    return out


@dataclass
class Unnest(LogicalNode):
    """Expand one LIST column into rows (reference:
    src/execution/operator/projection/physical_unnest.cpp).  Other columns
    repeat per element; NULL/empty lists contribute zero rows."""
    child: LogicalNode
    index: int                 # which output column of child is the list
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            fs = list(self.child.schema.fields)
            f = fs[self.index]
            et = f.dtype.child if f.dtype.child is not None else T.INTEGER
            sd = None
            if et.id == T.TypeId.VARCHAR:
                import numpy as np
                from ..storage.strings import StringDictionary
                sd = StringDictionary(np.array([], dtype=object))
            fs[self.index] = Field(f.name, et, sd)
            self.schema = Schema(tuple(fs))

    def children(self):
        return [self.child]


@dataclass
class TopN(LogicalNode):
    """ORDER BY + LIMIT fused (reference: src/optimizer/topn_optimizer.cpp,
    operator/order/physical_top_n.cpp).  TPU design: sort ONLY the encoded
    keys + row ids, then gather limit+offset rows per column — avoids
    carrying every payload column through the sort."""
    child: LogicalNode
    keys: List[OrderKey]
    limit: int
    offset: int = 0
    schema: Schema = None

    def __post_init__(self):
        if self.schema is None:
            self.schema = self.child.schema

    def children(self):
        return [self.child]

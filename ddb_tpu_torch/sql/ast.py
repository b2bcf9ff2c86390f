"""Unbound SQL AST.

Analog of the reference's ParsedExpression/SQLStatement/TableRef hierarchies
(reference: src/include/duckdb/parser/parsed_expression.hpp,
sql_statement.hpp, tableref/*).  Produced by sql/parser.py, consumed by
sql/binder.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple


# ---- expressions ----------------------------------------------------------

class EExpr:
    pass


@dataclass
class EIdent(EExpr):
    parts: List[str]          # ["t", "col"] or ["col"]


@dataclass
class ELit(EExpr):
    value: Any                # int | float | Decimal | str | bool | None


@dataclass
class ETyped(EExpr):
    """Typed literal: DATE '1994-01-01', INTERVAL '3' MONTH, TIMESTAMP ..."""
    typename: str
    text: str
    qualifier: Optional[str] = None   # interval unit


@dataclass
class EBinary(EExpr):
    op: str
    left: EExpr
    right: EExpr


@dataclass
class EUnary(EExpr):
    op: str                   # '-' | 'not'
    child: EExpr


@dataclass
class EFunc(EExpr):
    name: str
    args: List[EExpr]
    distinct: bool = False
    star: bool = False        # count(*)
    order: List = None        # agg(x ORDER BY ...) modifier


@dataclass
class EWindow(EExpr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ... [frame])."""
    func: "EFunc"
    partition: List[EExpr] = field(default_factory=list)
    order: List["OrderItem"] = field(default_factory=list)
    frame: Optional[str] = None       # None => dialect default
    ref: Optional[str] = None         # OVER window_name (WINDOW clause)


@dataclass
class EQuant(EExpr):
    """Quantified comparison: expr op ANY/ALL (subquery)
    (reference: src/parser/expression/subquery_expression.hpp ANY/ALL)."""
    op: str
    child: EExpr
    subquery: object
    is_all: bool = False


@dataclass
class ECase(EExpr):
    operand: Optional[EExpr]
    whens: List[Tuple[EExpr, EExpr]]
    else_: Optional[EExpr]


@dataclass
class ECast(EExpr):
    child: EExpr
    typename: str
    width: int = 0
    scale: int = 0
    try_: bool = False          # TRY_CAST: unparsable values become NULL


@dataclass
class EBetween(EExpr):
    child: EExpr
    lo: EExpr
    hi: EExpr
    negated: bool = False


@dataclass
class EIn(EExpr):
    child: EExpr
    items: Optional[List[EExpr]] = None      # literal list
    subquery: Optional["SelectStmt"] = None
    negated: bool = False


@dataclass
class EExists(EExpr):
    subquery: "SelectStmt"
    negated: bool = False


@dataclass
class ESub(EExpr):
    """Scalar subquery."""
    subquery: "SelectStmt"


@dataclass
class EIsNull(EExpr):
    child: EExpr
    negated: bool = False


@dataclass
class ELike(EExpr):
    child: EExpr
    pattern: EExpr
    negated: bool = False


@dataclass
class EStar(EExpr):
    prefix: Optional[str] = None   # t.* vs *


@dataclass
class ELambda(EExpr):
    """Lambda argument of list functions: x -> body, (x,y) -> body,
    or lambda x: body (reference: lambda_expression.hpp)."""
    params: List[str]
    body: EExpr


@dataclass
class EParam(EExpr):
    """Prepared-statement parameter: ? (positional) or $n."""
    index: Optional[int] = None    # None => next positional


# ---- table refs -----------------------------------------------------------

class TableRef:
    pass


@dataclass
class RBase(TableRef):
    name: str
    alias: Optional[str] = None


@dataclass
class RSubquery(TableRef):
    select: "SelectStmt"
    alias: str
    column_aliases: Optional[List[str]] = None
    lateral: bool = False     # LATERAL (…): may reference columns of
    # earlier FROM items (reference: LATERAL join binding,
    # src/planner/binder/tableref/bind_joinref.cpp lateral handling)


@dataclass
class RValues(TableRef):
    rows: List[List[EExpr]] = field(default_factory=list)
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None


@dataclass
class RFunction(TableRef):
    name: str
    args: List = field(default_factory=list)   # literal values
    alias: Optional[str] = None
    kwargs: dict = field(default_factory=dict)  # named args (delim=..., …)
    column_aliases: Optional[List[str]] = None  # t(a, b) renames


@dataclass
class SampleSpec:
    method: str               # rows | percent
    amount: float
    seed: int = 42


@dataclass
class RSampleRef(TableRef):
    """<table-ref> TABLESAMPLE <spec>."""
    ref: TableRef
    spec: SampleSpec


@dataclass
class RJoin(TableRef):
    left: TableRef
    right: TableRef
    join_type: str            # inner|left|right|full|cross
    on: Optional[EExpr] = None
    using: Optional[List[str]] = None
    asof: bool = False        # ASOF JOIN (nearest-match inequality)
    natural: bool = False     # NATURAL JOIN: USING = common column names


# ---- statements -----------------------------------------------------------

@dataclass
class OrderItem:
    expr: EExpr
    desc: Optional[bool] = None         # None => default_order setting
    nulls_last: Optional[bool] = None   # None => dialect default


@dataclass
class CTEDef:
    name: str
    select: "SelectStmt"
    cols: Optional[List[str]] = None      # column alias list
    recursive: bool = False               # WITH RECURSIVE was present


@dataclass
class SelectStmt:
    items: List[Tuple[EExpr, Optional[str]]] = field(default_factory=list)
    distinct: bool = False
    from_refs: List[TableRef] = field(default_factory=list)
    where: Optional[EExpr] = None
    group_by: List[EExpr] = field(default_factory=list)
    group_by_all: bool = False     # GROUP BY ALL: every non-agg item
    # GROUPING SETS/ROLLUP/CUBE: index lists into group_by; None = plain
    grouping_sets: Optional[List[List[int]]] = None
    sample: Optional["SampleSpec"] = None     # USING SAMPLE
    having: Optional[EExpr] = None
    qualify: Optional[EExpr] = None   # QUALIFY: filter on window output
    distinct_on: Optional[List[EExpr]] = None  # DISTINCT ON (exprs)
    order_by: List[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    limit_expr: Optional[EExpr] = None       # non-literal LIMIT
    offset_expr: Optional[EExpr] = None      # non-literal OFFSET
    limit_percent: Optional[EExpr] = None    # LIMIT n% / n PERCENT
    ctes: List[Tuple[str, "SelectStmt"]] = field(default_factory=list)
    # set operation: this node represents `set_left <op> <rhs>`;
    # items/from_refs are unused when set_op is present
    set_op: Optional[Tuple[str, "SelectStmt", bool]] = None  # (op, rhs, all)
    set_left: Optional["SelectStmt"] = None


@dataclass
class CreateView:
    name: str
    sql_text: str
    or_replace: bool = False
    column_aliases: Optional[List[str]] = None


@dataclass
class CreateMacro:
    """CREATE MACRO name(params) AS expr | AS TABLE select
    (reference: src/parser/parsed_data/create_macro_info.hpp)."""
    name: str
    params: List[str]
    defaults: dict              # param -> default expr source text
    body: str                   # expression / SELECT source text
    is_table: bool = False
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class CreateTableAs:
    name: str
    select: SelectStmt
    or_replace: bool = False


@dataclass
class DescribeStmt:
    """DESCRIBE/SUMMARIZE table-or-query (reference: DESCRIBE pragma
    rewrite, src/parser/statement/relation_statement.cpp + SUMMARIZE
    rewrite in the shell)."""
    table: Optional[str]
    select: Optional["SelectStmt"]
    summarize: bool = False


@dataclass
class CreateType:
    """CREATE TYPE name AS ENUM (...) (reference: enum logical type,
    src/parser/parsed_data/create_type_info.hpp)."""
    name: str
    values: List[str]
    or_replace: bool = False


@dataclass
class CreateSchema:
    name: str
    if_not_exists: bool = False


@dataclass
class CreateSequence:
    name: str
    start: int = 1
    increment: int = 1
    if_not_exists: bool = False


@dataclass
class CreateIndex:
    name: str
    table: str
    columns: List[str]
    unique: bool = False
    if_not_exists: bool = False


@dataclass
class DropStmt:
    kind: str                 # table | view | secret | type
    name: str
    if_exists: bool = False
    cascade: bool = False     # DROP ... CASCADE drops dependents too


@dataclass
class CreateSecret:
    """CREATE [PERSISTENT] SECRET name (TYPE t, key val, ...)
    (reference: SecretManager, src/main/secret/secret_manager.hpp:88)."""
    name: Optional[str]
    pairs: dict
    persistent: bool = False
    or_replace: bool = False
    if_not_exists: bool = False


@dataclass
class ColumnDef:
    name: str
    typename: str
    width: int = 0
    scale: int = 0
    not_null: bool = False
    primary_key: bool = False
    unique: bool = False
    default: Optional[str] = None   # DEFAULT expression source text
    # column-level REFERENCES parent(col): (parent_table, [cols] or None)
    references: Optional[tuple] = None
    collation: Optional[str] = None   # column-level COLLATE name


@dataclass
class EDefault:
    """The DEFAULT keyword inside INSERT VALUES rows (reference:
    src/parser/expression/default_expression.hpp)."""
    pass


@dataclass
class CreateTable:
    name: str
    columns: List[ColumnDef]
    or_replace: bool = False
    if_not_exists: bool = False
    # table-level constraints: [("primary_key"|"unique", [col, ...]), ...]
    constraints: List = field(default_factory=list)
    # FOREIGN KEY constraints: [([cols], parent_table, [parent_cols]), ...]
    # (reference: ForeignKeyConstraint, src/parser/constraint.hpp)
    foreign_keys: List = field(default_factory=list)


@dataclass
class InsertStmt:
    table: str
    columns: Optional[List[str]] = None
    values: Optional[List[List[EExpr]]] = None   # VALUES rows
    select: Optional[SelectStmt] = None


@dataclass
class DeleteStmt:
    table: str
    where: Optional[EExpr] = None


@dataclass
class UpdateStmt:
    table: str
    assignments: List[Tuple[str, EExpr]] = field(default_factory=list)
    where: Optional[EExpr] = None


@dataclass
class TransactionStmt:
    kind: str                 # begin | commit | rollback


@dataclass
class ExplainStmt:
    stmt: "SelectStmt"
    analyze: bool = False


@dataclass
class SetStmt:
    name: str
    value: object


@dataclass
class SetVariableStmt:
    name: str
    value: object          # expression AST


@dataclass
class PragmaStmt:
    name: str
    args: List = field(default_factory=list)


@dataclass
class CopyStmt:
    target: object            # table name (str) or SelectStmt
    path: str
    direction: str            # "to" | "from"
    format: str = "csv"
    # DELIMITER/HEADER/... copy options (reference: copy_info.hpp)
    options: dict = field(default_factory=dict)


@dataclass
class ExportStmt:
    """EXPORT DATABASE 'dir' (FORMAT ..., DELIMITER ..., HEADER ...)
    (reference: physical_export.cpp)."""
    path: str
    options: dict


@dataclass
class ImportStmt:
    """IMPORT DATABASE 'dir' — replays schema.sql + load.sql."""
    path: str


@dataclass
class PrepareStmt:
    name: str
    sql_text: str             # body re-parsed at EXECUTE with params bound


@dataclass
class ExecuteStmt:
    name: str
    args: List = field(default_factory=list)   # literal python values


@dataclass
class DeallocateStmt:
    name: Optional[str]       # None => deallocate all


@dataclass
class AlterStmt:
    """ALTER TABLE (reference: src/execution/operator/schema/
    physical_alter.cpp, parser/statement/alter_statement.cpp)."""
    table: str
    action: str               # rename_table|rename_column|add_column|
    #                           drop_column
    name: Optional[str] = None        # column (or new table name)
    new_name: Optional[str] = None
    coltype: Optional[tuple] = None   # (typename, width, scale)
    if_exists: bool = False


@dataclass
class CheckpointStmt:
    """CHECKPOINT / FORCE CHECKPOINT (reference: function/table/
    checkpoint.cpp; storage_manager.cpp CreateCheckpoint)."""
    force: bool = False


@dataclass
class AttachStmt:
    path: str
    name: Optional[str] = None        # defaults to file stem
    read_only: bool = False


@dataclass
class DetachStmt:
    name: str


@dataclass
class PivotStmt:
    """Simplified PIVOT (reference: parser/statement/pivot_statement.cpp,
    transform/tableref/transform_pivot.cpp): rewritten at execution into
    one CASE-filtered aggregate per pivot value."""
    source: TableRef
    on_col: str
    in_values: Optional[List] = None     # None => discover distinct values
    using: List = field(default_factory=list)   # [(EFunc, alias|None)]
    group_by: List[str] = field(default_factory=list)


@dataclass
class UnpivotStmt:
    """UNPIVOT: columns -> (name, value) rows via UNION ALL rewrite."""
    source: TableRef
    on_cols: List[str] = field(default_factory=list)
    name_col: str = "name"
    value_col: str = "value"


@dataclass
class EList(EExpr):
    """List literal [e1, e2, ...]."""
    items: List[EExpr] = field(default_factory=list)


@dataclass
class EStruct(EExpr):
    """Struct literal {'a': e1, ...} / struct_pack(a := e1, ...)."""
    fields: List = field(default_factory=list)   # [(name, EExpr), ...]


@dataclass
class EMap(EExpr):
    """Map literal MAP {k1: v1, ...}."""
    entries: List = field(default_factory=list)  # [(EExpr, EExpr), ...]


@dataclass
class EIndex(EExpr):
    """Postfix subscript: list[i] (1-based), map[key], struct['field']."""
    child: EExpr
    index: EExpr


@dataclass
class ECollate(EExpr):
    """expr COLLATE name (nocase | noaccent | nocase.noaccent)."""
    child: EExpr
    collation: str

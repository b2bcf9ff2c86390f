"""Binder: unbound AST -> bound logical plan.

Analog of the reference's Binder (reference: src/planner/binder.hpp:102,
expression binders in src/planner/expression_binder/, subquery flattening in
src/planner/subquery/).  TPU-specific responsibilities on top of name/type
resolution:

* VARCHAR rewriting: every string operation is turned into integer-code
  operations against host-side sorted dictionaries (comparisons become code
  thresholds, LIKE becomes a per-code boolean table, string functions
  become code->code translation tables) — no string ever reaches the device.
* Subquery flattening: EXISTS/IN -> semi/anti joins; correlated scalar
  aggregate subqueries -> grouped aggregate + LEFT join on the correlation
  keys (the reference's flatten-dependent-join pass).
"""

from __future__ import annotations

import decimal
from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import types as T
from ..batch import Field, Schema
from ..catalog import Catalog, CatalogException
from ..expr import ir
from ..expr.functions import add_months_host, days_from_civil
from ..plan import logical as L
from ..storage.strings import StringDictionary
from ..types import DataType, TypeId
from . import ast as A


class BindError(Exception):
    pass


class ConversionError(BindError):
    """String value cannot be cast to the target type (reference:
    ConversionException, src/common/exception/conversion_exception.cpp)."""


class InvalidInputError(BindError):
    """Raised by error() and malformed runtime input (reference:
    InvalidInputException)."""


class OutOfRangeError(BindError):
    """Value outside the valid domain (reference: OutOfRangeException,
    e.g. get_bit/set_bit index checks)."""


AGG_FUNCS = {"sum", "count", "avg", "min", "max", "any_value", "first",
             "stddev", "stddev_samp", "stddev_pop", "var_samp", "var_pop",
             "variance", "median", "quantile", "quantile_cont",
             "quantile_disc", "corr", "covar_pop", "covar_samp",
             "bool_and", "bool_or", "approx_count_distinct", "mode",
             "arg_min", "arg_max", "argmin", "argmax", "min_by",
             "arg_min_null", "arg_max_null",
             "max_by", "histogram", "histogram_exact", "approx_top_k",
             "product", "list", "array_agg", "string_agg", "mad",
             "group_concat", "bit_and", "bit_or", "bit_xor", "entropy",
             "last"}

# alias -> canonical function name (reference: the *_ALIAS entries of
# src/function/function_list.cpp / extension/core_functions)
FUNC_ALIASES = {
    "ceiling": "ceil", "mean": "avg", "arbitrary": "first",
    "fmod": "mod", "fdiv": "divide", "pow": "power",
    "listagg": "string_agg", "favg": "avg", "fsum": "sum",
    "sumkahan": "sum", "kahan_sum": "sum",
    "countif": "count_if", "datediff": "date_diff",
    "datesub": "date_sub", "datepart": "date_part",
    "datetrunc": "date_trunc", "greatest_common_divisor": "gcd",
    "least_common_multiple": "lcm", "approx_quantile": "quantile",
    "reservoir_quantile": "quantile", "weekday": "dayofweek",
    "stddev": "stddev_samp", "kurtosis_samp": "kurtosis",
    "str_split_regex": "string_split_regex",
    "regexp_split_to_array": "string_split_regex",
    "list_cat": "list_concat", "array_cat": "list_concat",
    "array_concat": "list_concat",
    "list_value": "list_pack", "array_value": "list_pack",
    "array_distinct": "list_distinct", "array_unique": "list_unique",
    "array_reverse_sort": "list_reverse_sort",
    "array_indexof": "list_position", "list_indexof": "list_position",
    "array_has": "list_contains", "array_contains": "list_contains",
    "array_has_all": "list_has_all", "array_has_any": "list_has_any",
    "array_aggr": "list_aggregate", "list_aggr": "list_aggregate",
    "aggregate": "list_aggregate",
    "array_aggregate": "list_aggregate",
    "array_transform": "list_transform", "list_apply": "list_transform",
    "array_apply": "list_transform", "apply": "list_transform",
    "array_filter": "list_filter", "filter": "list_filter",
    "list_where": "list_select_mask_where",
    "array_where": "list_select_mask_where",
    "array_reduce": "list_reduce", "reduce": "list_reduce",
    "array_zip": "list_zip", "array_resize": "list_resize",
    "array_select": "list_select", "array_grade_up": "list_grade_up",
    "grade_up": "list_grade_up",
    "array_cosine_similarity": "list_cosine_similarity",
    "array_cosine_distance": "list_cosine_distance",
    "array_distance": "list_distance",
    "array_dot_product": "list_dot_product",
    "array_inner_product": "list_dot_product",
    "list_inner_product": "list_dot_product",
    "array_negative_dot_product": "list_negative_dot_product",
    "array_negative_inner_product": "list_negative_dot_product",
    "list_negative_inner_product": "list_negative_dot_product",
    "to_base64": "base64", "sha-1": "sha1",
}

# temporal functions whose TIMESTAMPTZ arguments are evaluated in the
# session TimeZone (instant -> wall shift before the naive kernel;
# reference: ICU function overloads, extension/icu/icu-datefunc.cpp).
# epoch*/to_* are instant-based and deliberately absent.
_TZ_WALL_FUNCS = frozenset([
    "year", "month", "day", "minute", "hour", "second", "millisecond",
    "microsecond", "date_part", "date_trunc", "quarter", "dayofweek",
    "dow", "isodow", "dayofmonth", "dayofyear", "doy", "week",
    "weekofyear", "isoyear", "century", "decade", "millennium",
    "yearweek", "last_day", "monthname", "dayname", "strftime",
    "time_bucket", "date_diff", "datediff", "date_sub", "date_add",
    "age", "ts_date",
])

# builtin aggregates implemented as macro rewrites: AST-level aggregate
# detection must treat them as aggregates before expansion
AGG_MACROS = {"count_if", "regr_count", "regr_avgx", "regr_avgy",
              "regr_sxx", "regr_syy", "regr_sxy", "regr_slope",
              "regr_intercept", "regr_r2", "skewness", "kurtosis",
              "kurtosis_pop", "sem"}

_BUILTIN_MACROS = {
    # reference: src/catalog/default/default_functions.cpp implements
    # several of these the same way (SQL macro over primitives)
    "mod": {"params": ["a", "b"], "defaults": {}, "body": "a % b"},
    "add": {"params": ["a", "b"], "defaults": {}, "body": "a + b"},
    "subtract": {"params": ["a", "b"], "defaults": {}, "body": "a - b"},
    "multiply": {"params": ["a", "b"], "defaults": {}, "body": "a * b"},
    "divide": {"params": ["a", "b"], "defaults": {}, "body": "a // b"},
    "count_if": {"params": ["a"], "defaults": {}, "body":
                 "coalesce(sum(CASE WHEN a THEN 1 ELSE 0 END), 0)"},
    "julian": {"params": ["x"], "defaults": {}, "body":
               "epoch(x) / 86400.0 + 2440587.5"},
    "era": {"params": ["x"], "defaults": {}, "body":
            "CASE WHEN year(x) > 0 THEN 1 ELSE 0 END"},
    "nanosecond": {"params": ["x"], "defaults": {}, "body":
                   "microsecond(x) * 1000"},
    "constant_or_null": {"params": ["a", "b"], "defaults": {}, "body":
                         "CASE WHEN b IS NULL THEN NULL ELSE a END"},
    # regr_* family over pairwise-non-null rows
    # (reference: core_functions/aggregate/regression/*)
    "regr_count": {"params": ["y", "x"], "defaults": {}, "body":
                   "count(CASE WHEN y IS NOT NULL AND x IS NOT NULL "
                   "THEN 1 END)"},
    "regr_avgy": {"params": ["y", "x"], "defaults": {}, "body":
                  "avg(CASE WHEN x IS NOT NULL THEN y END)"},
    "regr_avgx": {"params": ["y", "x"], "defaults": {}, "body":
                  "avg(CASE WHEN y IS NOT NULL THEN x END)"},
    "regr_sxx": {"params": ["y", "x"], "defaults": {}, "body":
                 "regr_count(y, x) * var_pop("
                 "CASE WHEN y IS NOT NULL THEN x END)"},
    "regr_syy": {"params": ["y", "x"], "defaults": {}, "body":
                 "regr_count(y, x) * var_pop("
                 "CASE WHEN x IS NOT NULL THEN y END)"},
    "regr_sxy": {"params": ["y", "x"], "defaults": {}, "body":
                 "regr_count(y, x) * covar_pop(y, x)"},
    "regr_slope": {"params": ["y", "x"], "defaults": {}, "body":
                   "CASE WHEN var_pop(CASE WHEN y IS NOT NULL THEN x "
                   "END) = 0 THEN NULL ELSE covar_pop(y, x) / var_pop("
                   "CASE WHEN y IS NOT NULL THEN x END) END"},
    "regr_intercept": {"params": ["y", "x"], "defaults": {}, "body":
                       "regr_avgy(y, x) - regr_slope(y, x) * "
                       "regr_avgx(y, x)"},
    "regr_r2": {"params": ["y", "x"], "defaults": {}, "body":
                "CASE WHEN regr_syy(y, x) = 0 THEN "
                "(CASE WHEN regr_sxx(y, x) = 0 THEN NULL ELSE 1 END) "
                "ELSE pow(corr(y, x), 2) END"},
    # moment statistics over power sums — numerically identical to the
    # reference states (core_functions/aggregate/distributive/skew.cpp,
    # kurtosis.cpp; algebraic/stddev.hpp StandardErrorOfTheMean)
    "sem": {"params": ["x"], "defaults": {}, "body":
            "sqrt(var_pop(x) / count(x))"},
    "skewness": {"params": ["x"], "defaults": {}, "body": """
        CASE WHEN count(x) <= 2 THEN NULL ELSE
          (sqrt(count(x) * (count(x) - 1.0)) / (count(x) - 2.0))
          * (1.0 / count(x))
          * (sum(CAST(x AS DOUBLE) * x * x)
             - 3 * sum(CAST(x AS DOUBLE) * x) * sum(CAST(x AS DOUBLE))
               / count(x)
             + 2 * pow(sum(CAST(x AS DOUBLE)), 3)
               / count(x) / count(x))
          / sqrt(pow(greatest(
              (sum(CAST(x AS DOUBLE) * x)
               - sum(CAST(x AS DOUBLE)) * sum(CAST(x AS DOUBLE))
                 / count(x)) / count(x), 0.0), 3))
        END"""},
    "kurtosis": {"params": ["x"], "defaults": {}, "body": """
        CASE WHEN count(x) <= 3 OR
          (sum(CAST(x AS DOUBLE) * x)
           - sum(CAST(x AS DOUBLE)) * sum(CAST(x AS DOUBLE)) / count(x))
          = 0 THEN NULL ELSE
          (count(x) - 1.0) *
          ((count(x) + 1.0) *
           ((sum(CAST(x AS DOUBLE) * x * x * x)
             - 4 * sum(CAST(x AS DOUBLE) * x * x)
               * sum(CAST(x AS DOUBLE)) / count(x)
             + 6 * sum(CAST(x AS DOUBLE) * x)
               * pow(sum(CAST(x AS DOUBLE)) / count(x), 2)
             - 3 * pow(sum(CAST(x AS DOUBLE)), 4)
               / pow(CAST(count(x) AS DOUBLE), 3)) / count(x))
           / pow((sum(CAST(x AS DOUBLE) * x)
                  - sum(CAST(x AS DOUBLE)) * sum(CAST(x AS DOUBLE))
                    / count(x)) / count(x), 2)
           - 3 * (count(x) - 1.0))
          / ((count(x) - 2.0) * (count(x) - 3.0))
        END"""},
    "kurtosis_pop": {"params": ["x"], "defaults": {}, "body": """
        CASE WHEN count(x) = 0 OR
          (sum(CAST(x AS DOUBLE) * x)
           - sum(CAST(x AS DOUBLE)) * sum(CAST(x AS DOUBLE)) / count(x))
          = 0 THEN NULL ELSE
          ((sum(CAST(x AS DOUBLE) * x * x * x)
            - 4 * sum(CAST(x AS DOUBLE) * x * x)
              * sum(CAST(x AS DOUBLE)) / count(x)
            + 6 * sum(CAST(x AS DOUBLE) * x)
              * pow(sum(CAST(x AS DOUBLE)) / count(x), 2)
            - 3 * pow(sum(CAST(x AS DOUBLE)), 4)
              / pow(CAST(count(x) AS DOUBLE), 3)) / count(x))
          / pow((sum(CAST(x AS DOUBLE) * x)
                 - sum(CAST(x AS DOUBLE)) * sum(CAST(x AS DOUBLE))
                   / count(x)) / count(x), 2)
          - 3.0
        END"""},
}

_TYPE_MAP = {
    "int": T.INTEGER, "integer": T.INTEGER, "int4": T.INTEGER,
    "bigint": T.BIGINT, "int8": T.BIGINT, "hugeint": T.HUGEINT,
    "smallint": T.SMALLINT, "int2": T.SMALLINT, "tinyint": T.TINYINT,
    "double": T.DOUBLE, "float8": T.DOUBLE, "real": T.FLOAT,
    "float": T.FLOAT, "boolean": T.BOOLEAN, "bool": T.BOOLEAN,
    "date": T.DATE, "timestamp": T.TIMESTAMP, "time": T.TIME,
    "varchar": T.VARCHAR, "text": T.VARCHAR, "string": T.VARCHAR,
    "char": T.VARCHAR, "bpchar": T.VARCHAR,
    "blob": T.BLOB, "bytea": T.BLOB, "varbinary": T.BLOB,
    "binary": T.BLOB, "uuid": T.UUID, "interval": T.INTERVAL,
    "utinyint": T.SMALLINT, "usmallint": T.INTEGER,
    "uinteger": T.BIGINT, "ubigint": T.BIGINT, "uhugeint": T.HUGEINT,
    # numeric-style aliases (reference: LogicalType aliases in
    # src/common/types.cpp — int32, float4, etc.)
    "int1": T.TINYINT, "int16": T.SMALLINT, "int32": T.INTEGER,
    "int64": T.BIGINT, "int128": T.HUGEINT, "short": T.SMALLINT,
    "long": T.BIGINT, "signed": T.INTEGER, "float4": T.FLOAT,
    "float32": T.FLOAT, "float64": T.DOUBLE, "uint8": T.SMALLINT,
    "uint16": T.INTEGER, "uint32": T.BIGINT, "uint64": T.BIGINT,
    "oid": T.BIGINT, "logical": T.BOOLEAN, "datetime": T.TIMESTAMP,
    "nvarchar": T.VARCHAR,
}


def _split_top(s: str, sep: str):
    """Split on sep at angle-bracket depth 0 (nested type encodings)."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def resolve_typename(typename: str, width: int = 0, scale: int = 0
                     ) -> DataType:
    # dispatch on the lowered name but slice member NAMES from the
    # original string: struct keys are case-insensitive but
    # case-PRESERVING (reference: StructType::GetChildName)
    tn = typename.lower()
    if tn in ("decimal", "numeric"):
        return T.DECIMAL(width or 18, scale)
    if tn in ("timestamptz", "timetz"):
        return T.TIMESTAMPTZ if tn == "timestamptz" else T.TIMETZ
    if tn.startswith("list<") and tn.endswith(">"):
        inner, iw, isc = typename[5:-1].rsplit(":", 2)
        return T.LIST(resolve_typename(inner, int(iw), int(isc)))
    if tn.startswith("struct<") and tn.endswith(">"):
        members = []
        for part in _split_top(typename[7:-1], ","):
            mn, rest = part.split(":", 1)
            mt, mw, ms = rest.rsplit(":", 2)
            members.append((mn, resolve_typename(mt, int(mw), int(ms))))
        return T.STRUCT(members)
    if tn.startswith("map<") and tn.endswith(">"):
        kp, vp = _split_top(typename[4:-1], ",")
        kt, kw_, ks = kp.rsplit(":", 2)
        vt, vw, vs = vp.rsplit(":", 2)
        return T.MAP(resolve_typename(kt, int(kw_), int(ks)),
                     resolve_typename(vt, int(vw), int(vs)))
    if tn.startswith("union<") and tn.endswith(">"):
        members = []
        for part in typename[6:-1].split(","):
            mn, mt, mw, ms = part.split(":")
            members.append((mn, resolve_typename(mt, int(mw), int(ms))))
        return T.UNION(members)
    if tn not in _TYPE_MAP:
        raise BindError(f"unknown type {typename}")
    return _TYPE_MAP[tn]


def _contains_volatile(e) -> bool:
    """Binding these twice would have side effects (sequence advance,
    fresh random seed) — exclude from speculative validation binds."""
    if isinstance(e, A.EFunc) and e.name in ("nextval", "currval",
                                             "random", "uuid", "setseed"):
        return True
    return any(_contains_volatile(c) for c in _ast_children(e))


def _subst_ast(node, mapping):
    """Replace single-part identifiers with argument ASTs — the macro
    expansion primitive (reference: macro_function.cpp binds parameters
    lazily; ours substitutes at the AST level before binding)."""
    import copy
    import dataclasses
    if isinstance(node, A.EIdent) and len(node.parts) == 1 \
            and node.parts[0].lower() in mapping:
        return copy.deepcopy(mapping[node.parts[0].lower()])
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changes = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _subst_val(v, mapping)
            if nv is not v:
                changes[f.name] = nv
        if changes:
            return dataclasses.replace(node, **changes)
    return node


def _subst_val(v, mapping):
    import dataclasses
    if isinstance(v, list):
        out = [_subst_val(x, mapping) for x in v]
        return out if any(a is not b for a, b in zip(out, v)) else v
    if isinstance(v, tuple):
        out = tuple(_subst_val(x, mapping) for x in v)
        return out if any(a is not b for a, b in zip(out, v)) else v
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _subst_ast(v, mapping)
    return v


@dataclass
class ScopeEntry:
    alias: str
    schema: Schema
    start: int
    # column indices hidden from * expansion (right-hand duplicates of
    # USING/NATURAL join columns; reference: using_column_sets in
    # src/planner/binder/tableref/bind_joinref.cpp) — still resolvable
    # by qualified name
    hidden: tuple = ()


@dataclass
class Scope:
    entries: List[ScopeEntry] = dfield(default_factory=list)
    parent: Optional["Scope"] = None
    # unqualified-name overrides from USING/NATURAL joins whose visible
    # value is NOT the left column: right ColRef for RIGHT joins,
    # COALESCE(l, r) for FULL joins (reference: SetPrimaryBinding in
    # src/planner/binder/tableref/bind_joinref.cpp)
    using_map: dict = dfield(default_factory=dict)

    @property
    def width(self):
        return sum(len(e.schema) for e in self.entries)

    def add(self, alias: str, schema: Schema):
        self.entries.append(ScopeEntry(alias, schema, self.width))

    def resolve(self, parts: List[str]) -> ir.ColRef:
        if len(parts) == 2:
            tbl, col = parts
            for e in self.entries:
                if e.alias == tbl:
                    try:
                        i = e.schema.index_of(col)
                    except KeyError:
                        raise BindError(f"column {col} not in {tbl}")
                    f = e.schema.field(i)
                    return ir.ColRef(e.start + i, f.dtype, col, f.strdict)
            raise BindError(f"unknown table alias {tbl}")
        col = parts[-1].lower()
        if len(parts) == 1 and col in self.using_map:
            return self.using_map[col]
        hits = []
        for e in self.entries:
            for i, f in enumerate(e.schema.fields):
                if f.name.lower() == col:
                    hits.append((ir.ColRef(e.start + i, f.dtype, col,
                                           f.strdict), i in e.hidden))
        if len(hits) > 1:
            # USING/NATURAL-hidden duplicates don't make a name
            # ambiguous (reference: using_column_sets resolution)
            vis = [h for h, hid in hits if not hid]
            if len(vis) == 1:
                return vis[0]
        if len(hits) == 1:
            return hits[0][0]
        if len(hits) > 1:
            raise BindError(f"ambiguous column {col}")
        raise BindError(f"unknown column {col}")


@dataclass
class AggCtx:
    specs: List[L.AggSpec] = dfield(default_factory=list)
    keys: List[str] = dfield(default_factory=list)

    def add(self, spec: L.AggSpec, key: str) -> int:
        if key in self.keys:
            return self.keys.index(key)
        self.keys.append(key)
        self.specs.append(spec)
        return len(self.specs) - 1


@dataclass
class AggRef(ir.Expr):
    """Placeholder for an aggregate result during select binding."""
    index: int
    dtype: DataType
    strdict: object = None


@dataclass
class GroupingRef(ir.Expr):
    """Placeholder for GROUPING(col, ...) — resolved to bit tests over the
    per-set grouping mask column after grouping-set expansion."""
    indices: tuple
    dtype: DataType = T.BIGINT


@dataclass
class WinRef(ir.Expr):
    """Placeholder for a window-function result during select binding."""
    index: int
    dtype: DataType
    strdict: object = None


@dataclass
class WinCtx:
    fns: List = dfield(default_factory=list)
    keys: List[str] = dfield(default_factory=list)

    def add(self, fn, key: str) -> int:
        if key in self.keys:
            return self.keys.index(key)
        self.keys.append(key)
        self.fns.append(fn)
        return len(self.fns) - 1


def _ekey(e) -> str:
    """Structural key for matching expressions (group exprs, dedup)."""
    return repr(e)


def _references_cte(stmt: "A.SelectStmt", name: str) -> bool:
    """Does any FROM reference in the (sub)query tree name this CTE?"""
    def walk_ref(r) -> bool:
        if isinstance(r, A.RBase):
            return r.name.lower() == name
        if isinstance(r, A.RSubquery):
            return walk_stmt(r.select)
        if isinstance(r, A.RJoin):
            return walk_ref(r.left) or walk_ref(r.right)
        return False

    def walk_stmt(s) -> bool:
        if s is None:
            return False
        if s.set_op is not None:
            return walk_stmt(s.set_left) or walk_stmt(s.set_op[1])
        if any(walk_ref(r) for r in s.from_refs):
            return True
        # subqueries in expressions (WHERE EXISTS (... FROM cte))
        exprs = [e for e, _ in s.items] + [s.where, s.having]
        stack = [e for e in exprs if e is not None]
        while stack:
            e = stack.pop()
            sub = getattr(e, "subquery", None)
            if sub is not None and walk_stmt(sub):
                return True
            for attr in ("child", "left", "right", "lo", "hi", "else_",
                         "operand"):
                v = getattr(e, attr, None)
                if isinstance(v, A.EExpr):
                    stack.append(v)
            for attr in ("args", "items"):
                v = getattr(e, attr, None)
                if isinstance(v, (list, tuple)):
                    stack.extend(x for x in v if isinstance(x, A.EExpr))
            if isinstance(e, A.ECase):
                for w, t in e.whens:
                    stack.extend([w, t])
        return False

    return walk_stmt(stmt)


class Binder:
    def __init__(self, catalog: Catalog,
                 cte_frames: Optional[Dict[str, A.SelectStmt]] = None,
                 context=None):
        self.catalog = catalog
        self.ctes: Dict[str, A.SelectStmt] = dict(cte_frames or {})
        self.context = context   # owning Connection (table fns, config)
        self.params: Optional[list] = None   # prepared-statement values
        self._next_param = 0
        self._plan_for_bounds = None   # plan whose zone maps bound casts

    # ------------------------------------------------------------------
    # statements
    # ------------------------------------------------------------------
    def bind_select(self, stmt: A.SelectStmt,
                    outer_scope: Optional[Scope] = None) -> L.LogicalNode:
        if getattr(stmt, "distinct_on", None):
            # DISTINCT ON (keys): first row per key in ORDER BY order —
            # lowered to row_number() OVER (PARTITION BY keys
            # ORDER BY ...) = 1 via QUALIFY (reference lowers to a
            # first() aggregate; the rank filter is equivalent)
            import dataclasses as _dc
            win = A.EWindow(A.EFunc("row_number", []),
                            partition=list(stmt.distinct_on),
                            order=list(stmt.order_by or ()))
            cond = A.EBinary("==", win, A.ELit(1))
            q = cond if stmt.qualify is None \
                else A.EBinary("and", stmt.qualify, cond)
            stmt = _dc.replace(stmt, qualify=q, distinct_on=None)
        for cdef in stmt.ctes:
            self.ctes[cdef.name.lower()] = cdef
            if not hasattr(cdef, "_nrefs"):
                # static reference count over the registering statement:
                # CTEs used more than once bind+execute once behind a
                # Materialize barrier (reference: materialized-CTE
                # decision in binder/query_node/bind_cte_node.cpp)
                cdef._nrefs = _count_cte_refs(stmt, cdef)

        if stmt.set_op is not None:
            return self._bind_setop(stmt)

        plan, scope = self.bind_from(stmt.from_refs)

        # WHERE (with subquery flattening)
        if stmt.where is not None:
            try:
                plan, pred = self._bind_where(stmt.where, plan, scope,
                                              outer_scope)
            except BindError:
                # select-item aliases are legal in WHERE (reference:
                # bind_select_node.cpp alias binding; columns win)
                sub = self._lateral_alias_subst(
                    stmt.where, [it for it in stmt.items if it[1]])
                if sub is None:
                    raise
                plan, pred = self._bind_where(sub, plan, scope,
                                              outer_scope)
            if pred is not None:
                plan = L.Filter(plan, pred)

        if stmt.sample is not None:
            plan = L.Sample(plan, stmt.sample.method, stmt.sample.amount,
                            stmt.sample.seed)

        # expand stars
        items: List[Tuple[A.EExpr, Optional[str]]] = []
        for e, alias in stmt.items:
            if isinstance(e, A.EStar):
                for se in scope.entries:
                    if e.prefix is not None and se.alias != e.prefix:
                        continue
                    for fi, f in enumerate(se.schema.fields):
                        if fi in se.hidden:
                            continue
                        if e.prefix is None \
                                and f.name.lower() in scope.using_map:
                            # USING column: unqualified resolution picks
                            # the per-join-type visible value
                            items.append((A.EIdent([f.name]), f.name))
                        else:
                            items.append((A.EIdent([se.alias, f.name]),
                                          f.name))
            else:
                items.append((e, alias))

        # UNNEST as a top-level select item: bind the list argument as a
        # column, then wrap the projection in an Unnest node (reference:
        # unnest rewriter, src/optimizer/unnest_rewriter.cpp)
        unnest_idx = None
        for i, (e, alias) in enumerate(items):
            if isinstance(e, A.EFunc) and e.name == "unnest":
                if unnest_idx is not None:
                    raise BindError("only one UNNEST per SELECT supported")
                unnest_idx = i
                items[i] = (e.args[0], alias or "unnest")

        if getattr(stmt, "group_by_all", False) and not stmt.group_by:
            # GROUP BY ALL: every select item without an aggregate
            # (reference: group-by-all expansion, bind_group_by_node)
            stmt.group_by = [e for (e, _a) in items
                             if not self._contains_agg(e)]
        has_aggs = any(self._contains_agg(e) for e, _ in items) \
            or (stmt.having is not None
                and self._contains_agg(stmt.having)) \
            or bool(stmt.group_by) \
            or getattr(stmt, "group_by_all", False)
        has_windows = any(_contains_window(e) for e, _ in items) \
            or (stmt.qualify is not None
                and _contains_window(stmt.qualify))
        if stmt.qualify is not None and not has_windows:
            # reference: QUALIFY without a window function is a binder
            # error (src/planner/binder/query_node/bind_select_node.cpp)
            raise BindError(
                "QUALIFY clause requires at least one window function")

        having_bound = None
        qualify_bound = None
        order_prebound = {}
        if has_aggs:
            # windows over aggregates evaluate AFTER grouping: their
            # arguments/partition/order bind with the aggregate context and
            # the Window node sits above the Aggregate (reference:
            # window expressions bound post-aggregate in select binding)
            win_ctx = WinCtx() if has_windows else None
            agg_items = list(items)
            if stmt.qualify is not None and win_ctx is not None:
                # bind QUALIFY as a hidden trailing item so it shares the
                # aggregate + window binding context
                agg_items.append((_subst_item_aliases(stmt.qualify,
                                                      items),
                                  "__qualify"))
            plan, bound_items, having_bound, order_prebound = \
                self._bind_aggregate(stmt, agg_items, plan, scope, win_ctx)
            qexpr_hidden = None
            if stmt.qualify is not None and win_ctx is not None:
                qexpr_hidden = bound_items.pop()
            if win_ctx is not None and win_ctx.fns:
                if having_bound is not None:
                    # HAVING filters groups BEFORE window evaluation
                    plan = L.Filter(plan, having_bound)
                    having_bound = None
                qexpr = qexpr_hidden
                base = len(plan.schema)
                plan = L.Window(plan, win_ctx.fns)
                bound_items = [_resolve_winrefs(b, base)
                               for b in bound_items]
                order_prebound = {k: _resolve_winrefs(v, base)
                                  for k, v in order_prebound.items()}
                if qexpr is not None:
                    # QUALIFY filters AFTER window evaluation (reference:
                    # bind_select_node.cpp qualify binding)
                    plan = L.Filter(plan, _resolve_winrefs(qexpr, base))
        elif has_windows:
            win_ctx = WinCtx()
            bound_items = []
            for i2, (e, _) in enumerate(items):
                try:
                    bound_items.append(
                        self.bind_expr(e, scope, win_ctx=win_ctx))
                except BindError:
                    # lateral alias reference: SELECT 1 AS a, a+1
                    # (reference: bind_select_node.cpp alias binding —
                    # real columns take precedence, tried first above)
                    sub = self._lateral_alias_subst(e, items[:i2])
                    if sub is None:
                        raise
                    bound_items.append(
                        self.bind_expr(sub, scope, win_ctx=win_ctx))
            qexpr = None
            if stmt.qualify is not None:
                qexpr = self.bind_expr(
                    _subst_item_aliases(stmt.qualify, items), scope,
                    win_ctx=win_ctx)
            base = len(plan.schema)
            plan = L.Window(plan, win_ctx.fns)
            bound_items = [_resolve_winrefs(b, base) for b in bound_items]
            if qexpr is not None:
                plan = L.Filter(plan, _resolve_winrefs(qexpr, base))
        else:
            self._plan_for_bounds = plan
            try:
                bound_items = []
                for i2, (e, _) in enumerate(items):
                    if _contains_mark_sub(e):
                        # EXISTS/IN-subquery inside a select item: MARK
                        # join columns feed the projection
                        be, plan = self._flatten_marks(e, plan, scope)
                    elif _contains_scalar_sub(e):
                        # uncorrelated scalar subs evaluate eagerly in
                        # bind_expr; correlated ones decorrelate into
                        # joined columns like WHERE conjuncts do
                        try:
                            be = self.bind_expr(e, scope)
                        except BindError:
                            be, plan = self._flatten_scalar_subs(
                                e, plan, scope)
                    else:
                        try:
                            be = self.bind_expr(e, scope)
                        except BindError:
                            # lateral alias reference: SELECT 1 AS a,
                            # a+1 (reference: bind_select_node.cpp —
                            # real columns win, so tried first above)
                            sub = self._lateral_alias_subst(
                                e, items[:i2])
                            if sub is None:
                                raise
                            be = self.bind_expr(sub, scope)
                    bound_items.append(be)
            finally:
                self._plan_for_bounds = None

        names = []
        for i, (e, alias) in enumerate(items):
            if alias:
                names.append(alias)
            elif isinstance(e, A.EIdent):
                names.append(e.parts[-1])
            elif isinstance(e, A.EFunc):
                names.append(e.name)
            else:
                names.append(f"col{i}")

        if having_bound is not None:
            plan = L.Filter(plan, having_bound)

        proj_child = plan
        plan = L.Project(proj_child, bound_items, names)

        if unnest_idx is not None:
            if plan.schema.fields[unnest_idx].dtype.id != TypeId.LIST:
                raise BindError("UNNEST requires a LIST argument")
            plan = L.Unnest(plan, unnest_idx)

        if stmt.distinct:
            plan = L.Distinct(plan)

        if stmt.order_by:
            # hidden sort keys (ORDER BY g when g not selected) are legal
            # when there's no DISTINCT/aggregate re-shaping in the way
            hidden_scope = None
            if not stmt.distinct and not has_aggs \
                    and unnest_idx is None:
                hidden_scope = scope
            keys, hidden = self._bind_order_keys(stmt, items, names,
                                                 plan.schema, hidden_scope,
                                                 order_prebound)
            if hidden:
                ext_items = bound_items + [h for h, _ in hidden]
                ext_names = names + [n for _, n in hidden]
                plan = L.Project(proj_child, ext_items, ext_names)
                plan = L.Order(plan, keys)
                vis = [ir.ColRef(i, f.dtype, f.name, f.strdict)
                       for i, f in enumerate(plan.schema.fields[
                           :len(names)])]
                plan = L.Project(plan, vis, names)
            else:
                plan = L.Order(plan, keys)

        plan = self._apply_limit(plan, stmt)
        return plan

    def _apply_limit(self, plan, stmt):
        """Lower LIMIT/OFFSET incl. constant-foldable expressions,
        parameters, scalar subqueries, and n% (reference:
        bound_limit_node + physical_limit_percent)."""
        limit, offset = stmt.limit, stmt.offset
        if limit is not None and limit < 0:
            raise BindError("LIMIT cannot be negative")
        if offset and offset < 0:
            raise BindError("OFFSET cannot be negative")
        pct = None
        if getattr(stmt, "limit_expr", None) is not None:
            v = self._const_limit(stmt.limit_expr, "LIMIT")
            limit = None if v is None else int(v)
            if limit is not None and limit < 0:
                raise BindError("LIMIT value out of range")
        if getattr(stmt, "offset_expr", None) is not None:
            v = self._const_limit(stmt.offset_expr, "OFFSET")
            offset = 0 if v is None else int(v)
            if offset < 0:
                raise BindError("OFFSET value out of range")
        if getattr(stmt, "limit_percent", None) is not None:
            v = self._const_limit(stmt.limit_percent, "LIMIT")
            pct = float(v) if v is not None else 100.0
            if pct < 0:
                raise BindError("LIMIT percent value out of range")
        if limit is None and not offset and pct is None:
            return plan
        return L.Limit(plan, limit, int(offset or 0), pct)

    def _const_limit(self, e, clause):
        try:
            bound = self.bind_expr(e, Scope())
        except BindError:
            raise BindError(
                f"Binder Error: Referenced column not found in "
                f"{clause} clause (non-constant {clause})")
        if ir.referenced_columns(bound):
            raise BindError(
                f"Binder Error: Referenced column not found in "
                f"{clause} clause")
        from ..expr.compile import evaluate_const
        d, nmask = evaluate_const(bound)
        if nmask is not None and bool(np.asarray(nmask)[0]):
            return None
        v = np.asarray(d)[0].item()
        from ..types import TypeId as _TID
        if bound.dtype.id == _TID.DECIMAL:
            v = v / (10 ** bound.dtype.scale)
        return v

    def _bind_setop(self, stmt: A.SelectStmt) -> L.LogicalNode:
        op, rhs, all_ = stmt.set_op
        left = self.bind_select(stmt.set_left)
        right = self.bind_select(rhs)
        if len(left.schema) != len(right.schema):
            raise BindError("set operation column count mismatch")
        # unify column types across sides (reference:
        # bind_setop_node.cpp CastLogicalOperatorToTypes): NULL-typed
        # columns adopt the other side's type, numerics promote
        fields = []
        retype = False
        for f, g in zip(left.schema.fields, right.schema.fields):
            if f.dtype == g.dtype:
                fields.append(f)
                continue
            try:
                ct = ir.common_type(f.dtype, g.dtype)
            except TypeError:
                if TypeId.VARCHAR in (f.dtype.id, g.dtype.id):
                    ct = T.VARCHAR
                else:
                    raise BindError(
                        f"set operation type mismatch: {f.dtype!r} "
                        f"vs {g.dtype!r} for column {f.name}")
            sd = f.strdict if f.strdict is not None else g.strdict
            fields.append(Field(f.name, ct, sd))
            retype = True
        if retype:
            target = Schema(tuple(fields))
            left = self._cast_plan_to(left, target, null_to_any=True)
            right = self._cast_plan_to(right, target, null_to_any=True)
        left, right = self._align_setop_strings(left, right)
        if op == "union":
            plan = L.Union(left, right)
            if not all_:
                plan = L.Distinct(plan)
        elif op in ("except", "intersect"):
            jt = "anti" if op == "except" else "semi"
            conds = []
            for i, (f, g) in enumerate(zip(left.schema.fields,
                                           right.schema.fields)):
                le = ir.ColRef(i, f.dtype, f.name, f.strdict)
                re_ = ir.ColRef(i, g.dtype, g.name, g.strdict)
                le, re_ = self._align_join_keys(le, re_)
                conds.append(L.JoinCond(le, re_))
            plan = L.Join(left, right, jt, conds)
            if not all_:
                plan = L.Distinct(plan)
        else:
            raise BindError(f"set op {op}")
        out = plan
        if stmt.order_by:
            # ORDER BY binds over the output schema; aliases from EITHER
            # side of the set operation resolve positionally
            alt_names = [f.name for f in right.schema.fields]
            keys = []
            for it in stmt.order_by:
                keys.append(self._order_key_over_schema(
                    it, out.schema, alt_names))
            if keys:
                out = L.Order(out, keys)
        out = self._apply_limit(out, stmt)
        return out

    def _bind_recursive_cte(self, cdef: A.CTEDef) -> L.LogicalNode:
        """WITH RECURSIVE name AS (base UNION [ALL] recursive)
        (reference: binder bind of RecursiveCTENode,
        src/planner/binder/query_node/bind_recursive_cte_node.cpp)."""
        stmt = cdef.select
        op, rhs, all_ = stmt.set_op
        if op != "union":
            raise BindError("recursive CTE requires UNION or UNION ALL")
        name = cdef.name.lower()
        sub_ctes = {k: v for k, v in self.ctes.items() if k != name}
        base = Binder(self.catalog, sub_ctes,
                      self.context).bind_select(stmt.set_left)
        schema = base.schema.rename(cdef.cols) if cdef.cols \
            else base.schema
        cell = L.CTECell()
        rec_binder = Binder(self.catalog, sub_ctes, self.context)
        rec_binder.ctes[name] = L.CTERef(name, schema, cell)
        try:
            rec = rec_binder.bind_select(rhs)
        except BindError:
            # The probe bind can fail for reasons that resolve once the
            # working table is materialized (e.g. numeric->VARCHAR casts
            # need concrete value bounds, string concats need a live
            # dictionary).  The host fixpoint re-binds the recursive term
            # per iteration against real data, so route there; genuine
            # errors (unknown columns, bad types) re-raise on its first
            # iteration bind.
            return self._bind_recursive_cte_host(
                name, schema, base, rhs, all_, sub_ctes)
        if len(rec.schema) != len(base.schema):
            raise BindError("recursive CTE column count mismatch")
        # The CTE's column types are fixed by the anchor (reference:
        # bind_recursive_cte_node.cpp "result types ... are the types of
        # the LHS"), except that a NULL-typed anchor adopts the recursive
        # term's type; the recursive term is cast to the result types.
        #
        # Dictionary hazard: our VARCHAR columns are int32 codes into
        # bind-time-immutable dictionaries.  A recursive term that
        # produces strings outside the anchor dictionary (concats, scans
        # of other tables, numeric->varchar casts) yields codes in a
        # DIFFERENT dictionary each iteration — raw code concatenation
        # would silently corrupt results.  Those queries run through the
        # bind-time host fixpoint (_bind_recursive_cte_host), which
        # re-binds the recursive term per iteration against the current
        # working dictionary.
        out_fields = []
        host_mode = False
        need_cast = False
        for bf, rf in zip(schema.fields, rec.schema.fields):
            bt, rt = bf.dtype, rf.dtype
            f = bf
            if bt.id == TypeId.NULL and rt.id != TypeId.NULL:
                # the anchor fixes the type to SQLNULL; the reference
                # fails the cast of the recursive term to it at runtime
                # (test/sql/cte/recursive_cte_error.test) — we fail at
                # bind time
                raise BindError(
                    f"Conversion: recursive CTE column '{bf.name}' has "
                    f"anchor type NULL but recursive-term type {rt}; "
                    "cannot cast")
            out_fields.append(f)
            tt = f.dtype
            if tt.id == TypeId.VARCHAR:
                if rt.id == TypeId.VARCHAR:
                    if rf.strdict is not f.strdict:
                        host_mode = True
                elif rt.id != TypeId.NULL:
                    # numeric/temporal -> VARCHAR cast grows the dictionary
                    host_mode = True
            else:
                if rt.id == TypeId.VARCHAR:
                    raise BindError(
                        f"Conversion: recursive CTE column '{bf.name}' "
                        f"has anchor type {bt} but recursive-term type "
                        f"{rt}; cannot cast VARCHAR to {bt}")
                if rt != tt and rt.id != TypeId.NULL:
                    need_cast = True
        out_schema = Schema(tuple(out_fields))
        if host_mode:
            return self._bind_recursive_cte_host(
                name, out_schema, base, rhs, all_, sub_ctes)
        if need_cast:
            base = self._cast_plan_to(base, out_schema)
            rec = self._cast_plan_to(rec, out_schema)
        return L.RecursiveCTE(base, rec, all_, cell, out_schema)

    def _cast_plan_to(self, plan: L.LogicalNode, target: Schema,
                      null_to_any: bool = False) -> L.LogicalNode:
        """Project `plan` so each column is cast to the target schema's
        type (reference: CastLogicalOperatorToTypes in
        src/planner/binder/query_node/bind_setop_node.cpp).
        null_to_any retypes all-NULL columns to any target (set-op
        unification) and stringifies bounded columns for VARCHAR
        targets."""
        exprs, names = [], []
        changed = False
        for i, (f, tf) in enumerate(zip(plan.schema.fields,
                                        target.fields)):
            e = ir.ColRef(i, f.dtype, f.name, f.strdict)
            tt = tf.dtype
            if f.dtype != tt and tt.id == TypeId.VARCHAR \
                    and null_to_any:
                if f.dtype.id == TypeId.NULL:
                    e = ir.Cast(e, T.VARCHAR)
                    e.strdict = tf.strdict
                else:
                    self._plan_for_bounds = plan
                    try:
                        e = self._cast_to_varchar(e)
                    finally:
                        self._plan_for_bounds = None
                changed = True
            elif f.dtype != tt and tt.id != TypeId.VARCHAR:
                if tt.id == TypeId.DECIMAL and f.dtype.is_numeric \
                        and not f.dtype.id == TypeId.DOUBLE \
                        and not f.dtype.id == TypeId.FLOAT:
                    e = ir.promote(ir._as_decimal(e), tt)
                else:
                    e = ir.promote(e, tt)
                changed = True
            exprs.append(e)
            names.append(tf.name)
        if not changed:
            return plan
        return L.Project(plan, exprs, names)

    def _bind_recursive_cte_host(self, name: str, schema: Schema,
                                 base: L.LogicalNode, rhs, union_all: bool,
                                 sub_ctes) -> L.LogicalNode:
        """Bind-time host fixpoint for recursive CTEs whose string
        dictionaries grow per iteration.

        The reference executes the recursive half against a materialized
        working table each iteration
        (src/execution/operator/set/physical_recursive_cte.cpp); with
        bind-time-immutable dictionaries the equivalent is to RE-BIND the
        recursive term per iteration against a working TableData holding
        the previous iteration's rows (strings re-encoded into a fresh
        dictionary).  The final result is materialized into a TableData
        whose merged dictionary the outer query binds against.  Plan-cache
        safety: cached plans are keyed on catalog.version, which any
        mutation bumps."""
        from ..plan import physical
        from ..storage.table import TableData, TableColumn

        tfields = list(schema.fields)

        def rows_of(pschema, batch):
            sel = np.asarray(batch.sel)
            cols = []
            for tf, f, c in zip(tfields, pschema.fields, batch.columns):
                d = np.asarray(c.data)[sel]
                nu = (np.asarray(c.nulls)[sel] if c.nulls is not None
                      else None)
                cols.append(_host_coerce(d, nu, f, tf.dtype))
            return list(zip(*cols)) if cols else []

        bschema, bbatch = physical.execute(base)
        rows = rows_of(bschema, bbatch)
        seen = None
        if not union_all:
            seen = set()
            rows = [r for r in rows
                    if not (r in seen or seen.add(r))]
        acc = list(rows)
        working = rows
        it = 0
        while working:
            it += 1
            if it > physical._MAX_RECURSION:
                raise RuntimeError(
                    "recursive CTE exceeded max iteration count "
                    f"({physical._MAX_RECURSION})")
            td = _tabledata_from_rows("__rec_" + name, tfields, working)
            cell = L.CTECell()
            cell.batch = td.device_batch()
            cell.table = td      # lets _bind_ref scan a real Get so
            b = Binder(self.catalog, dict(sub_ctes), self.context)
            b.ctes[name] = L.CTERef(name, td.schema, cell)   # zone maps
            # bound casts (numeric->VARCHAR needs stats)
            rplan = b.bind_select(rhs)
            if len(rplan.schema) != len(tfields):
                raise BindError("recursive CTE column count mismatch")
            rschema, rbatch = physical.execute(rplan)
            new = rows_of(rschema, rbatch)
            if not union_all:
                out = []
                for r in new:
                    if r not in seen:
                        seen.add(r)
                        out.append(r)
                new = out
            if not new:
                break
            acc.extend(new)
            working = new
        td = _tabledata_from_rows(name, tfields, acc)
        return L.Get(td, list(range(len(tfields))))

    # ------------------------------------------------------------------
    # FROM
    # ------------------------------------------------------------------
    def bind_from(self, refs: List[A.TableRef]
                  ) -> Tuple[L.LogicalNode, Scope]:
        if not refs:
            # dummy single-row scan
            from ..storage.table import TableData, TableColumn
            td = TableData("__dummy", [TableColumn(
                "__one", T.INTEGER, np.array([1], dtype=np.int32))])
            plan = L.Get(td, [0])
            sc = Scope()
            sc.add("__dummy", plan.schema)
            return plan, sc
        plan, scope = self._bind_ref(refs[0])
        for r in refs[1:]:
            if isinstance(r, A.RSubquery) and r.lateral:
                plan, scope = self._bind_lateral(plan, scope, r, "inner")
                continue
            rplan, rscope = self._bind_ref(r)
            plan = L.CrossProduct(plan, rplan)
            for e in rscope.entries:
                scope.add(e.alias, e.schema)
        return plan, scope

    def _bind_ref(self, ref: A.TableRef) -> Tuple[L.LogicalNode, Scope]:
        if isinstance(ref, A.RSampleRef):
            plan, sc = self._bind_ref(ref.ref)
            return L.Sample(plan, ref.spec.method, ref.spec.amount,
                            ref.spec.seed), sc
        if isinstance(ref, A.RBase):
            name = ref.name.lower()
            alias = (ref.alias or ref.name.split(".")[-1]).lower()
            if name in self.ctes:
                cdef = self.ctes[name]
                if isinstance(cdef, L.CTERef):
                    # self-reference inside the recursive half: scan the
                    # working table (reference: LOGICAL_CTE_REF)
                    td = getattr(cdef.cell, "table", None) \
                        if cdef.cell is not None else None
                    if td is not None:
                        # host-fixpoint iteration: the working table is
                        # materialized, so scan it as a real Get (stats
                        # feed zone-map-bounded casts)
                        plan = L.Get(td, list(range(len(td.schema))))
                        sc = Scope()
                        sc.add(alias, plan.schema)
                        return plan, sc
                    sc = Scope()
                    sc.add(alias, cdef.schema)
                    return cdef, sc
                cols = cdef.cols if isinstance(cdef, A.CTEDef) else None
                sub = cdef.select if isinstance(cdef, A.CTEDef) else cdef
                if isinstance(cdef, A.CTEDef) and cdef.recursive \
                        and sub.set_op is not None \
                        and _references_cte(sub.set_op[1], name):
                    plan = self._bind_recursive_cte(cdef)
                elif getattr(cdef, "_bound_plan", None) is not None \
                        and cdef._bound_plan[0] == self.catalog.version:
                    plan = cdef._bound_plan[1]
                else:
                    sub_binder = Binder(self.catalog,
                                        {k: v for k, v in self.ctes.items()
                                         if k != name}, self.context)
                    plan = sub_binder.bind_select(sub)
                    if getattr(cdef, "_nrefs", 1) > 1:
                        # multiply-referenced CTE: share ONE materialized
                        # plan across all reference sites (re-bound if the
                        # catalog changed under a reused AST)
                        plan = L.Materialize(plan, name)
                        try:
                            cdef._bound_plan = (self.catalog.version,
                                                plan)
                        except Exception:
                            pass
                sc = Scope()
                schema = plan.schema.rename(cols) if cols else plan.schema
                sc.add(alias, schema)
                return plan, sc
            view = self.catalog.get_view(name)
            if view is not None:
                view_sql, vcols = view
                from . import parser as sqlparser
                sub = sqlparser.parse(view_sql)[0]
                plan = Binder(self.catalog, self.ctes, self.context).bind_select(sub)
                sc = Scope()
                schema = plan.schema
                if vcols:
                    schema = schema.rename(vcols)
                sc.add(alias, schema)
                return plan, sc
            td = self.catalog.get_table(name)
            plan = L.Get(td, list(range(len(td.schema))))
            sc = Scope()
            sc.add(alias, plan.schema)
            return plan, sc
        if isinstance(ref, A.RValues):
            # inline VALUES table: fold literal rows into a TableData
            from ..storage.table import TableData, TableColumn
            sc0 = Scope()
            bound_rows = [[self.bind_expr(e, sc0) for e in row]
                          for row in ref.rows]
            ncols = len(bound_rows[0])
            names = ref.column_aliases or \
                [f"col{j}" for j in range(ncols)]
            cols = []
            for j in range(ncols):
                vals = []
                for row in bound_rows:
                    c = row[j]
                    if not isinstance(c, ir.Const):
                        raise BindError("VALUES rows must be constant")
                    if c.value is None:
                        vals.append(None)
                    elif getattr(c, "strdict", None) is not None:
                        vals.append(c.strdict.decode_one(c.value))
                    else:
                        vals.append(T.decode_value(c.value, c.dtype))
                from ..storage.table import _column_from_values
                cols.append(_column_from_values(names[j], vals))
            td = TableData(ref.alias or "values", cols)
            plan = L.Get(td, list(range(ncols)))
            sc = Scope()
            sc.add((ref.alias or "values").lower(), plan.schema)
            return plan, sc
        if isinstance(ref, A.RFunction):
            mac = getattr(self.catalog, "macros", {}).get(
                ref.name.lower())
            if mac is not None and mac.get("is_table"):
                from . import parser as sqlparser
                sel = sqlparser.parse(mac["body"])[0]
                params = mac["params"]
                args = list(ref.args or ())
                mapping = {}
                for p, a in zip(params, args):
                    mapping[p] = a if isinstance(a, A.EExpr) \
                        else A.ELit(a)
                for p in params[len(args):]:
                    if p in mac["defaults"]:
                        mapping[p] = sqlparser.parse_expression(
                            mac["defaults"][p])
                    else:
                        raise BindError(f"macro {ref.name} requires "
                                        f"parameter {p}")
                sel = _subst_ast(sel, mapping)
                sub = A.RSubquery(sel, ref.alias or ref.name,
                                  getattr(ref, "column_aliases", None))
                return self._bind_ref(sub)
            # user-registered table functions (reference:
            # duckdb_create_table_function; Connection
            # .create_table_function) take priority over built-ins
            ureg = getattr(self.context, "_table_fns", None) \
                if self.context is not None else None
            ufn = (ureg or {}).get(ref.name.lower())
            if ufn is not None:
                producer, cols = ufn
                args = []
                for a in (ref.args or ()):
                    if isinstance(a, A.EExpr):
                        from ..api import _const_python_value
                        args.append(_const_python_value(
                            self.bind_expr(a, Scope())))
                    else:
                        args.append(a)
                rows = list(producer(*args))
                td = _rows_to_table(ref.name, rows, cols)
                plan = L.Get(td, list(range(len(td.schema))))
                sc = Scope()
                schema = plan.schema
                if getattr(ref, "column_aliases", None):
                    schema = schema.rename(ref.column_aliases)
                sc.add((ref.alias or ref.name).lower(), schema)
                self.uncacheable = True
                return plan, sc
            from ..table_functions import TABLE_FUNCTIONS
            fn = TABLE_FUNCTIONS.get(ref.name.lower())
            if fn is None:
                raise BindError(f"unknown table function {ref.name}")
            if self.context is None:
                raise BindError(
                    f"table function {ref.name} needs a connection")
            if any(isinstance(a, A.EExpr) for a in ref.args) or any(
                    isinstance(v, A.EExpr)
                    for v in (getattr(ref, "kwargs", None) or {}
                              ).values()):
                # non-literal argument expressions evaluate at bind time
                # (reference: table-in-out function bind casts constant
                # expressions)
                from ..api import _const_python_value

                def rv(a):
                    if isinstance(a, A.EExpr):
                        return _const_python_value(
                            self.bind_expr(a, Scope()))
                    return a
                import dataclasses as _dc
                ref = _dc.replace(
                    ref, args=[rv(a) for a in ref.args],
                    kwargs={k: rv(v) for k, v in
                            (getattr(ref, "kwargs", None) or {}).items()})
            import inspect
            if any(isinstance(a, str) and "://" in a
                   for a in (ref.args or ())):
                # remote paths revalidate through the caching
                # filesystem on every execution — never plan-cache
                self.uncacheable = True
            if len(inspect.signature(fn).parameters) >= 3:
                td = fn(self.context, ref.args,
                        getattr(ref, "kwargs", None) or {})
            else:
                td = fn(self.context, ref.args)
            plan = L.Get(td, list(range(len(td.schema))))
            sc = Scope()
            schema = plan.schema
            if getattr(ref, "column_aliases", None):
                schema = schema.rename(ref.column_aliases)
            sc.add((ref.alias or ref.name).lower(), schema)
            return plan, sc
        if isinstance(ref, A.RSubquery):
            plan = Binder(self.catalog, self.ctes, self.context).bind_select(ref.select)
            sc = Scope()
            schema = plan.schema
            if ref.column_aliases:
                schema = schema.rename(ref.column_aliases)
            sc.add(ref.alias.lower(), schema)
            return plan, sc
        if isinstance(ref, A.RJoin):
            return self._bind_join(ref)
        raise BindError(f"unsupported table ref {ref}")

    def _bind_join(self, ref: A.RJoin) -> Tuple[L.LogicalNode, Scope]:
        lplan, lscope = self._bind_ref(ref.left)
        if isinstance(ref.right, A.RSubquery) and ref.right.lateral:
            jt = "inner" if ref.join_type == "cross" else ref.join_type
            if jt not in ("inner", "left"):
                raise BindError("LATERAL supports INNER/CROSS/LEFT joins")
            return self._bind_lateral(lplan, lscope, ref.right, jt,
                                      on_ast=ref.on)
        rplan, rscope = self._bind_ref(ref.right)
        lwidth = lscope.width
        combined = Scope()
        for e in lscope.entries:
            combined.add(e.alias, e.schema)
            combined.entries[-1].hidden = e.hidden
        combined.using_map.update(lscope.using_map)
        for e in rscope.entries:
            combined.add(e.alias, e.schema)
            combined.entries[-1].hidden = e.hidden
        for nm, ex in rscope.using_map.items():
            shift = {i: i + lwidth for i in ir.referenced_columns(ex)}
            combined.using_map[nm] = ir.remap_columns(ex, shift)
        if ref.join_type == "positional":
            # row-i-pairs-with-row-i join, shorter side NULL-padded
            # (reference: physical_positional_join.cpp)
            return L.Positional(lplan, rplan), combined
        if ref.join_type == "cross" or (ref.on is None and not ref.using
                                        and not getattr(ref, "natural",
                                                        False)):
            return L.CrossProduct(lplan, rplan), combined

        if ref.asof:
            return self._bind_asof_join(ref, lplan, rplan, lscope, rscope,
                                        combined)

        conds: List[L.JoinCond] = []
        extras: List[ir.Expr] = []
        using = ref.using
        if getattr(ref, "natural", False) and not using:
            # NATURAL JOIN: USING over the common column names
            # (reference: bind_joinref.cpp natural-join expansion)
            lnames = [f.name.lower() for e2 in lscope.entries
                      for f in e2.schema.fields]
            rnames = {f.name.lower() for e2 in rscope.entries
                      for f in e2.schema.fields}
            using = [n for n in lnames if n in rnames]
            if not using:
                return L.CrossProduct(lplan, rplan), combined
        if using:
            for col in using:
                le = lscope.resolve([col])
                re_ = rscope.resolve([col])
                le2, re2 = self._align_join_keys(le, re_)
                conds.append(L.JoinCond(le2, re2))
                # unqualified visible value per join type (reference:
                # SetPrimaryBinding, bind_joinref.cpp): RIGHT joins show
                # the right column, FULL joins COALESCE both sides
                if ref.join_type in ("right", "full"):
                    shift = {i: i + lwidth
                             for i in ir.referenced_columns(re2)}
                    rc = ir.remap_columns(re2, shift)
                    if ref.join_type == "right":
                        combined.using_map[col.lower()] = rc
                    else:
                        combined.using_map[col.lower()] = ir.Func(
                            "coalesce", [le2, rc], le2.dtype)
            # the right-hand duplicates disappear from * expansion
            # (reference: USING column coalescing, bind_joinref.cpp)
            for col in using:
                for e2 in rscope.entries:
                    try:
                        i2 = e2.schema.index_of(col)
                    except KeyError:
                        continue
                    for ce in combined.entries:
                        if ce.alias == e2.alias \
                                and ce.schema is e2.schema:
                            ce.hidden = tuple(set(ce.hidden) | {i2})
                    break
        else:
            for c in ir_conjuncts_ast(ref.on):
                jc = self._try_equi_cond(c, lscope, rscope, combined,
                                         lwidth)
                if jc is not None:
                    conds.append(jc)
                else:
                    extras.append(self.bind_expr(c, combined))
        range_cond = None
        if not conds:
            # no equi conditions: pick an inequality to drive a sort-based
            # range join (reference: physical_piecewise_merge_join.cpp);
            # the remaining conditions stay as residual pair filters
            picked = None
            for i, c in enumerate(ir_conjuncts_ast(ref.on)):
                rc = self._try_range_cond(c, lscope, rscope)
                if rc is not None:
                    picked = i
                    range_cond = rc
                    break
            if range_cond is not None:
                extras = []
                for i, c in enumerate(ir_conjuncts_ast(ref.on)):
                    if i != picked:
                        extras.append(self.bind_expr(c, combined))
                extra = ir.make_and(extras) if extras else None
                plan = L.Join(lplan, rplan, ref.join_type, [], extra=extra,
                              range_cond=range_cond)
                return plan, combined
            if ref.join_type in ("left", "right", "full"):
                # nested-loop outer join over an arbitrary predicate
                # (reference: physical_nested_loop_join.cpp)
                plan = L.Join(lplan, rplan, ref.join_type, [],
                              extra=ir.make_and(extras)
                              if extras else ir.Const(True, T.BOOLEAN))
                return plan, combined
            if ref.join_type != "inner":
                raise BindError("non-equi outer joins not supported yet")
            plan = L.CrossProduct(lplan, rplan)
            for x in extras:
                plan = L.Filter(plan, x)
            return plan, combined
        # ON-clause extras on the NON-preserved side of an outer join are
        # equivalent to pre-filtering that input (q13's o_comment NOT LIKE)
        if extras and ref.join_type in ("left", "right"):
            keep = []
            for x in extras:
                cols = ir.referenced_columns(x)
                if ref.join_type == "left" and cols \
                        and all(c >= lwidth for c in cols):
                    rplan = L.Filter(rplan, ir.remap_columns(
                        x, {c: c - lwidth for c in cols}))
                elif ref.join_type == "right" and cols \
                        and all(c < lwidth for c in cols):
                    lplan = L.Filter(lplan, x)
                else:
                    keep.append(x)
            extras = keep
        extra = ir.make_and(extras) if extras else None
        jt = ref.join_type
        if jt in ("right_semi", "right_anti"):
            # emit matched/unmatched BUILD rows: swap sides so the
            # preserved side is the probe (reference: JoinType::RIGHT_SEMI
            # executed inside the hash join; ours mirrors to left semi)
            rwidth = rscope.width
            conds = [L.JoinCond(c.right, c.left) for c in conds]
            if extra is not None:
                cols = ir.referenced_columns(extra)
                extra = ir.remap_columns(
                    extra, {c: c + rwidth if c < lwidth else c - lwidth
                            for c in cols})
            plan = L.Join(rplan, lplan, jt[len("right_"):], conds,
                          extra=extra)
            return plan, rscope
        plan = L.Join(lplan, rplan, jt, conds, extra=extra)
        if jt in ("semi", "anti"):
            # only the preserved (left) side's columns are visible
            return plan, lscope
        return plan, combined

    def _bind_asof_join(self, ref: A.RJoin, lplan, rplan, lscope, rscope,
                        combined):
        """ASOF JOIN: equality keys + exactly one inequality picking the
        nearest build row (reference: physical_asof_join.cpp)."""
        if ref.join_type not in ("inner", "left"):
            raise BindError("ASOF JOIN supports INNER and LEFT")
        if ref.on is None:
            raise BindError("ASOF JOIN requires an ON clause")
        conds: List[L.JoinCond] = []
        range_cond = None
        for c in ir_conjuncts_ast(ref.on):
            jc = self._try_equi_cond(c, lscope, rscope, combined, None)
            if jc is not None:
                conds.append(jc)
                continue
            rc = self._try_range_cond(c, lscope, rscope)
            if rc is not None and range_cond is None:
                range_cond = rc
                continue
            raise BindError("ASOF JOIN conditions must be equality keys "
                            "plus exactly one inequality")
        if range_cond is None:
            raise BindError("ASOF JOIN requires an inequality condition")
        plan = L.Join(lplan, rplan, ref.join_type, conds,
                      range_cond=range_cond, asof=True)
        return plan, combined

    def _bind_lateral(self, lplan, lscope: Scope, ref: A.RSubquery,
                      join_type: str, on_ast: Optional[A.EExpr] = None
                      ) -> Tuple[L.LogicalNode, Scope]:
        """LATERAL (subquery): the subquery references columns of the FROM
        items to its left (reference: dependent-join planning + flattening,
        src/planner/binder/tableref/bind_joinref.cpp and
        src/planner/subquery/flatten_dependent_join.cpp).

        TPU-native decorrelation (no per-outer-row re-execution): correlated
        equality/inequality conjuncts become hash/range join conditions;
        ungrouped correlated aggregates become a group-by over the inner
        side joined back on the correlation keys."""
        sub = ref.select
        if sub.set_op is not None:
            raise BindError("LATERAL set-operation subquery not supported")
        if sub.limit is not None:
            raise BindError("LATERAL subquery with LIMIT not supported")
        sb, iplan, iscope, corr, corr_extra = \
            self._bind_subquery_corr(sub, lscope)

        # expand * over the inner scope
        items: List[Tuple[A.EExpr, Optional[str]]] = []
        for e, alias in sub.items:
            if isinstance(e, A.EStar):
                for se in iscope.entries:
                    if e.prefix is not None and se.alias != e.prefix:
                        continue
                    for fi, f in enumerate(se.schema.fields):
                        if fi in se.hidden:
                            continue
                        if e.prefix is None \
                                and f.name.lower() in iscope.using_map:
                            items.append((A.EIdent([f.name]), f.name))
                        else:
                            items.append((A.EIdent([se.alias, f.name]),
                                          f.name))
            else:
                items.append((e, alias))
        names = []
        for i, (e, alias) in enumerate(items):
            if alias:
                names.append(alias)
            elif isinstance(e, A.EIdent):
                names.append(e.parts[-1])
            elif isinstance(e, A.EFunc):
                names.append(e.name)
            else:
                names.append(f"col{i}")
        if ref.column_aliases:
            names[:len(ref.column_aliases)] = ref.column_aliases

        has_agg = any(self._contains_agg(e) for e, _ in items)
        lw = len(lplan.schema)
        lrefs = [ir.ColRef(i, f.dtype, f.name, f.strdict)
                 for i, f in enumerate(lplan.schema.fields)]

        if has_agg:
            # ungrouped correlated aggregate: GROUP BY the correlation keys
            # and LEFT-join back (an ungrouped aggregate yields exactly one
            # row per outer row, so the join is left-preserving; COUNT on
            # unmatched outer rows coalesces to 0)
            if sub.group_by:
                raise BindError(
                    "LATERAL aggregate subquery with GROUP BY unsupported")
            if corr_extra:
                raise BindError(
                    "LATERAL aggregate with non-equality correlation")
            agg_ctx = AggCtx()
            bound_items = [sb.bind_expr(e, iscope, agg_ctx=agg_ctx)
                           for e, _ in items]
            groups = [ie for (_, ie) in corr]
            agg = L.Aggregate(iplan, groups, agg_ctx.specs,
                              [f"__g{i}" for i in range(len(groups))])
            resolved = []
            count_like = set()
            for k, (b, (e, _)) in enumerate(zip(bound_items, items)):
                r = _resolve_aggrefs(b, len(groups))
                if isinstance(b, AggRef) \
                        and agg_ctx.specs[b.index].kind in ("count",
                                                            "count_star"):
                    # unmatched outer rows read NULL from the left join;
                    # COUNT over zero rows is 0, not NULL — coalesce the
                    # POST-join column (reference: ungrouped count
                    # semantics, flatten_dependent_join.cpp)
                    count_like.add(k)
                resolved.append(r)
            aproj = L.Project(
                agg,
                [ir.ColRef(i, g.dtype, f"__g{i}",
                           getattr(g, "strdict", None))
                 for i, g in enumerate(groups)] + resolved,
                [f"__g{i}" for i in range(len(groups))] + names)
            conds = [L.JoinCond(
                oe, ir.ColRef(i, ie.dtype, f"__g{i}",
                              getattr(ie, "strdict", None)))
                for i, (oe, ie) in enumerate(corr)]
            if not conds:
                one = ir.Const(1, T.INTEGER)
                lplan = L.Project(lplan, lrefs + [one],
                                  list(lplan.schema.names) + ["__k"])
                aproj = L.Project(
                    aproj, [ir.ColRef(i, f.dtype, f.name, f.strdict)
                            for i, f in enumerate(aproj.schema.fields)]
                    + [one], list(aproj.schema.names) + ["__k"])
                conds = [L.JoinCond(
                    ir.ColRef(lw, T.INTEGER, "__k"),
                    ir.ColRef(len(aproj.schema) - 1, T.INTEGER, "__k"))]
            plan = L.Join(lplan, aproj, "left", conds)
            # joined row: left cols [+__k] then aproj cols; values follow
            # the group columns (corr) or start right after left+__k
            voff = lw + (len(groups) if corr else 1)
            out_exprs = list(lrefs)
            for k, r in enumerate(resolved):
                c = ir.ColRef(voff + k, r.dtype, names[k],
                              getattr(r, "strdict", None))
                if k in count_like:
                    c = ir.Func("coalesce", [c, ir.Const(0, c.dtype)],
                                c.dtype)
                out_exprs.append(c)
            out = L.Project(plan, out_exprs,
                            list(lplan.schema.names)[:lw] + names)
            out_scope = Scope()
            for e_ in lscope.entries:
                out_scope.add(e_.alias, e_.schema)
            out_scope.add(ref.alias.lower(),
                          Schema(tuple(out.schema.fields[lw:])))
            return out, out_scope

        # plain (non-aggregate) subquery: join left with the inner plan;
        # correlated conjuncts drive the join, select items bind over the
        # combined row so they may reference outer columns too
        iw = len(iplan.schema)
        irefs = [ir.ColRef(i, f.dtype, f.name, f.strdict)
                 for i, f in enumerate(iplan.schema.fields)]
        keys = [ie for (_, ie) in corr]
        iproj = L.Project(iplan, irefs + keys,
                          list(iplan.schema.names)
                          + [f"__ck{i}" for i in range(len(keys))]) \
            if keys else iplan
        conds = [L.JoinCond(oe, ir.ColRef(iw + i, ie.dtype, f"__ck{i}",
                                          getattr(ie, "strdict", None)))
                 for i, (oe, ie) in enumerate(corr)]
        extra_parts = []
        for j, (op, oe, ie) in enumerate(corr_extra):
            # corr_extra inner side must be re-bound over the joined row:
            # shift inner column refs by lw
            cols = ir.referenced_columns(ie)
            ie2 = ir.remap_columns(ie, {c: c + lw for c in cols})
            extra_parts.append(ir.Cmp(op, oe, ie2))
        if conds:
            plan = L.Join(lplan, iproj, join_type, conds,
                          extra=ir.make_and(extra_parts)
                          if extra_parts else None)
        elif join_type == "left":
            one = ir.Const(1, T.INTEGER)
            lp = L.Project(lplan, lrefs + [one],
                           list(lplan.schema.names) + ["__k"])
            ipk = L.Project(iproj,
                            [ir.ColRef(i, f.dtype, f.name, f.strdict)
                             for i, f in enumerate(iproj.schema.fields)]
                            + [one], list(iproj.schema.names) + ["__k"])
            # account for the extra __k column on the left side
            shifted = []
            for p in extra_parts:
                cols = ir.referenced_columns(p)
                shifted.append(ir.remap_columns(
                    p, {c: (c + 1 if c >= lw else c) for c in cols}))
            plan = L.Join(lp, ipk, "left",
                          [L.JoinCond(ir.ColRef(lw, T.INTEGER, "__k"),
                                      ir.ColRef(len(ipk.schema) - 1,
                                                T.INTEGER, "__k"))],
                          extra=ir.make_and(shifted) if shifted else None)
            lw = lw + 1     # inner columns now start one later
        else:
            plan = L.CrossProduct(lplan, iproj)
            if extra_parts:
                plan = L.Filter(plan, ir.make_and(extra_parts))

        comb = Scope()
        for e_ in lscope.entries:
            comb.add(e_.alias, e_.schema)
        inner_start = lw
        for e_ in iscope.entries:
            # place inner entries at their joined-row positions
            comb.entries.append(ScopeEntry(
                e_.alias, e_.schema, inner_start + e_.start))
        bound = [self.bind_expr(e, comb) for e, _ in items]
        out_lrefs = [ir.ColRef(i, f.dtype, f.name, f.strdict)
                     for i, f in enumerate(lplan.schema.fields)]
        out = L.Project(plan, out_lrefs + bound,
                        list(lplan.schema.names) + names)
        out_scope = Scope()
        for e_ in lscope.entries:
            out_scope.add(e_.alias, e_.schema)
        out_scope.add(ref.alias.lower(),
                      Schema(tuple(out.schema.fields[len(lplan.schema):])))
        if on_ast is not None and not (
                isinstance(on_ast, A.ELit) and on_ast.value is True):
            # ON references the subquery's OUTPUT columns; bind it over
            # the projected row (post-join filter)
            if join_type == "left":
                raise BindError("LEFT JOIN LATERAL requires ON TRUE")
            out = L.Filter(out, self.bind_expr(on_ast, out_scope))
        return out, out_scope

    _FLIP_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}

    def _try_range_cond(self, c: A.EExpr, lscope, rscope):
        """Bind `lexpr <op> rexpr` with sides from opposite scopes into a
        (left_expr, op, right_expr) range-join driver."""
        if not (isinstance(c, A.EBinary)
                and c.op in ("<", "<=", ">", ">=")):
            return None
        for a, b, op in ((c.left, c.right, c.op),
                         (c.right, c.left, self._FLIP_OP[c.op])):
            try:
                le = self.bind_expr(a, lscope)
                re_ = self.bind_expr(b, rscope)
            except BindError:
                continue
            if le.dtype.id == TypeId.VARCHAR \
                    or re_.dtype.id == TypeId.VARCHAR:
                return None     # string ranges need dictionary order (r3)
            le2, re2 = self._align_join_keys(le, re_)
            return (le2, op, re2)
        return None

    def _try_equi_cond(self, c: A.EExpr, lscope, rscope, combined,
                       lwidth) -> Optional[L.JoinCond]:
        if not (isinstance(c, A.EBinary) and c.op == "=="):
            return None
        for a, b in ((c.left, c.right), (c.right, c.left)):
            try:
                le = self.bind_expr(a, lscope)
                re_ = self.bind_expr(b, rscope)
            except BindError:
                continue
            le2, re2 = self._align_join_keys(le, re_)
            return L.JoinCond(le2, re2)
        return None

    def _align_setop_strings(self, left: L.LogicalNode,
                             right: L.LogicalNode):
        """Recode VARCHAR columns of both set-op sides into one merged
        dictionary so codes compare/union correctly across sides
        (reference: set ops operate on raw strings —
        src/execution/operator/set/physical_union.cpp; our dictionary
        encoding needs explicit alignment)."""
        needs = []
        for i, (f, g) in enumerate(zip(left.schema.fields,
                                       right.schema.fields)):
            if f.dtype.id == TypeId.VARCHAR \
                    and g.dtype.id == TypeId.VARCHAR \
                    and f.strdict is not None and g.strdict is not None \
                    and f.strdict is not g.strdict:
                needs.append(i)
        if not needs:
            return left, right

        def recode(plan, other_schema, side):
            exprs, names = [], []
            for i, f in enumerate(plan.schema.fields):
                e = ir.ColRef(i, f.dtype, f.name, f.strdict)
                if i in needs:
                    g = other_schema.fields[i]
                    a, b = (f.strdict, g.strdict) if side == "l" \
                        else (g.strdict, f.strdict)
                    md, ltab, rtab = StringDictionary.merge(a, b)
                    tab = ltab if side == "l" else rtab
                    e = ir.DictLookup(e, tab.astype(np.int32),
                                      T.VARCHAR, "dict_align")
                    e.strdict = md
                exprs.append(e)
                names.append(f.name)
            return L.Project(plan, exprs, names)

        return (recode(left, right.schema, "l"),
                recode(right, left.schema, "r"))

    def _align_join_keys(self, le: ir.Expr, re_: ir.Expr
                         ) -> Tuple[ir.Expr, ir.Expr]:
        """Make both key sides comparable on device (dict merge, decimal
        rescale, numeric promote)."""
        lt, rt = le.dtype, re_.dtype
        if lt.id == TypeId.VARCHAR and rt.id == TypeId.VARCHAR:
            ld = getattr(le, "strdict", None)
            rd = getattr(re_, "strdict", None)
            if ld is rd or ld is None or rd is None:
                return le, re_
            md, ltab, rtab = StringDictionary.merge(ld, rd)
            le2 = ir.DictLookup(le, ltab, T.INTEGER, "dict_align")
            re2 = ir.DictLookup(re_, rtab, T.INTEGER, "dict_align")
            return le2, re2
        if lt.id == TypeId.DECIMAL or rt.id == TypeId.DECIMAL:
            s = max(lt.scale if lt.id == TypeId.DECIMAL else 0,
                    rt.scale if rt.id == TypeId.DECIMAL else 0)
            tgt = T.DECIMAL(18, s)
            return ir.promote(ir._as_decimal(le), tgt), \
                ir.promote(ir._as_decimal(re_), tgt)
        if lt != rt and lt.is_numeric and rt.is_numeric:
            ct = T.max_numeric(lt, rt)
            return ir.promote(le, ct), ir.promote(re_, ct)
        return le, re_

    # ------------------------------------------------------------------
    # WHERE + subquery flattening
    # ------------------------------------------------------------------
    def _bind_where(self, where: A.EExpr, plan, scope, outer_scope):
        conjs = ir_conjuncts_ast(where)
        preds: List[ir.Expr] = []
        self._plan_for_bounds = plan
        for c in conjs:
            if isinstance(c, A.EExists) or (
                    isinstance(c, A.EUnary) and c.op == "not"
                    and isinstance(c.child, A.EExists)):
                neg = isinstance(c, A.EUnary)
                ex = c.child if neg else c
                neg = neg or ex.negated
                plan = self._flatten_exists(ex.subquery, neg, plan, scope)
                continue
            if isinstance(c, A.EIn) and c.subquery is not None:
                plan = self._flatten_in(c, plan, scope)
                continue
            if _contains_mark_sub(c):
                # EXISTS/IN under OR/NOT/CASE: MARK joins compute a
                # boolean matched column per subquery (reference:
                # mark joins from flatten_dependent_join.cpp /
                # subquery planning in plan_subquery.cpp)
                c2, plan = self._flatten_marks(c, plan, scope)
                preds.append(c2)
                continue
            if _contains_scalar_sub(c):
                c2, plan = self._flatten_scalar_subs(c, plan, scope)
                preds.append(c2)
                continue
            self._plan_for_bounds = plan
            preds.append(self.bind_expr(c, scope))
        self._plan_for_bounds = None
        return plan, ir.make_and(preds)

    def _bind_subquery_corr(self, sub: A.SelectStmt, outer_scope: Scope):
        """Bind subquery FROM/WHERE, splitting correlated equality conjuncts.

        Returns (inner_plan, inner_scope, corr) where corr is a list of
        (outer_expr, inner_expr) bound pairs."""
        sub_binder = Binder(self.catalog, self.ctes, self.context)
        plan, iscope = sub_binder.bind_from(sub.from_refs)
        corr: List[Tuple[ir.Expr, ir.Expr]] = []
        corr_extra: List[Tuple[str, ir.Expr, ir.Expr]] = []
        preds: List[ir.Expr] = []
        if sub.where is not None:
            for c in ir_conjuncts_ast(sub.where):
                try:
                    preds.append(sub_binder.bind_expr(c, iscope))
                    continue
                except BindError:
                    pass
                ok = False
                if isinstance(c, A.EBinary) and c.op in (
                        "==", "!=", "<", "<=", ">", ">="):
                    flip = {"==": "==", "!=": "!=", "<": ">", "<=": ">=",
                            ">": "<", ">=": "<="}
                    for a, b, op in ((c.left, c.right, c.op),
                                     (c.right, c.left, flip[c.op])):
                        try:
                            oe = self.bind_expr(a, outer_scope)
                            ie = sub_binder.bind_expr(b, iscope)
                        except BindError:
                            continue
                        oe2, ie2 = self._align_join_keys(oe, ie)
                        if op == "==":
                            corr.append((oe2, ie2))
                        else:
                            corr_extra.append((op, oe2, ie2))
                        ok = True
                        break
                if not ok:
                    raise BindError(
                        "unsupported correlated predicate in subquery")
        if preds:
            plan = L.Filter(plan, ir.make_and(preds))
        return sub_binder, plan, iscope, corr, corr_extra

    def _flatten_exists(self, sub: A.SelectStmt, negated: bool, plan,
                        scope) -> L.LogicalNode:
        # uncorrelated subqueries (possibly with grouping etc.) bind whole
        try:
            full = Binder(self.catalog, self.ctes, self.context).bind_select(sub)
        except BindError:
            full = None
        if full is not None:
            one = ir.Const(1, T.INTEGER)
            iplan = L.Project(full, [one], ["__k"])
            oplan = L.Project(plan, [
                ir.ColRef(i, f.dtype, f.name, f.strdict)
                for i, f in enumerate(plan.schema.fields)] + [one],
                list(plan.schema.names) + ["__k"])
            jt = "anti" if negated else "semi"
            j = L.Join(oplan, iplan, jt,
                       [L.JoinCond(ir.ColRef(len(plan.schema), T.INTEGER,
                                             "__k"),
                                   ir.ColRef(0, T.INTEGER, "__k"))])
            return L.Project(j, [
                ir.ColRef(i, f.dtype, f.name, f.strdict)
                for i, f in enumerate(plan.schema.fields)],
                list(plan.schema.names))
        sb, iplan, iscope, corr, corr_extra = \
            self._bind_subquery_corr(sub, scope)
        if not corr and not corr_extra:
            # uncorrelated EXISTS: evaluate as mark over const? keep simple:
            # semi-join on constant key 1=1 via cross + limit is overkill;
            # use count>0 decided at execution by semi join on dummy keys
            one = ir.Const(1, T.INTEGER)
            iplan = L.Project(iplan, [one], ["__k"])
            oplan = L.Project(plan, [
                ir.ColRef(i, f.dtype, f.name, f.strdict)
                for i, f in enumerate(plan.schema.fields)] + [one],
                list(plan.schema.names) + ["__k"])
            jt = "anti" if negated else "semi"
            j = L.Join(oplan, iplan, jt,
                       [L.JoinCond(ir.ColRef(len(plan.schema), T.INTEGER,
                                             "__k"),
                                   ir.ColRef(0, T.INTEGER, "__k"))])
            # drop helper column
            return L.Project(j, [
                ir.ColRef(i, f.dtype, f.name, f.strdict)
                for i, f in enumerate(plan.schema.fields)],
                list(plan.schema.names))
        if not corr:
            # inequality-only correlation: range semi/anti join driven by
            # the first usable inequality (reference: plan_comparison_join
            # falls back to PiecewiseMergeJoin for these)
            jt = "anti" if negated else "semi"
            drv = next((k for k, (op, oe, ie) in enumerate(corr_extra)
                        if op in ("<", "<=", ">", ">=")
                        and oe.dtype.id != TypeId.VARCHAR
                        and ie.dtype.id != TypeId.VARCHAR), None)
            if drv is None:
                raise BindError("EXISTS correlation needs an equality or "
                                "inequality predicate")
            ikeys = [ie for (_, _, ie) in corr_extra]
            iproj = L.Project(iplan, ikeys,
                              [f"__ck{i}" for i in range(len(ikeys))])
            lw = len(plan.schema)
            op0, oe0, ie0 = corr_extra[drv]
            rref0 = ir.ColRef(drv, ie0.dtype, f"__ck{drv}",
                              getattr(ie0, "strdict", None))
            o2, r2 = self._align_join_keys(oe0, rref0)
            parts = []
            for j, (op, oe, ie) in enumerate(corr_extra):
                if j == drv:
                    continue
                rref = ir.ColRef(lw + j, ie.dtype, f"__ck{j}",
                                 getattr(ie, "strdict", None))
                parts.append(ir.Cmp(op, oe, rref))
            extra = ir.make_and(parts) if parts else None
            return L.Join(plan, iproj, jt, [], extra=extra,
                          range_cond=(o2, op0, r2))
        jt = "anti" if negated else "semi"
        # inner plan projects the correlated inner exprs as join keys,
        # plus inner sides of non-equality correlations for the residual
        ikeys = [ie for (_, ie) in corr] + [ie for (_, _, ie) in corr_extra]
        iproj = L.Project(iplan, ikeys,
                          [f"__ck{i}" for i in range(len(ikeys))])
        conds = [L.JoinCond(oe, ir.ColRef(i, ie.dtype, f"__ck{i}",
                                          getattr(ie, "strdict", None)))
                 for i, (oe, ie) in enumerate(corr)]
        extra = None
        if corr_extra:
            lw = len(plan.schema)
            parts = []
            for j, (op, oe, ie) in enumerate(corr_extra):
                rref = ir.ColRef(lw + len(corr) + j, ie.dtype,
                                 f"__ck{len(corr)+j}",
                                 getattr(ie, "strdict", None))
                parts.append(ir.Cmp(op, oe, rref))
            extra = ir.make_and(parts)
        return L.Join(plan, iproj, jt, conds, extra=extra)

    def _flatten_in(self, c: A.EIn, plan, scope) -> L.LogicalNode:
        # uncorrelated subqueries (with grouping/having etc.): bind whole
        try:
            full = Binder(self.catalog, self.ctes, self.context).bind_select(c.subquery)
        except BindError:
            full = None
        if full is not None:
            f0 = full.schema.field(0)
            outer = self.bind_expr(c.child, scope)
            o2, i2 = self._align_join_keys(
                outer, ir.ColRef(0, f0.dtype, f0.name, f0.strdict))
            if c.negated:
                return self._notin_mark(plan, full, [L.JoinCond(o2, i2)])
            return L.Join(plan, full, "semi", [L.JoinCond(o2, i2)])
        sb, iplan, iscope, corr, corr_extra = \
            self._bind_subquery_corr(c.subquery, scope)
        if corr_extra:
            raise BindError("IN subquery with non-equality correlation")
        # bind subquery select item over inner scope
        if len(c.subquery.items) != 1:
            raise BindError("IN subquery must return one column")
        item = sb.bind_expr(c.subquery.items[0][0], iscope)
        outer = self.bind_expr(c.child, scope)
        o2, i2 = self._align_join_keys(outer, item)
        keys = [i2] + [ie for (_, ie) in corr]
        iproj = L.Project(iplan, keys,
                          [f"__ck{i}" for i in range(len(keys))])
        conds = [L.JoinCond(o2, ir.ColRef(0, i2.dtype, "__ck0",
                                          getattr(i2, "strdict", None)))]
        for i, (oe, ie) in enumerate(corr):
            conds.append(L.JoinCond(
                oe, ir.ColRef(i + 1, ie.dtype, f"__ck{i+1}",
                              getattr(ie, "strdict", None))))
        if c.negated:
            return self._notin_mark(plan, iproj, conds)
        return L.Join(plan, iproj, "semi", conds)

    def _notin_mark(self, plan, inner, conds):
        """NOT IN needs SQL 3-valued semantics: plan a mark join and keep
        only rows whose mark is exactly FALSE (NULL marks — probe NULL vs
        non-empty build, or NULL in the build values — are filtered, and
        the whole result is empty when the build side contains NULL).
        Reference: subquery planning lowers NOT IN to mark join + NOT
        filter (src/planner/subquery/flatten_dependent_join.cpp)."""
        lw = len(plan.schema)
        j = L.Join(plan, inner, "mark", conds, mark_name="__notin",
                   mark_in=True)
        filt = L.Filter(j, ir.Not(ir.ColRef(lw, T.BOOLEAN, "__notin")))
        return L.Project(
            filt,
            [ir.ColRef(i, f.dtype, f.name, f.strdict)
             for i, f in enumerate(plan.schema.fields)],
            list(plan.schema.names))

    def _flatten_marks(self, c: A.EExpr, plan, scope):
        """Plan each EXISTS/IN-subquery inside predicate `c` as a MARK
        join appending a boolean matched column, then bind `c` with those
        columns substituted.  IN marks are 3-valued (mark_in=True: the
        executor emits NULL where no match but the probe value is NULL or
        a correlation-matching build row has a NULL IN-value, matching
        the reference's NextMarkJoin semantics)."""
        subs: list = []
        _collect_mark_subs(c, subs)
        replacements: Dict[int, ir.Expr] = {}
        for m in subs:
            sub = m.subquery
            neg = bool(getattr(m, "negated", False))
            sb, iplan, iscope, corr, corr_extra = \
                self._bind_subquery_corr(sub, scope)
            if corr_extra:
                raise BindError(
                    "mark join with non-equality correlation unsupported")
            keys = []
            outer = []
            if isinstance(m, A.EIn):
                if len(sub.items) != 1:
                    raise BindError("IN subquery must return one column")
                it0 = sub.items[0][0]
                if isinstance(it0, A.EStar):
                    # SELECT * subquery (e.g. IN (VALUES ...)): the
                    # star must expand to exactly one inner column
                    flat = [(se.alias, f.name)
                            for se in iscope.entries
                            for fi, f in enumerate(se.schema.fields)
                            if fi not in se.hidden]
                    if len(flat) != 1:
                        raise BindError(
                            "IN subquery must return one column")
                    it0 = A.EIdent([flat[0][0], flat[0][1]])
                item = sb.bind_expr(it0, iscope)
                o0 = self.bind_expr(m.child, scope)
                o2, i2 = self._align_join_keys(o0, item)
                keys.append(i2)
                outer.append(o2)
            keys += [ie for (_, ie) in corr]
            outer += [oe for (oe, _) in corr]
            lw = len(plan.schema)
            if not keys:
                # uncorrelated EXISTS: constant-key mark join
                one = ir.Const(1, T.INTEGER)
                iproj = L.Project(iplan, [one], ["__k"])
                plan = L.Project(
                    plan,
                    [ir.ColRef(i, f.dtype, f.name, f.strdict)
                     for i, f in enumerate(plan.schema.fields)] + [one],
                    list(plan.schema.names) + ["__k"])
                conds = [L.JoinCond(ir.ColRef(lw, T.INTEGER, "__k"),
                                    ir.ColRef(0, T.INTEGER, "__k"))]
            else:
                iproj = L.Project(iplan, keys,
                                  [f"__mk{i}" for i in range(len(keys))])
                conds = [L.JoinCond(
                    oe, ir.ColRef(i, ke.dtype, f"__mk{i}",
                                  getattr(ke, "strdict", None)))
                    for i, (oe, ke) in enumerate(zip(outer, keys))]
            mname = f"__mark{len(replacements)}"
            plan = L.Join(plan, iproj, "mark", conds, mark_name=mname,
                          mark_in=isinstance(m, A.EIn))
            col = ir.ColRef(len(plan.schema) - 1, T.BOOLEAN, mname)
            replacements[id(m)] = ir.Not(col) if neg else col
        bound = self.bind_expr(c, _scope_of_plan(plan, scope),
                               sub_replacements=replacements)
        return bound, plan

    @staticmethod
    def _count_fix(vcol, raw_item, agg_ctx):
        """Unmatched outer rows read NULL through the decorrelating left
        join, but COUNT over zero rows is 0 — coalesce when the subquery
        item is a bare count aggregate (reference: count handling in
        flatten_dependent_join.cpp)."""
        if isinstance(raw_item, AggRef) \
                and agg_ctx.specs[raw_item.index].kind in ("count",
                                                           "count_star"):
            return ir.Func("coalesce", [vcol, ir.Const(0, vcol.dtype)],
                           vcol.dtype)
        return vcol

    def _flatten_scalar_subs(self, c: A.EExpr, plan, scope):
        """Replace each scalar subquery inside conjunct c with a column
        joined into plan; returns (bound predicate, new plan)."""
        subs: List[A.ESub] = []
        _collect_scalar_subs(c, subs)
        replacements: Dict[int, ir.Expr] = {}
        for s in subs:
            sb, iplan, iscope, corr, corr_extra = \
                self._bind_subquery_corr(s.subquery, scope)
            if corr_extra:
                raise BindError(
                    "scalar subquery with non-equality correlation")
            if len(s.subquery.items) != 1:
                raise BindError("scalar subquery must return one column")
            item_ast = s.subquery.items[0][0]
            if corr:
                if not self._contains_agg(item_ast) \
                        and s.subquery.order_by \
                        and s.subquery.limit == 1 \
                        and not s.subquery.offset:
                    # correlated ORDER BY ... LIMIT 1: first row per
                    # correlation key via a row_number window over the
                    # decorrelated inner plan (reference handles this in
                    # flatten_dependent_join.cpp by pushing the limit
                    # into a dependent join; a rank-filter is the
                    # standard set-based equivalent)
                    item_bound = sb.bind_expr(item_ast, iscope)
                    groups = [ie for (_, ie) in corr]
                    okeys = []
                    for it in s.subquery.order_by:
                        oe = sb.bind_expr(it.expr, iscope)
                        nl = it.nulls_last if it.nulls_last is not None \
                            else sb._default_nulls_last()
                        okeys.append(L.OrderKey(oe, sb._desc(it), nl))
                    rn = L.WindowFn("row_number", None, list(groups),
                                    okeys, T.BIGINT, "__rn")
                    wplan = L.Window(iplan, [rn])
                    rncol = ir.ColRef(len(wplan.schema) - 1, T.BIGINT,
                                      "__rn")
                    fplan = L.Filter(wplan, ir.Cmp(
                        "==", rncol, ir.Const(1, T.BIGINT)))
                    aproj = L.Project(
                        fplan, list(groups) + [item_bound],
                        [f"__g{i}" for i in range(len(groups))]
                        + ["__v"])
                    conds = [L.JoinCond(
                        oe, ir.ColRef(i, ie.dtype, f"__g{i}",
                                      getattr(ie, "strdict", None)))
                        for i, (oe, ie) in enumerate(corr)]
                    plan = L.Join(plan, aproj, "left", conds)
                    replacements[id(s)] = ir.ColRef(
                        len(plan.schema) - 1, item_bound.dtype, "__v",
                        getattr(item_bound, "strdict", None))
                    continue
                if not self._contains_agg(item_ast):
                    raise BindError(
                        "correlated scalar subquery must be an aggregate")
                agg_ctx = AggCtx()
                item_bound_raw = sb.bind_expr(item_ast, iscope,
                                              agg_ctx=agg_ctx)
                groups = [ie for (_, ie) in corr]
                agg = L.Aggregate(iplan, groups, agg_ctx.specs,
                                  [f"__g{i}" for i in range(len(groups))])
                # resolve AggRefs in bound_item over agg output
                bound_item = _resolve_aggrefs(item_bound_raw, len(groups))
                aproj = L.Project(
                    agg,
                    [ir.ColRef(i, g.dtype, f"__g{i}",
                               getattr(g, "strdict", None))
                     for i, g in enumerate(groups)] + [bound_item],
                    [f"__g{i}" for i in range(len(groups))] + ["__v"])
                conds = [L.JoinCond(
                    oe, ir.ColRef(i, ie.dtype, f"__g{i}",
                                  getattr(ie, "strdict", None)))
                    for i, (oe, ie) in enumerate(corr)]
                plan = L.Join(plan, aproj, "left", conds)
                # value column is last in join output
                vcol = ir.ColRef(len(plan.schema) - 1, bound_item.dtype,
                                 "__v")
                replacements[id(s)] = self._count_fix(
                    vcol, item_bound_raw, agg_ctx)
            else:
                # uncorrelated: full subquery plan (may itself aggregate)
                splan = Binder(self.catalog, self.ctes, self.context).bind_select(
                    s.subquery)
                old_width = len(plan.schema)
                plan = L.CrossProduct(plan, splan)
                f = splan.schema.field(0)
                replacements[id(s)] = ir.ColRef(old_width, f.dtype,
                                                f.name, f.strdict)
        # bind c with replacements for ESub nodes
        bound = self.bind_expr(c, _scope_of_plan(plan, scope),
                               sub_replacements=replacements)
        return bound, plan

    # ------------------------------------------------------------------
    # aggregation binding
    # ------------------------------------------------------------------
    def _contains_agg(self, e: A.EExpr) -> bool:
        if isinstance(e, A.EFunc):
            nm = FUNC_ALIASES.get(e.name, e.name)
            if nm in AGG_FUNCS or nm in AGG_MACROS \
                    or nm in (getattr(self.context, "_agg_udfs", None)
                              or {}):
                return True
        for ch in _ast_children(e):
            if self._contains_agg(ch):
                return True
        return False

    def _bind_aggregate(self, stmt: A.SelectStmt, items, plan, scope,
                        win_ctx=None):
        # resolve group-by expressions (ordinals / aliases / exprs)
        group_asts: List[A.EExpr] = []
        for g in stmt.group_by:
            if isinstance(g, A.ELit) and isinstance(g.value, int):
                group_asts.append(items[g.value - 1][0])
                continue
            if isinstance(g, A.EIdent) and len(g.parts) == 1:
                # real column wins; otherwise a select-item alias
                try:
                    self.bind_expr(g, scope)
                    group_asts.append(g)
                    continue
                except BindError:
                    pass
                matched = False
                for e, alias in items:
                    if alias == g.parts[0]:
                        group_asts.append(e)
                        matched = True
                        break
                if matched:
                    continue
            group_asts.append(g)
        bound_groups = [self.bind_expr(g, scope) for g in group_asts]
        group_keys = [_ekey(bg) for bg in bound_groups]

        for e, alias in items:
            self._validate_group_refs(e, group_asts, scope, group_keys)

        agg_ctx = AggCtx()
        bound_items = []
        for e, alias in items:
            bound_items.append(self.bind_expr(e, scope, agg_ctx=agg_ctx,
                                              group_map=(group_asts,
                                                         group_keys),
                                              win_ctx=win_ctx))
        having_bound = None
        if stmt.having is not None:
            having_bound = self.bind_expr(stmt.having, scope,
                                          agg_ctx=agg_ctx,
                                          group_map=(group_asts,
                                                     group_keys))

        # ORDER BY expressions not in the SELECT list (aggregates, group
        # keys, grouping()-functions, CASE over them) pre-bind here so
        # their specs make it into the Aggregate node; select-list aliases
        # fail to bind and resolve later by name instead
        order_prebound = {}
        for it in stmt.order_by:
            if isinstance(it.expr, A.ELit):
                continue
            try:
                # select-item aliases may appear INSIDE the expression
                # (e.g. ORDER BY CASE WHEN lochierarchy = 0 THEN ... END)
                e = _subst_item_aliases(it.expr, items)
                order_prebound[_ekey(it.expr)] = self.bind_expr(
                    e, scope, agg_ctx=agg_ctx,
                    group_map=(group_asts, group_keys),
                    win_ctx=win_ctx)
            except BindError:
                pass

        gnames = [f"__g{i}" for i in range(len(bound_groups))]
        ngroups = len(bound_groups)
        has_grouping_fn = any(
            any(isinstance(n, GroupingRef) for n in ir.walk(x))
            for x in (list(bound_items)
                      + ([having_bound] if having_bound is not None else [])
                      + list(order_prebound.values())))
        add_mask = has_grouping_fn and stmt.grouping_sets is not None
        if add_mask:
            gnames = gnames + ["__gmask"]
        if stmt.grouping_sets is not None:
            # one aggregate per set; excluded keys group by constant NULL
            # (same result as omitting them) so every set shares one
            # schema and the results UNION ALL cleanly (reference:
            # grouping-set expansion in bind_select_node.cpp)
            agg = None
            for gset in stmt.grouping_sets:
                keep = set(gset)
                groups_k = []
                for i, bg in enumerate(bound_groups):
                    if i in keep:
                        groups_k.append(bg)
                    else:
                        c = ir.Const(None, bg.dtype)
                        c.strdict = getattr(bg, "strdict", None)
                        groups_k.append(c)
                if add_mask:
                    mask = sum(1 << (ngroups - 1 - i)
                               for i in range(ngroups) if i not in keep)
                    groups_k.append(ir.Const(mask, T.BIGINT))
                a_k = L.Aggregate(plan, groups_k, agg_ctx.specs, gnames)
                agg = a_k if agg is None else L.Union(agg, a_k)
        else:
            agg = L.Aggregate(plan, bound_groups, agg_ctx.specs, gnames)
        base = ngroups + (1 if add_mask else 0)
        if has_grouping_fn:
            mask_col = ir.ColRef(ngroups, T.BIGINT, "__gmask") \
                if add_mask else None
            bound_items = [_resolve_grouprefs(b, mask_col, ngroups)
                           for b in bound_items]
            if having_bound is not None:
                having_bound = _resolve_grouprefs(having_bound, mask_col,
                                                  ngroups)
            order_prebound = {k: _resolve_grouprefs(v, mask_col, ngroups)
                              for k, v in order_prebound.items()}
        bound_items = [_resolve_aggrefs(b, base) for b in bound_items]
        if having_bound is not None:
            having_bound = _resolve_aggrefs(having_bound, base)
        order_prebound = {k: _resolve_aggrefs(v, base)
                          for k, v in order_prebound.items()}
        if win_ctx is not None and win_ctx.fns:
            # window specs bound with agg/group placeholders: rewrite them
            # into ColRefs over the Aggregate output
            def rw(x):
                if x is None:
                    return None
                if has_grouping_fn:
                    x = _resolve_grouprefs(
                        x, ir.ColRef(ngroups, T.BIGINT, "__gmask")
                        if add_mask else None, ngroups)
                return _resolve_aggrefs(x, base)
            import copy as _copy
            for i, wf in enumerate(win_ctx.fns):
                wf = _copy.copy(wf)
                wf.arg = rw(wf.arg)
                wf.partition = [rw(p) for p in wf.partition]
                wf.order = [L.OrderKey(rw(k.expr), k.desc, k.nulls_last)
                            for k in wf.order]
                win_ctx.fns[i] = wf
        return agg, bound_items, having_bound, order_prebound


    def _default_desc(self) -> bool:
        if self.context is not None:
            try:
                return str(self.context.config.get(
                    "default_order")).lower() in ("desc", "descending")
            except Exception:
                pass
        return False

    def _desc(self, it) -> bool:
        """Resolve an OrderItem's direction against the default_order
        setting (reference: PRAGMA default_order)."""
        return self._default_desc() if it.desc is None else it.desc

    def _default_nulls_last(self) -> bool:
        if self.context is not None:
            try:
                return str(self.context.config.get(
                    "default_null_order")).lower() in (
                    "nulls_last", "last")
            except Exception:
                pass
        return True

    def _validate_group_refs(self, e: A.EExpr, group_asts, scope,
                             group_keys=None):
        """Reject bare column references that are neither grouped nor
        inside an aggregate (reference: binder 'must appear in GROUP BY'
        errors, test_group_by_error.test)."""
        if any(_ast_equal(e, g) for g in group_asts):
            return
        if group_keys and not _contains_volatile(e):
            # semantic match: `t.j * 2` equals group expr `j * 2`
            # once bound (qualified vs unqualified references)
            try:
                if _ekey(self.bind_expr(e, scope)) in group_keys:
                    return
            except BindError:
                pass
        if isinstance(e, A.EFunc) and (
                FUNC_ALIASES.get(e.name, e.name) in AGG_FUNCS
                or FUNC_ALIASES.get(e.name, e.name) in AGG_MACROS
                or FUNC_ALIASES.get(e.name, e.name) in
                (getattr(self.context, "_agg_udfs", None) or {})
                or e.star):
            return
        if isinstance(e, (A.EWindow, A.ESub, A.EExists)):
            return
        if isinstance(e, A.EIdent):
            try:
                self.bind_expr(e, scope)
            except BindError:
                return   # alias/unknown — resolved or errored elsewhere
            raise BindError(
                f"column \"{e.parts[-1]}\" must appear in the GROUP BY "
                "clause or be used in an aggregate function")
        for c in _ast_children(e):
            self._validate_group_refs(c, group_asts, scope, group_keys)

    # ------------------------------------------------------------------
    # ORDER BY
    # ------------------------------------------------------------------
    def _bind_order_keys(self, stmt, items, names, out_schema,
                         hidden_scope, prebound=None):
        """Resolve ORDER BY keys over the projected schema; unresolvable
        keys bind over hidden_scope / pre-bound aggregate expressions as
        hidden sort columns.  Returns (keys, hidden) where hidden =
        [(bound_expr, name)]."""
        keys = []
        hidden = []
        prebound = prebound or {}
        item_keys = [_ekey(e) for e, _ in items]
        for it in stmt.order_by:
            e = it.expr
            idx = None
            if isinstance(e, A.ELit) and isinstance(e.value, int):
                idx = e.value - 1
            elif isinstance(e, A.EIdent) and len(e.parts) == 1 \
                    and e.parts[0] in names:
                idx = names.index(e.parts[0])
            elif _ekey(e) in item_keys:
                idx = item_keys.index(_ekey(e))
            nl = it.nulls_last
            if nl is None:
                nl = self._default_nulls_last()
            if idx is not None:
                f = out_schema.field(idx)
                coll = None
                if f.dtype.id == TypeId.VARCHAR \
                        and hidden_scope is not None:
                    # column-level / default collation orders through
                    # a hidden folded sort key; the projected value
                    # keeps its original text (reference: PushCollation
                    # on ORDER BY keys)
                    coll = self._column_collation(
                        ir.ColRef(idx, f.dtype, f.name, f.strdict))
                    if not coll and self.context is not None:
                        coll = str(self.context.config.get(
                            "default_collation") or "") or None
                        if coll:
                            self.uncacheable = True
                if coll:
                    try:
                        be = self._bind_collate(
                            self.bind_expr(items[idx][0],
                                           hidden_scope), coll)
                        hidx = len(names) + len(hidden)
                        hidden.append((be, f"__sort{len(hidden)}"))
                        keys.append(L.OrderKey(
                            ir.ColRef(hidx, be.dtype,
                                      f"__sort{len(hidden) - 1}",
                                      getattr(be, "strdict", None)),
                            self._desc(it), nl))
                        continue
                    except BindError:
                        pass
                keys.append(L.OrderKey(
                    ir.ColRef(idx, f.dtype, f.name, f.strdict),
                    self._desc(it), nl))
                continue
            if _ekey(e) in prebound:
                be = prebound[_ekey(e)]
            elif hidden_scope is not None:
                try:
                    be = self.bind_expr(e, hidden_scope)
                except BindError:
                    # ORDER BY alias COLLATE x / alias expressions
                    sub = self._lateral_alias_subst(e, items)
                    if sub is None:
                        raise
                    be = self.bind_expr(sub, hidden_scope)
            else:
                raise BindError(
                    f"ORDER BY expression must appear in SELECT list: {e}")
            hidx = len(names) + len(hidden)
            hidden.append((be, f"__sort{len(hidden)}"))
            keys.append(L.OrderKey(
                ir.ColRef(hidx, be.dtype, f"__sort{len(hidden)-1}",
                          getattr(be, "strdict", None)),
                self._desc(it), nl))
        return keys, hidden

    def _order_key_over_schema(self, it: A.OrderItem, schema: Schema,
                               alt_names=None):
        e = it.expr
        if isinstance(e, A.ELit) and isinstance(e.value, int):
            idx = e.value - 1
        elif isinstance(e, A.EIdent):
            name = e.parts[-1]
            try:
                idx = schema.index_of(name)
            except KeyError:
                if alt_names and name.lower() in [a.lower()
                                                 for a in alt_names]:
                    idx = [a.lower() for a in alt_names].index(
                        name.lower())
                else:
                    raise BindError(f"ORDER BY column {name} not found")
        else:
            raise BindError("unsupported ORDER BY in set operation")
        f = schema.field(idx)
        return L.OrderKey(ir.ColRef(idx, f.dtype, f.name, f.strdict),
                          self._desc(it), it.nulls_last
                          if it.nulls_last is not None
                          else self._default_nulls_last())

    # ------------------------------------------------------------------
    # expression binding
    # ------------------------------------------------------------------
    def bind_expr(self, e: A.EExpr, scope: Scope, agg_ctx=None,
                  group_map=None, sub_replacements=None,
                  win_ctx=None) -> ir.Expr:
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements, win_ctx)
        if isinstance(e, A.EWindow):
            if win_ctx is None:
                raise BindError("window function not allowed here")
            return self._bind_window(e, scope, win_ctx, agg_ctx, group_map)
        # group expression matching (whole-subtree)
        if group_map is not None:
            gasts, gkeys = group_map
            for gi, ga in enumerate(gasts):
                if _ast_equal(e, ga):
                    bg = self.bind_expr(ga, scope)
                    return ir.ColRef(gi, bg.dtype, f"__g{gi}",
                                     getattr(bg, "strdict", None))
            if not isinstance(e, (A.ELit,)) \
                    and any(type(ga) is type(e) for ga in gasts) \
                    and not _contains_volatile(e):
                # semantic match for qualified/rewritten forms of a
                # group expression (t.j*2 vs j*2)
                try:
                    bound_try = self.bind_expr(e, scope)
                except BindError:
                    bound_try = None
                if bound_try is not None:
                    k = _ekey(bound_try)
                    for gi, gk in enumerate(gkeys):
                        if k == gk:
                            return ir.ColRef(
                                gi, bound_try.dtype, f"__g{gi}",
                                getattr(bound_try, "strdict", None))
        if sub_replacements is not None and isinstance(e, A.ESub):
            return sub_replacements[id(e)]
        if sub_replacements is not None \
                and isinstance(e, (A.EExists, A.EIn)) \
                and id(e) in sub_replacements:
            return sub_replacements[id(e)]

        if isinstance(e, A.EIdent):
            try:
                return scope.resolve(e.parts)
            except BindError:
                # struct field access: s.f / t.s.f resolves the prefix
                # as a STRUCT column then extracts the trailing field
                if len(e.parts) >= 2:
                    try:
                        base = scope.resolve(e.parts[:-1])
                    except BindError:
                        base = None
                    if base is not None \
                            and base.dtype.id == TypeId.STRUCT:
                        return self._struct_extract(base, e.parts[-1])
                    if base is not None \
                            and base.dtype.id == TypeId.UNION:
                        return self._union_extract(base, e.parts[-1])
                if e.parts[-1].lower() == "rowid" \
                        and len(scope.entries) == 1:
                    # base-table pseudo-column: the scan batch is
                    # table-row aligned, so rowid = the array position
                    # (reference: rowid pseudo column, table_scan.cpp)
                    return ir.Func("rowid", [], T.BIGINT)
                raise
        if isinstance(e, A.EParam):
            if self.params is None:
                raise BindError("query has parameters but none were "
                                "supplied (pass params=[...])")
            if e.index is not None:
                idx = e.index - 1
            else:
                idx = self._next_param
                self._next_param += 1
            if idx >= len(self.params):
                raise BindError(f"missing value for parameter {idx + 1}")
            return self._bind_literal(self.params[idx])
        if isinstance(e, A.ELit):
            return self._bind_literal(e.value)
        if isinstance(e, A.EList):
            return self._bind_list_literal(e, scope, agg_ctx, group_map,
                                           sub_replacements)
        if isinstance(e, A.EStruct):
            return self._bind_struct_literal(e, scope, agg_ctx, group_map,
                                             sub_replacements)
        if isinstance(e, A.EMap):
            return self._bind_map_literal(e, scope, agg_ctx, group_map,
                                          sub_replacements)
        if isinstance(e, A.EIndex):
            return self._bind_index(e, scope, agg_ctx, group_map,
                                    sub_replacements)
        if isinstance(e, A.ECollate):
            return self._bind_collate(b(e.child), e.collation)
        if isinstance(e, A.ETyped):
            return self._bind_typed_literal(e)
        if isinstance(e, A.EUnary):
            if e.op == "not":
                return ir.Not(b(e.child))
            if e.op == "~":
                c = b(e.child)
                if self._is_bit(c):
                    return self._bit_not(c)
                # two's complement: ~x == -1 - x (reference: operator ~,
                # core_functions/scalar/operators/bitwise.cpp)
                return ir.bind_arith("-", ir.Const(-1, T.INTEGER), c)
            c = b(e.child)
            if isinstance(c, ir.Const) and c.value is not None:
                return ir.Const(-c.value, c.dtype)
            zero = ir.Const(0, c.dtype)
            return ir.bind_arith("-", zero, c)
        if isinstance(e, A.EBinary):
            if e.op in ("and", "or"):
                return ir.BoolOp(e.op, (b(e.left), b(e.right)))
            if e.op in ("==", "!=", "<", "<=", ">", ">="):
                return self._bind_comparison(e.op, e.left, e.right, scope,
                                             agg_ctx, group_map,
                                             sub_replacements, win_ctx)
            return self._bind_arith(e.op, b(e.left), b(e.right))
        if isinstance(e, A.EBetween):
            lo = A.EBinary(">=", e.child, e.lo)
            hi = A.EBinary("<=", e.child, e.hi)
            both = A.EBinary("and", lo, hi)
            out = b(both)
            return ir.Not(out) if e.negated else out
        if isinstance(e, A.EIsNull):
            return ir.IsNull(b(e.child), e.negated)
        if isinstance(e, A.ELike):
            return self._bind_like(e, scope, agg_ctx, group_map,
                                   sub_replacements)
        if isinstance(e, A.EIn):
            if e.subquery is not None:
                raise BindError("IN subquery only supported in WHERE")
            child = b(e.child)
            if child.dtype.id == TypeId.VARCHAR:
                sd = getattr(child, "strdict", None)
                codes = []
                for item in e.items:
                    be = b(item)
                    if not isinstance(be, ir.Const):
                        raise BindError("IN list must be constants")
                    isd = getattr(be, "strdict", None)
                    text = isd.decode_one(be.value) if isd is not None \
                        else self._const_text(be)
                    code = sd.code_of(text)
                    if code >= 0:
                        codes.append(code)
                if not codes:
                    return ir.Const(bool(e.negated), T.BOOLEAN)
                return ir.InList(child, codes, e.negated)
            vals = []
            for item in e.items:
                be = b(item)
                if not isinstance(be, ir.Const):
                    raise BindError("IN list must be constants")
                if be.dtype.id == TypeId.VARCHAR:
                    be = self._const_varchar_as(be, child.dtype)
                v = be.value
                if child.dtype.id == TypeId.DECIMAL \
                        and be.dtype.id != TypeId.DECIMAL:
                    v = v * T.decimal_scale_factor(child.dtype.scale)
                vals.append(v)
            return ir.InList(child, vals, e.negated)
        if isinstance(e, A.ECase):
            return self._bind_case(e, scope, agg_ctx, group_map,
                                   sub_replacements)
        if isinstance(e, A.ECast):
            return self._bind_cast(b(e.child), e.typename, e.width,
                                   e.scale, e.try_)
        if isinstance(e, A.EFunc):
            return self._bind_func(e, scope, agg_ctx, group_map,
                                   sub_replacements)
        if isinstance(e, A.ESub):
            # FROM-less scalar subquery over outer columns inlines
            # directly: (SELECT t.a) == t.a
            if not e.subquery.from_refs and len(e.subquery.items) == 1 \
                    and e.subquery.where is None:
                try:
                    return b(e.subquery.items[0][0])
                except BindError:
                    pass
            return self._eager_scalar_sub(e)
        if isinstance(e, A.EExists):
            raise BindError("EXISTS only supported in WHERE conjuncts")
        raise BindError(f"cannot bind expression {e}")

    def _eager_scalar_sub(self, e: A.ESub) -> ir.Expr:
        """Uncorrelated scalar subquery: execute at bind time, fold to a
        constant (correlated ones are flattened in _bind_where; reaching
        here correlated raises BindError from the inner bind)."""
        from ..plan import optimizer, physical
        plan = Binder(self.catalog, self.ctes, self.context).bind_select(e.subquery)
        plan = optimizer.optimize(plan)
        schema, batch = physical.execute(plan)
        import numpy as np
        sel = np.asarray(batch.sel)
        f = schema.field(0)
        idx = np.nonzero(sel)[0]
        if len(idx) == 0:
            return ir.Const(None, f.dtype)
        i = int(idx[0])
        col = batch.columns[0]
        if col.nulls is not None and bool(np.asarray(col.nulls)[i]):
            return ir.Const(None, f.dtype)
        raw = np.asarray(col.data)[i]
        if f.dtype.id == TypeId.VARCHAR:
            c = ir.Const(0, T.VARCHAR)
            c.strdict = StringDictionary(
                np.array([f.strdict.decode_one(int(raw))], dtype=object))
            return c
        dt = f.dtype
        v = raw.item()
        if dt.id == TypeId.DECIMAL:
            # strip trailing zeros so downstream rescales stay in int64
            scale = dt.scale
            while scale > 0 and v % 10 == 0:
                v //= 10
                scale -= 1
            dt = T.DECIMAL(18, scale)
        return ir.Const(v, dt)

    def _bind_literal(self, v) -> ir.Const:
        t = T.literal_type(v)
        if v is None:
            return ir.Const(None, t)
        if t.id == TypeId.VARCHAR:
            c = ir.Const(0, T.VARCHAR)
            c.strdict = StringDictionary(np.array([v], dtype=object))
            return c
        return ir.Const(T.encode_literal(v, t), t)

    def _bind_typed_literal(self, e: A.ETyped) -> ir.Expr:
        if e.typename == "date":
            return ir.Const(T.encode_literal(e.text, T.DATE), T.DATE)
        if e.typename == "timestamp":
            return ir.Const(T.encode_literal(e.text, T.TIMESTAMP),
                            T.TIMESTAMP)
        if e.typename == "time":
            return ir.Const(T.encode_literal(e.text, T.TIME), T.TIME)
        if e.typename == "timestamptz":
            # naive strings interpret in the session TimeZone; explicit
            # offsets win (reference: ICU timestamptz cast semantics)
            sp = T.temporal_special(e.text, T.TIMESTAMPTZ)
            if sp is None:
                from .. import tz as tzmod
                zone = str(self.context.config.get("timezone") or "UTC")
                sp = tzmod.parse_timestamptz(e.text, zone)
            return ir.Const(sp, T.TIMESTAMPTZ)
        if e.typename == "timetz":
            return ir.Const(self._timetz_raw(e.text), T.TIMETZ)
        if e.typename == "interval":
            txt = e.text.strip()
            unit = e.qualifier
            if unit is not None:
                txt = f"{txt} {unit}"
            try:
                raw = T.parse_interval_text(txt)
            except ValueError as ex:
                raise BindError(str(ex))
            return ir.Const(raw, T.INTERVAL)
        raise BindError(f"typed literal {e.typename}")

    # interval units in months / in micros (reference: interval.cpp)
    _IV_MONTHS = {"month": 1, "mon": 1, "year": 12, "quarter": 3,
                  "decade": 120, "century": 1200, "millennium": 12000}
    _IV_US = {"microsecond": 1, "us": 1, "millisecond": 1_000,
              "ms": 1_000, "second": 1_000_000, "minute": 60_000_000,
              "hour": 3_600_000_000, "day": 86_400_000_000,
              "week": 7 * 86_400_000_000}

    def _bind_arith(self, op: str, l: ir.Expr, r: ir.Expr) -> ir.Expr:
        if op in ("&", "|", "<<", ">>"):
            # BIT operands get bitstring semantics, integers bitwise
            # (reference: core_functions/scalar/operators/bitwise.cpp +
            # common/types/bit.cpp)
            if self._is_bit(l) or self._is_bit(r):
                if op in ("<<", ">>"):
                    return self._bit_shift(op, l, r)
                return self._bit_binop(op, l, r)
            return ir.bind_arith(op, l, r)
        if op in ("+", "-") and l.dtype.id == TypeId.INTERVAL \
                and r.dtype.id == TypeId.INTERVAL:
            # interval +/- interval: the month/micros packing
            # (types.py interval_pack) is linear, so raw int64
            # addition is exact even for calendar intervals
            return ir.bind_arith(op, l, r)
        # temporal +/- interval (reference: Interval::Add,
        # src/common/types/interval.cpp).  Month-units run through the
        # device add_months kernel (calendar math with end-of-month
        # clamping); day/time units are micro-/day-count adds.
        for a, bso in ((l, r), (r, l)):
            if getattr(bso, "dtype", None) == T.INTERVAL \
                    and isinstance(bso, ir.Const) \
                    and not (op == "-" and bso is l):
                other = a
                tid = other.dtype.id
                sign = 1 if op == "+" else -1
                months, us = T.interval_unpack(int(bso.value))
                months *= sign
                us *= sign
                if months and tid not in (TypeId.TIME, TypeId.TIMETZ):
                    # apply the calendar-month component first
                    # (reference: Interval::Add adds months, then
                    # days/micros)
                    if isinstance(other, ir.Const) \
                            and tid == TypeId.DATE and not us:
                        return ir.Const(
                            add_months_host(other.value, months), T.DATE)
                    if tid == TypeId.DATE:
                        f = ir.Func("add_months_days", [other], T.DATE)
                        f.extra = months
                        other = f
                    elif tid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ):
                        f = ir.Func("add_months_us", [other],
                                    other.dtype)
                        f.extra = months
                        other = f
                    else:
                        raise BindError(
                            f"cannot add month interval to "
                            f"{other.dtype}")
                    if not us:
                        return other
                if not us:
                    return other
                if tid == TypeId.DATE:
                    if us % 86_400_000_000 == 0:
                        return ir.bind_arith(
                            "+", other,
                            ir.Const(us // 86_400_000_000, T.INTEGER))
                    # sub-day interval promotes DATE to TIMESTAMP
                    other = ir.Cast(other, T.TIMESTAMP, src=T.DATE)
                    tid = TypeId.TIMESTAMP
                if tid == TypeId.TIME:
                    # TIME arithmetic wraps around midnight
                    # (reference: Interval::Add on dtime_t)
                    day = 86_400_000_000
                    add = ir.Arith("+", other,
                                   ir.Const(us % day, T.INTERVAL),
                                   T.TIME)
                    return ir.Arith("%", add, ir.Const(day, T.BIGINT),
                                    T.TIME)
                if tid in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ,
                           TypeId.INTERVAL):
                    return ir.Arith("+", other,
                                    ir.Const(us, T.INTERVAL),
                                    other.dtype)
                raise BindError(
                    f"cannot add interval to {other.dtype}")
        if op == "//" and (l.dtype.id in (TypeId.DECIMAL, TypeId.FLOAT,
                                          TypeId.DOUBLE)
                           or r.dtype.id in (TypeId.DECIMAL, TypeId.FLOAT,
                                             TypeId.DOUBLE)):
            # reference: // over non-integers is plain division
            return ir.bind_arith("//", ir.promote(l, T.DOUBLE),
                                 ir.promote(r, T.DOUBLE))
        # integer constant folding (IN (2000, 2000+1, ...), LIMIT n*2, ...)
        # runtime (non-constant) INTERVAL +/- temporal: unpack the
        # packed months/micros on device (reference: Interval::Add)
        for a, bso in ((l, r), (r, l)):
            if getattr(bso, "dtype", None) == T.INTERVAL \
                    and not isinstance(bso, ir.Const) \
                    and getattr(a, "dtype", None) is not None \
                    and a.dtype.id in (TypeId.DATE, TypeId.TIMESTAMP,
                                       TypeId.TIMESTAMPTZ) \
                    and op in ("+", "-") \
                    and not (op == "-" and bso is l):
                ts = ir.Cast(a, T.TIMESTAMP, src=T.DATE) \
                    if a.dtype.id == TypeId.DATE else a
                iv = bso
                half = ir.Const(1 << 51, T.BIGINT)
                monthc = ir.Const(T.INTERVAL_MONTH, T.BIGINT)
                months = ir.Arith(
                    "//", ir.Arith("+", iv, half, T.BIGINT), monthc,
                    T.BIGINT)
                # python-style floor divide matches interval_unpack;
                # our // truncates toward zero, so adjust negatives
                biased = ir.Arith("+", iv, half, T.BIGINT)
                months = ir.Func("floordiv_pow52", [biased], T.BIGINT)
                us = ir.Arith("-", iv,
                              ir.Arith("*", months, monthc, T.BIGINT),
                              T.BIGINT)
                if op == "-":
                    z = ir.Const(0, T.BIGINT)
                    months = ir.Arith("-", z, months, T.BIGINT)
                    us = ir.Arith("-", z, us, T.BIGINT)
                shifted = ir.Func("add_months_dyn_us", [ts, months],
                                  ts.dtype if ts.dtype.id
                                  != TypeId.DATE else T.TIMESTAMP)
                return ir.Arith("+", shifted, us, shifted.dtype)
        if op in ("+", "-", "*") and isinstance(l, ir.Const) \
                and isinstance(r, ir.Const) \
                and l.value is not None and r.value is not None \
                and l.dtype.is_integer and r.dtype.is_integer:
            a, b2 = int(l.value), int(r.value)
            v = a + b2 if op == "+" else (a - b2 if op == "-" else a * b2)
            out = ir.bind_arith(op, l, r)
            return ir.Const(v, out.dtype)
        return ir.bind_arith(op, l, r)

    def _bind_comparison(self, op, la, ra, scope, agg_ctx, group_map,
                         sub_replacements, win_ctx=None) -> ir.Expr:
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements, win_ctx)
        l = b(la)
        r = b(ra)
        lt, rt = l.dtype, r.dtype
        # VARCHAR literal vs typed (date/numeric) column: implicit cast of
        # the literal (reference: cast_rules.cpp — VARCHAR casts to anything)
        if lt.id == TypeId.VARCHAR and rt.id != TypeId.VARCHAR \
                and isinstance(l, ir.Const):
            l = self._const_varchar_as(l, rt)
        elif rt.id == TypeId.VARCHAR and lt.id != TypeId.VARCHAR \
                and isinstance(r, ir.Const):
            r = self._const_varchar_as(r, lt)
        lt, rt = l.dtype, r.dtype
        if lt.id == TypeId.VARCHAR or rt.id == TypeId.VARCHAR:
            return self._bind_string_comparison(op, l, r)
        return ir.bind_comparison(op, l, r)

    def _const_varchar_as(self, c: ir.Const, tgt: T.DataType) -> ir.Expr:
        """Reinterpret a VARCHAR constant as tgt's type (date '1998-01-01',
        numeric '42', ...)."""
        import decimal as _dec
        text = self._const_text(c)
        try:
            if tgt.id in (TypeId.DATE, TypeId.TIMESTAMP, TypeId.TIME):
                return ir.Const(T.encode_literal(text, tgt), tgt)
            if tgt.id == TypeId.TIMESTAMPTZ:
                from .. import tz as tzmod
                sp = T.temporal_special(text, tgt)
                raw = sp if sp is not None else tzmod.parse_timestamptz(
                    text, self._session_tz())
                return ir.Const(raw, tgt)
            if tgt.id == TypeId.DECIMAL:
                return ir.Const(T.encode_literal(_dec.Decimal(text), tgt),
                                tgt)
            if tgt.is_integer:
                return ir.Const(int(text), tgt)
            if tgt.id in (TypeId.FLOAT, TypeId.DOUBLE):
                return ir.Const(float(text), tgt)
            if tgt.id == TypeId.BOOLEAN:
                low = text.strip().lower()
                if low in ("true", "t", "yes", "y", "1"):
                    return ir.Const(True, tgt)
                if low in ("false", "f", "no", "n", "0"):
                    return ir.Const(False, tgt)
                raise ValueError(text)
        except (ValueError, _dec.InvalidOperation):
            raise BindError(
                f"cannot cast literal {text!r} to {tgt!r}")
        return c

    def _bind_string_comparison(self, op, l: ir.Expr, r: ir.Expr):
        if getattr(l, "collate_fold", None) is None \
                and getattr(r, "collate_fold", None) is None:
            # column-level collation folds BOTH comparison sides
            # (reference: PushCollation on bound comparisons); the
            # default_collation setting applies when no explicit
            # collation is in play
            coll = self._column_collation(l) or self._column_collation(r)
            if not coll and self.context is not None:
                coll = str(self.context.config.get(
                    "default_collation") or "") or None
                if coll is not None:
                    # setting-dependent bind: never cache the plan
                    self.uncacheable = True
            if coll:
                l = self._bind_collate(l, coll)
                r = self._bind_collate(r, coll)
        lf = getattr(l, "collate_fold", None)
        rf = getattr(r, "collate_fold", None)
        if lf is not None and rf is None:
            # one explicitly-collated side folds the other (reference:
            # collation propagates across the comparison)
            r = self._collate_with_fold(r, lf)
        elif rf is not None and lf is None:
            l = self._collate_with_fold(l, rf)
        ld = getattr(l, "strdict", None)
        rd = getattr(r, "strdict", None)
        # constant side?  a collated column folds the literal into the
        # same sort-key domain (reference: collation propagates to the
        # comparison's other side, bound_comparison collation push)
        if isinstance(r, ir.Const) and rd is not None and ld is not None:
            s = rd.decode_one(r.value) if r.value is not None else None
            fold = getattr(l, "collate_fold", None)
            if fold is not None and s is not None:
                s = fold(s)
            return self._string_vs_const(op, l, ld, s)
        if isinstance(l, ir.Const) and ld is not None and rd is not None:
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                    "==": "==", "!=": "!="}
            s = ld.decode_one(l.value) if l.value is not None else None
            fold = getattr(r, "collate_fold", None)
            if fold is not None and s is not None:
                s = fold(s)
            return self._string_vs_const(flip[op], r, rd, s)
        # column vs column
        if ld is rd:
            return ir.Cmp(op, l, r)
        md, ltab, rtab = StringDictionary.merge(ld, rd)
        return ir.Cmp(op, ir.DictLookup(l, ltab, T.INTEGER, "dict_align"),
                      ir.DictLookup(r, rtab, T.INTEGER, "dict_align"))

    def _string_vs_const(self, op, col: ir.Expr, sd: StringDictionary,
                         s: Optional[str]):
        if s is None:
            return ir.Const(None, T.BOOLEAN)
        code_eq = sd.code_of(s)
        if op == "==":
            if code_eq < 0:
                return ir.BoolOp("and", (
                    ir.Const(False, T.BOOLEAN),
                    ir.IsNull(col, negated=True)))
            return ir.Cmp("==", col, ir.Const(code_eq, T.INTEGER))
        if op == "!=":
            if code_eq < 0:
                return ir.IsNull(col, negated=True) \
                    if False else ir.Cmp(">=", col,
                                         ir.Const(0, T.INTEGER))
            return ir.Cmp("!=", col, ir.Const(code_eq, T.INTEGER))
        if op == "<":
            return ir.Cmp("<", col, ir.Const(sd.lower_bound(s), T.INTEGER))
        if op == "<=":
            return ir.Cmp("<", col, ir.Const(sd.upper_bound(s), T.INTEGER))
        if op == ">":
            return ir.Cmp(">=", col, ir.Const(sd.upper_bound(s), T.INTEGER))
        if op == ">=":
            return ir.Cmp(">=", col, ir.Const(sd.lower_bound(s), T.INTEGER))
        raise BindError(op)

    def _bind_like(self, e: A.ELike, scope, agg_ctx, group_map,
                   sub_replacements):
        col = self.bind_expr(e.child, scope, agg_ctx, group_map,
                             sub_replacements)
        if col.dtype.id != TypeId.VARCHAR:
            raise BindError("LIKE requires VARCHAR")
        pat = self.bind_expr(e.pattern, scope)
        if not isinstance(pat, ir.Const):
            raise BindError("LIKE pattern must be constant")
        pd = getattr(pat, "strdict", None)
        pattern = pd.decode_one(pat.value)
        sd = getattr(col, "strdict", None)
        table = sd.match_like(pattern)
        out = ir.DictLookup(col, table, T.BOOLEAN, f"like:{pattern}")
        return ir.Not(out) if e.negated else out

    def _unify_string_exprs(self, exprs):
        """Rewrite VARCHAR expressions from different dictionaries into a
        shared merged dictionary (CASE/COALESCE over mixed strings)."""
        dicts = [getattr(x, "strdict", None) for x in exprs]
        uniq = {id(d): d for d in dicts if d is not None}
        if len(uniq) <= 1:
            sd = next(iter(uniq.values()), None)
            return exprs, sd
        merged = StringDictionary(np.unique(np.concatenate(
            [d.values for d in uniq.values()])))
        out = []
        for x, d in zip(exprs, dicts):
            if d is None:
                out.append(x)
                continue
            if isinstance(x, ir.Const):
                if x.value is None:
                    nc = ir.Const(None, T.VARCHAR)
                else:
                    nc = ir.Const(merged.code_of(d.decode_one(x.value)),
                                  T.VARCHAR)
                nc.strdict = merged
                out.append(nc)
            else:
                dl = ir.DictLookup(x, d.translate_to(merged), T.VARCHAR,
                                   "dict_unify")
                dl.strdict = merged
                out.append(dl)
        return out, merged

    def _bind_case(self, e: A.ECase, scope, agg_ctx, group_map,
                   sub_replacements):
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements)
        whens = []
        for c, v in e.whens:
            if e.operand is not None:
                c = A.EBinary("==", e.operand, c)
            whens.append((b(c), v))
        vals = [b(v) for _, v in whens] if False else None
        bvs = [b(v) for (_, v) in e.whens]
        belse = b(e.else_) if e.else_ is not None else None
        # common result type
        ts = [v.dtype for v in bvs] + ([belse.dtype] if belse else [])
        ct = ts[0]
        for t2 in ts[1:]:
            ct = ir.common_type(ct, t2)
        if ct.id == TypeId.DECIMAL:
            s = max((t.scale for t in ts if t.id == TypeId.DECIMAL),
                    default=0)
            ct = T.DECIMAL(18, s)
            bvs = [ir.promote(ir._as_decimal(v) if v.dtype.is_integer
                              or v.dtype.id == TypeId.DECIMAL else v, ct)
                   for v in bvs]
            if belse is not None:
                belse = ir.promote(ir._as_decimal(belse)
                                   if belse.dtype.is_integer
                                   or belse.dtype.id == TypeId.DECIMAL
                                   else belse, ct)
        elif ct.id == TypeId.VARCHAR:
            allv = bvs + ([belse] if belse is not None else [])
            allv, merged = self._unify_string_exprs(allv)
            if belse is not None:
                bvs, belse = allv[:-1], allv[-1]
            else:
                bvs = allv
            if belse is None:
                belse = ir.Const(None, ct)
            wpairs = [(w[0], v) for w, v in zip(whens, bvs)]
            out = ir.Case(wpairs, belse, ct)
            out.strdict = merged if merged is not None else \
                next((getattr(v, "strdict", None) for v in bvs
                      if getattr(v, "strdict", None) is not None), None)
            return out
        else:
            bvs = [ir.promote(v, ct) for v in bvs]
            if belse is not None:
                belse = ir.promote(belse, ct)
        if belse is None:
            belse = ir.Const(None, ct)
        wpairs = [(w[0], v) for w, v in zip(whens, bvs)]
        out = ir.Case(wpairs, belse, ct)
        sd = next((getattr(v, "strdict", None) for v in bvs
                   if getattr(v, "strdict", None) is not None), None)
        if sd is not None:
            out.strdict = sd
        return out

    # ---- TIMESTAMPTZ (reference: LogicalType::TIMESTAMP_TZ,
    # src/include/duckdb/common/types.hpp:185-234 + extension/icu/) ----
    def _session_tz(self) -> str:
        if self.context is not None:
            return str(self.context.config.get("timezone") or "UTC")
        return "UTC"

    def _tz_shift_expr(self, e: ir.Expr, to_wall: bool,
                       dtype: DataType, zone: str = None) -> ir.Expr:
        """instant<->wall conversion as a device tz_shift lookup over
        bind-time TZif transition tables (no host callback on the hot
        path; reference: ICU ops in extension/icu/icu-timezone.cpp)."""
        from .. import tz as tzmod
        if zone is None:
            zone = self._session_tz()
            # plan depends on the TimeZone setting -> don't cache
            self.uncacheable = True
        trans, offs = tzmod.zone_table(zone)
        if len(offs) == 1 and int(offs[0]) == 0:
            return ir.Cast(e, dtype)     # UTC: identity physical
        if to_wall:
            bounds, delta = trans, offs
        else:
            bounds, delta = trans + offs, -offs
        out = ir.Func("tz_shift", [e], dtype)
        out.extra = (bounds, delta)
        return out

    def _tz_wall(self, e: ir.Expr) -> ir.Expr:
        """TIMESTAMPTZ -> session wall clock as naive TIMESTAMP; other
        types pass through (used by temporal extraction functions)."""
        if e.dtype.id == TypeId.TIMESTAMPTZ:
            return self._tz_shift_expr(e, True, T.TIMESTAMP)
        return e

    def _bind_tz_cast(self, c: ir.Expr, tgt: DataType, try_: bool):
        """Casts with a TIMESTAMPTZ endpoint; returns None if the pair
        is not tz-related (falls through to the generic cast)."""
        sid = c.dtype.id
        if tgt.id == TypeId.TIMESTAMPTZ:
            if sid == TypeId.TIMESTAMPTZ:
                return c
            if sid == TypeId.VARCHAR:
                return self._cast_varchar_to_tstz(c, try_)
            if sid == TypeId.DATE:
                c = ir.Cast(c, T.TIMESTAMP, src=T.DATE)
                sid = TypeId.TIMESTAMP
            if sid == TypeId.TIMESTAMP:
                return self._tz_shift_expr(c, False, T.TIMESTAMPTZ)
            return None
        if sid == TypeId.TIMESTAMPTZ:
            if tgt.id == TypeId.TIMETZ:
                # wall clock in the session zone, carrying its offset
                wall = self._tz_shift_expr(c, True, T.TIMESTAMP)
                out = ir.Func("timetz_from_tz", [wall, c], T.TIMETZ)
                return out
            if tgt.id == TypeId.TIMESTAMP:
                return self._tz_shift_expr(c, True, T.TIMESTAMP)
            if tgt.id in (TypeId.DATE, TypeId.TIME):
                wall = self._tz_shift_expr(c, True, T.TIMESTAMP)
                if tgt.id == TypeId.DATE:
                    return ir.Func("ts_date", [wall], T.DATE)
                return ir.Func("ts_time", [wall], T.TIME)
            if tgt.id == TypeId.VARCHAR:
                if isinstance(c, ir.Const):
                    from .. import tz as tzmod
                    if c.value is None:
                        return ir.Const(None, T.VARCHAR)
                    text = tzmod.render_timestamptz(
                        int(c.value), self._session_tz())
                    sd, codes, _ = StringDictionary.encode([text])
                    out = ir.Const(int(codes[0]), T.VARCHAR)
                    out.strdict = sd
                    return out
                return None
            return None
        return None

    def _cast_varchar_to_tstz(self, c: ir.Expr, try_: bool) -> ir.Expr:
        """VARCHAR -> TIMESTAMPTZ: explicit offsets win, otherwise the
        session TimeZone interprets the wall clock (per-dictionary-code
        bind-time parse, one device gather)."""
        from .. import tz as tzmod
        zone = self._session_tz()
        self.uncacheable = True
        if isinstance(c, ir.Const) and getattr(c, "strdict", None) \
                is not None:
            text = c.strdict.decode_one(c.value)
            try:
                sp = T.temporal_special(text, T.TIMESTAMPTZ)
                raw = sp if sp is not None else \
                    tzmod.parse_timestamptz(text, zone)
            except (ValueError, OverflowError):
                if try_:
                    return ir.Const(None, T.TIMESTAMPTZ)
                raise ConversionError(
                    f"Could not convert string '{text}' to "
                    f"TIMESTAMP WITH TIME ZONE")
            return ir.Const(raw, T.TIMESTAMPTZ)
        sd = getattr(c, "strdict", None)
        if sd is None:
            raise BindError("cast from varchar requires a dictionary")
        n = len(sd.values)
        out = np.zeros(n, dtype=np.int64)
        bad = np.zeros(n, dtype=bool)
        first_bad = None
        for i in range(n):
            text = str(sd.values[i]).strip()
            try:
                sp = T.temporal_special(text, T.TIMESTAMPTZ)
                out[i] = sp if sp is not None else \
                    tzmod.parse_timestamptz(text, zone)
            except (ValueError, OverflowError):
                bad[i] = True
                if first_bad is None and text != "":
                    first_bad = text
        if first_bad is not None and not try_:
            raise ConversionError(
                f"Could not convert string '{first_bad}' to "
                f"TIMESTAMP WITH TIME ZONE")
        return ir.DictLookup(c, out, T.TIMESTAMPTZ, "str_cast",
                             null_table=bad if bad.any() else None)

    def _bind_cast(self, c: ir.Expr, typename: str, w: int, s: int,
                   try_: bool = False):
        # constant-fold casts of string literals (CAST('1998-09-02' AS date))
        if isinstance(c, ir.Const) and c.dtype.id == TypeId.VARCHAR \
                and getattr(c, "strdict", None) is not None:
            text = c.strdict.decode_one(c.value)
            tgt = {"date": T.DATE, "timestamp": T.TIMESTAMP,
                   "timetz": T.TIMETZ, "time": T.TIME}.get(typename)
            if typename in ("decimal", "numeric"):
                tgt = T.DECIMAL(w or 18, s)
            elif typename in ("int", "integer", "bigint", "smallint",
                              "tinyint", "int4", "int8"):
                tgt = T.BIGINT if typename in ("bigint", "int8") \
                    else T.INTEGER
            elif typename in ("double", "float8", "real", "float"):
                tgt = T.DOUBLE
            if tgt is not None:
                try:
                    raw = self._timetz_raw(text.strip()) \
                        if tgt.id == TypeId.TIMETZ \
                        else _parse_text(text.strip(), tgt)
                except (ValueError, decimal.InvalidOperation,
                        OverflowError):
                    if try_:
                        return ir.Const(None, tgt)
                    raise ConversionError(
                        f"Could not convert string '{text}' to {tgt}")
                return ir.Const(raw, tgt)
        if typename in ("bit", "bitstring"):
            if w or s:
                raise BindError(
                    "Parser Error: Type BIT does not support any "
                    "modifiers!")
            return self._bind_bit_cast(c, try_)
        if typename in ("decimal", "numeric"):
            tgt = T.DECIMAL(w or 18, s)
        elif self.catalog is not None \
                and typename.lower() in getattr(self.catalog, "enums",
                                                {}):
            # cast to a user ENUM type: VARCHAR physical + domain
            # check, tagged so enum_*() can recover the type
            values = self.catalog.enums[typename.lower()]
            if isinstance(c, ir.Const):
                if c.value is None:
                    out = ir.Const(None, T.VARCHAR)
                else:
                    txt = self._const_text(c)
                    if txt not in values:
                        raise ConversionError(
                            f"Could not convert string '{txt}' to "
                            f"{typename}")
                    sd2, codes2, _ = StringDictionary.encode([txt])
                    out = ir.Const(int(codes2[0]), T.VARCHAR)
                    out.strdict = sd2
                out.enum_type = typename.lower()
                return out
            out = c
            if c.dtype.id != TypeId.VARCHAR:
                out = self._cast_to_varchar(c)
            out.enum_type = typename.lower()
            return out
        else:
            tgt = resolve_typename(typename, w, s)
        if tgt.id == TypeId.BLOB and c.dtype.id == TypeId.VARCHAR:
            return self._bind_blob_from_text(c)
        if (tgt.is_numeric or tgt.id == TypeId.BOOLEAN) \
                and self._is_bit(c):
            return self._bit_to_numeric(c, tgt, try_)
        if tgt.id == TypeId.TIMESTAMPTZ \
                or c.dtype.id == TypeId.TIMESTAMPTZ:
            out = self._bind_tz_cast(c, tgt, try_)
            if out is not None:
                return out
        if isinstance(c, ir.Const) and c.value is None:
            # typed NULL: keep it a constant (VALUES (NULL::INTEGER),
            # COALESCE folding, reference: BoundConstantExpression)
            return ir.Const(None, tgt)
        if isinstance(c, ir.Const):
            # constant TIMETZ packing/unpacking folds
            if c.dtype.id == TypeId.TIME and tgt.id == TypeId.TIMETZ:
                return ir.Const(T.timetz_pack(int(c.value), 0), tgt)
            if c.dtype.id == TypeId.TIMETZ and tgt.id == TypeId.TIME:
                wall, _ = T.timetz_unpack(int(c.value))
                return ir.Const(wall % 86_400_000_000, tgt)
            if c.dtype.id == TypeId.TIMESTAMP \
                    and tgt.id == TypeId.TIMETZ:
                return ir.Const(T.timetz_pack(
                    int(c.value) % 86_400_000_000, 0), tgt)
        if isinstance(c, ir.Const) \
                and c.dtype.id in (TypeId.TINYINT, TypeId.SMALLINT,
                                   TypeId.INTEGER, TypeId.BIGINT,
                                   TypeId.DECIMAL, TypeId.FLOAT,
                                   TypeId.DOUBLE, TypeId.BOOLEAN) \
                and tgt.id in (TypeId.TINYINT, TypeId.SMALLINT,
                               TypeId.INTEGER, TypeId.BIGINT,
                               TypeId.HUGEINT, TypeId.DECIMAL,
                               TypeId.FLOAT, TypeId.DOUBLE,
                               TypeId.BOOLEAN):
            # constant numeric casts fold (VALUES rows stay constant;
            # reference folds via BoundCastExpression on constants)
            import decimal as _dec
            try:
                v = T.decode_value(c.value, c.dtype)
                if tgt.is_integer and isinstance(
                        v, (_dec.Decimal, float)):
                    # floats round half-to-even (std::nearbyint),
                    # decimals half away from zero (reference:
                    # NumericTryCast vs decimal casts)
                    mode = _dec.ROUND_HALF_EVEN \
                        if c.dtype.id in (TypeId.FLOAT,
                                          TypeId.DOUBLE) \
                        else _dec.ROUND_HALF_UP
                    v = int(_dec.Decimal(str(v)).to_integral_value(
                        rounding=mode))
                if tgt.id == TypeId.BOOLEAN:
                    v = bool(v)
                lim = {TypeId.TINYINT: 127, TypeId.SMALLINT: 32767,
                       TypeId.INTEGER: 2**31 - 1,
                       TypeId.BIGINT: 2**63 - 1,
                       TypeId.HUGEINT: 2**127 - 1}.get(tgt.id)
                if lim is not None and isinstance(v, int) \
                        and not -lim - 1 <= v <= lim:
                    raise OverflowError(v)
                if tgt.id == TypeId.FLOAT and isinstance(
                        v, (int, float)) and abs(float(v)) > \
                        3.4028235677937994e38:
                    # double -> float out of range errors (reference:
                    # NumericTryCast double->float)
                    raise OverflowError(v)
                return ir.Const(T.encode_literal(v, tgt), tgt)
            except (ValueError, OverflowError,
                    _dec.InvalidOperation):
                if try_:
                    return ir.Const(None, tgt)
                raise ConversionError(
                    f"Could not convert {c.value} to {tgt!r}")
        if tgt.id == TypeId.VARCHAR:
            return self._cast_to_varchar(c)
        if c.dtype.id == TypeId.VARCHAR:
            if tgt.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP):
                return self._cast_text_nested(c, tgt, try_)
            return self._cast_from_varchar(c, tgt, try_)
        return ir.Cast(c, tgt)

    def _session_timetz_offset(self) -> int:
        """UTC offset (seconds) of the session TimeZone at the current
        instant — offset-less TIMETZ strings attach it (reference: ICU
        VARCHAR -> TIMETZ cast under SET TimeZone)."""
        zone = self._session_tz()
        if zone in (None, "UTC"):
            return 0
        try:
            import time as _time
            from .. import tz as tzmod
            return int(tzmod.offset_at(int(_time.time() * 1e6), zone)
                       // 1_000_000)
        except Exception:
            return 0

    def _timetz_raw(self, text: str) -> int:
        try:
            wall, off = T.parse_time_text(text)
        except ValueError:
            return T.parse_timetz_text(text)   # timestamp-string form
        if off is None:
            off = self._session_timetz_offset()
        return T.timetz_pack(wall, off)

    def _cast_from_varchar(self, c: ir.Expr, tgt: DataType,
                           try_: bool) -> ir.Expr:
        """VARCHAR -> typed cast as a bind-time per-code parse table
        (reference: string casts, src/common/operator/cast_operators.cpp;
        our dictionary encoding makes the cast one device gather).  CAST
        raises ConversionError if any non-empty dictionary entry is
        unparsable; TRY_CAST maps those codes to NULL."""
        sd = getattr(c, "strdict", None)
        if sd is None:
            raise BindError("cast from varchar requires a dictionary")
        n = len(sd.values)
        out = np.zeros(n, dtype=tgt.np_dtype)
        bad = np.zeros(n, dtype=bool)
        first_bad = None
        for i in range(n):
            text = str(sd.values[i]).strip()
            try:
                out[i] = self._timetz_raw(text) \
                    if tgt.id == TypeId.TIMETZ else _parse_text(text, tgt)
            except (ValueError, decimal.InvalidOperation, OverflowError):
                bad[i] = True
                # '' may be the placeholder for NULL rows; never a strict
                # error (NULL rows stay NULL via the row null mask)
                if first_bad is None and text != "":
                    first_bad = text
        if first_bad is not None and not try_:
            raise ConversionError(
                f"Could not convert string '{first_bad}' to {tgt}")
        return ir.DictLookup(c, out, tgt, "str_cast",
                             null_table=bad if bad.any() else None)

    # largest enumerable value domain for a bind-time stringify table
    _STRINGIFY_SPAN = 1 << 20

    def _cast_to_varchar(self, c: ir.Expr) -> ir.Expr:
        """Typed -> VARCHAR cast.  TPU-native design: the result column
        needs a dictionary, so the input's value domain must be
        bind-time enumerable — constants fold, and bounded columns
        (zone-map interval analysis, plan/bounds.py) get a stringify
        table covering [lo, hi].  Unbounded doubles/timestamps are
        unsupported (reference stringifies row-at-a-time,
        src/common/operator/string_cast.cpp — no dictionary there)."""
        t = c.dtype
        if t.id == TypeId.VARCHAR:
            return c
        if isinstance(c, ir.Const):
            if c.value is None:
                out = ir.Const(None, T.VARCHAR)
                return out
            text = _host_stringify(c.value, t, getattr(c, "strdict", None))
            sd, codes, _ = StringDictionary.encode([text])
            out = ir.Const(int(codes[0]), T.VARCHAR)
            out.strdict = sd
            return out
        if t.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP) \
                and getattr(c, "strdict", None) is not None:
            # nested -> VARCHAR: per-store-id render table (reference:
            # Vector::ToString over nested vectors)
            store = c.strdict
            outs = [T.stringify_value(i, t, store)
                    for i in range(len(store))]
            return self._string_table(c, outs, "nested_str")
        if t.id == TypeId.BOOLEAN:
            tab = np.array([0, 1], dtype=np.int32)
            dl = ir.DictLookup(ir.Cast(c, T.INTEGER), tab, T.VARCHAR,
                               "stringify")
            dl.strdict = StringDictionary(
                np.array(["false", "true"]))
            return dl
        b = None
        plan = getattr(self, "_plan_for_bounds", None)
        if plan is not None and (t.is_integer or t.id in (
                TypeId.DECIMAL, TypeId.DATE)):
            from ..plan import bounds as PB
            try:
                b = PB.expr_bounds(c, PB.node_bounds(plan))
            except Exception:
                b = None
        if b is None and t.id in (TypeId.TIME, TypeId.TIMETZ,
                                  TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ,
                                  TypeId.INTERVAL, TypeId.DATE):
            # unbounded temporal columns stringify at EXECUTION time:
            # a host callback formats the batch's actual values and
            # fills a runtime output dictionary (same runtime-store
            # seam as aggregate outputs)
            out_sd = StringDictionary(np.array([], dtype=object))
            out_sd.runtime = True
            out = ir.Func("__stringify__", [c], T.VARCHAR)
            out.extra = (t, getattr(c, "strdict", None), out_sd)
            out.strdict = out_sd
            self.uncacheable = True
            return out
        if b is None:
            raise BindError(
                f"cast {t} to varchar needs a bounded value domain "
                "(supported: constants, bounded int/decimal/date columns)")
        lo, hi = int(b[0]), int(b[1])
        if hi - lo + 1 > self._STRINGIFY_SPAN:
            raise BindError(
                f"cast {t} to varchar: value span {hi - lo + 1} exceeds "
                f"the {self._STRINGIFY_SPAN} stringify-table limit")
        raw = np.arange(lo, hi + 1, dtype=np.int64)
        if t.is_integer:
            strs = raw.astype(str)
        elif t.id == TypeId.DATE:
            strs = np.datetime_as_string(
                raw.astype("datetime64[D]"), unit="D")
        else:
            strs = np.array([_host_stringify(v, t, None) for v in raw])
        uniq, inv = np.unique(strs.astype(str), return_inverse=True)
        dl = ir.DictLookup(c, inv.astype(np.int32), T.VARCHAR,
                           "stringify", base=lo)
        dl.strdict = StringDictionary(uniq)
        return dl

    def _bind_func(self, e: A.EFunc, scope, agg_ctx, group_map,
                   sub_replacements) -> ir.Expr:
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements)
        name = e.name
        if name in FUNC_ALIASES:
            import dataclasses as _dc
            name = FUNC_ALIASES[name]
            e = _dc.replace(e, name=name)
        if name in _TZ_WALL_FUNCS:
            # calendar extraction on TIMESTAMPTZ happens in the session
            # TimeZone (reference: ICU date-part overloads,
            # extension/icu/icu-datefunc.cpp) — shift the instant to
            # session wall clock, then reuse the naive kernels
            raw_b = b
            b = lambda x: self._tz_wall(raw_b(x))
        if name in AGG_FUNCS or (name == "count" and e.star) \
                or name in (getattr(self.context, "_agg_udfs", None)
                            or {}):
            if agg_ctx is None:
                raise BindError(f"aggregate {name} not allowed here")
            return self._bind_agg_func(e, scope, agg_ctx, group_map,
                                       sub_replacements)
        if name == "unnest":
            raise BindError("UNNEST is only supported as a top-level "
                            "SELECT item or table function")
        if name in ("grouping", "grouping_id"):
            # resolved after grouping-set expansion (reference:
            # GROUPING() over the grouping-set mask, bind_group_by)
            if group_map is None:
                raise BindError("grouping() requires GROUP BY")
            gasts, _ = group_map
            idxs = []
            for arg in e.args:
                for i, g in enumerate(gasts):
                    if _ast_equal(arg, g):
                        idxs.append(i)
                        break
                else:
                    raise BindError(
                        "grouping() argument must be a GROUP BY column")
            return GroupingRef(tuple(idxs))
        if name == "icu_sort_key" and len(e.args) == 2:
            # sort key under a named collator (reference:
            # extension/icu/icu_collate.cpp ICUCollateFunction) — ours
            # returns the fold used as the collation's sort domain
            a0 = b(e.args[0])
            a1 = b(e.args[1])
            if not isinstance(a1, ir.Const):
                raise BindError("icu_sort_key collator must be "
                                "constant")
            coll = self._const_text(a1).lower()
            base = coll[4:] if coll.startswith("icu_") else coll
            if base in _LOCALE_COLLATIONS:
                fold = _LOCALE_COLLATIONS[base]
            elif base in ("noaccent", "nocase"):
                import unicodedata
                if base == "noaccent":
                    fold = lambda s: "".join(
                        ch for ch in unicodedata.normalize("NFD", s)
                        if not unicodedata.combining(ch))
                else:
                    fold = str.lower
            else:
                raise InvalidInputError(
                    f"Invalid Input Error: unknown collator '{coll}'")
            if isinstance(a0, ir.Const):
                if a0.value is None:
                    return ir.Const(None, T.VARCHAR)
                return self._bind_literal(fold(self._const_text(a0)))
            sd0 = getattr(a0, "strdict", None)
            if sd0 is None:
                raise BindError("icu_sort_key requires VARCHAR")
            return self._string_table(
                a0, [fold(str(v)) for v in sd0.values], "icu_sort_key")
        if name == "xor" and len(e.args) == 2:
            a0, a1 = b(e.args[0]), b(e.args[1])
            if self._is_bit(a0) or self._is_bit(a1):
                return self._bit_binop("xor", a0, a1)
            return ir.bind_arith("xor", a0, a1)
        if name in ("get_bit", "set_bit", "bit_position", "bitstring") \
                or (name in ("bit_count", "bit_length", "octet_length")
                    and e.args
                    and self._is_bit(b(e.args[0]))):
            return self._bind_bit_func(name, e, scope, agg_ctx,
                                       group_map, sub_replacements)
        if name in ("list_first", "list_last") and len(e.args) == 1:
            # first/last element (reference: core_functions list_first/
            # list_last rewrite to list_extract)
            import dataclasses as _dc
            idx = 1 if name == "list_first" else -1
            e = _dc.replace(e, name="list_extract",
                            args=[e.args[0], A.ELit(idx)])
            name = "list_extract"
        if name in ("string_split", "str_split", "string_to_array",
                    "split"):
            return self._bind_string_split(e, scope, agg_ctx, group_map,
                                           sub_replacements)
        if name in ("nextval", "currval"):
            # sequence access evaluates at bind time (single-row usage:
            # INSERT VALUES / scalar SELECT; reference: nextval scalar,
            # src/function/scalar/sequence/)
            if self.context is None:
                raise BindError(f"{name} needs a connection")
            arg = e.args[0]
            if not isinstance(arg, A.ELit):
                raise BindError(f"{name} requires a constant name")
            self.uncacheable = True
            if name == "nextval":
                v = self.context.catalog.sequence_next(str(arg.value))
                # durable counters: crash must not replay old values
                # (reference: WriteSequenceValue WAL record)
                wal = getattr(self.context, "_wal_log", None)
                if wal is not None:
                    wal({"op": "sequence_value",
                         "name": str(arg.value).lower(), "value": int(v)})
            else:
                v = self.context.catalog.sequence_current(str(arg.value))
            return ir.Const(int(v), T.BIGINT)
        if name == "random":
            self.uncacheable = True
            seed = 0
            if self.context is not None:
                import random as _random
                if not hasattr(self.context, "_rand"):
                    self.context._rand = _random.Random()
                seed = self.context._rand.getrandbits(62)
            out = ir.Func("random", [], T.DOUBLE)
            out.extra = seed
            return out
        if name == "setseed":
            if self.context is not None and isinstance(e.args[0],
                                                       A.ELit):
                import random as _random
                self.context._rand = _random.Random(
                    float(e.args[0].value))
            self.uncacheable = True
            return ir.Const(None, T.DOUBLE)
        if name == "union_value":
            # union_value(tag := expr): single-member union constant
            # (reference: union_value scalar, union_type.cpp)
            from ..storage.nested import UnionStore
            tag = e.args[0].value
            bound = b(e.args[1])
            if not isinstance(bound, ir.Const):
                raise BindError("union_value requires a constant")
            store = UnionStore([str(tag)],
                               [(0, self._const_py(bound))])
            out = ir.Const(0, T.UNION([(str(tag), bound.dtype)]))
            out.strdict = store
            return out
        if name == "union_tag":
            u = b(e.args[0])
            if u.dtype.id != TypeId.UNION:
                raise BindError("union_tag needs a UNION value")
            store = getattr(u, "strdict", None)
            vals = [store.tag_of(i) for i in range(len(store))]
            return self._payload_expr(u, vals, T.VARCHAR, "union_tag")
        if name == "union_extract":
            u = b(e.args[0])
            if u.dtype.id != TypeId.UNION:
                raise BindError("union_extract needs a UNION value")
            member = e.args[1].value if isinstance(e.args[1], A.ELit) \
                else str(e.args[1])
            return self._union_extract(u, member)
        if name in ("struct_extract", "element_at", "map_extract",
                    "map_keys", "map_values", "map_contains",
                    "list_extract", "list_element", "array_extract"):
            return self._bind_nested_func(name, e, scope, agg_ctx,
                                          group_map, sub_replacements)
        if name in ("list_transform", "array_transform", "list_apply",
                    "array_apply", "apply", "list_filter",
                    "array_filter", "filter", "list_reduce", "reduce"):
            return self._bind_list_lambda(name, e, scope, agg_ctx,
                                          group_map, sub_replacements)
        if name in ("array_length", "list_length", "len", "length",
                    "cardinality", "list_contains", "array_contains",
                    "list_has", "contains", "list_sort", "array_sort",
                    "list_reverse_sort", "list_reverse", "array_reverse",
                    "list_distinct", "list_unique", "flatten",
                    "list_sum", "list_min", "list_max", "list_avg",
                    "list_median", "list_slice", "array_slice",
                    "array_to_string", "list_position", "list_indexof",
                    "array_position"):
            a = b(e.args[0])
            if a.dtype.id == TypeId.LIST:
                return self._bind_list_func(name, a, e, scope, agg_ctx,
                                            group_map, sub_replacements)
            if a.dtype.id == TypeId.MAP and name in ("cardinality",
                                                     "len", "length"):
                store = getattr(a, "strdict", None)
                if store is None:
                    raise BindError("map argument has no store")
                if getattr(store, "runtime", False):
                    return ir.DictLookup(
                        a, lambda: (store.lengths(), None), T.BIGINT,
                        "map_length")
                return ir.DictLookup(a, store.lengths(), T.BIGINT,
                                     "map_length")
            # fall through to the string/aliased handlers below
        if name in ("year", "month", "day"):
            a = b(e.args[0])
            if a.dtype.id == TypeId.TIMESTAMP:
                a = ir.Func("ts_date", [a], T.DATE)
            return ir.Func(name, [a], T.BIGINT)
        if name in ("minute", "hour", "second", "millisecond",
                    "microsecond"):
            a = b(e.args[0])
            return ir.Func(f"ts_{name}", [a], T.BIGINT)
        if name == "date_part":
            part = e.args[0]
            if not isinstance(part, A.ELit):
                raise BindError("date_part needs constant part")
            a = b(e.args[1])
            return ir.Func(part.value.lower(), [a], T.BIGINT)
        if name in ("abs",):
            a = b(e.args[0])
            return ir.Func(name, [a], a.dtype)
        if name == "bit_count":
            # integer popcount on the two's-complement pattern
            # (reference: bit_count scalar, core_functions/scalar/
            # operators/bitwise.cpp; BIT inputs dispatch earlier)
            a = b(e.args[0])
            if not a.dtype.is_integer:
                raise BindError("bit_count requires an integer or BIT "
                                "argument")
            return ir.Func("bit_count", [a], T.BIGINT)
        if name in ("floor", "ceil", "sqrt"):
            a = b(e.args[0])
            a = ir.promote(a, T.DOUBLE)
            return ir.Func(name, [a], T.DOUBLE)
        if name == "round":
            a = b(e.args[0])
            digits = 0
            if len(e.args) > 1:
                d2 = b(e.args[1])
                digits = d2.value
            if a.dtype.id == TypeId.DECIMAL:
                return ir.Cast(a, T.DECIMAL(18, digits))
            f = ir.Func("round", [ir.promote(a, T.DOUBLE)], T.DOUBLE)
            f.extra = digits
            return f
        if name == "coalesce":
            args = [b(a) for a in e.args]
            ct = args[0].dtype
            for a in args[1:]:
                ct = ir.common_type(ct, a.dtype)
            if ct.id == TypeId.VARCHAR:
                args, merged = self._unify_string_exprs(args)
                out = ir.Func("coalesce", args, ct)
                out.strdict = merged if merged is not None else \
                    next((getattr(a, "strdict", None) for a in args
                          if getattr(a, "strdict", None) is not None),
                         None)
                return out
            args = [ir.promote(a, ct) for a in args]
            out = ir.Func("coalesce", args, ct)
            sd = next((getattr(a, "strdict", None) for a in args
                       if getattr(a, "strdict", None) is not None), None)
            if sd is not None:
                out.strdict = sd
            return out
        if name in ("ln", "log", "log2", "log10", "exp", "sin", "cos",
                    "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
                    "radians", "degrees", "cbrt", "acosh", "asinh",
                    "atanh", "cot", "gamma", "lgamma", "trunc", "even"):
            if name == "log" and len(e.args) == 2:
                # log(base, x) = ln(x)/ln(base)
                base = ir.promote(b(e.args[0]), T.DOUBLE)
                x = ir.promote(b(e.args[1]), T.DOUBLE)
                return ir.Arith("/", ir.Func("ln", [x], T.DOUBLE),
                                ir.Func("ln", [base], T.DOUBLE),
                                T.DOUBLE)
            a = ir.promote(b(e.args[0]), T.DOUBLE)
            return ir.Func(name, [a], T.DOUBLE)
        if name in ("isnan", "isinf", "isfinite", "signbit"):
            a = ir.promote(b(e.args[0]), T.DOUBLE)
            return ir.Func(name, [a], T.BOOLEAN)
        if name in ("atan2", "nextafter"):
            a = ir.promote(b(e.args[0]), T.DOUBLE)
            a2 = ir.promote(b(e.args[1]), T.DOUBLE)
            return ir.Func(name, [a, a2], T.DOUBLE)
        if name in ("gcd", "lcm"):
            a = ir.promote(b(e.args[0]), T.BIGINT)
            a2 = ir.promote(b(e.args[1]), T.BIGINT)
            return ir.Func(name, [a, a2], T.BIGINT)
        if name == "factorial":
            a = ir.promote(b(e.args[0]), T.BIGINT)
            return ir.Func(name, [a], T.BIGINT)
        if name == "pi" and not e.args:
            import math as _math
            return ir.Const(_math.pi, T.DOUBLE)
        if name == "to_timestamp":
            a = ir.promote(b(e.args[0]), T.DOUBLE)
            return ir.Func(name, [a], T.TIMESTAMP)
        if name in ("epoch_us", "epoch_ns", "epoch_ms") \
                and len(e.args) == 1:
            a = b(e.args[0])
            if a.dtype.id not in (TypeId.DATE, TypeId.TIMESTAMP,
                                  TypeId.TIME, TypeId.INTERVAL):
                raise BindError(f"{name} requires a temporal argument")
            out = ir.Func("epoch_raw", [a], T.BIGINT)
            out.extra = name
            return out
        if name == "make_date" and len(e.args) == 3:
            args = [ir.promote(b(a), T.BIGINT) for a in e.args]
            return ir.Func(name, args, T.DATE)
        if name == "make_time" and len(e.args) == 3:
            args = [ir.promote(b(e.args[0]), T.BIGINT),
                    ir.promote(b(e.args[1]), T.BIGINT),
                    ir.promote(b(e.args[2]), T.DOUBLE)]
            return ir.Func(name, args, T.TIME)
        if name in ("make_timestamp", "make_timestamp_ns") \
                and len(e.args) in (1, 6):
            if len(e.args) == 1:
                a = ir.promote(b(e.args[0]), T.BIGINT)
                if name == "make_timestamp_ns":
                    a = ir.Arith("//", a, ir.Const(1000, T.BIGINT),
                                 T.BIGINT)
                return ir.Func("make_timestamp", [a], T.TIMESTAMP)
            args = [ir.promote(b(a), T.BIGINT) for a in e.args[:5]] \
                + [ir.promote(b(e.args[5]), T.DOUBLE)]
            return ir.Func("make_timestamp", args, T.TIMESTAMP)
        if name == "time_bucket" and len(e.args) >= 2:
            w = b(e.args[0])
            ts = b(e.args[1])
            if not isinstance(w, ir.Const) or w.dtype.id != \
                    TypeId.INTERVAL:
                raise BindError("time_bucket requires a constant "
                                "INTERVAL width")
            _UNIT_US = {"microsecond": 1, "millisecond": 1000,
                        "second": 1_000_000, "minute": 60_000_000,
                        "hour": 3_600_000_000, "day": 86_400_000_000,
                        "week": 7 * 86_400_000_000}
            _m, _us = T.interval_unpack(int(w.value))
            if _m:
                raise BindError("time_bucket month widths not supported")
            width = _us
            if width <= 0:
                raise BindError("time_bucket width must be positive")
            # reference origins (core_functions/scalar/date/time_bucket):
            # 2000-01-03 (Monday) for whole-week widths, 2000-01-01 else
            _DAY = 86_400_000_000
            if width % (7 * _DAY) == 0:
                origin = 10959 * _DAY        # 2000-01-03
            else:
                origin = 10957 * _DAY        # 2000-01-01
            was_date = ts.dtype.id == TypeId.DATE
            if was_date:
                ts = ir.Cast(ts, T.TIMESTAMP)
            out = ir.Func("time_bucket", [ts], T.TIMESTAMP)
            out.extra = (width, origin)
            return ir.Func("ts_date", [out], T.DATE) if was_date else out
        if name == "sign":
            a = b(e.args[0])
            return ir.Func(name, [ir.promote(a, T.DOUBLE)], T.DOUBLE)
        if name in ("pow", "power"):
            return ir.Func("pow", [b(e.args[0]), b(e.args[1])], T.DOUBLE)
        if name in ("least", "greatest"):
            args = [b(a) for a in e.args]
            ct = args[0].dtype
            for a in args[1:]:
                ct = ir.common_type(ct, a.dtype)
            if ct.id == TypeId.VARCHAR:
                args, merged = self._unify_string_exprs(args)
                out = ir.Func(name, args, ct)
                out.strdict = merged if merged is not None else \
                    getattr(args[0], "strdict", None)
                return out
            args = [ir.promote(a, ct) for a in args]
            return ir.Func(name, args, ct)
        if name == "nullif":
            a = b(e.args[0])
            a2 = b(e.args[1])
            out = ir.Func("nullif", [a, a2], a.dtype)
            sd = getattr(a, "strdict", None)
            if sd is not None:
                out.strdict = sd
            return out
        if name == "ifnull":
            a = b(e.args[0])
            a2 = b(e.args[1])
            ct = ir.common_type(a.dtype, a2.dtype)
            return ir.Func("ifnull", [ir.promote(a, ct),
                                      ir.promote(a2, ct)], ct)
        if name == "date_trunc":
            part = e.args[0]
            if not isinstance(part, A.ELit):
                raise BindError("date_trunc needs a constant part")
            d = b(e.args[1])
            p = part.value.lower()
            is_ts = d.dtype.id == TypeId.TIMESTAMP
            if p in ("second", "minute", "hour"):
                if not is_ts:
                    return d   # truncating a DATE below day = identity
                us = {"second": 1_000_000, "minute": 60_000_000,
                      "hour": 3_600_000_000}[p]
                out = ir.Func("ts_trunc", [d], T.TIMESTAMP)
                out.extra = us
                return out
            if p not in ("day", "week", "month", "year"):
                raise BindError(f"date_trunc part {p} unsupported")
            if is_ts:
                days = ir.Func("ts_date", [d], T.DATE)
            else:
                days = d
            if p == "day":
                out = days
            else:
                out = ir.Func(f"date_trunc_{p}", [days], T.DATE)
            if is_ts:
                out = ir.Cast(out, T.TIMESTAMP, src=T.DATE)
            return out
        if name in ("quarter", "dayofweek", "dow", "isodow", "dayofmonth",
                    "dayofyear", "doy", "week", "weekofyear", "isoyear",
                    "century", "decade", "millennium", "epoch",
                    "epoch_ms", "yearweek"):
            a = b(e.args[0])
            nm = {"dow": "dayofweek", "dayofmonth": "day",
                  "doy": "dayofyear", "weekofyear": "week"}.get(name, name)
            out = ir.Func(nm, [a], T.BIGINT)
            if nm == "epoch":      # duckdb: epoch() returns DOUBLE
                return ir.Cast(out, T.DOUBLE)
            return out
        if name == "last_day":
            a = b(e.args[0])
            return ir.Func("last_day", [a], T.DATE)
        if name == "strftime" and len(e.args) == 2:
            # strftime(temporal, fmt) / strftime(fmt, temporal)
            # (reference: strftime.cpp).  TPU-native design: VARCHAR
            # results need a bind-time dictionary, so the value domain
            # is enumerated from zone-map bounds (like CAST .. AS
            # VARCHAR); formats without time specifiers lower
            # timestamps to dates first.
            a0, a1 = b(e.args[0]), b(e.args[1])
            if a0.dtype.id == TypeId.VARCHAR:
                fmt_e, val = a0, a1
            else:
                val, fmt_e = a0, a1
            if not isinstance(fmt_e, ir.Const) \
                    or getattr(fmt_e, "strdict", None) is None:
                raise BindError("strftime format must be a constant")
            fmt = fmt_e.strdict.decode_one(fmt_e.value)
            has_time = any(spec in fmt for spec in
                           ("%H", "%I", "%M", "%S", "%f", "%g", "%p",
                            "%X", "%c", "%-H", "%-I", "%-M", "%-S"))
            if isinstance(val, ir.Const):
                text = None if val.value is None else _strftime_raw(
                    int(val.value), val.dtype, fmt)
                return self._bind_literal(text)
            if val.dtype.id in (TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ) \
                    and not has_time:
                val = ir.Func("ts_date", [self._tz_wall(val)], T.DATE)
            if val.dtype.id != TypeId.DATE:
                raise BindError(
                    "strftime with time specifiers needs a DATE-"
                    "reducible argument (timestamp domains are not "
                    "bind-time enumerable)")
            bnd = None
            plan = getattr(self, "_plan_for_bounds", None)
            if plan is not None:
                from ..plan import bounds as PB
                try:
                    bnd = PB.expr_bounds(val, PB.node_bounds(plan))
                except Exception:
                    bnd = None
            if bnd is None:
                raise BindError("strftime needs a bounded date domain")
            lo, hi = int(bnd[0]), int(bnd[1])
            if hi - lo + 1 > self._STRINGIFY_SPAN:
                raise BindError("strftime: date span too large")
            raw = np.arange(lo, hi + 1, dtype=np.int64)
            strs = np.array([_strftime_raw(int(d), T.DATE, fmt)
                             for d in raw])
            uniq, inv = np.unique(strs.astype(str), return_inverse=True)
            dl = ir.DictLookup(val, inv.astype(np.int32), T.VARCHAR,
                               "strftime", base=lo)
            dl.strdict = StringDictionary(uniq)
            return dl
        if name in ("monthname", "dayname"):
            a = b(e.args[0])
            if name == "monthname":
                names_ = ["January", "February", "March", "April", "May",
                          "June", "July", "August", "September",
                          "October", "November", "December"]
                idx = ir.Arith("-", ir.Func("month", [a], T.BIGINT),
                               ir.Const(1, T.BIGINT), T.BIGINT)
            else:
                names_ = ["Sunday", "Monday", "Tuesday", "Wednesday",
                          "Thursday", "Friday", "Saturday"]
                idx = ir.Func("dayofweek", [a], T.BIGINT)
            nd = StringDictionary(np.unique(np.asarray(names_,
                                                       dtype=object)))
            table = np.array([nd.code_of(n) for n in names_],
                             dtype=np.int32)
            out = ir.DictLookup(idx, table, T.VARCHAR, name)
            out.strdict = nd
            return out
        if name in ("concat", "concat_op", "concat_ws"):
            return self._bind_concat(e, scope, agg_ctx, group_map,
                                     sub_replacements)
        if name == "json_keys":
            return self._bind_json_keys(e, scope, agg_ctx, group_map,
                                        sub_replacements)
        if name in ("current_date", "current_timestamp",
                    "current_localtimestamp", "now"):
            if name == "now":
                name = "current_timestamp"
            # bind-time clock constants (reference: these are stable
            # within a transaction; ours are stable within a statement)
            import time as _time
            self.uncacheable = True
            now_us = int(_time.time() * 1_000_000)
            if name != "current_timestamp":
                from .. import tz as tzmod
                zone = "UTC"
                if self.context is not None:
                    zone = str(self.context.config.get("timezone")
                               or "UTC")
                try:
                    now_us = int(tzmod.utc_to_wall_np(
                        np.asarray([now_us], np.int64), zone)[0])
                except tzmod.UnknownTimeZone:
                    pass
            if name == "current_date":
                return ir.Const(now_us // 86_400_000_000, T.DATE)
            if name == "current_timestamp":
                # reference: now() returns TIMESTAMP WITH TIME ZONE
                return ir.Const(now_us, T.TIMESTAMPTZ)
            return ir.Const(now_us, T.TIMESTAMP)
        if name in ("timezone", "to_utc_timestamp", "from_utc_timestamp"):
            # tz conversions via bind-time TZif transition tables
            # (reference: extension/icu/icu-timezone.cpp; semantics with
            # our single naive-TIMESTAMP type follow PostgreSQL:
            # timezone(tz, ts) / ts AT TIME ZONE tz interprets ts as
            # wall clock in tz and returns the UTC instant;
            # from_utc_timestamp(ts, tz) is the inverse)
            from .. import tz as tzmod
            if len(e.args) != 2:
                raise BindError(f"{name} requires (tz, timestamp)")
            if name == "timezone":
                tz_ast, ts_ast = e.args
            else:
                ts_ast, tz_ast = e.args
            tzb = self.bind_expr(tz_ast, scope, agg_ctx, group_map,
                                 sub_replacements)
            if not isinstance(tzb, ir.Const):
                raise BindError(f"{name} requires a constant zone name")
            sd = getattr(tzb, "strdict", None)
            tzname = sd.decode_one(tzb.value) if sd is not None \
                else str(tzb.value)
            try:
                trans, offs = tzmod.zone_table(tzname)
            except tzmod.UnknownTimeZone as ex:
                raise BindError(str(ex))
            ts_e = self.bind_expr(ts_ast, scope, agg_ctx, group_map,
                                  sub_replacements)
            if ts_e.dtype.id == TypeId.DATE:
                ts_e = ir.Cast(ts_e, T.TIMESTAMP)
            if ts_e.dtype.id not in (TypeId.TIMESTAMP,
                                     TypeId.TIMESTAMPTZ):
                raise BindError(f"{name} requires a TIMESTAMP argument")
            if name == "timezone" \
                    and ts_e.dtype.id == TypeId.TIMESTAMPTZ:
                # TIMESTAMPTZ AT TIME ZONE tz -> wall clock in tz as
                # naive TIMESTAMP (reference: ICU timezone(tstz))
                bounds, delta, out_t = trans, offs, T.TIMESTAMP
            elif name == "timezone":
                # TIMESTAMP AT TIME ZONE tz: interpret as wall clock
                # in tz -> instant (reference returns TIMESTAMPTZ)
                bounds, delta, out_t = trans + offs, -offs, T.TIMESTAMPTZ
            elif name == "from_utc_timestamp":
                bounds, delta, out_t = trans, offs, T.TIMESTAMP
            else:
                bounds, delta, out_t = trans + offs, -offs, T.TIMESTAMP
            out = ir.Func("tz_shift", [ts_e], out_t)
            out.extra = (bounds, delta)
            return out
        if name == "typeof" and len(e.args) == 1:
            a = b(e.args[0])
            if self._is_bit(a):
                return self._bind_literal("BIT")
            et = getattr(a, "enum_type", None)
            if et is not None:
                return self._bind_literal(str(et))
            return self._bind_literal(repr(a.dtype))
        if name in ("current_database", "current_catalog") and not e.args:
            dbname = "memory"
            if self.context is not None:
                dbname = getattr(self.context, "db_alias", None) \
                    or "memory"
            return self._bind_literal(dbname)
        if name == "current_schema" and not e.args:
            return self._bind_literal("main")
        if name == "version" and not e.args:
            return self._bind_literal("v1.3.2-ddbtpu")
        if name == "current_setting" and len(e.args) == 1:
            a = b(e.args[0])
            if not isinstance(a, ir.Const):
                raise BindError("current_setting requires a constant")
            key = self._const_text(a)
            val = None
            if self.context is not None:
                try:
                    val = self.context.config.get(key)
                except Exception:
                    raise BindError(f"unrecognized setting {key}")
            return self._bind_literal(val)
        if name in ("txid_current", "current_transaction_id",
                    "current_query_id", "current_connection_id") \
                and not e.args:
            self.uncacheable = True
            v = 0
            if self.context is not None:
                v = int(getattr(self.context, "_stmt_counter", 0))
            return ir.Const(v, T.BIGINT)
        if name == "current_query" and not e.args:
            self.uncacheable = True
            q = getattr(self.context, "_current_query", "") \
                if self.context is not None else ""
            return self._bind_literal(q)
        if name == "can_cast_implicitly" and len(e.args) == 2:
            a = b(e.args[0])
            a2 = b(e.args[1])
            try:
                ct = ir.common_type(a.dtype, a2.dtype)
                ok = ct.id == a2.dtype.id
            except Exception:
                ok = False
            return ir.Const(bool(ok), T.BOOLEAN)
        if name in ("gen_random_uuid", "uuid", "uuidv4") and not e.args:
            import uuid as _uuid
            self.uncacheable = True
            return self._bind_literal(str(_uuid.uuid4()))
        if name == "uuidv7" and not e.args:
            import os as _os
            import time as _time
            import uuid as _uuid
            self.uncacheable = True
            ms = int(_time.time() * 1000)
            rand = int.from_bytes(_os.urandom(10), "big")
            v = (ms << 80) | (7 << 76) | ((rand >> 62) & 0xFFF) << 64 \
                | (2 << 62) | (rand & ((1 << 62) - 1))
            return self._bind_literal(str(_uuid.UUID(int=v)))
        if name == "error" and len(e.args) == 1:
            a = b(e.args[0])
            if isinstance(a, ir.Const):
                raise InvalidInputError(self._const_text(a))
            raise BindError("error() requires a constant message")
        # integer -> VARCHAR scalar functions ride the bounded-domain
        # stringify machinery (same constraint as int::VARCHAR casts)
        if name in _INT_STR_FUNCS and e.args:
            a0 = b(e.args[0])
            if a0.dtype.is_integer:
                extra = []
                for xa in e.args[1:]:
                    xb = b(xa)
                    if not isinstance(xb, ir.Const):
                        raise BindError(f"{name}: extra arguments must "
                                        "be constants")
                    extra.append(int(xb.value))
                fn = _INT_STR_FUNCS[name]
                return self._int_domain_func(
                    a0, lambda v: fn(int(v), *extra), name)
        if name in ("format", "printf") and e.args:
            # rewrite to concat over literal pieces + VARCHAR-cast args
            # (reference: fmt/printf scalar functions; our dictionary
            # string model concatenates per-code tables)
            import re as _re
            f0 = b(e.args[0])
            if not isinstance(f0, ir.Const):
                raise BindError(f"{name} format must be constant")
            fmt = self._const_text(f0)
            pat = r"\{[^{}]*\}" if name == "format" else \
                r"%[-+ #0-9.]*[sdifgxX%]"
            pieces = _re.split("(" + pat + ")", fmt)
            items: list = []
            ai = 1
            for p in pieces:
                if not p:
                    continue
                is_slot = bool(_re.fullmatch(pat, p))
                if is_slot and name == "printf" and p == "%%":
                    items.append(A.ELit("%"))
                    continue
                if is_slot:
                    if ai >= len(e.args):
                        raise BindError(f"{name}: not enough arguments")
                    items.append(A.ECast(e.args[ai], "varchar", 0, 0,
                                         False))
                    ai += 1
                else:
                    items.append(A.ELit(p.replace("{{", "{")
                                        .replace("}}", "}")))
            return self._bind_concat(
                A.EFunc("concat", items), scope, agg_ctx, group_map,
                sub_replacements)
        if name in ("string_split_regex", "regexp_extract_all",
                    "parse_path"):
            return self._bind_str_list_func(name, e, scope, agg_ctx,
                                            group_map, sub_replacements)
        if name in ("strptime", "try_strptime"):
            return self._bind_strptime(name, e, scope, agg_ctx,
                                       group_map, sub_replacements)
        # host-dictionary string functions
        if name in _STR_FUNCS:
            return self._bind_string_func(name, e, scope, agg_ctx,
                                          group_map, sub_replacements)
        if name == "map" and len(e.args) == 2:
            # MAP(keys_list, values_list) constructor (reference:
            # core_functions/scalar/map/map.cpp)
            from ..storage.nested import MapStore
            kb = self.bind_expr(e.args[0], scope, agg_ctx, group_map,
                                sub_replacements)
            vb = self.bind_expr(e.args[1], scope, agg_ctx, group_map,
                                sub_replacements)
            if isinstance(kb, ir.Const) and isinstance(vb, ir.Const) \
                    and kb.dtype.id == TypeId.LIST \
                    and vb.dtype.id == TypeId.LIST:
                ks = kb.strdict.decode_one(kb.value)
                vs = vb.strdict.decode_one(vb.value)
                if len(ks) != len(vs):
                    raise BindError("MAP key/value lists differ in size")
                out = ir.Const(0, T.MAP(kb.dtype.child or T.INTEGER,
                                        vb.dtype.child or T.INTEGER))
                out.strdict = MapStore([list(zip(ks, vs))])
                return out
            raise BindError("MAP() requires constant key/value lists")
        # SQL macros (reference: macro_catalog_entry / macro_function);
        # _BUILTIN_MACROS supplies reference functions that are pure
        # rewrites over existing primitives (the reference implements
        # several the same way, src/catalog/default/default_functions.cpp)
        mac = getattr(self.catalog, "macros", {}).get(name) \
            or _BUILTIN_MACROS.get(name)
        if mac is not None and not mac.get("is_table"):
            from . import parser as sqlparser
            depth = getattr(self, "_macro_depth", 0)
            if depth > 32:
                raise BindError(f"macro {name} expansion too deep "
                                "(recursive macro?)")
            params = mac["params"]
            if len(e.args) > len(params):
                raise BindError(f"macro {name} takes at most "
                                f"{len(params)} arguments")
            mapping = {p: a for p, a in zip(params, e.args)}
            for p in params[len(e.args):]:
                if p in mac["defaults"]:
                    mapping[p] = sqlparser.parse_expression(
                        mac["defaults"][p])
                else:
                    raise BindError(
                        f"macro {name} requires parameter {p}")
            expanded = _subst_ast(
                sqlparser.parse_expression(mac["body"]), mapping)
            self._macro_depth = depth + 1
            try:
                return self.bind_expr(expanded, scope, agg_ctx,
                                      group_map, sub_replacements)
            finally:
                self._macro_depth = depth
        # user-defined scalar functions (reference: Python client UDFs,
        # tools/pythonpkg create_function; ours run through
        # jax.pure_callback so they compose with the jitted pipeline)
        # ---- round-5 function-library breadth batch -----------------
        if name in _R5_BREADTH_FNS:
            out = self._bind_breadth_func(name, e, scope, agg_ctx,
                                          group_map, sub_replacements)
            if out is not None:
                return out
        udf = getattr(self.context, "_udfs", {}).get(name) \
            if self.context is not None else None
        if udf is not None:
            fn, ret_dtype = udf
            bargs = [self.bind_expr(a, scope, agg_ctx, group_map,
                                    sub_replacements) for a in e.args]
            out = ir.Func("__pyudf__", bargs, ret_dtype)
            if ret_dtype.id == TypeId.VARCHAR:
                # string results land in a runtime dictionary the
                # callback fills (same seam as __stringify__)
                out_sd = StringDictionary(np.array([], dtype=object))
                out_sd.runtime = True
                out.strdict = out_sd
                out.extra = (fn, [getattr(a, "strdict", None)
                                  for a in bargs], False, out_sd)
            else:
                out.extra = (fn, [getattr(a, "strdict", None)
                                  for a in bargs])
            self.uncacheable = True
            return out
        raise BindError(f"unknown function {name}")

    def _bind_breadth_func(self, name, e, scope, agg_ctx, group_map,
                           sub_replacements):
        """Round-5 library-tail functions (reference:
        extension/core_functions/scalar/{list,map,struct,date}/ +
        src/function/scalar/).  Returns None to fall through."""
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements)
        if name in ("enum_code", "enum_first", "enum_last",
                    "enum_range", "enum_range_boundary"):
            bargs0 = [self.bind_expr(a, scope, agg_ctx, group_map,
                                     sub_replacements) for a in e.args]
            etype = next((getattr(a, "enum_type", None)
                          for a in bargs0
                          if getattr(a, "enum_type", None)), None)
            if etype is None:
                # column over an enum-domained table column
                for a in bargs0:
                    if isinstance(a, ir.ColRef) \
                            and a.dtype.id == TypeId.VARCHAR:
                        for td in getattr(self.catalog, "tables",
                                          {}).values():
                            dom = getattr(td, "enum_domains",
                                          {}).get(a.name)
                            if dom is not None:
                                etype = dom[0].lower()
                                break
                    if etype is not None:
                        break
            if etype is None or etype not in getattr(
                    self.catalog, "enums", {}):
                raise BindError(f"{name} requires an ENUM-typed "
                                "argument")
            values = list(self.catalog.enums[etype])
            from ..storage.lists import ListStore
            if name == "enum_first":
                return self._bind_literal(values[0])
            if name == "enum_last":
                return self._bind_literal(values[-1])
            if name == "enum_range":
                out = ir.Const(0, T.LIST(T.VARCHAR))
                out.strdict = ListStore([values])
                return out
            if name == "enum_range_boundary":
                lo_c, hi_c = bargs0[0], bargs0[1]

                def bound(cst, default):
                    if isinstance(cst, ir.Const) and cst.value is None:
                        return default
                    txt = self._const_text(cst)
                    return values.index(txt)

                lo_i = bound(lo_c, 0)
                hi_i = bound(hi_c, len(values) - 1)
                out = ir.Const(0, T.LIST(T.VARCHAR))
                out.strdict = ListStore([values[lo_i:hi_i + 1]])
                return out
            # enum_code: ordinal within the enum declaration
            a0 = bargs0[0]
            sd = getattr(a0, "strdict", None)
            order = {v: i for i, v in enumerate(values)}
            if isinstance(a0, ir.Const):
                if a0.value is None:
                    return ir.Const(None, T.BIGINT)
                return ir.Const(order.get(self._const_text(a0), 0),
                                T.BIGINT)
            if sd is None:
                raise BindError("enum_code requires a dictionary")
            if getattr(sd, "runtime", False):
                def tbl():
                    t2 = np.array([order.get(str(v), 0)
                                   for v in sd.values], dtype=np.int64)
                    return t2, None
                return ir.DictLookup(a0, tbl, T.BIGINT, "enum_code")
            table = np.array([order.get(str(v), 0) for v in sd.values],
                             dtype=np.int64)
            return ir.DictLookup(a0, table, T.BIGINT, "enum_code")
        if name in ("encode", "decode"):
            a0 = self.bind_expr(e.args[0], scope, agg_ctx, group_map,
                                sub_replacements)
            sd = getattr(a0, "strdict", None)
            if sd is None:
                raise BindError(f"{name} requires a dictionary-backed "
                                "argument")
            from ..storage.nested import BlobStore
            if name == "encode":        # VARCHAR -> BLOB (utf8 bytes)
                out_store = BlobStore()
                out_store.runtime = True

                def fn(vals, nulls):
                    if nulls[0]:
                        return None
                    return out_store.add(
                        str(sd.decode_one(int(vals[0]))).encode("utf-8"))

                out = ir.Func("__pyudf__", [a0], T.BLOB)
                out.extra = (fn, [None], True)
                out.strdict = out_store
                self.uncacheable = True
                return out
            # decode: BLOB -> VARCHAR (errors on invalid utf8 like the
            # reference)
            out_sd = StringDictionary(np.array([], dtype=object))
            out_sd.runtime = True

            def fn(vals, nulls):
                if nulls[0]:
                    return None
                return sd.decode_one(int(vals[0])).decode("utf-8")

            out = ir.Func("__pyudf__", [a0], T.VARCHAR)
            out.extra = (fn, [None], True, out_sd)
            out.strdict = out_sd
            self.uncacheable = True
            return out
        if name == "getvariable":
            a0 = self.bind_expr(e.args[0], scope, agg_ctx, group_map,
                                sub_replacements)
            nm = str(self._const_text(a0)).lower() \
                if isinstance(a0, ir.Const) else None
            if nm is None:
                raise BindError("getvariable name must be constant")
            store = getattr(self.context, "_variables", {})
            if nm not in store:
                return ir.Const(None, T.VARCHAR)
            v, dt = store[nm]
            self.uncacheable = True
            return self._bind_literal(v) if dt.id == TypeId.VARCHAR \
                else ir.Const(T.encode_literal(v, dt), dt)
        if name in ("list_pack", "unpivot_list"):
            return b(A.EList(list(e.args)))
        if name in ("get_current_timestamp", "transaction_timestamp"):
            return b(A.EFunc("now", []))
        if name == "current_schemas":
            out = ir.Const(0, T.LIST(T.VARCHAR))
            from ..storage.lists import ListStore
            schemas = ["main", "temp"] + sorted(
                getattr(self.catalog, "schemas", ()))
            out.strdict = ListStore([list(dict.fromkeys(schemas))])
            return out
        if name == "in_search_path":
            args = [b(a) for a in e.args]
            sc = args[-1]
            txt = self._const_text(sc) if isinstance(sc, ir.Const) \
                else None
            return ir.Const(txt in ("main", "temp", None), T.BOOLEAN)
        if name in _TO_IV_MONTHS:
            a = ir.promote(b(e.args[0]), T.BIGINT)
            return ir.Arith("*", a,
                            ir.Const(_TO_IV_MONTHS[name]
                                     * T.INTERVAL_MONTH, T.BIGINT),
                            T.INTERVAL)
        if name in _TO_IV_US:
            a = ir.promote(b(e.args[0]), T.BIGINT)
            return ir.Arith("*", a, ir.Const(_TO_IV_US[name], T.BIGINT),
                            T.INTERVAL)
        if name == "age":
            args = [b(a) for a in e.args]
            if len(args) == 1:
                args = [args[0], b(A.EFunc("now", []))]
            a2, b2 = (ir.Cast(x, T.TIMESTAMP, src=x.dtype)
                      if x.dtype.id == TypeId.DATE else x
                      for x in args)
            m = ir.Func("months_between_us", [a2, b2], T.BIGINT)
            anchor = ir.Func("add_months_dyn_us", [b2, m], T.TIMESTAMP)
            us = ir.Arith("-", a2, anchor, T.BIGINT)
            packed = ir.Arith(
                "+", ir.Arith("*", m,
                              ir.Const(T.INTERVAL_MONTH, T.BIGINT),
                              T.BIGINT),
                us, T.INTERVAL)
            return packed
        if name in ("date_diff", "date_sub"):
            if len(e.args) != 3:
                raise BindError(f"{name} requires (part, start, end)")
            pc = b(e.args[0])
            if not isinstance(pc, ir.Const):
                raise BindError(f"{name} part must be constant")
            part = str(self._const_text(pc)).lower().rstrip("s")
            part = {"yr": "year", "mon": "month", "qtr": "quarter"}.get(
                part, part)
            a1, a2 = b(e.args[1]), b(e.args[2])

            def as_ts(x):
                if x.dtype.id == TypeId.DATE:
                    return ir.Cast(x, T.TIMESTAMP, src=T.DATE)
                return x

            t1, t2 = as_ts(a1), as_ts(a2)
            if name == "date_sub":
                # complete parts between start and end
                if part in _DD_MONTH_PARTS:
                    m = ir.Func("months_between_us", [t2, t1], T.BIGINT)
                    return ir.Arith(
                        "//", m,
                        ir.Const(_DD_MONTH_PARTS[part], T.BIGINT),
                        T.BIGINT)
                if part not in _DD_US_PARTS:
                    raise BindError(f"date_sub part {part}")
                diff = ir.Arith("-", t2, t1, T.BIGINT)
                return ir.Arith("//", diff,
                                ir.Const(_DD_US_PARTS[part], T.BIGINT),
                                T.BIGINT)
            # date_diff: partition boundaries crossed
            if part in _DD_MONTH_PARTS:
                k = _DD_MONTH_PARTS[part]

                def months_of(x):
                    y = ir.Func("year", [x], T.BIGINT)
                    mth = ir.Func("month", [x], T.BIGINT)
                    return ir.Arith(
                        "+", ir.Arith("*", y, ir.Const(12, T.BIGINT),
                                      T.BIGINT),
                        ir.Arith("-", mth, ir.Const(1, T.BIGINT),
                                 T.BIGINT), T.BIGINT)

                def da(x):
                    return ir.Func(
                        "ts_date", [x], T.DATE) \
                        if x.dtype.id != TypeId.DATE else x

                m1 = ir.Arith("//", months_of(da(t1)),
                              ir.Const(k, T.BIGINT), T.BIGINT)
                m2 = ir.Arith("//", months_of(da(t2)),
                              ir.Const(k, T.BIGINT), T.BIGINT)
                return ir.Arith("-", m2, m1, T.BIGINT)
            if part not in _DD_US_PARTS:
                raise BindError(f"date_diff part {part}")
            k = _DD_US_PARTS[part]

            def trunc(x):
                v = ir.Arith("//", x, ir.Const(k, T.BIGINT), T.BIGINT)
                return v

            return ir.Arith("-", trunc(t2), trunc(t1), T.BIGINT)

        # ---- host row-wise nested-store functions --------------------
        impl = _breadth_impl()
        bargs = [b(a) for a in e.args]

        def store_of(x):
            return getattr(x, "strdict", None)

        def rowfn(fn, ret_dtype, out_store=None):
            out = ir.Func("__pyudf__", bargs, ret_dtype)
            out.extra = (fn, [None] * len(bargs), True)
            if out_store is not None:
                out.strdict = out_store
            self.uncacheable = True
            return out

        from ..storage.lists import ListStore
        from ..storage.nested import MapStore, StructStore

        def dec(i):
            st = store_of(bargs[i])

            def get(vals, nulls):
                if nulls[i]:
                    return None
                return st.decode_one(int(vals[i]))
            return get

        if name == "list_zip":
            n_l = len(bargs)
            decs = [dec(i) for i in range(n_l)]
            out_store = ListStore()
            out_store.runtime = True

            def fn(vals, nulls):
                lists = [d(vals, nulls) for d in decs]
                return out_store.add(impl["zip_rows"](lists))

            et = T.STRUCT((f"list_{j + 1}",
                           bargs[j].dtype.child or T.INTEGER)
                          for j in range(n_l))
            return rowfn(fn, T.LIST(et), out_store)
        if name == "list_select":
            d0, d1 = dec(0), dec(1)
            out_store = ListStore()
            out_store.runtime = True

            def fn(vals, nulls):
                lst, idx = d0(vals, nulls), d1(vals, nulls)
                if lst is None or idx is None:
                    return None
                out = []
                for i in idx:
                    if i is None or not 1 <= int(i) <= len(lst):
                        raise ValueError(
                            "list_select index out of range")
                    out.append(lst[int(i) - 1])
                return out_store.add(out)

            return rowfn(fn, bargs[0].dtype, out_store)
        if name in ("list_has_all", "list_has_any"):
            d0, d1 = dec(0), dec(1)
            want_all = name == "list_has_all"

            def fn(vals, nulls):
                a, c = d0(vals, nulls), d1(vals, nulls)
                if a is None or c is None:
                    return None
                sa = {x for x in a if x is not None}
                sc = {x for x in c if x is not None}
                return sc <= sa if want_all else bool(sa & sc)

            return rowfn(fn, T.BOOLEAN)
        if name in ("list_distance", "list_cosine_similarity",
                    "list_cosine_distance", "list_dot_product",
                    "list_negative_dot_product"):
            kind = {"list_distance": "dist",
                    "list_cosine_similarity": "cos",
                    "list_cosine_distance": "cosd",
                    "list_dot_product": "dot",
                    "list_negative_dot_product": "ndot"}[name]
            d0, d1 = dec(0), dec(1)

            def fn(vals, nulls):
                return impl["dist"](d0(vals, nulls), d1(vals, nulls),
                                    kind)

            return rowfn(fn, T.DOUBLE)
        if name == "list_grade_up":
            d0 = dec(0)
            out_store = ListStore()
            out_store.runtime = True

            def fn(vals, nulls):
                lst = d0(vals, nulls)
                if lst is None:
                    return None
                keyed = sorted(
                    range(len(lst)),
                    key=lambda i: (lst[i] is None, lst[i]
                                   if lst[i] is not None else 0))
                return out_store.add([i + 1 for i in keyed])

            return rowfn(fn, T.LIST(T.BIGINT), out_store)
        if name == "list_resize":
            d0 = dec(0)
            out_store = ListStore()
            out_store.runtime = True
            fill_sd = store_of(bargs[2]) if len(bargs) > 2 else None

            def fn(vals, nulls):
                lst = d0(vals, nulls)
                if lst is None or nulls[1]:
                    return None
                n2 = int(vals[1])
                fill = None
                if len(bargs) > 2 and not nulls[2]:
                    fill = fill_sd.decode_one(int(vals[2])) \
                        if fill_sd is not None else vals[2].item() \
                        if hasattr(vals[2], "item") else vals[2]
                out = list(lst[:n2]) + [fill] * max(n2 - len(lst), 0)
                return out_store.add(out)

            return rowfn(fn, bargs[0].dtype, out_store)
        if name == "list_concat":
            decs = [dec(i) if bargs[i].dtype.id == TypeId.LIST else None
                    for i in range(len(bargs))]
            out_store = ListStore()
            out_store.runtime = True

            def fn(vals, nulls):
                out = []
                for i, d in enumerate(decs):
                    lst = d(vals, nulls) if d is not None else None
                    if lst:
                        out.extend(lst)
                return out_store.add(out)

            lt = next((a.dtype for a in bargs
                       if a.dtype.id == TypeId.LIST),
                      T.LIST(T.INTEGER))
            return rowfn(fn, lt, out_store)
        if name in ("list_aggregate", "list_aggr"):
            d0 = dec(0)
            how = self._const_text(bargs[1]) \
                if isinstance(bargs[1], ir.Const) else None
            if how is None:
                raise BindError("list_aggregate name must be constant")
            how_l = str(how).lower()

            def fn(vals, nulls):
                lst = d0(vals, nulls)
                if lst is None:
                    return None
                return impl["aggregate"](lst, how_l)

            rt = {"count": T.BIGINT, "sum": T.DOUBLE, "avg": T.DOUBLE,
                  "mean": T.DOUBLE, "string_agg": T.VARCHAR}.get(
                      how_l, T.DOUBLE)
            if rt.id == TypeId.VARCHAR:
                out_sd = StringDictionary(np.array([], dtype=object))
                out_sd.runtime = True
                out = ir.Func("__pyudf__", bargs, rt)
                out.extra = (fn, [None] * len(bargs), True, out_sd)
                out.strdict = out_sd
                self.uncacheable = True
                return out
            return rowfn(fn, rt)
        if name == "map_entries":
            d0 = dec(0)
            out_store = ListStore()
            out_store.runtime = True

            def fn(vals, nulls):
                m = d0(vals, nulls)
                if m is None:
                    return None
                items = m.items() if isinstance(m, dict) else m
                return out_store.add(
                    [{"key": k, "value": v} for k, v in items])

            kt = bargs[0].dtype.child or T.INTEGER
            vt = bargs[0].dtype.child2 or T.INTEGER
            return rowfn(fn, T.LIST(T.STRUCT(
                (("key", kt), ("value", vt)))), out_store)
        if name == "map_from_entries":
            d0 = dec(0)
            out_store = MapStore()
            out_store.runtime = True

            def fn(vals, nulls):
                lst = d0(vals, nulls)
                if lst is None:
                    return None
                pairs = []
                for x in lst:
                    if isinstance(x, dict):
                        vs = list(x.values())
                        pairs.append((vs[0], vs[1]))
                return out_store.add(pairs)

            et = bargs[0].dtype.child
            kt = vt = T.INTEGER
            if et is not None and et.children:
                kt = et.children[0][1]
                vt = et.children[1][1]
            return rowfn(fn, T.MAP(kt, vt), out_store)
        if name == "map_extract_value":
            d0 = dec(0)
            key_sd = store_of(bargs[1])

            def fn(vals, nulls):
                m = d0(vals, nulls)
                if m is None or nulls[1]:
                    return None
                k = key_sd.decode_one(int(vals[1])) \
                    if key_sd is not None else \
                    (vals[1].item() if hasattr(vals[1], "item")
                     else vals[1])
                items = m.items() if isinstance(m, dict) else m
                for kk, vv in items:
                    if kk == k:
                        return vv
                return None

            vt = bargs[0].dtype.child2 or T.INTEGER
            if vt.id == TypeId.VARCHAR:
                out_sd = StringDictionary(np.array([], dtype=object))
                out_sd.runtime = True
                out = ir.Func("__pyudf__", bargs, vt)
                out.extra = (fn, [None] * len(bargs), True, out_sd)
                out.strdict = out_sd
                self.uncacheable = True
                return out
            return rowfn(fn, vt)
        if name == "map_concat":
            decs = [dec(i) for i in range(len(bargs))]
            out_store = MapStore()
            out_store.runtime = True

            def fn(vals, nulls):
                merged = {}
                for d in decs:
                    m = d(vals, nulls)
                    if m:
                        items = m.items() if isinstance(m, dict) else m
                        for k, v in items:
                            merged[k] = v
                return out_store.add(list(merged.items()))

            return rowfn(fn, bargs[0].dtype, out_store)
        if name in ("struct_concat", "struct_insert"):
            decs = [dec(i) for i in range(len(bargs))]

            def names_types(dt):
                return list(dt.children or ())

            fields = []
            seen = set()
            for a in bargs:
                for fn_, ft in names_types(a.dtype):
                    if fn_ not in seen:
                        fields.append((fn_, ft))
                        seen.add(fn_)
                    else:
                        if name == "struct_insert":
                            raise BindError(
                                f"duplicate struct field {fn_}")
                        fields = [(n2, ft if n2 == fn_ else t2)
                                  for n2, t2 in fields]
            out_store = StructStore([f for f, _ in fields], [])
            out_store.runtime = True

            def fn(vals, nulls):
                merged = {}
                for d in decs:
                    st2 = d(vals, nulls)
                    if st2:
                        merged.update(st2)
                return out_store.add(
                    tuple(merged.get(f) for f, _ in fields))

            return rowfn(fn, T.STRUCT(fields), out_store)
        if name == "struct_extract_at":
            sidx = bargs[1]
            if not isinstance(sidx, ir.Const):
                raise BindError("struct_extract_at index must be "
                                "constant")
            children = list(bargs[0].dtype.children or ())
            i = int(sidx.value)
            if not 1 <= i <= len(children):
                raise BindError("struct_extract_at index out of range")
            return self._struct_extract(bargs[0], children[i - 1][0])
        if name == "bar":
            if len(bargs) < 3:
                raise BindError("bar requires (x, min, max[, width])")

            def fn(vals, nulls):
                if nulls[0] or nulls[1] or nulls[2]:
                    return None
                x, lo, hi = (float(vals[0]), float(vals[1]),
                             float(vals[2]))
                width = float(vals[3]) if len(vals) > 3 \
                    and not nulls[3] else 80.0
                frac = 0.0 if hi == lo else (x - lo) / (hi - lo)
                frac = min(max(frac, 0.0), 1.0)
                nfull = int(frac * width)
                return "\u2588" * nfull

            out_sd = StringDictionary(np.array([], dtype=object))
            out_sd.runtime = True
            out = ir.Func("__pyudf__", bargs, T.VARCHAR)
            out.extra = (fn, [None] * len(bargs), True, out_sd)
            out.strdict = out_sd
            self.uncacheable = True
            return out
        if name == "alias":
            a = bargs[0]
            nm = getattr(a, "name", None) or "expr"
            sd, codes, _ = StringDictionary.encode([str(nm)])
            out = ir.Const(int(codes[0]), T.VARCHAR)
            out.strdict = sd
            return out
        return None

    def _bind_window(self, e: A.EWindow, scope, win_ctx: WinCtx,
                     agg_ctx=None, group_map=None) -> WinRef:
        fn = e.func
        name = fn.name
        # with agg_ctx set (window over aggregate output) the window's
        # inner expressions bind with aggregate/group placeholders
        wb = lambda x: self.bind_expr(x, scope, agg_ctx, group_map)
        partition = [wb(p) for p in e.partition]
        order = []
        for it in e.order:
            oe = wb(it.expr)
            nl = it.nulls_last if it.nulls_last is not None \
                else self._default_nulls_last()
            order.append(L.OrderKey(oe, self._desc(it), nl))
        arg = None
        offset = 1
        if name in ("row_number", "rank", "dense_rank"):
            dtype = T.BIGINT
        elif name in ("percent_rank", "cume_dist"):
            dtype = T.DOUBLE
        elif name == "ntile":
            if not fn.args:
                raise BindError("ntile requires a bucket count")
            k = self.bind_expr(fn.args[0], scope)
            if not isinstance(k, ir.Const):
                raise BindError("ntile bucket count must be constant")
            offset = int(k.value)
            dtype = T.BIGINT
        elif name == "count" and (fn.star or not fn.args):
            name = "count_star"
            dtype = T.BIGINT
        else:
            if not fn.args:
                raise BindError(f"window {name} requires an argument")
            arg = wb(fn.args[0])
            if name in ("lag", "lead") and len(fn.args) > 1:
                off = self.bind_expr(fn.args[1], scope)
                if not isinstance(off, ir.Const):
                    raise BindError("lag/lead offset must be constant")
                offset = int(off.value)
            if name == "nth_value":
                if len(fn.args) < 2:
                    raise BindError("nth_value requires (expr, n)")
                nk = self.bind_expr(fn.args[1], scope)
                if not isinstance(nk, ir.Const):
                    raise BindError("nth_value n must be constant")
                offset = int(nk.value)
                if offset < 1:
                    raise BindError("nth_value n must be >= 1")
            if name == "count":
                dtype = T.BIGINT
            elif name == "sum":
                at = arg.dtype
                dtype = T.DECIMAL(18, at.scale) \
                    if at.id == TypeId.DECIMAL else (
                        T.HUGEINT if at.is_integer else T.DOUBLE)
            elif name == "avg":
                dtype = T.DOUBLE
            elif name in ("min", "max", "first_value", "last_value",
                          "lag", "lead", "nth_value"):
                dtype = arg.dtype
            else:
                raise BindError(f"window function {name} not supported")
        distinct = bool(getattr(fn, "distinct", False))
        if distinct and name not in ("count", "sum", "avg"):
            raise BindError(
                f"DISTINCT is not supported for window {name}")
        frame = self._parse_frame(e.frame, name)
        wf = L.WindowFn(name, arg, partition, order, dtype,
                        name, offset,
                        getattr(arg, "strdict", None)
                        if arg is not None else None, frame,
                        distinct=distinct)
        key = repr((name, repr(arg), [repr(p) for p in partition],
                    [(repr(k.expr), k.desc, k.nulls_last)
                     for k in order], offset, distinct, frame))
        idx = win_ctx.add(wf, key)
        return WinRef(idx, dtype, wf.strdict)

    def _parse_frame(self, text: Optional[str], fn_name: str):
        """Parse 'rows|range|groups between X and Y [exclude ...]' ->
        (kind, preceding, following, exclude); None component =
        unbounded.  Returns None for the dialect default (RANGE
        unbounded-preceding..current-row, EXCLUDE NO OTHERS).
        Reference: window frame binding in
        src/planner/binder/expression/bind_window_expression.cpp +
        WindowExcludeMode."""
        if not text:
            return None
        toks = text.lower().split()
        kind = toks[0]
        if kind not in ("rows", "range", "groups"):
            raise BindError(f"unsupported frame: {text}")
        body = " ".join(toks[1:])
        exclude = None
        if " exclude " in " " + body + " ":
            body, _, exc = body.partition(" exclude ")
            exc = exc.strip()
            if exc in ("current row", "group", "ties"):
                exclude = exc
            elif exc != "no others":
                raise BindError(f"unsupported EXCLUDE clause: {exc}")
            body = body.strip()
        if not body.startswith("between "):
            # shorthand: '<bound>' == 'BETWEEN <bound> AND CURRENT ROW'
            a, b2 = body, "current row"
        else:
            a, b2 = body[len("between "):].split(" and ")
        if kind == "range" and a.strip() == "unbounded preceding" \
                and b2.strip() == "current row" and exclude is None:
            return None          # the dialect default
        if fn_name not in ("sum", "avg", "count", "count_star",
                           "min", "max", "first_value", "last_value",
                           "nth_value"):
            raise BindError(f"{kind.upper()} frame unsupported for "
                            f"{fn_name}")

        def bound(s, is_start):
            s = s.strip()
            if s == "unbounded preceding":
                return None if is_start else 0
            if s == "unbounded following":
                return None
            if s == "current row":
                return 0
            n, k2 = s.split()
            n = float(n) if "." in n else int(n)
            if k2 == "preceding":
                return n if is_start else -n
            return -n if is_start else n   # following

        pre = bound(a, True)
        post = bound(b2, False)
        return (kind, pre, post, exclude)

    def _bind_agg_func(self, e: A.EFunc, scope, agg_ctx, group_map,
                       sub_replacements) -> AggRef:
        name = e.name
        if name == "count" and (e.star or not e.args):
            # COUNT() == COUNT(*) (reference: count with no argument
            # binds to count_star, src/function/aggregate/count.cpp)
            spec = L.AggSpec("count_star", None, T.BIGINT, "count_star")
            idx = agg_ctx.add(spec, "count_star()")
            return AggRef(idx, T.BIGINT)
        if not e.args:
            raise BindError(f"{name} requires an argument")
        # aggregate arguments bind over the raw input scope: group-expr
        # substitution must NOT apply inside an aggregate
        arg = self.bind_expr(e.args[0], scope, None, None,
                             sub_replacements)
        if name == "count":
            spec = L.AggSpec("count", arg, T.BIGINT, "count",
                             distinct=e.distinct)
            idx = agg_ctx.add(spec, f"count({_ekey(arg)},{e.distinct})")
            return AggRef(idx, T.BIGINT)
        if name == "sum":
            at = arg.dtype
            if at.id == TypeId.DECIMAL:
                # duckdb parity: SUM(DECIMAL) -> DECIMAL(38, s); wide values
                # carry a second limb column (batch.Column.hi)
                rt = T.DECIMAL(38, at.scale)
            elif at.is_integer:
                rt = T.HUGEINT
            else:
                rt = T.DOUBLE
            spec = L.AggSpec("sum", arg, rt, "sum", distinct=e.distinct)
            idx = agg_ctx.add(spec, f"sum({_ekey(arg)},{e.distinct})")
            return AggRef(idx, rt)
        if name == "avg":
            spec = L.AggSpec("avg", arg, T.DOUBLE, "avg",
                             distinct=e.distinct)
            idx = agg_ctx.add(spec, f"avg({_ekey(arg)},{e.distinct})")
            return AggRef(idx, T.DOUBLE)
        if name in ("min", "max"):
            spec = L.AggSpec(name, arg, arg.dtype, name)
            idx = agg_ctx.add(spec, f"{name}({_ekey(arg)})")
            return AggRef(idx, arg.dtype, getattr(arg, "strdict", None))
        if name == "mode":
            spec = L.AggSpec("mode", arg, arg.dtype, "mode")
            idx = agg_ctx.add(spec, f"mode({_ekey(arg)})")
            return AggRef(idx, arg.dtype, getattr(arg, "strdict", None))
        if name in ("arg_min", "arg_max", "argmin", "argmax", "min_by",
                    "max_by", "arg_min_null", "arg_max_null"):
            if len(e.args) != 2:
                raise BindError(f"{name} requires (arg, val)")
            by = self.bind_expr(e.args[1], scope, None, None,
                                sub_replacements)
            kind = "arg_max" if name in ("arg_max", "argmax", "max_by",
                                         "arg_max_null") \
                else "arg_min"
            spec = L.AggSpec(kind, arg, arg.dtype, kind, arg2=by)
            if name.endswith("_null"):
                # _null variants keep NULL payloads (reference:
                # ArgMinMaxNull in arg_min_max.cpp)
                spec.extra = "keep_null_payload"
            idx = agg_ctx.add(spec,
                              f"{kind}({_ekey(arg)},{_ekey(by)},"
                              f"{name.endswith('_null')})")
            return AggRef(idx, arg.dtype, getattr(arg, "strdict", None))
        if name in ("any_value", "first"):
            spec = L.AggSpec("any_value", arg, arg.dtype, "any_value")
            idx = agg_ctx.add(spec, f"any_value({_ekey(arg)})")
            return AggRef(idx, arg.dtype, getattr(arg, "strdict", None))
        if name == "last":
            spec = L.AggSpec("last", arg, arg.dtype, "last")
            idx = agg_ctx.add(spec, f"last({_ekey(arg)})")
            return AggRef(idx, arg.dtype, getattr(arg, "strdict", None))
        if name in ("bit_and", "bit_or", "bit_xor"):
            if arg.dtype.id == TypeId.NULL:
                arg = ir.Cast(arg, T.BIGINT)
            if not arg.dtype.is_integer:
                raise BindError(f"{name} requires an integer argument")
            spec = L.AggSpec(name, arg, arg.dtype, name,
                             distinct=e.distinct)
            idx = agg_ctx.add(spec, f"{name}({_ekey(arg)},{e.distinct})")
            return AggRef(idx, arg.dtype)
        if name == "entropy":
            spec = L.AggSpec("entropy", arg, T.DOUBLE, "entropy")
            idx = agg_ctx.add(spec, f"entropy({_ekey(arg)})")
            return AggRef(idx, T.DOUBLE)
        def _agg_order():
            """agg(x ORDER BY ...) keys bound in the input scope
            (reference: ORDER_MODIFIER on bound aggregates)."""
            if not getattr(e, "order", None):
                return None, ""
            out = []
            for it in e.order:
                oe = self.bind_expr(it.expr, scope, None, None,
                                    sub_replacements)
                nl = it.nulls_last if it.nulls_last is not None \
                    else self._default_nulls_last()
                out.append((oe, self._desc(it), nl))
            key = ";".join(f"{_ekey(oe)}:{d}:{nl}" for oe, d, nl in out)
            return out, key

        if name in ("list", "array_agg"):
            from ..storage.lists import ListStore
            store = ListStore()
            store.runtime = True
            rt = T.LIST(arg.dtype)
            order_b, okey = _agg_order()
            spec = L.AggSpec("collect", arg, rt, "list",
                             distinct=e.distinct, store=store,
                             order_by=order_b)
            idx = agg_ctx.add(spec,
                              f"list({_ekey(arg)},{e.distinct},{okey})")
            # dedup may return an existing spec — use ITS store so the
            # expr and the executed spec share one object
            return AggRef(idx, rt, agg_ctx.specs[idx].store)
        if name in ("histogram", "histogram_exact"):
            from ..storage.nested import MapStore
            store = MapStore()
            store.runtime = True
            rt = T.MAP(arg.dtype, T.BIGINT)
            spec = L.AggSpec("histogram", arg, rt, "histogram",
                             store=store)
            key = f"histogram({_ekey(arg)})"
            if len(e.args) == 2:
                # histogram(x, bin_boundaries) buckets into <= ranges
                # with an int64-max overflow bin; histogram_exact(x,
                # values) counts exact matches only (reference:
                # aggregate/holistic/histogram.cpp two-arg overloads)
                bins = self.bind_expr(e.args[1], scope, None, None,
                                      sub_replacements)
                bs = getattr(bins, "strdict", None)
                if not isinstance(bins, ir.Const) or bs is None:
                    raise BindError(
                        f"{name} bin boundaries must be a constant "
                        "list")
                blist = bs.decode_one(int(bins.value))
                spec.extra = ("exact" if name == "histogram_exact"
                              else "bins", list(blist))
                key = f"{name}({_ekey(arg)},{blist!r})"
            idx = agg_ctx.add(spec, key)
            return AggRef(idx, rt, agg_ctx.specs[idx].store)
        if name == "approx_top_k":
            from ..storage.lists import ListStore
            if len(e.args) != 2:
                raise BindError("approx_top_k requires (arg, k)")
            k = self.bind_expr(e.args[1], scope)
            if not isinstance(k, ir.Const):
                raise BindError("approx_top_k k must be constant")
            store = ListStore()
            store.runtime = True
            rt = T.LIST(arg.dtype)
            spec = L.AggSpec("approx_top_k", arg, rt, "approx_top_k",
                             store=store, extra=int(k.value))
            idx = agg_ctx.add(spec,
                              f"approx_top_k({_ekey(arg)},{k.value})")
            return AggRef(idx, rt, agg_ctx.specs[idx].store)
        if name in ("string_agg", "group_concat"):
            sep = ","
            if len(e.args) > 1:
                s2 = self.bind_expr(e.args[1], scope, None, None,
                                    sub_replacements)
                if not isinstance(s2, ir.Const):
                    raise BindError("string_agg separator must be constant")
                sd2 = getattr(s2, "strdict", None)
                sep = sd2.decode_one(s2.value) if sd2 is not None \
                    else str(s2.value)
            store = StringDictionary(np.array([], dtype=object))
            store.runtime = True
            order_b, okey = _agg_order()
            spec = L.AggSpec("string_agg", arg, T.VARCHAR, "string_agg",
                             distinct=e.distinct, store=store, extra=sep,
                             order_by=order_b)
            idx = agg_ctx.add(
                spec,
                f"string_agg({_ekey(arg)},{sep},{e.distinct},{okey})")
            return AggRef(idx, T.VARCHAR, agg_ctx.specs[idx].store)
        if name == "product":
            arg = self._agg_numeric(arg)
            spec = L.AggSpec("product", arg, T.DOUBLE, "product",
                             distinct=e.distinct)
            idx = agg_ctx.add(spec, f"product({_ekey(arg)},{e.distinct})")
            return AggRef(idx, T.DOUBLE)
        if name in ("stddev", "stddev_samp", "stddev_pop", "var_samp",
                    "var_pop", "variance"):
            kind = {"stddev": "stddev_samp", "variance": "var_samp"} \
                .get(name, name)
            arg = self._agg_numeric(arg)
            spec = L.AggSpec(kind, arg, T.DOUBLE, kind)
            idx = agg_ctx.add(spec, f"{kind}({_ekey(arg)})")
            return AggRef(idx, T.DOUBLE)
        if name in ("corr", "covar_pop", "covar_samp"):
            if len(e.args) != 2:
                raise BindError(f"{name} requires two arguments")
            arg = self._agg_numeric(arg)
            arg2 = self._agg_numeric(
                self.bind_expr(e.args[1], scope, None, None,
                               sub_replacements))
            spec = L.AggSpec(name, arg, T.DOUBLE, name, arg2=arg2)
            idx = agg_ctx.add(spec, f"{name}({_ekey(arg)},{_ekey(arg2)})")
            return AggRef(idx, T.DOUBLE)
        if name in ("median", "quantile_cont", "quantile_disc",
                    "quantile"):
            q = 0.5
            if name != "median":
                if len(e.args) < 2:
                    raise BindError(f"{name} requires a fraction")
                qe = self.bind_expr(e.args[1], scope)
                if not isinstance(qe, ir.Const):
                    raise BindError("quantile fraction must be constant")
                q = float(qe.value)
                if qe.dtype.id == TypeId.DECIMAL:
                    q /= T.decimal_scale_factor(qe.dtype.scale)
            interp = name in ("median", "quantile_cont") \
                and arg.dtype.id != TypeId.VARCHAR
            rt = T.DOUBLE if interp else arg.dtype
            kind = "quantile"
            spec = L.AggSpec(kind, arg, rt, name, quantile=q,
                             interpolate=interp)
            idx = agg_ctx.add(spec, f"quantile({_ekey(arg)},{q},{interp})")
            return AggRef(idx, rt, getattr(arg, "strdict", None)
                          if not interp else None)
        if name in ("bool_and", "bool_or"):
            spec = L.AggSpec("min" if name == "bool_and" else "max",
                             arg, T.BOOLEAN, name)
            idx = agg_ctx.add(spec, f"{name}({_ekey(arg)})")
            return AggRef(idx, T.BOOLEAN)
        if name == "mad":
            # median absolute deviation (reference:
            # core_functions/aggregate/holistic/mad.cpp); temporal
            # arguments yield an interval of micros
            arg2 = arg
            rt = T.DOUBLE
            if arg.dtype.is_temporal:
                rt = T.INTERVAL
            elif arg.dtype.id != TypeId.DOUBLE:
                arg2 = ir.promote(arg, T.DOUBLE)
            spec = L.AggSpec("mad", arg2, rt, name)
            idx = agg_ctx.add(spec, f"mad({_ekey(arg2)})")
            return AggRef(idx, rt)
        if name == "approx_count_distinct":
            # real HyperLogLog sketch above the exactness threshold
            # (ops/sketch.py; reference: third_party/hyperloglog behind
            # approx_count.cpp) — small inputs stay exact like the
            # reference's sparse representation
            spec = L.AggSpec("approx_count_distinct", arg, T.BIGINT,
                             name)
            idx = agg_ctx.add(spec, f"approx_cd({_ekey(arg)})")
            return AggRef(idx, T.BIGINT)
        udafs = getattr(self.context, "_agg_udfs", None) or {}
        if name in udafs:
            # user-defined aggregate: host init/update/finalize over
            # decoded group values (reference:
            # duckdb_create_aggregate_function, src/include/duckdb.h)
            init, update, finalize, rt = udafs[name]
            store = None
            if rt.id == TypeId.VARCHAR:
                store = StringDictionary(np.array([], dtype=object))
                store.runtime = True
            spec = L.AggSpec("udaf", arg, rt, name,
                             distinct=e.distinct, store=store,
                             extra=(init, update, finalize))
            self.uncacheable = True
            idx = agg_ctx.add(spec, f"{name}({_ekey(arg)})")
            return AggRef(idx, rt, store)
        raise BindError(f"aggregate {name} not supported yet")

    def _agg_numeric(self, arg: ir.Expr) -> ir.Expr:
        """Promote statistical-aggregate inputs to DOUBLE (duckdb casts
        decimal/int inputs for stddev/corr familes)."""
        if arg.dtype.id == TypeId.DOUBLE:
            return arg
        if arg.dtype.id == TypeId.NULL:
            # all-NULL input: aggregate yields NULL (reference binds
            # SQLNULL args through the DOUBLE overload)
            return ir.Cast(arg, T.DOUBLE)
        if not arg.dtype.is_numeric:
            raise BindError("statistical aggregate requires numeric input")
        return ir.Cast(arg, T.DOUBLE)

    def _bind_list_lambda(self, name, e, scope, agg_ctx, group_map,
                          sub_replacements):
        """list_transform / list_filter / list_reduce with a lambda
        argument (reference: src/core_functions/lambda_functions.cpp).
        The lambda body evaluates host-side per element
        (sql/lambda_eval.py) through the pure_callback seam — list
        payloads are host stores by design."""
        from ..storage.lists import ListStore
        from . import lambda_eval as LE
        if len(e.args) < 2:
            raise BindError(f"{name} requires (list, lambda)")
        a = self.bind_expr(e.args[0], scope, agg_ctx, group_map,
                           sub_replacements)
        lam = e.args[1]
        if not isinstance(lam, A.ELambda):
            raise BindError(f"{name} requires a lambda argument")
        if a.dtype.id != TypeId.LIST:
            raise BindError(f"{name} requires a LIST argument")
        store = getattr(a, "strdict", None)
        if store is None:
            raise BindError(f"{name}: list argument has no store")
        kind = "transform"
        if name in ("list_filter", "array_filter", "filter"):
            kind = "filter"
        elif name in ("list_reduce", "reduce"):
            kind = "reduce"
        nparams = {"transform": 1, "filter": 1, "reduce": 2}[kind]
        # duckdb lambdas take optional extra index params; we support
        # (x[, i]) for transform/filter and (acc, x[, i]) for reduce
        if len(lam.params) < nparams:
            raise BindError(
                f"{name} lambda needs {nparams}+ parameters")
        body = lam.body
        ps = [p.lower() for p in lam.params]

        # constant list: fold at bind time
        if isinstance(a, ir.Const):
            lst = None if a.value is None \
                else store.decode_one(int(a.value))
            try:
                val = _apply_list_lambda(kind, lst, ps, body, LE)
            except LE.LambdaError as ex:
                raise BindError(str(ex))
            if kind in ("transform", "filter"):
                out = ir.Const(0, a.dtype)
                out.strdict = ListStore([val])
                return out
            return self._bind_literal(val)

        out_store = ListStore()
        out_store.runtime = True

        def fn(vals, nulls, kind=kind):
            lst = None if nulls[0] else store.decode_one(int(vals[0]))
            val = _apply_list_lambda(kind, lst, ps, body, LE)
            if kind in ("transform", "filter"):
                return None if val is None else out_store.add(val)
            return val
        rt = a.dtype if kind in ("transform", "filter") else \
            (a.dtype.child or T.BIGINT)
        if kind == "reduce" and isinstance(body, A.EBinary) \
                and body.op == "/":
            rt = T.DOUBLE
        out = ir.Func("__pyudf__", [a], rt)
        out.extra = (fn, [None], True)
        if kind in ("transform", "filter"):
            out.strdict = out_store
        self.uncacheable = True
        return out

    def _bind_list_func_dynamic(self, name, a, store, e, scope, agg_ctx,
                                group_map, sub_replacements):
        """List functions over RUNTIME-built lists: evaluate against the
        store per row via the callback seam."""
        def lst_of(vals, nulls):
            return None if nulls[0] else store.decode_one(int(vals[0]))

        if name in ("array_length", "list_length", "len", "length",
                    "cardinality"):
            def fn(vals, nulls):
                lst = lst_of(vals, nulls)
                return None if lst is None else len(lst)
            out = ir.Func("__pyudf__", [a], T.BIGINT)
            out.extra = (fn, [None], True)
            return out
        if name in ("list_contains", "array_contains", "list_has",
                    "contains", "list_position", "list_indexof",
                    "array_position", "list_sum", "list_min",
                    "list_max", "list_avg"):
            needle = None
            if name in ("list_contains", "array_contains", "list_has",
                        "contains", "list_position", "list_indexof",
                        "array_position"):
                c = self.bind_expr(e.args[1], scope, agg_ctx, group_map,
                                   sub_replacements)
                if not isinstance(c, ir.Const):
                    raise BindError(f"{name} needle must be constant "
                                    "for runtime lists")
                sd = getattr(c, "strdict", None)
                needle = sd.decode_one(c.value) if sd is not None \
                    else T.decode_value(c.value, c.dtype)

            def fn(vals, nulls, name=name, needle=needle):
                lst = lst_of(vals, nulls)
                if lst is None:
                    return None
                if name in ("list_contains", "array_contains",
                            "list_has", "contains"):
                    return needle in lst
                if name in ("list_position", "list_indexof",
                            "array_position"):
                    return lst.index(needle) + 1 if needle in lst \
                        else None
                vs = [x for x in lst if x is not None]
                if not vs:
                    return None
                if name == "list_sum":
                    return sum(vs)
                if name == "list_min":
                    return min(vs)
                if name == "list_max":
                    return max(vs)
                return float(sum(vs)) / len(vs)
            rt = {"list_contains": T.BOOLEAN, "array_contains":
                  T.BOOLEAN, "list_has": T.BOOLEAN,
                  "contains": T.BOOLEAN, "list_avg": T.DOUBLE}.get(
                      name, T.BIGINT if name in ("list_position",
                                                 "list_indexof",
                                                 "array_position")
                      else (a.dtype.child or T.BIGINT))
            out = ir.Func("__pyudf__", [a], rt)
            out.extra = (fn, [None], True)
            return out
        if name in ("list_sort", "array_sort", "list_reverse_sort",
                    "list_reverse", "array_reverse", "list_distinct",
                    "list_unique", "flatten"):
            from ..storage.lists import ListStore
            out_store = ListStore()
            out_store.runtime = True

            def fn(vals, nulls, name=name):
                lst = lst_of(vals, nulls)
                if lst is None:
                    return None
                live = [x for x in lst if x is not None]
                if name in ("list_sort", "array_sort"):
                    out = sorted(live) + [None] * (len(lst) - len(live))
                elif name == "list_reverse_sort":
                    out = sorted(live, reverse=True) \
                        + [None] * (len(lst) - len(live))
                elif name in ("list_reverse", "array_reverse"):
                    out = list(reversed(lst))
                elif name in ("list_distinct", "list_unique"):
                    seen, out = set(), []
                    for x in live:
                        if x not in seen:
                            seen.add(x)
                            out.append(x)
                    if name == "list_unique":
                        return len(out)
                else:       # flatten
                    out = []
                    for x in lst:
                        if x is not None:
                            out.extend(x)
                return out_store.add(out)
            rt = T.BIGINT if name == "list_unique" else a.dtype
            out = ir.Func("__pyudf__", [a], rt)
            out.extra = (fn, [None], True)
            if name != "list_unique":
                out.strdict = out_store
            self.uncacheable = True
            return out
        raise BindError(f"{name} over runtime-built lists not "
                        "supported yet")

    def _bind_list_literal(self, e: A.EList, scope, agg_ctx, group_map,
                           sub_replacements) -> ir.Expr:
        """[v1, v2, ...] -> Const of LIST type backed by a host ListStore
        (reference: list_value / array literals, LogicalType::LIST)."""
        from ..storage.lists import ListStore
        bound = [self.bind_expr(it, scope, agg_ctx, group_map,
                                sub_replacements) for it in e.items]
        et = None
        for c in bound:
            if c.dtype.id != TypeId.NULL:
                et = c.dtype if et is None \
                    else ir.common_type(et, c.dtype)
        lt = T.LIST(et if et is not None else T.INTEGER)
        if all(isinstance(c, ir.Const) for c in bound):
            vals = []
            for c in bound:
                sd = getattr(c, "strdict", None)
                if c.value is None:
                    vals.append(None)
                elif sd is not None:
                    vals.append(sd.decode_one(c.value))
                else:
                    vals.append(T.decode_value(c.value, c.dtype))
            out = ir.Const(0, lt)
            out.strdict = ListStore([vals])
            return out
        # non-constant elements: per-row host list construction through
        # the pure_callback seam (reference: list_value builds child
        # vectors; our LIST payloads are host stores by design)
        store = ListStore()
        store.runtime = True
        dts = [c.dtype for c in bound]
        sds = [getattr(c, "strdict", None) for c in bound]

        def make_row(vals, nulls):
            row = []
            for v, isn, dt, sd in zip(vals, nulls, dts, sds):
                if isn:
                    row.append(None)
                elif sd is not None:
                    row.append(str(v))     # decoded by the wrapper
                else:
                    row.append(T.decode_value(v, dt))
            return store.add(row)
        out = ir.Func("__pyudf__", bound, lt)
        out.extra = (make_row, sds, True)
        out.strdict = store
        self.uncacheable = True
        return out

    def _str_args(self, name, e, scope, agg_ctx, group_map,
                  sub_replacements):
        """(varchar column expr, [decoded constant extras])."""
        col = self.bind_expr(e.args[0], scope, agg_ctx, group_map,
                             sub_replacements)
        sd = getattr(col, "strdict", None)
        if col.dtype.id != TypeId.VARCHAR or sd is None:
            raise BindError(f"{name} requires a VARCHAR argument")
        extras = []
        for a in e.args[1:]:
            x = self.bind_expr(a, scope, None, None, sub_replacements)
            if not isinstance(x, ir.Const):
                raise BindError(f"{name}: extra args must be constants")
            xd = getattr(x, "strdict", None)
            extras.append(xd.decode_one(x.value) if xd is not None
                          else T.decode_value(x.value, x.dtype))
        return col, sd, extras

    def _bind_str_list_func(self, name, e, scope, agg_ctx, group_map,
                            sub_replacements) -> ir.Expr:
        """VARCHAR -> LIST(VARCHAR) host functions (reference:
        string_split_regex / regexp_extract_all / parse_path)."""
        import re as _re
        from ..storage.lists import ListStore
        col, sd, extras = self._str_args(name, e, scope, agg_ctx,
                                         group_map, sub_replacements)
        if name == "string_split_regex":
            pat = str(extras[0]) if extras else ","
            outs = [_re.split(pat, str(v)) for v in sd.values]
        elif name == "regexp_extract_all":
            pat = str(extras[0])
            grp = int(extras[1]) if len(extras) > 1 else 0
            outs = []
            for v in sd.values:
                try:
                    outs.append([m.group(grp)
                                 for m in _re.finditer(pat, str(v))])
                except IndexError:
                    outs.append([])
        else:   # parse_path
            sep = extras[0] if extras else "both_slash"
            outs = [_parse_path(str(v), sep) for v in sd.values]
        store = ListStore(outs)
        out = ir.DictLookup(col, np.arange(len(outs), dtype=np.int32),
                            T.LIST(T.VARCHAR), name)
        out.strdict = store
        return out

    def _bind_strptime(self, name, e, scope, agg_ctx, group_map,
                       sub_replacements) -> ir.Expr:
        """strptime(s, fmt) -> TIMESTAMP via a bind-time parse table
        (reference: strptime, src/function/scalar/strftime_format.cpp)."""
        import datetime as _dt
        col, sd, extras = self._str_args(name, e, scope, agg_ctx,
                                         group_map, sub_replacements)
        if not extras:
            raise BindError(f"{name} requires a format string")
        fmt = str(extras[0])
        n = len(sd.values)
        table = np.zeros(n, dtype=np.int64)
        bad = np.zeros(n, dtype=bool)
        first_bad = None
        for i, v in enumerate(sd.values):
            try:
                dt = _dt.datetime.strptime(str(v), fmt)
                table[i] = T.td_micros(
                    dt.replace(tzinfo=None) - _dt.datetime(1970, 1, 1))
            except ValueError:
                bad[i] = True
                if first_bad is None and str(v) != "":
                    first_bad = str(v)
        if first_bad is not None and name == "strptime":
            raise ConversionError(
                f"Could not parse string \"{first_bad}\" according to "
                f"format specifier \"{fmt}\"")
        return ir.DictLookup(col, table, T.TIMESTAMP, name,
                             null_table=bad if bad.any() else None)

    def _int_domain_func(self, c: ir.Expr, fn, label: str) -> ir.Expr:
        """int expr -> VARCHAR via a bind-time stringify table over the
        column's bounded domain (same design as _cast_to_varchar)."""
        if isinstance(c, ir.Const):
            if c.value is None:
                return ir.Const(None, T.VARCHAR)
            text = fn(int(c.value))
            sd, codes, _ = StringDictionary.encode([text])
            out = ir.Const(int(codes[0]), T.VARCHAR)
            out.strdict = sd
            return out
        bnd = None
        plan = getattr(self, "_plan_for_bounds", None)
        if plan is not None and c.dtype.is_integer:
            from ..plan import bounds as PB
            try:
                bnd = PB.expr_bounds(c, PB.node_bounds(plan))
            except Exception:
                bnd = None
        if bnd is None:
            raise BindError(
                f"{label} needs a bounded integer domain "
                "(constants or bounded columns)")
        lo, hi = int(bnd[0]), int(bnd[1])
        if hi - lo + 1 > self._STRINGIFY_SPAN:
            raise BindError(f"{label}: value span exceeds the "
                            f"{self._STRINGIFY_SPAN} table limit")
        outs = [fn(v) for v in range(lo, hi + 1)]
        uniq, inv = np.unique(np.asarray(outs, dtype=object).astype(str),
                              return_inverse=True)
        dl = ir.DictLookup(c, inv.astype(np.int32), T.VARCHAR, label,
                           base=lo)
        dl.strdict = StringDictionary(uniq)
        return dl

    def _bind_string_split(self, e: A.EFunc, scope, agg_ctx, group_map,
                           sub_replacements) -> ir.Expr:
        """string_split(s, sep) -> LIST(VARCHAR): per-dictionary-code split
        tables, list payloads host-side (reference:
        extension/core_functions/scalar/string/string_split.cpp)."""
        from ..storage.lists import ListStore
        col = self.bind_expr(e.args[0], scope, agg_ctx, group_map,
                             sub_replacements)
        sd = getattr(col, "strdict", None)
        if col.dtype.id != TypeId.VARCHAR or sd is None:
            raise BindError("string_split requires a VARCHAR argument")
        sep = ","
        if len(e.args) > 1:
            s2 = self.bind_expr(e.args[1], scope, None, None,
                                sub_replacements)
            if not isinstance(s2, ir.Const):
                raise BindError("string_split separator must be constant")
            sd2 = getattr(s2, "strdict", None)
            sep = sd2.decode_one(s2.value) if sd2 is not None \
                else str(s2.value)
        outs = [str(v).split(sep) if sep else [str(v)] for v in sd.values]
        store = ListStore(outs)
        out = ir.DictLookup(col, np.arange(len(outs), dtype=np.int32),
                            T.LIST(T.VARCHAR), "string_split")
        out.strdict = store
        return out

    # ------------------------------------------------------------------
    # nested types: STRUCT / MAP (store-backed, like LIST/VARCHAR —
    # reference: LogicalType::STRUCT/MAP src/common/types.cpp, child
    # vectors src/common/types/vector.cpp; TPU design keeps payloads
    # host-side and compiles field access to per-store-id gather tables)
    # ------------------------------------------------------------------
    def _collate_with_fold(self, c: ir.Expr, fold) -> ir.Expr:
        """Recode an expression through an existing collation fold
        (the other comparison side's), keeping outputs VARCHAR."""
        if c.dtype.id != TypeId.VARCHAR:
            return c
        sd = getattr(c, "strdict", None)
        if isinstance(c, ir.Const):
            if c.value is None:
                return c
            text = fold(sd.decode_one(c.value) if sd is not None
                        else str(c.value))
            sd2, codes, _ = StringDictionary.encode([text])
            out = ir.Const(int(codes[0]), T.VARCHAR)
            out.strdict = sd2
            out.collate_fold = fold
            return out
        if sd is None:
            return c
        folded = [fold(str(v)) for v in sd.values]
        uniq, inv = np.unique(np.asarray(folded, dtype=object)
                              .astype(str), return_inverse=True)
        out = ir.DictLookup(c, inv.astype(np.int32), T.VARCHAR,
                            "collate_fold")
        out.strdict = StringDictionary(uniq)
        out.collate_fold = fold
        return out

    def _column_collation(self, x) -> Optional[str]:
        """Declared column-level collation of a ColRef, if any."""
        if isinstance(x, ir.ColRef) and x.dtype.id == TypeId.VARCHAR \
                and self.catalog is not None:
            for td in getattr(self.catalog, "tables", {}).values():
                coll = getattr(td, "collate_columns", {}).get(x.name)
                if coll:
                    return coll
        return None

    def _bind_collate(self, c: ir.Expr, collation: str) -> ir.Expr:
        """expr COLLATE name: recode into a collation-folded sorted
        dictionary so equality AND ordering follow the collation
        (reference: ICU collations, extension/icu/icu_collate.cpp +
        PragmaCollations; ours folds at bind time — dictionary codes
        stay the comparison domain on device)."""
        parts = [p[4:] if p.startswith("icu_") else p
                 for p in collation.lower().split(".") if p]
        parts = [p.split("_")[0] if "_" in p
                 and p.split("_")[0] in _LOCALE_COLLATIONS else p
                 for p in parts]
        if "nfc" in parts or "nfd" in parts:
            parts = [p for p in parts if p not in ("nfc", "nfd")] \
                + ["da"]      # canonical-normalization fold
        bad = [p for p in parts if p not in ("nocase", "noaccent")
               and p not in _LOCALE_COLLATIONS]
        if bad:
            raise BindError(f"unknown collation {bad[0]}")
        if c.dtype.id != TypeId.VARCHAR:
            raise BindError("COLLATE requires a VARCHAR operand")
        locales = [p for p in parts if p in _LOCALE_COLLATIONS]

        def fold(s: str) -> str:
            if "noaccent" in parts:
                import unicodedata
                s = "".join(ch for ch in unicodedata.normalize("NFD", s)
                            if not unicodedata.combining(ch))
            if "nocase" in parts:
                s = s.lower()
            for loc in locales:
                s = _LOCALE_COLLATIONS[loc](s)
            return s

        sd = getattr(c, "strdict", None)
        if isinstance(c, ir.Const):
            if c.value is None:
                return c
            text = fold(sd.decode_one(c.value) if sd is not None
                        else str(c.value))
            sd2, codes, _ = StringDictionary.encode([text])
            out = ir.Const(int(codes[0]), T.VARCHAR)
            out.strdict = sd2
            out.collate_fold = fold
            return out
        if sd is None:
            raise BindError("COLLATE operand has no dictionary")
        folded = [fold(str(v)) for v in sd.values]
        uniq, inv = np.unique(np.asarray(folded, dtype=object)
                              .astype(str), return_inverse=True)
        out = ir.DictLookup(c, inv.astype(np.int32), T.VARCHAR,
                            f"collate_{'_'.join(parts)}")
        out.strdict = StringDictionary(uniq)
        out.collate_fold = fold
        return out

    def _const_py(self, c: ir.Const):
        """Constant -> python value (dictionary/store decoded)."""
        if c.value is None:
            return None
        sd = getattr(c, "strdict", None)
        if sd is not None:
            return sd.decode_one(c.value)
        return T.decode_value(c.value, c.dtype)

    def _payload_expr(self, child: ir.Expr, vals: list, t, tag: str
                      ) -> ir.Expr:
        """Per-store-id gather: python payload values (indexed by the
        child's store id) -> a typed DictLookup expression."""
        nulls = np.array([v is None for v in vals], dtype=bool)
        nt = nulls if nulls.any() else None
        if t.id == TypeId.VARCHAR:
            sd, codes, n2 = StringDictionary.encode(
                ["" if v is None else str(v) for v in vals])
            out = ir.DictLookup(child, codes.astype(np.int32), T.VARCHAR,
                                tag, null_table=nt)
            out.strdict = sd
            return out
        if t.id == TypeId.LIST:
            from ..storage.lists import ListStore
            store = ListStore([v if v is not None else [] for v in vals])
            out = ir.DictLookup(child,
                                np.arange(len(vals), dtype=np.int32),
                                t, tag, null_table=nt)
            out.strdict = store
            return out
        if t.id == TypeId.STRUCT:
            from ..storage.nested import StructStore
            names = [n for n, _ in (t.children or ())]
            items = []
            for v in vals:
                if isinstance(v, dict):
                    items.append(tuple(v.get(n) for n in names))
                elif v is None:
                    items.append(tuple(None for _ in names))
                else:
                    items.append(tuple(v))
            store = StructStore(names, items)
            out = ir.DictLookup(child,
                                np.arange(len(vals), dtype=np.int32),
                                t, tag, null_table=nt)
            out.strdict = store
            return out
        if t.id == TypeId.MAP:
            from ..storage.nested import MapStore
            store = MapStore([
                list(v.items()) if isinstance(v, dict)
                else (list(v) if v is not None else []) for v in vals])
            out = ir.DictLookup(child,
                                np.arange(len(vals), dtype=np.int32),
                                t, tag, null_table=nt)
            out.strdict = store
            return out
        arr = np.zeros(len(vals), dtype=t.np_dtype)
        for i, v in enumerate(vals):
            if v is not None:
                arr[i] = T.encode_literal(v, t)
        return ir.DictLookup(child, arr, t, tag, null_table=nt)

    def _union_extract(self, base: ir.Expr, member: str) -> ir.Expr:
        """Member value when the tag matches, else NULL (reference:
        union_extract, src/common/types/union_type.cpp)."""
        store = getattr(base, "strdict", None)
        if store is None:
            raise BindError("union value has no store")
        for k, (n, t) in enumerate(base.dtype.children or ()):
            if n.lower() == str(member).lower():
                return self._payload_expr(
                    base, store.member_values(k), t, "union_extract")
        raise BindError(f"union has no member '{member}'")

    def _struct_extract(self, base: ir.Expr, fname: str) -> ir.Expr:
        store = getattr(base, "strdict", None)
        if store is None:
            raise BindError("struct value has no store")
        fields = base.dtype.children or ()
        for k, (n, t) in enumerate(fields):
            if n.lower() == str(fname).lower():
                return self._payload_expr(
                    base, store.field_values(k), t, "struct_extract")
        raise BindError(f"struct has no field '{fname}'")

    def _bind_struct_literal(self, e: A.EStruct, scope, agg_ctx,
                             group_map, sub_replacements) -> ir.Expr:
        from ..storage.nested import StructStore
        names, vals, ftypes = [], [], []
        for fname, fe in e.fields:
            c = self.bind_expr(fe, scope, agg_ctx, group_map,
                               sub_replacements)
            if not isinstance(c, ir.Const):
                raise BindError("struct literals must contain constants")
            names.append(fname)
            vals.append(self._const_py(c))
            ftypes.append((fname, c.dtype if c.dtype.id != TypeId.NULL
                           else T.INTEGER))
        out = ir.Const(0, T.STRUCT(ftypes))
        out.strdict = StructStore(names, [tuple(vals)])
        return out

    def _bind_map_literal(self, e: A.EMap, scope, agg_ctx, group_map,
                          sub_replacements) -> ir.Expr:
        from ..storage.nested import MapStore
        pairs, kt, vt = [], None, None
        for ke, ve in e.entries:
            kc = self.bind_expr(ke, scope, agg_ctx, group_map,
                                sub_replacements)
            vc = self.bind_expr(ve, scope, agg_ctx, group_map,
                                sub_replacements)
            if not isinstance(kc, ir.Const) or not isinstance(vc, ir.Const):
                raise BindError("map literals must contain constants")
            pairs.append((self._const_py(kc), self._const_py(vc)))
            if kc.dtype.id != TypeId.NULL:
                kt = kc.dtype if kt is None else ir.common_type(kt,
                                                                kc.dtype)
            if vc.dtype.id != TypeId.NULL:
                vt = vc.dtype if vt is None else ir.common_type(vt,
                                                                vc.dtype)
        out = ir.Const(0, T.MAP(kt or T.INTEGER, vt or T.INTEGER))
        out.strdict = MapStore([pairs])
        return out

    def _bind_index(self, e: A.EIndex, scope, agg_ctx, group_map,
                    sub_replacements) -> ir.Expr:
        c = self.bind_expr(e.child, scope, agg_ctx, group_map,
                           sub_replacements)
        ie = self.bind_expr(e.index, scope, agg_ctx, group_map,
                            sub_replacements)
        t = c.dtype
        if t.id == TypeId.STRUCT:
            if not isinstance(ie, ir.Const) \
                    or ie.dtype.id != TypeId.VARCHAR:
                raise BindError(
                    "struct subscript must be a constant field name")
            return self._struct_extract(c, self._const_py(ie))
        if t.id == TypeId.MAP:
            if not isinstance(ie, ir.Const):
                raise BindError("map subscript must be constant")
            key = self._const_py(ie)
            store = getattr(c, "strdict", None)
            if store is None:
                raise BindError("map value has no store")
            vals = [dict(store.items[i]).get(key)
                    for i in range(len(store))]
            return self._payload_expr(c, vals, t.child2, "map_extract")
        if t.id == TypeId.LIST:
            if not isinstance(ie, ir.Const) or not ie.dtype.is_integer:
                raise BindError("list subscript must be a constant integer")
            k = int(ie.value)
            store = getattr(c, "strdict", None)
            if store is None:
                raise BindError("list value has no store")
            vals = []
            for it in store.items:
                # 1-based; negative counts from the end (duckdb
                # list_extract semantics, core_functions/scalar/list/)
                idx = k - 1 if k > 0 else len(it) + k
                vals.append(it[idx] if 0 <= idx < len(it) else None)
            return self._payload_expr(c, vals, t.child or T.INTEGER,
                                      "list_extract")
        if t.id == TypeId.VARCHAR:
            # 'abc'[2] == substring('abc', 2, 1) (reference: array_extract
            # over VARCHAR, src/function/scalar/string/substring.cpp)
            return self.bind_expr(
                A.EFunc("substring", [e.child, e.index, A.ELit(1)]),
                scope, agg_ctx, group_map, sub_replacements)
        raise BindError(f"cannot subscript a value of type {t}")

    def _bind_nested_func(self, name, e: A.EFunc, scope, agg_ctx,
                          group_map, sub_replacements) -> ir.Expr:
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements)
        a = b(e.args[0])
        t = a.dtype
        store = getattr(a, "strdict", None)
        if name == "struct_extract":
            if t.id != TypeId.STRUCT:
                raise BindError("struct_extract requires a STRUCT")
            fe = b(e.args[1])
            if not isinstance(fe, ir.Const):
                raise BindError("struct_extract field must be constant")
            return self._struct_extract(a, self._const_py(fe))
        if name in ("map_keys", "map_values"):
            if t.id != TypeId.MAP or store is None:
                raise BindError(f"{name} requires a MAP")
            get = store.keys_of if name == "map_keys" else store.values_of
            vals = [get(i) for i in range(len(store))]
            et = t.child if name == "map_keys" else t.child2
            return self._payload_expr(a, vals, T.LIST(et), name)
        if name == "map_contains":
            if t.id != TypeId.MAP or store is None:
                raise BindError("map_contains requires a MAP")
            kc = b(e.args[1])
            if not isinstance(kc, ir.Const):
                raise BindError("map_contains key must be constant")
            key = self._const_py(kc)
            tab = np.array([key in dict(store.items[i])
                            for i in range(len(store))], dtype=bool)
            return ir.DictLookup(a, tab, T.BOOLEAN, "map_contains")
        if name in ("element_at", "map_extract", "list_extract",
                    "list_element", "array_extract"):
            return self._bind_index(
                A.EIndex(e.args[0], e.args[1]), scope, agg_ctx,
                group_map, sub_replacements)
        raise BindError(f"unsupported nested function {name}")

    def _bind_list_func(self, name, a: ir.Expr, e: A.EFunc, scope,
                        agg_ctx, group_map, sub_replacements) -> ir.Expr:
        """Scalar functions over LIST columns via per-list-id tables
        (reference: extension/core_functions/scalar/list/*)."""
        store = getattr(a, "strdict", None)
        if store is None:
            raise BindError(f"{name}: list argument has no store")
        if not isinstance(a, (ir.Const, ir.ColRef)) \
                or getattr(store, "runtime", False):
            # runtime-built list (literal over columns, aggregate
            # results like approx_top_k/collect, window outputs): the
            # store fills during execution, so consult it through a
            # callback instead of a bind-time table
            return self._bind_list_func_dynamic(
                name, a, store, e, scope, agg_ctx, group_map,
                sub_replacements)
        if name in ("array_length", "list_length", "len", "length",
                    "cardinality"):
            return ir.DictLookup(a, store.lengths(), T.BIGINT,
                                 "list_length")
        et = a.dtype.child or T.INTEGER
        if name in ("list_sort", "array_sort", "list_reverse_sort",
                    "list_reverse", "array_reverse", "list_distinct",
                    "list_unique", "flatten"):
            def xform(lst):
                vals = [x for x in lst if x is not None]
                if name in ("list_sort", "array_sort"):
                    return sorted(vals) + [None] * (len(lst) - len(vals))
                if name == "list_reverse_sort":
                    return sorted(vals, reverse=True) \
                        + [None] * (len(lst) - len(vals))
                if name in ("list_reverse", "array_reverse"):
                    return list(reversed(lst))
                if name == "list_distinct":
                    seen, out = set(), []
                    for x in vals:
                        if x not in seen:
                            seen.add(x)
                            out.append(x)
                    return out
                if name == "flatten":
                    out = []
                    for x in lst:
                        if isinstance(x, list):
                            out.extend(x)
                    return out
                return lst
            if name == "list_unique":
                tab = np.array([len({x for x in lst if x is not None})
                                for lst in store.items], dtype=np.int64)
                return ir.DictLookup(a, tab, T.BIGINT, "list_unique")
            rt = T.LIST(et.child) if name == "flatten" \
                and et.id == TypeId.LIST else T.LIST(et)
            return self._payload_expr(
                a, [xform(lst) for lst in store.items],
                rt, name)
        if name in ("list_sum", "list_min", "list_max", "list_avg",
                    "list_median"):
            red = {"list_sum": sum, "list_min": min, "list_max": max}
            vals = []
            for lst in store.items:
                xs = [x for x in lst if x is not None]
                if not xs:
                    vals.append(None)
                elif name == "list_avg":
                    vals.append(float(sum(xs)) / len(xs))
                elif name == "list_median":
                    ss = sorted(xs)
                    m = len(ss) // 2
                    vals.append(float(ss[m]) if len(ss) % 2
                                else (float(ss[m - 1]) + float(ss[m])) / 2)
                else:
                    vals.append(red[name](xs))
            rt = T.DOUBLE if name in ("list_avg", "list_median") else et
            return self._payload_expr(a, vals, rt, name)
        if name in ("list_slice", "array_slice"):
            lo = self.bind_expr(e.args[1], scope, agg_ctx, group_map,
                                sub_replacements)
            hi = self.bind_expr(e.args[2], scope, agg_ctx, group_map,
                                sub_replacements)
            if not isinstance(lo, ir.Const) or not isinstance(hi, ir.Const):
                raise BindError(f"{name}: bounds must be constant")
            i0, i1 = int(lo.value), int(hi.value)
            outs = []
            for lst in store.items:
                b0 = i0 - 1 if i0 > 0 else len(lst) + i0
                b1 = i1 if i1 > 0 else len(lst) + i1 + 1
                outs.append(lst[max(b0, 0):max(b1, 0)])
            return self._payload_expr(a, outs, T.LIST(et), name)
        if name in ("array_to_string", "list_aggr_string"):
            sep = self.bind_expr(e.args[1], scope, agg_ctx, group_map,
                                 sub_replacements)
            if not isinstance(sep, ir.Const):
                raise BindError(f"{name}: separator must be constant")
            sd = getattr(sep, "strdict", None)
            sp = sd.decode_one(sep.value) if sd is not None \
                else str(sep.value)
            vals = [sp.join(str(x) for x in lst if x is not None)
                    for lst in store.items]
            return self._payload_expr(a, vals, T.VARCHAR, name)
        if name in ("list_position", "list_indexof", "array_position"):
            v = self.bind_expr(e.args[1], scope, agg_ctx, group_map,
                               sub_replacements)
            if not isinstance(v, ir.Const):
                raise BindError(f"{name}: needle must be constant")
            sdv = getattr(v, "strdict", None)
            needle = sdv.decode_one(v.value) if sdv is not None \
                else T.decode_value(v.value, v.dtype)
            vals = [lst.index(needle) + 1 if needle in lst else None
                    for lst in store.items]
            return self._payload_expr(a, vals, T.INTEGER, name)
        # list_contains(l, v)
        v = self.bind_expr(e.args[1], scope, agg_ctx, group_map,
                           sub_replacements)
        if not isinstance(v, ir.Const):
            raise BindError(f"{name}: needle must be constant")
        sdv = getattr(v, "strdict", None)
        needle = sdv.decode_one(v.value) if sdv is not None \
            else T.decode_value(v.value, v.dtype)
        table = np.array([needle in lst for lst in store.items],
                         dtype=bool)
        return ir.DictLookup(a, table, T.BOOLEAN, "list_contains")

    # ---- BIT (bitstring) ------------------------------------------------
    # Dictionary-encoded like VARCHAR: canonical '0'/'1' text in the
    # dictionary, per-code tables for every operator (reference packs a
    # padded blob, src/common/types/bit.cpp; here text IS the storage
    # form so device work stays int32 gathers).

    def _is_bit(self, x) -> bool:
        if getattr(x, "bit_type", False):
            return True
        if isinstance(x, ir.ColRef) and x.dtype.id == TypeId.VARCHAR:
            for td in getattr(self.catalog, "tables", {}).values():
                if x.name in getattr(td, "bit_columns", ()):
                    return True
        return False

    def _bit_text_of(self, c: ir.Const) -> str:
        from ..expr import bits as B
        sd = getattr(c, "strdict", None)
        if c.dtype.id == TypeId.BLOB and sd is not None:
            return B.from_blob(sd.decode_one(int(c.value)))
        if c.dtype.is_integer:
            # numeric -> BIT: the two's-complement bit pattern at the
            # type's width (reference: NumericToBit casts, bit.cpp)
            w = {TypeId.TINYINT: 8, TypeId.SMALLINT: 16,
                 TypeId.INTEGER: 32}.get(c.dtype.id, 64)
            return format(int(c.value) & ((1 << w) - 1), f"0{w}b")
        return B.validate(self._const_text(c))

    def _bit_table(self, col: ir.Expr, fn, label: str) -> ir.Expr:
        """Per-code table applying fn(text)->text|None over col's
        dictionary; BitErrors become NULL codes."""
        from ..expr import bits as B
        sd = col.strdict
        outs = []
        for v in sd.values:
            try:
                outs.append(fn(str(v)))
            except B.BitError:
                outs.append(None)
        out = self._string_table(col, outs, label)
        out.bit_type = True
        return out

    def _bit_not(self, c: ir.Expr) -> ir.Expr:
        from ..expr import bits as B
        if isinstance(c, ir.Const):
            if c.value is None:
                out = ir.Const(None, T.VARCHAR)
            else:
                out = self._bind_literal(B.bit_not(self._bit_text_of(c)))
            out.bit_type = True
            return out
        return self._bit_table(c, lambda s: B.bit_not(B.validate(s)),
                               "bit_not")

    def _bit_shift(self, op: str, l: ir.Expr, r: ir.Expr) -> ir.Expr:
        from ..expr import bits as B
        sh = B.shift_left if op == "<<" else B.shift_right
        if not isinstance(r, ir.Const):
            raise BindError("BIT shift amount must be constant")
        if r.value is None:
            out = ir.Const(None, T.VARCHAR)
            out.bit_type = True
            return out
        n = int(r.value)
        if isinstance(l, ir.Const):
            if l.value is None:
                out = ir.Const(None, T.VARCHAR)
            else:
                try:
                    out = self._bind_literal(
                        sh(self._bit_text_of(l), n))
                except B.BitError as ex:
                    raise self._bit_raise(ex)
            out.bit_type = True
            return out
        return self._bit_table(l, lambda s: sh(B.validate(s), n),
                               f"bit{op}")

    def _bit_binop(self, op: str, l: ir.Expr, r: ir.Expr) -> ir.Expr:
        from ..expr import bits as B
        fn2 = {"&": B.bit_and, "|": B.bit_or, "xor": B.bit_xor}[op]
        if isinstance(l, ir.Const) and isinstance(r, ir.Const):
            if l.value is None or r.value is None:
                out = ir.Const(None, T.VARCHAR)
            else:
                try:
                    out = self._bind_literal(
                        fn2(self._bit_text_of(l), self._bit_text_of(r)))
                except B.BitError as ex:
                    raise InvalidInputError(
                        f"Invalid Input Error: {ex}")
            out.bit_type = True
            return out
        if isinstance(r, ir.Const) or isinstance(l, ir.Const):
            cst, col = (l, r) if isinstance(l, ir.Const) else (r, l)
            if cst.value is None:
                out = ir.Const(None, T.VARCHAR)
                out.bit_type = True
                return out
            ctext = self._bit_text_of(cst)
            return self._bit_table(
                col, lambda s: fn2(B.validate(s), ctext), f"bit{op}")
        # column (x) column: pair table like _concat2
        lv = [str(v) for v in l.strdict.values]
        rv = [str(v) for v in r.strdict.values]
        if len(lv) * len(rv) > self._CONCAT_CAP:
            raise BindError("BIT operator: combined dictionary too large")
        outs = []
        for x in lv:
            for y in rv:
                try:
                    outs.append(fn2(B.validate(x), B.validate(y)))
                except B.BitError:
                    outs.append(None)
        live = [o for o in outs if o is not None]
        nd = StringDictionary(
            np.unique(np.asarray(live, dtype=object).astype(str))
            if live else np.array([], dtype=object))
        table = np.array([0 if o is None else nd.code_of(o)
                          for o in outs], dtype=np.int32)
        nulls = np.array([o is None for o in outs], dtype=bool)
        out = ir.DictLookup2(l, r, table, max(len(rv), 1), T.VARCHAR,
                             f"bit{op}",
                             null_table=nulls if nulls.any() else None)
        out.strdict = nd
        out.bit_type = True
        return out

    def _bit_raise(self, ex) -> Exception:
        """Map a BitError to the reference's exception family."""
        m = str(ex)
        if m.startswith("bit index") or "shift by negative" in m:
            return OutOfRangeError(f"Out of Range Error: {m}")
        if "must be 1 or 0" in m or "Length must be" in m \
                or "different sizes" in m:
            return InvalidInputError(f"Invalid Input Error: {m}")
        return ConversionError(f"Conversion Error: {m}")

    def _bind_bit_func(self, name, e: A.EFunc, scope, agg_ctx,
                       group_map, sub_replacements) -> ir.Expr:
        from ..expr import bits as B
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements)
        args = [b(a) for a in e.args]

        def const_int(c, what):
            if not isinstance(c, ir.Const):
                raise BindError(f"{name}: {what} must be constant")
            return None if c.value is None else int(c.value)

        str_out = name in ("set_bit", "bitstring")
        if name == "bit_position":
            if len(args) != 2:
                raise BindError(
                    f"Binder Error: No function matches {name}")
            sub = args[0]
            if not isinstance(sub, ir.Const):
                raise BindError("bit_position needle must be constant")
            driving = args[1]
            stext = None if sub.value is None \
                else self._bit_text_of(sub)
            fn = lambda s: B.bit_position(stext, B.validate(s))
        elif name == "get_bit":
            if len(args) != 2:
                raise BindError(
                    f"Binder Error: No function matches {name}")
            driving = args[0]
            i = const_int(args[1], "index")
            fn = lambda s: B.get_bit(B.validate(s), i)
        elif name == "set_bit":
            if len(args) != 3:
                raise BindError(
                    f"Binder Error: No function matches {name}")
            driving = args[0]
            i = const_int(args[1], "index")
            nb = const_int(args[2], "new bit")
            fn = lambda s: B.set_bit(B.validate(s), i, nb)
        elif name == "bitstring":
            if len(args) != 2:
                raise BindError(
                    f"Binder Error: No function matches {name} with a "
                    "single argument")
            driving = args[0]
            n = const_int(args[1], "length")
            fn = lambda s: B.bitstring(B.validate(s), n)
        elif name == "bit_count":
            driving = args[0]
            fn = lambda s: B.bit_count(B.validate(s))
        elif name == "bit_length":
            driving = args[0]
            fn = lambda s: len(B.validate(s))
        else:   # octet_length on BIT
            driving = args[0]
            fn = lambda s: (len(B.validate(s)) + 7) // 8
        if isinstance(driving, ir.Const):
            if driving.value is None:
                out = ir.Const(None,
                               T.VARCHAR if str_out else T.BIGINT)
                if str_out:
                    out.bit_type = True
                return out
            try:
                r = fn(self._bit_text_of(driving))
            except B.BitError as ex:
                raise self._bit_raise(ex)
            out = self._bind_literal(str(r) if str_out else int(r))
            if str_out:
                out.bit_type = True
            return out
        sd = getattr(driving, "strdict", None)
        if sd is None or driving.dtype.id not in (TypeId.VARCHAR,):
            raise BindError(f"{name} requires a BIT argument")
        if str_out:
            return self._bit_table(driving, fn, name)
        raw = []
        for v in sd.values:
            try:
                raw.append(fn(str(v)))
            except B.BitError:
                raw.append(None)
        nulls = np.array([r is None for r in raw], dtype=bool)
        table = np.array([0 if r is None else int(r) for r in raw],
                         dtype=np.int64)
        return ir.DictLookup(driving, table, T.BIGINT, name,
                             null_table=nulls if nulls.any() else None)

    def _bit_to_numeric(self, c: ir.Expr, tgt: DataType,
                        try_: bool) -> ir.Expr:
        """BIT -> numeric/boolean: the unsigned value of the bits
        (reference: CastFromBitToNumeric, common/types/bit.cpp);
        BOOLEAN is true iff any bit is set."""
        from ..expr import bits as B

        def val(text):
            t2 = B.validate(text)
            if tgt.id == TypeId.BOOLEAN:
                if len(t2) > 8:
                    raise B.BitError(
                        f"bit string of length {len(t2)} does not fit "
                        "in a BOOLEAN")
                return "1" in t2
            v = int(t2, 2)
            if tgt.id in (TypeId.FLOAT, TypeId.DOUBLE):
                # bit PATTERN reinterprets as the float's raw bytes
                # (reference: CastFromBitToNumeric memcpy semantics)
                import struct
                if tgt.id == TypeId.FLOAT:
                    if len(t2) > 32:
                        raise B.BitError("too many bits for FLOAT")
                    return struct.unpack(
                        ">f", (v & 0xFFFFFFFF).to_bytes(4, "big"))[0]
                if len(t2) > 64:
                    raise B.BitError("too many bits for DOUBLE")
                return struct.unpack(
                    ">d", v.to_bytes(8, "big"))[0]
            if tgt.id == TypeId.DECIMAL:
                return v * T.decimal_scale_factor(tgt.scale)
            lim = min(_INT_LIMITS.get(tgt.id, 2 ** 63 - 1),
                      2 ** 63 - 1)   # int64 lanes cap HUGEINT here
            if v > lim:
                raise B.BitError(
                    f"bit value {t2} out of range for {tgt!r}")
            return v

        if isinstance(c, ir.Const):
            if c.value is None:
                return ir.Const(None, tgt)
            try:
                return ir.Const(val(self._bit_text_of(c)), tgt)
            except (B.BitError, OverflowError) as ex:
                if try_:
                    return ir.Const(None, tgt)
                raise self._bit_raise(ex) if isinstance(ex, B.BitError) \
                    else ConversionError(f"Conversion Error: {ex}")
        sd = getattr(c, "strdict", None)
        if sd is None:
            raise BindError("BIT cast requires a dictionary")
        n = len(sd.values)
        table = np.zeros(n, dtype=tgt.np_dtype)
        bad = np.zeros(n, dtype=bool)
        first_bad = None
        for i in range(n):
            text = str(sd.values[i])
            try:
                table[i] = val(text)
            except (B.BitError, OverflowError, ValueError):
                bad[i] = True
                if first_bad is None and text != "":
                    first_bad = text
        if first_bad is not None and not try_:
            raise ConversionError(
                f"Conversion Error: Could not convert BIT "
                f"'{first_bad}' to {tgt!r}")
        return ir.DictLookup(c, table, tgt, "bit_cast",
                             null_table=bad if bad.any() else None)

    def _bind_bit_cast(self, c: ir.Expr, try_: bool) -> ir.Expr:
        from ..expr import bits as B
        if getattr(c, "bit_type", False):
            return c
        if isinstance(c, ir.Const):
            if c.value is None:
                out = ir.Const(None, T.VARCHAR)
                out.bit_type = True
                return out
            try:
                out = self._bind_literal(self._bit_text_of(c))
            except B.BitError as ex:
                if try_:
                    out = ir.Const(None, T.VARCHAR)
                    out.bit_type = True
                    return out
                raise ConversionError(f"Conversion Error: {ex}")
            out.bit_type = True
            return out
        sd = getattr(c, "strdict", None)
        if sd is None:
            raise BindError("cast to BIT requires a string or blob")
        if c.dtype.id == TypeId.BLOB:
            return self._blob_bit(c)
        # VARCHAR column: strict CAST errors on any bad non-'' entry
        outs = []
        first_bad = None
        for v in sd.values:
            try:
                outs.append(B.validate(str(v)))
            except B.BitError:
                outs.append(None)
                if first_bad is None and str(v) != "":
                    first_bad = str(v)
        if first_bad is not None and not try_:
            raise ConversionError(
                "Conversion Error: Invalid character encountered in "
                f"string -> bit conversion: '{first_bad}'")
        out = self._string_table(c, outs, "str_to_bit")
        out.bit_type = True
        return out

    def _blob_bit(self, c: ir.Expr) -> ir.Expr:
        from ..expr import bits as B
        store = c.strdict
        outs = []
        for item in store.items:
            try:
                outs.append(B.from_blob(item))
            except B.BitError:
                outs.append(None)
        out = self._string_table(c, outs, "blob_to_bit")
        out.bit_type = True
        return out

    def _text_nested_value(self, atom, tgt: DataType,
                           try_: bool = False):
        return text_to_nested(atom, tgt, try_=try_,
                              timetz_raw=self._timetz_raw)

    def _cast_text_nested(self, c: ir.Expr, tgt: DataType,
                          try_: bool) -> ir.Expr:
        """VARCHAR -> LIST/STRUCT/MAP: bind-time per-code parse into a
        host-side store (reference: string -> nested casts,
        src/common/types/vector/ string-cast paths)."""
        import decimal as _dec

        from ..expr import nestedtext as NT
        from ..storage.lists import ListStore
        from ..storage.nested import MapStore, StructStore

        def make_store():
            if tgt.id == TypeId.LIST:
                return ListStore()
            if tgt.id == TypeId.STRUCT:
                return StructStore([n for n, _t in
                                    (tgt.children or ())])
            return MapStore()

        def conv(text):
            v = self._text_nested_value((text, False), tgt,
                                        try_=try_)
            if v is not None and tgt.id == TypeId.STRUCT:
                # top-level store keeps member order as a tuple
                return tuple(v[n] for n, _t in (tgt.children or ()))
            return v

        store = make_store()
        if isinstance(c, ir.Const):
            if c.value is None:
                return ir.Const(None, tgt)
            text = self._const_text(c)
            try:
                v = conv(text)
            except (NT.NestedTextError, ValueError, OverflowError,
                    _dec.InvalidOperation):
                v = None
            if v is None:
                if try_:
                    return ir.Const(None, tgt)
                raise ConversionError(
                    f"Could not convert string '{text}' to {tgt!r}")
            out = ir.Const(int(store.add(v)), tgt)
            out.strdict = store
            return out
        sd = getattr(c, "strdict", None)
        if sd is None:
            raise BindError("cast from varchar requires a dictionary")
        n = len(sd.values)
        table = np.zeros(n, dtype=np.int32)
        bad = np.zeros(n, dtype=bool)
        first_bad = None
        for i in range(n):
            text = str(sd.values[i]).strip()
            try:
                v = conv(text)
            except (NT.NestedTextError, ValueError, OverflowError,
                    _dec.InvalidOperation):
                v = None
            if v is None:
                bad[i] = True
                if first_bad is None and text != "":
                    first_bad = text
            else:
                table[i] = store.add(v)
        if first_bad is not None and not try_:
            raise ConversionError(
                f"Could not convert string '{first_bad}' to {tgt!r}")
        out = ir.DictLookup(c, table, tgt, "str_cast",
                            null_table=bad if bad.any() else None)
        out.strdict = store
        return out

    def _bind_blob_from_text(self, c: ir.Expr) -> ir.Expr:
        """VARCHAR/BIT -> BLOB: bitstrings pack 8 bits/byte, plain
        strings keep their utf8 bytes (reference: Bit::BitToBlob /
        CastToBlob)."""
        from ..expr import bits as B
        from ..storage.nested import BlobStore
        is_bit = self._is_bit(c)
        conv = (lambda s: B.to_blob(B.validate(s))) if is_bit \
            else (lambda s: s.encode("utf-8"))
        if isinstance(c, ir.Const):
            if c.value is None:
                return ir.Const(None, T.BLOB)
            try:
                data = conv(self._const_text(c))
            except B.BitError as ex:
                raise ConversionError(f"Conversion Error: {ex}")
            out = ir.Const(0, T.BLOB)
            out.strdict = BlobStore([data])
            return out
        sd = getattr(c, "strdict", None)
        if sd is None:
            raise BindError("cast to BLOB requires a dictionary")
        items = []
        table = np.zeros(len(sd.values), dtype=np.int32)
        nulls = np.zeros(len(sd.values), dtype=bool)
        for i, v in enumerate(sd.values):
            try:
                items.append(conv(str(v)))
                table[i] = len(items) - 1
            except B.BitError:
                nulls[i] = True
        out = ir.DictLookup(c, table, T.BLOB, "to_blob",
                            null_table=nulls if nulls.any() else None)
        out.strdict = BlobStore(items)
        return out

    def _lateral_alias_subst(self, e, prior_items):
        """Deep-copied alias substitution for lateral references; None
        if no prior alias occurs in e (caller re-raises the original
        bind error)."""
        import copy as _copy
        if not prior_items:
            return None
        sub = _subst_item_aliases(_copy.deepcopy(e), prior_items)
        if _ast_equal(sub, e):
            return None
        # chained aliases (SELECT 2 a, a*a b, b+a) resolve to a
        # fixpoint; bounded in case of self-reference
        for _ in range(8):
            nxt = _subst_item_aliases(_copy.deepcopy(sub), prior_items)
            if _ast_equal(nxt, sub):
                break
            sub = nxt
        return sub

    def _bind_string_func(self, name, e: A.EFunc, scope, agg_ctx,
                          group_map, sub_replacements):
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements)
        args = [b(a) for a in e.args]
        col = args[0]
        sd = getattr(col, "strdict", None)
        if col.dtype.id != TypeId.VARCHAR or sd is None:
            raise BindError(f"{name} requires VARCHAR column")
        const_args = []
        for a in args[1:]:
            if not isinstance(a, ir.Const):
                raise BindError(f"{name}: extra args must be constants")
            v = a.value
            if getattr(a, "strdict", None) is not None:
                v = a.strdict.decode_one(v)
            const_args.append(v)
        fn = _STR_FUNCS[name]

        # the whole dictionary is evaluated at bind time, including the
        # '' placeholder of NULL rows — a partial function (hamming,
        # unhex, ...) must not fail the bind for codes no live row uses;
        # errors surface as NULL for that code instead
        def compute_raw():
            raw = []
            errs = 0
            first_err = None
            for v in sd.values:
                try:
                    raw.append(fn(str(v), *const_args))
                except BindError as ex:
                    raw.append(None)
                    errs += 1
                    if first_err is None:
                        first_err = ex
                except (ValueError, TypeError, KeyError, IndexError,
                        OverflowError):
                    raw.append(None)
                    errs += 1
            return raw, errs, first_err

        if getattr(sd, "runtime", False):
            # runtime-filled dictionary (aggregate/window output): the
            # per-code table must be rebuilt at evaluation time, when
            # the store has its real contents (lazy DictLookup)
            if name in _STR_INT_FUNCS:
                def tbl_int():
                    raw, _, _ = compute_raw()
                    nt = np.array([r is None for r in raw], dtype=bool)
                    return (np.array(
                        [0 if r is None else int(r) for r in raw],
                        dtype=np.int64), nt if nt.any() else None)
                return ir.DictLookup(col, tbl_int, T.BIGINT, name)
            if name in _STR_BOOL_FUNCS:
                def tbl_bool():
                    raw, _, _ = compute_raw()
                    nt = np.array([r is None for r in raw], dtype=bool)
                    return (np.array([bool(r) for r in raw], dtype=bool),
                            nt if nt.any() else None)
                return ir.DictLookup(col, tbl_bool, T.BOOLEAN, name)
            if name in _STR_FLOAT_FUNCS:
                def tbl_float():
                    raw, _, _ = compute_raw()
                    nt = np.array([r is None for r in raw], dtype=bool)
                    return (np.array(
                        [np.nan if r is None else r for r in raw],
                        dtype=np.float64), nt if nt.any() else None)
                return ir.DictLookup(col, tbl_float, T.DOUBLE, name)
            out_sd = StringDictionary(np.array([], dtype=object))
            out_sd.runtime = True

            def tbl_str():
                raw, _, _ = compute_raw()
                live = [o for o in raw if o is not None]
                out_sd.values = (
                    np.unique(np.asarray(live, dtype=object).astype(str))
                    if live else np.array([], dtype=object))
                out_sd._lookup = None
                table = np.array(
                    [0 if o is None else out_sd.code_of(o)
                     for o in raw], dtype=np.int32)
                nt = np.array([o is None for o in raw], dtype=bool)
                return table, nt if nt.any() else None

            out = ir.DictLookup(col, tbl_str, T.VARCHAR, name)
            out.strdict = out_sd
            return out

        raw, errs, first_err = compute_raw()
        if errs == len(raw) and raw and first_err is not None:
            raise first_err
        nulls = np.array([r is None for r in raw], dtype=bool)
        null_table = nulls if nulls.any() else None
        if name in _STR_INT_FUNCS:
            table = np.array([0 if r is None else int(r) for r in raw],
                             dtype=np.int64)
            return ir.DictLookup(col, table, T.BIGINT, name,
                                 null_table=null_table)
        if name in _STR_BOOL_FUNCS:
            table = np.array([bool(r) for r in raw], dtype=bool)
            return ir.DictLookup(col, table, T.BOOLEAN, name,
                                 null_table=null_table)
        if name in _STR_FLOAT_FUNCS:
            table = np.array([np.nan if r is None else r for r in raw],
                             dtype=np.float64)
            return ir.DictLookup(col, table, T.DOUBLE, name,
                                 null_table=null_table)
        # string -> string: build output dictionary (None => SQL NULL)
        return self._string_table(col, raw, name)

    def _string_table(self, col: ir.Expr, outs, label: str) -> ir.Expr:
        """DictLookup mapping col's dictionary codes to new strings;
        None entries become SQL NULL via the lookup's null table."""
        live = [o for o in outs if o is not None]
        new_dict = StringDictionary(
            np.unique(np.asarray(live, dtype=object).astype(str))
            if live else np.array([], dtype=object))
        table = np.array([0 if o is None else new_dict.code_of(o)
                          for o in outs], dtype=np.int32)
        nulls = np.array([o is None for o in outs], dtype=bool)
        out = ir.DictLookup(col, table, T.VARCHAR, label,
                            null_table=nulls if nulls.any() else None)
        out.strdict = new_dict
        return out

    def _const_text(self, c: ir.Const) -> str:
        sd = getattr(c, "strdict", None)
        if sd is not None:
            return str(sd.decode_one(c.value))
        if c.dtype.id == TypeId.BOOLEAN:
            return "true" if c.value else "false"
        return str(T.decode_value(c.value, c.dtype))

    def _null_to_empty(self, col: ir.Expr) -> ir.Expr:
        """Rewrite a VARCHAR expr so NULL rows read as '' (concat()'s
        NULL-skipping semantics; reference: concat vs || operator,
        extension/core_functions/scalar/string/concat.cpp)."""
        sd = col.strdict
        vals = [str(v) for v in sd.values]
        ext = StringDictionary(np.unique(
            np.asarray(vals + [""], dtype=object).astype(str)))
        remap = np.array([ext.code_of(v) for v in vals], dtype=np.int32)
        dl = ir.DictLookup(col, remap, T.VARCHAR, "null_to_empty")
        dl.strdict = ext
        empty = ir.Const(ext.code_of(""), T.VARCHAR)
        empty.strdict = ext
        out = ir.Func("ifnull", [dl, empty], T.VARCHAR)
        out.strdict = ext
        return out

    _CONCAT_CAP = 1 << 22    # max pair-dictionary product per combine

    def _bind_concat(self, e: A.EFunc, scope, agg_ctx, group_map,
                     sub_replacements) -> ir.Expr:
        """concat / || / concat_ws over dictionary-encoded strings.

        Column arguments combine through per-code tables: one column =>
        per-code string table; two columns => pair table indexed by
        code1 * card2 + code2 (capped).  concat() treats NULL inputs as
        '' (and never returns NULL); '||' propagates NULL.  concat_ws
        with NULL column rows approximates DuckDB by treating them as ''
        (separators are not elided per-row)."""
        name = e.name
        b = lambda x: self.bind_expr(x, scope, agg_ctx, group_map,
                                     sub_replacements)
        args = [b(a) for a in e.args]
        sep = ""
        if name == "concat_ws":
            if len(args) < 2:
                raise BindError("concat_ws needs separator + arguments")
            s0 = args.pop(0)
            if not isinstance(s0, ir.Const):
                raise BindError("concat_ws separator must be constant")
            sep = self._const_text(s0)
        null_prop = name == "concat_op"
        parts = []
        for a in args:
            if isinstance(a, ir.Const) and (
                    a.value is None or a.dtype.id == TypeId.NULL):
                if null_prop:
                    return self._bind_literal(None)
                continue
            if isinstance(a, ir.Const):
                parts.append(("const", self._const_text(a)))
            elif a.dtype.id == TypeId.VARCHAR \
                    and getattr(a, "strdict", None) is not None:
                parts.append(("col", a if null_prop
                              else self._null_to_empty(a)))
            else:
                raise BindError(
                    f"concat: cannot stringify {a.dtype!r} argument")
        if not parts:
            return self._bind_literal("")
        acc = parts[0]
        for p in parts[1:]:
            acc = self._concat2(acc, p, sep)
        if acc[0] == "const":
            return self._bind_literal(acc[1])
        return acc[1]

    def _concat2(self, a, b2, sep: str):
        if a[0] == "const" and b2[0] == "const":
            return ("const", a[1] + sep + b2[1])
        if a[0] == "const":
            col = b2[1]
            outs = [a[1] + sep + str(v) for v in col.strdict.values]
            return ("col", self._string_table(col, outs, "concat"))
        if b2[0] == "const":
            col = a[1]
            outs = [str(v) + sep + b2[1] for v in col.strdict.values]
            return ("col", self._string_table(col, outs, "concat"))
        l, r = a[1], b2[1]
        lv = [str(v) for v in l.strdict.values]
        rv = [str(v) for v in r.strdict.values]
        if len(lv) * len(rv) > self._CONCAT_CAP:
            raise BindError("concat: combined dictionary too large")
        outs = [x + sep + y for x in lv for y in rv]
        nd = StringDictionary(
            np.unique(np.asarray(outs, dtype=object).astype(str))
            if outs else np.array([], dtype=object))
        table = np.array([nd.code_of(o) for o in outs], dtype=np.int32)
        out = ir.DictLookup2(l, r, table, max(len(rv), 1), T.VARCHAR,
                             "concat")
        out.strdict = nd
        return ("col", out)

    def _bind_json_keys(self, e: A.EFunc, scope, agg_ctx, group_map,
                        sub_replacements) -> ir.Expr:
        """json_keys(j[, path]) -> LIST(VARCHAR) via per-code list store
        (reference: extension/json json_keys)."""
        from ..expr import jsonfuncs as J
        from ..storage.lists import ListStore
        col = self.bind_expr(e.args[0], scope, agg_ctx, group_map,
                             sub_replacements)
        sd = getattr(col, "strdict", None)
        if col.dtype.id != TypeId.VARCHAR or sd is None:
            raise BindError("json_keys requires a VARCHAR argument")
        path = "$"
        if len(e.args) > 1:
            p = self.bind_expr(e.args[1], scope, None, None,
                               sub_replacements)
            if not isinstance(p, ir.Const):
                raise BindError("json_keys path must be constant")
            psd = getattr(p, "strdict", None)
            path = psd.decode_one(p.value) if psd is not None else p.value
        outs = [J.json_keys(str(v), path) or [] for v in sd.values]
        store = ListStore(outs)
        out = ir.DictLookup(col, np.arange(len(outs), dtype=np.int32),
                            T.LIST(T.VARCHAR), "json_keys")
        out.strdict = store
        return out


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _jaccard(a: str, b: str) -> float:
    sa, sb = set(a), set(b)
    return len(sa & sb) / len(sa | sb) if (sa | sb) else 1.0


def _regexp_extract(s, p, group=0):
    m = __import__("re").search(p, s)
    if not m:
        return ""
    try:
        return m.group(int(group))
    except (IndexError, ValueError):
        return ""


def _split_part(s, sep, n):
    parts = s.split(sep) if sep else [s]
    n = int(n)
    return parts[n - 1] if 1 <= n <= len(parts) else ""


def _str_bin(s):
    return "".join(format(b2, "08b") for b2 in s.encode())


def _jaro(a: str, b: str) -> float:
    if a == b:
        return 1.0
    la, lb = len(a), len(b)
    if not la or not lb:
        return 0.0
    window = max(la, lb) // 2 - 1
    am = [False] * la
    bm = [False] * lb
    matches = 0
    for i, ch in enumerate(a):
        lo, hi = max(0, i - window), min(lb, i + window + 1)
        for j in range(lo, hi):
            if not bm[j] and b[j] == ch:
                am[i] = bm[j] = True
                matches += 1
                break
    if not matches:
        return 0.0
    t = 0
    k = 0
    for i in range(la):
        if am[i]:
            while not bm[k]:
                k += 1
            if a[i] != b[k]:
                t += 1
            k += 1
    t //= 2
    m = float(matches)
    return (m / la + m / lb + (m - t) / m) / 3.0


def _jaro_winkler(a: str, b: str) -> float:
    j = _jaro(a, b)
    if j <= 0.7:
        return j
    pre = 0
    for ca, cb in zip(a[:4], b[:4]):
        if ca != cb:
            break
        pre += 1
    return j + 0.1 * pre * (1.0 - j)


def _hamming(a: str, b: str):
    if len(a) != len(b):
        raise BindError("hamming: strings must be of equal length")
    return sum(ca != cb for ca, cb in zip(a, b))


def _like_to_re(p: str, esc: str):
    import re as _re
    out = []
    i = 0
    while i < len(p):
        c = p[i]
        if esc and c == esc and i + 1 < len(p):
            out.append(_re.escape(p[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(_re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def _like_escape(s, p, esc, nocase):
    import re as _re
    flags = (_re.IGNORECASE if nocase else 0) | _re.DOTALL
    return bool(_re.match(_like_to_re(str(p), str(esc)), s, flags))


def _graphemes(s: str):
    """Approximate grapheme clusters: a base char plus trailing
    combining marks (reference uses full UAX-29 via utf8proc; this
    covers the accent/combining cases the tests exercise)."""
    import unicodedata
    out = []
    for ch in s:
        if out and unicodedata.combining(ch):
            out[-1] += ch
        else:
            out.append(ch)
    return out


def _path_seps(sep) -> str:
    s = str(sep)
    if s in ("both_slash", "default"):
        return "/\\"
    if s == "forward_slash":
        return "/"
    if s == "backslash":
        return "\\"
    return s or "/\\"


def _parse_path(s, sep="both_slash"):
    import re as _re
    seps = _path_seps(sep)
    parts = _re.split("[" + _re.escape(seps) + "]", s)
    out = []
    for i, p in enumerate(parts):
        if p:
            out.append(p)
        elif i == 0:
            out.append(s[0])     # leading separator -> root component
    return out


def _parse_filename(s, trim_extension=False, sep="both_slash"):
    import re as _re
    if isinstance(trim_extension, str):
        sep, trim_extension = trim_extension, False
    seps = _path_seps(sep)
    base = _re.split("[" + _re.escape(seps) + "]", s)[-1]
    if trim_extension and "." in base:
        base = base[:base.rfind(".")]
    return base


def _parse_dirpath(s, sep="both_slash"):
    import re as _re
    seps = _path_seps(sep)
    m = None
    for mm in _re.finditer("[" + _re.escape(seps) + "]", s):
        m = mm
    if m is None:
        return ""
    return s[:m.start()] or s[0]


def _format_bytes_str(v):
    n = float(v)
    units = ["bytes", "KiB", "MiB", "GiB", "TiB", "PiB"]
    i = 0
    while abs(n) >= 1024 and i < len(units) - 1:
        n /= 1024.0
        i += 1
    if i == 0:
        return f"{int(n)} bytes"
    return f"{n:.1f} {units[i]}"



# locale-tailored collations: primary-strength sort-key folds
# (reference: ICU tailored collators, extension/icu/icu_collate.cpp;
# PragmaCollations lists the locales).  'de' ranks umlauts with their
# base letters (DIN 5007-1) and ss for eszett; 'es' ranks n-tilde as a
# distinct letter AFTER n (\x7f sorts past 'z').
def validate_collation(name: str) -> None:
    """Raise BindError for collation names the engine doesn't know
    (CREATE TABLE column collations validate eagerly like the
    reference's binder)."""
    parts = [p[4:] if p.startswith("icu_") else p
             for p in str(name).lower().split(".") if p]
    parts = [p.split("_")[0] if "_" in p
             and p.split("_")[0] in _LOCALE_COLLATIONS else p
             for p in parts]
    bad = [p for p in parts
           if p not in ("nocase", "noaccent", "nfc", "nfd")
           and p not in _LOCALE_COLLATIONS]
    if bad:
        raise BindError(f"unknown collation {bad[0]}")


def _fold_primary(s: str) -> str:
    import unicodedata
    s = s.lower().replace("\u00df", "ss")
    return "".join(ch for ch in unicodedata.normalize("NFD", s)
                   if not unicodedata.combining(ch))


def _fold_es(s: str) -> str:
    import unicodedata
    s = s.lower().replace("\u00f1", "\x00NT\x00")
    s = "".join(ch for ch in unicodedata.normalize("NFD", s)
                if not unicodedata.combining(ch))
    return s.replace("\x00NT\x00", "n\x7f")


def _fold_nfc(s: str) -> str:
    # normalization-only tailoring: compatibility characters (e.g. the
    # Angstrom sign) equal their canonical letters; order stays binary
    import unicodedata
    return unicodedata.normalize("NFC", s.lower())


_LOCALE_COLLATIONS = {
    "de": _fold_primary, "german": _fold_primary,
    "es": _fold_es, "spanish": _fold_es,
    # locales whose tailoring coincides with primary-strength folds
    "en": _fold_primary, "english": _fold_primary,
    "fr": _fold_primary, "french": _fold_primary,
    "it": _fold_primary, "pt": _fold_primary, "nl": _fold_primary,
    # Scandinavian + CJK locales: canonical normalization, binary order
    "da": _fold_nfc, "sv": _fold_nfc, "nb": _fold_nfc, "fi": _fold_nfc,
    "ja": _fold_nfc, "ko": _fold_nfc, "zh": _fold_nfc,
    "ro": _fold_primary, "tr": _fold_primary, "pl": _fold_primary,
    "cs": _fold_primary, "ru": _fold_nfc, "el": _fold_nfc,
    # POSIX/C/binary: codepoint order, no fold
    "c": lambda s: s, "posix": lambda s: s, "binary": lambda s: s,
}


_STR_FUNCS = {
    "substring": lambda s, start, length=None:
        s[start - 1: start - 1 + length] if length is not None
        else s[start - 1:],
    "substr": lambda s, start, length=None:
        s[start - 1: start - 1 + length] if length is not None
        else s[start - 1:],
    "upper": lambda s: s.upper(),
    "ucase": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "lcase": lambda s: s.lower(),
    "trim": lambda s: s.strip(),
    "ltrim": lambda s: s.lstrip(),
    "rtrim": lambda s: s.rstrip(),
    "length": lambda s: len(s),
    "char_length": lambda s: len(s),
    "character_length": lambda s: len(s),
    "strlen": lambda s: len(s),
    "bit_length": lambda s: 8 * len(s.encode()),
    "octet_length": lambda s: len(s.encode()),
    "reverse": lambda s: s[::-1],
    "starts_with": lambda s, p: s.startswith(p),
    "prefix": lambda s, p: s.startswith(p),
    "ends_with": lambda s, p: s.endswith(p),
    "suffix": lambda s, p: s.endswith(p),
    "contains": lambda s, p: p in s,
    "regexp_matches": lambda s, p: bool(__import__("re").search(p, s)),
    "regexp_full_match": lambda s, p:
        bool(__import__("re").fullmatch(p, s)),
    "regexp_replace": lambda s, p, r2:
        __import__("re").sub(p, r2, s, count=1),
    "regexp_extract": _regexp_extract,
    "replace": lambda s, a, b2: s.replace(a, b2),
    # reference: extension/core_functions/scalar/string/*
    "left": lambda s, n: s[:int(n)] if n >= 0 else s[:len(s) + int(n)],
    "right": lambda s, n: (s[-int(n):] if n > 0 else
                           s[min(-int(n), len(s)):]),
    "lpad": lambda s, n, p=" ":
        (p * n)[:max(int(n) - len(s), 0)] + s if len(s) < n else s[:int(n)],
    "rpad": lambda s, n, p=" ":
        s + (p * n)[:max(int(n) - len(s), 0)] if len(s) < n else s[:int(n)],
    "repeat": lambda s, n: s * max(int(n), 0),
    "ascii": lambda s: ord(s[0]) if s else 0,
    "instr": lambda s, p: s.find(p) + 1,
    "strpos": lambda s, p: s.find(p) + 1,
    "position": lambda s, p: s.find(p) + 1,
    "levenshtein": _levenshtein,
    "editdist3": _levenshtein,
    "damerau_levenshtein": _levenshtein,
    "jaccard": _jaccard,
    "split_part": _split_part,
    "translate": lambda s, frm, to:
        s.translate(str.maketrans(frm[:len(to)], to[:len(frm)])),
    "initcap": lambda s: s[:1].upper() + s[1:].lower(),
    "title": lambda s: s.title(),
    "md5": lambda s:
        __import__("hashlib").md5(s.encode()).hexdigest(),
    "sha256": lambda s:
        __import__("hashlib").sha256(s.encode()).hexdigest(),
    "hash": lambda s:
        int.from_bytes(__import__("hashlib").md5(
            s.encode()).digest()[:8], "little") >> 1,
    "nfc_normalize": lambda s:
        __import__("unicodedata").normalize("NFC", s),
    "strip_accents": lambda s: "".join(
        c for c in __import__("unicodedata").normalize("NFD", s)
        if not __import__("unicodedata").combining(c)),
    # ---- round-4 additions (reference: core_functions/scalar/string) --
    "ord": lambda s: ord(s[0]) if s else 0,
    "unicode": lambda s: ord(s[0]) if s else -1,
    "hex": lambda s: s.encode().hex().upper(),
    "to_hex": lambda s: s.encode().hex().upper(),
    "unhex": lambda s: bytes.fromhex(s).decode("utf-8", "replace"),
    "from_hex": lambda s: bytes.fromhex(s).decode("utf-8", "replace"),
    "bin": _str_bin,
    "to_binary": _str_bin,
    "unbin": lambda s: "".join(
        chr(int(s[i:i + 8], 2)) for i in range(0, len(s), 8)),
    "base64": lambda s:
        __import__("base64").b64encode(s.encode()).decode(),
    "from_base64": lambda s:
        __import__("base64").b64decode(s.encode()).decode(
            "utf-8", "replace"),
    "url_encode": lambda s:
        __import__("urllib.parse", fromlist=["quote"]).quote(
            s, safe=""),
    "url_decode": lambda s:
        __import__("urllib.parse", fromlist=["unquote"]).unquote(s),
    "regexp_escape": lambda s: __import__("re").escape(s),
    "sha1": lambda s:
        __import__("hashlib").sha1(s.encode()).hexdigest(),
    "jaro_similarity": _jaro,
    "jaro_winkler_similarity": _jaro_winkler,
    "hamming": _hamming,
    "mismatches": _hamming,
    "like_escape": lambda s, p, esc: _like_escape(s, p, esc, False),
    "ilike_escape": lambda s, p, esc: _like_escape(s, p, esc, True),
    "not_like_escape": lambda s, p, esc:
        not _like_escape(s, p, esc, False),
    "not_ilike_escape": lambda s, p, esc:
        not _like_escape(s, p, esc, True),
    "left_grapheme": lambda s, n: "".join(_graphemes(s)[:int(n)]),
    "right_grapheme": lambda s, n:
        "".join(_graphemes(s)[-int(n):] if n > 0 else []),
    "length_grapheme": lambda s: len(_graphemes(s)),
    "substring_grapheme": lambda s, start, length=None: "".join(
        _graphemes(s)[start - 1: start - 1 + length]
        if length is not None else _graphemes(s)[start - 1:]),
    "parse_filename": _parse_filename,
    "parse_dirname": lambda s, sep="both_slash": (
        _parse_path(s, sep)[-2] if len(_parse_path(s, sep)) > 1
        else (_parse_path(s, sep)[0] if _parse_path(s, sep) else "")),
    "parse_dirpath": _parse_dirpath,
}


def _int_hex(v, upper=True):
    u = v & 0xFFFFFFFFFFFFFFFF if v < 0 else v
    s = format(u, "X")
    return s


def _int_bin(v):
    u = v & 0xFFFFFFFFFFFFFFFF if v < 0 else v
    return format(u, "b")


def _to_base(v, radix, minlen=0):
    if radix < 2 or radix > 36:
        raise BindError("to_base radix must be between 2 and 36")
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    u = v & 0xFFFFFFFFFFFFFFFF if v < 0 else v
    out = ""
    while u:
        out = digits[u % radix] + out
        u //= radix
    out = out or "0"
    return out.rjust(int(minlen), "0")


def _format_bytes_decimal(v):
    n = float(v)
    units = ["bytes", "kB", "MB", "GB", "TB", "PB"]
    i = 0
    while abs(n) >= 1000 and i < len(units) - 1:
        n /= 1000.0
        i += 1
    if i == 0:
        return f"{int(n)} bytes"
    return f"{n:.1f} {units[i]}"


# int-argument -> VARCHAR functions (bounded-domain stringify tables)
_INT_STR_FUNCS = {
    "chr": lambda v: chr(v),
    "format_bytes": _format_bytes_str,
    "formatreadablesize": _format_bytes_str,
    "formatreadabledecimalsize": _format_bytes_decimal,
    "hex": _int_hex,
    "to_hex": _int_hex,
    "bin": _int_bin,
    "to_binary": _int_bin,
    "to_base": _to_base,
}

# JSON extension parity (reference: extension/json/json_functions/) —
# host-evaluated over dictionary values, gathered on device.
from ..expr import jsonfuncs as _J  # noqa: E402

_STR_FUNCS.update({
    "json_extract": _J.json_extract,
    "json_extract_path": _J.json_extract,
    "json_extract_string": _J.json_extract_string,
    "json_extract_path_text": _J.json_extract_string,
    "json_value": _J.json_value,
    "json_type": _J.json_type,
    "json_typeof": _J.json_type,
    "json_structure": _J.json_structure,
    "json_merge_patch": _J.json_merge_patch,
    "to_json": _J.to_json,
    "json_quote": _J.to_json,
    "json_array_length": _J.json_array_length,
    "json_valid": _J.json_valid,
    "json_contains": _J.json_contains,
})

_STR_INT_FUNCS = {"length", "char_length", "character_length", "strlen",
                  "bit_length", "octet_length", "ascii", "instr",
                  "strpos", "position", "levenshtein", "editdist3",
                  "damerau_levenshtein", "hash", "json_array_length",
                  "ord", "unicode", "hamming", "mismatches",
                  "length_grapheme"}
_STR_BOOL_FUNCS = {"starts_with", "prefix", "contains", "suffix",
                   "ends_with", "regexp_matches", "regexp_full_match",
                   "json_valid", "json_contains", "like_escape",
                   "ilike_escape", "not_like_escape",
                   "not_ilike_escape"}
_STR_FLOAT_FUNCS = {"jaccard", "jaro_similarity",
                    "jaro_winkler_similarity"}


# ---------------------------------------------------------------------------
# AST utilities
# ---------------------------------------------------------------------------

def _ast_children(e: A.EExpr):
    if isinstance(e, A.EBinary):
        return [e.left, e.right]
    if isinstance(e, A.EUnary):
        return [e.child]
    if isinstance(e, A.EFunc):
        return list(e.args)
    if isinstance(e, A.ECase):
        out = []
        if e.operand:
            out.append(e.operand)
        for c, v in e.whens:
            out += [c, v]
        if e.else_:
            out.append(e.else_)
        return out
    if isinstance(e, A.ECast):
        return [e.child]
    if isinstance(e, A.EBetween):
        return [e.child, e.lo, e.hi]
    if isinstance(e, (A.EIsNull,)):
        return [e.child]
    if isinstance(e, A.ELike):
        return [e.child, e.pattern]
    if isinstance(e, A.EIn):
        return [e.child] + (e.items or [])
    return []


def _ast_equal(a: A.EExpr, b: A.EExpr) -> bool:
    return repr(a) == repr(b)


def _walk_ast_objects(obj, seen=None):
    """Generic deep walk over AST dataclasses (lists/tuples/fields)."""
    if seen is None:
        seen = set()
    if isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _walk_ast_objects(x, seen)
        return
    if not hasattr(obj, "__dataclass_fields__") or id(obj) in seen:
        return
    seen.add(id(obj))
    yield obj
    for f in obj.__dataclass_fields__:
        yield from _walk_ast_objects(getattr(obj, f, None), seen)


def _count_cte_refs(stmt: A.SelectStmt, cdef: "A.CTEDef") -> int:
    """How many FROM references in `stmt` (including subqueries and other
    CTE bodies, excluding the CTE's own definition) name this CTE."""
    name = cdef.name.lower()
    skip = set()
    for o in _walk_ast_objects(getattr(cdef, "select", None)):
        skip.add(id(o))
    n = 0
    for o in _walk_ast_objects(stmt):
        if id(o) in skip:
            continue
        if isinstance(o, A.RBase) and o.name.lower() == name:
            n += 1
    return n


def ir_conjuncts_ast(e: Optional[A.EExpr]) -> List[A.EExpr]:
    if e is None:
        return []
    if isinstance(e, A.EBinary) and e.op == "and":
        return ir_conjuncts_ast(e.left) + ir_conjuncts_ast(e.right)
    f = _factor_or(e)
    if f is not None:
        return ir_conjuncts_ast(f)
    return [e]


def _or_branches(e: A.EExpr) -> List[A.EExpr]:
    if isinstance(e, A.EBinary) and e.op == "or":
        return _or_branches(e.left) + _or_branches(e.right)
    return [e]


def _factor_or(e: A.EExpr) -> Optional[A.EExpr]:
    """(A AND X) OR (A AND Y) -> A AND (X OR Y): factor conjuncts common
    to every OR branch (reference: expression rewriter common-subexpression
    rules, src/optimizer/rule/).  Crucial for correlated subqueries whose
    correlation equality repeats under an OR (TPC-DS q41)."""
    if not (isinstance(e, A.EBinary) and e.op == "or"):
        return None
    branches = [ir_conjuncts_ast(b) for b in _or_branches(e)]
    if len(branches) < 2:
        return None
    common = [c for c in branches[0]
              if all(any(_ast_equal(c, d) for d in b)
                     for b in branches[1:])]
    if not common:
        return None
    rests = []
    for b in branches:
        rest = [c for c in b
                if not any(_ast_equal(c, cc) for cc in common)]
        if not rest:
            # one branch reduces to the common part alone: the OR of the
            # remainders is vacuously true, the whole expr = AND(common)
            rests = None
            break
        r = rest[0]
        for c in rest[1:]:
            r = A.EBinary("and", r, c)
        rests.append(r)
    out = None
    for c in common:
        out = c if out is None else A.EBinary("and", out, c)
    if rests is not None:
        disj = rests[0]
        for r in rests[1:]:
            disj = A.EBinary("or", disj, r)
        out = A.EBinary("and", out, disj)
    return out


def _contains_scalar_sub(e: A.EExpr) -> bool:
    if isinstance(e, A.ESub):
        return True
    return any(_contains_scalar_sub(c) for c in _ast_children(e))


def _collect_scalar_subs(e: A.EExpr, out: List[A.ESub]):
    if isinstance(e, A.ESub):
        out.append(e)
        return
    for c in _ast_children(e):
        _collect_scalar_subs(c, out)


def _contains_mark_sub(e: A.EExpr) -> bool:
    """EXISTS / IN-subquery anywhere below the top level (inside OR,
    CASE, NOT, ...) — planned as a MARK join."""
    if isinstance(e, A.EExists):
        return True
    if isinstance(e, A.EIn) and e.subquery is not None:
        return True
    return any(_contains_mark_sub(c) for c in _ast_children(e))


def _collect_mark_subs(e: A.EExpr, out: list):
    if isinstance(e, A.EExists) or (isinstance(e, A.EIn)
                                    and e.subquery is not None):
        out.append(e)
        return
    for c in _ast_children(e):
        _collect_mark_subs(c, out)



def _subst_item_aliases(e, items):
    """Replace bare identifiers matching a select-item alias with that
    item's expression (QUALIFY may reference output aliases, reference:
    bind_select_node.cpp qualify alias binding)."""
    import copy as _copy
    if isinstance(e, A.EIdent) and len(e.parts) == 1:
        for ie, alias in items:
            if alias and alias.lower() == e.parts[0].lower():
                return _copy.deepcopy(ie)
    for attr in ("child", "left", "right", "pattern", "lo", "hi",
                 "index"):
        if hasattr(e, attr) and isinstance(getattr(e, attr), A.EExpr):
            setattr(e, attr, _subst_item_aliases(getattr(e, attr), items))
    if hasattr(e, "args"):
        e.args = [_subst_item_aliases(a, items)
                  if isinstance(a, A.EExpr) else a for a in e.args]
    return e


def _contains_window(e: A.EExpr) -> bool:
    if isinstance(e, A.EWindow):
        return True
    for c in _ast_children(e):
        if _contains_window(c):
            return True
    return False


def _resolve_winrefs(e: ir.Expr, base: int) -> ir.Expr:
    import copy
    if isinstance(e, WinRef):
        return ir.ColRef(base + e.index, e.dtype, f"__w{e.index}",
                         e.strdict)
    c = copy.copy(e)
    if isinstance(e, ir.Case):
        c.whens = [(_resolve_winrefs(w, base), _resolve_winrefs(v, base))
                   for w, v in e.whens]
        c.else_ = _resolve_winrefs(e.else_, base)
        return c
    for attr in ("child", "left", "right"):
        if hasattr(e, attr):
            setattr(c, attr, _resolve_winrefs(getattr(e, attr), base))
    if hasattr(e, "args") and not isinstance(e, ir.Case):
        c.args = tuple(_resolve_winrefs(a, base) for a in e.args)
    return c


def _resolve_grouprefs(e: ir.Expr, mask_col, ngroups: int) -> ir.Expr:
    """Rewrite GroupingRef placeholders: bit tests over the grouping-set
    mask column (plain GROUP BY: constant 0)."""
    import copy
    if isinstance(e, GroupingRef):
        if mask_col is None:
            return ir.Const(0, T.BIGINT)
        out = None
        for i in e.indices:
            shift = 1 << (ngroups - 1 - i)
            bit = ir.Arith("%",
                           ir.Arith("//", mask_col,
                                    ir.Const(shift, T.BIGINT), T.BIGINT),
                           ir.Const(2, T.BIGINT), T.BIGINT)
            out = bit if out is None \
                else ir.Arith("+", ir.Arith("*", out,
                                            ir.Const(2, T.BIGINT),
                                            T.BIGINT), bit, T.BIGINT)
        return out
    c = copy.copy(e)
    if isinstance(e, ir.Case):
        c.whens = [(_resolve_grouprefs(w, mask_col, ngroups),
                    _resolve_grouprefs(v, mask_col, ngroups))
                   for w, v in e.whens]
        c.else_ = _resolve_grouprefs(e.else_, mask_col, ngroups)
        return c
    for attr in ("child", "left", "right"):
        if hasattr(e, attr):
            setattr(c, attr,
                    _resolve_grouprefs(getattr(e, attr), mask_col,
                                       ngroups))
    if hasattr(e, "args") and not isinstance(e, ir.Case):
        c.args = tuple(_resolve_grouprefs(a, mask_col, ngroups)
                       for a in e.args)
    return c


def _resolve_aggrefs(e: ir.Expr, ngroups: int) -> ir.Expr:
    """Rewrite AggRef placeholders into ColRefs over aggregate output."""
    import copy
    if isinstance(e, AggRef):
        return ir.ColRef(ngroups + e.index, e.dtype, f"__a{e.index}",
                         e.strdict)
    c = copy.copy(e)
    if isinstance(e, ir.Case):
        c.whens = [(_resolve_aggrefs(w, ngroups),
                    _resolve_aggrefs(v, ngroups)) for w, v in e.whens]
        c.else_ = _resolve_aggrefs(e.else_, ngroups)
        return c
    for attr in ("child", "left", "right"):
        if hasattr(e, attr):
            setattr(c, attr, _resolve_aggrefs(getattr(e, attr), ngroups))
    if hasattr(e, "args") and not isinstance(e, ir.Case):
        c.args = tuple(_resolve_aggrefs(a, ngroups) for a in e.args)
    return c


def _scope_of_plan(plan: L.LogicalNode, base_scope: Scope) -> Scope:
    """Scope covering a plan whose prefix columns match base_scope and
    whose suffix columns (from flattened subqueries) bind positionally."""
    sc = Scope()
    for e in base_scope.entries:
        sc.add(e.alias, e.schema)
    extra = len(plan.schema) - sc.width
    if extra > 0:
        fs = plan.schema.fields[-extra:]
        sc.add("__sub", Schema(tuple(fs)))
    return sc


def _apply_list_lambda(kind, lst, ps, body, LE):
    """Apply a transform/filter/reduce lambda to one python list."""
    if lst is None:
        return None
    if kind == "transform":
        out = []
        for i, x in enumerate(lst):
            env = {ps[0]: x}
            if len(ps) > 1:
                env[ps[1]] = i + 1
            out.append(LE.evaluate(body, env))
        return out
    if kind == "filter":
        out = []
        for i, x in enumerate(lst):
            env = {ps[0]: x}
            if len(ps) > 1:
                env[ps[1]] = i + 1
            if LE.evaluate(body, env) is True:
                out.append(x)
        return out
    # reduce: duckdb seeds with the first element, errors on empty
    if not lst:
        raise LE.LambdaError("list_reduce on an empty list")
    acc = lst[0]
    for i, x in enumerate(lst[1:], start=2):
        env = {ps[0]: acc, ps[1]: x}
        if len(ps) > 2:
            env[ps[2]] = i
        acc = LE.evaluate(body, env)
    return acc


def _strftime_raw(raw: int, dtype: DataType, fmt: str) -> str:
    """duckdb-style strftime of one raw temporal value (reference:
    src/common/types/strftime.cpp; %-X = non-padded variants)."""
    import datetime as _dt
    if dtype.id == TypeId.DATE:
        v = _dt.date(1970, 1, 1) + _dt.timedelta(days=raw)
    else:
        v = _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=raw)
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch != "%":
            out.append(ch)
            i += 1
            continue
        spec = fmt[i + 1:i + 2]
        dash = spec == "-"
        if dash:
            spec = fmt[i + 2:i + 3]
            i += 1
        i += 2
        if spec == "%":
            out.append("%")
        elif spec == "f":
            out.append("%06d" % getattr(v, "microsecond", 0))
        elif spec == "g":
            out.append(("%06d" % getattr(v, "microsecond", 0))[:3])
        elif spec == "n":
            out.append("%09d" % (getattr(v, "microsecond", 0) * 1000))
        else:
            try:
                s2 = v.strftime("%" + spec)
            except ValueError:
                s2 = "%" + spec
            if dash:
                s2 = s2.lstrip("0") or "0"
            out.append(s2)
    return "".join(out)


_INT_LIMITS = {TypeId.TINYINT: 127, TypeId.SMALLINT: 32767,
               TypeId.INTEGER: 2 ** 31 - 1, TypeId.BIGINT: 2 ** 63 - 1,
               TypeId.HUGEINT: 2 ** 127 - 1}


def text_to_nested(atom, tgt: DataType, try_: bool = False,
                   timetz_raw=None):
    """One parsed atom -> python value of type tgt (recursive).
    TRY_CAST semantics push into ELEMENTS: a bad element becomes NULL
    while the row survives (reference: VectorStringToList/ToStruct/
    ToMap element casts with error vectors)."""
    from ..expr import nestedtext as NT
    if atom is None:
        return None
    if isinstance(atom, tuple):
        text, _quoted = atom
    else:
        text = str(atom)
    if tgt.id == TypeId.VARCHAR:
        return text
    if tgt.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP):
        try:
            if tgt.id == TypeId.LIST:
                return [text_to_nested(x, tgt.child, try_, timetz_raw)
                        for x in NT.split_list(text)]
            if tgt.id == TypeId.STRUCT:
                from ..storage.nested import StructValue
                fields = tgt.children or ()
                got = {}
                for (k, kq), v in NT.split_pairs(text, ":"):
                    # quoted keys keep exact spelling incl. spaces
                    got[(k if kq else k.strip()).lower()] = v
                known = {n.lower() for n, _t in fields}
                for k in got:
                    if k not in known:
                        raise NT.NestedTextError(
                            f"unknown struct key '{k}'")
                return StructValue(
                    (n, text_to_nested(got.get(n.lower()), t, try_,
                                       timetz_raw))
                    for n, t in fields)
            return [(text_to_nested((k, kq), tgt.child, try_,
                                    timetz_raw),
                     text_to_nested(v, tgt.child2, try_, timetz_raw))
                    for (k, kq), v in NT.split_pairs(text, "=")]
        except NT.NestedTextError:
            # TRY_CAST: an unparsable NESTED element becomes NULL
            # while siblings survive (reference: error vectors in
            # VectorStringToList/ToStruct)
            if try_:
                return None
            raise
    try:
        if tgt.id == TypeId.BOOLEAN:
            return _parse_text(text, tgt)
        raw = timetz_raw(text) if tgt.id == TypeId.TIMETZ \
            and timetz_raw is not None else _parse_text(text, tgt)
        lim = _INT_LIMITS.get(tgt.id)
        if lim is not None and not -lim - 1 <= raw <= lim:
            raise OverflowError(raw)
        return T.decode_value(raw, tgt)
    except (ValueError, OverflowError, decimal.InvalidOperation):
        if try_:
            return None
        raise


def _parse_text(text: str, tgt: DataType):
    """Parse one string to the raw physical value of tgt (reference:
    TryCast string parsers, src/common/operator/cast_operators.cpp).
    Raises ValueError / decimal.InvalidOperation on unparsable input."""
    import datetime
    if tgt.id == TypeId.BOOLEAN:
        low = text.lower()
        if low in ("true", "t", "yes", "y", "1"):
            return True
        if low in ("false", "f", "no", "n", "0"):
            return False
        raise ValueError(text)
    if tgt.is_integer:
        try:
            return int(text)
        except ValueError:
            low = text.strip().lower()
            if low.startswith(("0x", "0b")):
                # hex/binary literals — unsigned only (reference:
                # TryCast radix prefixes, cast_operators.cpp)
                return int(low, 0)
            # DuckDB rounds decimal strings half away from zero
            d = decimal.Decimal(text)
            return int(d.to_integral_value(
                rounding=decimal.ROUND_HALF_UP))
    if tgt.id == TypeId.DECIMAL:
        d = decimal.Decimal(text).scaleb(tgt.scale)
        return int(d.to_integral_value(rounding=decimal.ROUND_HALF_UP))
    if tgt.id in (TypeId.FLOAT, TypeId.DOUBLE):
        return float(text)
    if tgt.id == TypeId.DATE:
        sp = T.temporal_special(text, tgt)
        if sp is not None:
            return sp
        d = datetime.date.fromisoformat(text)
        return (d - datetime.date(1970, 1, 1)).days
    if tgt.id == TypeId.TIMESTAMP:
        sp = T.temporal_special(text, tgt)
        if sp is not None:
            return sp
        dt = datetime.datetime.fromisoformat(text)
        epoch = datetime.datetime(1970, 1, 1)
        return T.td_micros(dt - epoch)
    if tgt.id == TypeId.TIMESTAMPTZ:
        sp = T.temporal_special(text, tgt)
        if sp is not None:
            return sp
        from .. import tz as tzmod
        return tzmod.parse_timestamptz(text, "UTC")
    if tgt.id == TypeId.TIME:
        wall, _off = T.parse_time_text(text)
        return wall
    if tgt.id == TypeId.TIMETZ:
        return T.parse_timetz_text(text)
    raise ValueError(f"unsupported cast target {tgt}")


# ---------------------------------------------------------------------------
# recursive-CTE host fixpoint helpers
# ---------------------------------------------------------------------------

def _host_stringify(raw, dtype: DataType, strdict) -> str:
    """Physical value -> DuckDB cast-to-VARCHAR text (reference:
    src/common/operator/string_cast.cpp)."""
    return T.stringify_value(raw, dtype, strdict)


def _host_coerce(d: np.ndarray, nulls, f: Field, target: DataType) -> list:
    """One materialized column -> python values coerced to the anchor
    type (strings for VARCHAR targets, physical scalars otherwise)."""
    st = f.dtype
    n = len(d)
    if nulls is None:
        nulls = np.zeros(n, dtype=bool)
    out = []
    if target.id == TypeId.VARCHAR:
        for i in range(n):
            if nulls[i] or st.id == TypeId.NULL:
                out.append(None)
            elif st.id == TypeId.VARCHAR:
                out.append(f.strdict.decode_one(int(d[i])))
            else:
                out.append(_host_stringify(d[i], st, f.strdict))
        return out
    for i in range(n):
        if nulls[i] or st.id == TypeId.NULL:
            out.append(None)
            continue
        v = d[i]
        if st == target:
            out.append(v.item() if hasattr(v, "item") else v)
        elif target.id == TypeId.DECIMAL:
            ss = st.scale if st.id == TypeId.DECIMAL else 0
            iv = int(round(float(v) * 10 ** ss)) \
                if st.id in (TypeId.FLOAT, TypeId.DOUBLE) else int(v)
            if target.scale >= ss:
                out.append(iv * 10 ** (target.scale - ss))
            else:
                q = 10 ** (ss - target.scale)
                out.append((iv + (q // 2 if iv >= 0 else -(q // 2))) // q)
        elif target.id in (TypeId.FLOAT, TypeId.DOUBLE):
            if st.id == TypeId.DECIMAL:
                out.append(float(v) / 10 ** st.scale)
            else:
                out.append(float(v))
        elif target.id == TypeId.TIMESTAMP and st.id == TypeId.DATE:
            out.append(int(v) * 86_400_000_000)
        elif target.is_integer or target.id in (TypeId.DATE, TypeId.TIME,
                                                TypeId.TIMESTAMP):
            if st.id == TypeId.DECIMAL:
                q = 10 ** st.scale
                iv = int(v)
                out.append((iv + (q // 2 if iv >= 0 else -(q // 2))) // q)
            else:
                out.append(int(round(float(v))))
        elif target.id == TypeId.BOOLEAN:
            out.append(bool(v))
        else:
            out.append(v.item() if hasattr(v, "item") else v)
    return out


def _tabledata_from_rows(name: str, tfields, rows):
    """Build a TableData from host row tuples typed by tfields."""
    from ..storage.table import TableColumn, TableData
    cols = []
    for j, f in enumerate(tfields):
        vals = [r[j] for r in rows]
        if f.dtype.id == TypeId.VARCHAR:
            sd, codes, nulls = StringDictionary.encode(vals)
            cols.append(TableColumn(f.name, f.dtype, codes,
                                    nulls if nulls.any() else None, sd))
        else:
            nulls = np.array([v is None for v in vals], dtype=bool)
            data = np.array([0 if v is None else v for v in vals],
                            dtype=f.dtype.np_dtype)
            cols.append(TableColumn(f.name, f.dtype, data,
                                    nulls if nulls.any() else None))
    return TableData(name, cols)


def _rows_to_table(name, rows, cols):
    """Python row tuples + declared (name, DataType) columns ->
    TableData (user table functions, C table-function trampolines)."""
    from ..storage.strings import StringDictionary
    from ..storage.table import TableColumn, TableData

    out = []
    for j, (cn, ct) in enumerate(cols):
        vals = [r[j] if j < len(r) else None for r in rows]
        nulls = np.array([v is None for v in vals], dtype=bool)
        if ct.id == TypeId.VARCHAR:
            sd, codes, n2 = StringDictionary.encode(
                [None if v is None else str(v) for v in vals])
            out.append(TableColumn(cn, ct, codes,
                                   nulls if nulls.any() else None,
                                   strdict=sd))
            continue
        data = np.array([0 if v is None else T.encode_literal(v, ct)
                         for v in vals], dtype=ct.np_dtype)
        out.append(TableColumn(cn, ct, data,
                               nulls if nulls.any() else None))
    return TableData(f"__tf_{name}", out)


# round-5 breadth batch (reference: extension/core_functions/ function
# names still missing after r4; see docs/PARITY.md)
_R5_BREADTH_FNS = {
    "enum_code", "enum_first", "enum_last", "enum_range",
    "enum_range_boundary", "encode", "decode", "getvariable", "list_pack", "unpivot_list", "get_current_timestamp",
    "transaction_timestamp", "bit_count", "age", "date_diff",
    "date_sub", "current_schemas", "in_search_path",
    "to_years", "to_months", "to_quarters", "to_decades",
    "to_centuries", "to_millennia", "to_days", "to_weeks", "to_hours",
    "to_minutes", "to_seconds", "to_milliseconds", "to_microseconds",
    "list_zip", "list_select", "list_has_all", "list_has_any",
    "list_distance", "list_cosine_similarity", "list_cosine_distance",
    "list_dot_product", "list_negative_dot_product", "list_grade_up",
    "list_resize", "list_concat", "list_aggregate", "list_aggr",
    "map_entries", "map_from_entries", "map_extract_value",
    "map_concat", "struct_concat", "struct_extract_at",
    "struct_insert", "bar", "alias",
}

_TO_IV_MONTHS = {"to_years": 12, "to_months": 1, "to_quarters": 3,
                 "to_decades": 120, "to_centuries": 1200,
                 "to_millennia": 12000}
_TO_IV_US = {"to_days": 86_400_000_000, "to_weeks": 7 * 86_400_000_000,
             "to_hours": 3_600_000_000, "to_minutes": 60_000_000,
             "to_seconds": 1_000_000, "to_milliseconds": 1_000,
             "to_microseconds": 1}

# date_diff parts -> truncation-boundary counters
_DD_MONTH_PARTS = {"year": 12, "quarter": 3, "month": 1,
                   "decade": 120, "century": 1200, "millennium": 12000}
_DD_US_PARTS = {"day": 86_400_000_000, "week": 7 * 86_400_000_000,
                "hour": 3_600_000_000, "minute": 60_000_000,
                "second": 1_000_000, "millisecond": 1_000,
                "microsecond": 1}


def _breadth_impl():
    """Late-bound host implementations for the multi-list/map/struct
    functions (row-wise over the nested stores)."""
    import math

    def zip_rows(lists):
        mx = max((len(x) for x in lists if x is not None), default=0)
        out = []
        for i in range(mx):
            out.append({f"list_{j + 1}":
                        (lst[i] if lst is not None and i < len(lst)
                         else None)
                        for j, lst in enumerate(lists)})
        return out

    def dist(a, b, kind):
        if a is None or b is None:
            return None
        if len(a) != len(b):
            raise ValueError("list dimensions must match")
        va = [0.0 if x is None else float(x) for x in a]
        vb = [0.0 if x is None else float(x) for x in b]
        dot = sum(x * y for x, y in zip(va, vb))
        if kind == "dot":
            return dot
        if kind == "ndot":
            return -dot
        if kind == "dist":
            return math.sqrt(sum((x - y) ** 2
                                 for x, y in zip(va, vb)))
        na = math.sqrt(sum(x * x for x in va))
        nb = math.sqrt(sum(x * x for x in vb))
        cos = dot / (na * nb) if na and nb else float("nan")
        return cos if kind == "cos" else 1.0 - cos

    def aggregate(lst, how):
        vals = [x for x in lst if x is not None]
        how = how.lower()
        if how == "count":
            return len(vals)
        if not vals:
            return None
        if how in ("sum",):
            return sum(vals)
        if how in ("min",):
            return min(vals)
        if how in ("max",):
            return max(vals)
        if how in ("avg", "mean"):
            return sum(float(v) for v in vals) / len(vals)
        if how in ("first", "any_value"):
            return vals[0]
        if how == "last":
            return vals[-1]
        if how == "string_agg":
            return ",".join(str(v) for v in vals)
        raise ValueError(f"list_aggregate: unsupported {how}")

    return {"zip_rows": zip_rows, "dist": dist, "aggregate": aggregate}

"""Lazy Relation (dataframe) API.

Parity target: the reference's Relation classes
(reference: src/main/relation/*.cpp, 21 node types;
src/include/duckdb/main/relation.hpp:59).  Design: relations compose
lazily as SQL query fragments; nothing executes until a materializing
method (fetchall/df/arrow/count/execute/create/insert_into) runs, at
which point the whole tree lowers through the normal
parse->bind->optimize->execute pipeline as ONE query — so the optimizer
sees the full tree exactly like the reference's relation-to-plan
binding does.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence

_ALIAS_COUNTER = itertools.count(1)


def _q(name: str) -> str:
    """Quote an identifier when needed."""
    if name.replace("_", "").isalnum() and not name[0].isdigit():
        return name
    return '"' + name.replace('"', '""') + '"'


class Relation:
    """A lazily-evaluated query fragment (reference: Relation,
    src/include/duckdb/main/relation.hpp)."""

    def __init__(self, con, sql: str, alias: Optional[str] = None):
        self._con = con
        self._sql = sql
        self.alias = alias or f"rel{next(_ALIAS_COUNTER):02d}"

    # ---- composition ----------------------------------------------------
    def _wrap(self, sql: str, alias: Optional[str] = None) -> "Relation":
        return Relation(self._con, sql, alias)

    def _sub(self) -> str:
        return f"({self._sql}) {_q(self.alias)}"

    def set_alias(self, alias: str) -> "Relation":
        """reference: Relation::Alias (subquery_relation.cpp)"""
        return Relation(self._con, self._sql, alias)

    def filter(self, condition: str) -> "Relation":
        """reference: FilterRelation (src/main/relation/filter_relation.cpp)"""
        return self._wrap(
            f"SELECT * FROM {self._sub()} WHERE {condition}")

    where = filter

    def project(self, *exprs: str) -> "Relation":
        """reference: ProjectionRelation (projection_relation.cpp)"""
        cols = ", ".join(exprs) if exprs else "*"
        return self._wrap(f"SELECT {cols} FROM {self._sub()}")

    select = project

    def aggregate(self, aggr_expr: str,
                  group_expr: str = "") -> "Relation":
        """reference: AggregateRelation (aggregate_relation.cpp)"""
        sql = f"SELECT {aggr_expr} FROM {self._sub()}"
        if group_expr:
            sql += f" GROUP BY {group_expr}"
        return self._wrap(sql)

    agg = aggregate

    def order(self, order_expr: str) -> "Relation":
        """reference: OrderRelation (order_relation.cpp)"""
        return self._wrap(
            f"SELECT * FROM {self._sub()} ORDER BY {order_expr}")

    sort = order

    def limit(self, n: int, offset: int = 0) -> "Relation":
        """reference: LimitRelation (limit_relation.cpp)"""
        sql = f"SELECT * FROM {self._sub()} LIMIT {int(n)}"
        if offset:
            sql += f" OFFSET {int(offset)}"
        return self._wrap(sql)

    def distinct(self) -> "Relation":
        """reference: DistinctRelation (distinct_relation.cpp)"""
        return self._wrap(f"SELECT DISTINCT * FROM {self._sub()}")

    def join(self, other: "Relation", condition: str,
             how: str = "inner") -> "Relation":
        """reference: JoinRelation (join_relation.cpp).  `condition` is
        either an ON expression or a comma list of USING columns."""
        how = how.upper()
        if how not in ("INNER", "LEFT", "RIGHT", "OUTER", "FULL",
                       "SEMI", "ANTI", "CROSS"):
            raise ValueError(f"unsupported join type {how}")
        if how == "OUTER":
            how = "FULL"
        l, r = self._sub(), other._sub()
        if how == "CROSS":
            return self._wrap(f"SELECT * FROM {l} CROSS JOIN {r}")
        cond = condition.strip()
        simple_cols = all(c.strip().replace("_", "").isalnum()
                          for c in cond.split(","))
        clause = f"USING ({cond})" if simple_cols and "=" not in cond \
            else f"ON ({cond})"
        return self._wrap(f"SELECT * FROM {l} {how} JOIN {r} {clause}")

    def cross(self, other: "Relation") -> "Relation":
        """reference: CrossProductRelation (cross_product_relation.cpp)"""
        return self.join(other, "", how="cross")

    def union(self, other: "Relation", all_: bool = True) -> "Relation":
        """reference: SetOpRelation UNION (setop_relation.cpp); like the
        reference's Relation::Union this is UNION ALL."""
        op = "UNION ALL" if all_ else "UNION"
        return self._wrap(f"({self._sql}) {op} ({other._sql})")

    def except_(self, other: "Relation") -> "Relation":
        """reference: SetOpRelation EXCEPT"""
        return self._wrap(f"({self._sql}) EXCEPT ({other._sql})")

    def intersect(self, other: "Relation") -> "Relation":
        """reference: SetOpRelation INTERSECT"""
        return self._wrap(f"({self._sql}) INTERSECT ({other._sql})")

    def map(self, fn, schema=None) -> "Relation":
        """reference: TableFunctionRelation over a Python callable —
        materializes this relation, applies fn(df) -> df, re-registers."""
        import pandas as pd
        df = self.df()
        out = fn(df)
        if not isinstance(out, pd.DataFrame):
            raise TypeError("map function must return a DataFrame")
        name = f"__map_{next(_ALIAS_COUNTER)}"
        self._con.register(name, out)
        return Relation(self._con, f"SELECT * FROM {name}")

    # ---- inspection -----------------------------------------------------
    def _result(self):
        return self._con.execute(self._sql)

    @property
    def columns(self) -> List[str]:
        return self._schema().names

    @property
    def column_names(self) -> List[str]:
        return self._schema().names

    @property
    def column_types(self) -> list:
        return self._schema().types

    @property
    def types(self) -> List[str]:
        return [repr(t) for t in self._schema().types]

    def _schema(self):
        from .sql import parser as sqlparser
        from .sql.binder import Binder
        stmt = sqlparser.parse(self._sql)[0]
        plan = Binder(self._con.catalog,
                      context=self._con).bind_select(stmt)
        return plan.schema

    def describe(self) -> "Relation":
        return self._wrap(f"SUMMARIZE {self._sub()}")

    def sql_query(self) -> str:
        """The SQL this relation lowers to (reference: Relation::GetQueryNode
        / ToString)."""
        return self._sql

    def explain(self) -> str:
        return self._con.execute("EXPLAIN " + self._sql).fetchall()[0][-1]

    def __repr__(self):
        res = self._result()
        return repr(res)

    def show(self):
        print(self.__repr__())

    # ---- materialization ------------------------------------------------
    def execute(self):
        return self._result()

    def fetchall(self) -> list:
        return self._result().fetchall()

    def fetchone(self):
        rows = self.limit(1).fetchall()
        return rows[0] if rows else None

    def df(self):
        return self._result().df()

    def fetchdf(self):
        return self.df()

    def arrow(self):
        return self._result().arrow()

    def fetchnumpy(self):
        return self._result().fetchnumpy()

    def count(self, column: str = "*") -> "Relation":
        return self.aggregate(f"count({column})")

    def sum(self, column: str) -> "Relation":
        return self.aggregate(f"sum({column})")

    def min(self, column: str) -> "Relation":
        return self.aggregate(f"min({column})")

    def max(self, column: str) -> "Relation":
        return self.aggregate(f"max({column})")

    def mean(self, column: str) -> "Relation":
        return self.aggregate(f"avg({column})")

    avg = mean

    def value_counts(self, column: str) -> "Relation":
        return self.aggregate(f"{column}, count(*)", column)

    def unique(self, column: str) -> "Relation":
        return self._wrap(f"SELECT DISTINCT {column} FROM {self._sub()}")

    # ---- DDL/DML sinks --------------------------------------------------
    def create(self, table_name: str) -> None:
        """reference: CreateTableRelation (create_table_relation.cpp)"""
        self._con.execute(
            f"CREATE TABLE {_q(table_name)} AS {self._sql}")

    def create_view(self, view_name: str,
                    replace: bool = True) -> "Relation":
        """reference: CreateViewRelation (create_view_relation.cpp)"""
        orr = "OR REPLACE " if replace else ""
        self._con.execute(
            f"CREATE {orr}VIEW {_q(view_name)} AS {self._sql}")
        return self._con.view(view_name)

    to_view = create_view

    def insert_into(self, table_name: str) -> None:
        """reference: InsertRelation (insert_relation.cpp)"""
        self._con.execute(
            f"INSERT INTO {_q(table_name)} {self._sql}")

    def to_csv(self, path: str, **kwargs) -> None:
        """reference: WriteCSVRelation (write_csv_relation.cpp)"""
        opts = ""
        if kwargs.get("sep"):
            opts = f" (DELIMITER '{kwargs['sep']}')"
        self._con.execute(
            f"COPY ({self._sql}) TO '{path}'{opts}")

    write_csv = to_csv

    def to_parquet(self, path: str) -> None:
        """reference: WriteParquetRelation (write_parquet_relation.cpp)"""
        self._con.execute(
            f"COPY ({self._sql}) TO '{path}' (FORMAT PARQUET)")

    write_parquet = to_parquet


def table_relation(con, name: str) -> Relation:
    """reference: TableRelation (table_relation.cpp)"""
    return Relation(con, f"SELECT * FROM {name}", alias=name.split(".")[-1])


def view_relation(con, name: str) -> Relation:
    """reference: ViewRelation (view_relation.cpp)"""
    return Relation(con, f"SELECT * FROM {name}", alias=name.split(".")[-1])


def sql_relation(con, sql: str) -> Relation:
    """reference: QueryRelation (query_relation.cpp) — binds eagerly so
    unknown tables/columns raise at creation like the reference, while
    execution stays lazy."""
    rel = Relation(con, sql.rstrip().rstrip(";"))
    rel._schema()      # eager bind: validation only, no execution
    return rel


def table_function_relation(con, name: str, *args) -> Relation:
    """reference: TableFunctionRelation (table_function_relation.cpp)"""
    rendered = ", ".join(_render_literal(a) for a in args)
    return Relation(con, f"SELECT * FROM {name}({rendered})")


def values_relation(con, rows: Sequence[Sequence],
                    columns: Optional[List[str]] = None) -> Relation:
    """reference: ValueRelation (value_relation.cpp)"""
    body = ", ".join(
        "(" + ", ".join(_render_literal(v) for v in r) + ")"
        for r in rows)
    sql = f"VALUES {body}"
    if columns:
        alias = f"v({', '.join(_q(c) for c in columns)})"
        sql = f"SELECT * FROM ({sql}) {alias}"
    return Relation(con, sql)


def _render_literal(v) -> str:
    import datetime
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, datetime.datetime):
        return f"TIMESTAMP '{v.isoformat(sep=' ')}'"
    if isinstance(v, datetime.date):
        return f"DATE '{v.isoformat()}'"
    return "'" + str(v).replace("'", "''") + "'"

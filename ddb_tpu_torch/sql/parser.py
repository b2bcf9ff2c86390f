"""Recursive-descent SQL parser (Pratt expressions).

Covers the dialect exercised by the reference's benchmark suites (TPC-H /
h2oai / ClickBench shapes) plus DDL basics; the reference's parser layer is
src/parser/ + third_party/libpg_query — ours is original and minimal, grown
query-shape by query-shape.
"""

from __future__ import annotations

import decimal
from typing import List, Optional

from . import ast as A
from .lexer import SQLSyntaxError, Token, tokenize


def parse(sql: str) -> List[object]:
    p = Parser(tokenize(sql), sql)
    stmts = []
    while not p.at("EOF"):
        stmts.append(p.statement())
        while p.accept_op(";"):
            pass
    return stmts


def parse_expression(text: str):
    """Parse a standalone scalar expression (DEFAULT clauses)."""
    p = Parser(tokenize(text), text)
    e = p.expr()
    if not p.at("EOF"):
        p.error("unexpected trailing input in expression")
    return e



# identifiers that introduce a clause and therefore can never be an
# implicit (AS-less) alias (duckdb treats them as unreserved keywords)
_NON_ALIAS = {"qualify", "window", "lateral", "natural",
              "tablesample", "positional"}

# words accepted as the unit of an INTERVAL literal (singular + plural;
# reference: Interval::FromCString unit table, common/types/interval.cpp)
_IV_UNITS = set()
for _u in ("year", "month", "day", "hour", "minute", "second",
           "microsecond", "millisecond", "week", "quarter", "decade",
           "century", "millennium"):
    _IV_UNITS.add(_u)
    _IV_UNITS.add(_u + "s")
_IV_UNITS |= {"centuries", "millennia", "mon", "mons", "min", "mins",
              "sec", "secs", "us", "ms", "hr", "hrs"}


class Parser:
    def __init__(self, tokens: List[Token], text: str = ""):
        self.toks = tokens
        self.i = 0
        self.text = text

    # ---- token helpers ---------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, kind: str, value: Optional[str] = None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def at_kw(self, *vals) -> bool:
        t = self.peek()
        return t.kind == "KW" and t.value in vals

    def accept_kw(self, *vals) -> Optional[str]:
        if self.at_kw(*vals):
            return self.next().value
        return None

    def expect_kw(self, val: str) -> None:
        if not self.accept_kw(val):
            self.error(f"expected {val.upper()}")

    def accept_word(self, *vals) -> Optional[str]:
        """Accept a bare word whether it lexed as KW or IDENT."""
        t = self.peek()
        if t.kind in ("KW", "IDENT") and t.value in vals:
            return self.next().value
        return None

    def expect_word(self, val: str) -> None:
        if not self.accept_word(val):
            self.error(f"expected {val.upper()}")

    def accept_op(self, op: str) -> bool:
        if self.at("OP", op):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.error(f"expected '{op}'")

    def ident_orig(self) -> str:
        """Identifier preserving its original case (struct member
        names; the reference is case-insensitive but case-preserving)."""
        t = self.peek()
        if t.kind == "IDENT":
            self.next()
            return t.orig if t.orig is not None else t.value
        return self.ident()

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "IDENT":
            return self.next().value
        # allow non-reserved keywords as identifiers where unambiguous
        if t.kind == "KW" and t.value in (
                "date", "time", "timestamp", "values", "first", "last",
                "range", "row", "rows", "key", "set", "over",
                "partition", "grouping", "nulls", "current", "sample",
                "percent", "cube", "rollup", "repeatable", "view",
                "replace", "interval", "preceding", "following",
                "unbounded", "positional", "recursive", "asof",
                "semi", "anti"):
            return self.next().value
        self.error("expected identifier")

    def error(self, msg: str):
        t = self.peek()
        raise SQLSyntaxError(f"{msg} at position {t.pos} (near {t.value!r})")

    # ---- statements ------------------------------------------------------
    def statement(self):
        t = self.peek()
        if t.kind == "IDENT" and t.value in ("describe", "summarize"):
            # DESCRIBE/SUMMARIZE <table> | DESCRIBE/SUMMARIZE SELECT ...
            kind = t.value
            self.next()
            if self.at_kw("select", "with", "from", "values"):
                return A.DescribeStmt(None, self.select_stmt(),
                                      summarize=(kind == "summarize"))
            if self.accept_kw("table"):
                pass
            return A.DescribeStmt(self.ident(), None,
                                  summarize=(kind == "summarize"))
        if t.kind == "IDENT" and t.value in ("export", "import"):
            kind = t.value
            self.next()
            self.expect_word("database")
            path = self.next().value       # string literal
            opts = {}
            if kind == "export" and self.accept_op("("):
                while not self.at("OP", ")"):
                    key = self.next().value.lower()
                    if not self.at("OP", ",") and not self.at("OP", ")"):
                        opts[key] = self.next().value
                    else:
                        opts[key] = True
                    self.accept_op(",")
                self.expect_op(")")
            if kind == "export":
                return A.ExportStmt(str(path), opts)
            return A.ImportStmt(str(path))
        if t.kind == "IDENT" and t.value == "explain":
            self.next()
            analyze = False
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "analyze":
                self.next()
                analyze = True
            return A.ExplainStmt(self.select_stmt(), analyze)
        if t.kind == "KW" and t.value == "set" or \
                (t.kind == "IDENT" and t.value == "set"):
            self.next()
            if self.peek().kind == "IDENT" \
                    and self.peek().value.lower() == "variable":
                # SET VARIABLE name = expr (reference: SET VARIABLE,
                # consumed by getvariable())
                self.next()
                name = self.ident()
                if not self.accept_op("="):
                    self.expect_kw("to")
                return A.SetVariableStmt(name, self.expr())
            name = self.ident()
            if not self.accept_op("="):
                self.expect_kw("to") if self.at_kw("to") else None
            v = self.expr_primary()
            val = v.value if isinstance(v, A.ELit) \
                else ".".join(v.parts) if isinstance(v, A.EIdent) \
                else str(v)
            return A.SetStmt(name, val)
        if t.kind == "IDENT" and t.value == "pragma":
            self.next()
            name = self.ident()
            args = []
            if self.accept_op("("):
                if not self.at("OP", ")"):
                    args.append(self.expr_primary())
                    while self.accept_op(","):
                        args.append(self.expr_primary())
                self.expect_op(")")
            elif self.accept_op("="):
                args.append(self.expr_primary())
            return A.PragmaStmt(name, [
                a.value if isinstance(a, A.ELit)
                else ".".join(a.parts) if isinstance(a, A.EIdent)
                else str(a) for a in args])
        if self.at_kw("select", "with", "from", "values"):
            return self.select_stmt()
        if self.at("OP", "(") and self.peek(1).kind == "KW" \
                and self.peek(1).value in ("select", "with", "from", "values"):
            return self.select_stmt()
        if self.at_kw("create"):
            return self.create_stmt()
        if self.at_kw("insert"):
            return self.insert_stmt()
        if self.at_kw("delete"):
            self.next()
            self.expect_kw("from")
            name = self.qident()
            where = self.expr() if self.accept_kw("where") else None
            return A.DeleteStmt(name, where)
        if self.at_kw("update"):
            self.next()
            name = self.qident()
            self.expect_kw("set")
            assigns = []
            while True:
                col = self.ident()
                self.expect_op("=")
                assigns.append((col, self.expr()))
                if not self.accept_op(","):
                    break
            where = self.expr() if self.accept_kw("where") else None
            return A.UpdateStmt(name, assigns, where)
        t = self.peek()
        if t.kind == "IDENT" and t.value in ("checkpoint", "force"):
            force = t.value == "force"
            self.next()
            if force:
                self.expect_word("checkpoint")
            return A.CheckpointStmt(force)
        if t.kind == "IDENT" and t.value in ("begin", "commit",
                                             "rollback", "abort"):
            self.next()
            if self.peek().kind == "IDENT" and \
                    self.peek().value == "transaction":
                self.next()
            kind = {"abort": "rollback"}.get(t.value, t.value)
            return A.TransactionStmt(kind)
        if t.kind == "IDENT" and t.value == "copy":
            self.next()
            if self.accept_op("("):
                target = self.select_stmt()
                self.expect_op(")")
            else:
                target = self.ident()
            if self.accept_kw("to"):
                direction = "to"
            elif self.accept_kw("from"):
                direction = "from"
            else:
                # TO may lex as IDENT
                w = self.next().value
                direction = w if w in ("to", "from") else \
                    self.error("expected TO or FROM")
            path = self.next().value
            fmt = "csv"
            opts = {}
            if self.accept_op("("):
                while not self.at("OP", ")"):
                    word = str(self.next().value).lower()
                    if self.at("OP", ",") or self.at("OP", ")"):
                        opts[word] = True
                    else:
                        v = self.next().value
                        if isinstance(v, str) and v.lower() in (
                                "true", "false"):
                            v = v.lower() == "true"
                        opts[word] = v
                    self.accept_op(",")
                    if word == "format":
                        fmt = str(opts[word]).lower()
                self.expect_op(")")
            if path.lower().endswith(".parquet"):
                fmt = "parquet"
            return A.CopyStmt(target, path, direction, fmt, opts)
        if self.at_kw("drop"):
            self.next()
            if self.peek().kind == "IDENT" \
                    and self.peek().value in ("secret", "persistent",
                                              "temporary"):
                if self.peek().value in ("persistent", "temporary"):
                    self.next()
                self.next()          # 'secret'
                kind = "secret"
            elif self.peek().kind == "IDENT" \
                    and self.peek().value == "type":
                self.next()
                kind = "type"
            elif self.peek().kind == "IDENT" \
                    and self.peek().value == "index":
                self.next()
                kind = "index"
            elif self.peek().kind == "IDENT" \
                    and self.peek().value in ("schema", "sequence",
                                              "macro", "function"):
                kind = self.next().value
                if kind == "function":
                    kind = "macro"
                if kind == "macro" and self.peek().kind == "KW" \
                        and self.peek().value == "table":
                    self.next()
            else:
                kind = "view" if self.accept_kw("view") else \
                    ("table" if self.accept_kw("table") else
                     self.error("expected TABLE, VIEW, TYPE or SECRET"))
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            nm = self.ident()
            cascade = False
            if self.peek().kind == "IDENT" \
                    and self.peek().value in ("cascade", "restrict"):
                cascade = self.next().value == "cascade"
            return A.DropStmt(kind, nm, if_exists, cascade)
        if t.kind == "IDENT" and t.value == "pivot":
            return self.pivot_stmt()
        if t.kind == "IDENT" and t.value == "unpivot":
            return self.unpivot_stmt()
        if t.kind == "IDENT" and t.value == "prepare":
            return self.prepare_stmt()
        if t.kind == "IDENT" and t.value == "execute":
            return self.execute_stmt()
        if t.kind == "IDENT" and t.value == "deallocate":
            self.next()
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "prepare":
                self.next()
            if self.at("OP", ";") or self.at("EOF") or self.at_kw("all"):
                self.accept_kw("all")
                return A.DeallocateStmt(None)
            return A.DeallocateStmt(self.ident())
        if t.kind == "IDENT" and t.value == "alter":
            return self.alter_stmt()
        if t.kind == "IDENT" and t.value == "attach":
            self.next()
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "database":
                self.next()
            if not self.at("STR"):
                self.error("expected database path string")
            path = self.next().value
            name = None
            if self.accept_kw("as"):
                name = self.ident()
            read_only = False
            if self.accept_op("("):
                while not self.at("OP", ")"):
                    w = self.next().value
                    if str(w).lower() == "read_only":
                        read_only = True
                self.expect_op(")")
            return A.AttachStmt(path, name, read_only)
        if t.kind == "IDENT" and t.value == "detach":
            self.next()
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "database":
                self.next()
            return A.DetachStmt(self.ident())
        self.error("expected statement")

    def pivot_stmt(self):
        """PIVOT <source> ON <col> [IN (v,...)] USING agg() [AS a][, ...]
        [GROUP BY c, ...] (reference: simplified pivot syntax,
        parser/transform/tableref/transform_pivot.cpp)."""
        self.next()
        source = self.table_primary()
        self.expect_kw("on")
        on_col = self.ident()
        in_values = None
        if self.accept_kw("in"):
            self.expect_op("(")
            in_values = [self._literal()]
            while self.accept_op(","):
                in_values.append(self._literal())
            self.expect_op(")")
        using = []
        if self.accept_kw("using"):
            while True:
                e = self.expr()
                alias = self.ident() if self.accept_kw("as") else None
                using.append((e, alias))
                if not self.accept_op(","):
                    break
        group_by = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.ident())
            while self.accept_op(","):
                group_by.append(self.ident())
        return A.PivotStmt(source, on_col, in_values, using, group_by)

    def unpivot_stmt(self):
        """UNPIVOT <source> ON c1, c2, ... [INTO NAME n VALUE v]."""
        self.next()
        source = self.table_primary()
        self.expect_kw("on")
        on_cols = [self.ident()]
        while self.accept_op(","):
            on_cols.append(self.ident())
        name_col, value_col = "name", "value"
        if self.accept_kw("into"):
            self.expect_word("name")
            name_col = self.ident()
            self.expect_word("value")
            value_col = self.ident()
        return A.UnpivotStmt(source, on_cols, name_col, value_col)

    def _literal(self):
        """A literal value (possibly signed) -> python value."""
        neg = self.accept_op("-")
        t = self.peek()
        if t.kind == "NUM":
            self.next()
            v = decimal.Decimal(t.value) if "." in t.value else int(t.value)
            return -v if neg else v
        if t.kind == "STR":
            self.next()
            return t.value
        if self.accept_kw("true"):
            return True
        if self.accept_kw("false"):
            return False
        if self.accept_kw("null"):
            return None
        self.error("expected literal")

    def prepare_stmt(self):
        """PREPARE name AS <statement> — body kept as raw text and
        re-parsed at EXECUTE (reference: parser/statement/
        prepare_statement.cpp; rebinding per execute matches the
        reference's prepared-statement semantics)."""
        self.next()
        name = self.ident()
        self.expect_kw("as")
        body_start = self.peek().pos
        depth = 0
        end = len(self.text)
        while not self.at("EOF"):
            if self.at("OP", ";") and depth == 0:
                end = self.peek().pos
                break
            if self.at("OP", "("):
                depth += 1
            elif self.at("OP", ")"):
                depth -= 1
            self.next()
        return A.PrepareStmt(name, self.text[body_start:end])

    def execute_stmt(self):
        self.next()
        name = self.ident()
        args = []
        if self.accept_op("("):
            if not self.at("OP", ")"):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
            self.expect_op(")")
        return A.ExecuteStmt(name, args)

    def alter_stmt(self):
        self.next()
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        table = self.ident()
        w = self.peek()
        if w.kind == "IDENT" and w.value == "rename":
            self.next()
            if self.accept_word("to"):
                return A.AlterStmt(table, "rename_table",
                                   new_name=self.ident(),
                                   if_exists=if_exists)
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "column":
                self.next()
            col = self.ident()
            self.expect_word("to")
            return A.AlterStmt(table, "rename_column", name=col,
                               new_name=self.ident(), if_exists=if_exists)
        if w.kind == "IDENT" and w.value == "add":
            self.next()
            if self.at_kw("primary") or (
                    self.peek().kind == "IDENT"
                    and self.peek().value == "primary"):
                # ALTER TABLE ADD PRIMARY KEY (cols) (reference:
                # alter_table_info.hpp AddConstraint)
                self.next()
                self.expect_kw("key")
                self.expect_op("(")
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                return A.AlterStmt(table, "add_pk",
                                   name=",".join(cols),
                                   if_exists=if_exists)
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "column":
                self.next()
            col = self.ident()
            tn, wd, sc = self.typename()
            return A.AlterStmt(table, "add_column", name=col,
                               coltype=(tn, wd, sc), if_exists=if_exists)
        if self.at_kw("drop") or (w.kind == "IDENT" and w.value == "drop"):
            self.next()
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "column":
                self.next()
            return A.AlterStmt(table, "drop_column", name=self.ident(),
                               if_exists=if_exists)
        if w.kind in ("IDENT", "KW") and w.value == "alter":
            # ALTER COLUMN col SET DATA TYPE t | {SET|DROP} DEFAULT |
            # {SET|DROP} NOT NULL (reference:
            # src/parser/statement/alter_statement.cpp)
            self.next()
            if self.peek().kind in ("IDENT", "KW") \
                    and self.peek().value == "column":
                self.next()
            col = self.ident()
            act = self.next().value.lower()     # set | drop | type
            if act == "type" or (act == "set" and self.peek().value
                                 in ("data", "type")):
                if act == "set":
                    if self.next().value.lower() == "data":
                        self.expect_word("type")
                tn, wd, sc = self.typename()
                using = None
                if self.peek().kind in ("KW", "IDENT") \
                        and self.peek().value == "using":
                    self.next()
                    ustart = self.peek().pos
                    self.expr()
                    using = self.text[ustart:self.peek().pos].strip()
                return A.AlterStmt(table, "set_type", name=col,
                                   coltype=(tn, wd, sc),
                                   new_name=using,
                                   if_exists=if_exists)
            if act == "set" and self.peek().kind in ("KW", "IDENT") \
                    and self.peek().value == "default":
                self.next()
                dstart = self.peek().pos
                self.expr()
                dtext = self.text[dstart:self.peek().pos].strip()
                return A.AlterStmt(table, "set_default", name=col,
                                   new_name=dtext, if_exists=if_exists)
            if act == "drop" and self.peek().kind in ("KW", "IDENT") \
                    and self.peek().value == "default":
                self.next()
                return A.AlterStmt(table, "drop_default", name=col,
                                   if_exists=if_exists)
            if act == "set" and self.accept_kw("not"):
                self.expect_kw("null")
                return A.AlterStmt(table, "set_not_null", name=col,
                                   if_exists=if_exists)
            if act == "drop" and self.accept_kw("not"):
                self.expect_kw("null")
                return A.AlterStmt(table, "drop_not_null", name=col,
                                   if_exists=if_exists)
            self.error("unsupported ALTER COLUMN action")
        self.error("expected RENAME, ADD, DROP or ALTER")

    def create_stmt(self):
        start = self.peek().pos
        self.expect_kw("create")
        or_replace = False
        if self.accept_kw("or"):
            self.expect_kw("replace")
            or_replace = True
        if self.peek().kind in ("IDENT", "KW") \
                and self.peek().value in ("temp", "temporary") \
                and self.peek(1).kind in ("IDENT", "KW") \
                and self.peek(1).value in ("table", "view", "macro",
                                           "function", "sequence"):
            # CREATE TEMP[ORARY] TABLE/VIEW/... — session lifetime ==
            # our in-memory default, so the qualifier is advisory
            # (reference: OnCreateConflict temporary catalog)
            self.next()
        if self.peek().kind == "IDENT" \
                and self.peek().value in ("secret", "persistent",
                                          "temporary"):
            persistent = False
            if self.peek().value in ("persistent", "temporary"):
                persistent = self.next().value == "persistent"
            if not (self.peek().kind == "IDENT"
                    and self.peek().value == "secret"):
                self.error("expected SECRET")
            self.next()
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = None
            if not self.at("OP", "("):
                name = self.ident()
            self.expect_op("(")
            pairs = {}
            while True:
                key = self.ident().lower()
                t = self.peek()
                if t.kind == "STR":
                    val = self.next().value
                elif t.kind == "NUM":
                    val = self.next().value
                else:
                    val = self.ident()
                pairs[key] = val
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return A.CreateSecret(name, pairs, persistent, or_replace,
                                  if_not_exists)
        if self.peek().kind == "IDENT" and self.peek().value == "type":
            # CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')
            self.next()
            name = self.ident()
            self.expect_kw("as")
            if not (self.peek().kind == "IDENT"
                    and self.peek().value == "enum"):
                self.error("only ENUM types are supported")
            self.next()
            self.expect_op("(")
            vals = []
            if not self.at("OP", ")"):
                vals.append(self.next().value)
                while self.accept_op(","):
                    vals.append(self.next().value)
            self.expect_op(")")
            return A.CreateType(name, vals, or_replace)
        if (self.peek().kind == "IDENT"
                and self.peek().value in ("index", "unique")
                and (self.peek().value == "index"
                     or (self.peek(1).kind == "IDENT"
                         and self.peek(1).value == "index"))):
            # CREATE [UNIQUE] INDEX name ON table (col, ...)
            unique = self.peek().value == "unique"
            if unique:
                self.next()
            self.next()   # index
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = self.ident()
            self.expect_kw("on")
            table = self.ident()
            self.expect_op("(")
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            return A.CreateIndex(name, table, cols, unique,
                                 if_not_exists)
        if self.peek().kind == "IDENT" \
                and self.peek().value in ("schema", "sequence"):
            kind = self.next().value
            ine = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                ine = True
            name = self.ident()
            if kind == "schema":
                return A.CreateSchema(name, ine)
            start, inc = 1, 1
            while True:
                t = self.peek()
                if t.kind in ("IDENT", "KW") and t.value == "start":
                    self.next()
                    self.accept_kw("with")
                    neg = self.accept_op("-")
                    start = int(self.next().value) * (-1 if neg else 1)
                elif t.kind in ("IDENT", "KW") \
                        and t.value == "increment":
                    self.next()
                    self.accept_kw("by")
                    neg = self.accept_op("-")
                    inc = int(self.next().value) * (-1 if neg else 1)
                elif t.kind in ("IDENT", "KW") and t.value in (
                        "minvalue", "maxvalue", "cache"):
                    self.next()
                    self.accept_op("-")
                    self.next()
                elif t.kind in ("IDENT", "KW") and t.value in (
                        "cycle", "no"):
                    self.next()
                else:
                    break
            return A.CreateSequence(name, start, inc, ine)
        if self.peek().kind == "IDENT" \
                and self.peek().value in ("macro", "function"):
            self.next()
            ine = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                ine = True
            name = self.qident()
            params, defaults = [], {}
            self.expect_op("(")
            if not self.at("OP", ")"):
                while True:
                    p = self.ident()
                    params.append(p)
                    if self.accept_op(":="):
                        dstart = self.peek().pos
                        self.expr()
                        defaults[p] = self.text[dstart:
                                                self.peek().pos].strip()
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            self.expect_kw("as")
            is_table = False
            if self.peek().kind == "KW" and self.peek().value == "table":
                self.next()
                is_table = True
            bstart = self.peek().pos
            if is_table:
                self.select_stmt()
            else:
                self.expr()
            body = self.text[bstart:self.peek().pos].strip()
            return A.CreateMacro(name, params, defaults, body, is_table,
                                 or_replace, ine)
        if self.accept_kw("view"):
            name = self.ident()
            cols = self._opt_column_alias_list()
            self.expect_kw("as")
            body_start = self.peek().pos
            sel = self.select_stmt()
            body_end = self.peek().pos
            return A.CreateView(name, self.text[body_start:body_end],
                                or_replace, cols)
        if self.accept_kw("table"):
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = self.ident()
            while self.accept_op("."):
                name += "." + self.ident()   # schema-qualified
            if self.accept_kw("as"):
                return A.CreateTableAs(name, self.select_stmt(),
                                       or_replace)
            self.expect_op("(")
            cols = []
            constraints = []
            foreign_keys = []

            def _col_list():
                self.expect_op("(")
                out = [self.ident()]
                while self.accept_op(","):
                    out.append(self.ident())
                self.expect_op(")")
                return out

            def _references():
                # REFERENCES parent [(col, ...)] — ON DELETE/UPDATE
                # actions are parsed and rejected unless RESTRICT/NO
                # ACTION (the reference supports only those too:
                # src/parser/transform/constraint/transform_constraint.cpp)
                parent = self.qident()
                pcols = _col_list() if self.at("OP", "(") else None
                while self.at_kw("on") or (
                        self.peek().kind == "IDENT"
                        and self.peek().value == "on"):
                    self.next()
                    act = self.next().value.lower()   # delete / update
                    word = self.next().value.lower()
                    if word == "no":
                        self.expect_word("action")
                    elif word != "restrict":
                        self.error(
                            f"ON {act.upper()} {word.upper()} is not "
                            "supported (only RESTRICT/NO ACTION)")
                return parent, pcols

            while True:
                if self.at_kw("primary") or (
                        self.peek().kind == "IDENT"
                        and self.peek().value == "primary"):
                    self.next()
                    self.expect_kw("key")
                    constraints.append(("primary_key", _col_list()))
                elif self.peek().kind in ("IDENT", "KW") \
                        and self.peek().value == "unique" \
                        and self.peek(1).kind == "OP" \
                        and self.peek(1).value == "(":
                    self.next()
                    constraints.append(("unique", _col_list()))
                elif self.peek().kind in ("IDENT", "KW") \
                        and self.peek().value == "foreign":
                    self.next()
                    self.expect_kw("key")
                    fcols = _col_list()
                    self.expect_word("references")
                    parent, pcols = _references()
                    foreign_keys.append((fcols, parent, pcols))
                else:
                    cname = self.ident()
                    tn, w, s = self.typename()
                    not_null = pk = uq = False
                    default = None
                    refs = None
                    collation = None
                    if self.peek().kind in ("KW", "IDENT") \
                            and self.peek().value == "collate":
                        # column-level collation: comparisons on this
                        # column fold through it at bind time
                        self.next()
                        collation = self.ident()
                        while self.at("OP", ".") \
                                and self.peek(1).kind in ("IDENT",
                                                          "KW"):
                            self.next()
                            collation += "." + self.ident()
                    while True:
                        if self.accept_kw("not"):
                            self.expect_kw("null")
                            not_null = True
                        elif self.accept_kw("primary"):
                            self.expect_kw("key")
                            not_null = pk = True
                        elif self.peek().kind == "IDENT" \
                                and self.peek().value == "unique":
                            self.next()
                            uq = True
                        elif self.peek().kind == "IDENT" \
                                and self.peek().value == "references":
                            self.next()
                            refs = _references()
                        elif self.accept_kw("default"):
                            dstart = self.peek().pos
                            self.expr()
                            default = self.text[dstart:
                                                self.peek().pos].strip()
                        else:
                            break
                    cols.append(A.ColumnDef(cname, tn, w, s, not_null,
                                            pk, uq, default=default,
                                            references=refs,
                                            collation=collation))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            for c in cols:
                if c.primary_key:
                    constraints.append(("primary_key", [c.name]))
                if c.unique:
                    constraints.append(("unique", [c.name]))
                if c.references is not None:
                    foreign_keys.append(
                        ([c.name], c.references[0], c.references[1]))
            if self.at_kw("on"):
                # ON COMMIT PRESERVE ROWS — the only mode this engine
                # (and the reference) supports; parse and discard
                self.next()
                self.expect_word("commit")
                self.expect_word("preserve")
                self.expect_word("rows")
            return A.CreateTable(name, cols, or_replace, if_not_exists,
                                 constraints, foreign_keys)
        self.error("expected VIEW or TABLE")

    def _quantified(self, op: str, x, sub, is_all: bool):
        """expr op ANY/ALL (subquery) -> IN / CASE-over-aggregates
        rewrite (reference: quantified subquery planning in
        plan_subquery.cpp; the min/max forms are the standard
        decorrelation)."""
        import copy
        if op == "==" and not is_all:
            return A.EIn(x, subquery=sub)
        if op == "!=" and is_all:
            return A.EIn(x, subquery=sub, negated=True)
        agg = None
        if not is_all:
            agg = "max" if op in ("<", "<=") else (
                "min" if op in (">", ">=") else None)
        else:
            agg = "min" if op in ("<", "<=") else (
                "max" if op in (">", ">=") else None)
        if agg is None:
            self.error(f"unsupported quantified comparison {op} "
                       f"{'ALL' if is_all else 'ANY'}")

        def sq(items, where=None):
            return A.ESub(A.SelectStmt(
                items=items,
                from_refs=[A.RSubquery(copy.deepcopy(sub), "__q",
                                       ["__qcol"])],
                where=where))
        col = A.EIdent(["__qcol"])
        cnt_all = sq([(A.EFunc("count", [], star=True), None)])
        cnt_null = sq([(A.EFunc("count", [], star=True), None)],
                      where=A.EIsNull(col))
        extreme = sq([(A.EFunc(agg, [col]), None)])
        cmp_ = A.EBinary(op, copy.deepcopy(x), extreme)
        has_null = A.EBinary(">", cnt_null, A.ELit(0))
        empty = A.EBinary("==", cnt_all, A.ELit(0))
        if not is_all:
            # empty -> false; x NULL -> NULL; cmp true -> true;
            # nulls present -> NULL; else false
            return A.ECase(None, [
                (empty, A.ELit(False)),
                (A.EIsNull(copy.deepcopy(x)), A.ELit(None)),
                (cmp_, A.ELit(True)),
                (has_null, A.ELit(None)),
            ], A.ELit(False))
        # ALL: empty -> true; x NULL -> NULL; cmp false -> false;
        # nulls present -> NULL; else true
        return A.ECase(None, [
            (empty, A.ELit(True)),
            (A.EIsNull(copy.deepcopy(x)), A.ELit(None)),
            (A.EUnary("not", cmp_), A.ELit(False)),
            (has_null, A.ELit(None)),
        ], A.ELit(True))

    def _table_alias(self) -> str:
        """Derived-table alias; optional like the reference
        (unaliased subqueries get a generated unique name)."""
        if self.accept_kw("as"):
            return self.ident()
        t = self.peek()
        if t.kind == "IDENT" and t.value not in _NON_ALIAS:
            return self.ident()
        self._anon_subq = getattr(self, "_anon_subq", 0) + 1
        return f"unnamed_subquery{self._anon_subq}"

    def qident(self) -> str:
        name = self.ident()
        while self.accept_op("."):
            name += "." + self.ident()
        return name

    def insert_stmt(self):
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self.qident()
        cols = None
        if self.at("OP", "(") \
                and not (self.peek(1).kind == "KW"
                         and self.peek(1).value in ("values", "select",
                                                    "with", "from")):
            self.next()
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        if self.at("OP", "(") and self.peek(1).kind == "KW" \
                and self.peek(1).value in ("values", "select", "with",
                                           "from"):
            # INSERT INTO t (VALUES ...) / (SELECT ...): parenthesized
            # source query (reference: parenthesized insert source)
            self.next()
            sel = self.select_stmt()
            self.expect_op(")")
            return A.InsertStmt(name, cols, select=sel)
        if self.at_kw("default") and self.peek(1).kind == "KW" \
                and self.peek(1).value == "values":
            # INSERT INTO t DEFAULT VALUES (one all-defaults row)
            self.next()
            self.next()
            return A.InsertStmt(name, cols, values=[[]])
        if self.accept_kw("values"):
            rows = []
            while True:
                self.expect_op("(")
                row = [self._insert_value()]
                while self.accept_op(","):
                    row.append(self._insert_value())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
                if not self.at("OP", "("):
                    break       # trailing comma after the last row
            return A.InsertStmt(name, cols, values=rows)
        return A.InsertStmt(name, cols, select=self.select_stmt())

    def _insert_value(self):
        """A VALUES cell: an expression or the DEFAULT keyword."""
        if self.accept_kw("default"):
            return A.EDefault()
        return self.expr()

    # ---- SELECT ----------------------------------------------------------
    def select_stmt(self) -> A.SelectStmt:
        ctes = []
        if self.accept_kw("with"):
            recursive = bool(self.accept_kw("recursive"))
            while True:
                name = self.ident()
                cols = None
                if self.accept_op("("):
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("as")
                # [NOT] MATERIALIZED hint (we materialize shared CTEs
                # automatically; the hint parses and is advisory)
                forced_mat = False
                if self.accept_kw("not"):
                    self.expect_word("materialized")
                elif self.accept_word("materialized"):
                    forced_mat = True
                self.expect_op("(")
                cd = A.CTEDef(name, self.select_stmt(), cols, recursive)
                if forced_mat:
                    cd._nrefs = 2      # force the Materialize barrier
                ctes.append(cd)
                self.expect_op(")")
                if not self.accept_op(","):
                    break
        stmt = self._set_operand()
        stmt.ctes = ctes
        # set operations (left-associative)
        while self.at_kw("union", "except", "intersect"):
            op = self.next().value
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            rhs = self._set_operand()
            node = A.SelectStmt(set_op=(op, rhs, all_), set_left=stmt)
            node.ctes = ctes
            # trailing ORDER BY/LIMIT parsed into the last core belong to
            # the whole set operation
            if rhs.order_by:
                node.order_by, rhs.order_by = rhs.order_by, []
            if rhs.limit is not None or rhs.offset \
                    or rhs.limit_expr is not None \
                    or rhs.offset_expr is not None \
                    or rhs.limit_percent is not None:
                node.limit, node.offset = rhs.limit, rhs.offset
                node.limit_expr = rhs.limit_expr
                node.offset_expr = rhs.offset_expr
                node.limit_percent = rhs.limit_percent
                rhs.limit, rhs.offset = None, 0
                rhs.limit_expr = rhs.offset_expr = None
                rhs.limit_percent = None
            stmt = node
        # trailing ORDER BY / LIMIT apply to the set-op result
        if self.at_kw("order"):
            tgt = stmt
            self.next()
            self.expect_kw("by")
            if self.at_kw("all"):
                tgt.order_by = self._order_all(stmt)
            else:
                tgt.order_by = self.order_items()
        if self.accept_kw("limit"):
            self._parse_limit_clause(stmt)
        if self.accept_kw("offset"):
            self._parse_offset_clause(stmt)
        return stmt

    def _set_operand(self) -> A.SelectStmt:
        """A set-operation operand: SELECT core or parenthesized select."""
        if self.at("OP", "(") and self.peek(1).kind == "KW" \
                and self.peek(1).value in ("select", "with", "from", "values"):
            self.next()
            inner = self.select_stmt()
            self.expect_op(")")
            return inner
        return self.select_core()

    def select_core(self) -> A.SelectStmt:
        # bare VALUES clause as a full query core (reference:
        # transform VALUES lists, transform_select_node.cpp):
        # 'VALUES (1, 2), (3, 4)' == SELECT * FROM (VALUES ...)
        if self.at_kw("values"):
            self.next()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.expr()]
                while self.accept_op(","):
                    row.append(self.expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            s = A.SelectStmt()
            s.from_refs.append(A.RValues(rows, None, None))
            s.items.append((A.EStar(), None))
            if self.at_kw("order"):
                self.next()
                self.expect_kw("by")
                s.order_by = self.order_items()
            if self.accept_kw("limit"):
                self._parse_limit_clause(s)
            if self.accept_kw("offset"):
                self._parse_offset_clause(s)
            return s
        # FROM-first query: 'FROM t [SELECT items] [WHERE ...] ...'
        # (reference: from_first syntax, transform_select_node.cpp)
        if self.at_kw("from"):
            self.next()
            s = A.SelectStmt()
            s.from_refs.append(self.table_ref())
            while self.accept_op(","):
                s.from_refs.append(self.table_ref())
            if self.accept_kw("select"):
                self.accept_kw("distinct") and setattr(
                    s, "distinct", True)
                while True:
                    e = self.expr()
                    alias = None
                    if self.accept_kw("as"):
                        alias = self.next().value \
                            if self.peek().kind == "STR" else self.ident()
                    elif self.peek().kind == "IDENT" \
                            and self.peek().value not in _NON_ALIAS:
                        alias = self.next().value
                    s.items.append((e, alias))
                    if not self.accept_op(","):
                        break
            else:
                s.items.append((A.EStar(), None))
            self._select_tail(s)
            return s
        self.expect_kw("select")
        s = A.SelectStmt()
        if self.accept_kw("distinct"):
            s.distinct = True
            if self.peek().kind in ("KW", "IDENT") \
                    and self.peek().value == "on" \
                    and self.peek(1).kind == "OP" \
                    and self.peek(1).value == "(":
                # DISTINCT ON (exprs): first row per key (reference:
                # transform_select_node.cpp DistinctModifier) — lowered
                # to a row_number QUALIFY after the full SELECT parses
                self.next()
                self.next()
                s.distinct_on = [self.expr()]
                while self.accept_op(","):
                    s.distinct_on.append(self.expr())
                self.expect_op(")")
                s.distinct = False
        self.accept_kw("all")
        while True:
            e = self.expr()
            alias = None
            if self.accept_kw("as"):
                alias = self.next().value \
                    if self.peek().kind == "STR" else self.ident()
            elif self.peek().kind == "IDENT" \
                    and self.peek().value not in _NON_ALIAS:
                alias = self.next().value
            s.items.append((e, alias))
            if self.accept_op(","):
                if self.at_kw("from") or self.peek().kind == "EOF" \
                        or (self.peek().kind == "OP"
                            and self.peek().value in (")", ";")):
                    break   # trailing comma before FROM / end
                continue
            if True:
                break
        if self.accept_kw("from"):
            s.from_refs.append(self.table_ref())
            while self.accept_op(","):
                s.from_refs.append(self.table_ref())
        self._select_tail(s)
        return s

    def _select_tail(self, s) -> None:
        """WHERE .. GROUP BY .. HAVING .. WINDOW .. QUALIFY .. ORDER ..
        LIMIT tail shared by SELECT-first and FROM-first cores."""
        if self.accept_kw("where"):
            s.where = self.expr()
        if self.accept_kw("using"):
            self.expect_kw("sample")
            s.sample = self._sample_spec()
        if self.accept_kw("group"):
            self.expect_kw("by")
            if self.accept_kw("all"):
                s.group_by_all = True
            elif self.at_kw("grouping", "rollup", "cube"):
                self._grouping_sets(s)
            else:
                while True:
                    s.group_by.append(self.expr())
                    if not self.accept_op(","):
                        break
        if self.accept_kw("having"):
            s.having = self.expr()
        wdefs = {}
        while True:
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "window":
                # WINDOW w AS (PARTITION BY ... ORDER BY ... [frame]), ...
                self.next()
                while True:
                    wname = self.ident().lower()
                    self.expect_kw("as")
                    self.expect_op("(")
                    w = A.EWindow(None)
                    if self.accept_kw("partition"):
                        self.expect_kw("by")
                        w.partition.append(self.expr())
                        while self.accept_op(","):
                            w.partition.append(self.expr())
                    if self.accept_kw("order"):
                        self.expect_kw("by")
                        w.order = self.order_items()
                    if self.at_kw("rows", "range") or (self.peek().kind == "IDENT" and self.peek().value == "groups"):
                        frame_kind = self.next().value
                        parts = [frame_kind]
                        while not self.at("OP", ")"):
                            parts.append(self.next().value)
                        w.frame = " ".join(parts)
                    self.expect_op(")")
                    wdefs[wname] = w
                    if not self.accept_op(","):
                        break
                continue
            if self.peek().kind == "IDENT" \
                    and self.peek().value == "qualify":
                self.next()
                s.qualify = self.expr()
                continue
            break
        if wdefs:
            def resolve(e):
                if isinstance(e, A.EWindow) and e.ref:
                    d = wdefs.get(e.ref.lower())
                    if d is None:
                        self.error(f"unknown window {e.ref}")
                    e.partition = list(d.partition)
                    e.order = list(d.order)
                    e.frame = d.frame
                    e.ref = None
                if hasattr(e, "__dataclass_fields__"):
                    import dataclasses
                    for f in dataclasses.fields(e):
                        v = getattr(e, f.name)
                        if isinstance(v, A.EExpr):
                            resolve(v)
                        elif isinstance(v, (list, tuple)):
                            for x in v:
                                if isinstance(x, A.EExpr):
                                    resolve(x)
                                elif isinstance(x, A.OrderItem):
                                    resolve(x.expr)
                return e
            s.items = [(resolve(e), a) for e, a in s.items]
            if s.qualify is not None:
                s.qualify = resolve(s.qualify)
        if self.at_kw("order"):
            # leave for select_stmt when part of set-op; consume here
            self.next()
            self.expect_kw("by")
            if self.at_kw("all"):
                s.order_by = self._order_all(s)
            else:
                s.order_by = self.order_items()
        if self.accept_kw("limit"):
            self._parse_limit_clause(s)
        if self.accept_kw("offset"):
            self._parse_offset_clause(s)

    def _parse_limit_clause(self, s):
        """LIMIT <expr> [% | PERCENT] — constants fold at bind time;
        subqueries/parameters/percent supported (reference:
        transform_limit + physical_limit_percent)."""
        self._limit_pct = True
        try:
            e = self.expr()
        finally:
            self._limit_pct = False
        if isinstance(e, A.EUnary) and e.op == "-" \
                and isinstance(e.child, A.ELit) \
                and isinstance(e.child.value, int):
            e = A.ELit(-e.child.value)
        if self.accept_op("%") or self.accept_word("percent"):
            s.limit_percent = e
        elif isinstance(e, A.ELit) and isinstance(e.value, int) \
                and not isinstance(e.value, bool):
            s.limit = e.value
        else:
            s.limit_expr = e

    def _parse_offset_clause(self, s):
        e = self.expr()
        if isinstance(e, A.EUnary) and e.op == "-" \
                and isinstance(e.child, A.ELit) \
                and isinstance(e.child.value, int):
            e = A.ELit(-e.child.value)
        if isinstance(e, A.ELit) and isinstance(e.value, int) \
                and not isinstance(e.value, bool):
            s.offset = e.value
        else:
            s.offset_expr = e

    def _order_all(self, s):
        """ORDER BY ALL: every select item, left to right (reference:
        order-by-all binding, bind_order.cpp)."""
        self.next()   # 'all'
        desc = None
        if self.accept_kw("desc"):
            desc = True
        elif self.accept_kw("asc"):
            desc = False
        nl = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nl = False
            else:
                self.expect_kw("last")
                nl = True
        core = s
        while core.set_left is not None:
            core = core.set_left
        return [A.OrderItem(A.ELit(i + 1), desc, nl)
                for i in range(len(core.items))]

    def order_items(self):
        items = []
        while True:
            e = self.expr()
            it = A.OrderItem(e)
            if self.accept_kw("desc"):
                it.desc = True
            elif self.accept_kw("asc"):
                it.desc = False
            if self.accept_kw("nulls"):
                if self.accept_kw("first"):
                    it.nulls_last = False
                else:
                    self.expect_kw("last")
                    it.nulls_last = True
            items.append(it)
            if not self.accept_op(","):
                break
        return items

    def _sample_spec(self):
        """<amount> [% | PERCENT | ROWS] [REPEATABLE (seed)] — reference:
        parser sample_options (SampleOptions)."""
        t = self.next()
        if t.kind != "NUM":
            self.error("expected sample size")
        amount = float(t.value)
        method = "rows"
        if self.accept_op("%") or self.accept_kw("percent"):
            method = "percent"
        else:
            self.accept_kw("rows")
        seed = 42
        if self.accept_kw("repeatable"):
            self.expect_op("(")
            st = self.next()
            if st.kind != "NUM":
                self.error("expected seed")
            seed = int(st.value)
            self.expect_op(")")
        return A.SampleSpec(method, amount, seed)

    def _grouping_sets(self, s: A.SelectStmt) -> None:
        """GROUP BY GROUPING SETS ((...),...) | ROLLUP(...) | CUBE(...)
        normalized to a distinct group-expr list + index sets
        (reference: planner grouping-set expansion,
        src/planner/binder/query_node/bind_select_node.cpp)."""
        def expr_index(e):
            k = repr(e)
            for i, g in enumerate(s.group_by):
                if repr(g) == k:
                    return i
            s.group_by.append(e)
            return len(s.group_by) - 1

        def expr_list():
            self.expect_op("(")
            out = []
            if not self.accept_op(")"):
                out.append(expr_index(self.expr()))
                while self.accept_op(","):
                    out.append(expr_index(self.expr()))
                self.expect_op(")")
            return out

        sets: list = []
        if self.accept_kw("grouping"):
            if self.ident().lower() != "sets":
                self.error("expected SETS after GROUPING")
            self.expect_op("(")
            while True:
                sets.append(expr_list())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        elif self.accept_kw("rollup"):
            cols = expr_list()
            sets = [cols[:k] for k in range(len(cols), -1, -1)]
        elif self.accept_kw("cube"):
            cols = expr_list()
            for mask in range(1 << len(cols)):
                sets.append([c for i, c in enumerate(cols)
                             if mask >> i & 1])
            sets.sort(key=lambda x: (-len(x), x))
        s.grouping_sets = sets

    # ---- table refs ------------------------------------------------------
    def table_ref(self) -> A.TableRef:
        left = self.table_primary()
        if self.accept_kw("tablesample"):
            left = A.RSampleRef(left, self._sample_spec())
        while True:
            jt = None
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.table_primary()
                left = A.RJoin(left, right, "cross")
                continue
            if self.accept_kw("positional"):
                self.expect_kw("join")
                right = self.table_primary()
                left = A.RJoin(left, right, "positional")
                continue
            asof = bool(self.accept_kw("asof"))
            natural = self.peek().kind == "IDENT" \
                and self.peek().value == "natural"
            if natural:
                self.next()
            if asof or natural or self.at_kw(
                    "join", "inner", "left", "right",
                    "full", "semi", "anti"):
                if self.accept_kw("inner"):
                    jt = "inner"
                elif self.accept_kw("semi"):
                    jt = "semi"
                elif self.accept_kw("anti"):
                    jt = "anti"
                elif self.accept_kw("left"):
                    self.accept_kw("outer")
                    if self.accept_kw("semi"):
                        jt = "semi"
                    elif self.accept_kw("anti"):
                        jt = "anti"
                    else:
                        jt = "left"
                elif self.accept_kw("right"):
                    self.accept_kw("outer")
                    if self.accept_kw("semi"):
                        jt = "right_semi"
                    elif self.accept_kw("anti"):
                        jt = "right_anti"
                    else:
                        jt = "right"
                elif self.accept_kw("full"):
                    self.accept_kw("outer")
                    jt = "full"
                else:
                    jt = "inner"
                self.expect_kw("join")
                right = self.table_primary()
                if self.accept_kw("on"):
                    cond = self.expr()
                    left = A.RJoin(left, right, jt, on=cond, asof=asof)
                elif self.accept_kw("using"):
                    self.expect_op("(")
                    cols = [self.ident()]
                    while self.accept_op(","):
                        cols.append(self.ident())
                    self.expect_op(")")
                    left = A.RJoin(left, right, jt, using=cols, asof=asof)
                else:
                    left = A.RJoin(left, right, jt, asof=asof,
                                   natural=natural)
                continue
            return left

    def table_primary(self) -> A.TableRef:
        if self.accept_kw("lateral"):
            # LATERAL (subquery) [AS] alias — the subquery may reference
            # columns of FROM items to its left
            ref = self.table_primary()
            if isinstance(ref, A.RSubquery):
                ref.lateral = True
            return ref
        if self.accept_op("("):
            # parenthesized set expression as a table:
            # ((SELECT ...) EXCEPT (SELECT ...)) alias — try a full select
            # with backtracking before falling back to a table_ref
            if self.at("OP", "("):
                k = 0
                while self.peek(k).kind == "OP" \
                        and self.peek(k).value == "(":
                    k += 1
                if self.peek(k).kind == "KW" \
                        and self.peek(k).value in ("select", "with"):
                    save = self.i
                    try:
                        sel = self.select_stmt()
                        self.expect_op(")")
                        alias = self._table_alias()
                        cols = self._opt_column_alias_list()
                        return A.RSubquery(sel, alias, cols)
                    except SQLSyntaxError:
                        self.i = save
            if self.at_kw("select", "with", "from", "values"):
                sel = self.select_stmt()
                self.expect_op(")")
                alias = self._table_alias()
                cols = self._opt_column_alias_list()
                return A.RSubquery(sel, alias, cols)
            if self.at_kw("values"):
                self.next()
                rows = []
                while True:
                    self.expect_op("(")
                    row = [self.expr()]
                    while self.accept_op(","):
                        row.append(self.expr())
                    self.expect_op(")")
                    rows.append(row)
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                self.accept_kw("as")
                alias = None
                if self.peek().kind == "IDENT" \
                        and self.peek().value not in _NON_ALIAS:
                    alias = self.next().value
                cols = self._opt_column_alias_list()
                return A.RValues(rows, alias, cols)
            ref = self.table_ref()
            self.expect_op(")")
            return ref
        if self.peek().kind == "STR":
            # FROM 'file.csv' / 'file.parquet' / 'file.json': the path
            # dispatches to the matching reader (reference: replacement
            # scans, src/main/extension/extension_helper.cpp +
            # read_csv replacement scan)
            path = self.next().value
            alias = None
            if self.accept_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "IDENT" \
                    and self.peek().value not in _NON_ALIAS:
                alias = self.next().value
            low = path.lower()
            if low.endswith(".parquet") or low.endswith(".pq"):
                fn = "read_parquet"
            elif low.endswith(".json") or low.endswith(".ndjson") \
                    or low.endswith(".jsonl"):
                fn = "read_json_auto"
            else:
                fn = "read_csv_auto"
            return A.RFunction(fn, [path], alias)
        name = self.ident()
        # qualified name: db.table (ATTACHed databases / main catalog)
        while self.at("OP", ".") and self.peek(1).kind in ("IDENT", "KW"):
            self.next()
            name += "." + self.ident()
        if self.at("OP", "("):
            self.next()
            args = []
            kwargs = {}

            def _one():
                if self.peek().kind in ("IDENT", "KW") \
                        and self.peek(1).kind == "OP" \
                        and self.peek(1).value in ("=", ":="):
                    key = self.next().value.lower()
                    self.next()
                    kwargs[key] = self.expr()
                else:
                    args.append(self.expr())

            if not self.at("OP", ")"):
                _one()
                while self.accept_op(","):
                    _one()
            self.expect_op(")")
            alias = None
            if self.accept_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "IDENT" \
                    and self.peek().value not in _NON_ALIAS:
                alias = self.next().value
            fcols = self._opt_column_alias_list()

            def _lit(a):
                if isinstance(a, A.ELit):
                    return a.value
                if isinstance(a, A.ETyped):
                    return a.text
                if isinstance(a, A.EUnary) and a.op == "-" \
                        and isinstance(a.child, A.ELit):
                    return -a.child.value
                if isinstance(a, A.EList):
                    return [x.value if isinstance(x, A.ELit)
                            else str(x) for x in a.items]
                if isinstance(a, A.EStruct):
                    return {n: _lit(v) for n, v in a.fields}
                # non-literal expression: keep the AST — macro
                # substitution / bind-time evaluation resolve it
                return a

            vals = [_lit(a) for a in args]
            kw = {k: _lit(v) for k, v in kwargs.items()}
            return A.RFunction(name, vals, alias, kwargs=kw,
                               column_aliases=fcols)
        alias = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "IDENT" \
                and self.peek().value not in _NON_ALIAS:
            alias = self.next().value
        return A.RBase(name, alias)

    def _opt_column_alias_list(self):
        """Optional (c1, c2, ...) column rename list after an alias."""
        if self.at("OP", "(") and self.peek(1).kind in ("IDENT", "KW") \
                and self.peek(2).kind == "OP" \
                and self.peek(2).value in (",", ")"):
            self.next()
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            return cols
        return None

    # ---- expressions (Pratt) --------------------------------------------
    def expr(self) -> A.EExpr:
        return self.expr_or()

    def expr_or(self):
        e = self.expr_and()
        while self.accept_kw("or"):
            e = A.EBinary("or", e, self.expr_and())
        return e

    def expr_and(self):
        e = self.expr_not()
        while self.accept_kw("and"):
            e = A.EBinary("and", e, self.expr_not())
        return e

    def expr_not(self):
        if self.accept_kw("not"):
            return A.EUnary("not", self.expr_not())
        return self.expr_cmp()

    def expr_cmp(self):
        e = self.expr_bit()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("=", "==", "<>", "!=",
                                              "<", "<=", ">", ">="):
                self.next()
                op = {"=": "==", "==": "==", "<>": "!=",
                      "!=": "!="}.get(t.value, t.value)
                if (self.at_kw("any", "all")
                        or (self.peek().kind == "IDENT"
                            and self.peek().value == "some")) \
                        and self.peek(1).kind == "OP" \
                        and self.peek(1).value == "(":
                    q = self.next().value
                    self.expect_op("(")
                    if self.at_kw("select", "with", "from", "values"):
                        sub = self.select_stmt()
                    else:
                        # ANY over a list expression: x = ANY([..])
                        le = self.expr()
                        sub = A.SelectStmt(
                            items=[(A.EFunc("unnest", [le]), "v")])
                    self.expect_op(")")
                    e = self._quantified(op, e, sub, q == "all")
                    continue
                e = A.EBinary(op, e, self.expr_bit())
                continue
            if t.kind == "KW":
                negated = False
                save = self.i
                if self.accept_kw("not"):
                    negated = True
                if self.accept_kw("between"):
                    lo = self.expr_add()
                    self.expect_kw("and")
                    hi = self.expr_add()
                    e = A.EBetween(e, lo, hi, negated)
                    continue
                if self.accept_kw("in"):
                    self.expect_op("(")
                    if self.at_kw("select", "with", "from", "values"):
                        sub = self.select_stmt()
                        self.expect_op(")")
                        e = A.EIn(e, subquery=sub, negated=negated)
                    else:
                        items = [self.expr()]
                        while self.accept_op(","):
                            items.append(self.expr())
                        self.expect_op(")")
                        e = A.EIn(e, items=items, negated=negated)
                    continue
                if self.accept_kw("like", "ilike"):
                    e = A.ELike(e, self.expr_add(), negated)
                    continue
                if self.accept_kw("is"):
                    neg2 = bool(self.accept_kw("not"))
                    self.expect_kw("null")
                    e = A.EIsNull(e, negated=neg2)
                    continue
                if negated:
                    self.i = save
            break
        return e

    def expr_bit(self):
        # bitwise/other-operator level: below comparison, above +/-
        # (Postgres gives all "other" operators one left-assoc level;
        # reference: &, |, <<, >> on integers and BIT)
        e = self.expr_add()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("&", "|", "<<", ">>"):
                self.next()
                e = A.EBinary(t.value, e, self.expr_add())
            else:
                return e

    def expr_add(self):
        e = self.expr_mul()
        while True:
            if self.peek().kind in ("KW", "IDENT") \
                    and self.peek().value == "at" \
                    and self.peek(1).value == "time" \
                    and self.peek(2).value == "zone":
                # expr AT TIME ZONE tz == timezone(tz, expr)
                self.next(); self.next(); self.next()
                e = A.EFunc("timezone", [self.expr_mul(), e])
            elif self.accept_op("+"):
                e = A.EBinary("+", e, self.expr_mul())
            elif self.accept_op("-"):
                e = A.EBinary("-", e, self.expr_mul())
            elif self.accept_op("||"):
                # NULL-propagating concat (distinct from concat(), which
                # skips NULLs — reference: concat_operator vs concat)
                e = A.EFunc("concat_op", [e, self.expr_mul()])
            else:
                return e

    def expr_mul(self):
        e = self.expr_unary()
        while True:
            if self.accept_op("*"):
                e = A.EBinary("*", e, self.expr_unary())
            elif self.accept_op("/"):
                e = A.EBinary("/", e, self.expr_unary())
            elif self.accept_op("//"):
                e = A.EBinary("//", e, self.expr_unary())
            elif self.accept_op("**") or self.accept_op("^"):
                e = A.EFunc("pow", [e, self.expr_unary()])
            elif self.at("OP", "%"):
                if getattr(self, "_limit_pct", False):
                    nxt = self.peek(1)
                    if nxt.kind == "EOF" \
                            or (nxt.kind == "OP"
                                and nxt.value in (";", ")")) \
                            or (nxt.kind == "KW"
                                and nxt.value in ("offset", "order",
                                                  "union", "except",
                                                  "intersect")):
                        return e   # LIMIT n %: percent marker, not modulo
                self.next()
                e = A.EBinary("%", e, self.expr_unary())
            else:
                return e

    def expr_unary(self):
        if self.accept_op("-"):
            return A.EUnary("-", self.expr_unary())
        if self.accept_op("~"):
            return A.EUnary("~", self.expr_unary())
        if self.accept_op("+"):
            return self.expr_unary()
        return self.expr_postfix()

    def expr_postfix(self):
        e = self.expr_primary()
        while True:
            if self.accept_op("::"):
                tn, w, s = self.typename()
                e = A.ECast(e, tn, w, s)
            elif self.at("OP", "!") \
                    and not (self.peek(1).kind == "OP"
                             and self.peek(1).value == "="):
                # postfix factorial (reference: operator !)
                self.next()
                e = A.EFunc("factorial", [e])
            elif self.accept_op("->"):
                e = A.EFunc("json_extract", [e, self.expr_primary()])
            elif self.accept_op("->>"):
                e = A.EFunc("json_extract_string",
                            [e, self.expr_primary()])
            elif self.at("OP", "["):
                # subscript: list[i], map[key], struct['field']
                self.next()
                idx = self.expr()
                self.expect_op("]")
                e = A.EIndex(e, idx)
            elif self.peek().kind == "IDENT" \
                    and self.peek().value == "collate":
                self.next()
                coll = self.ident()
                while self.at("OP", ".") \
                        and self.peek(1).kind in ("IDENT", "KW"):
                    self.next()
                    coll += "." + self.ident()
                e = A.ECollate(e, coll)
            elif self.at("OP", ".") and not isinstance(e, A.EIdent) \
                    and self.peek(1).kind in ("IDENT", "KW"):
                # struct field access on a non-identifier expression:
                # struct_pack(...).a, (expr).f  (identifier chains are
                # handled inside expr_primary as EIdent parts)
                self.next()
                e = A.EFunc("struct_extract",
                            [e, A.ELit(self.ident())])
            else:
                return e

    def typename(self):
        t = self.peek()
        if t.kind in ("IDENT", "KW"):
            name = self.next().value
        else:
            self.error("expected type name")
        if name in ("double", "timestamp") and self.peek().kind in (
                "IDENT", "KW") and self.peek().value == "precision":
            self.next()
        if name == "union" and self.at("OP", "("):
            # UNION(a INT, b VARCHAR) — members encoded into the name,
            # decoded by resolve_typename (reference: union logical type)
            self.next()
            parts = []
            while True:
                mn = self.ident_orig()
                mt, mw, ms = self.typename()
                parts.append(f"{mn}:{mt}:{mw}:{ms}")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return "union<" + ",".join(parts) + ">", 0, 0
        if name in ("struct", "row") and self.at("OP", "("):
            # STRUCT(a INT, b VARCHAR) — members encoded into the name
            self.next()
            parts = []
            while True:
                mn = self.ident_orig()
                mt, mw, ms = self.typename()
                parts.append(f"{mn}:{mt}:{mw}:{ms}")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            name = "struct<" + ",".join(parts) + ">"
            # allow trailing [] handling below
            w = s = 0
            while self.at("OP", "["):
                self.next()
                if self.peek().kind == "NUM":
                    self.next()
                self.expect_op("]")
                name, w, s = f"list<{name}:{w}:{s}>", 0, 0
            return name, w, s
        if name == "map" and self.at("OP", "("):
            self.next()
            kt, kw_, ks = self.typename()
            self.expect_op(",")
            vt, vw, vs = self.typename()
            self.expect_op(")")
            return f"map<{kt}:{kw_}:{ks},{vt}:{vw}:{vs}>", 0, 0
        if name in ("time", "timestamp") and self.at_kw("with"):
            # WITH TIME ZONE (reference: LogicalType::TIMESTAMP_TZ and
            # TIME_TZ, src/include/duckdb/common/types.hpp) — both are
            # real logical types here
            self.next()
            self.expect_word("time")
            self.expect_word("zone")
            name = "timestamptz" if name == "timestamp" else "timetz"
        w = s = 0
        if self.accept_op("("):
            w = int(self.next().value)
            if self.accept_op(","):
                s = int(self.next().value)
            self.expect_op(")")
        while self.at("OP", "[") :
            # INTEGER[] / INTEGER[3] array types -> LIST (fixed-size
            # arrays are stored as lists, like the reference's ARRAY)
            self.next()
            if self.peek().kind == "NUM":
                self.next()
            self.expect_op("]")
            name, w, s = f"list<{name}:{w}:{s}>", 0, 0
        return name, w, s

    def _struct_body(self) -> A.EStruct:
        """{ 'name': expr, ... } (already past the opening brace)."""
        fields = []
        if not self.at("OP", "}"):
            while True:
                kt = self.next()
                if kt.kind not in ("STR", "IDENT", "KW", "QID"):
                    self.error("expected struct field name")
                self.expect_op(":")
                fields.append((kt.value, self.expr()))
                if not self.accept_op(","):
                    break
        self.expect_op("}")
        return A.EStruct(fields)

    def expr_primary(self):
        t = self.peek()
        if t.kind == "OP" and t.value == "{":
            self.next()
            return self._struct_body()
        if t.kind == "IDENT" and t.value.lower() == "map" \
                and self.peek(1).kind == "OP" \
                and self.peek(1).value == "{":
            # MAP {k: v, ...}
            self.next()
            self.next()
            entries = []
            if not self.at("OP", "}"):
                while True:
                    k = self.expr()
                    self.expect_op(":")
                    entries.append((k, self.expr()))
                    if not self.accept_op(","):
                        break
            self.expect_op("}")
            return A.EMap(entries)
        if t.kind in ("IDENT", "KW") \
                and t.value.lower() in ("struct_pack", "row") \
                and self.peek(1).kind == "OP" \
                and self.peek(1).value == "(":
            # struct_pack(a := e, ...) / row(e1, e2, ...)
            is_row = t.value.lower() == "row"
            self.next()
            self.next()
            fields = []
            i = 0
            if not self.at("OP", ")"):
                while True:
                    if self.peek().kind in ("IDENT", "QID") \
                            and self.peek(1).kind == "OP" \
                            and self.peek(1).value == ":=":
                        ftok = self.next()
                        fname = ftok.orig if ftok.orig is not None \
                            else ftok.value
                        self.next()
                    else:
                        if not is_row:
                            self.error("struct_pack needs name := value")
                        fname = f"v{i + 1}"
                    fields.append((fname, self.expr()))
                    i += 1
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            return A.EStruct(fields)
        if t.kind == "IDENT" and t.value.lower() == "struct_insert" \
                and self.peek(1).kind == "OP" \
                and self.peek(1).value == "(":
            # struct_insert(s, a := e, ...) -> EFunc(s, EStruct(fields))
            self.next()
            self.next()
            base = self.expr()
            fields = []
            while self.accept_op(","):
                fname = self.next().value
                if not self.accept_op(":="):
                    self.expect_op(":")
                    self.expect_op("=")
                fields.append((fname, self.expr()))
            self.expect_op(")")
            return A.EFunc("struct_insert", [base, A.EStruct(fields)])
        if t.kind == "OP" and t.value == "[":
            # list literal [e1, e2, ...] or comprehension
            # [expr FOR x IN list [IF cond]]
            return self.expr_primary_bracket()
        if t.kind == "NUM":
            self.next()
            txt = t.value
            if "." in txt or "e" in txt.lower():
                if "e" in txt.lower():
                    return A.ELit(float(txt))
                return A.ELit(decimal.Decimal(txt))
            return A.ELit(int(txt))
        if t.kind == "STR":
            self.next()
            return A.ELit(t.value)
        if t.kind == "KW":
            if t.value in ("date", "timestamp", "time") \
                    and self.peek(1).kind == "STR":
                self.next()
                return A.ETyped(t.value, self.next().value)
            if t.value in ("timestamp", "time") \
                    and self.peek(1).value in ("with", "without") \
                    and self.peek(2).value == "time" \
                    and self.peek(3).value == "zone" \
                    and self.peek(4).kind == "STR":
                # TIMESTAMP/TIME WITH TIME ZONE '...' literals
                # (reference: LogicalType::TIMESTAMP_TZ typed literals)
                withtz = self.peek(1).value == "with"
                for _ in range(4):
                    self.next()
                name = t.value + ("tz" if withtz else "")
                return A.ETyped(name, self.next().value)
            if t.value == "interval":
                self.next()
                if self.peek().kind == "STR":
                    txt = self.next().value
                elif self.at("OP", "("):
                    # INTERVAL (expr) unit — parenthesized quantity
                    self.next()
                    txt = self.next().value
                    self.expect_op(")")
                else:
                    txt = self.next().value   # INTERVAL 3 MONTH
                unit = None
                if self.peek().kind in ("IDENT", "KW") \
                        and self.peek().value.lower() in _IV_UNITS:
                    unit = self.next().value.rstrip("s")
                    if unit == "centurie":
                        unit = "century"
                    elif unit == "millennia":
                        unit = "millennium"
                return A.ETyped("interval", txt, unit)
            if t.value in ("true", "false"):
                self.next()
                return A.ELit(t.value == "true")
            if t.value == "null":
                self.next()
                return A.ELit(None)
            if t.value == "case":
                return self.case_expr()
            if t.value in ("cast", "try_cast"):
                self.next()
                self.expect_op("(")
                e = self.expr()
                self.expect_kw("as")
                tn, w, s = self.typename()
                self.expect_op(")")
                return A.ECast(e, tn, w, s, t.value == "try_cast")
            if t.value == "exists":
                self.next()
                self.expect_op("(")
                sub = self.select_stmt()
                self.expect_op(")")
                return A.EExists(sub)
            if t.value == "not":
                self.next()
                return A.EUnary("not", self.expr_not())
            if t.value == "substring":
                self.next()
                self.expect_op("(")
                e = self.expr()
                if self.accept_kw("from"):
                    start = self.expr()
                    length = None
                    if self.accept_kw("for"):
                        length = self.expr()
                else:
                    self.expect_op(",")
                    start = self.expr()
                    length = None
                    if self.accept_op(","):
                        length = self.expr()
                self.expect_op(")")
                args = [e, start] + ([length] if length is not None else [])
                return A.EFunc("substring", args)
            if t.value == "extract":
                self.next()
                self.expect_op("(")
                part = self.next().value
                self.expect_kw("from")
                e = self.expr()
                self.expect_op(")")
                return A.EFunc(part.lower(), [e])
        if self.accept_op("("):
            if self.at_kw("select", "with", "from", "values"):
                sub = self.select_stmt()
                self.expect_op(")")
                return A.ESub(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "PARAM":
            self.next()
            if t.value == "?":
                return A.EParam(None)
            return A.EParam(int(t.value[1:]))
        if t.kind == "OP" and t.value == "*":
            self.next()
            return A.EStar()
        if t.kind == "KW" and t.value in ("left", "right", "replace") \
                and self.peek(1).kind == "OP" \
                and self.peek(1).value == "(":
            # keyword-named functions: left(s,n), right(s,n), replace(...)
            self.next()
            name = t.value
            self.next()
            args = []
            if not self.at("OP", ")"):
                args.append(self.expr())
                while self.accept_op(","):
                    args.append(self.expr())
            self.expect_op(")")
            return A.EFunc(name, args)
        if t.kind == "IDENT" \
                and t.value in ("timestamptz", "timetz", "datetime") \
                and self.peek(1).kind == "STR":
            # TIMESTAMPTZ '...' / TIMETZ '...' typed literals
            self.next()
            name = "timestamp" if t.value == "datetime" else t.value
            return A.ETyped(name, self.next().value)
        if t.kind == "IDENT" and t.value == "try_cast" \
                and self.peek(1).kind == "OP" and self.peek(1).value == "(":
            self.next()
            self.expect_op("(")
            e = self.expr()
            self.expect_kw("as")
            tn, w, s = self.typename()
            self.expect_op(")")
            return A.ECast(e, tn, w, s, True)
        if t.kind in ("IDENT", "KW"):
            name = self.ident()
            # function call?
            if self.at("OP", "("):
                self.next()
                if self.accept_op("*"):
                    self.expect_op(")")
                    fn = A.EFunc(name, [], star=True)
                    if self.at_kw("over"):
                        return self.window_suffix(fn)
                    return fn
                distinct = bool(self.accept_kw("distinct"))
                args = []
                if name == "union_value" and not self.at("OP", ")"):
                    # union_value(tag := expr)
                    tag = self.ident()
                    if not self.accept_op(":="):
                        self.expect_op(":")
                        self.expect_op("=")
                    args = [A.ELit(tag), self.expr()]
                    self.expect_op(")")
                    fn = A.EFunc(name, args)
                    return fn
                if not self.at("OP", ")"):
                    args.append(self._arg_expr())
                    while self.accept_op(","):
                        args.append(self._arg_expr())
                fnorder = None
                if self.accept_kw("order"):
                    # agg(x ORDER BY k [DESC], ...) ordered aggregate
                    self.expect_kw("by")
                    fnorder = self.order_items()
                self.expect_op(")")
                fn = A.EFunc(name, args, distinct=distinct,
                             order=fnorder)
                if self.peek().kind == "IDENT" \
                        and self.peek().value == "within":
                    # ordered-set aggregates: fn(frac) WITHIN GROUP
                    # (ORDER BY x) -> quantile-style call (reference:
                    # transform_function.cpp WITHIN GROUP rewrite)
                    self.next()
                    self.expect_kw("group")
                    self.expect_op("(")
                    self.expect_kw("order")
                    self.expect_kw("by")
                    items = self.order_items()
                    self.expect_op(")")
                    if len(items) != 1:
                        self.error("WITHIN GROUP needs one ORDER BY key")
                    col = items[0].expr
                    if items[0].desc:
                        # fraction p over DESC order == 1-p ascending
                        args = [A.ELit(1 - a.value)
                                if isinstance(a, A.ELit) else
                                A.EBinary("-", A.ELit(1), a)
                                for a in args]
                    rewritten = {"percentile_cont": "quantile_cont",
                                 "percentile_disc": "quantile_disc",
                                 "mode": "mode",
                                 "quantile_cont": "quantile_cont",
                                 "quantile_disc": "quantile_disc"}
                    if name not in rewritten:
                        self.error(
                            f"WITHIN GROUP unsupported for {name}")
                    fn = A.EFunc(rewritten[name], [col] + args,
                                 distinct=distinct)
                if self.at_kw("over"):
                    return self.window_suffix(fn)
                return fn
            if name in ("current_date", "current_timestamp",
                        "current_localtimestamp", "localtimestamp",
                        "today", "get_current_timestamp") \
                    and not self.at("OP", "."):
                # paren-less niladic datetime functions (reference:
                # these parse as special keywords in libpg_query)
                return A.EFunc({"today": "current_date",
                                "get_current_timestamp":
                                    "current_timestamp",
                                "localtimestamp":
                                    "current_localtimestamp"}.get(
                                        name, name), [])
            if name == "array" and self.at("OP", "["):
                # postgres-style ARRAY[...] constructor (reference:
                # transform_array_constructor) — re-parse as a list
                # literal / comprehension
                return self.expr_primary_bracket()
            parts = [name]
            while self.accept_op("."):
                if self.at("OP", "*"):
                    self.next()
                    return A.EStar(prefix=parts[0])
                parts.append(self.ident())
            return A.EIdent(parts)
        self.error("expected expression")

    def expr_primary_bracket(self):
        """[...] list literal / comprehension body (shared by bare
        bracket syntax and ARRAY[...])."""
        self.expect_op("[")
        items = []
        if not self.at("OP", "]"):
            items.append(self.expr())
            if self.at_kw("for") or (
                    self.peek().kind == "IDENT"
                    and self.peek().value == "for"):
                self.next()
                var = self.ident()
                self.expect_kw("in")
                src = self.expr()
                cond = None
                if self.peek().kind in ("KW", "IDENT") \
                        and self.peek().value == "if":
                    self.next()
                    cond = self.expr()
                self.expect_op("]")
                if cond is not None:
                    src = A.EFunc("list_filter",
                                  [src, A.ELambda([var], cond)])
                return A.EFunc("list_transform",
                               [src, A.ELambda([var], items[0])])
            while self.accept_op(","):
                items.append(self.expr())
        self.expect_op("]")
        return A.EList(items)

    def _arg_expr(self):
        """A function-call argument: possibly a lambda
        `x -> body` / `(x, y) -> body` / `lambda x[, y]: body`
        (reference: transform_lambda.cpp; lambdas are only legal as
        arguments, which keeps -> unambiguous with the JSON arrow)."""
        t = self.peek()
        # IDENT ->
        if t.kind == "IDENT" and self.peek(1).kind == "OP" \
                and self.peek(1).value == "->":
            p = self.next().value
            self.next()
            return A.ELambda([p], self.expr())
        # lambda x[, y]: body
        if t.kind == "IDENT" and t.value == "lambda" \
                and self.peek(1).kind == "IDENT":
            self.next()
            ps = [self.ident()]
            while self.accept_op(","):
                ps.append(self.ident())
            self.expect_op(":")
            return A.ELambda(ps, self.expr())
        # ( IDENT [, IDENT]* ) ->
        if t.kind == "OP" and t.value == "(":
            j = 1
            ok = self.peek(j).kind == "IDENT"
            j += 1
            while ok and self.peek(j).kind == "OP" \
                    and self.peek(j).value == ",":
                ok = self.peek(j + 1).kind == "IDENT"
                j += 2
            if ok and self.peek(j).kind == "OP" \
                    and self.peek(j).value == ")" \
                    and self.peek(j + 1).kind == "OP" \
                    and self.peek(j + 1).value == "->":
                self.next()
                ps = [self.ident()]
                while self.accept_op(","):
                    ps.append(self.ident())
                self.expect_op(")")
                self.next()        # ->
                return A.ELambda(ps, self.expr())
        return self.expr()

    def window_suffix(self, fn: A.EFunc) -> A.EWindow:
        self.expect_kw("over")
        if self.peek().kind == "IDENT" and not self.at("OP", "("):
            # OVER window_name (resolved from the WINDOW clause)
            return A.EWindow(fn, ref=self.ident())
        self.expect_op("(")
        w = A.EWindow(fn)
        if self.accept_kw("partition"):
            self.expect_kw("by")
            w.partition.append(self.expr())
            while self.accept_op(","):
                w.partition.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            w.order = self.order_items()
        if self.at_kw("rows", "range") or (self.peek().kind == "IDENT" and self.peek().value == "groups"):
            # frame clause parsed but only defaults supported for now
            frame_kind = self.next().value
            parts = [frame_kind]
            while not self.at("OP", ")"):
                parts.append(self.next().value)
            w.frame = " ".join(parts)
        self.expect_op(")")
        return w

    def case_expr(self):
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            c = self.expr()
            self.expect_kw("then")
            v = self.expr()
            whens.append((c, v))
        else_ = None
        if self.accept_kw("else"):
            else_ = self.expr()
        self.expect_kw("end")
        return A.ECase(operand, whens, else_)

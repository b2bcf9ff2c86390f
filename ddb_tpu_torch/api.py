"""Client API: connect / Connection / QueryResult (PyTorch port of
ddb_tpu/api.py, SELECT queries only).

The device is explicit: `connect(device="cuda")` runs every query on the
GPU and raises when CUDA is unavailable; the tests pass `device="cpu"`.
"""

from __future__ import annotations

import decimal
from typing import Any, Dict, List

import numpy as np
import torch

from . import types as T
from .batch import Batch, Schema, bind_device
from .catalog import Catalog
from .config import Config
from .plan import physical
from .storage import table as storage
from .types import TypeId


class QueryResult:
    def __init__(self, schema: Schema, batch: Batch):
        self.schema = schema
        self.batch = batch
        self._rows = None

    @property
    def column_names(self) -> List[str]:
        return self.schema.names

    # ---- materialization -------------------------------------------------
    def _host_columns(self):
        sel = self.batch.sel.cpu().numpy()
        cols = []
        for f, c in zip(self.schema.fields, self.batch.columns):
            d = c.data.cpu().numpy()[sel]
            if c.hi is not None:
                # wide (i128) value: exact reconstruction with Python ints;
                # int64 wrap preserves the low 32 bits of `data`
                hi = c.hi.cpu().numpy()[sel].astype(object)
                lo = (d & np.int64(0xFFFFFFFF)).astype(object)
                d = hi * (1 << 32) + lo
            n = c.nulls.cpu().numpy()[sel] if c.nulls is not None else None
            cols.append((f, d, n))
        return cols

    def fetchall(self) -> List[tuple]:
        if self._rows is None:
            ncols = [_decode_column(f, d, n)
                     for f, d, n in self._host_columns()]
            self._rows = list(zip(*ncols)) if ncols else []
        return self._rows

    def fetchone(self):
        rows = self.fetchall()
        return rows[0] if rows else None

    def fetchnumpy(self):
        """Dict of numpy arrays (masked where NULL)."""
        out = {}
        for f, d, n in self._host_columns():
            out[f.name] = np.ma.masked_array(d, mask=n) \
                if n is not None else d
        return out


def _decode_column(f, d, n):
    t = f.dtype
    out = []
    if t.id == TypeId.DECIMAL:
        q = decimal.Decimal(1).scaleb(-t.scale)
        for i, v in enumerate(d):
            out.append(None if (n is not None and n[i])
                       else decimal.Decimal(int(v)).scaleb(-t.scale)
                       .quantize(q))
        return out
    for i, v in enumerate(d):
        if n is not None and n[i]:
            out.append(None)
        else:
            out.append(T.decode_value(v, t, f.strdict))
    return out


class Connection:
    """Catalog + config + plan cache; executes SELECT statements on one
    torch device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.catalog = Catalog()
        self.config = Config()
        self._plan_cache: Dict[str, Any] = {}
        # registries the binder consults (create_function,
        # create_aggregate; table functions and variables stay empty)
        self._udfs: Dict[str, tuple] = {}
        self._agg_udfs: Dict[str, tuple] = {}
        self._table_fns: Dict[str, tuple] = {}
        self._variables: Dict[str, tuple] = {}

    # ---- ingest ----------------------------------------------------------
    def register(self, name: str, obj) -> "Connection":
        """Register a dict of columns (lists of Python values or numpy
        arrays)."""
        if not isinstance(obj, dict):
            raise NotImplementedError(
                f"register() of {type(obj).__name__}: dicts only")
        self.catalog.add_table(storage.from_pydict(name, obj),
                               or_replace=True)
        return self

    def create_function(self, name: str, fn, return_type=None,
                        *_ignored, **_kw) -> "Connection":
        """Register a Python scalar function callable from SQL
        (reference: duckdb.create_function).  `return_type`: a DataType,
        an SQL type name, or None for BIGINT.  The function is called row
        by row on the host with Python values (VARCHAR arguments arrive
        as str); returning None yields NULL."""
        self._udfs[name.lower()] = (fn, _resolve_type(return_type))
        self.catalog.bump()
        return self

    def create_aggregate(self, name: str, init, update, finalize,
                         return_type=None) -> "Connection":
        """Register a user aggregate (reference:
        duckdb_create_aggregate_function).  `init()` returns a fresh
        state, `update(state, value)` folds one non-NULL value,
        `finalize(state)` returns the result (None => NULL).  It runs on
        the host aggregate path."""
        self._agg_udfs[name.lower()] = (init, update, finalize,
                                        _resolve_type(return_type))
        self.catalog.bump()
        return self

    # ---- query -----------------------------------------------------------
    def execute(self, sql: str, params=None) -> QueryResult:
        from .sql import parser as sqlparser
        stmts = sqlparser.parse(sql)
        if len(stmts) == 1 and params is None:
            stmts[0]._sql_text = sql     # plan-cache key
        result = None
        for stmt in stmts:
            r = self._execute_statement(stmt, params)
            if r is not None:
                result = r   # last row-returning statement wins
        return result

    sql = execute

    def _execute_statement(self, stmt, params=None) -> QueryResult:
        from .plan import optimizer
        from .sql import ast as A
        from .sql.binder import Binder
        if not isinstance(stmt, A.SelectStmt):
            raise NotImplementedError(
                f"{type(stmt).__name__}: only SELECT is ported")
        # plan cache: reuse plans while the catalog version is unchanged
        ckey = getattr(stmt, "_sql_text", None)
        cached = self._plan_cache.get(ckey) if ckey else None
        if cached is not None and cached[0] == self.catalog.version \
                and params is None:
            plan = cached[1]
        else:
            binder = Binder(self.catalog, context=self)
            if params is not None:
                binder.params = list(params)
            try:
                # sub-plans the binder folds while it binds run on this
                # connection's device
                with bind_device(self.device):
                    plan = optimizer.optimize(binder.bind_select(stmt))
            except ModuleNotFoundError as e:
                # the binder or a table function imports a module of this
                # package that is not carried over (out-of-core storage,
                # the remote file cache, autocomplete)
                if not (e.name or "").startswith(__package__ + "."):
                    raise
                raise NotImplementedError(
                    f"{e.name} is not ported") from e
            if ckey and params is None \
                    and not getattr(binder, "uncacheable", False):
                self._plan_cache[ckey] = (self.catalog.version, plan)
        schema, batch = physical.execute(plan, self.device)
        return QueryResult(schema, batch)


def _resolve_type(return_type):
    if return_type is None:
        return T.BIGINT
    if isinstance(return_type, str):
        from .sql.binder import resolve_typename
        return resolve_typename(return_type, 0, 0)
    return return_type


def _const_python_value(bound):
    """Bound constant expression -> Python value (the binder reads table
    function arguments through this)."""
    from .expr import ir
    from .expr.compile import evaluate_const
    if isinstance(bound, ir.Const) and bound.value is None:
        return None
    if isinstance(bound, ir.Const):
        raw = bound.value
    else:
        # cast chains, functions: evaluate over a one-row host batch
        d, n = evaluate_const(bound)
        if n is not None and bool(n[0]):
            return None
        raw = d[0].numpy()[()]
    sd = getattr(bound, "strdict", None)
    if sd is not None:
        return sd.decode_one(int(raw))
    return T.decode_value(raw, bound.dtype)


def connect(device="cuda") -> Connection:
    """A new in-memory database whose queries run on `device`."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("connect(device='cuda'): CUDA is not available")
    return Connection(device)

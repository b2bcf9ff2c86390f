"""Bridge between the C ABI (native/capi.c) and the Python engine.

The C layer embeds CPython and calls ONLY the functions in this module
(stable internal surface); the public C surface mirrors the reference's
C API (reference: src/include/duckdb.h, impl src/main/capi/*.cpp).

Everything returned to C is pre-lowered to C-friendly shapes: ints,
floats, UTF-8 bytes, and flat lists — no engine objects cross the
boundary except opaque handles.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from .types import TypeId

# ddb_type enum values — MUST match native/include/ddb_tpu_c.h
_TYPE_CODES = {
    TypeId.BOOLEAN: 1,
    TypeId.TINYINT: 2,
    TypeId.SMALLINT: 3,
    TypeId.INTEGER: 4,
    TypeId.BIGINT: 5,
    TypeId.HUGEINT: 6,
    TypeId.FLOAT: 7,
    TypeId.DOUBLE: 8,
    TypeId.DECIMAL: 9,
    TypeId.VARCHAR: 10,
    TypeId.BLOB: 11,
    TypeId.DATE: 12,
    TypeId.TIME: 13,
    TypeId.TIMESTAMP: 14,
    TypeId.INTERVAL: 15,
    TypeId.LIST: 16,
    TypeId.STRUCT: 17,
    TypeId.MAP: 18,
    TypeId.UUID: 19,
}


def open_database(path: Optional[str], config=None):
    """Returns an opaque database handle (the connect factory args).
    `config`: [(name, value), ...] applied to every connection
    (reference: duckdb_open_ext + duckdb_config)."""
    return {"path": path if path not in (None, "", ":memory:") else None,
            "config": list(config or [])}


def connect(db) -> object:
    """A connection on the torch device that DDB_CAPI_PLATFORM names,
    the card by default; without CUDA that default raises, and nothing
    falls back to the CPU."""
    from .api import connect as connect_device
    device = os.environ.get("DDB_CAPI_PLATFORM", "cuda")
    # creates a WAL-backed DB if absent
    con = connect_device(device, database=db["path"])
    for k, v in db.get("config") or []:
        con.execute(f"SET {k} = '{v}'")
    return con


def config_settings():
    """[(name, description)] of every recognized setting (reference:
    duckdb_config_count / duckdb_get_config_flag)."""
    from .config import SETTINGS
    return [(s.name, s.description) for s in SETTINGS]


def query(con, sql: str):
    """Execute sql; returns (names, type_codes, columns, meta) where
    columns is a list of per-column value lists (None for NULL, values
    lowered to int/float/bytes/bool) and meta is per-column
    (width, scale) for DECIMAL fidelity at the C boundary."""
    res = con.execute(sql)
    if res is None:
        return ([], [], [], [])
    rows = res.fetchall()
    names = [str(n) for n in res.column_names]
    codes = [_TYPE_CODES.get(t.id, 0) for t in res.column_types]
    meta = [(int(t.width), int(t.scale)) for t in res.column_types]
    ncols = len(names)
    columns: List[list] = [[] for _ in range(ncols)]
    for r in rows:
        for j in range(ncols):
            columns[j].append(_lower(r[j]))
    return (names, codes, columns, meta)


def _lower(v):
    if v is None or isinstance(v, (bool, int, float)):
        return v
    if isinstance(v, bytes):
        return v
    import decimal
    if isinstance(v, decimal.Decimal):
        return float(v)
    return str(v)


def execute_params(con, sql: str, params: list):
    return query_with(con, sql, params)


def query_with(con, sql: str, params: list):
    res = con.execute(sql, params if params else None)
    if res is None:
        return ([], [], [], [])
    rows = res.fetchall()
    names = [str(n) for n in res.column_names]
    codes = [_TYPE_CODES.get(t.id, 0) for t in res.column_types]
    meta = [(int(t.width), int(t.scale)) for t in res.column_types]
    ncols = len(names)
    columns: List[list] = [[] for _ in range(ncols)]
    for r in rows:
        for j in range(ncols):
            columns[j].append(_lower(r[j]))
    return (names, codes, columns, meta)


def appender_create(con, table: str):
    return con.appender(table)


def appender_rows(app, rows: List[Tuple]):
    for r in rows:
        app.append_row(*r)


def appender_flush(app):
    app.flush()


_CODE_TO_TYPE = {v: k for k, v in _TYPE_CODES.items()}


def register_scalar(con, name: str, callable_, ret_code: int):
    """Register a C-trampoline scalar UDF (reference:
    duckdb_create_scalar_function; the callable is a PyCFunction built
    by native/capi.c around the user's C function pointer)."""
    from . import types as T
    tid = _CODE_TO_TYPE.get(int(ret_code))
    if tid is None:
        raise ValueError(f"bad return type code {ret_code}")
    con.create_function(name, callable_, T.DataType(tid))
    return True


def register_aggregate(con, name: str, init, update, finalize,
                       ret_code: int):
    """Register a C-trampoline aggregate (reference:
    duckdb_create_aggregate_function; the callables are PyCFunctions
    built by native/capi.c around the user's state callbacks)."""
    from . import types as T
    tid = _CODE_TO_TYPE.get(int(ret_code))
    if tid is None:
        raise ValueError(f"bad return type code {ret_code}")
    con.create_aggregate(name, init,
                         lambda st, v: update(st, v),
                         finalize, T.DataType(tid))
    return True


def register_table(con, name: str, callable_, names, type_codes):
    """Register a C-trampoline table function (reference:
    duckdb_create_table_function; the callable returns the full row
    list per invocation, built by native/capi.c)."""
    from . import types as T
    cols = []
    for cn, code in zip(names, type_codes):
        tid = _CODE_TO_TYPE.get(int(code))
        if tid is None:
            raise ValueError(f"bad column type code {code}")
        cols.append((str(cn), T.DataType(tid)))
    con.create_table_function(name, callable_, cols)
    return True

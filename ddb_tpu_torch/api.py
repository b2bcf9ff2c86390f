"""Client API: connect / Database / Connection / QueryResult / Cursor /
Appender (PyTorch port of ddb_tpu/api.py).

The device is explicit: `connect(device="cuda")` runs every statement on
the GPU and raises when CUDA is unavailable; the tests pass
`device="cpu"`.  `connect(device, database=path)` opens a database file:
the last checkpoint loads, its write-ahead log replays, and every later
mutation is logged.  Every statement kind of the reference runs.  COPY,
EXPORT and IMPORT read and write CSV in torch on the connection's device
(storage/csvscan.py, storage/csvwrite.py); Parquet goes through pyarrow,
imported where it is used, as in the reference.

`Connection.use_mesh(mesh)` runs every SELECT through the distributed
executor (parallel/executor.py) over the mesh's shards; a plan it does not
take falls back to one device.

A SELECT over a table above `external_threshold_rows` streams it through
the device in tiles of `tile_rows` rows where the reference does
(plan/tiled.py), and `SET memory_limit` bounds the buffer manager's
cached batches and the working set the external join may reserve.

A mutation replaces the table's column arrays on the host (copy-on-write,
storage/dml.py) and drops the table's cached device batches; the next
statement that reads the table uploads it again.
"""

from __future__ import annotations

import decimal
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import types as T
from .batch import (Batch, Schema, batch_to_host, bind_device, to_numpy,
                    to_pinned_numpy)
from .catalog import Catalog, CatalogException
from .config import Config
from .plan import logical as L
from .plan import physical
from .replication import ChangeDataCapture, SnapshotManager, TimestampManager
from .spans import span
from .storage import dml
from .storage import table as storage
from .types import TypeId

def _run_external(plan, config, device):
    """(schema, batch) of `plan` through the first out-of-core path that
    takes it, in the reference's order (ddb_tpu/api.py), else None: the
    plan then runs in memory."""
    from .plan import tiled
    for fn in (tiled.execute_tiled, tiled.execute_tiled_topn,
               tiled.execute_tiled_sort, tiled.execute_external_join):
        res = fn(plan, config, device)
        if res is not None:
            return res
    return None


class FatalError(IOError):
    """Unrecoverable database error; the connection is invalidated
    (reference: ValidChecker, src/main/valid_checker.hpp).  An IOError,
    since every fatal path wraps a storage-corruption IOError."""


class QueryResult:
    def __init__(self, schema: Schema, batch: Batch):
        self.schema = schema
        self.batch = batch
        self._rows = None

    @property
    def column_names(self) -> List[str]:
        return self.schema.names

    @property
    def column_types(self):
        return self.schema.types

    def df(self):
        import pandas as pd
        return pd.DataFrame(self.fetchall(), columns=self.column_names)

    def arrow(self):
        """An Arrow table of the result (pyarrow is imported here, as the
        reference's QueryResult.arrow does)."""
        import pyarrow as pa
        arrays = {}
        for f, d, n in self._host_columns():
            t = f.dtype
            mask = n
            if t.id == TypeId.VARCHAR:
                idx = pa.array(d.astype(np.int32), mask=mask)
                arrays[f.name] = pa.DictionaryArray.from_arrays(
                    idx, pa.array(f.strdict.values.astype(object)))
            elif t.id == TypeId.DECIMAL and d.dtype == np.int64:
                # the scaled integers as decimal128's 16-byte words: the
                # values pa.array of the Decimals gives, without them
                words = np.empty((len(d), 2), dtype=np.int64)
                words[:, 0] = d
                words[:, 1] = d >> 63
                valid = None if mask is None else \
                    pa.array(~np.asarray(mask, dtype=bool)).buffers()[1]
                arrays[f.name] = pa.Array.from_buffers(
                    pa.decimal128(max(t.width, 19), t.scale), len(d),
                    [valid, pa.py_buffer(words)],
                    null_count=0 if mask is None else int(mask.sum()))
            elif t.id == TypeId.DECIMAL:
                vals = [None if (mask is not None and mask[i])
                        else decimal.Decimal(int(v)).scaleb(-t.scale)
                        for i, v in enumerate(d)]
                arrays[f.name] = pa.array(
                    vals, pa.decimal128(max(t.width, 19), t.scale))
            elif t.id == TypeId.DATE:
                arrays[f.name] = pa.array(d.astype("datetime64[D]"),
                                          mask=mask)
            elif t.id == TypeId.TIMESTAMP:
                arrays[f.name] = pa.array(d.astype("datetime64[us]"),
                                          mask=mask)
            elif t.id == TypeId.TIMESTAMPTZ:
                arrays[f.name] = pa.array(
                    d.astype("datetime64[us]"), mask=mask).cast(
                        pa.timestamp("us", tz="UTC"))
            elif t.id == TypeId.TIME:
                arrays[f.name] = pa.array(
                    d.astype(np.int64) % 86_400_000_000,
                    mask=mask).cast(pa.time64("us"))
            elif t.id == TypeId.INTERVAL:
                # months ride the high bits of the packed int64
                # (types.py interval_pack); month-free columns export as
                # plain durations, calendar intervals as
                # month_day_nano like the reference's Arrow bridge
                months = np.array([T.interval_unpack(int(v))[0]
                                   for v in d], dtype=np.int64)
                if months.any():
                    vals = []
                    for i, v in enumerate(d):
                        if mask is not None and mask[i]:
                            vals.append(None)
                            continue
                        mo, us = T.interval_unpack(int(v))
                        days, rem = divmod(us, 86_400_000_000)
                        vals.append((mo, int(days), int(rem) * 1000))
                    arrays[f.name] = pa.array(
                        vals, pa.month_day_nano_interval())
                else:
                    arrays[f.name] = pa.array(
                        (d - months * T.INTERVAL_MONTH)
                        .astype("timedelta64[us]"), mask=mask)
            elif t.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP,
                          TypeId.BLOB):
                vals = [None if (mask is not None and mask[i])
                        else f.strdict.decode_one(int(v))
                        for i, v in enumerate(d)]
                if t.id == TypeId.MAP:
                    # pa.array infers struct from dicts; build an explicit
                    # map array (insertion order kept)
                    pairs = [None if v is None else list(v.items())
                             for v in vals]
                    arrays[f.name] = pa.array(
                        pairs, type=pa.map_(
                            pa.array([k for v in pairs or [] if v
                                      for k, _ in v]).type
                            if any(pairs) else pa.string(),
                            pa.array([x for v in pairs or [] if v
                                      for _, x in v]).type
                            if any(pairs) else pa.int64()))
                else:
                    arrays[f.name] = pa.array(vals)
            else:
                arrays[f.name] = pa.array(d, mask=mask)
        return pa.table(arrays)

    def __repr__(self):
        rows = self.fetchall()
        head = " | ".join(self.column_names)
        lines = [head, "-" * len(head)]
        for r in rows[:20]:
            lines.append(" | ".join(str(v) for v in r))
        if len(rows) > 20:
            lines.append(f"... ({len(rows)} rows)")
        return "\n".join(lines)

    # ---- materialization -------------------------------------------------
    def _host_columns(self):
        with span("ddb.api.fetch"):
            data, nulls = batch_to_host(self.batch, self.schema)
            return list(zip(self.schema.fields, data, nulls))

    def fetchall(self) -> List[tuple]:
        if self._rows is None:
            with span("ddb.api.fetch"):
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


class StreamQueryResult:
    """Chunked result streaming (reference: StreamQueryResult,
    ddb_tpu/api.py).  A Project/Filter chain over one table, with an
    optional LIMIT/OFFSET, runs tile by tile: each tile of TILE_ROWS rows
    of the columns the scan reads is uploaded to the connection's device,
    runs the chain there and comes back as rows.  A LIMIT stops the scan
    early, and the table's whole batch is never built.  Any other plan
    runs in memory behind the same interface.

    The reference takes a LIMIT only at the plan's top; its optimizer
    puts the projection above it (`SELECT a FROM t LIMIT n` plans as
    Project(Limit(Get))), so there such a statement runs in memory.  Here
    the projections above a LIMIT join the chain, which gives the same
    rows: a projection keeps every row."""

    TILE_ROWS = 1 << 16

    def __init__(self, plan: "L.LogicalNode", device):
        import copy
        from .expr import ir
        self.schema = plan.schema
        self.device = torch.device(device)
        self.tiles_scanned = 0
        self._iter = None
        self._res = None
        limit, offset = None, 0
        chain = []
        node = plan
        while isinstance(node, L.Project):
            chain.append(node)
            node = node.child
        if isinstance(node, L.Limit) and node.percent is None:
            limit, offset = node.limit, node.offset
            node = node.child
        else:
            chain, node = [], plan
        while isinstance(node, (L.Project, L.Filter)):
            chain.append(node)
            node = node.child
        if isinstance(node, L.Get):
            self._limit, self._offset = limit, offset
            self._get = node
            cell = L.CTECell()
            tnode: L.LogicalNode = L.CTERef("__stream", node.schema, cell)
            if node.filters:
                tnode = L.Filter(tnode, ir.make_and(node.filters))
            for ln in reversed(chain):
                n2 = copy.copy(ln)
                n2.child = tnode
                tnode = n2
            self._cell = cell
            self._tile_plan = tnode
        else:
            self._res = QueryResult(*physical.execute(plan, self.device))

    def _rows_iter(self):
        if self._res is not None:
            yield from self._res.fetchall()
            return
        from .batch import bucket_capacity, make_batch
        table = self._get.table
        n = table.num_rows
        cols = [table.columns[i] for i in self._get.column_indices]
        cap = bucket_capacity(min(self.TILE_ROWS, max(n, 1)))
        remaining_skip = self._offset or 0
        remaining = self._limit
        for lo in range(0, n, self.TILE_ROWS):
            hi = min(lo + self.TILE_ROWS, n)
            self._cell.batch = make_batch(
                [c.data[lo:hi] for c in cols],
                [None if c.nulls is None else c.nulls[lo:hi] for c in cols],
                count=hi - lo, capacity=cap, device=self.device)
            self.tiles_scanned += 1
            with bind_device(self.device):
                rows = QueryResult(*physical.execute(
                    self._tile_plan, self.device)).fetchall()
            self._cell.batch = None
            if remaining_skip:
                if remaining_skip >= len(rows):
                    remaining_skip -= len(rows)
                    continue
                rows = rows[remaining_skip:]
                remaining_skip = 0
            if remaining is not None:
                rows = rows[:remaining]
                remaining -= len(rows)
            yield from rows
            if remaining == 0:
                return   # early exit: later tiles are never scanned

    def __iter__(self):
        if self._iter is None:
            self._iter = self._rows_iter()
        return self._iter

    def fetchone(self):
        try:
            return next(iter(self))
        except StopIteration:
            return None

    def fetchmany(self, k: int = 1024) -> List[tuple]:
        out = []
        it = iter(self)
        for _ in range(k):
            try:
                out.append(next(it))
            except StopIteration:
                break
        return out

    def fetchall(self) -> List[tuple]:
        return list(iter(self))

    @property
    def column_names(self):
        return self.schema.names


class TransactionException(Exception):
    """Commit-time conflict: the transaction was rolled back
    (reference: TransactionException, src/common/exception.cpp)."""


class Database:
    """Shared database instance: catalog + write lock.  Connections
    attached to one Database see each other's committed changes, each
    on its own device (reference: DatabaseInstance, src/main/
    database.cpp + DuckTransactionManager)."""

    def __init__(self):
        self.catalog = Catalog()
        self.lock = threading.RLock()


class Connection:
    """A session on one torch device over a (possibly shared) Database:
    catalog, settings, plan cache, prepared statements, transactions."""

    def __init__(self, device, database: Optional[Database] = None):
        self.device = torch.device(device)
        self._db = database if database is not None else Database()
        self.catalog = self._db.catalog
        self.config = Config()
        # text -> (catalog version, optimized plan, unoptimized plan)
        self._plan_cache: Dict[str, Any] = {}
        self.clock = TimestampManager()
        self.cdc = ChangeDataCapture(self.clock)
        self.snapshots = SnapshotManager()
        self._txn_ops = None              # logical ops buffered in a txn
        self._txn_events = None           # CDC events buffered in a txn
        self._replaying = False           # COMMIT or a WAL re-applies ops
        self._prepared: Dict[str, str] = {}   # PREPARE name -> sql text
        self._attached: Dict[str, str] = {}   # ATTACH name -> path
        # registries the binder consults
        self._udfs: Dict[str, tuple] = {}
        self._agg_udfs: Dict[str, tuple] = {}
        self._table_fns: Dict[str, tuple] = {}
        self._variables: Dict[str, tuple] = {}  # SET VARIABLE
        from .logging_ import LogManager
        from .secrets import SecretManager
        self.log = LogManager()
        self.secret_manager = SecretManager()
        self._db_path: Optional[str] = None   # the opened database file
        self._wal = None                      # its WriteAheadLog
        self._redo = None                     # redo transport (redo.py)
        self._invalidated: Optional[str] = None   # fatal-error latch
        self.mesh = None                  # set by use_mesh()

    def use_mesh(self, mesh) -> "Connection":
        """Execute queries distributed over a parallel.mesh.Mesh (tables
        row-sharded, aggregates and joins through hash exchanges).  A plan
        the distributed executor does not take falls back to one
        device."""
        self.mesh = mesh
        return self

    # ---- replication / fork-parity API ----------------------------------
    def on_change(self, callback) -> "Connection":
        """Register a CDC callback receiving ChangeEvent."""
        self.cdc.register(callback)
        return self

    def get_hlc_timestamp(self) -> int:
        return self.clock.get_hlc_timestamp()

    def set_hlc_timestamp(self, ts: int) -> None:
        self.clock.set_hlc_timestamp(ts)

    def create_snapshot(self) -> int:
        return self.snapshots.create(self.catalog)

    def remove_snapshot(self, sid: int) -> None:
        self.snapshots.remove(sid)

    # ---- persistence (native single-file storage) -----------------------
    # load and open_database replace tables outside `execute`, so each
    # forgets the plans of older catalog versions itself: a cached plan
    # would pin a replaced table and its device batch.
    def save(self, path: str) -> None:
        """Checkpoint the whole database to a single file (atomic; the
        native writer of native/dtbfile.cpp)."""
        from .storage.persist import save_database
        save_database(self.catalog, path)

    def load(self, path: str) -> "Connection":
        from .storage.persist import load_database
        try:
            load_database(self.catalog, path)
        except IOError as e:
            # an unrecoverable storage error latches the connection
            # invalid (reference: ValidChecker)
            self._invalidated = str(e)
            raise FatalError(str(e))
        finally:
            self._drop_stale_plans()
        return self

    def open_database(self, path: str) -> "Connection":
        """Open `path` as the durable database: load the last checkpoint,
        replay its WAL on this connection's device, then log every later
        mutation (reference: storage_manager.cpp LoadDatabase +
        wal_replay.cpp)."""
        from .storage.wal import WriteAheadLog, apply_record, replay_records
        self._db_path = path
        t0 = time.perf_counter()
        if os.path.exists(path):
            self.load(path)
        t1 = time.perf_counter()
        records = 0
        self._replaying = True
        try:
            with bind_device(self.device):
                for rec in replay_records(path + ".wal"):
                    apply_record(self, rec)
                    records += 1
        finally:
            self._replaying = False
            self._drop_stale_plans()
        self._wal = WriteAheadLog(path + ".wal")
        # the two host-side parts of the time to recover
        self.open_stats = {"load_s": t1 - t0,
                           "replay_s": time.perf_counter() - t1,
                           "records": records}
        return self

    def checkpoint(self) -> None:
        """Persist the full database and truncate the WAL (reference:
        CheckpointManager::CreateCheckpoint)."""
        if self._db_path is None:
            return
        self.save(self._db_path)
        if self._wal is not None:
            self._wal.truncate()

    def close(self) -> None:
        if self._wal is not None:
            if self.config.get("checkpoint_on_shutdown"):
                self.checkpoint()
            self._wal.close()
            self._wal = None

    def __enter__(self) -> "Connection":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def _wal_active(self) -> bool:
        """Should mutations build logical records?  With a WAL file, a
        redo transport, or inside a transaction (the ops replay at
        COMMIT)."""
        return (self._wal is not None or self._txn_ops is not None
                or self._redo is not None) and not self._replaying

    def attach_redo_transport(self, path: str) -> "Connection":
        """Stream every logical WAL record to an append-only redo file
        that a redo.Follower tails."""
        from .redo import RedoWriter
        self._redo = RedoWriter(path)
        return self

    def detach_redo_transport(self) -> "Connection":
        if self._redo is not None:
            self._redo.close()
            self._redo = None
        return self

    def _wal_log(self, rec: dict) -> None:
        if self._replaying:
            return
        if self._txn_ops is not None:       # buffer until COMMIT
            self._txn_ops.append(rec)
            return
        if self._redo is not None:
            self._redo.append(rec)
            self._redo.flush()
        if self._wal is None:
            return
        self._wal.append(rec)
        self._wal.flush()
        self._maybe_autocheckpoint()

    def _maybe_autocheckpoint(self) -> None:
        thr = self.config.get("wal_autocheckpoint")
        if thr and self._wal.size() > int(thr):
            self.checkpoint()

    # ---- ingest ----------------------------------------------------------
    def register(self, name: str, obj) -> "Connection":
        """Register a dict of columns (lists of Python values or numpy
        arrays), a pandas DataFrame or a pyarrow Table (each imported
        only here, as the reference does)."""
        if isinstance(obj, dict):
            td = storage.from_pydict(name, obj)
        elif type(obj).__module__.split(".")[0] == "pyarrow":
            td = storage.from_arrow(name, obj)
        else:
            td = storage.from_pandas(name, obj)
        self.catalog.add_table(td, or_replace=True)
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

    def create_table_function(self, name: str, fn,
                              columns) -> "Connection":
        """Register a Python table function callable from SQL FROM
        clauses (reference: duckdb_create_table_function,
        src/include/duckdb.h).  `fn(*args)` returns an iterable of row
        tuples; `columns` is a list of (name, type) pairs (DataType or
        SQL type-name strings)."""
        from .sql.binder import resolve_typename
        cols = []
        for cn, ct in columns:
            if isinstance(ct, str):
                ct = resolve_typename(ct.lower(), 0, 0)
            cols.append((str(cn), ct))
        self._table_fns[name.lower()] = (fn, cols)
        self.catalog.bump()
        return self

    def remove_function(self, name: str) -> "Connection":
        """Drop a scalar or aggregate function made by create_function or
        create_aggregate."""
        self._udfs.pop(name.lower(), None)
        self._agg_udfs.pop(name.lower(), None)
        self.catalog.bump()
        return self

    # ---- query -----------------------------------------------------------
    def execute(self, sql: str, params=None) -> Optional[QueryResult]:
        from .sql import parser as sqlparser
        with span("ddb.api.execute"):
            if self._invalidated is not None:
                raise FatalError("connection invalidated by a previous fatal "
                                 f"error: {self._invalidated}")
            with span("ddb.frontend.parse"):
                stmts = sqlparser.parse(sql)
            if len(stmts) == 1 and params is None:
                stmts[0]._sql_text = sql     # plan-cache key
            result = None
            # every binder call and every sub-plan it folds runs on this
            # connection's device
            with bind_device(self.device):
                for stmt in stmts:
                    try:
                        r = self._execute_statement(stmt, params)
                    except ModuleNotFoundError as e:
                        # the binder or a table function imports a module of
                        # this package that is not carried over
                        if not (e.name or "").startswith(__package__ + "."):
                            raise
                        raise NotImplementedError(
                            f"{e.name} is not ported") from e
                    finally:
                        self._drop_stale_plans()
                    if r is not None:
                        result = r   # last row-returning statement wins
            return result

    # ---- the lazy Relation API (relation.py) -----------------------------
    def table(self, name: str):
        from .relation import table_relation
        self.catalog.get_table(name)   # raises for an unknown table
        return table_relation(self, name)

    def view(self, name: str):
        from .relation import view_relation
        return view_relation(self, name)

    def sql(self, query: str):
        """A SELECT gives a lazy Relation; other statements execute now
        (reference: duckdb.sql)."""
        from .relation import sql_relation
        low = query.lstrip().lower()
        if low.startswith(("select", "with", "from", "values", "(")):
            with bind_device(self.device):
                return sql_relation(self, query)
        return self.execute(query)

    query = sql

    def values(self, rows, columns=None):
        from .relation import values_relation
        return values_relation(self, rows, columns)

    def table_function(self, name: str, *args):
        from .relation import table_function_relation
        return table_function_relation(self, name, *args)

    def from_df(self, df, name: Optional[str] = None):
        from .relation import table_relation
        name = name or f"__df_{id(df) & 0xFFFFFF:x}"
        self.register(name, df)
        return table_relation(self, name)

    def from_query(self, query: str):
        from .relation import sql_relation
        with bind_device(self.device):
            return sql_relation(self, query)

    def from_csv_auto(self, path: str):
        from .relation import sql_relation
        with bind_device(self.device):
            return sql_relation(
                self, f"SELECT * FROM read_csv_auto('{path}')")

    def from_parquet(self, path: str):
        from .relation import sql_relation
        with bind_device(self.device):
            return sql_relation(
                self, f"SELECT * FROM read_parquet('{path}')")

    # ---- files (reference: ddb_tpu/api.py read_parquet, read_csv) ---------
    def register_filesystem(self, scheme: str, fs) -> "Connection":
        """Register an fsspec-style filesystem for scheme:// paths in
        read_csv/read_parquet (reference: caching_file_system.cpp +
        pythonpkg register_filesystem); reads cache locally with
        version revalidation."""
        from .storage.cachefs import register_filesystem
        register_filesystem(scheme, fs)
        return self

    def unregister_filesystem(self, scheme: str) -> "Connection":
        from .storage.cachefs import unregister_filesystem
        unregister_filesystem(scheme)
        return self

    def read_parquet(self, name: str, path: str) -> "Connection":
        import pyarrow.parquet as pq
        self.catalog.add_table(
            storage.from_arrow(name, pq.read_table(path)), or_replace=True)
        return self

    def read_csv(self, name: str, path: str, **kw) -> "Connection":
        """The reference's pyarrow read: the header row names the columns
        (unless `column_names`), every type inferred as pyarrow infers
        it, empty fields NULL; parsed on this connection's device."""
        from .storage import csvscan
        td = csvscan.read(path, kw.get("column_names"), None,
                          delimiter=kw.get("delimiter", ","),
                          device=self.device, table_name=name)
        self.catalog.add_table(td, or_replace=True)
        return self

    def stream(self, sql: str) -> StreamQueryResult:
        """One SELECT with its rows streamed tile by tile (reference:
        Connection.stream)."""
        from .sql import ast as A
        from .sql import parser as sqlparser
        stmts = sqlparser.parse(sql)
        if len(stmts) != 1 or not isinstance(stmts[0], A.SelectStmt):
            raise ValueError("stream() takes exactly one SELECT")
        with bind_device(self.device):
            _, plan = self._plan(stmts[0])
            return StreamQueryResult(plan, self.device)

    def cursor(self) -> "Cursor":
        return Cursor(self)

    def duplicate(self) -> "Connection":
        """A new Connection on the same Database and device."""
        return Connection(self.device, self._db)

    def appender(self, table: str) -> "Appender":
        """Bulk row ingest with buffered flushes (reference:
        src/main/appender.cpp)."""
        return Appender(self, table)

    def _drop_stale_plans(self) -> None:
        """Forget the plans of older catalog versions: each holds its
        tables, and through them their device batches."""
        v = self.catalog.version
        for k in [k for k, e in self._plan_cache.items() if e[0] != v]:
            del self._plan_cache[k]

    def _optimize(self, plan):
        from .plan import optimizer
        return optimizer.optimize(plan)

    def _plan(self, select, params=None, key=None):
        """(bound plan, optimised plan) of a SELECT.  Under `key`, a plan
        cached at this catalog version is reused, and a new one kept."""
        with span("ddb.frontend.plan"):
            cached = self._plan_cache.get(key) if key else None
            if cached is not None and cached[0] == self.catalog.version:
                return cached[2], cached[1]
            binder = self._binder(params)
            with span("ddb.frontend.bind"):
                unopt = binder.bind_select(select)
            with span("ddb.frontend.optimize"):
                plan = self._optimize(unopt)
            if key and not getattr(binder, "uncacheable", False):
                self._plan_cache[key] = (self.catalog.version, plan, unopt)
            return unopt, plan

    def execute_plan(self, plan: L.LogicalNode) -> QueryResult:
        """Execute a hand-built bound logical plan on this connection's
        device (testing / internal)."""
        schema, batch = physical.execute(plan, self.device)
        return QueryResult(schema, batch)

    def table_data(self, name: str) -> storage.TableData:
        """Internal raw-TableData accessor (plan-building tests); the
        public .table() returns a lazy Relation like the reference."""
        return self.catalog.get_table(name)

    def _binder(self, params=None):
        from .sql.binder import Binder
        b = Binder(self.catalog, context=self)
        if params is not None:
            b.params = list(params)
        return b

    def _run(self, plan):
        """(schema, batch) of a plan, on this connection's device."""
        return physical.execute(plan, self.device)

    def _execute_statement(self, stmt, params=None) -> Optional[QueryResult]:
        from .sql import ast as A
        if isinstance(stmt, A.SelectStmt):
            return self._execute_select(stmt, params)
        if isinstance(stmt, A.ExplainStmt):
            return self._execute_explain(stmt)
        if isinstance(stmt, A.DescribeStmt):
            return self._execute_describe(stmt)
        if isinstance(stmt, A.SetVariableStmt):
            from .sql.binder import Scope
            c = self._binder().bind_expr(stmt.value, Scope())
            self._variables[stmt.name.lower()] = (_const_python_value(c),
                                                  c.dtype)
            return None
        if isinstance(stmt, A.SetStmt):
            self.config.set(stmt.name, stmt.value)
            if stmt.name.lower() == "redo_transport":
                v = str(stmt.value or "")
                if v in ("", "none", "off"):
                    self.detach_redo_transport()
                else:
                    self.attach_redo_transport(v.removeprefix("file://"))
            if stmt.name.lower() == "memory_limit":
                from .storage import tempmem
                from .storage.buffer import MANAGER, parse_memory_limit
                # a percentage resolves against the host's memory, as in
                # the reference (storage/buffer.py:parse_memory_limit)
                limit = parse_memory_limit(stmt.value)
                MANAGER.set_limit(limit)
                # blocking-operator working sets arbitrate against the
                # same budget (reference: TemporaryMemoryManager)
                tempmem.MEMORY.set_budget(limit)
            return None
        if isinstance(stmt, A.PragmaStmt):
            return self._execute_pragma(stmt)
        if isinstance(stmt, A.CreateMacro):
            key = stmt.name.lower()
            if key in self.catalog.macros and not stmt.or_replace:
                if stmt.if_not_exists:
                    return None
                raise CatalogException(f"macro {stmt.name} already exists")
            self.catalog.macros[key] = {
                "params": [p.lower() for p in stmt.params],
                "defaults": {k.lower(): v
                             for k, v in stmt.defaults.items()},
                "body": stmt.body, "is_table": stmt.is_table}
            self.catalog.bump()
            self._wal_log({"op": "create_macro", "name": key,
                           "macro": self.catalog.macros[key]})
            return None
        if isinstance(stmt, A.CreateView):
            self.catalog.add_view(stmt.name, stmt.sql_text,
                                  or_replace=stmt.or_replace,
                                  column_aliases=stmt.column_aliases)
            self._wal_log({"op": "create_view", "name": stmt.name,
                           "sql": stmt.sql_text,
                           "aliases": stmt.column_aliases})
            return None
        if isinstance(stmt, A.CreateSecret):
            try:
                self.secret_manager.create(
                    stmt.name, stmt.pairs, stmt.persistent,
                    stmt.or_replace, stmt.if_not_exists)
            except ValueError as e:
                raise CatalogException(str(e))
            return None
        if isinstance(stmt, A.CheckpointStmt):
            self.checkpoint()
            return None
        if isinstance(stmt, A.AttachStmt):
            return self._execute_attach(stmt)
        if isinstance(stmt, A.DetachStmt):
            return self._execute_detach(stmt)
        if isinstance(stmt, A.DropStmt):
            return self._execute_drop(stmt)
        if isinstance(stmt, A.CreateSchema):
            key = stmt.name.lower()
            if key in self.catalog.schemas and not stmt.if_not_exists:
                raise CatalogException(f"schema {stmt.name} already "
                                       "exists")
            self.catalog.schemas.add(key)
            self.catalog.bump()
            self._wal_log({"op": "create_schema", "name": key})
            return None
        if isinstance(stmt, A.CreateSequence):
            key = stmt.name.lower()
            if key in self.catalog.sequences:
                if stmt.if_not_exists:
                    return None
                raise CatalogException(
                    f"sequence {stmt.name} already exists")
            self.catalog.sequences[key] = {
                "value": stmt.start - stmt.increment, "start": stmt.start,
                "increment": stmt.increment}
            self.catalog.bump()
            self._wal_log({"op": "create_sequence", "name": key,
                           "start": stmt.start,
                           "increment": stmt.increment})
            return None
        if isinstance(stmt, A.CreateIndex):
            return self._execute_create_index(stmt)
        if isinstance(stmt, A.CreateType):
            key = stmt.name.lower()
            if key in self.catalog.enums and not stmt.or_replace:
                raise CatalogException(f"type {stmt.name} already exists")
            self.catalog.enums[key] = [str(v) for v in stmt.values]
            self.catalog.bump()
            self._wal_log({"op": "create_type", "name": key,
                           "values": self.catalog.enums[key]})
            return None
        if isinstance(stmt, A.CreateTableAs):
            return self._execute_create_table_as(stmt)
        if isinstance(stmt, A.CreateTable):
            return self._execute_create_table(stmt)
        if isinstance(stmt, A.InsertStmt):
            return self._execute_insert(stmt, params)
        if isinstance(stmt, A.DeleteStmt):
            return self._execute_delete(stmt)
        if isinstance(stmt, A.UpdateStmt):
            return self._execute_update(stmt)
        if isinstance(stmt, A.TransactionStmt):
            return self._execute_transaction(stmt)
        if isinstance(stmt, A.PrepareStmt):
            # validate eagerly like the reference (parse errors at PREPARE)
            from .sql import parser as sqlparser
            sqlparser.parse(stmt.sql_text)
            self._prepared[stmt.name.lower()] = stmt.sql_text
            return None
        if isinstance(stmt, A.ExecuteStmt):
            text = self._prepared.get(stmt.name.lower())
            if text is None:
                raise CatalogException(
                    f"prepared statement {stmt.name} does not exist")
            args = [self._literal_value(a) for a in stmt.args]
            return self.execute(text, args if args else None)
        if isinstance(stmt, A.DeallocateStmt):
            if stmt.name is None:
                self._prepared.clear()
            else:
                self._prepared.pop(stmt.name.lower(), None)
            return None
        if isinstance(stmt, A.AlterStmt):
            return self._execute_alter(stmt)
        if isinstance(stmt, A.PivotStmt):
            return self._execute_statement(self._rewrite_pivot(stmt))
        if isinstance(stmt, A.UnpivotStmt):
            return self._execute_statement(self._rewrite_unpivot(stmt))
        if isinstance(stmt, A.CopyStmt):
            return self._execute_copy(stmt)
        if isinstance(stmt, A.ExportStmt):
            return self._execute_export(stmt)
        if isinstance(stmt, A.ImportStmt):
            return self._execute_import(stmt)
        raise NotImplementedError(f"statement {type(stmt).__name__}")

    def _execute_select(self, stmt, params):
        # plan cache: reuse plans while the catalog version is unchanged
        unopt, plan = self._plan(
            stmt, params,
            key=getattr(stmt, "_sql_text", None) if params is None else None)
        ctx = self._exec_context()
        t0 = time.perf_counter()
        if self.mesh is not None:
            # with a mesh the out-of-core paths are not tried
            try:
                from .parallel.executor import execute_distributed
                res = QueryResult(*execute_distributed(plan, self.mesh))
            except NotImplementedError as e:
                self.log.debug("dist", f"fallback to single device: {e}")
                res = QueryResult(*(physical.execute(plan, ctx=ctx) if ctx
                                    else self._run(plan)))
        elif ctx is None:
            res = QueryResult(*(_run_external(plan, self.config,
                                              self.device)
                                or self._run(plan)))
        else:   # profiling stays on the in-memory path, as in the reference
            res = QueryResult(*physical.execute(plan, ctx=ctx))
        self.log.debug("query", f"executed in "
                       f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        if ctx is not None and ctx.profiler is not None:
            res.profile = ctx.profiler.render(plan)
        if self.config.get("enable_verification"):
            self._verify_statement(stmt, unopt, res)
        return res

    def _exec_context(self):
        """The execution context of a profiled SELECT, or of one that
        reports its progress; None for the others."""
        if self.config.get("enable_profiling"):
            from .profiler import QueryProfiler
            return physical.ExecContext(self.device, profiler=QueryProfiler())
        if self.config.get("enable_progress_bar"):
            return physical.ExecContext(self.device, progress=_progress_bar)
        return None

    # ---- statement verification -----------------------------------------
    def _verify_statement(self, stmt, unopt_plan, res: QueryResult):
        """Run the statement again as its unoptimized plan and as a fresh
        parse and bind, distributed over a mesh (under
        verify_parallelism), and through the out-of-core paths with every
        table streamed in tiles of 2,048 rows, and compare the rows
        (reference: the statement verifiers,
        src/verification/statement_verifier.hpp)."""
        a = sorted(map(repr, res.fetchall()))

        def diff(name, rows):
            b = sorted(map(repr, rows))
            if a != b:
                self.log.warn("verify", f"{name} variant mismatch")
                raise RuntimeError(
                    f"statement verification failed: original and "
                    f"{name} variants disagree ({len(a)} vs {len(b)} "
                    f"rows)")
            self.log.debug("verify", f"{name} cross-check ok")

        diff("unoptimized", QueryResult(*self._run(unopt_plan)).fetchall())
        sql = getattr(stmt, "_sql_text", None)
        if sql is not None:
            from .sql import parser as sqlparser
            stmts2 = sqlparser.parse(sql)
            if len(stmts2) == 1:
                _, p2 = self._plan(stmts2[0])
                diff("re-parsed", QueryResult(*self._run(p2)).fetchall())

        # PARALLELISM: run distributed and diff (reference: PRAGMA
        # verify_parallelism forces multi-threaded pipelines; the
        # reference re-executes over every visible device)
        if self.config.get("verify_parallelism"):
            from .parallel.executor import execute_distributed
            try:
                sd, bd = execute_distributed(self._optimize(unopt_plan),
                                             _verify_mesh(self.device))
                diff("distributed", QueryResult(sd, bd).fetchall())
            except NotImplementedError:
                pass

        # EXTERNAL: force the out-of-core tiled paths (reference: pragma
        # verify_external, forced spill execution)
        class _Cfg:
            def __init__(self, base):
                self._base = base

            def get(self, k):
                if k == "external_threshold_rows":
                    return 1
                if k == "tile_rows":
                    return 2048
                return self._base.get(k)

        ext = _run_external(self._optimize(unopt_plan), _Cfg(self.config),
                            self.device)
        if ext is not None:
            diff("external", QueryResult(*ext).fetchall())

    # ---- EXPLAIN / DESCRIBE / PRAGMA --------------------------------------
    def _execute_explain(self, stmt):
        from .plan.logical import explain as render_plan
        from .profiler import QueryProfiler
        _, plan = self._plan(stmt.stmt)
        if not stmt.analyze:
            text = render_plan(plan)
        else:
            prof = QueryProfiler()
            physical.execute(plan, ctx=physical.ExecContext(
                self.device, profiler=prof))
            text = prof.render(plan)
        return self._text_result("explain", text.rstrip("\n").split("\n"))

    def _execute_describe(self, stmt):
        """DESCRIBE: column name/type/null/key rows; SUMMARIZE: per-column
        statistics (reference: DESCRIBE rewrite + shell SUMMARIZE)."""
        from .table_functions import _strcol
        if stmt.select is not None and not stmt.summarize:
            with span("ddb.frontend.plan"), span("ddb.frontend.bind"):
                plan = self._binder().bind_select(stmt.select)
            fields = list(plan.schema.fields)
            nn, keys = set(), set()
        else:
            if stmt.select is not None:
                _, plan = self._plan(stmt.select)
                td = _result_to_table("__summarize", *self._run(plan))
            else:
                td = self.catalog.get_table(stmt.table)
            fields = td.columns
            nn = set(getattr(td, "not_null", ()))
            keys = set()
            for k, cols in getattr(td, "constraints", ()):
                if k == "primary_key":
                    keys.update(cols)

        if not stmt.summarize:
            names = [f.name for f in fields]
            out = storage.TableData("describe", [
                _strcol("column_name", names),
                _strcol("column_type", [repr(f.dtype) for f in fields]),
                _strcol("null", ["NO" if f.name in nn else "YES"
                                 for f in fields]),
                _strcol("key", ["PRI" if f.name in keys else ""
                                for f in fields]),
                _strcol("default", [""] * len(names)),
                _strcol("extra", [""] * len(names))])
            return self._table_result(out)

        n = td.num_rows
        name_l, type_l, mn, mx, uniq, avg, std, q25, q50, q75, cnt, nulp \
            = ([] for _ in range(12))

        def s(v):
            return "" if v is None else str(v)

        for c in td.columns:
            name_l.append(c.name)
            type_l.append(repr(c.dtype))
            live = c.data if c.nulls is None else c.data[~c.nulls]
            k = len(live)
            cnt.append(str(n))
            nulp.append(f"{(100.0 * (n - k) / n) if n else 0.0:.2f}%")
            if k == 0:
                for lst in (mn, mx, uniq, avg, std, q25, q50, q75):
                    lst.append("")
                continue
            uniq.append(str(int(len(np.unique(live)))))
            if c.dtype.id == TypeId.VARCHAR and c.strdict is not None:
                mn.append(s(c.strdict.decode_one(int(live.min()))))
                mx.append(s(c.strdict.decode_one(int(live.max()))))
                for lst in (avg, std, q25, q50, q75):
                    lst.append("")
                continue
            mn.append(s(T.decode_value(live.min(), c.dtype, c.strdict)
                        if c.dtype.id != TypeId.DOUBLE else live.min()))
            mx.append(s(T.decode_value(live.max(), c.dtype, c.strdict)
                        if c.dtype.id != TypeId.DOUBLE else live.max()))
            if c.dtype.is_numeric:
                f = live.astype(np.float64)
                if c.dtype.id == TypeId.DECIMAL:
                    f = f / T.decimal_scale_factor(c.dtype.scale)
                avg.append(f"{f.mean():.6g}")
                std.append(f"{f.std(ddof=1) if k > 1 else 0.0:.6g}")
                q25.append(f"{np.quantile(f, 0.25):.6g}")
                q50.append(f"{np.quantile(f, 0.50):.6g}")
                q75.append(f"{np.quantile(f, 0.75):.6g}")
            else:
                for lst in (avg, std, q25, q50, q75):
                    lst.append("")
        out = storage.TableData("summarize", [
            _strcol("column_name", name_l),
            _strcol("column_type", type_l),
            _strcol("min", mn), _strcol("max", mx),
            _strcol("approx_unique", uniq),
            _strcol("avg", avg), _strcol("std", std),
            _strcol("q25", q25), _strcol("q50", q50),
            _strcol("q75", q75),
            _strcol("count", cnt),
            _strcol("null_percentage", nulp)])
        return self._table_result(out)

    def _table_result(self, td) -> QueryResult:
        return QueryResult(*self._run(L.Get(td,
                                            list(range(len(td.columns))))))

    def _text_result(self, name: str, lines) -> QueryResult:
        from .table_functions import _strcol
        return self._table_result(storage.TableData(
            name, [_strcol(name, lines)]))

    def _count_result(self, n: int) -> QueryResult:
        """DML row-count result: one BIGINT row, "Count", on this
        connection's device."""
        return self._table_result(storage.TableData("count", [
            storage.TableColumn("Count", T.BIGINT,
                                np.array([int(n)], dtype=np.int64))]))

    def _execute_pragma(self, stmt):
        name = stmt.name.lower()
        if name == "table_info":
            return self.execute(
                f"SELECT * FROM pragma_table_info('{stmt.args[0]}')")
        if name in ("enable_profiling", "enable_profile"):
            self.config.set("enable_profiling", True)
            return None
        if name == "disable_profiling":
            self.config.set("enable_profiling", False)
            return None
        if name in ("enable_verification", "verify_external",
                    "verify_parallelism"):
            # statement-verifier mode: every SELECT runs again as its
            # unoptimized plan, as a fresh parse, distributed (under
            # verify_parallelism) and out of core
            self.config.set("enable_verification", True)
            if name != "enable_verification":
                self.config.set(name, True)
            return None
        if name in ("disable_verification", "disable_verify_external",
                    "disable_verify_parallelism"):
            base = name[len("disable_"):]
            if base == "verification":
                self.config.set("enable_verification", False)
                self.config.set("verify_external", False)
                self.config.set("verify_parallelism", False)
            else:
                self.config.set(base, False)
            return None
        if name == "show_tables":
            return self.execute(
                "SELECT table_name FROM duckdb_tables() ORDER BY 1")
        if name == "database_size":
            total = sum(
                sum(c.data.nbytes for c in t.columns)
                for t in self.catalog.tables.values())
            return self._text_result("database_size", [f"{total} bytes"])
        if name == "collations" and not stmt.args:
            from .sql.binder import _LOCALE_COLLATIONS
            names_ = sorted({"nocase", "noaccent", "nfc"}
                            | set(_LOCALE_COLLATIONS))
            return self._text_result("collation_name", names_)
        # settings set via PRAGMA name=value
        if stmt.args:
            self.config.set(name, stmt.args[0])
            return None
        # argless engine-tuning pragmas of the reference are inert
        # (reference: every boolean setting doubles as PRAGMA
        # [disable_]name — src/main/settings/)
        base = name
        for pre in ("enable_", "disable_"):
            if name.startswith(pre):
                base = name[len(pre):]
        from .config import INERT_SETTINGS
        if name in INERT_SETTINGS or base in INERT_SETTINGS \
                or ("enable_" + base) in INERT_SETTINGS \
                or name in self.config.values \
                or base in ("checkpoint_on_shutdown", "object_cache",
                            "verification", "optimizer",
                            "print_progress_bar"):
            return None
        raise NotImplementedError(f"PRAGMA {name}")

    # ---- DDL -------------------------------------------------------------
    def _execute_attach(self, stmt):
        """ATTACH a database file (or ':memory:') under a name: its
        tables and views load into this catalog as `name.table`
        (reference: attached_database.cpp)."""
        from .storage.persist import load_database
        name = (stmt.name or os.path.splitext(
            os.path.basename(stmt.path))[0]).lower()
        if stmt.path not in (":memory:", ""):
            load_database(self.catalog, stmt.path, prefix=name + ".")
        self._attached[name] = stmt.path
        return None

    def _execute_detach(self, stmt):
        name = stmt.name.lower()
        if name not in self._attached:
            raise CatalogException(f"database {stmt.name} is not attached")
        del self._attached[name]
        pre = name + "."
        for k in [k for k in self.catalog.tables if k.startswith(pre)]:
            del self.catalog.tables[k]
        for k in [k for k in self.catalog.views if k.startswith(pre)]:
            del self.catalog.views[k]
        self.catalog.bump()
        return None

    def _execute_drop(self, stmt):
        if stmt.kind == "secret":
            try:
                self.secret_manager.drop(stmt.name, if_exists=stmt.if_exists)
            except ValueError as e:
                raise CatalogException(str(e))
            return None
        key = stmt.name.lower()
        cat = self.catalog
        if stmt.kind == "view":
            cat.drop_view(stmt.name, if_exists=stmt.if_exists)
        elif stmt.kind == "type":
            if key not in cat.enums and not stmt.if_exists:
                raise CatalogException(f"type {stmt.name} does not exist")
            # a table column still carries this enum domain: RESTRICT
            # errors, CASCADE drops the dependent tables (reference:
            # dependency_manager.cpp)
            deps = [td for td in cat.tables.values()
                    if any(tn.lower() == key for (tn, _v) in
                           getattr(td, "enum_domains", {}).values())]
            if deps and not stmt.cascade:
                raise CatalogException(
                    f"Dependency Error: Cannot drop entry "
                    f"\"{stmt.name}\" because there are entries that "
                    f"depend on it: table \"{deps[0].name}\". "
                    f"Use DROP...CASCADE to drop all dependents.")
            for td in deps:
                cat.drop_table(td.name, if_exists=True)
            cat.enums.pop(key, None)
            cat.bump()
        elif stmt.kind == "schema":
            if key not in cat.schemas:
                if not stmt.if_exists:
                    raise CatalogException(
                        f"schema {stmt.name} does not exist")
            else:
                deps = [t for t in cat.tables if t.startswith(key + ".")]
                if deps and not stmt.cascade:
                    raise CatalogException(
                        f"Dependency Error: schema {stmt.name} has "
                        f"dependent tables; use DROP...CASCADE")
                for t in deps:
                    cat.drop_table(t, if_exists=True)
                cat.schemas.discard(key)
                cat.bump()
        elif stmt.kind == "sequence":
            if key not in cat.sequences and not stmt.if_exists:
                raise CatalogException(
                    f"sequence {stmt.name} does not exist")
            deps = cat.dependents_of("sequence", key)
            if deps and not stmt.cascade:
                raise CatalogException(
                    f"Dependency Error: Cannot drop entry "
                    f"\"{stmt.name}\" because there are entries that "
                    f"depend on it: {deps[0][0]} \"{deps[0][1]}\". "
                    f"Use DROP...CASCADE to drop all dependents.")
            for kind, name in deps:
                if kind == "table":
                    cat.drop_table(name, if_exists=True)
            cat.sequences.pop(key, None)
            cat.bump()
        elif stmt.kind == "macro":
            if key not in cat.macros and not stmt.if_exists:
                raise CatalogException(f"macro {stmt.name} does not exist")
            cat.macros.pop(key, None)
            cat.bump()
        elif stmt.kind == "index":
            owner = next((t for t in cat.tables.values()
                          if key in t.indexes), None)
            if owner is None:
                if not stmt.if_exists:
                    raise CatalogException(
                        f"index {stmt.name} does not exist")
            else:
                ix = owner.indexes.pop(key)
                if ix.unique:
                    owner.constraints = [
                        (k, cs) for (k, cs)
                        in getattr(owner, "constraints", ())
                        if not (k == "unique" and cs == list(ix.columns))]
                cat.bump()
        else:
            # indexes owned by the table drop with it; only FK children
            # restrict (reference: dependency_manager.cpp)
            deps = [d for d in cat.dependents_of("table", key)
                    if d[0] == "table" and d != ("table", key)]
            if deps and cat.has_table(key) and not stmt.cascade:
                raise CatalogException(
                    f"Dependency Error: Cannot drop entry "
                    f"\"{stmt.name}\" because there are entries "
                    f"that depend on it: {deps[0][0]} "
                    f"\"{deps[0][1]}\". "
                    f"Use DROP...CASCADE to drop all dependents.")
            for kind, name in deps:
                if kind == "table":
                    cat.drop_table(name, if_exists=True)
            cat.drop_table(stmt.name, if_exists=stmt.if_exists)
        self._wal_log({"op": "drop", "kind": stmt.kind, "name": stmt.name})
        return None

    def _execute_create_index(self, stmt):
        from .storage.index import SortedIndex
        td = self.catalog.get_table(stmt.table)
        key = stmt.name.lower()
        for t in self.catalog.tables.values():
            if key in t.indexes:
                if stmt.if_not_exists:
                    return None
                raise CatalogException(f"index {stmt.name} already exists")
        byname = {c.name.lower() for c in td.columns}
        for cn in stmt.columns:
            if cn.lower() not in byname:
                raise CatalogException(
                    f"column {cn} does not exist in {stmt.table}")
        ix = SortedIndex(key, [c.lower() for c in stmt.columns],
                         unique=stmt.unique)
        ix.refresh(td)
        if stmt.unique and ix.has_internal_duplicates():
            raise dml.ConstraintException(
                f"Constraint Error: duplicate key violates UNIQUE "
                f"index {stmt.name}")
        td.indexes[key] = ix
        if stmt.unique:
            td.constraints = list(getattr(td, "constraints", ())) \
                + [("unique", [c.lower() for c in stmt.columns])]
        self.catalog.bump()
        self._wal_log({"op": "create_index", "name": key,
                       "table": td.name,
                       "columns": [c.lower() for c in stmt.columns],
                       "unique": stmt.unique})
        return None

    def _execute_create_table_as(self, stmt):
        _, plan = self._plan(stmt.select)
        td = _result_to_table(stmt.name, *self._run(plan))
        self.catalog.add_table(td, or_replace=stmt.or_replace)
        if self._wal_active:
            from .storage.wal import encode_rows
            rows = dml.rows_as_python(td, np.ones(td.num_rows, dtype=bool))
            self._wal_log({
                "op": "create_table", "name": td.name,
                "columns": [{"name": c.name, "type": c.dtype.id.name,
                             "width": c.dtype.width,
                             "scale": c.dtype.scale}
                            for c in td.columns],
                "rows": encode_rows(rows)})
        return None

    def _execute_create_table(self, stmt):
        from .sql.binder import BindError, resolve_typename
        if stmt.if_not_exists and self.catalog.has_table(stmt.name):
            return None
        fields = []
        enum_domains = {}
        bit_columns = set()
        collate_columns = {}
        for c in stmt.columns:
            cname = c.name.lower()
            tn = c.typename.lower()
            if getattr(c, "collation", None):
                # column-level collation: comparisons/sorts on this
                # column fold through it
                from .sql.binder import validate_collation
                validate_collation(c.collation)
                collate_columns[cname] = c.collation.lower()
            if tn in ("bit", "bitstring"):
                # BIT column: VARCHAR storage holding canonical '0'/'1'
                # text, validated at constraint-check time
                fields.append((cname, T.VARCHAR))
                bit_columns.add(cname)
                continue
            if tn in self.catalog.enums:
                # ENUM column: VARCHAR storage restricted to the enum's
                # value domain
                fields.append((cname, T.VARCHAR))
                enum_domains[cname] = (tn, frozenset(
                    self.catalog.enums[tn]))
                continue
            fields.append((cname,
                           resolve_typename(c.typename, c.width, c.scale)))
        td = dml.empty_table(stmt.name.lower(), fields)
        if enum_domains:
            td.enum_domains = enum_domains
        if bit_columns:
            td.bit_columns = bit_columns
        if collate_columns:
            td.collate_columns = collate_columns
        defaults = {c.name.lower(): c.default for c in stmt.columns
                    if c.default is not None}
        if defaults:
            # validate eagerly: parse + referenced sequences must exist
            from .catalog import _sequence_refs
            from .sql import parser as sqlparser
            for cname, dtext in defaults.items():
                sqlparser.parse_expression(dtext)
                for seq in _sequence_refs(dtext):
                    if seq not in self.catalog.sequences:
                        raise CatalogException(
                            f"sequence {seq} does not exist "
                            f"(DEFAULT of column {cname})")
            td.defaults = defaults
        td.constraints = [(k, [c.lower() for c in cols])
                          for k, cols in getattr(stmt, "constraints", [])]
        fks = []
        for cols, parent, pcols in getattr(stmt, "foreign_keys", []):
            # the parent must exist and the referenced columns must be
            # PRIMARY KEY or UNIQUE (reference: bind_create_table.cpp)
            ptd = self.catalog.get_table(parent)
            cols = [c.lower() for c in cols]
            if pcols is None:
                pk = next((pc for k, pc in getattr(ptd, "constraints", ())
                           if k == "primary_key"), None)
                if pk is None:
                    raise BindError(
                        f"table {parent} has no PRIMARY KEY to "
                        "reference")
                pcols = list(pk)
            else:
                pcols = [c.lower() for c in pcols]
                keyed = {tuple(sorted(pc)) for _k, pc in
                         getattr(ptd, "constraints", ())}
                if tuple(sorted(pcols)) not in keyed:
                    raise BindError(
                        f"referenced columns ({', '.join(pcols)}) of "
                        f"{parent} must have a PRIMARY KEY or UNIQUE "
                        "constraint")
            if len(cols) != len(pcols):
                raise BindError(
                    "foreign key column count must match the "
                    "referenced key")
            fks.append((cols, ptd.name, pcols))
        if fks:
            td.foreign_keys = fks
        td.not_null = {c.name.lower() for c in stmt.columns if c.not_null}
        for k, cols in td.constraints:
            if k == "primary_key":     # PK implies NOT NULL
                td.not_null.update(cols)
        self.catalog.add_table(td, or_replace=stmt.or_replace)
        self._wal_log({"op": "create_table", "name": td.name,
                       "columns": [{"name": c.name,
                                    "type": c.dtype.id.name,
                                    "width": c.dtype.width,
                                    "scale": c.dtype.scale}
                                   for c in td.columns],
                       "constraints": [[k, list(c)]
                                       for k, c in td.constraints],
                       "foreign_keys": [[list(c), p, list(pc)]
                                        for c, p, pc in
                                        getattr(td, "foreign_keys", [])],
                       "not_null": sorted(td.not_null),
                       "defaults": defaults,
                       "enum_domains": {k: [v[0], sorted(v[1])]
                                        for k, v in enum_domains.items()},
                       "bit_columns": sorted(bit_columns)})
        return None

    def _execute_alter(self, stmt):
        """ALTER TABLE rename/add/drop column, rename table, column type,
        default and NOT NULL, primary key (reference: src/execution/
        operator/schema/physical_alter.cpp).  The device is bound here
        too: a WAL or a redo stream replays ALTER records outside
        `execute`, and SET DATA TYPE ... USING evaluates on the device."""
        with bind_device(self.device):
            return self._alter(stmt)

    def _alter(self, stmt):
        from .sql.binder import resolve_typename
        if stmt.if_exists and not self.catalog.has_table(stmt.table):
            return None
        td = self.catalog.get_table(stmt.table)
        if stmt.action == "rename_table":
            key = stmt.table.lower()
            new = stmt.new_name.lower()
            if self.catalog.has_table(new):
                raise CatalogException(f"table {new} already exists")
            del self.catalog.tables[self.catalog._resolve(key)]
            td.name = new
            self.catalog.tables[new] = td
        elif stmt.action == "rename_column":
            col = self._find_column(td, stmt.name)
            col.name = stmt.new_name.lower()
        elif stmt.action == "add_column":
            dt = resolve_typename(*stmt.coltype)
            n = td.num_rows
            td.columns.append(storage.TableColumn(
                stmt.name.lower(), dt, np.zeros(n, dtype=dt.np_dtype),
                np.ones(n, dtype=bool) if n else None))
            td.invalidate_cache()
        elif stmt.action == "drop_column":
            col = self._find_column(td, stmt.name)
            if len(td.columns) == 1:
                raise CatalogException("cannot drop the last column")
            td.columns.remove(col)
            td.invalidate_cache()
        elif stmt.action == "set_type":
            self._alter_set_type(td, stmt, resolve_typename)
        elif stmt.action == "set_default":
            self._find_column(td, stmt.name)
            low = stmt.name.lower()
            for ix in td.indexes.values():
                if not ix.name.startswith("__") \
                        and low in [c.lower() for c in ix.columns]:
                    raise CatalogException(
                        "Catalog Error: Cannot change the default "
                        "value of this column: an index depends on "
                        "it!")
            if not getattr(td, "defaults", None):
                td.defaults = {}
            td.defaults[low] = stmt.new_name
        elif stmt.action == "drop_default":
            self._find_column(td, stmt.name)
            if getattr(td, "defaults", None):
                td.defaults.pop(stmt.name.lower(), None)
        elif stmt.action == "set_not_null":
            col = self._find_column(td, stmt.name)
            if col.nulls is not None and col.nulls.any():
                raise dml.ConstraintException(
                    f"Constraint Error: NOT NULL constraint failed: "
                    f"{td.name}.{stmt.name} (existing NULLs)")
            if not isinstance(getattr(td, "not_null", None), set):
                td.not_null = set(getattr(td, "not_null", ()))
            td.not_null.add(stmt.name.lower())
        elif stmt.action == "drop_not_null":
            if isinstance(getattr(td, "not_null", None), set):
                td.not_null.discard(stmt.name.lower())
        elif stmt.action == "add_pk":
            # validate existing rows, then install the constraint
            cols = [c.strip().lower() for c in stmt.name.split(",")]
            for c in cols:
                self._find_column(td, c)
            if any(k == "primary_key"
                   for k, _ in getattr(td, "constraints", ())):
                raise CatalogException(
                    "table already has a PRIMARY KEY")
            td.constraints = list(getattr(td, "constraints", ())) \
                + [("primary_key", cols)]
            if not isinstance(getattr(td, "not_null", None), set):
                td.not_null = set(getattr(td, "not_null", ()))
            td.not_null.update(cols)
            try:
                dml.check_constraints(td)
            except dml.ConstraintException:
                td.constraints = [
                    (k, cs) for k, cs in td.constraints
                    if not (k == "primary_key" and cs == cols)]
                td.not_null.difference_update(cols)
                raise
        self.catalog.bump()
        self._wal_log({"op": "alter", "table": stmt.table,
                       "action": stmt.action, "name": stmt.name,
                       "new_name": stmt.new_name,
                       "coltype": list(stmt.coltype)
                       if stmt.coltype else None})
        return None

    def _alter_set_type(self, td, stmt, resolve_typename):
        """ALTER COLUMN SET DATA TYPE: re-encode through the host values;
        a USING expression is evaluated over the table on this
        connection's device."""
        from .sql.binder import ConversionError
        from .storage.strings import StringDictionary
        col = self._find_column(td, stmt.name)
        low = stmt.name.lower()
        for ix in td.indexes.values():
            if not ix.name.startswith("__") \
                    and low in [c.lower() for c in ix.columns]:
                raise CatalogException(
                    "Catalog Error: Cannot change the type of "
                    "this column: an index depends on it!")
        dt = resolve_typename(*stmt.coltype)
        n = td.num_rows
        using = getattr(stmt, "new_name", None)
        if using:
            from .expr.compile import evaluate
            from .sql import parser as sqlparser
            from .sql.binder import Scope
            b2 = self._binder()
            sc2 = Scope()
            sc2.add(td.name, td.schema)
            # zone-map bounds let USING casts to VARCHAR stringify
            b2._plan_for_bounds = L.Get(td, list(range(len(td.columns))))
            bound = b2.bind_expr(sqlparser.parse_expression(using), sc2)
            d2, n2 = evaluate(bound, td.device_batch(device=self.device))
            d2 = to_numpy(d2)[:n]
            n2 = None if n2 is None else to_numpy(n2)[:n]
            sdv = getattr(bound, "strdict", None)
            vals = [None if n2 is not None and n2[i]
                    else (sdv.decode_one(int(d2[i])) if sdv is not None
                          else T.decode_value(d2[i], bound.dtype))
                    for i in range(n)]
        else:
            try:
                vals = [None if (col.nulls is not None and col.nulls[i])
                        else (col.strdict.decode_one(int(col.data[i]))
                              if col.strdict is not None
                              else T.decode_value(col.data[i], col.dtype))
                        for i in range(n)]
            except (ValueError, TypeError, OverflowError) as ex:
                raise ConversionError(str(ex))
        newcol = storage.TableColumn(col.name, dt,
                                     np.zeros(0, dtype=dt.np_dtype))
        if dt.id == TypeId.VARCHAR:
            newcol.strdict = StringDictionary(
                np.array([], dtype=object).astype(str))
        try:
            phys, nulls, extra = dml._encode_values(newcol, vals)
        except (ValueError, TypeError, OverflowError) as ex:
            raise ConversionError(
                f"Conversion Error: could not convert column "
                f"{col.name} to {dt!r}: {ex}")
        newcol.data = phys
        newcol.nulls = nulls if nulls.any() else None
        if extra is not None:
            newcol.strdict = extra[0]
        newcol.compute_stats()
        td.columns[td.columns.index(col)] = newcol
        td.invalidate_cache()

    @staticmethod
    def _find_column(td, name):
        low = name.lower()
        for c in td.columns:
            if c.name.lower() == low:
                return c
        raise CatalogException(f"column {name} does not exist")

    # ---- files: EXPORT, IMPORT, COPY (reference: ddb_tpu/api.py) ---------
    def _execute_export(self, stmt):
        """EXPORT DATABASE 'dir' (FORMAT csv|parquet, DELIMITER d,
        HEADER) — schema.sql + load.sql + one data file per table
        (reference: physical_export.cpp layout, which IMPORT DATABASE
        replays verbatim)."""
        import os as _os
        path = stmt.path
        fmt = str(stmt.options.get("format", "csv")).lower()
        delim = stmt.options.get("delimiter", ",")
        _os.makedirs(path, exist_ok=True)
        ddl, loads = [], []
        for tname, _sql in [(k, None) for k in
                            sorted(self.catalog.enums)]:
            vals = ", ".join("'" + str(v).replace("'", "''") + "'"
                             for v in self.catalog.enums[tname])
            ddl.append(f"CREATE TYPE {tname} AS ENUM ({vals});")
        for sname, seq in sorted(self.catalog.sequences.items()):
            ddl.append(f"CREATE SEQUENCE {sname} START "
                       f"{seq['start']} INCREMENT {seq['increment']};")
        # FK parents must be created before children (reference:
        # physical_export.cpp orders entries by dependency)
        ordered, seen = [], set()

        def visit(tn):
            if tn in seen or tn not in self.catalog.tables:
                return
            seen.add(tn)
            for _c, parent, _pc in getattr(
                    self.catalog.tables[tn], "foreign_keys", ()):
                visit(parent.lower())
            ordered.append(tn)

        for tn in sorted(self.catalog.tables):
            visit(tn)
        for tname in ordered:
            td = self.catalog.tables[tname]
            cols = []
            nn = getattr(td, "not_null", set())
            for c in td.columns:
                enum_dom = getattr(td, "enum_domains", {}).get(c.name)
                tdecl = enum_dom[0] if enum_dom else repr(c.dtype)
                d = f"{c.name} {tdecl}"
                if c.name in nn:
                    d += " NOT NULL"
                dflt = getattr(td, "defaults", {}).get(c.name)
                if dflt:
                    d += f" DEFAULT {dflt}"
                cols.append(d)
            for kind, kcols in getattr(td, "constraints", ()):
                cols.append(f"{kind.replace('_', ' ').upper()} "
                            f"({', '.join(kcols)})")
            for fcols, parent, pcols in getattr(td, "foreign_keys",
                                                ()):
                cols.append(
                    f"FOREIGN KEY ({', '.join(fcols)}) REFERENCES "
                    f"{parent} ({', '.join(pcols)})")
            ddl.append(f"CREATE TABLE {tname} ({', '.join(cols)});")
            fname = f"{tname.replace('.', '_')}.{fmt}"
            fpath = _os.path.join(path, fname)
            if fmt == "parquet":
                self.execute(f"COPY {tname} TO '{fpath}' "
                             f"(FORMAT PARQUET)")
                loads.append(f"COPY {tname} FROM '{fpath}' "
                             f"(FORMAT PARQUET);")
            else:
                # portable csv (honours DELIMITER/HEADER), written on
                # this connection's device as the reference's pyarrow
                # writer writes it; nested columns raise there as here
                from .storage import csvwrite
                res = self.execute(f"SELECT * FROM {tname}")
                hv = stmt.options.get("header", True)
                header = str(hv).lower() not in ("false", "0", "no")
                csvwrite.write_batch(res.schema, res.batch, fpath,
                                     header=header, delimiter=str(delim),
                                     nested_text=False)
                hdr = "true" if header else "false"
                loads.append(
                    f"COPY {tname} FROM '{fpath}' (DELIMITER "
                    f"'{delim}', HEADER {hdr});")
        for vname, (vsql, valias) in sorted(self.catalog.views.items()):
            cols = f" ({', '.join(valias)})" if valias else ""
            ddl.append(f"CREATE VIEW {vname}{cols} AS {vsql};")
        with open(_os.path.join(path, "schema.sql"), "w") as f:
            f.write("\n".join(ddl) + "\n")
        with open(_os.path.join(path, "load.sql"), "w") as f:
            f.write("\n".join(loads) + "\n")
        return None

    def _execute_import(self, stmt):
        import os as _os
        for script in ("schema.sql", "load.sql"):
            p = _os.path.join(stmt.path, script)
            if not _os.path.exists(p):
                raise CatalogException(
                    f"IMPORT DATABASE: {p} does not exist")
            with open(p) as f:
                text = f.read()
            for sql in text.split(";"):
                if sql.strip():
                    self.execute(sql)
        return None

    def _execute_copy(self, stmt):
        """COPY table/(query) TO 'file' | COPY table FROM 'file'
        (reference: operator/persistent/physical_copy_to_file.cpp)."""
        from .sql import ast as A
        if stmt.direction == "to":
            if isinstance(stmt.target, A.SelectStmt):
                res = self._execute_statement(stmt.target)
            else:
                res = self.execute(f"SELECT * FROM {stmt.target}")
            if stmt.format == "parquet":
                import pyarrow.parquet as pq
                at = res.arrow()
                pq.write_table(at, stmt.path)
                return self._count_result(at.num_rows)
            # nested columns write as duckdb text (reference: CSV writer
            # casts nested to VARCHAR, sink_csv.cpp); the bytes are the
            # reference's pyarrow writer's
            from .storage import csvwrite
            opts = getattr(stmt, "options", {}) or {}
            hv = opts.get("header", True)
            n = csvwrite.write_batch(
                res.schema, res.batch, stmt.path,
                header=str(hv).lower() not in ("false", "0", "no"),
                delimiter=str(opts.get("delimiter", ",")))
            # COPY returns the written row count (reference: COPY TO
            # result, physical_copy_to_file.cpp finalize)
            return self._count_result(n)
        # COPY ... FROM: append file contents into the table
        td = self.catalog.get_table(stmt.target)
        if stmt.format == "parquet":
            import pyarrow.parquet as pq
            src = storage.from_arrow("__copy", pq.read_table(stmt.path))
        else:
            # sniff dialect (delimiter/header) but coerce to the target
            # table's declared column types
            from .storage.csv_sniffer import read_csv_auto
            names = [c.name for c in td.columns]
            nested = {c.name: c.dtype for c in td.columns
                      if c.dtype.id in (TypeId.LIST, TypeId.STRUCT,
                                        TypeId.MAP)}
            types = {c.name: ("VARCHAR" if c.name in nested
                              else repr(c.dtype)) for c in td.columns}
            opts = getattr(stmt, "options", None) or {}
            src = read_csv_auto(stmt.path,
                                delim=opts.get("delimiter"),
                                header=opts.get("header"),
                                names=names, types=types)
            src.name = "__copy"
        if stmt.format != "parquet":
            # nested target columns: parse the duckdb text back into
            # host stores (reference: CSV reader casts VARCHAR ->
            # nested on ingest)
            for col in src.columns:
                tgt = nested.get(col.name)
                if tgt is None or col.strdict is None:
                    continue
                from .sql.binder import text_to_nested
                from .storage.lists import ListStore
                from .storage.nested import MapStore, StructStore
                if tgt.id == TypeId.LIST:
                    store = ListStore()
                elif tgt.id == TypeId.STRUCT:
                    store = StructStore(
                        [n for n, _t in (tgt.children or ())])
                else:
                    store = MapStore()
                codes = np.zeros(len(col.data), dtype=np.int32)
                for i, code in enumerate(col.data):
                    if col.nulls is not None and col.nulls[i]:
                        continue
                    text = col.strdict.decode_one(int(code))
                    v = text_to_nested((str(text), False), tgt)
                    if tgt.id == TypeId.STRUCT:
                        v = tuple(v[n] for n, _t in tgt.children)
                    codes[i] = store.add(v)
                col.data = codes
                col.strdict = store
                col.dtype = tgt
        n0 = td.num_rows
        dml.append_table(td, src.columns)
        self._enforce_constraints(td, n0)
        self.catalog.bump()
        return self._count_result(td.num_rows - n0)

    # ---- DML -------------------------------------------------------------
    def _enforce_constraints(self, td, n0: int) -> None:
        """Post-append constraint check; rolls the append back on
        violation (reference: physical_insert.cpp)."""
        if not getattr(td, "constraints", None) \
                and not getattr(td, "not_null", None) \
                and not getattr(td, "enum_domains", None) \
                and not getattr(td, "bit_columns", None) \
                and not getattr(td, "foreign_keys", None):
            return
        try:
            dml.check_constraints(td)
            if getattr(td, "foreign_keys", None):
                dml.check_foreign_keys(td, self.catalog)
        except dml.ConstraintException:
            dml.truncate_rows(td, n0)
            raise

    def _emit_cdc(self, table, op, rows, old_rows=None):
        if not self.cdc.enabled:
            return
        if self._txn_events is not None:
            self._txn_events.append((table, op, rows, old_rows))
        else:
            self.cdc.emit(table, op, rows, old_rows)

    def _log_insert(self, td, rows, columns=None):
        if self._wal_active:
            from .storage.wal import encode_rows
            self._wal_log({"op": "insert", "table": td.name,
                           "columns": columns, "rows": encode_rows(rows)})

    def _execute_insert(self, stmt, params=None):
        from .sql import ast as A
        from .sql.binder import Scope
        td = self.catalog.get_table(stmt.table)
        if stmt.values is None:
            return self._insert_select(td, stmt)
        b = self._binder(params)
        sc = Scope()
        names = [c.name for c in td.columns]
        defaults = getattr(td, "defaults", {})
        default_ast = {}
        if defaults:
            from .sql import parser as sqlparser
            default_ast = {c: sqlparser.parse_expression(t)
                           for c, t in defaults.items()}

        def eval_default(col):
            # re-bound per row: nextval() must advance for each
            # inserted row (reference: DefaultExpression binding)
            a = default_ast.get(col.lower())
            if a is None:
                return None
            return _const_python_value(b.bind_expr(a, sc))

        target = [c.lower() for c in stmt.columns] \
            if stmt.columns is not None else None
        arity = len(stmt.values[0]) if stmt.values else 0
        eff_cols = target if target is not None else names[:arity]
        missing = [c for c in names
                   if c not in eff_cols and c.lower() in defaults]
        rows = []
        for vr in stmt.values:
            row = []
            for i, e in enumerate(vr):
                if isinstance(e, A.EDefault):
                    col = eff_cols[i] if i < len(eff_cols) else ""
                    row.append(eval_default(col))
                else:
                    row.append(_const_python_value(b.bind_expr(e, sc)))
            for col in missing:
                row.append(eval_default(col))
            rows.append(row)
        # arity==0 is INSERT ... DEFAULT VALUES: always pass the
        # (possibly empty) explicit column list so columns without a
        # DEFAULT become NULL rather than indexing an empty row.
        ins_cols = (eff_cols + missing) \
            if (target is not None or missing or arity == 0) else None
        # offset-less TIMETZ strings attach the session zone's offset
        order = [c.lower() for c in (ins_cols or names)]
        dtypes = {c.name.lower(): c.dtype for c in td.columns}
        for j, cn in enumerate(order):
            dt = dtypes.get(cn)
            if dt is not None and dt.id == T.TypeId.TIMETZ:
                for row in rows:
                    if j < len(row) and isinstance(row[j], str):
                        row[j] = b._timetz_raw(row[j])
        n0 = td.num_rows
        dml.insert_rows(td, rows, ins_cols)
        self._enforce_constraints(td, n0)
        self.catalog.bump()
        self._emit_cdc(td.name, "insert", rows)
        self._log_insert(td, rows, ins_cols)
        return self._count_result(len(rows))

    def _insert_select(self, td, stmt):
        """INSERT ... SELECT: the query runs on the device; its rows come
        to the host and are appended."""
        _, plan = self._plan(stmt.select)
        src = _result_to_table("__tmp", *self._run(plan))
        n0 = td.num_rows
        dml.append_table(td, src.columns)
        self._enforce_constraints(td, n0)
        self.catalog.bump()
        if self.cdc.enabled or self._wal_active:
            rows = dml.rows_as_python(src, np.ones(src.num_rows, dtype=bool))
            self._emit_cdc(td.name, "insert", rows)
            self._log_insert(td, rows)
        return self._count_result(src.num_rows)

    def _bind_table_predicate(self, td, where):
        """WHERE over the whole table on this connection's device -> bool
        mask on the host."""
        from .expr.compile import select_mask
        from .sql.binder import Scope
        if where is None:
            return np.ones(td.num_rows, dtype=bool)
        sc = Scope()
        sc.add(td.name, td.schema)
        pred = self._binder().bind_expr(where, sc)
        m = select_mask(pred, td.device_batch(device=self.device))
        return to_numpy(m)[:td.num_rows]

    def _execute_delete(self, stmt):
        td = self.catalog.get_table(stmt.table)
        mask = self._bind_table_predicate(td, stmt.where)
        old = dml.rows_as_python(td, mask) if self.cdc.enabled else None
        ndel = int(mask.sum())
        referenced = any(
            parent == td.name
            for other in self.catalog.tables.values()
            for _c, parent, _pc in getattr(other, "foreign_keys", ()))
        backup = [(c.data, c.nulls) for c in td.columns] \
            if referenced else None
        dml.delete_rows(td, mask)
        if referenced:
            # RESTRICT: deleting still-referenced parent keys fails and
            # rolls back (reference: DataTable::VerifyDeleteForeignKey)
            try:
                dml.check_foreign_keys(td, self.catalog)
            except dml.ConstraintException:
                for c, (d, n) in zip(td.columns, backup):
                    c.data, c.nulls = d, n
                    c.compute_stats()
                td.invalidate_cache()
                raise
        if self._wal_active:
            self._wal_log({"op": "delete", "table": td.name,
                           "idx": [int(i) for i in np.nonzero(mask)[0]]})
        self.catalog.bump()
        if old is not None:
            self._emit_cdc(td.name, "delete", old)
        return self._count_result(ndel)

    def _execute_update(self, stmt):
        """UPDATE: the predicate and the SET expressions are evaluated
        over the whole table on the device; the mask and the new columns
        come to the host, where the masked rows are replaced."""
        from .expr import ir
        from .expr.compile import evaluate
        from .sql.binder import BindError, Scope
        td = self.catalog.get_table(stmt.table)
        mask = self._bind_table_predicate(td, stmt.where)
        old = dml.rows_as_python(td, mask) if self.cdc.enabled else None
        b = self._binder()
        sc = Scope()
        sc.add(td.name, td.schema)
        batch = td.device_batch(device=self.device)
        updates = {}
        for col, e in stmt.assignments:
            bound = b.bind_expr(e, sc)
            try:
                tcol = td.columns[td.schema.index_of(col)]
            except KeyError:
                raise BindError(
                    f"UPDATE: column {col} not in table {td.name}")
            if tcol.dtype.id != TypeId.VARCHAR \
                    and bound.dtype != tcol.dtype:
                bound = ir.Cast(bound, tcol.dtype)
            d, n = evaluate(bound, batch)
            updates[col.lower()] = (
                to_numpy(d)[:td.num_rows],
                to_numpy(n)[:td.num_rows] if n is not None else None,
                getattr(bound, "strdict", None))
        del batch
        fk_relevant = getattr(td, "foreign_keys", None) or any(
            parent == td.name
            for other in self.catalog.tables.values()
            for _c, parent, _pc in getattr(other, "foreign_keys", ()))
        backup = None
        if getattr(td, "constraints", None) \
                or getattr(td, "not_null", None) \
                or getattr(td, "enum_domains", None) \
                or getattr(td, "bit_columns", None) or fk_relevant:
            backup = {c.name: (c.data, c.nulls, c.strdict)
                      for c in td.columns if c.name in updates}
        dml.update_rows(td, mask, updates)
        if backup is not None:
            try:
                dml.check_constraints(td)
                if fk_relevant:
                    dml.check_foreign_keys(td, self.catalog)
            except dml.ConstraintException:
                for c in td.columns:
                    if c.name in backup:
                        c.data, c.nulls, c.strdict = backup[c.name]
                        c.compute_stats()
                td.invalidate_cache()
                raise
        self.catalog.bump()
        if old is not None:
            self._emit_cdc(td.name, "update",
                           dml.rows_as_python(td, mask), old)
        if self._wal_active:
            from .storage.wal import encode_rows
            cols = list(updates.keys())
            positions = {c.name: j for j, c in enumerate(td.columns)}
            full = dml.rows_as_python(td, mask)
            rows = [[r[positions[c]] for c in cols] for r in full]
            self._wal_log({"op": "update", "table": td.name,
                           "idx": [int(i) for i in np.nonzero(mask)[0]],
                           "cols": cols, "rows": encode_rows(rows)})
        return self._count_result(int(mask.sum()))

    # ---- transactions ----------------------------------------------------
    def _execute_transaction(self, stmt):
        """Snapshot-isolated transactions over the shared Database
        (reference: DuckTransactionManager, src/transaction/).

        BEGIN switches this connection onto a private snapshot catalog of
        shallow table clones; writes mutate only the snapshot while their
        logical ops buffer.  COMMIT re-applies the buffered ops to a clone
        of the current shared catalog under the database lock and swaps
        it in; a constraint conflict aborts the whole commit.  ROLLBACK
        discards the snapshot."""
        if stmt.kind == "begin":
            if self._txn_ops is not None:
                raise RuntimeError("transaction already active")
            with self._db.lock:
                snap = _clone_catalog(self._db.catalog)
            snap.bump()
            self.catalog = snap
            self._txn_ops = []
            self._txn_events = []
        elif stmt.kind == "commit":
            if self._txn_ops is None:
                raise RuntimeError("no transaction active")
            ops = self._txn_ops
            events = self._txn_events or []
            self._txn_ops = None
            self._txn_events = None
            try:
                self._commit_ops(ops)
            finally:
                self.catalog = self._db.catalog
            if ops and self._redo is not None:
                for rec in ops:
                    self._redo.append(rec)
                self._redo.flush()
            if ops and self._wal is not None:
                # the whole commit, then one flush and at most one
                # checkpoint (a truncate inside it would apply it twice)
                for rec in ops:
                    self._wal.append(rec)
                self._wal.flush()
                self._maybe_autocheckpoint()
            hlc = self.clock.get_hlc_timestamp()
            for table, op, rows, old_rows in events:
                self.cdc.emit(table, op, rows, old_rows, hlc=hlc)
        elif stmt.kind == "rollback":
            if self._txn_ops is None:
                raise RuntimeError("no transaction active")
            self.catalog = self._db.catalog
            self._txn_ops = None
            self._txn_events = None
        return None

    def _commit_ops(self, ops) -> None:
        """Atomically re-apply a transaction's logical ops to the shared
        catalog (clone -> replay -> swap under the database lock)."""
        from .storage.wal import apply_record, decode_rows
        if not ops:
            return
        with self._db.lock:
            shared = self._db.catalog
            work = _clone_catalog(shared)
            self.catalog = work
            was_replaying = self._replaying
            self._replaying = True
            try:
                for rec in ops:
                    if rec.get("op") == "insert":
                        td = work.get_table(rec["table"])
                        n0 = td.num_rows
                        dml.insert_rows(td, decode_rows(rec["rows"]),
                                        rec.get("columns"))
                        self._enforce_constraints(td, n0)
                    else:
                        apply_record(self, rec)
            except Exception as e:
                self.catalog = shared
                raise TransactionException(
                    f"transaction conflict on commit, rolled back: "
                    f"{e}") from e
            finally:
                self._replaying = was_replaying
            shared.tables = work.tables
            shared.views = work.views
            shared.enums = work.enums
            shared.schemas = work.schemas
            shared.macros = work.macros
            shared.bump()
            self.catalog = shared

    # ---- PREPARE arguments, PIVOT and UNPIVOT ----------------------------
    def _literal_value(self, e):
        """Constant expression -> python value (EXECUTE arguments)."""
        from .sql import ast as A
        if isinstance(e, A.ELit):
            return e.value
        if isinstance(e, A.EUnary) and e.op == "-":
            return -self._literal_value(e.child)
        if isinstance(e, A.ETyped):
            import datetime
            if e.typename == "date":
                return datetime.date.fromisoformat(e.text)
            if e.typename == "timestamp":
                return datetime.datetime.fromisoformat(e.text)
            return e.text
        raise NotImplementedError(
            f"EXECUTE argument {type(e).__name__} must be a literal")

    def _source_schema_names(self, ref):
        plan, _ = self._binder()._bind_ref(ref)
        return plan.schema.names

    def _rewrite_pivot(self, stmt):
        """PIVOT -> GROUP BY + one CASE-filtered aggregate per pivot value
        (reference: planner/binder/tableref/bind_pivot.cpp)."""
        from .sql import ast as A
        values = stmt.in_values
        if values is None:
            # discover the distinct pivot values with a query
            disc = A.SelectStmt(
                items=[(A.EIdent([stmt.on_col]), None)], distinct=True,
                from_refs=[stmt.source],
                order_by=[A.OrderItem(A.EIdent([stmt.on_col]))])
            values = [r[0] for r in
                      self._execute_statement(disc).fetchall()
                      if r[0] is not None]
        using = stmt.using
        if not using:
            using = [(A.EFunc("count", [], star=True), None)]
        group = list(stmt.group_by)
        if not group:
            # implicit: every column not referenced by ON or USING
            used = {stmt.on_col.lower()}
            for e, _ in using:
                used |= _ident_names(e)
            group = [n for n in self._source_schema_names(stmt.source)
                     if n.lower() not in used]
        items = [(A.EIdent([g]), None) for g in group]
        for v in values:
            for e, alias in using:
                filt = _pivot_filtered_agg(e, stmt.on_col, v)
                label = str(v) if len(using) == 1 else \
                    f"{v}_{alias or e.name}"
                items.append((filt, label))
        return A.SelectStmt(
            items=items, from_refs=[stmt.source],
            group_by=[A.EIdent([g]) for g in group],
            order_by=[A.OrderItem(A.EIdent([g])) for g in group])

    def _rewrite_unpivot(self, stmt):
        """UNPIVOT -> UNION ALL of per-column projections, NULLs dropped
        (reference: binder/tableref/bind_pivot.cpp unpivot path)."""
        from .sql import ast as A
        other = [n for n in self._source_schema_names(stmt.source)
                 if n.lower() not in {c.lower() for c in stmt.on_cols}]
        parts = []
        for col in stmt.on_cols:
            items = [(A.EIdent([o]), None) for o in other]
            items.append((A.ELit(col), stmt.name_col))
            items.append((A.EIdent([col]), stmt.value_col))
            parts.append(A.SelectStmt(
                items=items, from_refs=[stmt.source],
                where=A.EIsNull(A.EIdent([col]), negated=True)))
        out = parts[0]
        for nxt in parts[1:]:
            out = A.SelectStmt(set_left=out, set_op=("union", nxt, True))
        return out


def _progress_bar(done: int, total: int) -> None:
    """The share of plan nodes executed, drawn on stderr (reference:
    the progress bar of ddb_tpu/api.py, after main/query_progress.cpp)."""
    import sys
    width = 30
    filled = int(width * done / total)
    sys.stderr.write("\r[%s%s] %5.1f%%" % (
        "=" * filled, " " * (width - filled), 100.0 * done / total))
    if done >= total:
        sys.stderr.write("\n")
    sys.stderr.flush()


def _verify_mesh(device):
    """The mesh of verify_parallelism: every visible CUDA device when a
    CUDA connection sees two or more, else eight shards on the
    connection's device.  (The reference uses every visible device, which
    its tests make eight virtual CPU devices.)"""
    from .parallel.mesh import Mesh
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        return Mesh([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    return Mesh([device] * 8)


def _clone_table(td):
    """dml.clone_table, sharing the source's cached device batches and
    zone maps while neither table changes: the clone's columns are the
    source's arrays, and a mutation replaces arrays and drops only its
    own table's caches.  (The reference's clone uploads its own copy on
    first read: a second lineitem on the card inside a transaction.)"""
    out = dml.clone_table(td)
    out._device_batches = dict(td._device_batches)
    out._rg_stats = dict(td._rg_stats)
    return out


def _clone_catalog(src: Catalog) -> Catalog:
    """A catalog of shallow table clones (a transaction's snapshot, or
    the work copy a COMMIT replays into).  Sequences are shared: they are
    not transactional (reference: sequences bypass the undo buffer)."""
    out = Catalog()
    out.tables = {n: _clone_table(t) for n, t in src.tables.items()}
    out.views = dict(src.views)
    out.enums = dict(src.enums)
    out.sequences = src.sequences
    out.schemas = set(src.schemas)
    out.macros = dict(src.macros)
    return out


def _result_to_table(name, schema: Schema, batch: Batch):
    """A result's live rows as a host table (the low word of a wide
    column, as the reference keeps it)."""
    sel = batch.sel
    cols = []
    with span("ddb.storage.materialise"):
        for f, c in zip(schema.fields, batch.columns):
            d = c.data[sel]
            n = c.nulls[sel] if c.nulls is not None else None
            cols.append(storage.TableColumn(
                f.name, f.dtype, to_pinned_numpy(d),
                to_pinned_numpy(n) if n is not None else None,
                strdict=f.strdict, stats=_result_stats(f, d, n)))
        return storage.TableData(name, cols)


def _result_stats(f, data, nulls) -> storage.ColumnStats:
    """`TableColumn.compute_stats` of a result column, taken from its
    tensors on the result's device before the copy to the host: a pass
    there, not two over the host copy.  min and max are numpy scalars of
    the column's dtype, as the host arrays give them."""
    live = data if nulls is None else data[~nulls]
    s = storage.ColumnStats(has_nulls=bool(nulls is not None
                                           and nulls.any()))
    if len(live) and (f.dtype.id != TypeId.VARCHAR or f.strdict is not None):
        s.min, s.max = torch.stack((live.min(), live.max())).cpu().numpy()
    if f.strdict is not None:
        s.distinct_hint = len(f.strdict)
    return s


class Cursor:
    """PEP 249-style cursor over a Connection."""

    arraysize = 1

    def __init__(self, con: Connection):
        self._con = con
        self._res: Optional[QueryResult] = None
        self._pos = 0

    @property
    def description(self):
        if self._res is None:
            return None
        return [(f.name, repr(f.dtype), None, None, None, None, None)
                for f in self._res.schema.fields]

    @property
    def rowcount(self):
        if self._res is None:
            return -1
        return len(self._res.fetchall())

    def execute(self, sql: str, params=None) -> "Cursor":
        self._res = self._con.execute(sql, params)
        self._pos = 0
        return self

    def executemany(self, sql: str, seq) -> "Cursor":
        for params in seq:
            self.execute(sql, params)
        return self

    def fetchone(self):
        rows = self._res.fetchall() if self._res else []
        if self._pos >= len(rows):
            return None
        r = rows[self._pos]
        self._pos += 1
        return r

    def fetchmany(self, size=None):
        size = size or self.arraysize
        out = []
        for _ in range(size):
            r = self.fetchone()
            if r is None:
                break
            out.append(r)
        return out

    def fetchall(self):
        rows = self._res.fetchall() if self._res else []
        out = rows[self._pos:]
        self._pos = len(rows)
        return list(out)

    def close(self):
        self._res = None


class Appender:
    """Buffered bulk-ingest appender (reference: src/main/appender.cpp):
    rows accumulate client-side and flush in batches, bypassing the SQL
    front end; constraints, CDC and the transaction log apply at
    flush."""

    FLUSH_COUNT = 204800

    def __init__(self, con: Connection, table: str):
        self._con = con
        self._table = table
        self._ncols = len(con.catalog.get_table(table).columns)
        self._rows: list = []
        self._cur: list = []

    def append(self, value) -> "Appender":
        self._cur.append(value)
        return self

    def end_row(self) -> "Appender":
        if len(self._cur) != self._ncols:
            raise ValueError(
                f"appender row has {len(self._cur)} values, table "
                f"{self._table} has {self._ncols} columns")
        self._rows.append(self._cur)
        self._cur = []
        if len(self._rows) >= self.FLUSH_COUNT:
            self.flush()
        return self

    def append_row(self, *values) -> "Appender":
        for v in values:
            self.append(v)
        return self.end_row()

    def flush(self) -> None:
        if not self._rows:
            return
        rows, self._rows = self._rows, []
        con = self._con
        td = con.catalog.get_table(self._table)
        n0 = td.num_rows
        dml.insert_rows(td, rows, None)
        con._enforce_constraints(td, n0)
        con.catalog.bump()
        con._drop_stale_plans()
        con._emit_cdc(td.name, "insert", rows)
        con._log_insert(td, rows)

    def close(self) -> None:
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.flush()


def _resolve_type(return_type):
    if return_type is None:
        return T.BIGINT
    if isinstance(return_type, str):
        from .sql.binder import resolve_typename
        return resolve_typename(return_type, 0, 0)
    return return_type


def _const_python_value(bound):
    """Bound constant expression -> Python value (INSERT VALUES, SET
    VARIABLE, table function arguments).  A cast chain or a function of
    constants folds on the host, as the binder folds constants."""
    from .expr import ir
    from .expr.compile import evaluate_const
    if isinstance(bound, ir.Const) and bound.value is None:
        return None
    if isinstance(bound, ir.Const):
        raw = bound.value
    else:
        d, n = evaluate_const(bound)
        if n is not None and bool(n[0]):
            return None
        raw = d[0].numpy()[()]
    sd = getattr(bound, "strdict", None)
    if sd is not None:
        return sd.decode_one(int(raw))
    return T.decode_value(raw, bound.dtype)


def _ident_names(e) -> set:
    """All identifier names referenced by an unbound AST expression."""
    from .sql import ast as A
    out = set()
    if isinstance(e, A.EIdent):
        out.add(e.parts[-1].lower())
    for f in getattr(e, "__dataclass_fields__", {}):
        v = getattr(e, f)
        if isinstance(v, A.EExpr):
            out |= _ident_names(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, A.EExpr):
                    out |= _ident_names(x)
                elif isinstance(x, tuple):
                    for y in x:
                        if isinstance(y, A.EExpr):
                            out |= _ident_names(y)
    return out


def _pivot_filtered_agg(e, on_col: str, value):
    """agg(arg) -> agg(CASE WHEN on_col = value THEN arg END)."""
    from .sql import ast as A
    cond = A.EBinary("==", A.EIdent([on_col]), A.ELit(value))
    if e.star or not e.args:
        # count(*) -> count(CASE WHEN cond THEN 1 END)
        return A.EFunc(e.name, [A.ECase(None, [(cond, A.ELit(1))], None)])
    arg = e.args[0]
    return A.EFunc(e.name, [A.ECase(None, [(cond, arg)], None)]
                   + list(e.args[1:]), distinct=e.distinct)


def connect(device="cuda", database: Optional[str] = None) -> Connection:
    """A connection whose statements run on `device`: to a new in-memory
    database, or to the database file `database`, whose last checkpoint
    loads and whose write-ahead log replays (Connection.open_database)."""
    try:
        device = torch.device(device)
    except (RuntimeError, TypeError) as e:
        raise ValueError(
            f"connect(device='cuda', database=None): {device!r} is not a "
            "torch device; open a database file as connect(device, "
            "database=path)") from e
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("connect(device='cuda'): CUDA is not available")
    con = Connection(device)
    if database is not None and database != ":memory:":
        con.open_database(database)
    return con

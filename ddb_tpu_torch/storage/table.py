"""In-memory columnar table storage.

PyTorch port of ddb_tpu/storage/table.py: host-resident numpy columns with
per-column min/max/null statistics (zone maps) collected at ingest, plus
device batches cached per device.  The executor names the device; a
call without one comes from the binder and uses the device of the
statement being bound (`batch.current_bind_device`), and raises when no
statement is being bound.
"""

from __future__ import annotations

import datetime
import decimal
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..batch import (Batch, Field, Schema, current_bind_device,
                     make_batch)
from ..storage.strings import StringDictionary
from .. import types as T
from ..types import DataType, TypeId


# reference: STANDARD_ROW_GROUPS_SIZE, src/include/duckdb/storage/
# storage_info.hpp:20
ROW_GROUP_SIZE = 122_880

# scan-skipping counters (EXPLAIN ANALYZE / tests read these)
SCAN_STATS = {"groups_total": 0, "groups_skipped": 0}


@dataclass
class ColumnStats:
    min: Any = None
    max: Any = None
    has_nulls: bool = False
    distinct_hint: Optional[int] = None   # e.g. dictionary size


@dataclass
class TableColumn:
    name: str
    dtype: DataType
    data: np.ndarray                      # physical values
    nulls: Optional[np.ndarray] = None    # bool mask, True => NULL
    strdict: Optional[StringDictionary] = None
    stats: ColumnStats = field(default_factory=ColumnStats)

    def compute_stats(self):
        live = self.data if self.nulls is None else self.data[~self.nulls]
        s = ColumnStats(has_nulls=bool(self.nulls is not None
                                       and self.nulls.any()))
        if len(live):
            if self.dtype.id != TypeId.VARCHAR or self.strdict is not None:
                s.min = live.min()
                s.max = live.max()
        if self.strdict is not None:
            s.distinct_hint = len(self.strdict)
        self.stats = s


class TableData:
    """A named table: columns + device batches cached per device.

    Mutations (storage/dml.py) replace column arrays and then call
    `invalidate_cache`, which drops the batch of every device and the
    zone maps."""

    def __init__(self, name: str, columns: List[TableColumn]):
        self.name = name
        self.columns = columns
        self._device_batches: Dict[torch.device, Batch] = {}
        self._rg_stats: Dict[int, list] = {}
        # mutation stamp + last mutation kind drive lazy index refresh
        # (storage/index.py: pure appends merge incrementally)
        self.version = 0
        self.last_op: Optional[str] = None
        self.indexes: Dict[str, Any] = {}     # name -> SortedIndex
        for c in columns:
            if c.stats.min is None and not c.stats.has_nulls:
                c.compute_stats()

    def note_mutation(self, op: str):
        self.version += 1
        self.last_op = op

    def find_index(self, columns) -> Optional[Any]:
        """An index whose key columns equal `columns`, else one whose
        key is a superset starting with them (a (a,b) index serves
        equality lookups on (a,b); exact matches win)."""
        want = [c.lower() for c in columns]
        prefix_hit = None
        for ix in self.indexes.values():
            have = [c.lower() for c in ix.columns]
            if have == want:
                return ix
            if prefix_hit is None and have[:len(want)] == want:
                prefix_hit = ix
        return prefix_hit

    def invalidate_cache(self):
        """Drop the cached batch of every device and the zone maps: the
        columns changed, or the buffer manager evicts the table."""
        self._device_batches.clear()
        self._rg_stats.clear()
        handle = getattr(self, "_cache_handle", None)
        if handle is not None:
            from .buffer import MANAGER
            MANAGER.drop(handle)

    @property
    def num_rows(self) -> int:
        return len(self.columns[0].data) if self.columns else 0

    @property
    def schema(self) -> Schema:
        return Schema(tuple(Field(c.name, c.dtype, c.strdict)
                            for c in self.columns))

    def device_batch(self, column_indices=None, *, device=None) -> Batch:
        """Full-table batch on `device`, cached per device.
        column_indices selects a projection of the cached batch.

        The buffer manager (storage/buffer.py) tracks the host columns'
        bytes, as the reference counts them, and LRU-evicts other tables'
        caches when over budget (reference: src/storage/buffer_manager.cpp).
        It keys a table by the id of its `_CacheHandle`, not by device: one
        entry stands for the batches of every device, and an eviction
        drops them all."""
        device = current_bind_device() if device is None \
            else torch.device(device)
        if device.type == "cuda" and device.index is None:
            # "cuda" and "cuda:0" must share one cached copy
            device = torch.device("cuda", torch.cuda.current_device())
        b = self._device_batches.get(device)
        if b is None:
            b = make_batch([c.data for c in self.columns],
                           [c.nulls for c in self.columns], self.num_rows,
                           device=device)
            self._device_batches[device] = b
        nbytes = sum(c.data.nbytes + (c.nulls.nbytes if c.nulls is not None
                                      else 0) for c in self.columns)
        _note_use(self, nbytes)
        if column_indices is None:
            return b
        return Batch(tuple(b.columns[i] for i in column_indices),
                     b.sel, b.count)

    def device_batch_rows(self, column_indices, rows: np.ndarray, *,
                          device) -> Batch:
        """Batch of specific row ids (index point lookups): the rows are
        gathered on the host and copied to `device`, instead of a pass
        over the whole table (reference: index scan fallback in
        table_scan.cpp:77-250)."""
        cols = self.columns if column_indices is None else \
            [self.columns[i] for i in column_indices]
        arrays = [c.data[rows] for c in cols]
        nulls = [c.nulls[rows] if c.nulls is not None else None
                 for c in cols]
        return make_batch(arrays, nulls, len(rows), device=device)

    # ---- row groups (reference: src/storage/table/row_group.hpp:70) -----

    def row_group_stats(self, group_size: int = ROW_GROUP_SIZE):
        """Per-row-group per-column (min, max, has_nulls) zone maps."""
        cached = self._rg_stats.get(group_size)
        if cached is not None:
            return cached
        n = self.num_rows
        ngroups = max((n + group_size - 1) // group_size, 1)
        stats = []
        for g in range(ngroups):
            lo, hi = g * group_size, min((g + 1) * group_size, n)
            row = []
            for c in self.columns:
                chunk = c.data[lo:hi]
                nn = c.nulls[lo:hi] if c.nulls is not None else None
                has_nulls = bool(nn.any()) if nn is not None else False
                ordered = c.dtype.is_integer or c.dtype.id in (
                    TypeId.DECIMAL, TypeId.DATE, TypeId.TIME,
                    TypeId.TIMESTAMP, TypeId.TIMESTAMPTZ, TypeId.BOOLEAN,
                    TypeId.FLOAT, TypeId.DOUBLE) \
                    or (c.dtype.id == TypeId.VARCHAR
                        and c.strdict is not None)
                if not ordered:
                    row.append((None, None, has_nulls))
                    continue
                live = chunk if nn is None else chunk[~nn]
                if len(live) == 0:
                    row.append((None, None, has_nulls))
                else:
                    row.append((live.min(), live.max(), has_nulls))
            stats.append(row)
        self._rg_stats[group_size] = stats
        return stats

    def device_batch_groups(self, column_indices, group_ids,
                            group_size: int = ROW_GROUP_SIZE, *,
                            device) -> Batch:
        """Batch of only the given row groups' rows (zone-map scan
        skipping), gathered on the host and copied to `device`."""
        n = self.num_rows
        cols = self.columns if column_indices is None else \
            [self.columns[i] for i in column_indices]
        slices = [(g * group_size, min((g + 1) * group_size, n))
                  for g in group_ids]
        arrays = [np.concatenate([c.data[lo:hi] for lo, hi in slices])
                  if slices else c.data[:0] for c in cols]
        nulls = [np.concatenate([c.nulls[lo:hi] for lo, hi in slices])
                 if (c.nulls is not None and slices)
                 else (None if c.nulls is None else c.nulls[:0])
                 for c in cols]
        nrows = sum(hi - lo for lo, hi in slices)
        return make_batch(arrays, nulls, nrows, device=device)


class _CacheHandle:
    """What the buffer manager holds for a table in place of the table
    itself (the reference hands it the table): a weak reference.  The
    manager's entries live as long as the process, so a strong one would
    keep every dropped or replaced table, and its device batches, alive;
    when the table is collected its entry and bytes leave the manager."""

    def __init__(self, td):
        self._td = weakref.ref(td)

    def invalidate_cache(self):
        td = self._td()
        if td is not None:
            td.invalidate_cache()


def _note_use(td: TableData, nbytes: int):
    from .buffer import MANAGER
    handle = getattr(td, "_cache_handle", None)
    if handle is None:
        handle = td._cache_handle = _CacheHandle(td)
        weakref.finalize(td, MANAGER.drop, handle)
    MANAGER.note_use(handle, nbytes)


# ---------------------------------------------------------------------------
# ingest helpers
# ---------------------------------------------------------------------------

def from_reference_table(td) -> TableData:
    """Carry a ddb_tpu TableData over into the port without importing
    ddb_tpu: column names, types (rebuilt by TypeId name), numpy data and
    null masks, and string dictionaries (by their sorted values)."""

    def dtype_of(dt):
        if dt is None:
            return None
        children = None
        if dt.children is not None:
            children = tuple((n, dtype_of(c)) for n, c in dt.children)
        return DataType(TypeId[dt.id.name], dt.width, dt.scale,
                        dtype_of(dt.child), dtype_of(dt.child2), children)

    cols = []
    for c in td.columns:
        if c.strdict is not None and c.dtype.id.name != "VARCHAR":
            raise NotImplementedError(
                f"column {c.name}: nested type {c.dtype!r}")
        sd = StringDictionary(np.asarray(c.strdict.values)) \
            if c.strdict is not None else None
        cols.append(TableColumn(
            c.name, dtype_of(c.dtype), np.asarray(c.data),
            None if c.nulls is None else np.asarray(c.nulls, dtype=bool),
            strdict=sd))
    return TableData(td.name, cols)


_EPOCH = datetime.date(1970, 1, 1)


def _micros(v: datetime.datetime) -> int:
    d = v.replace(tzinfo=None) - datetime.datetime(1970, 1, 1)
    return (d.days * 86400 + d.seconds) * 1_000_000 + d.microseconds


def _python_logical_type(live) -> DataType:
    """Logical type of non-NULL Python values, as pyarrow infers it for
    the reference package: metadata only for nested payloads, whose
    values stay Python objects."""
    live = [v for v in live if v is not None]
    if not live:
        return T.INTEGER
    if all(isinstance(v, (list, tuple)) for v in live):
        return T.LIST(_python_logical_type([x for v in live for x in v]))
    if all(isinstance(v, dict) for v in live):
        fnames = list(dict.fromkeys(k for v in live for k in v))
        return T.STRUCT((fn, _python_logical_type([v.get(fn) for v in live]))
                        for fn in fnames)
    if all(isinstance(v, (bool, np.bool_)) for v in live):
        return T.BOOLEAN
    if all(isinstance(v, (int, np.integer)) for v in live):
        return T.BIGINT
    if all(isinstance(v, (int, float, np.integer, np.floating))
           for v in live):
        return T.DOUBLE
    if all(isinstance(v, datetime.datetime) for v in live):
        return T.TIMESTAMP
    if all(isinstance(v, datetime.date) for v in live):
        return T.DATE
    if all(isinstance(v, (bytes, bytearray)) for v in live):
        return T.BLOB
    return T.VARCHAR


def _column_from_values(name: str, values) -> TableColumn:
    """One column from a numpy array or a list of Python scalars (None =>
    NULL), typed as ddb_tpu types the same values through pyarrow."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "USMm":
        return _column_from_numpy_text_or_time(name, values)
    if isinstance(values, np.ndarray) and values.dtype != object:
        kind = {"b": T.BOOLEAN, "f": (T.DOUBLE if values.dtype.itemsize == 8
                                      else T.FLOAT)}.get(values.dtype.kind)
        if kind is None and values.dtype.kind in "iu":
            kind = T.BIGINT if values.dtype.itemsize == 8 \
                or values.dtype == np.uint32 else T.INTEGER
        if kind is None:
            raise NotImplementedError(f"column {name}: numpy dtype "
                                      f"{values.dtype}")
        return TableColumn(name, kind, values.astype(kind.np_dtype))
    vals = list(values)
    nulls = np.array([v is None for v in vals], dtype=bool)
    live = [v for v in vals if v is not None]
    if live and all(isinstance(v, str) for v in live):
        sd, codes, n2 = StringDictionary.encode(vals)
        return TableColumn(name, T.VARCHAR, codes, n2 if n2.any() else None,
                           strdict=sd)
    if live and all(isinstance(v, (bool, np.bool_)) for v in live):
        dt, conv = T.BOOLEAN, bool
    elif any(isinstance(v, decimal.Decimal) for v in live) and all(
            isinstance(v, (decimal.Decimal, int, np.integer))
            and not isinstance(v, bool) for v in live):
        # pyarrow's decimal128(p, s): s the largest scale, p the widest
        # integer part plus s; stored as ddb_tpu stores decimal128
        dec = [decimal.Decimal(int(v)) if not isinstance(v, decimal.Decimal)
               else v for v in live]
        scale = max(max(0, -d.as_tuple().exponent) for d in dec)
        whole = max(max(0, len(d.as_tuple().digits) + d.as_tuple().exponent)
                    for d in dec)
        dt = T.DECIMAL(min(max(whole + scale, 1), 18), scale)
        conv = (lambda v: int(decimal.Decimal(v).scaleb(scale)))
    elif all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
             for v in live):
        dt, conv = (T.INTEGER if not live else T.BIGINT), int
    elif all(isinstance(v, (int, float, np.integer, np.floating))
             and not isinstance(v, bool) for v in live):
        dt, conv = T.DOUBLE, float
    elif all(type(v) is datetime.date for v in live):
        dt, conv = T.DATE, (lambda v: (v - _EPOCH).days)
    elif all(isinstance(v, datetime.datetime) for v in live):
        dt, conv = T.TIMESTAMP, _micros
    elif all(isinstance(v, (list, tuple)) for v in live):
        # nested payloads stay on the host: rows carry an int32 store id
        # (see storage/lists.py and storage/nested.py)
        from .lists import ListStore
        store = ListStore([list(v) if v is not None else [] for v in vals])
        return TableColumn(name, _python_logical_type(live),
                           np.arange(len(vals), dtype=np.int32),
                           nulls if nulls.any() else None, strdict=store)
    elif all(isinstance(v, dict) for v in live):
        from .nested import StructStore
        st = _python_logical_type(live)
        fnames = [n for n, _ in st.children]
        store = StructStore(fnames, [tuple((v or {}).get(fn)
                                           for fn in fnames) for v in vals])
        return TableColumn(name, st, np.arange(len(vals), dtype=np.int32),
                           nulls if nulls.any() else None, strdict=store)
    elif all(isinstance(v, (bytes, bytearray)) for v in live):
        from .nested import BlobStore
        store = BlobStore([bytes(v) if v is not None else b"" for v in vals])
        return TableColumn(name, T.BLOB, np.arange(len(vals), dtype=np.int32),
                           nulls if nulls.any() else None, strdict=store)
    else:
        raise NotImplementedError(f"column {name}: mixed or unsupported "
                                  f"Python values")
    data = np.array([conv(v) if v is not None else 0 for v in vals],
                    dtype=dt.np_dtype)
    return TableColumn(name, dt, data, nulls if nulls.any() else None)


# numpy datetime64 units that pyarrow takes: D as date32, the rest as
# timestamps, which ddb_tpu casts to microseconds
_TIMESTAMP_UNITS = {"s": 1_000_000, "ms": 1_000, "us": 1, "ns": None}


def _column_from_numpy_text_or_time(name: str, values) -> TableColumn:
    """A numpy str_ (U), bytes_ (S) or datetime64 (M) array as ddb_tpu
    types it through pyarrow: VARCHAR, BLOB, DATE (unit D) or TIMESTAMP
    (units s to ns; NaT is NULL).  timedelta64 (m) raises TypeError, as
    ddb_tpu does for the duration pyarrow makes of it; another datetime64
    unit raises NotImplementedError, as pyarrow does."""
    kind = values.dtype.kind
    if kind == "U":
        sd, codes, _ = StringDictionary.encode(values.tolist())
        return TableColumn(name, T.VARCHAR, codes, strdict=sd)
    if kind == "S":
        from .nested import BlobStore
        return TableColumn(name, T.BLOB,
                           np.arange(len(values), dtype=np.int32),
                           strdict=BlobStore(values.tolist()))
    if kind == "m":
        raise TypeError(f"unsupported numpy type {values.dtype} (an "
                        f"interval) for column {name}")
    unit, count = np.datetime_data(values.dtype)
    nat = np.isnat(values)
    nulls = nat if nat.any() else None
    if unit == "D" and count == 1:
        days = np.where(nat, 0, values.astype(np.int64)).astype(np.int32)
        return TableColumn(name, T.DATE, days, nulls)
    if unit not in _TIMESTAMP_UNITS or count != 1:
        raise NotImplementedError(f"column {name}: unsupported datetime64 "
                                  f"unit {values.dtype}")
    raw = np.where(nat, 0, values.view(np.int64))
    scale = _TIMESTAMP_UNITS[unit]
    if scale is None:
        # a safe cast of nanoseconds: no truncation
        if (raw % 1000).any():
            raise ValueError(f"column {name}: casting {values.dtype} to "
                             "microseconds would lose data")
        micros = raw // 1000
    else:
        micros = raw * scale
    return TableColumn(name, T.TIMESTAMP, micros.astype(np.int64), nulls)


def from_pydict(name: str, data: Dict[str, Any]) -> TableData:
    """Build a TableData from a dict of lists or numpy arrays (no pyarrow)."""
    return TableData(name, [_column_from_values(k, v)
                            for k, v in data.items()])


def from_arrow(name: str, atable) -> TableData:
    """Build a TableData from a pyarrow Table (scalar column types)."""
    return TableData(name, [_from_arrow_column(f.name,
                                               atable.column(i)
                                               .combine_chunks())
                            for i, f in enumerate(atable.schema)])


def _from_arrow_column(name: str, arr) -> TableColumn:
    import pyarrow as pa
    import pyarrow.compute as pc

    t = arr.type
    nulls = None
    if arr.null_count:
        nulls = np.asarray(pc.is_null(arr)).astype(bool)

    def np_of(a, dtype):
        v = np.ascontiguousarray(a.to_numpy(zero_copy_only=False))
        if nulls is not None:
            v = np.where(nulls, np.zeros((), dtype=dtype), v)
        return v.astype(dtype)

    if pa.types.is_null(t):
        n = len(arr)
        return TableColumn(name, T.INTEGER, np.zeros(n, dtype=np.int32),
                           np.ones(n, dtype=bool) if n else None)
    if pa.types.is_boolean(t):
        return TableColumn(name, T.BOOLEAN, np_of(arr, np.bool_), nulls)
    if pa.types.is_integer(t):
        wide = pa.types.is_int64(t) or pa.types.is_uint32(t) \
            or pa.types.is_uint64(t)
        dt = T.BIGINT if wide else T.INTEGER
        return TableColumn(name, dt, np_of(arr, dt.np_dtype), nulls)
    if pa.types.is_floating(t):
        dt = T.DOUBLE if pa.types.is_float64(t) else T.FLOAT
        return TableColumn(name, dt, np_of(arr, dt.np_dtype), nulls)
    if pa.types.is_decimal(t):
        dt = T.DECIMAL(min(t.precision, 18), t.scale)
        if t.byte_width == 16 and len(arr):
            # decimal128's words: the low one is the scaled integer when
            # the high one is its sign
            words = np.frombuffer(arr.buffers()[1], dtype=np.int64) \
                .reshape(-1, 2)[arr.offset:arr.offset + len(arr)]
            live = slice(None) if nulls is None else ~nulls
            if np.array_equal(words[live, 1], words[live, 0] >> 63):
                v = words[:, 0] if nulls is None \
                    else np.where(nulls, 0, words[:, 0])
                return TableColumn(name, dt, np.ascontiguousarray(v),
                                   nulls)
        v = np.array([0 if x is None else int(x.scaleb(t.scale))
                      for x in arr.to_pylist()], dtype=np.int64)
        return TableColumn(name, dt, v, nulls)
    if pa.types.is_date(t):
        v = np.asarray(arr.cast(pa.date32()).to_numpy(zero_copy_only=False))
        v = v.astype("datetime64[D]").astype(np.int64).astype(np.int32) \
            if v.dtype.kind == "M" else v.astype(np.int32)
        if nulls is not None:
            v = np.where(nulls, 0, v)
        return TableColumn(name, T.DATE, v, nulls)
    if pa.types.is_timestamp(t):
        v = arr.cast(pa.timestamp("us")).to_numpy(zero_copy_only=False) \
            .astype("datetime64[us]").astype(np.int64)
        if nulls is not None:
            v = np.where(nulls, 0, v)
        return TableColumn(name, T.TIMESTAMP, v, nulls)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        # StringDictionary.encode's dictionary and codes, from Arrow's own
        # dictionary of the values ("" stands for NULL, as there)
        enc = arr.dictionary_encode()
        seen = enc.dictionary.to_pylist()
        values = np.unique(np.array(
            seen + ([""] if nulls is not None else []),
            dtype=object).astype(str))
        lut = np.searchsorted(values, np.array(seen, dtype=object)
                              .astype(str)).astype(np.int32) if seen \
            else np.zeros(1, dtype=np.int32)
        idx = np.asarray(enc.indices.fill_null(0)).astype(np.int64)
        codes = lut[idx] if len(idx) else np.zeros(0, dtype=np.int32)
        if nulls is not None:
            codes[nulls] = 0
        return TableColumn(name, T.VARCHAR, codes.astype(np.int32), nulls,
                           strdict=StringDictionary(values))
    if pa.types.is_dictionary(t):
        return _from_arrow_column(name, arr.cast(pa.string()))
    # nested / var-len payloads: rows carry an int32 store id, payloads
    # stay host-side (see storage/nested.py; reference: nested Vector
    # child vectors, src/common/types/vector.cpp)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        from .lists import ListStore
        py = arr.to_pylist()
        store = ListStore([x if x is not None else [] for x in py])
        ids = np.arange(len(py), dtype=np.int32)
        return TableColumn(name, T.LIST(_arrow_logical_type(t.value_type)),
                           ids, nulls, strdict=store)
    if pa.types.is_struct(t):
        from .nested import StructStore
        fnames = [t.field(i).name for i in range(t.num_fields)]
        py = arr.to_pylist()
        items = [tuple((x or {}).get(fn) for fn in fnames) for x in py]
        store = StructStore(fnames, items)
        st = T.STRUCT((t.field(i).name,
                       _arrow_logical_type(t.field(i).type))
                      for i in range(t.num_fields))
        ids = np.arange(len(py), dtype=np.int32)
        return TableColumn(name, st, ids, nulls, strdict=store)
    if pa.types.is_map(t):
        from .nested import MapStore
        py = arr.to_pylist()
        store = MapStore([list(x) if x is not None else [] for x in py])
        mt = T.MAP(_arrow_logical_type(t.key_type),
                   _arrow_logical_type(t.item_type))
        ids = np.arange(len(py), dtype=np.int32)
        return TableColumn(name, mt, ids, nulls, strdict=store)
    if pa.types.is_binary(t) or pa.types.is_large_binary(t) \
            or pa.types.is_fixed_size_binary(t):
        from .nested import BlobStore
        py = arr.to_pylist()
        store = BlobStore([x if x is not None else b"" for x in py])
        ids = np.arange(len(py), dtype=np.int32)
        return TableColumn(name, T.BLOB, ids, nulls, strdict=store)
    raise TypeError(f"unsupported arrow type {t} for column {name}")


def _arrow_logical_type(t) -> DataType:
    """Arrow type -> our logical DataType (element types of nested
    payloads; payload values stay python-side, so this is metadata)."""
    import pyarrow as pa
    if pa.types.is_boolean(t):
        return T.BOOLEAN
    if pa.types.is_integer(t):
        wide = pa.types.is_int64(t) or pa.types.is_uint32(t) \
            or pa.types.is_uint64(t)
        return T.BIGINT if wide else T.INTEGER
    if pa.types.is_floating(t):
        return T.DOUBLE if pa.types.is_float64(t) else T.FLOAT
    if pa.types.is_decimal(t):
        return T.DECIMAL(min(t.precision, 38), t.scale)
    if pa.types.is_date(t):
        return T.DATE
    if pa.types.is_timestamp(t):
        return T.TIMESTAMP
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return T.LIST(_arrow_logical_type(t.value_type))
    if pa.types.is_struct(t):
        return T.STRUCT((t.field(i).name,
                         _arrow_logical_type(t.field(i).type))
                        for i in range(t.num_fields))
    if pa.types.is_map(t):
        return T.MAP(_arrow_logical_type(t.key_type),
                     _arrow_logical_type(t.item_type))
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return T.BLOB
    return T.VARCHAR


def from_pandas(name: str, df) -> TableData:
    """Build a TableData from a pandas DataFrame through Arrow, as the
    reference does (pyarrow is imported here only)."""
    import pyarrow as pa
    return from_arrow(name, pa.Table.from_pandas(df, preserve_index=False))

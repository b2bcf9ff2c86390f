"""Table mutation (INSERT/DELETE/UPDATE) — copy-on-write.

Analog of the reference's DML operators + local storage
(reference: src/execution/operator/persistent/physical_insert.cpp,
physical_delete.cpp, physical_update.cpp, src/storage/local_storage.cpp).
Every mutation REPLACES column arrays instead of mutating in place, so a
snapshot (fork parity: Connection::CreateSnapshot, reference:
src/main/connection.cpp:190-205) is a shallow copy of the table list.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as T
from ..types import DataType, TypeId
from .strings import StringDictionary
from .table import ColumnStats, TableColumn, TableData


class ConstraintException(Exception):
    """PRIMARY KEY / UNIQUE / NOT NULL violation (reference:
    ConstraintException, src/common/exception.cpp; enforced by ART index
    inserts upstream — here by a vectorized sort + adjacent-equal scan,
    src/execution/index/art/art.cpp:VerifyAppend analog)."""


def check_constraints(td: TableData) -> None:
    """Validate NOT NULL + PRIMARY KEY/UNIQUE over the FULL table.
    Raises ConstraintException on the first violation."""
    byname = {c.name: c for c in td.columns}
    for cname in getattr(td, "not_null", ()):
        c = byname.get(cname)
        if c is not None and c.nulls is not None and c.nulls.any():
            raise ConstraintException(
                f"Constraint Error: NOT NULL constraint failed: "
                f"{td.name}.{cname}")
    for cname, (tname, allowed) in getattr(td, "enum_domains",
                                           {}).items():
        c = byname.get(cname)
        if c is None or c.strdict is None or not len(c.data):
            continue
        # only codes actually referenced by live rows count (a rolled-back
        # insert may leave orphan dictionary entries); NULL rows are
        # excluded via the mask, but '' is a value like any other and
        # must be a declared member (reference rejects any non-member)
        codes = c.data if c.nulls is None else c.data[~c.nulls]
        live = {str(c.strdict.decode_one(int(k)))
                for k in np.unique(codes)}
        bad = live - set(allowed)
        if bad:
            raise ConstraintException(
                f"Conversion Error: value '{sorted(bad)[0]}' is not a "
                f"member of ENUM {tname}")
    for cname in getattr(td, "bit_columns", ()):
        c = byname.get(cname)
        if c is None or c.strdict is None or not len(c.data):
            continue
        from ..expr import bits as B
        codes = c.data if c.nulls is None else c.data[~c.nulls]
        for k in np.unique(codes):
            try:
                B.validate(str(c.strdict.decode_one(int(k))))
            except B.BitError as ex:
                raise ConstraintException(f"Conversion Error: {ex}")
    for kind, colnames in getattr(td, "constraints", ()):
        cols = [byname[n] for n in colnames if n in byname]
        if not cols or td.num_rows < 2:
            continue
        # UNIQUE ignores rows with NULL keys (SQL: NULLs never conflict);
        # PRIMARY KEY nulls are caught by the NOT NULL pass above.
        # Enforcement rides the point-lookup index: pure appends merge
        # the new block incrementally instead of re-sorting the table
        # (reference: ART VerifyAppend, src/execution/index/art/art.cpp)
        from .index import SortedIndex
        iname = "__uniq_" + "_".join(c.lower() for c in colnames)
        ix = td.indexes.get(iname)
        if ix is None:
            ix = SortedIndex(iname, list(colnames), unique=True)
            td.indexes[iname] = ix
        ix.refresh(td)
        if ix.has_internal_duplicates():
            raise ConstraintException(
                f"Constraint Error: duplicate key violates "
                f"{kind.replace('_', ' ')} constraint on {td.name}"
                f"({', '.join(colnames)})")


def _fk_tuples(td: TableData, cols, need_mask=False):
    """Comparable key tuples for FK verification: raw values for
    numerics, decoded text for dictionary-coded columns (codes are
    per-table and NOT comparable across tables).  Rows with any NULL
    key column are exempt (SQL MATCH SIMPLE semantics, same as the
    reference's ART-based VerifyForeignKey)."""
    byname = {c.name: c for c in td.columns}
    n = td.num_rows
    null = np.zeros(n, dtype=bool)
    arrs = []
    for cn in cols:
        c = byname.get(cn)
        if c is None:
            raise ConstraintException(
                f"Binder Error: column {cn} referenced by FOREIGN KEY "
                f"does not exist in {td.name}")
        if c.nulls is not None:
            null = null | np.asarray(c.nulls)
        d = np.asarray(c.data)
        if c.strdict is not None:
            d = c.strdict.decode(np.clip(d, 0, max(len(c.strdict) - 1,
                                                   0)).astype(np.int64))
        arrs.append(d)
    live = ~null
    if len(arrs) == 1:
        vals = arrs[0][live]
        return (vals, live) if need_mask else vals
    tup = list(zip(*(a[live] for a in arrs)))
    return (tup, live) if need_mask else tup


def _fk_subset_check(child: TableData, cols, parent: TableData, pcols,
                     verb: str) -> None:
    cvals, _ = _fk_tuples(child, cols, need_mask=True)
    pvals = _fk_tuples(parent, pcols)
    if isinstance(cvals, list):
        missing = set(cvals) - set(pvals)
        if missing:
            raise ConstraintException(
                f"Constraint Error: Violates foreign key constraint "
                f"({verb}): key {sorted(missing)[0]!r} of {child.name}"
                f"({', '.join(cols)}) does not exist in "
                f"{parent.name}({', '.join(pcols)})")
    else:
        if len(cvals):
            ok = np.isin(cvals, pvals)
            if not ok.all():
                bad = cvals[~ok][0]
                raise ConstraintException(
                    f"Constraint Error: Violates foreign key constraint "
                    f"({verb}): key {bad!r} of {child.name}"
                    f"({', '.join(cols)}) does not exist in "
                    f"{parent.name}({', '.join(pcols)})")


def check_foreign_keys(td: TableData, catalog) -> None:
    """Full FOREIGN KEY verification around a mutation of td
    (reference: DataTable::VerifyNewConstraint + VerifyForeignKey paths
    in src/storage/data_table.cpp; ours re-validates set inclusion with
    vectorized isin over the whole table — correctness first, the
    incremental ART walk is an optimization we skip).

      * outbound: td's FK values must exist in each parent
      * inbound: every table whose FK references td must still be
        covered (DELETE/UPDATE on the parent)
    """
    for cols, parent, pcols in getattr(td, "foreign_keys", ()):
        try:
            ptd = catalog.get_table(parent)
        except Exception:
            continue       # parent dropped concurrently: nothing to check
        _fk_subset_check(td, cols, ptd, pcols, "insert/update")
    for other in catalog.tables.values():
        if other is td:
            continue
        for cols, parent, pcols in getattr(other, "foreign_keys", ()):
            if parent == td.name:
                _fk_subset_check(other, cols, td, pcols,
                                 "delete/update on referenced table")


def truncate_rows(td: TableData, n: int) -> None:
    """Roll an append back to the first n rows (constraint failure)."""
    for col in td.columns:
        col.data = col.data[:n]
        if col.nulls is not None:
            col.nulls = col.nulls[:n]
        col.compute_stats()
    td.note_mutation("truncate")
    td.invalidate_cache()


def clone_table(td: TableData) -> TableData:
    """Shallow snapshot clone (arrays shared; mutations replace arrays)."""
    cols = [TableColumn(c.name, c.dtype, c.data, c.nulls, c.strdict,
                        c.stats) for c in td.columns]
    out = TableData(td.name, cols)
    out.constraints = list(getattr(td, "constraints", []))
    out.not_null = set(getattr(td, "not_null", ()))
    out.enum_domains = dict(getattr(td, "enum_domains", {}))
    out.foreign_keys = list(getattr(td, "foreign_keys", []))
    if getattr(td, "defaults", None):
        out.defaults = dict(td.defaults)
    from .index import SortedIndex
    out.indexes = {k: SortedIndex(v.name, list(v.columns), v.unique)
                   for k, v in getattr(td, "indexes", {}).items()}
    return out


def empty_table(name: str, fields) -> TableData:
    """fields: list[(name, DataType)]"""
    cols = []
    for cname, dt in fields:
        data = np.zeros(0, dtype=dt.np_dtype)
        if dt.id == TypeId.VARCHAR:
            sd = StringDictionary(np.array([], dtype=object).astype(str))
        elif dt.id == TypeId.UNION:
            from .nested import UnionStore
            sd = UnionStore([nm for nm, _t in (dt.children or ())])
        elif dt.id == TypeId.LIST:
            from .lists import ListStore
            sd = ListStore()
        elif dt.id == TypeId.STRUCT:
            from .nested import StructStore
            sd = StructStore([n for n, _t in (dt.children or ())])
        elif dt.id == TypeId.MAP:
            from .nested import MapStore
            sd = MapStore()
        else:
            sd = None
        cols.append(TableColumn(cname, dt, data, None, sd))
    return TableData(name, cols)


def _union_member_of(members, v) -> int:
    """Implicit member selection for a python value inserted into a
    UNION column (reference: union implicit cast resolution,
    src/function/cast/union_casts.cpp)."""
    def pri(k, t):
        tid = t.id
        if isinstance(v, bool):
            return 0 if tid == TypeId.BOOLEAN else 9
        if isinstance(v, int):
            return 0 if t.is_integer else \
                (1 if tid in (TypeId.FLOAT, TypeId.DOUBLE,
                              TypeId.DECIMAL) else 9)
        if isinstance(v, float):
            return 0 if tid in (TypeId.FLOAT, TypeId.DOUBLE) else 9
        if isinstance(v, str):
            return 0 if tid == TypeId.VARCHAR else 9
        return 5
    best, bestp = 0, 99
    for k, (n, t) in enumerate(members):
        p = pri(k, t)
        if p < bestp:
            best, bestp = k, p
    return best


def _encode_values(col: TableColumn, values: Sequence):
    """Python values -> (physical array, null mask, new strdict or None).

    For VARCHAR, returns codes against a dict EXTENDED with the new values
    plus a translate table for existing codes."""
    n = len(values)
    nulls = np.array([v is None for v in values], dtype=bool)
    if col.dtype.id == TypeId.UNION:
        store = col.strdict
        members = col.dtype.children or ()
        codes = np.zeros(n, dtype=np.int32)
        for i, v in enumerate(values):
            if v is None:
                continue
            k = _union_member_of(members, v)
            codes[i] = store.add(k, v)
        return codes, nulls, None
    if col.dtype.id in (TypeId.LIST, TypeId.STRUCT, TypeId.MAP):
        # store-backed nested values: append payloads, store ids
        # (reference: nested vectors own child vectors; ours keep
        # payloads host-side per storage/lists.py design)
        store = col.strdict
        codes = np.zeros(n, dtype=np.int32)
        for i, v in enumerate(values):
            if v is None:
                continue
            if col.dtype.id == TypeId.STRUCT and isinstance(v, dict):
                v = tuple(v.get(nm) for nm in store.names)
            elif col.dtype.id == TypeId.MAP and isinstance(v, dict):
                v = list(v.items())
            codes[i] = store.add(v)
        return codes, nulls, None
    if col.dtype.id == TypeId.VARCHAR:
        new_strs = np.unique(np.array(
            [("" if v is None else str(v)) for v in values], dtype=object)
            .astype(str))
        merged = np.unique(np.concatenate([col.strdict.values, new_strs])) \
            if len(col.strdict.values) else new_strs
        md = StringDictionary(merged)
        translate = col.strdict.translate_to(md) \
            if len(col.strdict.values) else None
        codes = np.array([md.code_of("" if v is None else str(v))
                          for v in values], dtype=np.int32)
        return codes, nulls, (md, translate)
    phys = np.array([T.encode_literal(v, col.dtype) for v in values],
                    dtype=col.dtype.np_dtype)
    return phys, nulls, None


def insert_rows(td: TableData, rows: List[Sequence],
                columns: Optional[List[str]] = None):
    """Append python-value rows.  Missing columns get NULL."""
    names = [c.name for c in td.columns]
    if columns is None:
        columns = names
    colmap = {c: i for i, c in enumerate(columns)}
    n = len(rows)
    for ci, col in enumerate(td.columns):
        if col.name in colmap:
            vals = [r[colmap[col.name]] for r in rows]
        else:
            vals = [None] * n
        data, nulls, dictinfo = _encode_values(col, vals)
        if dictinfo is not None:
            md, translate = dictinfo
            old = col.data if translate is None else \
                translate[col.data].astype(np.int32)
            col.strdict = md
            col.data = np.concatenate([old, data])
        else:
            col.data = np.concatenate([col.data, data])
        if nulls.any() or col.nulls is not None:
            old_n = col.nulls if col.nulls is not None else \
                np.zeros(len(col.data) - n, dtype=bool)
            col.nulls = np.concatenate([old_n, nulls])
        col.compute_stats()
    td.note_mutation("insert")
    td.invalidate_cache()
    return n


_INT_BITS = {TypeId.TINYINT: 8, TypeId.SMALLINT: 16, TypeId.INTEGER: 32,
             TypeId.BIGINT: 64}
# the raw values the Python round trip below maps to a sentinel:
# date.min/max and datetime.min/max (types.decode_value/encode_literal)
_SENTINELS = {TypeId.DATE: (-719162, 2932896, T.DATE_NINF, T.DATE_INF),
              TypeId.TIMESTAMP: (-62135596800000000, 253402300799999999,
                                 T.TS_NINF, T.TS_INF)}


def _appends_whole(col: TableColumn, s: TableColumn) -> bool:
    """Whether `s` appends to `col` without Python values: integers of any
    width into integers, or the same type (a DECIMAL of the same scale, a
    DATE or TIMESTAMP inside date's and datetime's range or at the
    sentinels, a VARCHAR into a table's own dictionary)."""
    a, b = col.dtype.id, s.dtype.id
    if a in _INT_BITS and b in _INT_BITS:
        return True
    if a != b:
        return False
    if a == TypeId.VARCHAR:
        return col.strdict is not None and s.strdict is not None \
            and not getattr(col.strdict, "runtime", False)
    if a == TypeId.DECIMAL:
        return col.dtype.scale == s.dtype.scale
    if a in _SENTINELS:
        lo, hi, ninf, inf = _SENTINELS[a]
        live = s.data if s.nulls is None else s.data[~s.nulls]
        return not len(live) or bool(
            (((live >= lo) & (live <= hi)) | (live <= ninf)
             | (live >= inf)).all())
    return a in (TypeId.DOUBLE, TypeId.BOOLEAN)


def _append_whole(td: TableData, src_cols: List[TableColumn]) -> int:
    """append_table's result without its Python values: the same arrays,
    dictionaries, NULL masks and stats, built column by column."""
    n = len(src_cols[0].data) if src_cols else 0
    parts = []
    for col, s in zip(td.columns, src_cols):
        nulls = s.nulls if s.nulls is not None else np.zeros(n, dtype=bool)
        tid = col.dtype.id
        if tid == TypeId.VARCHAR:
            live = ~nulls
            used = s.strdict.values[np.unique(s.data[live])].astype(str)
            new = np.unique(np.concatenate(
                [used, np.array([""] if nulls.any() else [], dtype=str)]))
            merged = np.unique(np.concatenate([col.strdict.values, new])) \
                if len(col.strdict.values) else new
            md = StringDictionary(merged)
            codes = np.zeros(n, dtype=np.int32)
            if live.any():
                codes[live] = np.searchsorted(
                    merged, s.strdict.values.astype(str))[s.data[live]]
            codes[nulls] = np.searchsorted(merged, "")
            old = col.data if not len(col.strdict.values) else \
                col.strdict.translate_to(md)[col.data].astype(np.int32)
            parts.append((old, codes, md))
            continue
        data = np.where(nulls, 0, s.data)
        if tid in _INT_BITS:
            bits = _INT_BITS[tid]
            live = data[~nulls]
            if len(live) and (live.min() < -(1 << (bits - 1))
                              or live.max() >= 1 << (bits - 1)):
                raise OverflowError(f"Python integer out of bounds for "
                                    f"int{bits}")
        elif tid in _SENTINELS:
            lo, hi, ninf, inf = _SENTINELS[tid]
            data = np.where(data <= lo, ninf, np.where(data >= hi, inf,
                                                       data))
            data = np.where(nulls, 0, data)
        parts.append((col.data, data.astype(col.dtype.np_dtype), None))
    for col, s, (old, data, md) in zip(td.columns, src_cols, parts):
        if md is not None:
            col.strdict = md
        col.data = np.concatenate([old, data])
        if (s.nulls is not None and s.nulls.any()) or col.nulls is not None:
            old_n = col.nulls if col.nulls is not None else \
                np.zeros(len(col.data) - n, dtype=bool)
            col.nulls = np.concatenate([
                old_n, s.nulls if s.nulls is not None
                else np.zeros(n, dtype=bool)])
        col.compute_stats()
    td.note_mutation("insert")
    td.invalidate_cache()
    return n


def append_table(td: TableData, src_cols: List[TableColumn]):
    """Append another table's columns (types must be compatible)."""
    if len(td.columns) == len(src_cols) and all(
            _appends_whole(c, s) for c, s in zip(td.columns, src_cols)):
        return _append_whole(td, src_cols)
    rows = None
    pyvals = []
    for col, s in zip(td.columns, src_cols):
        if s.dtype.id == TypeId.VARCHAR or (
                s.strdict is not None and s.dtype.id in (
                    TypeId.LIST, TypeId.STRUCT, TypeId.MAP,
                    TypeId.BLOB, TypeId.UUID, TypeId.UNION)):
            vals = [None if (s.nulls is not None and s.nulls[i])
                    else s.strdict.decode_one(int(s.data[i]))
                    for i in range(len(s.data))]
        else:
            vals = [None if (s.nulls is not None and s.nulls[i])
                    else T.decode_value(s.data[i], s.dtype)
                    for i in range(len(s.data))]
        pyvals.append(vals)
    n = len(pyvals[0]) if pyvals else 0
    rows = list(zip(*pyvals)) if pyvals else []
    return insert_rows(td, rows)


def delete_rows(td: TableData, mask: np.ndarray) -> int:
    """Delete rows where mask is True; returns count deleted."""
    keep = ~mask
    for col in td.columns:
        col.data = col.data[keep]
        if col.nulls is not None:
            col.nulls = col.nulls[keep]
        col.compute_stats()
    td.note_mutation("delete")
    td.invalidate_cache()
    return int(mask.sum())


def update_rows(td: TableData, mask: np.ndarray,
                updates: Dict[str, tuple]) -> int:
    """updates: column name -> (values array over ALL rows, nulls or None,
    value strdict for VARCHAR).  Applies at mask positions (copy-on-write)."""
    for col in td.columns:
        if col.name not in updates:
            continue
        vals, vnulls, vdict = updates[col.name]
        if col.dtype.id == TypeId.VARCHAR:
            # decode new values to strings, re-encode into merged dict
            strs = [None if (vnulls is not None and vnulls[i])
                    else vdict.decode_one(int(vals[i]))
                    for i in np.nonzero(mask)[0]]
            data, nulls, dictinfo = _encode_values(col, strs)
            md, translate = dictinfo
            base = col.data if translate is None else \
                translate[col.data].astype(np.int32)
            new = base.copy()
            new[mask] = data
            col.strdict = md
            col.data = new
        else:
            new = col.data.copy()
            new[mask] = np.asarray(vals)[mask].astype(col.dtype.np_dtype)
            col.data = new
        if vnulls is not None or col.nulls is not None:
            old_n = col.nulls.copy() if col.nulls is not None else \
                np.zeros(len(col.data), dtype=bool)
            old_n[mask] = vnulls[mask] if vnulls is not None else False
            col.nulls = old_n if old_n.any() else None
        col.compute_stats()
    td.note_mutation("update")
    td.invalidate_cache()
    return int(mask.sum())


def rows_as_python(td: TableData, mask: np.ndarray) -> List[tuple]:
    """Materialize masked rows as python tuples (CDC row images)."""
    idx = np.nonzero(mask)[0]
    out = []
    for i in idx:
        row = []
        for col in td.columns:
            if col.nulls is not None and col.nulls[i]:
                row.append(None)
            elif col.dtype.id == TypeId.VARCHAR:
                row.append(col.strdict.decode_one(int(col.data[i])))
            else:
                row.append(T.decode_value(col.data[i], col.dtype))
        out.append(tuple(row))
    return out

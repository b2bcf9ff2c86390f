"""Write-ahead log: durable logical-operation log + replay.

TPU-native analog of the reference WAL (reference:
src/storage/write_ahead_log.hpp:47, wal_replay.cpp): every
catalog/data-mutating statement appends a checksummed logical record
*before* it is considered durable; opening a database file replays the
log on top of the last checkpoint.  CHECKPOINT (or the
`wal_autocheckpoint` size threshold, reference
duck_transaction.hpp:64 AutomaticCheckpoint) rewrites the single-file
checkpoint via the native writer and truncates the log.

Record format (binary, append-only):
    magic  "DTBWAL1\n"
    record := u32 length | u32 crc32(payload) | payload (JSON, utf-8)
Replay stops at the first truncated/corrupt record — a torn tail from a
crash loses only the unflushed suffix, like the reference's replay.

Values inside records are tagged JSON: dates {"__d": iso}, timestamps
{"__dt": iso}, decimals {"__n": str}, intervals {"__iv": months, days,
micros} so row images round-trip exactly.
"""

from __future__ import annotations

import datetime
import decimal
import json
import os
import struct
import zlib
from typing import Iterator, List, Optional

MAGIC = b"DTBWAL1\n"
_HDR = struct.Struct("<II")


def encode_value(v):
    if isinstance(v, decimal.Decimal):
        return {"__n": str(v)}
    if isinstance(v, datetime.datetime):
        return {"__dt": v.isoformat()}
    if isinstance(v, datetime.date):
        return {"__d": v.isoformat()}
    if isinstance(v, datetime.timedelta):
        return {"__td": [v.days, v.seconds, v.microseconds]}
    if hasattr(v, "item"):           # numpy scalar
        return v.item()
    return v


def decode_value(v):
    if isinstance(v, dict):
        if "__n" in v:
            return decimal.Decimal(v["__n"])
        if "__dt" in v:
            return datetime.datetime.fromisoformat(v["__dt"])
        if "__d" in v:
            return datetime.date.fromisoformat(v["__d"])
        if "__td" in v:
            d, s, us = v["__td"]
            return datetime.timedelta(days=d, seconds=s, microseconds=us)
    return v


def encode_rows(rows) -> list:
    return [[encode_value(v) for v in r] for r in rows]


def decode_rows(rows) -> list:
    return [[decode_value(v) for v in r] for r in rows]


class WriteAheadLog:
    """Appender over `<database>.wal`."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            with open(path, "wb") as f:
                f.write(MAGIC)
        self._f = open(path, "ab")

    def append(self, record: dict) -> None:
        payload = json.dumps(record, separators=(",", ":")).encode("utf-8")
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def size(self) -> int:
        self._f.flush()
        return os.path.getsize(self.path)

    def truncate(self) -> None:
        """Reset to an empty log (after a checkpoint)."""
        self._f.close()
        with open(self.path, "wb") as f:
            f.write(MAGIC)
            f.flush()
            os.fsync(f.fileno())
        self._f = open(self.path, "ab")

    def close(self) -> None:
        try:
            self.flush()
        except (OSError, ValueError):
            pass
        self._f.close()


def replay_records(path: str) -> Iterator[dict]:
    """Yield valid records; stop silently at a torn/corrupt tail
    (reference: wal_replay.cpp tolerates a truncated final entry)."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            return
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return
            length, crc = _HDR.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                return
            yield json.loads(payload.decode("utf-8"))


def apply_record(con, rec: dict) -> None:
    """Re-apply one logical WAL record to a connection's catalog."""
    from ..sql.binder import resolve_typename
    from ..types import DataType, TypeId
    from . import dml

    op = rec["op"]
    cat = con.catalog
    if op == "create_table":
        fields = [(c["name"],
                   DataType(TypeId[c["type"]], c["width"], c["scale"]))
                  for c in rec["columns"]]
        td = dml.empty_table(rec["name"], fields)
        if rec.get("constraints"):
            td.constraints = [(k, list(c))
                              for k, c in rec["constraints"]]
        if rec.get("foreign_keys"):
            td.foreign_keys = [(list(c), p_, list(pc))
                               for c, p_, pc in rec["foreign_keys"]]
        if rec.get("not_null"):
            td.not_null = set(rec["not_null"])
        if rec.get("enum_domains"):
            td.enum_domains = {k: (v[0], frozenset(v[1]))
                               for k, v in rec["enum_domains"].items()}
        if rec.get("bit_columns"):
            td.bit_columns = set(rec["bit_columns"])
        if rec.get("defaults"):
            td.defaults = dict(rec["defaults"])
        cat.add_table(td, or_replace=True)
        if rec.get("rows"):
            dml.insert_rows(cat.get_table(rec["name"]),
                            decode_rows(rec["rows"]))
    elif op == "create_type":
        cat.enums[rec["name"]] = list(rec["values"])
        cat.bump()
    elif op == "drop" and rec["kind"] == "type":
        key = rec["name"].lower()
        # mirror DROP TYPE CASCADE: dependent tables go too (api.py
        # logs one record for the whole cascade)
        for tname in [t.name for t in cat.tables.values()
                      if any(tn.lower() == key for (tn, _v) in
                             getattr(t, "enum_domains", {}).values())]:
            cat.drop_table(tname, if_exists=True)
        cat.enums.pop(key, None)
        cat.bump()
    elif op == "create_view":
        cat.add_view(rec["name"], rec["sql"], or_replace=True,
                     column_aliases=rec.get("aliases"))
    elif op == "create_sequence":
        cat.sequences[rec["name"]] = {
            "value": rec["start"] - rec["increment"],
            "start": rec["start"], "increment": rec["increment"]}
        cat.bump()
    elif op == "sequence_value":
        # records replay in append order, so the last logged value wins;
        # max() would be wrong for negative-increment sequences
        seq = cat.sequences.get(rec["name"])
        if seq is not None:
            seq["value"] = int(rec["value"])
    elif op == "create_schema":
        cat.schemas.add(rec["name"])
        cat.bump()
    elif op == "create_macro":
        cat.macros[rec["name"]] = dict(rec["macro"])
        cat.bump()
    elif op == "create_index":
        from .index import SortedIndex
        td = cat.get_table(rec["table"])
        td.indexes[rec["name"]] = SortedIndex(
            rec["name"], list(rec["columns"]), rec["unique"])
        if rec["unique"]:
            td.constraints = list(getattr(td, "constraints", ())) \
                + [("unique", list(rec["columns"]))]
        cat.bump()
    elif op == "drop":
        if rec["kind"] == "view":
            cat.drop_view(rec["name"], if_exists=True)
        elif rec["kind"] == "macro":
            cat.macros.pop(rec["name"].lower(), None)
            cat.bump()
        elif rec["kind"] == "sequence":
            key = rec["name"].lower()
            for kind, name in cat.dependents_of("sequence", key):
                if kind == "table":
                    cat.drop_table(name, if_exists=True)
            cat.sequences.pop(key, None)
            cat.bump()
        elif rec["kind"] == "schema":
            key = rec["name"].lower()
            for t in [t for t in cat.tables if t.startswith(key + ".")]:
                cat.drop_table(t, if_exists=True)
            cat.schemas.discard(key)
            cat.bump()
        elif rec["kind"] == "index":
            key = rec["name"].lower()
            for t in cat.tables.values():
                ix = getattr(t, "indexes", {}).pop(key, None)
                if ix is not None and ix.unique:
                    t.constraints = [
                        (k, cs) for (k, cs)
                        in getattr(t, "constraints", ())
                        if not (k == "unique" and cs == list(ix.columns))]
            cat.bump()
        else:
            cat.drop_table(rec["name"], if_exists=True)
    elif op == "insert":
        dml.insert_rows(cat.get_table(rec["table"]),
                        decode_rows(rec["rows"]), rec.get("columns"))
    elif op == "delete":
        import numpy as np
        td = cat.get_table(rec["table"])
        mask = np.zeros(td.num_rows, dtype=bool)
        mask[np.asarray(rec["idx"], dtype=np.int64)] = True
        dml.delete_rows(td, mask)
    elif op == "update":
        td = cat.get_table(rec["table"])
        apply_rows_at(td, rec["idx"], decode_rows(rec["rows"]),
                      rec["cols"])
    elif op == "alter":
        from ..sql import ast as A
        stmt = A.AlterStmt(table=rec["table"], action=rec["action"],
                           name=rec.get("name"),
                           new_name=rec.get("new_name"),
                           coltype=tuple(rec["coltype"])
                           if rec.get("coltype") else None,
                           if_exists=True)
        con._execute_alter(stmt)
    else:
        raise ValueError(f"unknown WAL record op {op!r}")
    cat.bump()


def apply_rows_at(td, idx, rows, cols: Optional[List[str]] = None) -> None:
    """Set python-value `rows` at row positions `idx` for columns `cols`
    (UPDATE replay)."""
    import numpy as np

    from .dml import _encode_values

    idx = np.asarray(idx, dtype=np.int64)
    names = cols if cols is not None else [c.name for c in td.columns]
    mask = np.zeros(td.num_rows, dtype=bool)
    mask[idx] = True
    for j, cname in enumerate(names):
        col = next(c for c in td.columns if c.name == cname)
        vals = [r[j] for r in rows]
        data, nulls, dictinfo = _encode_values(col, vals)
        if dictinfo is not None:
            md, translate = dictinfo
            base = col.data if translate is None else \
                translate[col.data].astype(np.int32)
            new = base.copy()
            new[idx] = data
            col.strdict = md
            col.data = new
        else:
            new = col.data.copy()
            new[idx] = data
            col.data = new
        if nulls.any() or col.nulls is not None:
            old_n = col.nulls.copy() if col.nulls is not None else \
                np.zeros(len(col.data), dtype=bool)
            old_n[idx] = nulls
            col.nulls = old_n if old_n.any() else None
        col.compute_stats()
    td.invalidate_cache()

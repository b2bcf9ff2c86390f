"""Change-data-capture, hybrid logical clock, snapshots (fork parity).

The reference fork ("AnyBase") adds CDC emission on commit, an HLC
timestamp manager, and snapshot ids on top of stock DuckDB
(reference: src/transaction/cdc_write_state.cpp:21-100 EmitChange,
src/transaction/timestamp_manager.cpp, src/main/connection.cpp:190-205
CreateSnapshot, C API anybase-c.cpp).  This module provides the native
equivalents: a callback-based change stream with HLC stamps and
copy-on-write snapshots; an external redo stream (the fork's Kafka WAL)
can subscribe to the same callback.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class TimestampManager:
    """Hybrid logical clock: (physical_ms << 16) | logical."""

    def __init__(self):
        self._lock = threading.Lock()
        self._last = 0

    def get_hlc_timestamp(self) -> int:
        with self._lock:
            phys = int(time.time() * 1000) << 16
            self._last = max(self._last + 1, phys)
            return self._last

    def set_hlc_timestamp(self, ts: int) -> None:
        """Advance the clock past an externally observed timestamp."""
        with self._lock:
            self._last = max(self._last, int(ts))


@dataclass
class ChangeEvent:
    """One row-level change (reference emits insert/update/delete row
    images with per-table/column versions, cdc_write_state.cpp:47-52)."""
    table: str
    op: str                     # insert | delete | update
    hlc: int
    rows: List[tuple]           # new rows (insert), old rows (delete)
    old_rows: Optional[List[tuple]] = None   # update: before images


class ChangeDataCapture:
    def __init__(self, clock: TimestampManager):
        self.clock = clock
        self._callbacks: List[Callable[[ChangeEvent], None]] = []

    def register(self, cb: Callable[[ChangeEvent], None]) -> None:
        self._callbacks.append(cb)

    def unregister(self, cb) -> None:
        self._callbacks.remove(cb)

    @property
    def enabled(self) -> bool:
        return bool(self._callbacks)

    def emit(self, table: str, op: str, rows, old_rows=None,
             hlc: Optional[int] = None) -> None:
        if not self._callbacks:
            return
        ev = ChangeEvent(table, op,
                         self.clock.get_hlc_timestamp()
                         if hlc is None else hlc, rows, old_rows)
        for cb in self._callbacks:
            cb(ev)


class SnapshotManager:
    """Named snapshots of the catalog's table set (copy-on-write makes a
    snapshot a shallow clone; reference: Connection::CreateSnapshot)."""

    def __init__(self):
        self._snapshots: Dict[int, dict] = {}
        self._next = 1

    def create(self, catalog) -> int:
        from .storage.dml import clone_table
        sid = self._next
        self._next += 1
        self._snapshots[sid] = {
            name: clone_table(td) for name, td in catalog.tables.items()}
        return sid

    def get(self, sid: int) -> dict:
        return self._snapshots[sid]

    def remove(self, sid: int) -> None:
        self._snapshots.pop(sid, None)

    def ids(self):
        return list(self._snapshots)

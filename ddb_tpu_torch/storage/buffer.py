"""Device-memory buffer manager: LRU eviction of cached table batches.

TPU-native analog of the reference's buffer manager
(reference: src/storage/buffer_manager.cpp / standard_buffer_manager.cpp —
pins blocks in a bounded pool, evicts LRU unpinned blocks).  Here the unit
of caching is a table's whole-column device batch (TableData._device_batch);
tables re-materialize transparently from host numpy columns on next use,
so eviction is always safe (the host copy is the backing store, like the
reference's block files).
"""

from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Optional


def parse_memory_limit(text) -> Optional[int]:
    """'1GB' / '512MB' / '80%' / int -> bytes (None = unlimited).

    Percentages resolve against total system memory like the reference
    (src/main/settings: memory_limit accepts e.g. '80%'); unparseable
    values raise instead of silently disabling the cap."""
    if text is None:
        return None
    if isinstance(text, (int, float)):
        return int(text)
    s = str(text).strip().lower()
    if s in ("", "none", "unlimited", "-1"):
        return None
    m = re.match(r"^([\d.]+)\s*%$", s)
    if m:
        pct = float(m.group(1))
        if not 0 < pct <= 100:
            raise ValueError(
                f"memory_limit percentage out of range: '{text}'")
        import os
        try:
            total = (os.sysconf("SC_PAGE_SIZE")
                     * os.sysconf("SC_PHYS_PAGES"))
        except (ValueError, OSError, AttributeError):
            total = 16 * 1024**3
        return int(total * pct / 100.0)
    m = re.match(r"^([\d.]+)\s*(b|kb|kib|mb|mib|gb|gib|tb|tib)?$", s)
    if not m:
        raise ValueError(f"could not parse memory_limit value: '{text}'")
    v = float(m.group(1))
    unit = m.group(2) or "b"
    mult = {"b": 1, "kb": 1000, "kib": 1024, "mb": 1000**2,
            "mib": 1024**2, "gb": 1000**3, "gib": 1024**3,
            "tb": 1000**4, "tib": 1024**4}[unit]
    return int(v * mult)


class BufferManager:
    """Tracks live device batches; evicts least-recently-used table
    caches when the configured budget is exceeded."""

    def __init__(self, limit_bytes: Optional[int] = None):
        self.limit_bytes = limit_bytes
        self._entries: "OrderedDict[int, tuple]" = OrderedDict()
        self.total_bytes = 0
        self.evictions = 0
        # threaded readers touch device_batch concurrently (concurrentloop
        # analog); guard the LRU map + byte accounting.  RLock: eviction
        # calls td.invalidate_cache() which re-enters via drop().
        self._lock = threading.RLock()

    def set_limit(self, limit_bytes: Optional[int]):
        with self._lock:
            self.limit_bytes = limit_bytes
            self._evict_to_fit(pinned=None)

    def note_use(self, td, nbytes: int):
        """Record that `td`'s device batch (nbytes) is live and was just
        used; evict others to fit the budget."""
        key = id(td)
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self.total_bytes -= old
            self._entries[key] = (td, nbytes)
            self.total_bytes += nbytes
            self._evict_to_fit(pinned=key)

    def drop(self, td):
        key = id(td)
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self.total_bytes -= old

    def _evict_to_fit(self, pinned):
        if self.limit_bytes is None:
            return
        while self.total_bytes > self.limit_bytes and self._entries:
            key = next(iter(self._entries))
            if key == pinned and len(self._entries) == 1:
                break   # never evict the batch being used right now
            if key == pinned:
                # move pinned to the end and retry with the next-oldest
                self._entries.move_to_end(key)
                key = next(iter(self._entries))
            td, nbytes = self._entries.pop(key)
            self.total_bytes -= nbytes
            self.evictions += 1
            td.invalidate_cache()

    def stats(self):
        return {"cached_tables": len(self._entries),
                "cached_bytes": self.total_bytes,
                "limit_bytes": self.limit_bytes,
                "evictions": self.evictions}


MANAGER = BufferManager()

"""Temporary-memory arbitration + spill files for blocking operators.

TPU-native analog of the reference's TemporaryMemoryManager
(reference: src/storage/temporary_memory_manager.hpp:70 — blocking
operators request a reservation against a shared budget and degrade to
out-of-core execution when the grant is smaller than their data) and
TemporaryFileManager (src/storage/temporary_file_manager.cpp — spilled
blocks live in a temp directory and are deleted on unpin).

Here the "memory" being arbitrated is the working-set budget derived
from the `memory_limit` setting; spill payloads are numpy column
partitions written with np.save under a session temp directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np


class TemporaryMemoryManager:
    """Grants working-set reservations out of a shared budget.

    Like the reference, a single operator is never granted more than
    MAXIMUM_FREE_MEMORY_RATIO of the remaining budget, which is what
    pushes oversized operators into their external modes."""

    MAXIMUM_FREE_MEMORY_RATIO = 0.85

    def __init__(self, budget_bytes: Optional[int] = None):
        self.budget_bytes = budget_bytes
        self._reserved = 0
        self._lock = threading.Lock()

    def set_budget(self, budget_bytes: Optional[int]):
        with self._lock:
            self.budget_bytes = budget_bytes

    def reserve(self, requested: int) -> int:
        """Returns the granted bytes (<= requested).  With no budget
        configured the full request is granted."""
        with self._lock:
            if self.budget_bytes is None:
                return requested
            free = max(self.budget_bytes - self._reserved, 0)
            grant = min(requested,
                        int(free * self.MAXIMUM_FREE_MEMORY_RATIO))
            self._reserved += grant
            return grant

    def release(self, granted: int):
        with self._lock:
            self._reserved = max(self._reserved - granted, 0)

    def stats(self):
        with self._lock:
            return {"budget_bytes": self.budget_bytes,
                    "reserved_bytes": self._reserved}


class TemporaryFileManager:
    """Spill-file store: named groups of numpy arrays in a temp dir."""

    def __init__(self, base_dir: Optional[str] = None):
        self._base = base_dir
        self._dir: Optional[str] = None
        self._lock = threading.Lock()
        self._seq = 0
        self.bytes_spilled = 0
        self.files_written = 0

    def _ensure_dir(self) -> str:
        with self._lock:
            if self._dir is None:
                self._dir = tempfile.mkdtemp(
                    prefix="ddb_tpu_spill_", dir=self._base)
            return self._dir

    def write(self, arrays: List[Optional[np.ndarray]]) -> str:
        """Spill a list of arrays (None entries allowed); returns a
        token for read()/delete()."""
        d = self._ensure_dir()
        with self._lock:
            self._seq += 1
            token = os.path.join(d, f"part{self._seq:06d}.npz")
        kw = {f"a{i}": a for i, a in enumerate(arrays) if a is not None}
        kw["__mask__"] = np.array(
            [a is not None for a in arrays], dtype=bool)
        np.savez(token, **kw)
        sz = os.path.getsize(token)
        with self._lock:
            self.bytes_spilled += sz
            self.files_written += 1
        return token

    def read(self, token: str) -> List[Optional[np.ndarray]]:
        with np.load(token, allow_pickle=False) as z:
            mask = z["__mask__"]
            return [z[f"a{i}"] if mask[i] else None
                    for i in range(len(mask))]

    def delete(self, token: str):
        try:
            os.unlink(token)
        except OSError:
            pass

    def cleanup(self):
        with self._lock:
            d, self._dir = self._dir, None
        if d is not None:
            shutil.rmtree(d, ignore_errors=True)

    def stats(self):
        with self._lock:
            return {"bytes_spilled": self.bytes_spilled,
                    "files_written": self.files_written}


MEMORY = TemporaryMemoryManager()
FILES = TemporaryFileManager()

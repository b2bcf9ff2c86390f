"""Point-lookup index: sorted composite keys + binary search.

The TPU-native analog of the reference's ART index (reference:
src/execution/index/art/art.cpp — adaptive radix tree serving PK/UNIQUE
enforcement and selective point/range scans).  On this architecture the
hot data lives as dense host numpy columns mirrored to device; the right
index for that layout is a SORTED permutation of the key columns:

  - build: one lexsort of the key columns, O(n log n), vectorized
  - probe: np.searchsorted on the host (O(log n) per probe, vectorized
    over probe batches), then a tiny row-id gather feeds the device —
    a point query touches O(log n) host work + one small batch upload
    instead of a full-column device pass
  - appends merge incrementally: the new block is sorted and merged in
    O(n + k) without re-sorting the base (the LSM-ish analog of ART's
    incremental inserts)

NULL handling matches SQL index semantics: NULL keys are excluded from
the index (they never match equality probes and never conflict for
UNIQUE).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _composite(arrays: List[np.ndarray]) -> np.ndarray:
    """One sortable array from key columns: plain array for one column,
    structured (field-lexicographic) array for several."""
    if len(arrays) == 1:
        return arrays[0]
    dt = np.dtype([(f"k{i}", a.dtype) for i, a in enumerate(arrays)])
    out = np.empty(len(arrays[0]), dtype=dt)
    for i, a in enumerate(arrays):
        out[f"k{i}"] = a
    return out


class SortedIndex:
    """Sorted-key index over one or more columns of a TableData."""

    def __init__(self, name: str, columns: Sequence[str],
                 unique: bool = False):
        self.name = name
        self.columns = list(columns)
        self.unique = unique
        # built state
        self._keys: Optional[np.ndarray] = None   # sorted composite
        self._perm: Optional[np.ndarray] = None   # row ids, sorted order
        self._version: Optional[int] = None       # td.version at build
        self._nrows = 0
        self._dict_sizes: Optional[tuple] = None

    # -------------------------------------------------------------- #

    def _key_cols(self, td):
        byname = {c.name: c for c in td.columns}
        return [byname[n] for n in self.columns]

    def _live_rows(self, cols, lo: int, hi: int) -> np.ndarray:
        live = np.ones(hi - lo, dtype=bool)
        for c in cols:
            if c.nulls is not None:
                live &= ~c.nulls[lo:hi]
        return np.nonzero(live)[0] + lo

    def refresh(self, td) -> None:
        """Bring the index up to date with td (lazy, version-stamped).
        Pure appends merge incrementally; anything else rebuilds."""
        version = getattr(td, "version", 0)
        if self._version == version:
            return
        cols = self._key_cols(td)
        dict_sizes = tuple(len(c.strdict) if c.strdict is not None
                           else -1 for c in cols)
        n = td.num_rows
        incremental = (
            self._keys is not None
            and getattr(td, "last_op", None) == "insert"
            and self._version == version - 1
            and self._nrows <= n
            and self._dict_sizes == dict_sizes)   # same dict => same codes
        if incremental:
            idx = self._live_rows(cols, self._nrows, n)
            if len(idx):
                block = _composite([c.data[idx] for c in cols])
                order = np.argsort(block, kind="stable")
                block = block[order]
                bperm = idx[order]
                pos = np.searchsorted(self._keys, block, side="right")
                self._keys = np.insert(self._keys, pos, block)
                self._perm = np.insert(self._perm, pos, bperm)
        else:
            idx = self._live_rows(cols, 0, n)
            comp = _composite([c.data[idx] for c in cols])
            order = np.argsort(comp, kind="stable")
            self._keys = comp[order]
            self._perm = idx[order]
        self._version = version
        self._nrows = n
        self._dict_sizes = dict_sizes

    # -------------------------------------------------------------- #

    def lookup_eq(self, td, values: Sequence) -> np.ndarray:
        """Row ids whose key equals `values` (encoded physical values)."""
        self.refresh(td)
        if len(self._keys) == 0:
            return np.zeros(0, dtype=np.int64)
        if self._keys.dtype.fields:
            probe = np.zeros(1, dtype=self._keys.dtype)
            for f, v in zip(self._keys.dtype.names, values):
                probe[f] = v
            key = probe[0]
        else:
            key = np.asarray(values[0], dtype=self._keys.dtype)
        lo = int(np.searchsorted(self._keys, key, side="left"))
        hi = int(np.searchsorted(self._keys, key, side="right"))
        return self._perm[lo:hi]

    def lookup_range(self, td, lo_val, hi_val, lo_strict=False,
                     hi_strict=False) -> np.ndarray:
        """Row ids with lo_val <= key <= hi_val (single-column index)."""
        self.refresh(td)
        if len(self._keys) == 0:
            return np.zeros(0, dtype=np.int64)
        lo = 0 if lo_val is None else int(np.searchsorted(
            self._keys, lo_val, side="right" if lo_strict else "left"))
        hi = len(self._keys) if hi_val is None else int(np.searchsorted(
            self._keys, hi_val, side="left" if hi_strict else "right"))
        return self._perm[lo:hi]

    def probe_exists(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized membership: for each probe key (composite-encoded),
        does the index contain it?  (index must be refreshed)"""
        lo = np.searchsorted(self._keys, keys, side="left")
        hi = np.searchsorted(self._keys, keys, side="right")
        return hi > lo

    def has_internal_duplicates(self) -> bool:
        k = self._keys
        if k is None or len(k) < 2:
            return False
        return bool((k[1:] == k[:-1]).any())

    def size(self) -> int:
        return 0 if self._keys is None else len(self._keys)

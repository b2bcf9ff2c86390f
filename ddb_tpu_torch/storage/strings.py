"""Host-side sorted string dictionaries.

TPU has no pointers/var-len data, so every VARCHAR column is
dictionary-encoded at ingest: the device sees int32 codes, the dictionary (a
sorted numpy array of unique strings) stays on host.  Because the dictionary
is SORTED, code order == string order, which makes ORDER BY, range predicates
and equality against literals pure int operations on device.

This replaces the reference's string_t/FSST/dictionary machinery
(reference: src/include/duckdb/common/types/string_type.hpp,
src/storage/compression/dictionary/ and fsst.cpp) with a TPU-friendly design.
"""

from __future__ import annotations

import fnmatch
import re

import numpy as np


class StringDictionary:
    """Immutable sorted dictionary of unique strings for one column."""

    __slots__ = ("values", "_lookup", "runtime")

    def __init__(self, values: np.ndarray):
        # values must be sorted unique unicode/object array
        self.values = values
        self._lookup = None
        # True for stores filled during execution (aggregate/window
        # outputs): bind-time per-code tables would be empty, so
        # dependent DictLookups go lazy (binder._bind_string_func)
        self.runtime = False

    # ---- construction ----------------------------------------------------
    @staticmethod
    def encode(strings) -> tuple["StringDictionary", np.ndarray, np.ndarray]:
        """Encode an iterable of (str|None) -> (dict, codes int32, nulls bool)."""
        arr = np.asarray(strings, dtype=object)
        nulls = np.array([s is None for s in arr], dtype=bool)
        safe = np.where(nulls, "", arr).astype(str)
        uniq, codes = np.unique(safe, return_inverse=True)
        return StringDictionary(uniq), codes.astype(np.int32), nulls

    # ---- lookups ---------------------------------------------------------
    def __len__(self):
        return len(self.values)

    def decode_one(self, code: int) -> str:
        return str(self.values[code])

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return self.values[codes]

    def code_of(self, s: str) -> int:
        """Exact code of s, or -1 if absent."""
        i = int(np.searchsorted(self.values, s))
        if i < len(self.values) and self.values[i] == s:
            return i
        return -1

    def lower_bound(self, s: str) -> int:
        """Smallest code whose string >= s (for range predicates on codes)."""
        return int(np.searchsorted(self.values, s, side="left"))

    def upper_bound(self, s: str) -> int:
        return int(np.searchsorted(self.values, s, side="right"))

    # ---- predicate tables (device-gatherable) ----------------------------
    def match_like(self, pattern: str) -> np.ndarray:
        """bool table[n_codes]: does each dict entry match a SQL LIKE pattern."""
        rx = re.compile(_like_to_regex(pattern), re.S)
        return np.array([rx.fullmatch(str(v)) is not None
                         for v in self.values], dtype=bool)

    def match_fn(self, fn) -> np.ndarray:
        return np.array([bool(fn(str(v))) for v in self.values], dtype=bool)

    # ---- cross-dictionary translation (for joins/comparisons) ------------
    def translate_to(self, other: "StringDictionary") -> np.ndarray:
        """int32 table mapping my codes -> other's codes (-1 if missing)."""
        idx = np.searchsorted(other.values, self.values)
        idx = np.clip(idx, 0, max(len(other.values) - 1, 0))
        if len(other.values) == 0:
            return np.full(len(self.values), -1, dtype=np.int32)
        ok = other.values[idx] == self.values
        return np.where(ok, idx, -1).astype(np.int32)

    @staticmethod
    def merge(a: "StringDictionary", b: "StringDictionary"):
        """Merged dict + translation tables for each input."""
        merged = np.unique(np.concatenate([a.values, b.values]))
        md = StringDictionary(merged)
        return md, a.translate_to(md), b.translate_to(md)


def _like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        elif c == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 1
        else:
            out.append(re.escape(c))
        i += 1
    return "".join(out)

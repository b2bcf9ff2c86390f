"""Host-side stores for STRUCT / MAP / BLOB payloads.

TPU design note: like LIST (storage/lists.py) and VARCHAR dictionaries,
nested values have no device representation — rows carry an int32 store
id, payloads stay host-side and materialize on demand (reference: STRUCT
vectors hold child vectors, MAP is LIST(STRUCT(k,v)) —
src/common/types/vector.cpp; on TPU the children live on host and
struct_extract compiles to a per-id gather table instead)."""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np


class StructValue(dict):
    """STRUCT row decoded to a dict that remembers it is a struct —
    renderers print {'key': value} for structs vs {k=v} for MAPs
    (reference: StructVector vs MapVector ToString)."""


class StructStore:
    """Append-only store of struct rows; id = index.

    names: field names, in declaration order.
    items: one tuple of python field values per id."""

    def __init__(self, names: Sequence[str], items: Sequence[tuple] = ()):
        self.names: List[str] = [str(n) for n in names]
        self.items: List[tuple] = [tuple(x) for x in items]

    def add(self, vals: tuple) -> int:
        self.items.append(tuple(vals))
        return len(self.items) - 1

    def decode_one(self, i: int):
        return StructValue(zip(self.names, self.items[i]))

    def field_values(self, k: int) -> list:
        """All values of field #k, indexed by store id (the payload side
        of a struct_extract gather table)."""
        return [it[k] for it in self.items]

    def __len__(self) -> int:
        return len(self.items)


class MapStore:
    """Append-only store of maps; id = index.
    items: one list of (key, value) pairs per id (insertion order kept,
    matching duckdb MAP = LIST(STRUCT(k, v)) semantics)."""

    def __init__(self, items: Sequence[Sequence[Tuple[Any, Any]]] = ()):
        self.items: List[list] = [list(x) for x in items]

    def add(self, pairs) -> int:
        self.items.append(list(pairs))
        return len(self.items) - 1

    def decode_one(self, i: int):
        return dict(self.items[i])

    def keys_of(self, i: int) -> list:
        return [k for k, _ in self.items[i]]

    def values_of(self, i: int) -> list:
        return [v for _, v in self.items[i]]

    def lengths(self) -> np.ndarray:
        return np.array([len(x) for x in self.items], dtype=np.int64)

    def __len__(self) -> int:
        return len(self.items)


class UnionStore:
    """Tagged-union payloads: (member_index, python value) per id
    (reference: union vectors hold a tag + per-member child vectors,
    src/common/types/union_type.cpp — here host-side like the other
    nested stores)."""

    def __init__(self, tags: Sequence[str], items: Sequence[tuple] = ()):
        self.tags = list(tags)
        self.items: list = list(items)    # [(tag_idx, value)]

    def add(self, tag_idx: int, value) -> int:
        self.items.append((int(tag_idx), value))
        return len(self.items) - 1

    def decode_one(self, i: int):
        return self.items[i][1]

    def tag_of(self, i: int) -> str:
        return self.tags[self.items[i][0]]

    def member_values(self, k: int) -> list:
        """Value when the tag matches member k, else None."""
        return [v if ti == k else None for ti, v in self.items]

    def __len__(self) -> int:
        return len(self.items)


class BlobStore:
    """Dictionary of byte strings (BLOB payloads); id = index."""

    def __init__(self, items: Sequence[bytes] = ()):
        self.items: List[bytes] = [bytes(x) for x in items]

    def add(self, b: bytes) -> int:
        self.items.append(bytes(b))
        return len(self.items) - 1

    def decode_one(self, i: int) -> bytes:
        return self.items[i]

    def __len__(self) -> int:
        return len(self.items)

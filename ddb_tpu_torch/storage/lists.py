"""Host-side list store: the payload side of the LIST type.

TPU design note: variable-length payloads have no device representation —
rows carry an int32 list id; the element payloads stay host-side, exactly
like VARCHAR dictionaries (reference: LIST vectors hold offset/length into
a child vector, src/common/types/vector.cpp list handling; on TPU the
child vector lives on host and materializes on demand, e.g. at UNNEST)."""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np


class ListStore:
    """Append-only store of python-value lists; id = index."""

    def __init__(self, items: Sequence[list] = ()):
        self.items: List[list] = [list(x) for x in items]

    def add(self, lst) -> int:
        self.items.append(list(lst))
        return len(self.items) - 1

    def replace_all(self, items) -> None:
        self.items = [list(x) for x in items]

    def decode_one(self, i: int):
        return list(self.items[i])

    def __len__(self) -> int:
        return len(self.items)

    def lengths(self) -> np.ndarray:
        return np.array([len(x) for x in self.items], dtype=np.int64)

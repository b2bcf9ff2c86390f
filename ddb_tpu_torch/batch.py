"""Columnar batch: the unit of data flowing between operators.

PyTorch port of ddb_tpu/batch.py.  The layout is the same:

* Fixed capacity (a power of two, see `bucket_capacity`) per batch; a
  boolean row mask `sel` plus a `count` scalar say which rows are live.
* NULLs are per-column boolean masks (True => NULL), None when a column
  has no NULLs.
* Schema (names/types/string dictionaries) is host-side metadata; the
  batch holds only dense tensors, all on one device.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, replace
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .types import DataType

# Capacity bucketing: round row counts up to a power of two.
_MIN_CAP = 128

_TORCH_OF_NP = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


# The device of the statement being bound.  The binder (a copy of the
# reference's, which knows no device) executes sub-plans and scans working
# tables while it binds; those calls name no device and run on the one
# that `bind_device` set.  Nothing is bound by default: a device-less call
# outside `bind_device` raises rather than pick a device silently.  A
# context variable, so that connections binding on two threads do not
# read each other's device.
_BIND_DEVICE = contextvars.ContextVar("ddb_tpu_torch_bind_device")


def current_bind_device() -> torch.device:
    try:
        return _BIND_DEVICE.get()
    except LookupError:
        raise RuntimeError(
            "no device: pass device=, or call inside "
            "batch.bind_device(...)") from None


@contextlib.contextmanager
def bind_device(device):
    """Make `device` the one that device-less calls from the binder use."""
    token = _BIND_DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _BIND_DEVICE.reset(token)


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype holding a physical numpy dtype."""
    return _TORCH_OF_NP[np.dtype(np_dtype)]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host (one host synchronisation when it
    lies on the card)."""
    return t.cpu().numpy()


def to_pinned_numpy(t: torch.Tensor) -> np.ndarray:
    """`to_numpy` for host arrays that stay, such as a materialised
    table's columns.  From the card the values land in page-locked
    memory from torch's caching host allocator: the copy is one DMA into
    pages mapped once for the process, not a staged copy that faults in
    fresh pageable pages every time, and the array's next upload is one
    DMA too.  The array holds its tensor, so the block returns to the
    allocator's cache when the array is freed; the cache keeps it
    page-locked and gives nothing back to the system, so the process's
    pinned bytes are the most its materialised tables held at once,
    rounded up to powers of two, with no bound of their own."""
    if t.device.type != "cuda":
        return to_numpy(t)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def bucket_capacity(n: int) -> int:
    """Round n up to a power of two (>=_MIN_CAP)."""
    c = _MIN_CAP
    while c < n:
        c <<= 1
    return c


class Column(NamedTuple):
    data: torch.Tensor              # [cap] physical values (lo limb if wide)
    nulls: Optional[torch.Tensor]   # [cap] bool, True => NULL; None => none
    # optional high limb for wide (i128-style) values: value = hi*2^32 +
    # (data & 0xffffffff); produced by wide SUM accumulation
    # (ops/aggregate.py), None everywhere else
    hi: Optional[torch.Tensor] = None


class Batch(NamedTuple):
    """Tuple of columns + row mask + live-row count."""
    columns: tuple                 # tuple[Column, ...]
    sel: torch.Tensor              # [cap] bool, True => row is live
    count: torch.Tensor            # scalar int32, number of live rows

    @property
    def capacity(self) -> int:
        return int(self.sel.shape[0])

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def column(self, i: int) -> Column:
        return self.columns[i]

    def with_columns(self, columns) -> "Batch":
        return Batch(tuple(columns), self.sel, self.count)


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    strdict: Any = None   # StringDictionary for VARCHAR columns


@dataclass(frozen=True)
class Schema:
    fields: tuple

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    @property
    def names(self):
        return [f.name for f in self.fields]

    @property
    def types(self):
        return [f.dtype for f in self.fields]

    def __len__(self):
        return len(self.fields)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        # SQL identifiers are case-insensitive
        low = name.lower()
        for i, f in enumerate(self.fields):
            if f.name.lower() == low:
                return i
        raise KeyError(name)

    def field(self, i: int) -> Field:
        return self.fields[i]

    def rename(self, names) -> "Schema":
        return Schema(tuple(replace(f, name=n)
                            for f, n in zip(self.fields, names)))


def make_batch(arrays: Sequence[np.ndarray],
               nulls: Sequence[Optional[np.ndarray]] = None,
               count: Optional[int] = None,
               capacity: Optional[int] = None, *,
               device) -> Batch:
    """Build a Batch on `device` from host arrays, padding to capacity."""
    n = len(arrays[0]) if count is None else count
    cap = bucket_capacity(n) if capacity is None else capacity
    cols = []
    for i, a in enumerate(arrays):
        a = np.ascontiguousarray(a)
        d = torch.zeros(cap, dtype=torch_dtype(a.dtype), device=device)
        d[:len(a)] = torch.from_numpy(a).to(device)
        nm = None
        if nulls is not None and nulls[i] is not None:
            m = np.asarray(nulls[i], dtype=bool)
            if m.any():
                nm = torch.zeros(cap, dtype=torch.bool, device=device)
                nm[:len(m)] = torch.from_numpy(m).to(device)
        cols.append(Column(d, nm))
    sel = torch.arange(cap, device=device) < n
    return Batch(tuple(cols), sel,
                 torch.tensor(n, dtype=torch.int32, device=device))


def batch_to_host(batch: Batch, schema: Schema):
    """Materialize live rows to host as a list of numpy arrays + null masks.

    Invalid (masked-out) rows are dropped; row order is preserved."""
    sel = to_numpy(batch.sel)
    out_data, out_nulls = [], []
    for col in batch.columns:
        d = to_numpy(col.data)[sel]
        if col.hi is not None:
            # `data` is the composed (possibly wrapped) int64; exact value
            # = hi * 2^32 + low 32 bits.  Reconstruct as Python ints.
            h = to_numpy(col.hi)[sel].astype(object)
            d = h * (1 << 32) + (d & np.int64(0xFFFFFFFF)).astype(object)
        m = to_numpy(col.nulls)[sel] if col.nulls is not None else None
        out_data.append(d)
        out_nulls.append(m)
    return out_data, out_nulls


def host_compact_indices(batch: Batch):
    """Host helper: indices of live rows, in order."""
    return np.nonzero(to_numpy(batch.sel))[0]

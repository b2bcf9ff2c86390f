"""64-bit hashing for partitioning/shuffles (PyTorch port of
ddb_tpu/ops/hashing.py).

SplitMix64 finalizer.  torch has no uint64 arithmetic on every device,
so a hash is an int64 tensor holding the uint64's bit pattern: int64
multiply and add wrap as uint64's do, and the logical right shift is an
arithmetic one with the sign's copies masked off.
"""

from __future__ import annotations

import torch


def _signed(c: int) -> int:
    """The int64 with the bit pattern of the uint64 constant c."""
    return c - (1 << 64) if c >= 1 << 63 else c


_C0 = _signed(0x9E3779B97F4A7C15)
_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)


def lshr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def hash64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 over int values (any int dtype); int64 bit patterns."""
    z = x.to(torch.int64) + _C0
    z = (z ^ lshr(z, 30)) * _C1
    z = (z ^ lshr(z, 27)) * _C2
    return z ^ lshr(z, 31)


def hash_combine(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Combine an existing hash with another column (boost-style mix)."""
    return hash64(h ^ (x.to(torch.int64) + _C0 + (h << 6) + lshr(h, 2)))


def partition_of(h: torch.Tensor, num_partitions: int) -> torch.Tensor:
    """Map hash -> partition id [0, num_partitions) using high bits."""
    return lshr(h, 33).to(torch.int32) % num_partitions

"""Order-preserving key encoding for sort/group kernels.

PyTorch port of ddb_tpu/ops/sortkey.py.  Every key column is encoded into
operands whose signed integer order equals the SQL order (including NULL
placement and ASC/DESC), so a lexicographic sort over the operands
realizes any ORDER BY.
"""

from __future__ import annotations

import torch

from ..types import DataType, TypeId


def encode_key(data, nulls, dtype: DataType, *, desc: bool = False,
               nulls_last: bool = True):
    """Returns list of operand tensors (most-significant first) whose
    lexicographic ascending order == requested SQL order."""
    ops = []
    # null placement operand: 0 sorts before 1
    if nulls is not None:
        ops.append(torch.where(nulls, 1 if nulls_last else 0,
                               0 if nulls_last else 1).to(torch.int32))
    v = _orderable(data, dtype)
    if desc:
        v = ~v     # bitwise-not reverses the order of signed ints
    if nulls is not None:
        # neutralize payload for null rows so they compare equal
        v = torch.where(nulls, torch.zeros_like(v), v)
    ops.append(v)
    return ops


def _orderable(data, dtype: DataType):
    """Map to a dtype where the natural (signed) order == value order."""
    if dtype.id in (TypeId.FLOAT, TypeId.DOUBLE):
        # IEEE trick for SIGNED comparisons: positive floats' bit patterns
        # already order correctly as signed ints; negative floats keep the
        # sign bit (staying below positives) but need their magnitude bits
        # flipped so more-negative sorts lower
        if data.dtype == torch.float32:
            bits = data.contiguous().view(torch.int32)
            return torch.where(bits < 0, bits ^ (2**31 - 1), bits)
        bits = data.to(torch.float64).contiguous().view(torch.int64)
        return torch.where(bits < 0, bits ^ (2**63 - 1), bits)
    if data.dtype == torch.bool:
        return data.to(torch.int32)
    return data  # signed ints/dates/decimals order naturally

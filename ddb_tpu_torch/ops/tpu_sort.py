"""Sample-merge sort: batched local runs + bitonic merge cascade.

The port of ddb_tpu/ops/tpu_sort.py, the same two phases over torch
tensors on any device (the reference's are XLA operations, not a
Pallas kernel, so plain torch is their counterpart):

  phase 1  reshape to (T, RUN) and sort each run lexicographically along
           dim 1 (stable torch.sort passes, last key first).
  phase 2  pairwise bitonic merge cascade: rows [A | flip(B)] are
           bitonic, so log2(len) stages of reshape + torch.where finish
           each merge level.  No gather, no scatter.

Correctness notes:
  * padding uses per-dtype maxima (+inf for floats) on the key operands,
    so pads sort last and slice off; payload pads are zeros.
  * stability: `is_stable=True` appends an int32 row id as the last key
    and drops it before returning; the network itself is not stable.

`bench/sort_probe.py` times `sort_ops` against `torch.sort` on the card.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

# run length for phase 1 (the reference's)
RUN = 512

# below this, one flat lexicographic sort replaces the two phases
MIN_TWO_PHASE = 1 << 15


def _maxval(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _lex_sort(operands: List[torch.Tensor], num_keys: int, dim: int):
    """The operands reordered along `dim` by their first `num_keys`
    operands, lexicographically (ties in input order)."""
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key.gather(dim, perm)
        order = torch.sort(k, dim=dim, stable=True).indices
        perm = order if perm is None else perm.gather(dim, order)
    return [v.gather(dim, perm) for v in operands]


def _lex_gt(a_keys, b_keys):
    """Lexicographic a > b over parallel key streams."""
    gt = None
    eq = None
    for a, b in zip(a_keys, b_keys):
        this_gt = a > b
        this_eq = a == b
        if gt is None:
            gt, eq = this_gt, this_eq
        else:
            gt = gt | (eq & this_gt)
            eq = eq & this_eq
    return gt


def _merge_stage(streams, num_keys, T, S, j):
    """One compare-exchange stage at distance j on (T, S) rows."""
    views = [v.reshape(T, S // (2 * j), 2, j) for v in streams]
    a = [v[:, :, 0, :] for v in views]
    b = [v[:, :, 1, :] for v in views]
    gt = _lex_gt(a[:num_keys], b[:num_keys])
    out = []
    for av, bv in zip(a, b):
        lo = torch.where(gt, bv, av)
        hi = torch.where(gt, av, bv)
        out.append(torch.stack([lo, hi], dim=2).reshape(T, S))
    return out


def _merge_rows(streams, num_keys, S):
    """Bitonic-merge each row (must be a bitonic sequence) to ascending."""
    T = streams[0].shape[0]
    j = S // 2
    while j >= 1:
        streams = _merge_stage(streams, num_keys, T, S, j)
        j //= 2
    return streams


def _cascade(streams, num_keys, S0, n_out):
    """(T, S0) sorted rows -> flat sorted tensors via pairwise merges."""
    T, S = streams[0].shape[0], S0
    while T > 1:
        if T % 2:
            streams = [
                torch.cat([v, torch.full((1, S), _maxval(v.dtype)
                                         if i < num_keys else 0,
                                         dtype=v.dtype, device=v.device)])
                for i, v in enumerate(streams)]
            T += 1
        nxt = []
        for v in streams:
            ev, od = v[0::2], v[1::2]
            nxt.append(torch.cat([ev, od.flip(1)], dim=1))
        S *= 2
        T //= 2
        streams = _merge_rows(nxt, num_keys, S)
    return [v.reshape(-1)[:n_out] for v in streams]


def sort_ops(operands: Sequence[torch.Tensor], num_keys: int = 1,
             is_stable: bool = False) -> List[torch.Tensor]:
    """The reference's `sort_ops`: 1-D operands of one length sorted
    lexicographically by the first `num_keys`, the rest carried along,
    by the two-phase batched sort above.

    Stability is emulated by appending a row id key (so ties keep input
    order); the extra operand is dropped before returning."""
    operands = list(operands)
    n = operands[0].shape[0]
    added_rid = False
    if is_stable:
        rid = torch.arange(n, dtype=torch.int32, device=operands[0].device)
        operands = operands[:num_keys] + [rid] + operands[num_keys:]
        num_keys += 1
        added_rid = True
    if n < MIN_TWO_PHASE:
        out = _lex_sort(operands, num_keys, 0)
    else:
        pad = (-n) % RUN
        if pad:
            operands = [
                torch.cat([v, torch.full((pad,), _maxval(v.dtype)
                                         if i < num_keys else 0,
                                         dtype=v.dtype, device=v.device)])
                for i, v in enumerate(operands)]
        T = (n + pad) // RUN
        runs = _lex_sort([v.reshape(T, RUN) for v in operands], num_keys, 1)
        out = _cascade(runs, num_keys, RUN, n)
    if added_rid:
        out = out[:num_keys - 1] + out[num_keys:]
    return out

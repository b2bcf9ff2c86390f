"""ORDER BY / LIMIT (PyTorch port of ddb_tpu/ops/order.py).

`torch.sort` takes one key, so a sort over several key operands is either
packed into one int64 (when the value spans fit in 63 bits) or run as
stable sorts chained from the last key to the first.  The executor's
ORDER BY, TopN, DISTINCT and sort-based GROUP BY all sort through
`sort_permutation` and then gather.
"""

from __future__ import annotations

import numpy as np
import torch


def sort_permutation(key_ops, sel):
    """Permutation putting live rows in key order first, dead rows last;
    ties keep row order.

    Adaptive key narrowing: when the value spans of all key operands +
    the row id fit in 63 bits, everything packs into ONE int64 and a
    single sort runs.  The spans come to the host in one transfer and
    the branch is taken in Python (the executor is eager)."""
    cap = sel.shape[0]
    rowid = torch.arange(cap, dtype=torch.int64, device=sel.device)
    invalid = (~sel).to(torch.int32)
    rid_bits = int(max(1, np.ceil(np.log2(max(cap, 2)))))

    ops64 = [op.to(torch.int64) for op in key_ops]
    if ops64:
        ext = torch.stack([torch.stack((v.min(), v.max()))
                           for v in ops64]).cpu().tolist()
    else:
        ext = []
    # Python ints: a span beyond int64 simply needs more than 63 bits
    bits = [(mx - mn).bit_length() for mn, mx in ext]
    if 1 + rid_bits + sum(bits) <= 63:
        acc = invalid.to(torch.int64)
        for v, (mn, _), b in zip(ops64, ext, bits):
            acc = (acc << b) | (v - mn)
        acc = (acc << rid_bits) | rowid
        return torch.sort(acc).values & ((1 << rid_bits) - 1)
    perm = rowid
    for k in reversed([invalid, *key_ops]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def limit_mask(sel, offset: int, limit: int):
    """Keep live rows with ordinal in [offset, offset+limit)."""
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    keep = (pos >= offset) & (pos < offset + limit)
    return sel & keep

"""ORDER BY / LIMIT (PyTorch port of ddb_tpu/ops/order.py).

`torch.sort` takes one key, so the key operands of a sort are packed into
as few int64 words as their value spans allow, and one stable sort runs
per word, from the last word to the first.  The executor's
ORDER BY, TopN, DISTINCT and sort-based GROUP BY all sort through
`sort_permutation` and then gather.
"""

from __future__ import annotations

import numpy as np
import torch


def sort_permutation(key_ops, sel):
    """Permutation putting live rows in key order first, dead rows last;
    ties keep row order.

    Adaptive key narrowing: neighbouring operands whose value spans fit
    together in 63 bits pack into one int64 word.  One word that also
    has room for the row id takes a single sort; otherwise one stable
    sort runs per word, from the last word to the first (a float64 key
    fills a word alone, so (small keys..., double) takes two sorts).
    The spans come to the host in one transfer and the branches are
    taken in Python (the executor is eager)."""
    cap = sel.shape[0]
    rowid = torch.arange(cap, dtype=torch.int64, device=sel.device)
    rid_bits = int(max(1, np.ceil(np.log2(max(cap, 2)))))

    ops64 = [op.to(torch.int64) for op in key_ops]
    if ops64:
        ext = torch.stack([torch.stack((v.min(), v.max()))
                           for v in ops64]).cpu().tolist()
    else:
        ext = []
    # (operand, its minimum, bits of its span); Python ints, so a span
    # beyond int64 simply needs more than 63 bits
    fields = [((~sel).to(torch.int64), 0, 1)] + [
        (v, mn, (mx - mn).bit_length()) for v, (mn, mx) in zip(ops64, ext)]
    words, used = [[]], 0
    for f in fields:
        if words[-1] and used + f[2] > 63:
            words.append([])
            used = 0
        words[-1].append(f)
        used += f[2]

    def pack(word):
        if len(word) == 1:
            return word[0][0]          # alone: any span, no offset needed
        acc = torch.zeros(cap, dtype=torch.int64, device=sel.device)
        for v, mn, b in word:
            acc = (acc << b) | (v - mn)
        return acc

    if len(words) == 1 and used + rid_bits <= 63 and len(words[0]) > 1:
        acc = (pack(words[0]) << rid_bits) | rowid
        return torch.sort(acc).values & ((1 << rid_bits) - 1)
    perm = torch.sort(pack(words[-1]), stable=True).indices
    for word in reversed(words[:-1]):
        perm = perm[torch.sort(pack(word)[perm], stable=True).indices]
    return perm


def limit_mask(sel, offset: int, limit: int):
    """Keep live rows with ordinal in [offset, offset+limit)."""
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    keep = (pos >= offset) & (pos < offset + limit)
    return sel & keep

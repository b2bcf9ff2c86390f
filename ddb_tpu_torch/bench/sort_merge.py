"""Sort merge: two merge phases for a sample sort, written as whole-array
reshapes and elementwise min/max.

    python -m ddb_tpu_torch.bench.sort_merge [--n 6291456] [--runs 7]
        [--case b512+merge,hand_full] [--device cuda]

PyTorch port of scripts/exp_sort_merge.py, over its keys: 40 random bits
from a numpy generator of seed 0 above the row number in the low 23, so
every key is unique.

  b512+merge  torch.sort of rows of 512 keys, then the script's cascade:
              rows merged in pairs (a row and its neighbour reversed make
              a bitonic sequence; `merge_rows` halves it log2(S) times by
              reshape, min and max), an odd row count padded with a row
              of the int64 maximum, until one row is left.  n must be a
              multiple of 512
  hand_full   the XOR bitonic network over all keys: padded with the
              int64 maximum to a power of two, blocks of k/2 sorted are
              merged into blocks of k for k = 2, 4, ..., the padding cut

Both are plain torch (the script's are XLA operations, not Pallas
kernels).  Each is held to np.sort at n and at the script's check size,
the first 32,768 keys, then timed as bench/sort_study.py times (CUDA
events, the median of `runs`).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops.sortkey import sentinel_last
from .sort_study import N, chip, device_of, parse, same, timed_ms

CHECK_N = 1 << 15       # the script's check size
S0 = 512                # the batched sort's rows
LOW_BITS = 23
CASES = ("b512+merge", "hand_full")


def inputs(n: int = N, seed: int = 0) -> np.ndarray:
    """The script's keys: (random 40 bits << 23) | row, int64."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 40, n).astype(np.int64) << LOW_BITS) \
        | np.arange(n, dtype=np.int64)


def merge_rows(v):
    """Rows of v [T, S], each a bitonic sequence, sorted ascending: S/2,
    S/4, ..., 1 apart, every pair to (min, max); reshapes only, no
    gather."""
    t, s = v.shape
    j = s // 2
    while j >= 1:
        w = v.reshape(t, s // (2 * j), 2, j)
        a, b = w[:, :, 0, :], w[:, :, 1, :]
        v = torch.stack([torch.minimum(a, b), torch.maximum(a, b)],
                        dim=2).reshape(t, s)
        j //= 2
    return v


def cascade(v, n_out: int):
    """Sorted rows [T, S] to one sorted vector of n_out keys by pairwise
    bitonic merges; an odd row count takes a row of the dtype's maximum,
    cut by the final slice."""
    t, s = v.shape
    while t > 1:
        if t % 2:
            v = torch.cat([v, torch.full((1, s), sentinel_last(v.dtype),
                                         dtype=v.dtype, device=v.device)])
            t += 1
        v = torch.cat([v[0::2], v[1::2].flip(1)], dim=1)
        s *= 2
        t //= 2
        v = merge_rows(v)
    return v.reshape(-1)[:n_out]


def b512_merge(x):
    if x.shape[0] % S0:
        raise ValueError(f"b512+merge sorts rows of {S0}: {x.shape[0]} keys "
                         f"are not whole rows")
    rows = torch.sort(x.view(-1, S0), dim=1).values
    return cascade(rows, x.shape[0])


def hand_full(x):
    n_in = x.shape[0]
    n = 1 << max(0, (n_in - 1).bit_length())
    if n != n_in:
        x = torch.cat([x, torch.full((n - n_in,), sentinel_last(x.dtype),
                                     dtype=x.dtype, device=x.device)])
    v = x
    k = 2
    while k <= n:
        # blocks of k/2 are sorted; [A | reverse(B)] is bitonic
        w = v.view(n // k, k)
        w = torch.cat([w[:, :k // 2], w[:, k // 2:].flip(1)], dim=1)
        v = merge_rows(w).reshape(n)
        k *= 2
    return v[:n_in]


FNS = {"b512+merge": b512_merge, "hand_full": hand_full}


def run(n: int = N, device="cuda", cases=None, runs: int = 7) -> dict:
    """Check (at n and at CHECK_N), then time each case (all, or those
    named); returns {"chip", "rows", "results"}."""
    device = device_of(device)
    k_h = inputs(n)
    k = torch.from_numpy(k_h).to(device)
    results = {}
    for name, fn in FNS.items():
        if cases is not None and name not in cases:
            continue
        same(name, fn(k).cpu().numpy(), np.sort(k_h))
        m = min(n, CHECK_N)
        same(f"{name} at {m}", fn(k[:m]).cpu().numpy(), np.sort(k_h[:m]))
        ms = timed_ms(lambda: fn(k), device, runs)
        results[name] = {"ms": ms, "rows_per_sec": n / (ms / 1e3)}
    return {"chip": chip(device), "rows": n, "results": results}


def main(argv=None) -> int:
    a, cases = parse(argv, CASES, __doc__)
    print(json.dumps(run(a.n, a.device, cases, a.runs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

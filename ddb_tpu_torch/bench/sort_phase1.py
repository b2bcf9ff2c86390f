"""Sort phase 1: one flat sort against batched sorts of short rows, and
int64 keys against int32 limb pairs, each with an int32 payload.

    python -m ddb_tpu_torch.bench.sort_phase1 [--n 6291456] [--runs 7]
        [--case flat,b2048] [--device cuda]

PyTorch port of scripts/exp_sort_phase1.py (is a batched sort fast
enough to be the local phase of a sample sort?), with its inputs: int64
keys in [0, 2^40) from a numpy generator of seed 0 and the row ids as
payload.

  flat       torch.sort of the keys, the payload gathered
  bS         the keys as rows of S (512, 2048, 16384, 65536; n // S rows,
             the keys past the last whole row left out), torch.sort(dim=1),
             the payload gathered
  flat_i32   the key as the script's (hi, lo) int32 limb pair, lo signed
             (`(k & 0xFFFFFFFF)` read as int32): two stable sorts, lo then
             hi, the payload gathered
  b2048_i32  the same along rows of 2048

Each case is first held to numpy, then timed as bench/sort_study.py times
(CUDA events, the median of `runs`).  The int64 cases give the stable
np.argsort of the keys; the limb cases np.lexsort((lo, hi)), which is
not the int64 order: a lo at or above 2^31 is negative as int32 and sorts
before the smaller ones of its hi.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .sort_study import (N, check_lexsort, check_rows_lexsort, chip,
                         device_of, parse, same, timed_ms)

ROWS = (512, 2048, 16384, 65536)
CASES = ("flat",) + tuple(f"b{s}" for s in ROWS) + ("flat_i32",
                                                     "b2048_i32")


def inputs(n: int = N, seed: int = 0):
    """The script's int64 keys and int32 payload."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 40, n).astype(np.int64),
            np.arange(n, dtype=np.int32))


def limbs(k64: np.ndarray):
    """The script's (hi, lo) int32 pair of each key, lo signed."""
    return ((k64 >> 32).astype(np.int32),
            (k64 & 0xFFFFFFFF).astype(np.uint32).astype(np.int32))


def rows_of(x, s: int):
    """x as rows of s: the first n // s * s values."""
    t = x.shape[0] // s
    if t == 0:
        raise ValueError(f"rows of {s} need {s} keys, got {x.shape[0]}")
    return x[:t * s].view(t, s)


def sort_pair(hi, lo, pay, dim=-1):
    """(hi, lo, pay) in (hi, lo) order, ties in row order: a stable sort
    by lo, then a stable sort by hi."""
    perm = torch.sort(lo, dim=dim, stable=True).indices
    perm = perm.gather(dim, torch.sort(hi.gather(dim, perm), dim=dim,
                                       stable=True).indices)
    return hi.gather(dim, perm), lo.gather(dim, perm), pay.gather(dim, perm)


def case_fns(k, pay, hi, lo):
    """{name: fn} of the cases over the inputs on one device."""
    def flat():
        sk, perm = torch.sort(k, stable=True)
        return sk, pay[perm]

    def batched(s):
        def fn():
            sk, perm = torch.sort(rows_of(k, s), dim=1, stable=True)
            return sk, rows_of(pay, s).gather(1, perm)
        return fn

    return {"flat": flat, **{f"b{s}": batched(s) for s in ROWS},
            "flat_i32": lambda: sort_pair(hi, lo, pay),
            "b2048_i32": lambda: sort_pair(rows_of(hi, 2048),
                                           rows_of(lo, 2048),
                                           rows_of(pay, 2048), dim=1)}


def run(n: int = N, device="cuda", cases=None, runs: int = 7) -> dict:
    """Check, then time each case (all, or those named); returns
    {"chip", "rows", "results"}."""
    device = device_of(device)
    k_h, pay_h = inputs(n)
    hi_h, lo_h = limbs(k_h)
    k, pay, hi, lo = (torch.from_numpy(a).to(device)
                      for a in (k_h, pay_h, hi_h, lo_h))
    fns = case_fns(k, pay, hi, lo)

    def check(name, out):
        out = [o.cpu().numpy() for o in out]
        if name == "flat":
            same(name, out[0], np.sort(k_h))
            check_lexsort(name, [k_h], out[1])
        elif name == "flat_i32":
            perm = out[2]
            check_lexsort(name, [hi_h, lo_h], perm)
            same(name, np.stack(out[:2]), np.stack([hi_h[perm], lo_h[perm]]))
        elif name == "b2048_i32":
            perm = out[2] - 2048 * np.arange(out[2].shape[0])[:, None]
            keys = [rows_of(x, 2048).cpu().numpy() for x in (hi, lo)]
            check_rows_lexsort(name, keys, perm)
            same(name, np.stack(out[:2]),
                 np.stack([np.take_along_axis(x, perm, 1) for x in keys]))
        else:
            s = int(name[1:])
            kb = rows_of(k, s).cpu().numpy()
            same(name, out[0], np.sort(kb, axis=1))
            check_rows_lexsort(name, [kb],
                               out[1] - s * np.arange(kb.shape[0])[:, None])

    results = {}
    for name in CASES:
        if cases is not None and name not in cases:
            continue
        check(name, fns[name]())
        ms = timed_ms(fns[name], device, runs)
        results[name] = {"ms": ms, "rows_per_sec": n / (ms / 1e3)}
    return {"chip": chip(device), "rows": n, "results": results}


def main(argv=None) -> int:
    a, cases = parse(argv, CASES, __doc__)
    print(json.dumps(run(a.n, a.device, cases, a.runs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Sort study: the candidate sort strategies on the card, and the int32
op rate that bounds a network of compare-exchanges.

    python -m ddb_tpu_torch.bench.sort_study [--n 6291456] [--runs 7]
        [--case twoop,vpu_chain] [--device cuda]

PyTorch port of scripts/bench_sort_study.py: the same six cases under the
same names, over the same inputs (one numpy generator of seed 0: int64
keys in [0, 2^40), the row ids, then int32 keys in [0, 2^20)):

  twoop            the int64 key and its int32 row id: torch.sort, a gather
  packed           key << 23 | row id, one int64 sort
  engine_adaptive  ops/order.py:sort_permutation of the key (all rows live)
  int32_1op        the int32 keys alone
  batched_48x128k  torch.sort(dim=1) over the int64 keys as 48 rows
  vpu_chain        96 chained int32 min/max operations over the int32 keys
                   (ops/vpu_chain.py, a kernel: eager torch would make 96
                   passes over memory and time bandwidth, not the op rate)

Each case is first held to numpy: its values to np.sort of the same
input, its permutation to a stable np.argsort (`check_lexsort`), and
vpu_chain to its plain torch chain, bit for bit.  Then it is timed: CUDA
events around the call, the median of `runs` warm calls
(`cmpx_probe.times_ms`); vpu_chain queues VPU_REPS launches between its
events and divides.  The card has no tunnel, so the reference's
round-trip subtraction has nothing to cancel.  On the CPU the host clock
takes the events' place and the chip reads "cpu (host)".  The one JSON
line goes to standard output, never to docs/SORT_STUDY.json (the TPU's
file).

The L2 holds 50 MB and 6,291,456 int64 keys are 50.3 MB: run twoop and
packed at 8 times n too to see a sort out of cache.  At n above 2^23 the
packed row id overlaps the key's low bits; the case still sorts one int64
word, as the reference's does.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..ops import order, vpu_chain

N = 6 * 1024 * 1024
RID_BITS = 23
VPU_REPS = 20           # vpu_chain launches queued between two events
CASES = ("twoop", "packed", "engine_adaptive", "int32_1op",
         "batched_48x128k", "vpu_chain")


# ---------------------------------------------------------------------------
# shared by the three sort probes (sort_study, sort_phase1, sort_merge)
# ---------------------------------------------------------------------------

def device_of(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    return device


def chip(device: torch.device) -> str:
    """The card's name and power limit, or "<device> (host)"."""
    if device.type != "cuda":
        return f"{device} (host)"
    from .operators import card_line
    return card_line()


def timed_ms(fn, device: torch.device, runs: int) -> float:
    """Median milliseconds of `runs` warm calls: CUDA events on a CUDA
    device (cmpx_probe.times_ms), the host clock elsewhere."""
    if device.type == "cuda":
        from .cmpx_probe import times_ms
        return statistics.median(times_ms(fn, runs))
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_lexsort(name: str, keys, perm) -> None:
    """Raise unless perm equals np.lexsort(keys[::-1]) (keys most
    significant first; for one key a stable np.argsort).  Checked as
    that sort's definition, in O(n): perm holds every row once, the keys
    through it are in order, and rows that tie on every key keep their
    order."""
    perm = np.asarray(perm, dtype=np.int64).reshape(-1)
    n = perm.shape[0]
    if n and (perm.min() < 0 or perm.max() >= n
              or np.bincount(perm, minlength=n).max() != 1):
        raise AssertionError(f"{name}: not a permutation of {n} rows")
    tie = np.ones(max(n - 1, 0), dtype=bool)
    for k in keys:
        ks = np.asarray(k).reshape(-1)[perm]
        if (tie & (ks[:-1] > ks[1:])).any():
            raise AssertionError(f"{name}: the keys are out of order")
        tie &= ks[:-1] == ks[1:]
    if (tie & (perm[:-1] > perm[1:])).any():
        raise AssertionError(f"{name}: tied rows out of their order")


def check_rows_lexsort(name: str, keys, perm) -> None:
    """check_lexsort of every row of 2-D keys and perm [T, S], each row a
    sort of its own."""
    t, s = perm.shape
    row = np.repeat(np.arange(t, dtype=np.int64), s)
    check_lexsort(name, [row] + [np.asarray(k).reshape(-1) for k in keys],
                  np.asarray(perm, dtype=np.int64) + row.reshape(t, s)
                  * s)


def same(name: str, got, want) -> None:
    if not np.array_equal(got, want):
        bad = int(np.sum(np.asarray(got) != np.asarray(want)))
        raise AssertionError(f"{name}: {bad} of {np.size(want)} values "
                             f"differ from numpy")


def parse(argv, cases, doc, n=N):
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=n)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--case", default=None,
                    help=f"comma-separated, of {', '.join(cases)}")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    picked = None if a.case is None else a.case.split(",")
    for c in picked or ():
        if c not in cases:
            ap.error(f"unknown case {c!r}")
    return a, picked


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def inputs(n: int = N, seed: int = 0):
    """The script's arrays: int64 keys, the int32 row ids, int32 keys."""
    rng = np.random.default_rng(seed)
    k64 = rng.integers(0, 1 << 40, n).astype(np.int64)
    rid = np.arange(n, dtype=np.int32)
    k32 = rng.integers(0, 1 << 20, n).astype(np.int32)
    return k64, rid, k32


def _batched_rows(k):
    """batched_48x128k's (48, n // 48) rows: (48, 131072) at n = N."""
    cols = k.shape[0] // 48
    if cols == 0:
        raise ValueError(f"batched_48x128k needs 48 keys, got {k.shape[0]}")
    return k[:48 * cols].view(48, cols)


def case_fns(k64, rid, k32):
    """{name: fn} of the five sort cases over the inputs on one device."""
    sel = torch.ones(k64.shape[0], dtype=torch.bool, device=k64.device)

    def twoop():
        sk, perm = torch.sort(k64, stable=True)
        return sk, rid[perm]

    return {
        "twoop": twoop,
        "packed": lambda: torch.sort((k64 << RID_BITS)
                                     | rid.to(torch.int64)).values,
        "engine_adaptive": lambda: order.sort_permutation([k64], sel),
        "int32_1op": lambda: torch.sort(k32).values,
        "batched_48x128k": lambda: torch.sort(_batched_rows(k64),
                                              dim=1).values,
    }


def run(n: int = N, device="cuda", cases=None, runs: int = 7) -> dict:
    """Check, then time each case (all, or those named); returns
    {"chip", "rows", "results"}."""
    device = device_of(device)
    k64_h, rid_h, k32_h = inputs(n)
    k64, rid, k32 = (torch.from_numpy(a).to(device)
                     for a in (k64_h, rid_h, k32_h))
    fns = case_fns(k64, rid, k32)

    def check(name, out):
        if name == "twoop":
            same(name, out[0].cpu().numpy(), np.sort(k64_h))
            check_lexsort(name, [k64_h], out[1].cpu().numpy())
        elif name == "packed":
            same(name, out.cpu().numpy(), np.sort(
                (k64_h << RID_BITS) | rid_h.astype(np.int64)))
        elif name == "engine_adaptive":
            check_lexsort(name, [k64_h], out.cpu().numpy())
        elif name == "int32_1op":
            same(name, out.cpu().numpy(), np.sort(k32_h))
        else:
            same(name, out.cpu().numpy(),
                 np.sort(_batched_rows(k64).cpu().numpy(), axis=1))

    results = {}
    for name in CASES:
        if cases is not None and name not in cases:
            continue
        if name == "vpu_chain":
            results[name] = _vpu_case(k32, vpu_chain.reference_bounds(),
                                      device, runs)
            continue
        check(name, fns[name]())
        ms = timed_ms(fns[name], device, runs)
        results[name] = {"ms": ms, "rows_per_sec": n / (ms / 1e3)}
    return {"chip": chip(device), "rows": n, "results": results}


def _vpu_case(k32, bounds, device, runs) -> dict:
    """vpu_chain: the kernel equal to the plain chain, bit for bit, then
    timed; the int32 operations a second."""
    n = k32.numel()
    got = vpu_chain.vpu_chain(k32, bounds, add=1)
    want = vpu_chain.vpu_chain_plain(k32, bounds, add=1)
    if not torch.equal(got, want):
        raise AssertionError(f"vpu_chain: the kernel differs from the "
                             f"plain chain at {int((got != want).sum())} "
                             f"of {n} elements")
    ms = timed_ms(lambda: [vpu_chain.vpu_chain(k32, bounds, add=i)
                           for i in range(VPU_REPS)], device, runs) \
        / VPU_REPS
    rec = {"chain": vpu_chain.CHAIN, "max_abs_err": 0, "ms": ms,
           "ops_per_sec": vpu_chain.CHAIN * n / (ms / 1e3),
           "plain_ms": timed_ms(
               lambda: vpu_chain.vpu_chain_plain(k32, bounds, add=1),
               device, runs)}
    if device.type == "cuda":
        rec["sass_minmax"] = vpu_chain.sass_minmax_count()
    return rec


def main(argv=None) -> int:
    a, cases = parse(argv, CASES, __doc__)
    print(json.dumps(run(a.n, a.device, cases, a.runs)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

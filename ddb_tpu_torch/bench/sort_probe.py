"""Probe: the two-phase sample-merge sort against torch.sort on the GPU.

    python -m ddb_tpu_torch.bench.sort_probe [--n 6291456] [--seed 0]
        [--runs 7] [--device cuda]

The counterpart of scripts/exp_sort_merge2.py.  It makes that script's
keys from a seed with numpy: 6,291,456 int64 values of 40 random high
bits with the row number in the low 23, so every key is unique and every
operand of the sorted result is fixed.  It sorts them with
`ops.tpu_sort.sort_ops` alone (`f`) and with an int32 payload, the key's
high bits (`f2`), checks that both equal `torch.sort` exactly, and prints
the median milliseconds of `runs` warm calls of each, by CUDA events,
beside those of `torch.sort` (for `f2`, the sort and the payload's
gather).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import tpu_sort
from .cmpx_probe import times_ms

N = 6 * 1024 * 1024
LOW_BITS = 23           # the row number; N < 2^23


def make_keys(n: int = N, seed: int = 0, device="cuda") -> torch.Tensor:
    """The script's keys: (random 40 bits << 23) | row, int64."""
    rng = np.random.default_rng(seed)
    k64 = (rng.integers(0, 1 << 40, n).astype(np.int64) << LOW_BITS) \
        | np.arange(n, dtype=np.int64)
    return torch.from_numpy(k64).to(device)


def payload(keys: torch.Tensor) -> torch.Tensor:
    """`f2`'s payload: the key's high bits as int32 (wrapping, as the
    script's astype does)."""
    return (keys >> LOW_BITS).to(torch.int32)


def check(keys: torch.Tensor) -> dict:
    """sort_ops of `f` and `f2` against torch.sort: the number of
    operands that differ (0 when exact) and the largest difference."""
    want = torch.sort(keys).values
    (f,) = tpu_sort.sort_ops([keys], num_keys=1)
    f2, pay = tpu_sort.sort_ops([keys, payload(keys)], num_keys=1)
    diffs = [(f - want).abs().max(), (f2 - want).abs().max(),
             (pay.long() - payload(want).long()).abs().max()]
    return {"mismatched_operands": sum(int(d != 0) for d in diffs),
            "max_abs_err": max(int(d) for d in diffs)}


def run(n: int = N, seed: int = 0, device="cuda", runs: int = 7) -> dict:
    """Check, then time sort_ops and torch.sort (median of `runs`)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe times on the card: it needs a CUDA "
                           f"device, not {device}")
    keys = make_keys(n, seed, device)
    pay = payload(keys)
    rec = {"n": n, **check(keys)}

    def torch_f2():
        s = torch.sort(keys)
        return s.values, pay[s.indices]

    timed = {
        "sort_ops_f_ms": lambda: tpu_sort.sort_ops([keys]),
        "torch_sort_f_ms": lambda: torch.sort(keys),
        "sort_ops_f2_ms": lambda: tpu_sort.sort_ops([keys, pay]),
        "torch_sort_f2_ms": torch_f2,
    }
    for name, fn in timed.items():
        rec[name] = float(np.median(times_ms(fn, runs)))
    for f in ("f", "f2"):
        rec[f"sort_ops_{f}_rows_per_s"] = n / (rec[f"sort_ops_{f}_ms"] / 1e3)
    rec["device"] = torch.cuda.get_device_name(device)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    rec = run(a.n, a.seed, a.device, a.runs)
    print(json.dumps(rec))
    return 0 if rec["mismatched_operands"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())

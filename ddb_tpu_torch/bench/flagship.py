"""The flagship's one JSON line: TPC-H Q1 aggregate rows/s of the fused
Q1 kernel on one card, against the HBM roofline.

    python -m ddb_tpu_torch.bench.flagship [--operators PATH]
        [--device cuda]

PyTorch port of bench.py.  It prints ONE JSON line with bench.py's keys:
{"metric", "value", "unit", "vs_baseline", "kernel", "suite"}.

- Input: bench/tpch.py synth_lineitem at BENCH_ROWS rows (default
  6,001,215, TPC-H SF1 lineitem), seed 0, as int32 columns.
- Q1: the CUDA kernel `q1_kernel` (csrc/fused_agg.cu).  The reference's
  generations v2, v3, v4 and v7 are TPU layouts of one function; here
  they are that one kernel, so the line has one Q1 entry.
- vs_baseline: the fraction of the HBM roofline, 3.35 TB/s (H100 SXM
  nominal) over Q1's 24 bytes a row (six int32 columns).
- suite: the Q6 kernel `q6_kernel` and its plain torch version, the best
  of the two and its fraction of 3.35 TB/s over 16 bytes a row; the
  join probe of bench/operators.py and its sorts-only bound; and the rows
  of an operators file, if one is given, each labelled with its origin.
- The Q6 kernel is fed l_quantity in whole units.  bench.py passes the
  column scaled by 100, so its Q6 predicate (qty < 24) selects no row
  (bench.py:194); the port's line carries Q6's real revenue instead.
- Timing: CUDA events around launches queued back to back, the cutoff
  changing with each launch, median of 7 (bench/operators.py queued_ms).
- No fallback: bench.py falls back to an XLA loop when its kernels fail;
  here a failure raises and nothing is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import operators
from .tpch import synth_lineitem

BYTES_PER_ROW = 6 * 4           # Q1: six int32 columns
Q6_BYTES_PER_ROW = 4 * 4        # Q6: four int32 columns
Q1_CUTOFF = 10471               # 1998-09-02 in days since 1970-01-01
Q6_CUT = 8766                   # 1994-01-01
METRIC = "tpch_q1_sf1_agg_rows_per_sec"


def kernel_inputs(n, device):
    """synth_lineitem(n, seed=0) as the kernels' int32 columns:
    l_quantity in whole units, prices in cents, dates in days and
    gid = returnflag * 2 + linestatus."""
    d = synth_lineitem(n, seed=0)
    host = {"qty": d["l_quantity"] // 100, "ext": d["l_extendedprice"],
            "disc": d["l_discount"], "tax": d["l_tax"],
            "ship": d["l_shipdate"],
            "gid": d["l_returnflag"] * 2 + d["l_linestatus"]}
    return {k: torch.from_numpy(v.astype(np.int32)).to(device)
            for k, v in host.items()}


def q1_bench(cols, device):
    """The Q1 kernel held to its plain version, then its rows/s."""
    from ..ops import fused_agg as F
    args = [cols[c] for c in ("qty", "ext", "disc", "tax", "ship", "gid")]
    n = args[0].shape[0]
    for cut in (Q1_CUTOFF, Q1_CUTOFF - 1):
        if not torch.equal(F.q1_fused_aggregate(*args, cut),
                           F.q1_fused_aggregate_plain(*args, cut)):
            raise AssertionError(f"q1_kernel at cutoff {cut} differs from "
                                 "its plain version")
    ms = operators.queued_ms(
        lambda i: F.q1_fused_aggregate(*args, Q1_CUTOFF - (i % 2)),
        device)[0]
    return n / (ms / 1e3)


def q6_bench(cols, device):
    """The Q6 kernel and its plain version: both held to the numpy
    oracle at Q6's date, then both timed; suite entries."""
    from ..ops import fused_agg as F
    args = [cols[c] for c in ("qty", "ext", "disc", "ship")]
    n = args[0].shape[0]
    revenue = int(F.q6_fused_filter_sum(*args, Q6_CUT))
    want = F.q6_reference(*(a.cpu().numpy() for a in args), Q6_CUT)
    if revenue != want or int(F.q6_fused_filter_sum_plain(*args, Q6_CUT)) \
            != want or want <= 0:
        raise AssertionError(f"Q6: kernel {revenue}, numpy {want}")
    rates = {}
    for name, fn in (("cuda", F.q6_fused_filter_sum),
                     ("plain", F.q6_fused_filter_sum_plain)):
        ms = operators.queued_ms(lambda i: fn(*args, Q6_CUT + (i % 7)),
                                 device)[0]
        rates[name] = n / (ms / 1e3)
    best = max(rates.values())
    return {"q6_filter_cuda_rows_per_sec": rates["cuda"],
            "q6_filter_plain_rows_per_sec": rates["plain"],
            "q6_filter_rows_per_sec": best,
            "q6_filter_roofline_frac":
                best / (operators.HBM_BW / Q6_BYTES_PER_ROW),
            "q6_revenue": revenue}


def join_bench(device):
    """bench/operators.py's join probe at the reference's size, with its
    sorts-only bound, both measured in this run."""
    results = {}
    operators.bench_join(results, operators.REFERENCE_ROWS,
                         np.random.default_rng(0), device)
    r = results["join_probe"]
    return {"join_probe_live_rows_per_sec": r["rows_per_sec"],
            "join_probe_live_roofline_frac":
                r["rows_per_sec"] / r["roofline"]}


def operator_extras(path):
    """The rows of an operators file (bench/operators.py's record), each
    labelled with its origin: the file, its rows, its card and the row's
    measured_at stamp."""
    with open(path) as f:
        data = json.load(f)
    out = {}
    for op, r in data["results"].items():
        key = op.lstrip("_")
        out[f"{key}_rows_per_sec"] = r["rows_per_sec"]
        out[f"{key}_roofline_frac"] = r["roofline_frac"]
        out[f"{key}_source"] = (
            f"operators file {os.path.basename(path)}, {data['rows']} rows, "
            f"{data['chip']}, measured_at {r['measured_at']}")
    return out


def run(n=None, device="cuda", operators_path=None) -> dict:
    """The line as a dict.  n defaults to BENCH_ROWS (6,001,215)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flagship: CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    if n is None:
        n = int(os.environ.get("BENCH_ROWS", 6_001_215))
    cols = kernel_inputs(n, device)
    rate = q1_bench(cols, device)
    roofline = operators.HBM_BW / BYTES_PER_ROW
    suite = {"q1_agg_q1_kernel": rate,
             "q1_generations": "pallas_agg.py's v2, v3, v4 and v7 are one "
                               "CUDA kernel, q1_kernel",
             "rows": n,
             "chip": (operators.card_line() if device.type == "cuda"
                      else f"{device} (host)")}
    suite.update(q6_bench(cols, device))
    del cols
    suite.update(join_bench(device))
    if operators_path:
        suite.update(operator_extras(operators_path))
    return {"metric": METRIC, "value": rate, "unit": "rows/s",
            "vs_baseline": rate / roofline, "kernel": "q1_kernel",
            "suite": suite}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ddb_tpu_torch.bench."
                                      "flagship")
    ap.add_argument("--operators", default=None,
                    help="a bench/operators.py record to fold in")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device,
                         operators_path=args.operators)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

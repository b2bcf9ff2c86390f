"""Run the PyTorch/CUDA port (ddb_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: CUDA must be available; prints the card's name and power limit.
  2. build: compiles the CUDA kernels from ddb_tpu_torch/csrc/ with nvcc.
  3. kernels vs plain versions: every fused-aggregate input set, exact.
  4. main path at TPC-H SF10 scale (59,986,052 lineitem rows resident on
     the card): SQL Q1 and Q6 through connect()/execute()/fetchall(), and
     the benchmark path, the fused Q1/Q6 kernels over the same columns;
     the SQL answers must equal the kernels' exactly.  Launch counts are
     reset just before and read just after this phase.
  5. timings (CUDA events, median of warm runs), printed, never asserted.
Then one JSON line of kernel records, and last the device line.
Exits non-zero, printing no result, when any phase fails.
"""

from __future__ import annotations

import decimal
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SF10_LINEITEM_ROWS = 59_986_052
Q1_CUTOFF = 10471      # 1998-09-02 in days since 1970-01-01
Q6_CUT = 8766          # 1994-01-01
WARM_RUNS = 7
AVG_RTOL = 1e-12       # float avg vs exact kernel sums / counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0].strip()


def timed_ms(fn, runs=WARM_RUNS):
    """Median milliseconds of `runs` warm calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels_vs_plain(F, cases, dev):
    """Phase 3: kernel == plain version == numpy oracle on every case."""
    worst = {"q1": 0, "q6": 0}
    for name, kind, cols, cut in cases:
        t = [torch.from_numpy(c).to(dev) for c in cols]
        if kind == "q1":
            got = F.q1_fused_aggregate(*t, cut)
            plain = F.q1_fused_aggregate_plain(*t, cut)
            want = torch.from_numpy(F.reference_sums(*cols, cut)).to(dev)
        else:
            got = F.q6_fused_filter_sum(*t, cut)
            plain = F.q6_fused_filter_sum_plain(*t, cut)
            want = torch.tensor(F.q6_reference(*cols, cut), device=dev)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and torch.equal(got, want)):
            raise AssertionError(f"{name}: kernel {got.tolist()} != plain "
                                 f"{plain.tolist()} / oracle {want.tolist()}")
        worst[kind] = max(worst[kind], int((got - plain).abs().max()))
        print(f"phase 3: {name} ({cols[0].shape[0]} rows): kernel == plain "
              "== oracle")
    return worst


def check_q1(rows, sums, F):
    """SQL Q1 rows against the kernel's sums, exactly (avgs to 1e-12)."""
    r = F.q1_results_from_sums(sums)
    by_group = {(row[0], row[1]): row for row in rows}
    live = [g for g in range(F.GROUPS) if r["count"][g] > 0]
    if len(live) != len(rows):
        raise AssertionError(f"Q1: {len(rows)} SQL groups, kernel has "
                             f"{len(live)}")
    for g in live:
        key = ("ANR"[g // 2], "FO"[g % 2])
        row = by_group[key]
        cnt = int(r["count"][g])
        want = (decimal.Decimal(int(r["sum_qty"][g])).quantize(
                    decimal.Decimal("0.01")),
                decimal.Decimal(int(r["sum_base_price"][g])).scaleb(-2),
                decimal.Decimal(int(r["sum_disc_price"][g])).scaleb(-4),
                decimal.Decimal(int(r["sum_charge"][g])).scaleb(-6))
        if tuple(row[2:6]) != want or row[9] != cnt:
            raise AssertionError(f"Q1 {key}: SQL {row} != kernel {want}, "
                                 f"count {cnt}")
        avgs = (int(r["sum_qty"][g]) / cnt,
                int(r["sum_base_price"][g]) / cnt / 100,
                int(r["sum_disc"][g]) / cnt / 100)
        for got, exp in zip(row[6:9], avgs):
            if abs(got - exp) > AVG_RTOL * abs(exp):
                raise AssertionError(f"Q1 {key}: avg {got} != {exp}")


def main() -> int:
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import ddb_tpu_torch
    from ddb_tpu_torch import kernels
    from ddb_tpu_torch.bench.fused_agg_cases import cases
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES, register_synth_lineitem
    from ddb_tpu_torch.ops import fused_agg as F

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    # ---- 2. build ----------------------------------------------------------
    lib = kernels.load()
    print(f"phase 2: built {lib.path.name} in {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())

    # ---- 3. kernels vs plain versions --------------------------------------
    worst = check_kernels_vs_plain(F, cases(), dev)
    if F.LAUNCHES["q1"] == 0 or F.LAUNCHES["q6"] == 0:
        raise AssertionError(f"phase 3: kernels did not launch: "
                             f"{F.LAUNCHES}")

    # ---- 4. the main path at SF10 scale ------------------------------------
    t0 = time.perf_counter()
    con = ddb_tpu_torch.connect(device="cuda")
    register_synth_lineitem(con, SF10_LINEITEM_ROWS, seed=0)
    td = con.catalog.get_table("lineitem")
    td.device_batch(device=dev)
    torch.cuda.synchronize()
    print(f"phase 4: lineitem {td.num_rows} rows resident on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")

    def main_path():
        res1 = con.execute(TPCH_QUERIES[1])
        res6 = con.execute(TPCH_QUERIES[6])
        rows1, rows6 = res1.fetchall(), res6.fetchall()
        kin = F.lineitem_kernel_inputs(td, dev)
        sums = F.q1_fused_aggregate(
            kin["qty"], kin["ext"], kin["disc"], kin["tax"], kin["ship"],
            kin["gid"], Q1_CUTOFF)
        rev = F.q6_fused_filter_sum(kin["qty"], kin["ext"], kin["disc"],
                                    kin["ship"], Q6_CUT)
        return (res1, res6), rows1, rows6, kin, sums.cpu().numpy(), \
            int(rev)

    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    results, rows1, rows6, kin, sums, rev = main_path()
    launches = dict(F.LAUNCHES)
    print(f"phase 4: main path ran in {time.perf_counter() - t0:.2f} s "
          f"(first run); kernel launches {launches}")
    for k, v in launches.items():
        if v < 1:
            raise AssertionError(f"phase 4: kernel {k} never launched")
    for res in results:
        tensors = [res.batch.sel] + [t for c in res.batch.columns
                                     for t in c if t is not None]
        if any(t.device.type != "cuda" for t in tensors):
            raise AssertionError("phase 4: a result tensor is off the card")
    check_q1(rows1, sums, F)
    want6 = decimal.Decimal(rev).scaleb(-4)
    if rows6 != [(want6,)] or rev <= 0:
        raise AssertionError(f"Q6: SQL {rows6} != kernel {want6}")
    print(f"phase 4: SQL Q1 ({len(rows1)} groups) and Q6 revenue {want6} "
          "equal the kernels' results exactly")
    for row in rows1:
        print("  Q1", row)

    # full-size kernel vs plain version
    q1_args = [kin[c] for c in ("qty", "ext", "disc", "tax", "ship", "gid")]
    q6_args = [kin[c] for c in ("qty", "ext", "disc", "ship")]
    plain1 = F.q1_fused_aggregate_plain(*q1_args, Q1_CUTOFF).cpu().numpy()
    plain6 = int(F.q6_fused_filter_sum_plain(*q6_args, Q6_CUT))
    if not (np.array_equal(plain1, sums) and plain6 == rev):
        raise AssertionError("phase 4: full-size kernel != plain version")
    worst["q1"] = max(worst["q1"], int(np.abs(plain1 - sums).max()))
    worst["q6"] = max(worst["q6"], abs(plain6 - rev))
    print("phase 4: full-size kernels == plain versions")

    # ---- 5. timings --------------------------------------------------------
    n = td.num_rows
    ms = {
        "sql_q1": timed_ms(lambda: con.execute(TPCH_QUERIES[1]).fetchall()),
        "sql_q6": timed_ms(lambda: con.execute(TPCH_QUERIES[6]).fetchall()),
        "q1_plain": timed_ms(lambda: F.q1_fused_aggregate_plain(
            *q1_args, Q1_CUTOFF)),
        "q1": timed_ms(lambda: F.q1_fused_aggregate(*q1_args, Q1_CUTOFF)),
        "q6": timed_ms(lambda: F.q6_fused_filter_sum(*q6_args, Q6_CUT)),
        "q6_plain": timed_ms(lambda: F.q6_fused_filter_sum_plain(
            *q6_args, Q6_CUT)),
    }
    for name, t in ms.items():
        print(f"phase 5: {name}: {t:.4f} ms median of {WARM_RUNS}, "
              f"{n / (t / 1e3):.4e} rows/s at {n} rows [{card}]")

    print(json.dumps({"kernels": [
        {"name": "q1_fused_aggregate", "route": "cuda",
         "source": "ddb_tpu_torch/csrc/fused_agg.cu",
         "replaces": "ddb_tpu/ops/pallas_agg.py:502",
         "launches": launches["q1"], "max_abs_err": worst["q1"],
         "ms": ms["q1"], "plain_ms": ms["q1_plain"]},
        {"name": "q6_fused_filter_sum", "route": "cuda",
         "source": "ddb_tpu_torch/csrc/fused_agg.cu",
         "replaces": "ddb_tpu/ops/pallas_agg.py:575",
         "launches": launches["q6"], "max_abs_err": worst["q6"],
         "ms": ms["q6"], "plain_ms": ms["q6_plain"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

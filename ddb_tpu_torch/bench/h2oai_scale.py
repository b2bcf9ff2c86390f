"""h2oai group-by at scale (BASELINE config 4: 1e8 rows, skewed keys).

PyTorch port of scripts/run_h2oai_scale.py.  Generates G1-style data
fully vectorized (ids as numbers, stored as dictionary codes: no
per-row string formatting), runs the 10 group-by queries through
ddb_tpu_torch on the card (or the device the caller names), and computes
the reference harness's RESULT_QUERY checksums over each answer
(reference: benchmark/h2oai/group/q*.benchmark).

  python -m ddb_tpu_torch.bench.h2oai_scale --n 100000000 [--skew 1.1]
         [--queries 1,2,5] [--runs 7] [--check] [--dist N]
         [--oracle-1e8] [--device cuda] [--json PATH]

--skew S draws id1/id2/id4/id5 group indices from a Zipf-like
distribution (p ~ 1/rank^S); --dist N re-runs the queries under
Connection.use_mesh over N shards of the device and holds each result
to the single-device rows, with the exchange's retry counters
(parallel/executor.py STATS).  --check holds every answer to numpy
oracles over the generated columns.  --oracle-1e8 compares the
checksums with DuckDB's own over the 1e8-row table at skew 0
(ORACLE_1E8); the oracle CLI path of the reference script is not
carried over.  The table is kept resident (external_threshold_rows is
raised above it), as the card's timed h2oai runs keep it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from . import h2oai as H
from .operators import card_line, timed_ms

# reference harness checksum queries (benchmark/h2oai/group/q*.benchmark)
RESULT_QUERIES = {
    1: "SELECT COUNT(DISTINCT id1), SUM(v1), COUNT(*) FROM ans",
    2: "SELECT COUNT(DISTINCT id1), COUNT(DISTINCT id2), SUM(v1), "
       "COUNT(*) FROM ans",
    3: "SELECT COUNT(DISTINCT id3), SUM(v1), SUM(v3), COUNT(*) FROM ans",
    4: "SELECT COUNT(DISTINCT id4), SUM(v1), SUM(v2), SUM(v3), "
       "COUNT(*) FROM ans",
    5: "SELECT COUNT(DISTINCT id6), SUM(v1), SUM(v2), SUM(v3), "
       "COUNT(*) FROM ans",
    6: "SELECT COUNT(DISTINCT id4), COUNT(DISTINCT id5), "
       "SUM(median_v3), SUM(sd_v3), COUNT(*) FROM ans",
    7: "SELECT COUNT(DISTINCT id3), SUM(range_v1_v2), COUNT(*) FROM ans",
    8: "SELECT COUNT(DISTINCT id6), SUM(largest2_v3), COUNT(*) FROM ans",
    9: "SELECT COUNT(DISTINCT id2), COUNT(DISTINCT id4), SUM(r2), "
       "COUNT(*) FROM ans",
    10: "SELECT COUNT(DISTINCT id1), COUNT(DISTINCT id2), "
        "COUNT(DISTINCT id3), COUNT(DISTINCT id4), COUNT(DISTINCT id5), "
        "COUNT(DISTINCT id6), SUM(v3), SUM(count), COUNT(*) FROM ans",
}

# The DuckDB CLI's checksums of q1-q10 over generate_scale(100_000_000,
# k=100, seed=108, skew=0.0), copied from docs/H2OAI_SCALE_1e8.json
# ("oracle").
ORACLE_1E8 = {
    1: "100,300003746,100",
    2: "100,100,300003746,10000",
    3: "1000000,300003746,50002563.767536186,1000000",
    4: "100,300.00375988801136,799.9916991998564,5000.2863596884135,100",
    5: "1000000,300003746,799991752,5000285951.555294,1000000",
    6: "100,100,500035.01219150075,288662.36149158725,10000",
    7: "1000000,3998688,1000000",
    8: "1000000,196997770.60372835,2000000",
    9: "100,100,0.9888715674762605,10000",
    10: "100,100,1000000,100,100,1000000,5000285951.555922,100000000,"
        "100000000",
}
ORACLE_1E8_TABLE = {"n": 100_000_000, "k": 100, "seed": 108, "skew": 0.0}

# each query's group keys: the order in which two results are compared
KEYS = {1: ["id1"], 2: ["id1", "id2"], 3: ["id3"], 4: ["id4"],
        5: ["id6"], 6: ["id4", "id5"], 7: ["id3"],
        8: ["id6", "largest2_v3"], 9: ["id2", "id4"],
        10: ["id1", "id2", "id3", "id4", "id5", "id6"]}

FLOAT_RTOL = 1e-12     # float aggregates: sums taken in another order
ONE_PASS_RTOL = 1e-9   # stddev/corr from sum x, sum x^2 against two-pass


def skewed_codes(rng, k, n, skew):
    if not skew:
        return rng.integers(0, k, n).astype(np.int32)
    ranks = np.arange(1, k + 1, dtype=np.float64)
    p = 1.0 / ranks ** skew
    p /= p.sum()
    return rng.choice(k, size=n, p=p).astype(np.int32)


def generate_scale(n, k=100, seed=108, skew=0.0):
    """G1-style columns, drawn as the reference script draws them (the
    same draws in the same order), in the form of bench/h2oai.generate:
    every id as the number inside its label ('id001' is 1).  At skew 0
    they equal h2oai.generate(n, k, seed=seed)."""
    rng = np.random.default_rng(seed)
    big = max(n // k, 1)
    return {
        "id1": skewed_codes(rng, k, n, skew) + 1,
        "id2": skewed_codes(rng, k, n, skew) + 1,
        "id3": rng.integers(0, big, n).astype(np.int32) + 1,
        "id4": skewed_codes(rng, k, n, skew) + 1,
        "id5": skewed_codes(rng, k, n, skew) + 1,
        "id6": rng.integers(1, big + 1, n).astype(np.int32),
        "v1": rng.integers(1, 6, n).astype(np.int32),
        "v2": rng.integers(1, 16, n).astype(np.int32),
        "v3": np.round(rng.uniform(0, 100, n), 6),
    }


def register_scale(con, cols):
    """Table x_group of generate_scale()'s columns: id1-id3 VARCHAR as
    dictionary codes, the rest INTEGER and DOUBLE (bench/h2oai.register)."""
    return H.register(con, cols)


def write_csv_scale(cols, path, device="cuda"):
    """generate_scale()'s columns as the CSV file the reference writes
    with pyarrow (storage/csvwrite.py, formatted on `device`)."""
    return H.write_csv(cols, path, device=device)


def fmt_row(row):
    out = []
    for v in row:
        if v is None:
            out.append("")
        else:
            out.append(repr(v) if isinstance(v, float) else str(v))
    return ",".join(out)


def checksums_match(a: str, b: str, rtol=1e-9) -> bool:
    """Field-wise: ints exact, floats within rtol (summation order over
    1e8 doubles legitimately differs in the last ulps)."""
    fa, fb = a.split(","), b.split(",")
    if len(fa) != len(fb):
        return False
    for x, y in zip(fa, fb):
        if x == y:
            continue
        try:
            xv, yv = float(x), float(y)
        except ValueError:
            return False
        if not np.isclose(xv, yv, rtol=rtol, atol=1e-12):
            return False
    return True


def run(con, queries=None, runs=0):
    """The reference script's loop: CREATE OR REPLACE TEMP TABLE ans AS
    <q>, the checksum query over ans, DROP TABLE ans; each cycle timed on
    the connection's device.  With runs > 0, the query alone is then run
    `runs` more times (execute() and a synchronisation, the result left on
    the device) for its median, spread and peak device memory.

    Returns {q: {"checksum", "ms", "groups"[, "times_ms", "median_ms",
    "peak_bytes"]}}."""
    dev = con.device
    out = {}
    for q in queries or sorted(H.QUERIES):
        def cycle():
            con.execute(f"CREATE OR REPLACE TEMP TABLE ans AS "
                        f"{H.QUERIES[q]}")
            return con.execute(RESULT_QUERIES[q]).fetchall()
        rows, ms = timed_ms(cycle, dev)
        con.execute("DROP TABLE ans")
        rec = out[q] = {"checksum": fmt_row(rows[0]), "ms": ms,
                        "groups": rows[0][-1]}
        if runs:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            times = [timed_ms(lambda: con.execute(H.QUERIES[q]), dev)[1]
                     for _ in range(runs)]
            rec.update(times_ms=times, median_ms=statistics.median(times))
            if dev.type == "cuda":
                rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


# ---------------------------------------------------------------------------
# the rows over a mesh against one device's, on the device
# ---------------------------------------------------------------------------

def live_sorted(res, keys):
    """A result's live rows on its device, ordered by its key columns:
    [(field, data, nulls)]."""
    from ..ops import order as order_ops
    from ..ops import sortkey
    b = res.batch
    idx = torch.nonzero(b.sel).squeeze(1)
    cols = [(f, c.data[idx], None if c.nulls is None else c.nulls[idx])
            for f, c in zip(res.schema.fields, b.columns)]
    key_ops = []
    for k in keys:
        f, d, n = cols[res.schema.names.index(k)]
        key_ops.extend(sortkey.encode_key(d, n, f.dtype))
    perm = order_ops.sort_permutation(
        key_ops, torch.ones(idx.shape[0], dtype=torch.bool,
                            device=idx.device))
    return [(f, d[perm], None if n is None else n[perm]) for f, d, n in cols]


def same_rows(name, want, got, keys):
    """Two results on one device hold the same rows in any order: sorted
    by their key columns, integers equal exactly, floats to FLOAT_RTOL.
    Returns the rows; raises AssertionError naming the first column that
    differs."""
    if want.schema.names != got.schema.names:
        raise AssertionError(f"{name}: columns {got.schema.names}")
    a, b = live_sorted(want, keys), live_sorted(got, keys)
    if a[0][1].shape != b[0][1].shape:
        raise AssertionError(f"{name}: {b[0][1].shape[0]} rows against "
                             f"{a[0][1].shape[0]}")
    for (f, x, na), (_, y, nb) in zip(a, b):
        if not torch.equal(na if na is not None else torch.zeros_like(
                x, dtype=torch.bool), nb if nb is not None
                else torch.zeros_like(y, dtype=torch.bool)):
            raise AssertionError(f"{name}.{f.name}: NULLs differ")
        if x.is_floating_point():
            ok = torch.isclose(x, y, rtol=FLOAT_RTOL, atol=0.0,
                               equal_nan=True).all()
        else:
            ok = torch.equal(x, y)
        if not bool(ok):
            raise AssertionError(f"{name}.{f.name}: values differ")
    return a[0][1].shape[0]


def run_dist(con, shards, queries=None):
    """Every query under con.use_mesh over `shards` shards of the
    connection's device, against its single-device rows.  Returns
    {"devices", "status": {q: {"groups", "equal", "fallback", "ms"}},
    "exchange_stats"}; "equal" is True or the difference."""
    from ..parallel import executor as EX
    from ..parallel.mesh import Mesh
    EX.STATS["exchange_retries"] = 0
    EX.STATS["exchange_overflow_rows"] = 0
    mesh = Mesh([con.device] * shards)
    level = con.log.level
    status = {}
    for q in queries or sorted(H.QUERIES):
        want = con.execute(H.QUERIES[q])
        con.log.level = "debug"
        seen = len(con.log.entries)
        con.use_mesh(mesh)
        try:
            got, ms = timed_ms(lambda: con.execute(H.QUERIES[q]),
                               con.device)
        finally:
            con.use_mesh(None)
            con.log.level = level
        fallback = [e.message for e in list(con.log.entries)[seen:]
                    if e.type == "dist"]
        try:
            same_rows(f"q{q}", want, got, KEYS[q])
            equal = True
        except AssertionError as e:
            equal = str(e)
        status[q] = {"groups": int(got.batch.count), "equal": equal,
                     "fallback": fallback, "ms": ms}
        del want, got
    return {"devices": shards, "status": status,
            "exchange_stats": dict(EX.STATS)}


# ---------------------------------------------------------------------------
# every answer against numpy over the generated columns
# ---------------------------------------------------------------------------

def _segments(inv):
    """Rows ordered by group, and each group's first position there."""
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv)
    return order, np.concatenate([[0], np.cumsum(counts)[:-1]]), counts


def _sorted_result(res, keys):
    """A result's live columns as numpy arrays (VARCHAR as dictionary
    codes), rows ordered by the key columns."""
    cols = res.fetchnumpy()
    order = np.lexsort([cols[k] for k in reversed(keys)])
    return {k: v[order] for k, v in cols.items()}


def close(name, got, want, rtol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want)
    bad = ~(np.abs(got - want) <= rtol * np.abs(want))
    bad &= ~(np.isnan(got) & np.isnan(want))
    if got.shape != want.shape or bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} of {want.size} "
                             f"values differ by more than {rtol} relative")


def equal(name, got, want):
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        raise AssertionError(f"{name}: result differs from the numpy oracle")


def check_numpy(con, cols):
    """The ten queries on the connection against numpy over the same
    columns (group sums; bench/h2oai.py's q3, q6 and q8 oracles): integers
    exactly, floats to FLOAT_RTOL, the one-pass deviation and correlation
    to ONE_PASS_RTOL.  Raises AssertionError; returns the results and
    each one's live rows."""
    n = len(cols["v3"])
    id1, id2, id4 = cols["id1"], cols["id2"], cols["id4"]
    v1, v2, v3 = cols["v1"], cols["v2"], cols["v3"]
    res = {q: con.execute(H.QUERIES[q]) for q in sorted(H.QUERIES)}

    def sums(inv, w):
        return np.bincount(inv, weights=w)

    # q1, q2: exact integer sums (float64 weights hold them exactly)
    inv, first = H._group_index(id1)
    r = _sorted_result(res[1], ["id1"])
    equal("q1 groups", r["id1"], id1[first] - 1)
    equal("q1 sum(v1)", r["v1"], sums(inv, v1).astype(np.int64))
    inv, first = H._group_index(id1, id2)
    r = _sorted_result(res[2], ["id1", "id2"])
    equal("q2 groups", r["id2"], id2[first] - 1)
    equal("q2 sum(v1)", r["v1"], sums(inv, v1).astype(np.int64))
    # q3: the oracle of the bench module
    o3, s1, a3 = H.q3_oracle(cols)
    r = _sorted_result(res[3], ["id3"])
    equal("q3 groups", r["id3"], o3 - 1)
    equal("q3 sum(v1)", r["v1"], s1)
    close("q3 avg(v3)", r["v3"], a3, FLOAT_RTOL)
    # q4: averages by id4
    inv, first = H._group_index(id4)
    cnt = np.bincount(inv)
    r = _sorted_result(res[4], ["id4"])
    equal("q4 groups", r["id4"], id4[first])
    for name, col in (("v1", v1), ("v2", v2), ("v3", v3)):
        close(f"q4 avg({name})", r[name], sums(inv, col) / cnt, FLOAT_RTOL)
    # q5: sums by id6
    inv, first = H._group_index(cols["id6"])
    r = _sorted_result(res[5], ["id6"])
    equal("q5 groups", r["id6"], cols["id6"][first])
    equal("q5 sum(v2)", r["v2"], sums(inv, v2).astype(np.int64))
    close("q5 sum(v3)", r["v3"], sums(inv, v3), FLOAT_RTOL)
    # q6: median and deviation by (id4, id5)
    o4, o5, median, sd = H.q6_oracle(cols)
    r = _sorted_result(res[6], ["id4", "id5"])
    equal("q6 id4", r["id4"], o4)
    equal("q6 id5", r["id5"], o5)
    close("q6 median", r["median_v3"], median, FLOAT_RTOL)
    close("q6 stddev", np.ma.filled(r["sd_v3"], np.nan), sd, ONE_PASS_RTOL)
    # q7: max(v1) - min(v2) by id3
    inv, first = H._group_index(cols["id3"])
    order, starts, _ = _segments(inv)
    r = _sorted_result(res[7], ["id3"])
    equal("q7 groups", r["id3"], cols["id3"][first] - 1)
    equal("q7 range", r["range_v1_v2"],
          np.maximum.reduceat(v1[order], starts)
          - np.minimum.reduceat(v2[order], starts))
    # q8: the two largest v3 of every id6, as a multiset
    o6, top = H.q8_oracle(cols)
    r = _sorted_result(res[8], ["id6", "largest2_v3"])
    order = np.lexsort((top, o6))
    equal("q8 id6", r["id6"], o6[order])
    equal("q8 v3", r["largest2_v3"], top[order])
    # q9: squared correlation by (id2, id4), from one-pass sums
    inv, first = H._group_index(id2, id4)
    cnt = np.bincount(inv)
    x, y = v1.astype(np.float64), v2.astype(np.float64)
    mx, my = sums(inv, x) / cnt, sums(inv, y) / cnt
    cov = sums(inv, x * y) / cnt - mx * my
    var = (sums(inv, x * x) / cnt - mx * mx) * (sums(inv, y * y) / cnt
                                                  - my * my)
    with np.errstate(invalid="ignore", divide="ignore"):
        want = cov * cov / var
    r = _sorted_result(res[9], ["id2", "id4"])
    equal("q9 groups", r["id4"], id4[first])
    # r2 is near 0 here (independent draws): hold it absolutely.  A group
    # of one row, or of one value, has no correlation: NULL or NaN in SQL,
    # NaN in numpy
    got = np.ma.filled(np.ma.asarray(r["r2"], dtype=np.float64), np.nan)
    bad = ~(np.abs(got - want) <= ONE_PASS_RTOL)
    if (bad & ~(np.isnan(got) & np.isnan(want))).any():
        raise AssertionError("q9: r2 differs from the numpy oracle")
    # q10: one group per distinct row of the six ids
    packed = np.zeros(n, dtype=np.int64)
    for name in ("id1", "id2", "id3", "id4", "id5", "id6"):
        packed = packed * (int(cols[name].max()) + 1) + cols[name]
    groups = len(np.unique(packed))
    r = res[10].fetchnumpy()
    if len(r["count"]) != groups or int(r["count"].sum()) != n:
        raise AssertionError(f"q10: {len(r['count'])} groups of "
                             f"{int(r['count'].sum())} rows; numpy has "
                             f"{groups} of {n}")
    close("q10 sum(v3)", [r["v3"].sum()], [v3.sum()], 1e-9)
    return list(res.values()), {q: int(res[q].batch.count) for q in res}


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ddb_tpu_torch.bench.h2oai_scale",
        description="h2oai group-by q1-q10 at scale with the db-benchmark "
                    "harness's checksums")
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--seed", type=int, default=108)
    ap.add_argument("--skew", type=float, default=0.0)
    ap.add_argument("--queries", default="1,2,3,4,5,6,7,8,9,10")
    ap.add_argument("--runs", type=int, default=0,
                    help="time each query alone this many more times")
    ap.add_argument("--check", action="store_true",
                    help="hold every answer to numpy oracles")
    ap.add_argument("--dist", type=int, default=0,
                    help="re-run over N shards of the device")
    ap.add_argument("--oracle-1e8", action="store_true",
                    help="compare with DuckDB's checksums (ORACLE_1E8)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None, help="write the result here")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Runs the suite; prints the result as JSON and writes it to --json.
    Returns 1 when a checksum differs from DuckDB's or a mesh's rows from
    one device's; raises when a check fails."""
    import ddb_tpu_torch

    args = parse_args(argv)
    queries = [int(x) for x in args.queries.split(",")]
    table = {"n": args.n, "k": args.k, "seed": args.seed,
             "skew": args.skew}
    if args.oracle_1e8 and table != ORACLE_1E8_TABLE:
        raise SystemExit(f"--oracle-1e8 holds only the table "
                         f"{ORACLE_1E8_TABLE}, not {table}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("h2oai_scale: CUDA is not available; pass "
                           "--device cpu to run on the CPU")

    t0 = time.perf_counter()
    cols = generate_scale(args.n, args.k, seed=args.seed, skew=args.skew)
    gen_s = time.perf_counter() - t0
    print(f"generated {args.n} rows in {gen_s:.1f}s", file=sys.stderr,
          flush=True)
    con = register_scale(ddb_tpu_torch.connect(device=dev), cols)
    con.execute(f"SET external_threshold_rows = {args.n + 1}")
    t0 = time.perf_counter()
    con.catalog.get_table("x_group").device_batch(device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    result = {"table": table, "device": str(dev),
              "generate_s": gen_s,
              "resident_s": time.perf_counter() - t0}
    if dev.type == "cuda":
        result["card"] = card_line()
        result["resident_bytes"] = torch.cuda.memory_allocated(dev)

    if args.check:
        t0 = time.perf_counter()
        _, groups = check_numpy(con, cols)
        result["check"] = {"groups": groups,
                           "s": time.perf_counter() - t0}
        print(f"every answer equals numpy ({groups})", file=sys.stderr,
              flush=True)
    del cols

    recs = run(con, queries, args.runs)
    for q, rec in recs.items():
        print(f"q{q:02d} ddb_tpu_torch {rec['ms']:.1f} ms -> "
              f"{rec['checksum']}", file=sys.stderr, flush=True)
    result["ours"] = {q: r["checksum"] for q, r in recs.items()}
    result["queries"] = recs
    ok = True
    if args.oracle_1e8:
        result["oracle"] = {q: ORACLE_1E8[q] for q in queries}
        result["match"] = {q: checksums_match(recs[q]["checksum"],
                                              ORACLE_1E8[q])
                           for q in queries}
        ok &= all(result["match"].values())
    if args.dist:
        result["dist"] = run_dist(con, args.dist, queries)
        ok &= all(s["equal"] is True
                  for s in result["dist"]["status"].values())

    text = json.dumps(result, indent=1)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

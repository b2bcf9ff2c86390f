"""Run the PyTorch/CUDA port (ddb_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: CUDA must be available; prints the card's name and power limit.
  2. build: compiles the CUDA kernels from ddb_tpu_torch/csrc/ with nvcc.
  3. kernels vs plain versions: every fused-aggregate input set, exact,
     and the Q1 kernel's own edge cases (any row count, columns off a
     16-byte boundary, rows over the flush interval in one thread,
     filtered rows with a gid outside [0, 6)).
  4. main path at TPC-H SF10 scale (59,986,052 lineitem rows resident on
     the card): SQL Q1 and Q6 through connect()/execute()/fetchall(), and
     the benchmark path, the fused Q1/Q6 kernels over the same columns;
     the SQL answers must equal the kernels' exactly.  Launch counts are
     reset just before and read just after this phase.
  5. timings of phase 4 (CUDA events, median of warm runs with their
     spread), streaming probes over the six Q1 columns and the
     Q1 kernel's launch shape, printed, never asserted; 5b: the dense
     aggregate kernel (csrc/dense_agg.cu) over SQL Q1's own evaluated
     inputs, bit-equal to the masked loop, then timed beside the loop and
     its byte bound.  Then phase 4
     again after TPC-H's RF1 grows lineitem by 59,986 rows (INSERT INTO
     lineitem SELECT): SQL Q1 and Q6 must equal the kernels over the
     grown table, and the kernels their plain versions; the INSERT's and
     the re-upload's times are printed.  The lineitem table of phase 4 is
     then dropped.
  6. compare-exchange kernel vs its plain version, exact: the small cases
     that pin the semantics, the probe's own shape (96 tiles of 512 rows,
     45 stages, seed 0) and a large one (6144 tiles, 3.2 GB in and out).
  7. join path at TPC-H SF10 scale: customer (1,500,000 rows), orders
     (15,000,000) and lineitem (about 6.0e7) made from a seed and resident
     on the card; the compare-exchange probe's entry point at its own
     shape, then SQL Q3 and Q4 through connect()/execute()/fetchall().
     Q3 and Q4 must equal a numpy oracle on the host exactly (Q3's top 10
     tie-aware).  Launch counts are reset just before and read just after.
  8. timings of phase 7, and its peak device memory, printed, never
     asserted.  With --profile, torch.profiler tables of Q3 and Q4 too.
  9. h2oai db-benchmark group-by suite, checked size (G1_1e7_1e2_0_0:
     10,000,000 rows, K = 100, seed 108) resident on the card: all ten
     queries; q6 and q8 against numpy oracles (q8 exactly as a multiset,
     q6's groups exactly, its median to 1e-12 and its one-pass deviation
     to 1e-9 of the oracle's two-pass one), the others against numpy
     group sums (bench/h2oai_scale.py check_numpy).  It runs first in
     phase 23a's series of processes, beside phase 18.
 10. the same suite at full size (G1_1e8_1e2_0_0: 100,000,000 rows):
     median of warm runs and peak device memory of each query (execute()
     and a device synchronisation; the results stay on the card), q8
     cross-checked against max(v3) by id6 and q6 by its group count.
     With --profile, torch.profiler tables of q6 and q8.
 11. device agreement: the corpus of window and holistic-aggregate
     statements (bench/window_cases.py) through connect("cuda") and
     connect("cpu") must give the same rows (floats to 1e-12).
 12. loader: the vendored TPC-H sf0.01 files through load_tpch on the
     card, then TPC-H 3, 5, 10, 12, 14 and 19 on the card against the CPU.
 13. device agreement on the rest of the SELECT surface: the corpus of
     bench/select_cases.py (scalar functions, CTEs, UNNEST, lists, structs,
     lambdas, BIT, time zones, Python functions, the host aggregates)
     through connect("cuda") and connect("cpu"), floats to 1e-12; SAMPLE
     and random() by their properties on the card.
 14. a ClickBench-shaped hits table (bench/clickbench.py; the statements
     are written in the shape of ClickBench queries, they are not the
     suite's texts) at 10,000,000 rows: every statement on the card equals
     the CPU executor (sel_sample by its properties), and cb_like_count,
     cb_len and cb_trunc_minute equal numpy oracles.  b: the same columns
     written by clickbench.write_csv on the card (about 2.0 GB), whose
     header and first 10,000 rows must equal Python's csv.writer's bytes
     (the reference's write_csv); loaded in a fresh connection as the
     reference's tests/test_clickbench.py loads hits, CREATE TABLE hits AS
     SELECT * FROM read_csv_auto(file, nullstr='\\x00'), timed by step,
     with no chunk re-read for odd quoting and no field typed on the host;
     the loaded table equals the registered one on the card (integers
     as BIGINT) but for '' read as NULL in the VARCHAR columns (fault
     3.29), and phase 14's statements over it equal the CPU executor.
 15. the same table at 100,000,000 rows resident on the card:
     cb_like_count equals its oracle; every statement timed as phase 10
     times its queries, with peak device memory, host synchronisations,
     the recursion's rounds and the rows the host aggregate fetched.
 16. (runs right after phase 8, on phase 7's resident tables) DML at
     TPC-H SF10: RF1 (15,000 orders through an Appender and their lines
     by INSERT ... SELECT, in one transaction), RF2 (15,000 orders and
     their lines deleted by literal IN lists of 1,500 keys), ten ACID
     transactions (a point SELECT through an index on l_orderkey, an
     UPDATE of the order's lines, COMMIT) and one that rolls back.  Q3 and
     Q4 must then equal the numpy oracles over the columns with the same
     changes, the counts the oracle's, every table must be resident once,
     and nothing more than 10 % of the mutated tables may stay allocated
     beside them.  Each statement kind's times, split into binding,
     uploads, device work and the host, are printed, never asserted.
 17. out-of-core execution at the reference's defaults (tables above
     33,554,432 rows stream in tiles of 8,388,608; phases 4, 5, 7, 8, 10,
     15 and 16 set external_threshold_rows above their tables and say
     so, to time the resident path).  a: host-to-device rates (page-
     locked, registered in place, pageable, the host's staging copy);
     b: SF10 Q1 and Q6 streamed in 8 tiles equal the kernels exactly;
     f: an ORDER BY keeping about 1 % of the rows and a LIMIT 20000 take
     the tiled sort and TopN and equal the resident rows (b and f run
     before RF1, on phase 4's table); d: after phase 10, the h2oai suite
     at the defaults equals phase 10's rows, q1-q5, q7 and q10 streamed
     in 12 tiles; e and g: after phase 16, Q3 and Q4 under a memory_limit
     that Grace-partitions their joins spill and keep their rows, then
     under one below the three tables' bytes, where the buffer manager
     evicts and duckdb_memory()'s BUFFER_CACHE row stays within it; c (at
     the end): TPC-H SF30's lineitem, 179,998,372 rows on the host and
     never resident: the kernels over its int32 columns built piece by
     piece, then SQL Q1 and Q6 streamed in 22 tiles must equal them, each
     under 4 GiB above the allocation before it, with the copy and compute
     streams' times, the bytes moved and the bound.
 18. durable databases and the client surface at SF10 (59,986,052
     lineitem rows): a: CHECKPOINT into a new database file; b: under the
     WAL and a redo transport, RF1's share of lineitem by INSERT ...
     SELECT, a DELETE and an UPDATE of one day of l_shipdate each, then a
     crash (no close(), no checkpoint on shutdown); c: recovery through
     connect(device, database), timed as load, WAL replay and the first
     query, where SQL Q1 and Q6, streamed in 8 tiles and resident, must
     equal q1_kernel and q6_kernel over the recovered columns and a numpy
     oracle of the same mutations, with the table resident once; d:
     ATTACH of the file in a second connection equals the checkpoint's
     answers, and DETACH drops it; e: a redo Follower on a copy of the
     18a file catches up to the recovered answers; f: EXPLAIN ANALYZE of
     Q1 and Q6 and enable_profiling: the same rows, each operator's
     cardinality its live count; g: stream() with a LIMIT stops before
     the last tile, a whole stream equals execute() and never builds the
     table's batch, and a relation's Q6 revenue equals q6_kernel.  The
     native library of the database files (g++, zlib) is built in phase
     2.
 19. the distributed executor over four shards of the card
     (`Mesh([cuda:0] * 4)`): a (right after phase 8): SQL Q3 on phase 7's
     SF10 tables and SQL Q4 on SF1 tables (at SF10 the reference's
     capacities do not fit on one card) through execute_distributed and
     through use_mesh, equal to the single-device rows and the numpy
     oracles; c (beside a): exchange_by_key over SF10 lineitem on the mesh
     of 4 and the two-level exchange on a (2, 2) mesh, every live row on
     its hash's shard and the rows kept; b (after phase 17d): h2oai q1-q10
     at 1e8 rows equal to the single-device rows, compared on the card.
     Each statement's median of 3 warm runs, peak, exchanges, retries and
     host synchronisations are printed, never asserted.
 20. files in and out (storage/csvscan.py parses CSV on the card,
     storage/csvwrite.py writes it): e (inside phase 4, after RF1): COPY
     lineitem TO a '|' file without a header, then in a second
     connection CREATE TABLE lineitem with the declared types and COPY
     lineitem FROM it; every column equals phase 4's and SQL Q1/Q6 equal
     q1_kernel/q6_kernel over the reloaded columns (launches counted); f:
     Parquet both ways over the first 6,001,215 rows (SF1 lineitem's
     count) where pyarrow imports, else both statements raise naming it; b (after phase 19b): COPY x_group TO the h2oai file of
     1e8 rows, its first 10,000 lines against pyarrow's rules in plain
     Python; c: CREATE TABLE x_group AS SELECT * FROM read_csv_auto(file)
     in a second connection (db-benchmark's DuckDB load), every column
     equal to phase 10's, timed by step; d: q1-q10 there equal phase
     10's results; a (after phase 12): the corpus of bench/csv_cases.py
     through connect("cuda") and connect("cpu"), whole and in 5-byte
     chunks; g: a `mem://` filesystem through the cache.  Each step's
     temporary files go with it.
 21. the C API (inside phase 18, after 18g, on its database file as 18b
     and 18c left it): a: ddb_tpu_torch/capi.py builds libddb_tpu.so,
     libddb_tpu_adbc.so, capi_fetch and the reference's capi_smoke and
     adbc_smoke with cc; both smoke clients must print OK against the
     port on the card (DDB_CAPI_PLATFORM unset); b: the script's own
     Q1, Q6 (held to 18c's kernel sums) and a fetch of about 1,000,000
     rows at the defaults, then its connection closed; capi_fetch, a C
     program in a process of its own, opens the file and runs Q1 and Q6
     8 times and the fetch once: every value and checksum it prints must
     equal the script's rows lowered by capi_bridge, and the file and
     its WAL must be unchanged.  The C path launches none of the three
     kernels (SQL takes the engine's own operators).
 22. a: the reference's own test files, copied by
     ddb_tpu_torch/testing/refsuite.py into tests/test_torch_ref_*.py, in
     a pytest process of their own on the card (DDB_TORCH_REF_DEVICE=cuda,
     without tests/conftest.py, which imports jax), started as phase 18
     starts (its draw and CHECKPOINT keep one host core busy and the card
     idle for minutes) and read at the end: no test may fail, and the
     process must open connections on cuda and allocate device memory;
     b (at the end): bench/sort_probe.py: the two-phase sort of
     ops/tpu_sort.py over 6,291,456 unique int64 keys, alone and with an
     int32 payload, must equal torch.sort exactly; both are timed.  c: the
     sort studies bench/sort_study.py, sort_phase1.py and sort_merge.py at
     6,291,456 keys (twoop, packed, flat and vpu_chain at 8 times that
     too): every case equals numpy, and the vpu_chain kernel
     (csrc/vpu_chain.cu) its plain chain; its IMNMX count in the SASS and
     its int32 op rate beside the 16.75e12/s of cmpx_kernel's bound are
     printed.  Launch counts are reset just before and read just after
     the three modules.
 23. the repo's measuring programs.  a: python -m
     ddb_tpu_torch.bench.h2oai_scale in processes of their own, one after
     the other, started as phase 18 starts (beside 22a) and read at the
     end: phase 9, then (i) 1e8 rows at skew 0, whose ten db-benchmark checksums must
     match DuckDB's own (docs/H2OAI_SCALE_1e8.json); (ii) 1e7 rows at Zipf
     1.1, every answer held to numpy at phase 9's tolerances; (iii) 1e8
     rows at Zipf 1.1 (BASELINE config 4): q1-q10 timed on one device
     (median of 7, peak) beside phase 18's host work, then over four
     shards of the card, whose rows must equal one device's, with the
     exchange's retries and overflow rows; any failure or nonzero exit
     fails the script.  b (after 22b): bench/operators.py at 6,291,456
     and 59,986,052 rows, every operator held to its plain computation,
     no roofline fraction above 1.05 at the larger size; one JSON line.
     c: bench/flagship.py's JSON line (bench.py's keys), its operators'
     rows from b's larger size.  The Q1 and Q6 kernels' launches in b and
     c count in the kernels record.
Then one JSON line of kernel records (q1, q6, cmpx and vpu_chain) with
each kernel's bound, the card's line, and last the device line.
`--profile` adds torch.profiler tables.
Exits non-zero, printing no result, when any phase fails.
"""

from __future__ import annotations

import datetime
import decimal
import glob
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SF10_LINEITEM_ROWS = 59_986_052
RF1_LINEITEM_ROWS = 59_986     # RF1 at SF10 adds 0.1 % of lineitem
Q1_CUTOFF = 10471      # 1998-09-02 in days since 1970-01-01
Q6_CUT = 8766          # 1994-01-01
WARM_RUNS = 7
AVG_RTOL = 1e-12       # float avg vs exact kernel sums / counts
CMPX_LARGE_TILES = 6144    # 4.0e8 pairs: 3.2 GB in, 3.2 GB out
H2OAI_CHECKED_ROWS = 10_000_000     # G1_1e7_1e2_0_0
H2OAI_FULL_ROWS = 100_000_000       # G1_1e8_1e2_0_0
H2OAI_K, H2OAI_SEED = 100, 108
FLOAT_RTOL = 1e-12     # float aggregates: sums taken in another order
TPCH_LOADER_QUERIES = (3, 5, 10, 12, 14, 19)
HITS_CHECKED_ROWS = 10_000_000
HITS_FULL_ROWS = 100_000_000      # ClickBench's hits has 99,997,497
HITS_SEED = 11
# HAVING threshold and OFFSET at the checked size (the statements'
# own, 100000 and 1000, suit the full size)
HITS_CHECKED_MIN_COUNT, HITS_CHECKED_OFFSET = 10_000, 1000

# Published peaks of one H100 SXM, for the kernels' bounds.  The int32
# rate is derived from the float32 one: that counts a fused multiply-add
# as two operations, and an SM has half as many int32 lanes as float32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = FP32_FLOP_PER_S / 4
# int32 operations a row that the function needs (not what the kernel
# spends).  Q1: the cutoff compare, 100-disc, 100+tax, two shifts/masks,
# four 64-bit multiplies of four int32 operations each and eight 64-bit
# adds of two.  Q6: five compares, four ands, one widening multiply and
# one 64-bit add of two each.  A compare-exchange of two (hi, lo) pairs
# is a two-step lexicographic compare and four selects, so three
# operations an element and stage.
Q1_OPS_PER_ROW = 1 + 2 + 2 + 4 * 4 + 8 * 2
Q6_OPS_PER_ROW = 5 + 4 + 2 + 2
CMPX_OPS_PER_ELEMENT_STAGE = 3
# vpu_chain: 48 max and 48 min an element (scripts/bench_sort_study.py)
VPU_CHAIN_OPS = 96


def clocks_line() -> str:
    """The card's clocks, draw and temperature now, for reading a time."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip().splitlines()
    return out[0].strip()


def back_to_back_ms(fn, launches=20) -> float:
    """Milliseconds a call when `launches` calls are queued at once: the
    host runs ahead, so the device never waits for it between calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def bound(nbytes, nops):
    """(bound_ms, bound_by): the least time the card could take to move
    nbytes through device memory or to do nops int32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / INT32_OP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops \
        else (by_ops, "operations")


def q1_dense_inputs(con, sql):
    """The inputs of the one dense_group_aggregate call that SQL `sql`
    makes on `con`: (gid, domain, payloads, sel), Q1's evaluated group ids,
    filter and aggregate arguments."""
    from ddb_tpu_torch.ops import aggregate as A
    calls, dense = [], A.dense_group_aggregate

    def capture(gid, domain, payloads, sel):
        calls.append((gid, domain, list(payloads), sel))
        return dense(gid, domain, payloads, sel)

    A.dense_group_aggregate = capture
    try:
        con.execute(sql).fetchall()
    finally:
        A.dense_group_aggregate = dense
    if len(calls) != 1:
        raise AssertionError(f"{len(calls)} dense aggregates in {sql!r}")
    return calls[0]


def dense_phase(con, rows, card):
    """Phase 5b: the dense kernel (csrc/dense_agg.cu) over SQL Q1's own
    evaluated inputs on `con`: bit-equal to the masked loop, then its
    median of bracketed calls, its time queued back to back, the loop's
    time and the byte bound (each input column read once)."""
    from ddb_tpu_torch.bench import cmpx_probe
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    from ddb_tpu_torch.ops import aggregate as A
    t0 = time.perf_counter()
    gid, domain, pays, sel = q1_dense_inputs(con, TPCH_QUERIES[1])
    summed = [p for p in pays if A._in_dense_sums(p)]
    cols, _ = A.dense_plan(summed)
    before = A.LAUNCHES["dense"]
    got = A.dense_group_aggregate(gid, domain, pays, sel)
    torch.cuda.synchronize()
    want = A.dense_group_aggregate_plain(gid, domain, pays, sel)
    if A.LAUNCHES["dense"] != before + 1 or not torch.equal(got[1], want[1]):
        raise AssertionError("phase 5b: the dense kernel did not launch "
                             "once or its counts != the masked loop's")
    err = 0
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        g = [t for x in g for t in (x if isinstance(x, tuple) else (x,))]
        w = [t for x in w for t in (x if isinstance(x, tuple) else (x,))]
        if len(g) != len(w) or any((a is None) != (b is None)
                                   for a, b in zip(g, w)):
            raise AssertionError(f"phase 5b: aggregate {i} "
                                 f"({pays[i].kind}) != the masked loop's")
        for a, b in zip(g, w):
            if a is not None:
                err = max(err, (a != b).sum().item() if a.dtype == torch.bool
                          else (a - b).abs().max().item())
    if err != 0:
        raise AssertionError(f"phase 5b: the kernel's results differ from "
                             f"the masked loop's by up to {err}")
    n, live = gid.numel(), int(sel.sum())
    nbytes = n * (gid.element_size() + sel.element_size()) + sum(
        t.numel() * t.element_size() for c in cols
        for t in (c.data, c.nulls) if t is not None)
    bound_ms, by = bound(nbytes, 0)
    # the executor pads the batch to 2^26 slots and the kernel reads every
    # slot; the live rows alone (sel: the table's rows that pass Q1's
    # filter) would need nbytes * live / n
    bound_live_ms, _ = bound(nbytes * live // n, 0)
    fns = {"dense_sums": lambda: A.dense_sums(gid, domain, sel, cols),
           "dense_group_aggregate": lambda: A.dense_group_aggregate(
               gid, domain, pays, sel),
           "masked_loop": lambda: A.dense_group_aggregate_plain(
               gid, domain, pays, sel)}
    out = {"rows": rows, "slots": n, "live": live, "domain": domain,
           "aggregates": [p.kind for p in pays],
           "columns": [(None if c.data is None else str(c.data.dtype),
                        c.nulls is not None, c.count, c.sum) for c in cols],
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": by,
           "bound_live_ms": bound_live_ms, "max_abs_err": err}
    for name, fn in fns.items():
        t = cmpx_probe.times_ms(fn, WARM_RUNS)
        out[name] = statistics.median(t)
        print(f"phase 5b: {name}: {out[name]:.4f} ms median of "
              f"{WARM_RUNS} (min {min(t):.4f}, max {max(t):.4f}) at Q1's "
              f"{n} slots ({rows} rows) [{card}]")
    out["dense_sums_queued"] = back_to_back_ms(fns["dense_sums"])
    vec = gid.data_ptr() % 16 == 0
    shape = A.dense_launch_shape(gid.device, vec, domain * (
        1 + sum(c.words for c in cols)))
    print(f"phase 5b: dense_sums: {out['dense_sums_queued']:.4f} ms a "
          f"launch over 20 queued back to back; bound {bound_ms:.4f} ms "
          f"({by}: {nbytes} B of {len(cols)} columns, gid and sel over "
          f"{n} slots), {bound_ms / out['dense_sums_queued']:.4f} of it; "
          f"at the {live} live rows (sel) alone {bound_live_ms:.4f} ms, "
          f"{bound_live_ms / out['dense_sums_queued']:.4f} of it; launch "
          f"{shape.blocks(n)} blocks of {shape.threads} threads, "
          f"{shape.registers} registers a thread, {shape.shared_bytes} B "
          f"of shared memory a block, {shape.resident_blocks} resident an "
          f"SM [{card}; {clocks_line()}]")
    print(f"phase 5b: Q1's aggregates {out['aggregates']} as columns "
          f"(dtype, NULLs, count, sum mode) {out['columns']}; largest "
          f"difference from the masked loop {err}")
    print(f"phase 5b: ran in {time.perf_counter() - t0:.1f} s")
    return out


def check_cmpx(C, name, hi, lo, rows, stages, dmin):
    """Phase 6: kernel == plain version on one input; returns both times'
    inputs untouched and the largest absolute difference (0)."""
    got = C.cmpx_stages(hi, lo, rows, stages, dmin)
    torch.cuda.synchronize()
    plain = C.cmpx_stages_plain(hi, lo, rows, stages, dmin)
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])):
        bad = int(((got[0] != plain[0]) | (got[1] != plain[1])).sum())
        raise AssertionError(f"cmpx {name}: kernel != plain version at "
                             f"{bad} of {hi.numel()} pairs")
    print(f"phase 6: {name} ({hi.shape[0] // rows} tiles of {rows} rows, "
          f"{stages} stages, dmin {dmin}): kernel == plain")
    return max(int((got[0].long() - plain[0]).abs().max()),
               int((got[1].long() - plain[1]).abs().max()))


def check_q3(rows, oracle):
    """SQL Q3's top 10 against the oracle's ordered groups, tie-aware:
    every row must carry its group's exact values, and the rows' sort
    keys must be the oracle's first ten; which of several groups with
    the cut's revenue and date made it in is free."""
    epoch = datetime.date(1970, 1, 1)
    by_key = {k: (rev, day, prio) for k, rev, day, prio in oracle}
    want = oracle[:10]
    if len(rows) != len(want) or len({r[0] for r in rows}) != len(rows):
        raise AssertionError(f"Q3: {len(rows)} rows, oracle has "
                             f"{len(want)} of {len(oracle)} groups")
    for row, (_, rev, day, _) in zip(rows, want):
        key, got_rev, got_date, got_prio = row
        o_rev, o_day, o_prio = by_key[key]
        exact = (decimal.Decimal(o_rev).scaleb(-4),
                 epoch + datetime.timedelta(days=o_day), o_prio)
        if (got_rev, got_date, got_prio) != exact \
                or (o_rev, o_day) != (rev, day):
            raise AssertionError(f"Q3: SQL row {row} != oracle {exact}; "
                                 f"this rank holds {(rev, day)}")


def on_card(results, phase):
    for res in results:
        tensors = [res.batch.sel] + [t for c in res.batch.columns
                                     for t in c if t is not None]
        if any(t.device.type != "cuda" for t in tensors):
            raise AssertionError(f"{phase}: a result tensor is off the card")


def profile_sql(con, sql, name, runs=3, fetch=True):
    """--profile: torch.profiler over `runs` warm queries; prints the
    host's wall time, the device's busy time and the top device ops.
    Without `fetch` the result stays on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def query():
        res = con.execute(sql)
        if fetch:
            res.fetchall()

    with profile(activities=acts):      # the first profile starts the tracer
        query()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(runs):
            query()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    dev = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {name}: {runs} queries, wall {wall:.2f} ms (profiler "
          f"on), device busy {dev:.2f} ms in {sum(e.count for e in kernels)}"
          f" kernels and copies, share {dev / wall:.3f}")
    print(avgs.table(sort_by="self_device_time_total", row_limit=14,
                     max_name_column_width=48))


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


def check_q1_port_cases(F, port_cases, port_case_inputs, dev):
    """Phase 3: the Q1 kernel == plain version == numpy oracle on its own
    edge cases; returns the largest absolute difference (0)."""
    worst = 0
    for case in port_cases:
        name, _, offsets, cut, blocks = case
        cols, t = port_case_inputs(case, dev)
        off16 = [x.data_ptr() % 16 for x in t]
        if off16 != [4 * k for k in offsets]:
            raise AssertionError(f"{name}: columns lie {off16} bytes off a "
                                 f"16-byte boundary, wanted offsets {offsets}")
        got = F.q1_fused_aggregate(*t, cut, blocks=blocks)
        plain = F.q1_fused_aggregate_plain(*t, cut)
        want = torch.from_numpy(F.reference_sums(*cols, cut)).to(dev)
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and torch.equal(got, want)):
            raise AssertionError(f"{name}: kernel {got.tolist()} != plain "
                                 f"{plain.tolist()} / oracle {want.tolist()}")
        worst = max(worst, int((got - plain).abs().max()))
        print(f"phase 3: {name} ({cols[0].shape[0]} rows, columns "
              f"{off16} bytes off alignment, blocks "
              f"{'one wave' if blocks is None else blocks}): kernel == "
              "plain == oracle")
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


def host_sync_sites(fn) -> list:
    """Where fn makes the host wait for the device (`.item()`,
    `nonzero`, copies between host and device), as torch's sync debug
    mode reports them: one "file:line" of this repository a wait."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def count_host_syncs(fn) -> int:
    return len(host_sync_sites(fn))


def time_query(con, sql, dev):
    """One statement on the card: execute() and a device synchronisation,
    the result left on the card.  Returns the first run's ms, the warm
    runs' ms, the peak device memory in bytes, the host synchronisations
    of one run, the result's live rows and the rows the host aggregates
    fetched in one run."""
    from ddb_tpu_torch.bench import cmpx_probe
    from ddb_tpu_torch.plan import physical

    def run():
        res = con.execute(sql)
        torch.cuda.synchronize()
        return res

    torch.cuda.reset_peak_memory_stats(dev)
    fetched = physical.HOST_AGG_STATS["rows_fetched"]
    t0 = time.perf_counter()
    res = run()
    first = (time.perf_counter() - t0) * 1e3
    fetched = physical.HOST_AGG_STATS["rows_fetched"] - fetched
    on_card([res], sql[:40])
    live = int(res.batch.count)
    del res
    times = cmpx_probe.times_ms(run, WARM_RUNS)
    peak = torch.cuda.max_memory_allocated(dev)
    syncs = count_host_syncs(lambda: con.execute(sql))
    return first, times, peak, syncs, live, fetched


def check_sample(name, rows, table_rows):
    """SAMPLE 1 PERCENT's (count, sum of ResolutionWidth): the count
    within 5 standard deviations of the binomial mean, the sum between
    the column's bounds."""
    (cnt, total), = rows
    dev5 = 5 * (table_rows * 0.01 * 0.99) ** 0.5
    if abs(cnt - table_rows * 0.01) > dev5 \
            or not 800 * cnt <= total < 2560 * cnt:
        raise AssertionError(f"{name}: sample of {cnt} rows, sum {total}, "
                             f"from {table_rows} rows")


def check_h2oai_full(con, H, dev):
    """Phase 10's checks at full size, on the card: q8's rows are at most
    two a group and hold each group's max(v3); q6 has K * K groups."""
    r8 = con.execute(H.QUERIES[8]).batch
    rmax = con.execute("SELECT id6, max(v3) AS m FROM x_group "
                       "GROUP BY id6").batch
    id6 = r8.columns[0].data[r8.sel].to(torch.int64)
    v3 = r8.columns[1].data[r8.sel]
    gid = rmax.columns[0].data[rmax.sel].to(torch.int64)
    gmax = rmax.columns[1].data[rmax.sel]
    size = int(gid.max()) + 1
    per_group = torch.bincount(id6, minlength=size)
    top = torch.full((size,), float("-inf"), dtype=torch.float64, device=dev
                     ).scatter_reduce_(0, id6, v3, "amax")
    if int(per_group.max()) > 2 or not torch.equal(top[gid], gmax) \
            or int((per_group > 0).sum()) != gid.shape[0]:
        raise AssertionError("q8 at full size: rows do not hold each "
                             "group's max(v3), or a group has over 2 rows")
    groups6 = int(con.execute(H.QUERIES[6]).batch.count)
    if groups6 != H2OAI_K * H2OAI_K:
        raise AssertionError(f"q6 at full size: {groups6} groups")
    return id6.shape[0], gid.shape[0], groups6


def same_value(want, got, atol=0.0) -> bool:
    """Floats to FLOAT_RTOL relative or atol (NaN equals NaN), everything
    else exactly and of the same type; lists, tuples and dicts element by
    element."""
    if isinstance(want, float) and isinstance(got, float):
        return (math.isnan(want) and math.isnan(got)) \
            or math.isclose(want, got, rel_tol=FLOAT_RTOL, abs_tol=atol)
    if isinstance(want, (list, tuple)) and type(want) is type(got):
        return len(want) == len(got) \
            and all(same_value(w, g, atol) for w, g in zip(want, got))
    if isinstance(want, dict) and isinstance(got, dict):
        return list(want) == list(got) \
            and all(same_value(want[k], got[k], atol) for k in want)
    return type(want) is type(got) and want == got


def first_difference(want_rows, got_rows, atol=0.0):
    """None when two fetchall() lists agree (`same_value`), else a short
    description of the first difference."""
    if len(want_rows) != len(got_rows):
        return f"{len(want_rows)} rows against {len(got_rows)}"
    for i, (w, g) in enumerate(zip(want_rows, got_rows)):
        if not same_value(w, g, atol):
            return f"row {i}: {w!r} against {g!r}"
    return None


def same_rows(name, want, got, atol=0.0):
    """Rows of two executors: equal, floats to 1e-12 relative."""
    diff = first_difference(want, got, atol)
    if diff is not None:
        raise AssertionError(f"{name}: the card's rows differ from the "
                             f"CPU's: {diff}")


LAYERS = ("api", "frontend", "exec", "storage")


def layer_split(fn):
    """(wall seconds, {layer: seconds} with "host" the rest, host
    synchronisations of the package) of one call, run under
    torch.profiler.  A layer's time is the host time inside the
    program's ddb.<layer>.* spans less that of the ddb spans nested in
    them; the device is not synchronised, so a layer holds the waits
    for the device that fall inside it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        sites = host_sync_sites(fn)
        wall = time.perf_counter() - t0
    split = dict.fromkeys(LAYERS, 0.0)

    def visit(ev, outer):
        layer = outer
        if ev.name.startswith("ddb."):
            layer = ev.name.split(".")[1]
            split[layer] = split.get(layer, 0.0) + ev.cpu_time_total / 1e6
            if outer is not None:
                split[outer] -= ev.cpu_time_total / 1e6
        for child in ev.cpu_children:
            visit(child, layer)

    for ev in prof.events():
        if ev.cpu_parent is None:
            visit(ev, None)
    split["host"] = wall - sum(split.values())
    syncs = sum(not s.startswith("chip_smoke.py") for s in sites)
    return wall, split, syncs


def resident_bytes(td) -> int:
    """Bytes of a table's cached device batches."""
    return sum(t.numel() * t.element_size()
               for b in td._device_batches.values()
               for t in [b.sel] + [x for c in b.columns for x in c
                                   if x is not None])


def dml_phase(con, host, dev, card, sf=10, chunk=1500):
    """Phase 16: TPC-H's refresh functions and the ACID transaction on
    phase 7's resident tables; Q3 and Q4 afterwards against the numpy
    oracles over the columns with the same changes.  Returns the printed
    rows of times, for the record, and the Q3 and Q4 rows that equal the
    oracles."""
    import ddb_tpu_torch
    from ddb_tpu_torch.bench import cmpx_probe, tpch
    from ddb_tpu_torch.expr import ir
    from ddb_tpu_torch.expr.compile import select_mask
    from ddb_tpu_torch import types as PT

    epoch = datetime.date(1970, 1, 1)
    tables = ("customer", "orders", "lineitem")
    rf = tpch.synth_refresh(host, sf, seed=7)
    n_new = len(rf["orders"]["o_orderkey"])
    tpch.register_synth_tables(con, {"rf1_lineitem": rf["lineitem"]})
    stats = {}       # statement kind -> [(wall, split, syncs)]

    def timed(kind, fn):
        rec = layer_split(fn)
        stats.setdefault(kind, []).append(rec)
        return rec

    def first_query(label):
        """Q4 right after a mutation: its uploads are the re-upload."""
        wall, split, _ = timed("q4 after " + label,
                               lambda: con.execute(
                                   tpch.TPCH_QUERIES[4]).fetchall())
        print(f"phase 16: first query after {label}: Q4 in {wall:.3f} s, "
              f"of it {split['storage']:.3f} s re-uploading "
              f"[{card}]")

    timed("create index", lambda: con.execute(
        "CREATE INDEX lineitem_ok ON lineitem(l_orderkey)"))
    # ---- RF1 in one transaction ---------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    timed("begin", lambda: con.execute("BEGIN"))
    o = rf["orders"]
    cols = [o[c].tolist() for c in o]

    def append_orders():
        with con.appender("orders") as app:
            for k, c, day, p, s in zip(*cols):
                app.append_row(k, c, epoch + datetime.timedelta(days=day),
                               tpch.ORDERPRIORITIES[p], s)

    timed("rf1 appender (orders)", append_orders)
    timed("rf1 insert select (lineitem)", lambda: con.execute(
        "INSERT INTO lineitem SELECT * FROM rf1_lineitem"))
    txn_peak = torch.cuda.max_memory_allocated(dev)
    timed("commit", lambda: con.execute("COMMIT"))
    print(f"phase 16: RF1 inserted {n_new} orders and "
          f"{len(rf['lineitem']['l_orderkey'])} lines in one "
          f"transaction; peak {txn_peak / 2**30:.2f} GiB on the card "
          f"inside it, {(txn_peak - base) / 2**30:.2f} GiB above the "
          f"resident tables [{card}]")
    first_query("RF1")

    # ---- RF2: literal IN lists ----------------------------------------
    keys = rf["delete_keys"].tolist()
    td = con.catalog.get_table("lineitem")
    probe = ir.InList(ir.ColRef(0, PT.INTEGER), keys[:chunk])
    b = td.device_batch(device=dev)
    d = b.columns[0].data

    def loop():
        acc = torch.zeros_like(b.sel)
        for v in keys[:chunk]:
            acc = acc | (d == v)
        return acc & b.sel

    got, want = select_mask(probe, b), loop()
    if not torch.equal(got, want):
        raise AssertionError("phase 16: the IN-list search != the loop")
    search_ms = cmpx_probe.time_ms(lambda: select_mask(probe, b), runs=3)
    loop_ms = cmpx_probe.time_ms(loop, runs=3)
    print(f"phase 16: l_orderkey IN ({chunk} keys) over {td.num_rows} "
          f"rows ({b.capacity} slots): sorted search {search_ms:.4f} "
          f"ms, the loop of two passes a value {loop_ms:.4f} ms "
          f"[{card}]")
    del b, d, got, want
    for lo in range(0, len(keys), chunk):
        inlist = ", ".join(map(str, keys[lo:lo + chunk]))
        for t, col in (("lineitem", "l_orderkey"),
                       ("orders", "o_orderkey")):
            timed(f"rf2 delete ({t})", lambda: con.execute(
                f"DELETE FROM {t} WHERE {col} IN ({inlist})"))
    first_query("RF2")

    # ---- the ACID transactions, then one that rolls back ---------------
    count_sql = ("SELECT (SELECT count(*) FROM orders), count(*), "
                 "sum(l_extendedprice) FROM lineitem")
    # the first transaction starts with lineitem resident (the Q4
    # above read it): its clone reads the same batch
    lineitem_bytes = resident_bytes(con.catalog.get_table("lineitem"))
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for i, (k, delta) in enumerate(rf["acid"]):
        timed("begin", lambda: con.execute("BEGIN"))
        timed("point select (index)", lambda: con.execute(
            f"SELECT l_extendedprice, l_discount FROM lineitem "
            f"WHERE l_orderkey = {k}").fetchall())
        timed("update of one order", lambda: con.execute(
            f"UPDATE lineitem SET l_extendedprice = l_extendedprice "
            f"+ {delta / 100:.2f} WHERE l_orderkey = {k}"))
        if i == 0:
            peak = torch.cuda.max_memory_allocated(dev)
            print(f"phase 16: peak inside the first ACID transaction "
                  f"{(peak - base) / 2**30:.2f} GiB above the resident "
                  f"tables; lineitem's batch, which a clone of its own "
                  f"would upload again, holds "
                  f"{lineitem_bytes / 2**30:.2f} GiB [{card}]")
        timed("commit", lambda: con.execute("COMMIT"))
    first_query("the ACID transactions")
    before = con.execute(count_sql).fetchall()
    k0 = rf["acid"][0][0]
    con.execute("BEGIN")
    con.execute(f"UPDATE lineitem SET l_extendedprice = 0 "
                f"WHERE l_orderkey = {k0}")
    con.execute(f"DELETE FROM orders WHERE o_orderkey = {k0}")
    inside = con.execute(count_sql).fetchall()
    timed("rollback", lambda: con.execute("ROLLBACK"))
    after_rollback = con.execute(count_sql).fetchall()
    if inside == before or after_rollback != before:
        raise AssertionError(f"phase 16: ROLLBACK: {before} before, "
                             f"{inside} inside, {after_rollback} after")

    # ---- the answers against the oracles -------------------------------
    t0 = time.perf_counter()
    after = tpch.apply_refresh_numpy(host, rf, rf["delete_keys"], rf["acid"])
    rows3 = con.execute(tpch.TPCH_QUERIES[3]).fetchall()
    rows4 = con.execute(tpch.TPCH_QUERIES[4]).fetchall()
    n_orders, n_lines, _ = before[0]
    want_counts = (len(after["orders"]["o_orderkey"]),
                   len(after["lineitem"]["l_orderkey"]))
    if (n_orders, n_lines) != want_counts:
        raise AssertionError(f"phase 16: counts {(n_orders, n_lines)} != "
                             f"oracle {want_counts}")
    check_q3(rows3, tpch.q3_oracle(after))
    oracle4 = tpch.q4_oracle(after)
    if rows4 != oracle4 or not rows4:
        raise AssertionError(f"phase 16: Q4 {rows4} != oracle {oracle4}")
    print(f"phase 16: after RF1, RF2 and {len(rf['acid'])} ACID "
          f"transactions Q3 and Q4 equal the numpy oracles exactly; orders "
          f"{n_orders}, lineitem {n_lines} rows equal the oracle's counts; "
          f"the ROLLBACK left them unchanged ({time.perf_counter() - t0:.1f}"
          f" s)")

    # ---- residency -------------------------------------------------------
    torch.cuda.synchronize()
    resident = {}
    for t in tables:
        td = con.catalog.get_table(t)
        if len(td._device_batches) != 1:
            raise AssertionError(f"phase 16: {t} is resident "
                                 f"{len(td._device_batches)} times")
        resident[t] = resident_bytes(td)
    allocated = torch.cuda.memory_allocated(dev)
    tables_bytes = sum(resident.values())
    mutated = resident["orders"] + resident["lineitem"]
    if allocated - tables_bytes > 0.1 * mutated:
        raise AssertionError(
            f"phase 16: {allocated / 2**30:.2f} GiB allocated, the tables "
            f"hold {tables_bytes / 2**30:.2f} GiB: more than 10 % of the "
            f"mutated tables' copy left over")
    print(f"phase 16: each table resident once; {allocated / 2**30:.3f} GiB "
          f"allocated, the three tables' batches "
          f"{tables_bytes / 2**30:.3f} GiB [{card}]")

    # ---- times -----------------------------------------------------------
    rows = []
    for kind, recs in stats.items():
        walls = [w for w, _, _ in recs]
        med = statistics.median(walls)
        split = {k: statistics.median(s[k] for _, s, _ in recs)
                 for k in LAYERS + ("host",)}
        syncs = statistics.median(n for _, _, n in recs)
        rows.append((kind, len(recs), med, split, syncs))
        print(f"phase 16: {kind}: {med * 1e3:.1f} ms median of {len(recs)} "
              f"(min {min(walls) * 1e3:.1f}, max {max(walls) * 1e3:.1f}); "
              + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in split.items())
              + f" ms; {syncs:g} host synchronisations [{card}]")
    return rows, rows3, rows4


# ---------------------------------------------------------------------------
# phase 17: out-of-core execution at the reference's defaults
# ---------------------------------------------------------------------------

RESIDENT_THRESHOLD = 1 << 40      # above every table: the resident path
# TPC-H SF30 lineitem's cardinality: 17c drew SF100's 600,037,902 rows
# until phase 22 needed its time within the script's limit
SF30_LINEITEM_ROWS = 179_998_372
STREAM_PEAK_BYTES = 4 * 2**30       # a streamed statement's ceiling
KERNEL_CHUNK = 1 << 25              # rows a piece of the kernels' inputs


def mem_available_gib() -> float:
    """The host's MemAvailable from /proc/meminfo, GiB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 2**20
    raise AssertionError("no MemAvailable in /proc/meminfo")


def resident_path(con, phase, rows):
    """Set external_threshold_rows above the phase's tables, so that it
    times the resident path as before out-of-core execution was ported."""
    con.execute(f"SET external_threshold_rows = {RESIDENT_THRESHOLD}")
    print(f"phase {phase}: external_threshold_rows = {RESIDENT_THRESHOLD} "
          f"(above the tables' {rows} rows): the resident path")


def default_path(con):
    """The reference's defaults: external_threshold_rows and tile_rows as
    config.py sets them, and no memory limit."""
    from ddb_tpu_torch.config import SETTINGS
    for s in SETTINGS:
        if s.name in ("external_threshold_rows", "tile_rows"):
            con.execute(f"SET {s.name} = {s.default}")
    con.execute("SET memory_limit = 'unlimited'")
    return {s.name: s.default for s in SETTINGS
            if s.name in ("external_threshold_rows", "tile_rows")}


class EntryPoints:
    """Which out-of-core entry point of plan/tiled.py took each statement
    while entered, read by wrapping its four execute_* functions."""

    NAMES = ("execute_tiled", "execute_tiled_topn", "execute_tiled_sort",
             "execute_external_join")

    def __enter__(self):
        from ddb_tpu_torch.plan import tiled
        self.taken, self._saved = [], []
        for name in self.NAMES:
            fn = getattr(tiled, name)
            self._saved.append((name, fn))

            def wrapped(*args, _fn=fn, _name=name):
                res = _fn(*args)
                if res is not None:
                    self.taken.append(_name)
                return res
            setattr(tiled, name, wrapped)
        return self

    def __exit__(self, *exc):
        from ddb_tpu_torch.plan import tiled
        for name, fn in self._saved:
            setattr(tiled, name, fn)

    def run(self, fn):
        """(fn(), the entry point that took the statement fn runs)."""
        self.taken.clear()
        out = fn()
        return out, self.taken[-1] if self.taken else "in memory"


def stream_stats():
    from ddb_tpu_torch.plan import tiled
    return dict(tiled.STREAM_STATS)


def stream_delta(before):
    after = stream_stats()
    return {k: after[k] - before[k] for k in after}


def busy_ms(fn):
    """(host-to-device copy ms, other device ms) of one call as
    torch.profiler sees the card: the copies are the copy stream's
    work, the rest (kernels, the partials' copies back) the compute
    stream's.  None when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):      # the first profile starts the tracer
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    copy = other = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        if "HtoD" in e.name:
            copy += us
        else:
            other += us
    return None if copy + other == 0 else (copy / 1e3, other / 1e3)


def h2d_probe(dev, card, nbytes=1 << 30, reps=5):
    """Phase 17a: host-to-device rates, GB/s: from a page-locked buffer
    (the bound of every streamed statement), from pageable memory, from
    a numpy array registered in place with cudaHostRegister, and the
    host's copy into a page-locked buffer (the staging route), with the
    registration's own rate."""
    n = nbytes // 8
    host = np.arange(n, dtype=np.int64)
    d = torch.empty(n, dtype=torch.int64, device=dev)
    pinned = torch.empty(n, dtype=torch.int64, pin_memory=True)
    src = torch.from_numpy(host)

    def rate(fn):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return nbytes / best / 1e9

    out = {"pinned": rate(lambda: d.copy_(pinned, non_blocking=True)),
           "pageable": rate(lambda: d.copy_(src)),
           "staging": rate(lambda: pinned.copy_(src))}
    cr = torch.cuda.cudart()
    t0 = time.perf_counter()
    if int(cr.cudaHostRegister(host.ctypes.data, nbytes, 0)) != 0:
        raise AssertionError("phase 17a: cudaHostRegister failed")
    out["register"] = nbytes / (time.perf_counter() - t0) / 1e9
    out["registered"] = rate(lambda: d.copy_(src, non_blocking=True))
    cr.cudaHostUnregister(host.ctypes.data)
    if not all(v > 0 for v in out.values()):
        raise AssertionError(f"phase 17a: probe rates {out}")
    print(f"phase 17a: host to device over {nbytes / 1e9:.2f} GB, best of "
          f"{reps}: page-locked {out['pinned']:.2f} GB/s, registered in "
          f"place {out['registered']:.2f} GB/s, pageable "
          f"{out['pageable']:.2f} GB/s; the host's copy into a page-locked "
          f"buffer {out['staging']:.2f} GB/s on {torch.get_num_threads()} "
          f"threads; cudaHostRegister {out['register']:.2f} GB/s [{card}]")
    return out


def streamed_statement(con, sql, label, dev, card, rate, runs=3):
    """One statement at the defaults on a table that is not resident: a
    first run (the first streamed statement over a table registers its
    columns), then `runs` timed runs, each with its stream statistics
    and peak device memory.  Returns (rows, the record of the run of
    median wall time)."""
    t0 = time.perf_counter()
    rows = con.execute(sql).fetchall()
    first = (time.perf_counter() - t0) * 1e3
    recs = []
    for _ in range(runs):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = stream_stats()
        t0 = time.perf_counter()
        again = con.execute(sql).fetchall()
        wall = (time.perf_counter() - t0) * 1e3
        st = stream_delta(before)
        recs.append({"ms": wall, "first_ms": first,
                     "peak": torch.cuda.max_memory_allocated(dev) - base,
                     "bound_ms": st["bytes"] / (rate * 1e9) * 1e3, **st})
        if again != rows:
            raise AssertionError(f"phase 17{label}: a second run gave "
                                 f"other rows")
    rec = sorted(recs, key=lambda r: r["ms"])[len(recs) // 2]
    rec["max_peak"] = max(r["peak"] for r in recs)
    rec["all_ms"] = [r["ms"] for r in recs]
    both = rec["copy_ms"] + rec["compute_ms"]
    print(f"phase 17{label}: {rec['ms']:.4f} ms median of {runs} "
          f"({', '.join(f'{r:.1f}' for r in rec['all_ms'])}; first run "
          f"{first:.1f}); {rec['tiles']} tiles, {rec['bytes'] / 1e9:.3f} GB "
          f"to the card, {rec['bytes'] / (rec['ms'] / 1e3) / 1e9:.2f} GB/s "
          f"of wall time; copy stream busy {rec['copy_ms']:.1f} ms, compute "
          f"stream from each tile's arrival to its partial on the host "
          f"{rec['compute_ms']:.1f} ms, sum {both:.1f} ms, wall "
          f"{rec['ms'] / both:.3f} of the sum; host staging "
          f"{rec['staging_s'] * 1e3:.1f} ms; bound {rec['bound_ms']:.1f} ms "
          f"(bytes / {rate:.2f} GB/s); peak {rec['max_peak'] / 2**30:.3f} "
          f"GiB above the allocation before it [{card}]")
    return rows, rec


def streamed_sf10(con, td, dev, card, F, sums, rev, ms, rate):
    """Phases 17b and 17f on phase 4's SF10 lineitem (59,986,052 rows):
    Q1 and Q6 streamed at the defaults must equal the kernels exactly;
    an ORDER BY keeping about 1 % of the rows and a LIMIT 20000 take
    the tiled sort and TopN and equal the resident rows."""
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    defaults = default_path(con)
    print(f"phase 17b: lineitem {td.num_rows} rows at the defaults {defaults}")
    with EntryPoints() as ep:
        rows1, e1 = ep.run(lambda: con.execute(TPCH_QUERIES[1]).fetchall())
        rows6, e6 = ep.run(lambda: con.execute(TPCH_QUERIES[6]).fetchall())
        if (e1, e6) != ("execute_tiled", "execute_tiled"):
            raise AssertionError(f"phase 17b: Q1 took {e1}, Q6 {e6}")
        check_q1(rows1, sums, F)
        if rows6 != [(decimal.Decimal(rev).scaleb(-4),)]:
            raise AssertionError(f"phase 17b: streamed Q6 {rows6} != kernel")
        print("phase 17b: streamed SQL Q1 and Q6 equal the kernels exactly")
        for q in (1, 6):
            _, rec = streamed_statement(con, TPCH_QUERIES[q], f"b: SF10 Q{q}",
                                        dev, card, rate)
            ms[f"sf10_streamed_q{q}"] = rec["ms"]
            print(f"phase 17b: SF10 Q{q} streamed {rec['ms']:.4f} ms against "
                  f"{ms[f'sql_q{q}']:.4f} ms resident (phase 5) [{card}]")

        # l_extendedprice is uniform on [900.00, 105000.00)
        sort_sql = ("SELECT l_extendedprice, l_shipdate FROM lineitem WHERE "
                    "l_extendedprice < 1941 ORDER BY l_extendedprice, "
                    "l_shipdate")
        topn_sql = ("SELECT l_extendedprice, l_shipdate FROM lineitem ORDER BY "
                    "l_extendedprice DESC, l_shipdate LIMIT 20000")
        for name, sql, want in (("sort", sort_sql, "execute_tiled_sort"),
                                ("LIMIT 20000", topn_sql,
                                 "execute_tiled_topn")):
            t0 = time.perf_counter()
            got, entry = ep.run(lambda: con.execute(sql).fetchnumpy())
            t_ext = (time.perf_counter() - t0) * 1e3
            con.execute(f"SET external_threshold_rows = {RESIDENT_THRESHOLD}")
            t0 = time.perf_counter()
            res = con.execute(sql).fetchnumpy()
            t_res = (time.perf_counter() - t0) * 1e3
            con.execute(f"SET external_threshold_rows = "
                        f"{defaults['external_threshold_rows']}")
            n = len(got["l_extendedprice"])
            if entry != want or not n or list(got) != list(res) or not all(
                    np.array_equal(got[k], res[k]) for k in got):
                raise AssertionError(f"phase 17f: {name} took {entry}, "
                                     f"{n} rows, against the resident rows")
            print(f"phase 17f: {name} took {entry} and equals the resident "
                  f"rows ({n} rows, {100 * n / td.num_rows:.2f} % of the "
                  f"table): {t_ext:.1f} ms streamed, {t_res:.1f} ms resident "
                  f"[{card}]")
    con.execute(f"SET external_threshold_rows = {RESIDENT_THRESHOLD}")


def sf30_phase(dev, card, F, rate):
    """Phase 17c: TPC-H SF30's lineitem (179,998,372 rows, 7.9 GB) on
    the host, never resident on the card.  The kernels run over int32
    inputs built piece by piece from the host columns, then SQL Q1 and
    Q6 stream in 22 tiles each and must equal them exactly."""
    import ddb_tpu_torch
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES, register_synth_lineitem
    print(f"phase 17c: MemAvailable {mem_available_gib():.1f} GiB before "
          f"the table")
    t0 = time.perf_counter()
    con = register_synth_lineitem(ddb_tpu_torch.connect(device="cuda"),
                                  SF30_LINEITEM_ROWS, seed=0)
    defaults = default_path(con)
    td = con.catalog.get_table("lineitem")
    n = td.num_rows
    host = sum(c.data.nbytes for c in td.columns)
    print(f"phase 17c: lineitem {n} rows ({host / 1e9:.2f} GB on the host) "
          f"drawn in {time.perf_counter() - t0:.1f} s; MemAvailable "
          f"{mem_available_gib():.1f} GiB; defaults {defaults}")

    # the kernels' int32 inputs, piece by piece from the host columns
    t0 = time.perf_counter()
    col = {c.name: c.data for c in td.columns}
    kin = {k: torch.empty(n, dtype=torch.int32, device=dev)
           for k in ("qty", "ext", "disc", "tax", "ship", "gid")}
    for lo in range(0, n, KERNEL_CHUNK):
        hi = min(lo + KERNEL_CHUNK, n)

        def up(name):
            return torch.from_numpy(col[name][lo:hi]).to(dev)
        kin["qty"][lo:hi] = torch.div(up("l_quantity"), 100,
                                      rounding_mode="floor")
        kin["ext"][lo:hi] = up("l_extendedprice")
        kin["disc"][lo:hi] = up("l_discount")
        kin["tax"][lo:hi] = up("l_tax")
        kin["ship"][lo:hi] = up("l_shipdate")
        kin["gid"][lo:hi] = up("l_returnflag") * 2 + up("l_linestatus")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sums = F.q1_fused_aggregate(*[kin[c] for c in ("qty", "ext", "disc",
                                                   "tax", "ship", "gid")],
                                Q1_CUTOFF).cpu().numpy()
    rev = int(F.q6_fused_filter_sum(kin["qty"], kin["ext"], kin["disc"],
                                    kin["ship"], Q6_CUT))
    del kin
    torch.cuda.empty_cache()
    print(f"phase 17c: the kernels' inputs ({n * 24 / 1e9:.1f} GB of int32) "
          f"built in {build_s:.1f} s, both kernels run, inputs freed; "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated")

    recs = {}
    with EntryPoints() as ep:
        (rows1, recs[1]), e1 = ep.run(lambda: streamed_statement(
            con, TPCH_QUERIES[1], "c: SF30 Q1", dev, card, rate))
        (rows6, recs[6]), e6 = ep.run(lambda: streamed_statement(
            con, TPCH_QUERIES[6], "c: SF30 Q6", dev, card, rate))
    check_q1(rows1, sums, F)
    if rows6 != [(decimal.Decimal(rev).scaleb(-4),)] or rev <= 0:
        raise AssertionError(f"phase 17c: Q6 {rows6} != kernel {rev}")
    ntiles = -(-n // defaults["tile_rows"])
    if (e1, e6) != ("execute_tiled", "execute_tiled") \
            or {recs[1]["tiles"], recs[6]["tiles"]} != {ntiles} \
            or td._device_batches:
        raise AssertionError(f"phase 17c: Q1 took {e1} ({recs[1]['tiles']} "
                             f"tiles), Q6 {e6}; lineitem "
                             f"resident {bool(td._device_batches)}")
    for q, rec in recs.items():
        if rec["max_peak"] >= STREAM_PEAK_BYTES:
            raise AssertionError(f"phase 17c: Q{q} peaked "
                                 f"{rec['max_peak'] / 2**30:.2f} GiB above "
                                 f"the allocation before it")
    print(f"phase 17c: streamed SQL Q1 and Q6 over {n} rows in {ntiles} "
          f"tiles equal the kernels exactly; lineitem never resident on the "
          f"card; peaks "
          f"{recs[1]['max_peak'] / 2**30:.3f} and "
          f"{recs[6]['max_peak'] / 2**30:.3f} "
          f"GiB above the allocation before each")
    busy = busy_ms(lambda: con.execute(TPCH_QUERIES[1]).fetchall())
    if busy is None:
        print("phase 17c: the profiler recorded no device time: the "
              "device's busy time not measured")
    else:
        print(f"phase 17c: SF30 Q1 under torch.profiler: host-to-device "
              f"copies {busy[0]:.1f} ms, every other device operation "
              f"{busy[1]:.1f} ms, against the unprofiled wall "
              f"{recs[1]['ms']:.1f} ms [{card}]")
    del con, td
    return recs


def same_result(name, want, got):
    """Two results on the card: the same live rows in the same order,
    integers exactly, floats to FLOAT_RTOL relative."""
    if want.schema.names != got.schema.names:
        raise AssertionError(f"{name}: columns {got.schema.names}")
    ws, gs = want.batch.sel, got.batch.sel
    if int(ws.sum()) != int(gs.sum()):
        raise AssertionError(f"{name}: {int(gs.sum())} rows against "
                             f"{int(ws.sum())}")
    for f, a, b in zip(want.schema.fields, want.batch.columns,
                       got.batch.columns):
        x, y = a.data[ws], b.data[gs]
        na = None if a.nulls is None else a.nulls[ws]
        nb = None if b.nulls is None else b.nulls[gs]
        if (na is None) != (nb is None) and bool(
                (na if na is not None else nb).any()):
            raise AssertionError(f"{name}.{f.name}: NULLs differ")
        if x.is_floating_point():
            ok = torch.isclose(x, y, rtol=FLOAT_RTOL, atol=0.0,
                               equal_nan=True).all()
        else:
            ok = torch.equal(x, y)
        if not bool(ok):
            raise AssertionError(f"{name}.{f.name}: values differ")


def streamed_h2oai(con, H, dev, card, ms, resident):
    """Phase 17d: the h2oai suite at the defaults on phase 10's table:
    q1-q5, q7 and q10 stream in 12 tiles, q6, q8 and q9 stay resident;
    every result equals phase 10's."""
    from ddb_tpu_torch.bench import cmpx_probe
    n = con.catalog.get_table("x_group").num_rows
    defaults = default_path(con)
    ntiles = -(-n // defaults["tile_rows"])
    want_tiled = {1, 2, 3, 4, 5, 7, 10}
    with EntryPoints() as ep:
        for q in sorted(H.QUERIES):
            sql = H.QUERIES[q]
            con.execute(f"SET external_threshold_rows = {RESIDENT_THRESHOLD}")
            mem = con.execute(sql)
            con.execute(f"SET external_threshold_rows = "
                        f"{defaults['external_threshold_rows']}")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = stream_stats()
            t0 = time.perf_counter()
            got, entry = ep.run(lambda: con.execute(sql))
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev) - base
            st = stream_delta(before)
            if (entry == "execute_tiled") != (q in want_tiled) or \
                    (q in want_tiled and st["tiles"] != ntiles):
                raise AssertionError(f"phase 17d: q{q} took {entry} in "
                                     f"{st['tiles']} tiles")
            same_result(f"phase 17d q{q}", mem, got)
            del mem, got
            t = statistics.median(cmpx_probe.times_ms(
                lambda: con.execute(sql), 2))
            ms[f"h2oai_streamed_q{q}"] = t
            print(f"phase 17d: h2oai q{q}: {entry}, {st['tiles']} tiles, "
                  f"{st['bytes'] / 1e9:.3f} GB to the card, copy stream "
                  f"{st['copy_ms']:.1f} ms, compute stream "
                  f"{st['compute_ms']:.1f} ms (first run); equals phase "
                  f"10's rows; {t:.4f} ms median of 2 (first run "
                  f"{first:.1f}) against {ms[f'h2oai_q{q}']:.4f} ms "
                  f"resident; peak {peak / 2**30:.2f} GiB above the "
                  f"allocation before it, the table's batch "
                  f"{resident / 2**30:.2f} GiB [{card}]")
    con.execute(f"SET external_threshold_rows = {RESIDENT_THRESHOLD}")


def memory_phase(con, dev, card, rows3, rows4, spill_limit="256MB"):
    """Phases 17e and 17g on phase 7's SF10 tables after phase 16.  17e:
    the entry points of Q3 and Q4 at the defaults; then under a
    memory_limit that makes their joins Grace-partitioned, both spill and
    equal the rows phase 16 held to the oracles.  17g: a memory_limit
    below the three tables' bytes; Q3 and Q4 alternately keep their rows
    and the BUFFER_CACHE row of duckdb_memory() stays within it."""
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    from ddb_tpu_torch.plan import tiled
    from ddb_tpu_torch.storage import buffer, tempmem
    defaults = default_path(con)
    want = {3: rows3, 4: rows4}
    with EntryPoints() as ep:
        for q in (3, 4):
            t0 = time.perf_counter()
            rows, entry = ep.run(
                lambda: con.execute(TPCH_QUERIES[q]).fetchall())
            t = (time.perf_counter() - t0) * 1e3
            if rows != want[q]:
                raise AssertionError(f"phase 17e: Q{q} at the defaults")
            print(f"phase 17e: Q{q} at the defaults {defaults} takes "
                  f"{entry}: {t:.1f} ms [{card}]")
        limit = spill_limit
        con.execute(f"SET memory_limit = '{limit}'")
        for q in (3, 4):
            joins = tiled.EXTERNAL_JOIN_STATS["joins"]
            parts = tiled.EXTERNAL_JOIN_STATS["partitions"]
            spilled = tempmem.FILES.stats()["bytes_spilled"]
            t0 = time.perf_counter()
            rows, entry = ep.run(
                lambda: con.execute(TPCH_QUERIES[q]).fetchall())
            t = (time.perf_counter() - t0) * 1e3
            dj = tiled.EXTERNAL_JOIN_STATS["joins"] - joins
            dbytes = tempmem.FILES.stats()["bytes_spilled"] - spilled
            if rows != want[q] or dj < 1 or dbytes <= 0:
                raise AssertionError(f"phase 17e: Q{q} under memory_limit "
                                     f"{limit}: {dj} external joins, "
                                     f"{dbytes} bytes spilled, rows "
                                     f"{'equal' if rows == want[q] else 'differ'}")
            print(f"phase 17e: Q{q} under memory_limit {limit}: {entry}, "
                  f"{dj} Grace-partitioned joins in "
                  f"{tiled.EXTERNAL_JOIN_STATS['partitions'] - parts} "
                  f"partitions, {dbytes / 1e9:.3f} GB spilled; equals the "
                  f"oracles' rows; {t:.1f} ms [{card}]")
    tempmem.FILES.cleanup()

    # the largest table and half of the others: below the three tables'
    # bytes (as the buffer manager counts them), above any one table
    held = [sum(c.data.nbytes + (c.nulls.nbytes if c.nulls is not None
                                 else 0)
                for c in con.catalog.get_table(t).columns)
            for t in ("customer", "orders", "lineitem")]
    total = sum(held)
    limit = max(held) + (total - max(held)) // 2
    con.execute(f"SET memory_limit = '{limit}'")
    evictions = buffer.MANAGER.evictions
    for i, q in enumerate((3, 4, 3, 4)):
        rows = con.execute(TPCH_QUERIES[q]).fetchall()
        # a text of its own each time: a cached plan would hold the
        # table function's first result
        (used, lim), = con.execute(
            f"SELECT memory_usage_bytes, memory_limit_bytes FROM "
            f"duckdb_memory() WHERE tag = 'BUFFER_CACHE' AND {i} = {i}"
        ).fetchall()
        if rows != want[q] or lim != limit or used > limit:
            raise AssertionError(f"phase 17g: Q{q}: BUFFER_CACHE {used} of "
                                 f"{lim}, rows "
                                 f"{'equal' if rows == want[q] else 'differ'}")
        print(f"phase 17g: Q{q} under memory_limit {limit} (the tables "
              f"hold {total} bytes): rows unchanged, BUFFER_CACHE {used} "
              f"bytes")
    print(f"phase 17g: {buffer.MANAGER.evictions - evictions} evictions")
    default_path(con)


# ---------------------------------------------------------------------------
# phase 18: durable databases and the client surface at SF10
# ---------------------------------------------------------------------------

# the WAL's mutations after the checkpoint: RF1's share of lineitem by
# INSERT ... SELECT, a DELETE of one day of l_shipdate and an UPDATE of
# l_discount over another day (both days in Q6's year and before Q1's
# cutoff), small enough that the WAL stays under wal_autocheckpoint
DURABLE_NEW_SEED = 2
DURABLE_DELETE_DAY = datetime.date(1994, 3, 1)
DURABLE_UPDATE_DAY = datetime.date(1994, 6, 1)
DURABLE_DISCOUNT = 5               # the UPDATE's l_discount, in cents
STREAM_LIMIT = 100_000
Q6_PREDICATE = ("l_shipdate >= date '1994-01-01' and l_shipdate < date "
                "'1995-01-01' and l_discount between 0.05 and 0.07 and "
                "l_quantity < 24")


def _days(d) -> int:
    return (d - datetime.date(1970, 1, 1)).days


def durable_lineitem(con, rows, new_rows):
    """Register synthetic lineitem of `rows` rows (seed 0) on `con`, as
    phase 4 does.  Returns the host columns: those of the table and those
    of the `new_rows` rows (seed 2) that durable_mutations inserts."""
    import ddb_tpu_torch
    from ddb_tpu_torch.bench.tpch import register_synth_lineitem
    register_synth_lineitem(con, rows, seed=0)
    new = register_synth_lineitem(ddb_tpu_torch.connect(device=con.device),
                                  new_rows, seed=DURABLE_NEW_SEED)
    td = con.catalog.get_table("lineitem")
    return {"base": {c.name: c.data for c in td.columns},
            "new": new.catalog.get_table("lineitem")}


def durable_mutations(con, host):
    """The WAL's three mutations on `con`, through execute(); returns
    each one's wall seconds.  The new rows' table is added to the catalog
    and dropped from it directly, so the WAL holds the three alone."""
    new = host["new"]
    new.name = "lineitem_new"
    con.catalog.add_table(new)
    secs = {}
    for kind, sql in (
            ("insert", "INSERT INTO lineitem SELECT * FROM lineitem_new"),
            ("delete", "DELETE FROM lineitem WHERE l_shipdate = date "
                       f"'{DURABLE_DELETE_DAY}'"),
            ("update", "UPDATE lineitem SET l_discount = "
                       f"{DURABLE_DISCOUNT / 100:.2f} WHERE l_shipdate = "
                       f"date '{DURABLE_UPDATE_DAY}'")):
        t0 = time.perf_counter()
        con.execute(sql).fetchall()
        secs[kind] = time.perf_counter() - t0
        if kind == "insert":
            con.catalog.drop_table("lineitem_new")
    return secs


def lineitem_oracle(host):
    """Q1's sums ([6, 8] int64, the kernel's layout), Q6's revenue (int,
    1e-4 units) and the row count of lineitem with the WAL's mutations
    applied in numpy."""
    from ddb_tpu_torch.ops import fused_agg as F
    new = {c.name: c.data for c in host["new"].columns}
    col = {k: np.concatenate([v, new[k]]) for k, v in host["base"].items()}
    keep = col["l_shipdate"] != _days(DURABLE_DELETE_DAY)
    col = {k: v[keep] for k, v in col.items()}
    disc = np.where(col["l_shipdate"] == _days(DURABLE_UPDATE_DAY),
                    DURABLE_DISCOUNT, col["l_discount"])
    qty = col["l_quantity"] // 100
    sums = F.reference_sums(
        qty, col["l_extendedprice"], disc, col["l_tax"], col["l_shipdate"],
        col["l_returnflag"] * 2 + col["l_linestatus"], Q1_CUTOFF)
    ship = col["l_shipdate"]
    m6 = ((ship >= Q6_CUT) & (ship < Q6_CUT + 365) & (disc >= 5)
          & (disc <= 7) & (qty < 24))
    rev = int((col["l_extendedprice"][m6] * disc[m6]).sum())
    return sums, rev, len(ship)


def q1_q6_rows(con, table="lineitem"):
    """SQL Q1's and Q6's rows over `table`."""
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    return tuple(con.execute(TPCH_QUERIES[q].replace(
        "from lineitem", f"from {table}")).fetchall() for q in (1, 6))


def check_q1_q6(label, rows, sums, rev):
    """SQL Q1 and Q6 rows against Q1 sums and a Q6 revenue, exactly."""
    from ddb_tpu_torch.ops import fused_agg as F
    rows1, rows6 = rows
    check_q1(rows1, sums, F)
    want6 = decimal.Decimal(rev).scaleb(-4)
    if rows6 != [(want6,)]:
        raise AssertionError(f"{label}: Q6 {rows6} != {want6}")


def live_counts(con, plan, dev):
    """{id(node): live rows} of every operator of `plan`, each subtree
    run alone on the device, unprofiled."""
    from ddb_tpu_torch.plan import physical
    out = {}

    def walk(node):
        _, b = physical.execute(node, dev)
        out[id(node)] = int(b.count)
        for c in node.children():
            walk(c)
    walk(plan)
    return out


def profile_checks(con, sql, dev):
    """18f for one statement: the profiled run's rows equal the plain
    run's; each operator's cardinality its unprofiled live count; the
    self times sum to no more than the wall time.  Returns the wall
    and the self times' sum, in seconds."""
    from ddb_tpu_torch.batch import bind_device
    from ddb_tpu_torch.plan import physical
    from ddb_tpu_torch.profiler import QueryProfiler
    from ddb_tpu_torch.sql import parser
    with bind_device(dev):
        plan = con._optimize(con._binder().bind_select(
            parser.parse(sql)[0]))
    prof = QueryProfiler()
    t0 = time.perf_counter()
    schema, b = physical.execute(plan, ctx=physical.ExecContext(
        dev, profiler=prof))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from ddb_tpu_torch.api import QueryResult
    rows = QueryResult(schema, b).fetchall()
    if rows != con.execute(sql).fetchall():
        raise AssertionError("phase 18f: profiled rows != plain rows")
    live = live_counts(con, plan, dev)
    for nid, p in prof.profiles.items():
        if p.cardinality != live[nid]:
            raise AssertionError(f"phase 18f: {p.name} recorded "
                                 f"{p.cardinality} rows, live {live[nid]}")
    if set(prof.profiles) != set(live):
        raise AssertionError("phase 18f: an operator was not profiled")

    def self_seconds(node):
        return prof.profiles[id(node)].seconds - sum(
            prof.profiles[id(c)].seconds for c in node.children())

    def walk(node):
        return [node] + [n for c in node.children() for n in walk(c)]

    selfs = sum(max(self_seconds(n), 0.0) for n in walk(plan))
    if selfs > wall:
        raise AssertionError(f"phase 18f: self times {selfs} s exceed the "
                             f"wall's {wall} s")
    return wall, selfs


def durable_phase(dev, card, launches):
    """Phase 18 on SF10 lineitem (59,986,052 rows): 18a CHECKPOINT into a
    new database file; 18e a redo transport before 18b; 18b the WAL's
    mutations and a crash; 18c recovery, Q1/Q6 against the kernels and a
    numpy oracle, streamed and resident; 18d ATTACH of the checkpoint;
    18e a follower from a copy of the 18a file; 18f EXPLAIN ANALYZE and
    enable_profiling; 18g stream() and the relation API.  Adds phase 18's
    kernel launches to `launches`."""
    import gc
    import shutil
    import tempfile
    import ddb_tpu_torch
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    from ddb_tpu_torch.ops import fused_agg as F
    from ddb_tpu_torch.plan import tiled
    from ddb_tpu_torch.redo import Follower

    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    work = tempfile.mkdtemp(prefix="ddb_tpu_torch_phase18_")
    try:
        free = shutil.disk_usage(work).free
        print(f"phase 18: working in a temporary directory with "
              f"{free / 1e9:.1f} GB free")
        path = os.path.join(work, "sf10.dtb")
        stream = os.path.join(work, "redo.stream")
        copy = os.path.join(work, "follower.dtb")

        # ---- 18a: CHECKPOINT into a database file that does not exist yet
        con = ddb_tpu_torch.connect(device="cuda", database=path)
        host = durable_lineitem(con, SF10_LINEITEM_ROWS, RF1_LINEITEM_ROWS)
        td = con.catalog.get_table("lineitem")
        raw = sum(c.data.nbytes for c in td.columns)
        t0 = time.perf_counter()
        con.execute("CHECKPOINT")
        ckpt_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"phase 18a: CHECKPOINT of lineitem ({td.num_rows} rows, "
              f"{len(td.columns)} columns): {ckpt_s:.2f} s")
        print(f"phase 18a: raw bytes {raw}, file bytes {size} "
              f"({size / raw:.3f} of raw)")
        print(f"phase 18a: {raw / ckpt_s / 1e6:.1f} MB/s of raw columns "
              f"[{card}]")
        shutil.copyfile(path, copy)
        ckpt_rows = q1_q6_rows(con)
        del td

        # ---- 18e (set-up) and 18b: the WAL's mutations, then a crash ---
        con.execute(f"SET redo_transport = '{stream}'")
        secs = durable_mutations(con, host)
        for kind, s in secs.items():
            print(f"phase 18b: {kind} logged in {s:.2f} s [{card}]")
        con.execute("SET checkpoint_on_shutdown = false")
        wal_bytes = os.path.getsize(path + ".wal")
        if wal_bytes <= 8 or os.path.getsize(path) != size:
            raise AssertionError(f"phase 18b: WAL {wal_bytes} bytes, file "
                                 f"{os.path.getsize(path)}: checkpointed")
        del con                       # a crash: no close(), no checkpoint
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 18b: WAL {wal_bytes} bytes, redo stream "
              f"{os.path.getsize(stream)} bytes at the crash")

        # ---- 18c: recovery ---------------------------------------------
        t_oracle = time.perf_counter()
        sums, rev, nrows = lineitem_oracle(host)
        t_oracle = time.perf_counter() - t_oracle
        t0 = time.perf_counter()
        rec = ddb_tpu_torch.connect(device="cuda", database=path)
        opened = time.perf_counter() - t0
        st = rec.open_stats
        tiles0 = tiled.STREAM_STATS["tiles"]
        t0 = time.perf_counter()
        rows1 = rec.execute(TPCH_QUERIES[1]).fetchall()
        first_s = time.perf_counter() - t0
        streamed_tiles = tiled.STREAM_STATS["tiles"] - tiles0
        rows6 = rec.execute(TPCH_QUERIES[6]).fetchall()
        recover = st["load_s"] + st["replay_s"] + first_s
        print(f"phase 18c: load {st['load_s']:.2f} s, WAL replay "
              f"{st['replay_s']:.2f} s ({st['records']} records), first "
              f"query (SQL Q1 at the defaults, {streamed_tiles} tiles "
              f"streamed) {first_s:.2f} s [{card}]")
        print(f"phase 18c: time to recover {recover:.2f} s (connect() "
              f"returned in {opened:.2f} s) [{card}]")
        rtd = rec.catalog.get_table("lineitem")
        if rtd.num_rows != nrows:
            raise AssertionError(f"phase 18c: {rtd.num_rows} rows, the "
                                 f"oracle has {nrows}")
        t0 = time.perf_counter()
        kin = F.lineitem_kernel_inputs(rtd, dev)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        ksums = F.q1_fused_aggregate(
            kin["qty"], kin["ext"], kin["disc"], kin["tax"], kin["ship"],
            kin["gid"], Q1_CUTOFF).cpu().numpy()
        krev = int(F.q6_fused_filter_sum(kin["qty"], kin["ext"],
                                         kin["disc"], kin["ship"], Q6_CUT))
        del kin
        if not np.array_equal(ksums, sums) or krev != rev:
            raise AssertionError("phase 18c: the kernels over the recovered "
                                 "columns != the numpy oracle")
        tiles = -(-rtd.num_rows // int(rec.config.get("tile_rows")))
        if streamed_tiles != tiles:
            raise AssertionError(f"phase 18c: Q1 streamed {streamed_tiles} "
                                 f"tiles, not {tiles}")
        check_q1_q6("phase 18c streamed", (rows1, rows6), sums, rev)
        resident_path(rec, "18c", rtd.num_rows)
        res_rows = q1_q6_rows(rec)
        check_q1_q6("phase 18c resident", res_rows, sums, rev)
        torch.cuda.synchronize()
        if len(rtd._device_batches) != 1:
            raise AssertionError("phase 18c: lineitem resident "
                                 f"{len(rtd._device_batches)} times")
        allocated = torch.cuda.memory_allocated(dev)
        batch = resident_bytes(rtd)
        if allocated - batch > 0.1 * batch:
            raise AssertionError(f"phase 18c: {allocated} bytes allocated "
                                 f"beside a {batch}-byte table")
        print(f"phase 18c: {rtd.num_rows} rows recovered; SQL Q1 and Q6, "
              f"streamed and resident, equal q1_kernel and q6_kernel over "
              f"the recovered columns and the numpy oracle ({t_oracle:.1f}"
              f" s on the host) exactly; the kernels' inputs uploaded in "
              f"{upload_s:.2f} s")
        print(f"phase 18c: lineitem resident once, {batch / 2**30:.3f} GiB; "
              f"{allocated / 2**30:.3f} GiB allocated [{card}]")

        # ---- 18d: ATTACH the checkpoint in a second connection ---------
        other = ddb_tpu_torch.connect(device="cuda")
        t0 = time.perf_counter()
        other.execute(f"ATTACH '{path}' AS snap")
        attach_s = time.perf_counter() - t0
        snap_rows = q1_q6_rows(other, "snap.lineitem")
        if snap_rows != ckpt_rows:
            raise AssertionError("phase 18d: Q1/Q6 over snap.lineitem != "
                                 "the checkpoint's")
        other.execute("DETACH snap")
        names = [r[0] for r in other.execute(
            "SELECT database_name FROM duckdb_databases()").fetchall()]
        if names != ["memory"] or any(t.startswith("snap.")
                                      for t in other.catalog.tables):
            raise AssertionError(f"phase 18d: after DETACH {names}, "
                                 f"{list(other.catalog.tables)}")
        del other
        gc.collect()
        print(f"phase 18d: ATTACH in {attach_s:.2f} s; Q1 and Q6 over "
              f"snap.lineitem equal the checkpoint's; DETACH dropped it "
              f"[{card}]")

        # ---- 18e: a follower from a copy of the 18a file ---------------
        t0 = time.perf_counter()
        f = Follower(stream, database=copy, device="cuda")
        open_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        applied = 0
        while True:
            n = f.poll()
            if n == 0:
                break
            applied += n
        catch_s = time.perf_counter() - t0
        if q1_q6_rows(f.con) != (rows1, rows6):
            raise AssertionError("phase 18e: the follower's Q1/Q6 != 18c's")
        del f
        gc.collect()
        print(f"phase 18e: follower opened the copy in {open_s:.2f} s and "
              f"caught up on {applied} records in {catch_s:.2f} s; its Q1 "
              f"and Q6 equal the recovered database's [{card}]")

        # ---- 18f: profiling -------------------------------------------
        for q in (1, 6):
            wall, selfs = profile_checks(rec, TPCH_QUERIES[q], dev)
            text = "\n".join(r[0] for r in rec.execute(
                "EXPLAIN ANALYZE " + TPCH_QUERIES[q]).fetchall())
            print(f"phase 18f: Q{q} profiled in {wall * 1e3:.1f} ms wall, "
                  f"the operators' self times {selfs * 1e3:.1f} ms; "
                  f"cardinalities equal the live counts [{card}]")
            print(f"phase 18f: EXPLAIN ANALYZE of Q{q}:")
            for line in text.splitlines():
                print("  " + line)
        rec.execute("SET enable_profiling = true")
        res = rec.execute(TPCH_QUERIES[1])
        rec.execute("SET enable_profiling = false")
        if res.fetchall() != res_rows[0]:
            raise AssertionError("phase 18f: profiled Q1 rows differ")
        print("phase 18f: Q1 with enable_profiling gives the same rows:")
        for line in res.profile.splitlines():
            print("  " + line)

        # ---- 18g: streaming and relations ------------------------------
        rtd.invalidate_cache()
        gc.collect()
        torch.cuda.empty_cache()
        total_tiles = -(-rtd.num_rows // ddb_tpu_torch.api
                        .StreamQueryResult.TILE_ROWS)
        t0 = time.perf_counter()
        s = rec.stream("SELECT l_extendedprice, l_discount FROM lineitem "
                       f"WHERE {Q6_PREDICATE} LIMIT {STREAM_LIMIT}")
        got = s.fetchall()
        lim_s = time.perf_counter() - t0
        if len(got) != STREAM_LIMIT or s.tiles_scanned >= total_tiles:
            raise AssertionError(f"phase 18g: {len(got)} rows in "
                                 f"{s.tiles_scanned} of {total_tiles} tiles")
        print(f"phase 18g: LIMIT {STREAM_LIMIT} stopped after "
              f"{s.tiles_scanned} of {total_tiles} tiles in {lim_s:.2f} s "
              f"[{card}]")
        sql = ("SELECT l_extendedprice, l_discount FROM lineitem "
               f"WHERE {Q6_PREDICATE}")
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        s = rec.stream(sql)
        streamed = s.fetchall()
        full_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - before
        if rtd._device_batches:
            raise AssertionError("phase 18g: stream() cached the table")
        tile_bytes = s.TILE_ROWS * (8 + 8 + 4 + 8 + 1)
        if peak > 16 * tile_bytes:
            raise AssertionError(f"phase 18g: stream() peaked {peak} bytes "
                                 f"above, a tile's columns are {tile_bytes}")
        t0 = time.perf_counter()
        executed = rec.execute(sql).fetchall()
        exec_s = time.perf_counter() - t0
        if sorted(streamed) != sorted(executed):
            raise AssertionError("phase 18g: stream() != execute()")
        print(f"phase 18g: stream() of Q6's filter: {len(streamed)} rows "
              f"in {s.tiles_scanned} tiles, {full_s:.2f} s (execute() and "
              f"fetchall() {exec_s:.2f} s), equal to execute()'s")
        print(f"phase 18g: stream() peaked {peak / 2**20:.2f} MiB above "
              f"the allocation before it; the table's batch was never "
              f"built [{card}]")
        t0 = time.perf_counter()
        rel = rec.table("lineitem").filter(Q6_PREDICATE).aggregate(
            "sum(l_extendedprice * l_discount) AS revenue")
        rel_rows = rel.fetchall()
        rel_s = time.perf_counter() - t0
        if rel_rows != [(decimal.Decimal(krev).scaleb(-4),)]:
            raise AssertionError(f"phase 18g: relation {rel_rows} != "
                                 f"q6_kernel {krev}")
        print(f"phase 18g: table().filter().aggregate() of Q6's revenue "
              f"equals q6_kernel ({rel_s:.2f} s)")

        # ---- 21: the C API over this file, as 18b/18c left it ----------
        t21 = time.perf_counter()
        built = capi_smoke_phase(card)
        capi_fetch_phase(rec, path, built, card, opened, sums, rev)
        phase21_s = time.perf_counter() - t21
        print(f"phase 21: ran in {phase21_s:.1f} s")
        del rec, rtd, host
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k, v in F.LAUNCHES.items():
        if v < 1:
            raise AssertionError(f"phase 18: kernel {k} never launched")
        launches[k] += v
    print(f"phase 18: kernel launches {dict(F.LAUNCHES)}")
    return phase21_s


# ---------------------------------------------------------------------------
# phase 21: the C API (ddb_tpu_torch/capi.py builds ddb_tpu_torch/native/)
# ---------------------------------------------------------------------------

CAPI_RUNS = 8              # Q1 and Q6 through the C ABI: the first, then 7
CAPI_FETCH_SQL = (
    "SELECT * FROM lineitem WHERE l_shipdate BETWEEN DATE '1995-01-01' AND "
    "DATE '1995-02-11' ORDER BY l_quantity, l_extendedprice, l_discount, "
    "l_tax, l_shipdate, l_returnflag, l_linestatus")


def file_state(path):
    """(bytes, mtime in ns) of a database file and of its WAL."""
    return [(os.stat(p).st_size, os.stat(p).st_mtime_ns)
            for p in (path, path + ".wal")]


def capi_smoke_phase(card):
    """21a: build the C API and its clients; the reference's capi_smoke
    and adbc_smoke against the port's libraries, DDB_CAPI_PLATFORM unset
    (the card).  Returns the build."""
    from ddb_tpu_torch import capi
    t0 = time.perf_counter()
    built = capi.build()
    print(f"phase 21a: built the C API into {built.dir} in "
          f"{time.perf_counter() - t0:.2f} s: " + (", ".join(
              f"{k} {v:.2f} s" for k, v in built.seconds.items())
              or "built before"))
    env = capi.child_env()
    probe = subprocess.run(
        ["python3", "-c", "import torch; print(torch.__file__, "
         "torch.version.cuda)"], env=env, capture_output=True, text=True,
        timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"phase 21a: python3 of the C programs' "
                             f"environment: {probe.stderr[-2000:]}")
    torch_file, cuda = probe.stdout.split()
    print(f"phase 21a: the C programs' python3 imports {torch_file}, "
          f"CUDA {cuda}")
    for client, ok in (("capi_smoke", "capi smoke: OK"),
                       ("adbc_smoke", "adbc smoke: OK")):
        t0 = time.perf_counter()
        r = subprocess.run([built[client]], env=env, capture_output=True,
                           text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0 or ok not in r.stdout.splitlines():
            raise AssertionError(f"phase 21a: {client} exited "
                                 f"{r.returncode}: "
                                 f"{(r.stdout + r.stderr)[-3000:]}")
        print(f"phase 21a: {client} (the reference's client) against the "
              f"port's libraries on the card: {ok!r}, {wall:.2f} s wall "
              f"[{card}]")
    return built


def capi_fetch_phase(rec, path, built, card, connect_s, sums, rev):
    """21b: capi_fetch, a C program, opens the database file `path` in a
    second process and runs Q1 and Q6 CAPI_RUNS times and CAPI_FETCH_SQL
    once through the C ABI.  Every line it prints must equal the lines of
    this process's own rows (`rec`, at the defaults as the C program is,
    then closed) lowered by capi_bridge._lower; this process's Q1 and Q6
    must equal the Q1 sums and Q6 revenue that 18c held the kernels to
    (`sums`, `rev`); the file must be left as it was."""
    import gc
    from ddb_tpu_torch import capi, capi_bridge
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    stmts = [TPCH_QUERIES[1], TPCH_QUERIES[6], CAPI_FETCH_SQL]
    default_path(rec)
    expected, inproc, q_rows = [], [], []
    for k, sql in enumerate(stmts):
        secs = []
        for _ in range(CAPI_RUNS if k < 2 else 1):
            t0 = time.perf_counter()
            res = rec.execute(sql)
            rows = res.fetchall()
            secs.append(time.perf_counter() - t0)
        # what capi_bridge.query returns for these rows
        names = [str(n) for n in res.column_names]
        codes = [capi_bridge._TYPE_CODES.get(t.id, 0)
                 for t in res.column_types]
        t0 = time.perf_counter()
        columns = [[capi_bridge._lower(v) for v in col]
                   for col in zip(*rows)] or [[] for _ in names]
        lower_s = time.perf_counter() - t0
        expected += capi.fetch_lines(k, names, codes, columns)
        inproc.append((secs, lower_s, len(rows)))
        if k < 2:
            q_rows.append(rows)
        del res, rows, columns
    check_q1_q6("phase 21b in-process, at the defaults", q_rows, sums, rev)
    rec.execute("SET checkpoint_on_shutdown = false")
    rec.close()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"phase 21b: the parent closed its connection on the file; the "
          f"card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free "
          f"[{card}]")
    before = file_state(path)
    cmd = [built["capi_fetch"], path, "-n", str(CAPI_RUNS), stmts[0],
           stmts[1], "-n", "1", stmts[2]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=capi.child_env(), capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or r.stdout.splitlines()[-1:] != ["capi_fetch: OK"]:
        raise AssertionError(f"phase 21b: capi_fetch exited {r.returncode}:"
                             f" {(r.stdout + r.stderr)[-3000:]}")
    if file_state(path) != before:
        raise AssertionError(f"phase 21b: the C program changed the file: "
                             f"{before} -> {file_state(path)}")
    got = capi.untimed(r.stdout)[:-1]
    if got != expected:
        i = next((i for i, (a, b) in enumerate(zip(got, expected))
                  if a != b), min(len(got), len(expected)))
        raise AssertionError(f"phase 21b: capi_fetch line {i}: "
                             f"{got[i:i + 1]} != {expected[i:i + 1]} "
                             f"({len(got)} lines against {len(expected)})")
    t = capi.timings(r.stdout)
    print(f"phase 21b: capi_fetch ran {wall:.2f} s; every value and "
          f"checksum it printed ({len(got)} lines) equals this process's "
          f"rows lowered by capi_bridge, and the file and its WAL are "
          f"unchanged [{card}]")
    print(f"phase 21b: ddb_open {t['open'] / 1e3:.2f} s (the interpreter "
          f"and the imports), ddb_connect {t['connect'] / 1e3:.2f} s "
          f"(load and WAL replay; 18c's connect() {connect_s:.2f} s) "
          f"[{card}]")
    for k, q in ((0, 1), (1, 6)):
        c_ms = t["query"][k]
        secs, lower_s, _ = inproc[k]
        print(f"phase 21b: Q{q} ddb_query first {c_ms[0]:.1f} ms, median "
              f"of {len(c_ms) - 1} {statistics.median(c_ms[1:]):.1f} ms; "
              f"in-process execute+fetchall first {secs[0] * 1e3:.1f} ms, "
              f"median {statistics.median(secs[1:]) * 1e3:.1f} ms "
              f"[{card}]")
    fetch_s = t["query"][2][0] / 1e3
    secs, lower_s, n = inproc[2]
    print(f"phase 21b: the fetch, {n} rows x 7 columns: ddb_query and "
          f"reading every cell {fetch_s:.2f} s, {n / fetch_s:.0f} rows/s "
          f"through the C boundary; in-process execute+fetchall "
          f"{secs[0]:.2f} s, then capi_bridge._lower of every cell "
          f"{lower_s:.2f} s [{card}]")


# ---------------------------------------------------------------------------
# phase 22: the reference's own test files on the card; the sort probe
# ---------------------------------------------------------------------------

REF_SUITE_TIMEOUT_S = 600


def pytest_counts(text):
    """{"passed": n, "failed": n, "skipped": n, "error": n, "seconds": s}
    from the summary line of `pytest -q`."""
    counts = {"passed": 0, "failed": 0, "skipped": 0, "error": 0,
              "seconds": None}
    lines = [ln for ln in text.splitlines() if ln.strip()]
    last = lines[-1] if lines else ""
    for n, word in re.findall(r"(\d+) (passed|failed|skipped|errors?)\b",
                              last):
        counts["error" if word.startswith("error") else word] = int(n)
    m = re.search(r" in ([\d.]+)s", last)
    if m:
        counts["seconds"] = float(m.group(1))
    return counts


def start_refsuite(device="cuda"):
    """Phase 22a, started: the copies of the reference's test files
    (tests/test_torch_ref_*.py) in a pytest process of their own, every
    connection on `device`; its output and its report (connections by
    device type, peak device memory) go to a temporary directory."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(os.path.relpath(f, root) for f in glob.glob(
        os.path.join(root, "tests", "test_torch_ref_*.py")))
    if not files:
        raise AssertionError("phase 22a: no tests/test_torch_ref_*.py")
    tmp = tempfile.mkdtemp(prefix="ddb_tpu_torch_phase22_")
    log = open(os.path.join(tmp, "pytest.log"), "w+")
    env = dict(os.environ, DDB_TORCH_REF_DEVICE=device,
               DDB_TORCH_REF_REPORT=os.path.join(tmp, "report.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", *files], cwd=root, env=env, stdout=log,
        stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "files": files, "dir": tmp, "log": log,
            "device": device, "t0": time.perf_counter()}


def stop_refsuite(suite):
    """Ends phase 22a's process if it still runs and removes its files."""
    import shutil
    if suite["proc"].poll() is None:
        suite["proc"].kill()
        suite["proc"].wait()
    suite["log"].close()
    shutil.rmtree(suite["dir"], ignore_errors=True)


def finish_refsuite(suite, card):
    """Phase 22a, read: waits for the process (at most
    REF_SUITE_TIMEOUT_S from its start) and fails on any failure, a
    nonzero exit, or no connection or memory on the device."""
    proc, device = suite["proc"], suite["device"]
    try:
        left = suite["t0"] + REF_SUITE_TIMEOUT_S - time.perf_counter()
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 22a: still running after "
                                 f"{REF_SUITE_TIMEOUT_S} s")
        suite["log"].seek(0)
        out = suite["log"].read()
        report = os.path.join(suite["dir"], "report.json")
        rec = {}
        if os.path.exists(report):
            with open(report) as f:
                rec = json.load(f)
    finally:
        stop_refsuite(suite)
    counts = pytest_counts(out)
    opened = rec.get("connections", {}).get(torch.device(device).type, 0)
    peak = rec.get("peak_bytes", 0)
    print(f"phase 22a: {len(suite['files'])} files: {counts['passed']} "
          f"passed, {counts['failed']} failed, {counts['skipped']} "
          f"skipped, {counts['error']} errors in {counts['seconds']} s of "
          f"pytest (exit {rc}); {opened} connections opened on {device}, "
          f"{rec.get('connections')} in all; peak {peak / 2**20:.1f} MiB "
          f"allocated on the card [{card}]")
    if rc != 0 or counts["failed"] or counts["error"] \
            or not counts["passed"]:
        print(out[-8000:])
        raise AssertionError(f"phase 22a: the reference's tests failed on "
                             f"{device}: {counts}, exit {rc}")
    if opened == 0 or (torch.device(device).type == "cuda" and peak == 0):
        raise AssertionError(f"phase 22a: the statements did not run on "
                             f"{device}: {rec}")
    return {**counts, **rec}


def sort_phase(card):
    """Phase 22b: ops/tpu_sort.py's sort_ops against torch.sort over the
    probe's keys, exact, then both timed (median of 7, CUDA events)."""
    from ddb_tpu_torch.bench import sort_probe
    rec = sort_probe.run()
    if rec["mismatched_operands"] or rec["max_abs_err"]:
        raise AssertionError(f"phase 22b: sort_ops != torch.sort: {rec}")
    print(f"phase 22b: sort_ops of {rec['n']} unique int64 keys equals "
          f"torch.sort exactly, alone and with an int32 payload; median "
          f"of 7: keys alone {rec['sort_ops_f_ms']:.4f} ms against "
          f"torch.sort {rec['torch_sort_f_ms']:.4f} ms; with the payload "
          f"{rec['sort_ops_f2_ms']:.4f} ms against torch.sort and a "
          f"gather {rec['torch_sort_f2_ms']:.4f} ms [{card}]")
    return rec


HITS_CSV_LINES = 10_000      # lines of the file held to csv.writer
HITS_VARCHARS = ("SearchPhrase", "MobilePhoneModel", "URL", "Title",
                 "Referer")


def hits_csv_lines(cols, rows):
    """The header and the first `rows` rows of the hits file as the
    reference's write_csv renders them (Python's csv.writer), bytes."""
    import csv
    import io
    from ddb_tpu_torch.bench.clickbench import Coded
    buf = io.StringIO(newline="")
    w = csv.writer(buf)
    w.writerow(list(cols))
    head = {k: Coded(v.codes[:rows], v.values).decode()
            if isinstance(v, Coded) else v[:rows] for k, v in cols.items()}
    day0, t0 = datetime.date(1970, 1, 1), datetime.datetime(1970, 1, 1)
    for i in range(rows):
        row = []
        for k, v in head.items():
            if k == "EventDate":
                row.append((day0 + datetime.timedelta(days=int(v[i])))
                           .isoformat())
            elif k == "EventTime":
                row.append((t0 + datetime.timedelta(seconds=int(v[i])))
                           .isoformat(sep=" "))
            else:
                row.append(v[i])
        w.writerow(row)
    return buf.getvalue().encode()


def same_loaded_hits(reg, got, dev):
    """Phase 14b: the loaded hits equals the registered one, compared on
    the card: integers widened to BIGINT, dates and timestamps as they
    are, and each VARCHAR by its labels, where NULL in the loaded table
    stands for '' in the registered one (fault 3.29) and for nothing
    else.  Returns the NULL count of each VARCHAR column."""
    n = reg.num_rows
    if got.num_rows != n or [c.name for c in got.columns] != \
            [c.name for c in reg.columns]:
        raise AssertionError(f"phase 14b: {got.num_rows} rows, columns "
                             f"{[c.name for c in got.columns]}")
    wb, gb = reg.device_batch(device=dev), got.device_batch(device=dev)
    nulls = {}
    for i, (w, g) in enumerate(zip(reg.columns, got.columns)):
        where = f"phase 14b {w.name}"
        x = wb.columns[i].data[wb.sel]
        y = gb.columns[i].data[gb.sel]
        gn = gb.columns[i].nulls
        gn = torch.zeros_like(y, dtype=torch.bool) if gn is None \
            else gn[gb.sel]
        if w.strdict is None:
            want_type = {"DATE": "DATE", "TIMESTAMP": "TIMESTAMP"}.get(
                repr(w.dtype), "BIGINT")
            if repr(g.dtype) != want_type or bool(gn.any()) or \
                    not torch.equal(x.to(torch.int64), y.to(torch.int64)):
                raise AssertionError(f"{where}: {g.dtype!r} against "
                                     f"{w.dtype!r}, or values differ")
            continue
        rv, gv = np.asarray(w.strdict.values), np.asarray(g.strdict.values)
        lut = np.searchsorted(rv, gv)
        if repr(g.dtype) != "VARCHAR" or not np.array_equal(
                rv[np.minimum(lut, len(rv) - 1)], gv):
            raise AssertionError(f"{where}: labels the registered table "
                                 f"does not hold")
        empty = int(np.searchsorted(rv, ""))
        if empty == len(rv) or rv[empty] != "":
            empty = -1
        lut_t = torch.from_numpy(lut).to(dev)
        mapped = lut_t[y.to(torch.int64).clamp(0, len(gv) - 1)]
        if not torch.equal(gn, x == empty) or not torch.equal(
                mapped[~gn], x[~gn].to(torch.int64)):
            raise AssertionError(f"{where}: values differ beyond '' "
                                 f"against NULL")
        nulls[w.name] = int(gn.sum())
    return nulls


def hits_csv_phase(cols, reg, reg_rows, checked, dev, card):
    """Phase 14b: phase 14's hits columns written by clickbench.write_csv
    on the card (the bytes of the reference's write_csv), loaded as the
    reference's tests/test_clickbench.py loads them, the loaded table
    held to the registered one and phase 14's statements run over it."""
    import shutil
    import ddb_tpu_torch
    from ddb_tpu_torch.bench import clickbench
    from ddb_tpu_torch.storage import csv_sniffer, csvscan

    n = reg.num_rows
    work = work_dir("14b", 3 * 10 ** 9)
    path = os.path.join(work, "hits.csv")
    try:
        # ---- write -------------------------------------------------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clickbench.write_csv(cols, path)
        secs = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"phase 14b: clickbench.write_csv of {n} hits rows on the "
              f"card: {size / 1e9:.3f} GB in {secs:.2f} s, "
              f"{size / secs / 1e6:.1f} MB/s [{card}]")
        want = hits_csv_lines(cols, HITS_CSV_LINES)
        with open(path, "rb") as f:
            got = f.read(len(want))
        if got != want:
            at = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            raise AssertionError(f"phase 14b: byte {at} differs from "
                                 f"csv.writer's: {got[at - 40:at + 40]!r} "
                                 f"against {want[at - 40:at + 40]!r}")
        print(f"phase 14b: the header and the first {HITS_CSV_LINES:,} "
              f"rows equal csv.writer's bytes ({len(want)} bytes, CRLF, "
              f"quoted where needed)")

        # ---- load --------------------------------------------------------
        con = ddb_tpu_torch.connect(device="cuda")
        t0 = time.perf_counter()
        sn = csv_sniffer.sniff(path)
        sniff_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        con.execute(f"CREATE TABLE hits AS SELECT * FROM read_csv_auto"
                    f"('{path}', nullstr='\\x00')")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        tm, st = dict(csvscan.TIMINGS), dict(csvscan.STATS)
        split = ", ".join(f"{k} {v:.2f}" for k, v in tm.items())
        print(f"phase 14b: CREATE TABLE hits AS SELECT * FROM read_csv_auto"
              f"(..., nullstr='\\x00'): {load_s:.2f} s, "
              f"{size / load_s / 1e9:.3f} GB/s of file bytes; the parse "
              f"{sum(tm.values()):.2f} s ({split}; sniff {sniff_s:.3f} s); "
              f"{st['chunks']} chunks; peak {peak / 2**30:.2f} GiB above "
              f"the allocation before the statement (the parse "
              f"{st['peak_bytes'] / 2**30:.2f} GiB); {st['host_rows']} "
              f"fields typed on the host, {st['odd_quote_chunks']} chunks "
              f"re-read for odd quoting [{card}]")
        if st["odd_quote_chunks"] or st["host_rows"]:
            raise AssertionError(f"phase 14b: the parse left the device: "
                                 f"{st}")

        # ---- the table ---------------------------------------------------
        t0 = time.perf_counter()
        got_td = con.catalog.get_table("hits")
        nulls = same_loaded_hits(reg, got_td, dev)
        print(f"phase 14b: the loaded table equals phase 14's on the card "
              f"(integers as BIGINT), but for '' read as NULL (fault "
              f"3.29): NULLs {nulls} ({time.perf_counter() - t0:.1f} s)")

        # ---- the statements ----------------------------------------------
        t0 = time.perf_counter()
        on_cpu = ddb_tpu_torch.connect(device="cpu")
        on_cpu.catalog.add_table(got_td)
        same_as_reg, moved = [], {}
        for name, sql in checked.items():
            res = con.execute(sql)
            on_card([res], f"phase 14b {name}")
            rows = res.fetchall()
            if name in clickbench.DRAWS:
                check_sample(f"phase 14b {name}", rows, n)
                check_sample(f"phase 14b {name} on the CPU",
                             on_cpu.execute(sql).fetchall(), n)
                continue
            same_rows(f"phase 14b {name}", on_cpu.execute(sql).fetchall(),
                      rows)
            if first_difference(reg_rows[name], rows) is None:
                same_as_reg.append(name)
            else:
                moved[name] = [c for c in HITS_VARCHARS
                               if re.search(rf"\b{c}\b", sql)]
        print(f"phase 14b: {len(checked)} statements over the loaded table "
              f"equal the CPU executor ({', '.join(clickbench.DRAWS)} by "
              f"its properties) in {time.perf_counter() - t0:.1f} s; the "
              f"registered table's rows too: {same_as_reg}; changed by the "
              f"NULLs of: {moved}")
        del con, on_cpu, got_td, res
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def sort_studies_phase(card, device="cuda", n=None):
    """Phase 22c: bench/sort_study.py, sort_phase1.py and sort_merge.py at
    their size (6,291,456 keys), twoop, packed, flat and vpu_chain also
    at 8 times it (out of the 50 MB L2; vpu_chain's launch cost spread):
    every case held to numpy, vpu_chain to its plain chain.  Returns vpu_chain's record for the kernels line, its
    launches counted over the three modules' runs alone.  `device` and
    `n` (default 6,291,456) are for a rehearsal on the CPU."""
    from ddb_tpu_torch.bench import sort_merge, sort_phase1, sort_study
    from ddb_tpu_torch.ops import vpu_chain as V
    t0 = time.perf_counter()
    n = n or sort_study.N
    V.LAUNCHES["vpu_chain"] = 0
    recs = {"sort_study": sort_study.run(n, device),
            "sort_phase1": sort_phase1.run(n, device),
            "sort_merge": sort_merge.run(n, device),
            "sort_study 8x": sort_study.run(
                8 * n, device, cases=["twoop", "packed", "vpu_chain"]),
            "sort_phase1 8x": sort_phase1.run(8 * n, device,
                                              cases=["flat"])}
    launches = V.LAUNCHES["vpu_chain"]
    for name, rec in recs.items():
        print(f"phase 22c: {name}:", json.dumps(rec))
    vpu = recs["sort_study"]["results"]["vpu_chain"]
    vpu8 = recs["sort_study 8x"]["results"]["vpu_chain"]
    if launches < 1 or vpu.get("sass_minmax", 0) < 1:
        raise AssertionError(f"phase 22c: vpu_chain launched {launches} "
                             f"times; {vpu.get('sass_minmax')} IMNMX/VIMNMX "
                             f"in its SASS")
    # the kernel's other paths against the plain chain: random bounds, an
    # odd length, a view 4 bytes off the 16-byte boundary (scalar loop)
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, 1_000_003).astype(
        np.int32)).to(device)
    for bounds in (V.reference_bounds(), rng.integers(
            -2**31, 2**31, V.CHAIN).astype(np.int32)):
        for v in (x, x[1:]):
            got = V.vpu_chain(v, bounds, add=7)
            if not torch.equal(got, V.vpu_chain_plain(v, bounds, add=7)):
                raise AssertionError("phase 22c: vpu_chain != its plain "
                                     f"chain at {v.numel()} elements")
    k32 = torch.from_numpy(sort_study.inputs(n)[2]).to(device)
    ref_bounds = V.reference_bounds()
    b2b = back_to_back_ms(lambda: V.vpu_chain(k32, ref_bounds))
    # the rate at 8 times the study's size: a launch's fixed cost spread
    rate = vpu8["ops_per_sec"]
    print(f"phase 22c: vpu_chain: {vpu['sass_minmax']} IMNMX/VIMNMX in "
          f"vpu_chain_kernel's SASS (480 if each operation of its five "
          f"chains of 96, four in the vector loop and one in the scalar "
          f"loop, is one instruction); {vpu['ms']:.4f} ms a "
          f"launch at {k32.numel()} elements ({b2b:.4f} over 20 launches "
          f"queued), {vpu['ops_per_sec']:.4e} int32 ops/s; at "
          f"{8 * k32.numel()} elements {vpu8['ms']:.4f} ms, {rate:.4e} "
          f"ops/s against the {INT32_OP_PER_S:.4e} that bounds cmpx_kernel "
          f"(a {rate / INT32_OP_PER_S:.3f} share); "
          f"the plain chain {vpu['plain_ms']:.4f} ms; the kernel equals it "
          f"with the script's and random bounds, at an odd length and off "
          f"the 16-byte boundary; {launches} launches in the modules' runs "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")
    return {"launches": launches, "n": k32.numel(), "ms": vpu["ms"],
            "plain_ms": vpu["plain_ms"], "b2b": b2b, "rate": rate}


def select_phases(dev, card, profile, ms, all_ms):
    """Phases 13 to 15: the rest of the SELECT surface on the card."""
    import ddb_tpu_torch
    from ddb_tpu_torch.bench import clickbench, cmpx_probe, select_cases
    from ddb_tpu_torch.expr import functions as scalar_functions
    from ddb_tpu_torch.plan import physical

    timed_ms = cmpx_probe.time_ms
    # ---- 13. device agreement on the rest of the SELECT surface ---------------
    t0 = time.perf_counter()
    on_gpu = ddb_tpu_torch.connect(device="cuda")
    on_cpu = ddb_tpu_torch.connect(device="cpu")
    for con in (on_gpu, on_cpu):
        for name, tcols in select_cases.tables().items():
            con.register(name, tcols)
        select_cases.setup(con)
    corpus = {**select_cases.all_statements(),
              **{"deviations/" + k: v
                 for k, v in select_cases.DEVIATIONS.items()}}

    def agree(name, sql):
        res = on_gpu.execute(sql)
        on_card([res], f"phase 13 {name}")
        same_rows(f"phase 13 {name}", on_cpu.execute(sql).fetchall(),
                  res.fetchall())

    for name, sql in corpus.items():
        agree(name, sql)
    for con in (on_gpu, on_cpu):
        select_cases.set_timezone(con, select_cases.ZONE)
    for name, sql in select_cases.ZONED.items():
        agree("zoned/" + name, sql)
    # draws: the card's stream is its own, so properties only
    sql = "SELECT id FROM f USING SAMPLE 50 ROWS REPEATABLE (9)"
    picked = on_gpu.execute(sql).fetchall()
    if len(set(picked)) != 50 or on_gpu.execute(sql).fetchall() != picked:
        raise AssertionError("phase 13: SAMPLE 50 ROWS on the card")
    draws = [r[0] for r in on_gpu.execute(
        "SELECT random() FROM f").fetchall()]
    if len(set(draws)) != len(draws) or not all(0 <= d < 1 for d in draws):
        raise AssertionError("phase 13: random() on the card")
    print(f"phase 13: {len(corpus) + len(select_cases.ZONED)} "
          f"statements of the SELECT corpus give the same rows on the card "
          f"and on the CPU; SAMPLE and random() hold their properties "
          f"({time.perf_counter() - t0:.1f} s); host seams so far "
          f"{scalar_functions.HOST_CALLS}")
    del on_gpu, on_cpu

    # ---- 14. the hits table, checked size -------------------------------------
    t0 = time.perf_counter()
    cols = clickbench.generate(HITS_CHECKED_ROWS, seed=HITS_SEED)
    on_gpu = clickbench.register(ddb_tpu_torch.connect(device="cuda"), cols)
    on_cpu = ddb_tpu_torch.connect(device="cpu")
    on_cpu.catalog.add_table(on_gpu.catalog.get_table("hits"))
    on_gpu.catalog.get_table("hits").device_batch(device=dev)
    torch.cuda.synchronize()
    print(f"phase 14: hits {HITS_CHECKED_ROWS} rows resident on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    checked = clickbench.shapes(HITS_CHECKED_MIN_COUNT, HITS_CHECKED_OFFSET)
    t0 = time.perf_counter()
    on_gpu_rows = {}
    for name, sql in checked.items():
        res = on_gpu.execute(sql)
        on_card([res], f"phase 14 {name}")
        rows = on_gpu_rows[name] = res.fetchall()
        if not rows:
            raise AssertionError(f"phase 14 {name}: no rows")
        if name in clickbench.DRAWS:
            check_sample(f"phase 14 {name}", rows, HITS_CHECKED_ROWS)
            check_sample(f"phase 14 {name} on the CPU",
                         on_cpu.execute(sql).fetchall(), HITS_CHECKED_ROWS)
            if on_gpu.execute(sql).fetchall() != rows:
                raise AssertionError(f"phase 14 {name}: REPEATABLE drew "
                                     f"other rows the second time")
            continue
        same_rows(f"phase 14 {name}", on_cpu.execute(sql).fetchall(), rows)
    t1 = time.perf_counter()
    for name, want in (
            ("cb_like_count", clickbench.like_count_oracle(cols)),
            ("cb_len", clickbench.len_oracle(cols, HITS_CHECKED_MIN_COUNT)),
            ("cb_trunc_minute", clickbench.trunc_minute_oracle(
                cols, HITS_CHECKED_OFFSET))):
        diff = first_difference(want, on_gpu_rows[name])
        if diff is not None or not want:
            raise AssertionError(f"phase 14 {name}: oracle against card: "
                                 f"{diff}")
    print(f"phase 14: {len(checked)} statements equal the CPU executor "
          f"(sel_sample by its properties) in {t1 - t0:.1f} s; "
          f"cb_like_count {on_gpu_rows['cb_like_count']}, cb_len and "
          f"cb_trunc_minute equal numpy oracles "
          f"({time.perf_counter() - t1:.1f} s)")
    # ---- 14b. the same columns through the reference's CSV file ----------
    t0 = time.perf_counter()
    hits_csv_phase(cols, on_gpu.catalog.get_table("hits"), on_gpu_rows,
                   checked, dev, card)
    print(f"phase 14b: ran in {time.perf_counter() - t0:.1f} s")
    del on_gpu, on_cpu, cols, on_gpu_rows, res
    torch.cuda.empty_cache()

    # ---- 15. the hits table, full size -----------------------------------------
    t0 = time.perf_counter()
    cols = clickbench.generate(HITS_FULL_ROWS, seed=HITS_SEED)
    like_want = clickbench.like_count_oracle(cols)
    con = clickbench.register(ddb_tpu_torch.connect(device="cuda"), cols)
    del cols
    resident_path(con, 15, HITS_FULL_ROWS)
    t1 = time.perf_counter()
    con.catalog.get_table("hits").device_batch(device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    print(f"phase 15: hits {HITS_FULL_ROWS} rows: generated and registered "
          f"in {t1 - t0:.1f} s, resident on the card in "
          f"{time.perf_counter() - t1:.1f} s more, "
          f"{resident / 2**30:.2f} GiB [{card}]")
    if con.execute(clickbench.SHAPES["cb_like_count"]).fetchall() \
            != like_want:
        raise AssertionError("phase 15: cb_like_count != its oracle")
    print(f"phase 15: cb_like_count {like_want} equals its numpy oracle")
    for name, sql in clickbench.SHAPES.items():
        first, times, peak, syncs, live, fetched = time_query(con, sql, dev)
        all_ms[name] = times
        t = ms[name] = statistics.median(times)
        print(f"phase 15: {name}: {t:.4f} ms median of {WARM_RUNS} "
              f"(min {min(times):.4f}, max {max(times):.4f}; first run "
              f"{first:.1f}), {HITS_FULL_ROWS / (t / 1e3):.4e} rows/s, "
              f"{live} result rows, {syncs} host synchronisations a query, "
              f"{fetched} rows fetched by the host aggregate; peak "
              f"{peak / 2**30:.2f} GiB on the card, "
              f"{(peak - resident) / 2**30:.2f} GiB above the table "
              f"[{card}]")
    check_sample("phase 15 sel_sample",
                 con.execute(clickbench.SHAPES["sel_sample"]).fetchall(),
                 HITS_FULL_ROWS)
    spine = con.execute(clickbench.SHAPES["sel_day_spine"]).fetchall()
    if len(spine) != 90 or sum(c for _, c in spine) != HITS_FULL_ROWS:
        raise AssertionError(f"phase 15: sel_day_spine has {len(spine)} days "
                             f"holding {sum(c for _, c in spine)} rows")
    # the recursion alone: 90 rounds, each reading one count
    rec_sql = clickbench.SHAPES["sel_day_spine"].split(" SELECT d.x")[0] \
        + " SELECT count(*) FROM d"
    rec_ms = timed_ms(lambda: con.execute(rec_sql).fetchall())
    print(f"phase 15: the recursion of sel_day_spine alone: {rec_ms:.4f} ms "
          f"for 90 rounds, {rec_ms / 90:.4f} ms a round, "
          f"{count_host_syncs(lambda: con.execute(rec_sql))} host "
          f"synchronisations [{card}]")
    if profile:
        # where a plain sort-path aggregate and the recursion wait
        for name in ("sel_cte_twice", "cb_len", "sel_day_spine"):
            sites = host_sync_sites(
                lambda: con.execute(clickbench.SHAPES[name]))
            print(f"phase 15: {name} waits at", json.dumps(
                {s: sites.count(s) for s in sorted(set(sites))}))
        for name in ("cb_like_count", "cb_phrase_like", "cb_minute",
                     "cb_regexp", "sel_day_spine"):
            profile_sql(con, clickbench.SHAPES[name], name, fetch=False)
    del con
    torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# phase 19: the distributed executor over four shards of one card
# ---------------------------------------------------------------------------

DIST_SHARDS = 4
DIST_WARM_RUNS = 3

def dist_mesh(dev):
    """Four shards on the one card (a device may repeat in a port mesh)."""
    from ddb_tpu_torch.parallel.mesh import Mesh
    return Mesh([dev] * DIST_SHARDS)


def dist_plan(con, sql):
    """The optimized plan of a SELECT, bound on the connection's device."""
    from ddb_tpu_torch.batch import bind_device
    from ddb_tpu_torch.sql import parser as sqlparser
    with bind_device(con.device):
        return con._optimize(con._binder().bind_select(
            sqlparser.parse(sql)[0]))


class DistProbe:
    """While active: the distributed executor's exchanges (calls, the
    bytes of their receive buffers, their span on the card by CUDA
    events around each call) and its gathered fallbacks by plan node."""

    def __enter__(self):
        from ddb_tpu_torch.parallel import executor as EX
        self.EX = EX
        self.orig = (EX.all_to_all_exchange, EX._exec_gathered)
        self.events, self.nbytes = [], 0
        self.gathered = {}

        def exchange(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.orig[0](*a, **k)
            end.record()
            self.events.append((start, end))
            self.nbytes += sum(t.numel() * t.element_size()
                               for shard in out[0] for t in shard)
            return out

        def gathered(node, ctx):
            name = type(node).__name__
            self.gathered[name] = self.gathered.get(name, 0) + 1
            return self.orig[1](node, ctx)

        EX.all_to_all_exchange, EX._exec_gathered = exchange, gathered
        return self

    def __exit__(self, *exc):
        self.EX.all_to_all_exchange, self.EX._exec_gathered = self.orig

    def summary(self):
        torch.cuda.synchronize()
        return {"exchanges": len(self.events),
                "exchange_ms": sum(s.elapsed_time(e)
                                   for s, e in self.events),
                "received_gb": self.nbytes / 1e9,
                "gathered": self.gathered}


def dist_run(fn, dev):
    """One statement over the mesh: a first run (its wall ms, its peak
    above the allocation before it, its host synchronisations, the
    executor's retries and the probe's exchanges), then DIST_WARM_RUNS
    warm runs timed by CUDA events.  Returns the first run's result and
    the record."""
    from ddb_tpu_torch.parallel import executor as EX
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    stats = dict(EX.STATS)
    box = []
    with DistProbe() as probe:
        t0 = time.perf_counter()
        sites = host_sync_sites(lambda: box.append(fn()))
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        rec = probe.summary()
    rec.update(first=first, syncs=len(sites),
               peak=torch.cuda.max_memory_allocated(dev) - base,
               retries=EX.STATS["exchange_retries"]
               - stats["exchange_retries"],
               overflow_rows=EX.STATS["exchange_overflow_rows"]
               - stats["exchange_overflow_rows"])
    times = []
    for _ in range(DIST_WARM_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    rec.update(times=times, ms=statistics.median(times))
    return box[0], rec


def dist_line(phase, name, rec, single_ms, card):
    g = rec["gathered"]
    return (f"phase {phase}: {name}: {rec['ms']:.4f} ms median of "
            f"{DIST_WARM_RUNS} (min {min(rec['times']):.4f}, max "
            f"{max(rec['times']):.4f}; first run {rec['first']:.1f}) "
            f"against {single_ms:.4f} ms on one device; peak "
            f"{rec['peak'] / 2**30:.2f} GiB above the allocation before "
            f"it; {rec['exchanges']} exchanges, {rec['exchange_ms']:.1f} "
            f"ms between their events, {rec['received_gb']:.2f} GB of "
            f"receive buffers; gathered {g or 'none'}; retries "
            f"{rec['retries']}, overflow rows {rec['overflow_rows']}; "
            f"{rec['syncs']} host synchronisations [{card}]")


# TPC-H SF1's customer and orders: Q4 runs over four shards there.  At
# SF10 the reference's capacities compound through its three exchanges
# (semi join 2^26 slots a shard, aggregate 2^27, ORDER BY 2^28 a block):
# the ORDER BY's receive buffers alone would take 4 x 2^30 slots of 17
# bytes, 68 GiB, beside the tables.
SF1_CUSTOMERS, SF1_ORDERS = 150_000, 1_500_000


def dist_joins_phase(con, dev, card, rows3, oracle3, ms):
    """Phase 19a: SQL Q3 on phase 7's SF10 tables and SQL Q4 on SF1
    tables through execute_distributed over four shards of the card (a
    NotImplementedError fails the phase), then through
    connect().use_mesh().execute(); every result equals the single-device
    rows and the numpy oracles."""
    import ddb_tpu_torch
    from ddb_tpu_torch.api import QueryResult
    from ddb_tpu_torch.bench import cmpx_probe, tpch
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    from ddb_tpu_torch.parallel import executor as EX
    mesh = dist_mesh(dev)
    con1 = ddb_tpu_torch.connect(device="cuda")
    host1 = tpch.register_synth_join_tables(con1, SF1_CUSTOMERS, SF1_ORDERS,
                                            seed=0)
    rows4 = con1.execute(TPCH_QUERIES[4]).fetchall()
    if rows4 != tpch.q4_oracle(host1) or not rows4:
        raise AssertionError(f"phase 19a: SF1 Q4 {rows4} != the oracle")
    ms4 = cmpx_probe.time_ms(
        lambda: con1.execute(TPCH_QUERIES[4]).fetchall())
    print(f"phase 19a: SF1 tables for Q4: "
          f"{con1.catalog.get_table('lineitem').num_rows} lineitem rows; "
          f"Q4 on one device {ms4:.4f} ms and equal to the numpy oracle")
    for q, c, want, one in ((3, con, rows3, ms["sql_q3"]),
                            (4, con1, rows4, ms4)):
        plan = dist_plan(c, TPCH_QUERIES[q])
        res, rec = dist_run(
            lambda: QueryResult(*EX.execute_distributed(plan, mesh)), dev)
        on_card([res], f"phase 19a Q{q}")
        rows = res.fetchall()
        del res
        if q == 3:
            check_q3(rows, oracle3)
        if [r[1:] for r in rows] != [r[1:] for r in want]:
            raise AssertionError(f"phase 19a: Q{q} {rows} != {want}")
        print(dist_line("19a", f"SQL Q{q} at SF{10 if q == 3 else 1}", rec,
                        one, card))
        c.use_mesh(mesh)
        try:
            got = c.execute(TPCH_QUERIES[q]).fetchall()
        finally:
            c.use_mesh(None)
        if [r[1:] for r in got] != [r[1:] for r in want]:
            raise AssertionError(f"phase 19a: use_mesh Q{q} {got}")
    del con1, host1
    print("phase 19a: Q3 (SF10) and Q4 (SF1) over 4 shards equal the "
          "single-device rows and the numpy oracles, through "
          "execute_distributed and use_mesh")


def dist_h2oai_phase(con, H, dev, card, ms):
    """Phase 19b on phase 10's table (1e8 rows): q1-q10 through
    execute_distributed over four shards; each equals the single-device
    rows (integers exactly, floats to FLOAT_RTOL), compared on the card
    in key order (q10's 1e8 rows are never fetched)."""
    from ddb_tpu_torch.api import QueryResult
    from ddb_tpu_torch.bench import h2oai_scale
    from ddb_tpu_torch.parallel import executor as EX
    mesh = dist_mesh(dev)
    for q in sorted(H.QUERIES):
        plan = dist_plan(con, H.QUERIES[q])
        got, rec = dist_run(
            lambda: QueryResult(*EX.execute_distributed(plan, mesh)), dev)
        on_card([got], f"phase 19b q{q}")
        want = con.execute(H.QUERIES[q])
        n = h2oai_scale.same_rows(f"phase 19b q{q}", want, got,
                                  h2oai_scale.KEYS[q])
        del got, want
        print(dist_line("19b", f"h2oai q{q} ({n} rows, equal to one "
                               f"device's)", rec, ms[f"h2oai_q{q}"], card))
    print("phase 19b: h2oai q1-q10 over 4 shards equal the single-device "
          "rows")


def exchange_digest(keys, pays, valid):
    """(live rows, an order-free digest of the live (key, payload) rows)."""
    from ddb_tpu_torch.ops import hashing
    n, total = 0, 0
    for k, ps, v in zip(keys, pays, valid):
        h = hashing.hash64(k)
        for p in ps:
            h = hashing.hash_combine(h, p)
        n += int(v.sum())
        total += int(torch.where(v, h, 0).sum())
    return n, total & ((1 << 64) - 1)


def dist_exchange_phase(con, dev, card):
    """Phase 19c on phase 7's lineitem: exchange_by_key over l_orderkey
    with two payloads on the 1-D mesh of 4, and the two-level exchange on
    a (2, 2) mesh: every live row lands on shard partition_of(hash64(key),
    4), and the multiset of rows is kept; ms and GB/s printed."""
    from ddb_tpu_torch.batch import bucket_capacity
    from ddb_tpu_torch.bench import cmpx_probe
    from ddb_tpu_torch.parallel import exchange as X
    from ddb_tpu_torch.parallel.mesh import row_sharding
    td = con.catalog.get_table("lineitem")
    names = [c.name for c in td.columns]
    idx = [names.index(c) for c in ("l_orderkey", "l_extendedprice",
                                    "l_discount")]
    b = td.device_batch(idx, device=dev)
    mesh = dist_mesh(dev)
    key = row_sharding(mesh, b.columns[0].data)
    pays = [row_sharding(mesh, c.data) for c in b.columns[1:]]
    valid = row_sharding(mesh, b.sel)
    arrays = [[k] + [p[s] for p in pays] for s, k in enumerate(key)]
    per = b.capacity // DIST_SHARDS
    live = int(b.count)
    row_bytes = sum(c.data.element_size() for c in b.columns)
    n0, d0 = exchange_digest(key, [[p[s] for p in pays]
                                   for s in range(DIST_SHARDS)], valid)
    # the executor's first capacity for a row exchange of this many rows
    cap = bucket_capacity(max(per * 2 // (DIST_SHARDS // 2), 256))
    pids = [X.partition_ids(k, DIST_SHARDS) for k in key]
    for label, fn in (
            ("1-D mesh of 4", lambda: X.exchange_by_key(
                key, arrays, valid, DIST_SHARDS, cap, mesh.devices)),
            ("(2, 2) mesh, two levels", lambda: X.all_to_all_exchange_2level(
                arrays, valid, pids, 2, 2, cap, mesh.devices))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out, ovalid, ovf = fn()
        peak = torch.cuda.max_memory_allocated(dev) - base
        if sum(int(o) for o in ovf):
            raise AssertionError(f"phase 19c {label}: overflow {ovf}")
        for s, (o, v) in enumerate(zip(out, ovalid)):
            if not bool((X.partition_ids(o[0], DIST_SHARDS)[v] == s).all()):
                raise AssertionError(f"phase 19c {label}: a row is off its "
                                     f"hash's shard {s}")
        n1, d1 = exchange_digest([o[0] for o in out],
                                 [list(o[1:]) for o in out], ovalid)
        if (n1, d1) != (n0, d0):
            raise AssertionError(f"phase 19c {label}: rows {n1} digest "
                                 f"{d1:x} against {n0} {d0:x}")
        del out, ovalid
        times = cmpx_probe.times_ms(fn, DIST_WARM_RUNS)
        t = statistics.median(times)
        print(f"phase 19c: exchange_by_key of lineitem ({live} live rows "
              f"of {b.capacity} slots, l_orderkey and 2 payloads, "
              f"{row_bytes} B a row) over the {label}, capacity {cap} a "
              f"block: every row on its hash's shard, the rows kept; "
              f"{t:.4f} ms median of {DIST_WARM_RUNS} (min {min(times):.4f},"
              f" max {max(times):.4f}), {live * row_bytes / t / 1e6:.2f} "
              f"GB/s of live rows; peak {peak / 2**30:.2f} GiB above the "
              f"allocation before it [{card}]")



# ---------------------------------------------------------------------------
# phase 20: files in and out (storage/csvscan.py, storage/csvwrite.py)
# ---------------------------------------------------------------------------

H2OAI_CSV = "G1_1e8_1e2_0_0.csv"
# 20f's depth: SF1 lineitem's rows, the first of phase 4's (cut from all
# of SF10's 59,986,052 to keep the script within its time)
PARQUET_ROWS = 6_001_215
LINEITEM_DECL = ("CREATE TABLE lineitem (l_quantity DECIMAL(15,2), "
                 "l_extendedprice DECIMAL(15,2), l_discount DECIMAL(15,2), "
                 "l_tax DECIMAL(15,2), l_shipdate DATE, "
                 "l_returnflag VARCHAR, l_linestatus VARCHAR)")


def work_dir(phase, need_bytes):
    """A temporary directory with `need_bytes` free, or raise."""
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix=f"ddb_tpu_torch_phase{phase}_")
    free = shutil.disk_usage(work).free
    print(f"phase {phase}: working in a temporary directory with "
          f"{free / 1e9:.1f} GB free, {need_bytes / 1e9:.1f} GB needed")
    if free < need_bytes:
        shutil.rmtree(work, ignore_errors=True)
        raise AssertionError(f"phase {phase}: {free} bytes free on the "
                             f"temporary directory's disk, {need_bytes} "
                             f"needed")
    return work


def same_table(name, want, got, widths=True):
    """Two TableData equal exactly: names, types, values (floats bit for
    bit), NULL masks and string dictionaries.  `widths`: DECIMAL widths
    too (a Parquet round trip stores decimal128 at 18 digits, as the
    reference's does)."""
    if [c.name for c in want.columns] != [c.name for c in got.columns]:
        raise AssertionError(f"{name}: columns {[c.name for c in got.columns]}")
    for w, g in zip(want.columns, got.columns):
        where = f"{name}.{w.name}"
        wt, gt = (w.dtype, g.dtype) if widths else (
            (w.dtype.id, w.dtype.scale), (g.dtype.id, g.dtype.scale))
        if repr(wt) != repr(gt) or w.data.dtype != g.data.dtype:
            raise AssertionError(f"{where}: {g.dtype!r} against {w.dtype!r}")
        a, b = w.data, g.data
        if a.dtype.kind == "f":
            a, b = a.view(np.int64), b.view(np.int64)
        if not np.array_equal(a, b):
            raise AssertionError(f"{where}: values differ")
        if (w.nulls is None) != (g.nulls is None) or (
                w.nulls is not None and not np.array_equal(w.nulls, g.nulls)):
            raise AssertionError(f"{where}: NULLs differ")
        if (w.strdict is None) != (g.strdict is None) or (
                w.strdict is not None and list(w.strdict.values)
                != list(g.strdict.values)):
            raise AssertionError(f"{where}: dictionaries differ")


def outcome(fn):
    """("ok", value) or ("raises", exception class name)."""
    try:
        return ("ok", fn())
    except Exception as e:     # noqa: BLE001 - the class is compared
        return ("raises", type(e).__name__)


def csv_agreement_phase(card):
    """Phase 20a: the CPU tests' CSV corpus (bench/csv_cases.py) through
    connect("cuda") and connect("cpu"): every file read by read_csv_auto
    (whole, and in chunks of 5 bytes), every inferred file by
    Connection.read_csv, and the SQL statements (read_csv_auto, sniff_csv,
    read_csv with named arguments, COPY FROM with declared types, COPY TO
    and VALUES in FROM) give the same tables and rows, COPY TO the same
    bytes; one file is read in chunks of 9 bytes, so that a boundary
    falls inside each quoted field that holds a newline."""
    import shutil
    import ddb_tpu_torch
    from ddb_tpu_torch.batch import bind_device
    from ddb_tpu_torch.bench import csv_cases
    from ddb_tpu_torch.storage import csvscan
    from ddb_tpu_torch.storage.csv_sniffer import read_csv_auto

    t0 = time.perf_counter()
    work = work_dir("20a", 1 << 20)
    chunk0 = csvscan.CHUNK_BYTES
    try:
        p = os.path.join(work, "case.csv")
        n_files = 0
        for name, (text, kw) in sorted(csv_cases.CASES.items()):
            with open(p, "wb") as f:
                f.write(text.encode())
            for chunk in (chunk0, 5):
                csvscan.CHUNK_BYTES = chunk
                got = {}
                for dev in ("cuda", "cpu"):
                    with bind_device(dev):
                        got[dev] = outcome(lambda: read_csv_auto(p, **kw))
                csvscan.CHUNK_BYTES = chunk0
                if got["cuda"][0] != got["cpu"][0] or (
                        got["cuda"][0] == "raises"
                        and got["cuda"] != got["cpu"]):
                    raise AssertionError(f"phase 20a {name}: {got}")
                if got["cuda"][0] == "ok":
                    same_table(f"phase 20a {name}", got["cpu"][1],
                               got["cuda"][1])
                n_files += 1
        for name, text in sorted(csv_cases.INFER.items()):
            with open(p, "wb") as f:
                f.write(text.encode())
            got = {}
            for dev in ("cuda", "cpu"):
                con = ddb_tpu_torch.connect(dev)
                got[dev] = outcome(lambda: con.read_csv("t", p)
                                   .catalog.get_table("t"))
            if got["cuda"][0] != got["cpu"][0]:
                raise AssertionError(f"phase 20a infer {name}: {got}")
            if got["cuda"][0] == "ok":
                same_table(f"phase 20a infer {name}", got["cpu"][1],
                           got["cuda"][1])
        # the SQL statements, in a directory per device
        cons, dirs = {}, {}
        for dev in ("cuda", "cpu"):
            dirs[dev] = os.path.join(work, dev)
            os.makedirs(dirs[dev])
            with open(os.path.join(dirs[dev], "f.csv"), "w") as f:
                f.write(csv_cases.random_file(np.random.default_rng(5), 2000,
                                              newlines=False))
            with open(os.path.join(dirs[dev], "p.csv"), "w") as f:
                f.write(csv_cases.CASES["no_header_pipe"][0])
            cons[dev] = ddb_tpu_torch.connect(dev)
        for name, sqls in csv_cases.STATEMENTS.items():
            sqls = [sqls] if isinstance(sqls, str) else sqls
            rows = {}
            for dev, con in cons.items():
                for sql in sqls:
                    r = con.execute(sql.format(d=dirs[dev]))
                if dev == "cuda":
                    on_card([r], f"phase 20a {name}")
                rows[dev] = ([repr(t) for t in r.column_types], r.fetchall())
            if not rows["cuda"][1]:
                raise AssertionError(f"phase 20a {name}: no rows")
            same_rows(f"phase 20a {name}", rows["cpu"][1], rows["cuda"][1])
            if rows["cpu"][0] != rows["cuda"][0]:
                raise AssertionError(f"phase 20a {name}: types {rows}")
        outs = {dev: open(os.path.join(dirs[dev], "out.csv"), "rb").read()
                for dev in dirs}
        if outs["cuda"] != outs["cpu"] or not outs["cuda"]:
            raise AssertionError("phase 20a: COPY TO bytes differ")
        # a chunk boundary inside every quoted newline
        text = "a,b\n" + "".join(f'"v{i:02d}\nw\r\nx",{i}\n'
                                 for i in range(40))
        with open(p, "wb") as f:
            f.write(text.encode())
        csvscan.CHUNK_BYTES = 9
        got = {}
        for dev in ("cuda", "cpu"):
            with bind_device(dev):
                got[dev] = read_csv_auto(p)
            if csvscan.STATS["chunks"] < 40:
                raise AssertionError(f"phase 20a: {csvscan.STATS}")
        csvscan.CHUNK_BYTES = chunk0
        same_table("phase 20a quoted newlines", got["cpu"], got["cuda"])
        if got["cuda"].num_rows != 40:
            raise AssertionError("phase 20a: quoted newlines")
    finally:
        csvscan.CHUNK_BYTES = chunk0
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 20a: {n_files} reads of {len(csv_cases.CASES)} files "
          f"(whole and in 5-byte chunks), {len(csv_cases.INFER)} inferred "
          f"files and {len(csv_cases.STATEMENTS)} statements give the same "
          f"tables, rows and COPY TO bytes on the card and on the CPU; "
          f"chunks of 9 bytes split every quoted newline "
          f"({time.perf_counter() - t0:.1f} s) [{card}]")


def arrow_double(x: float) -> str:
    """Arrow's text of a double (its shortest round trip, positional for
    decimal exponents in [-6, 10)), in plain Python."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    if x == 0:
        return "-0" if math.copysign(1.0, x) < 0 else "0"
    r = repr(abs(x))
    m, _, e = r.partition("e")
    ip, _, fp = m.partition(".")
    fp = "" if fp == "0" else fp
    digits = (ip + fp).lstrip("0")
    dp = len(ip) - (len(ip + fp) - len(digits)) + (int(e) if e else 0)
    digits = digits.rstrip("0")
    nd, ex = len(digits), dp - 1
    if -6 <= ex < 10:
        if dp <= 0:
            body = "0." + "0" * (-dp) + digits
        elif dp >= nd:
            body = digits + "0" * (dp - nd)
        else:
            body = digits[:dp] + "." + digits[dp:]
    else:
        body = digits[0] + ("." + digits[1:] if nd > 1 else "") + "e" + \
            ("+" if ex >= 0 else "-") + str(abs(ex))
    return ("-" if x < 0 else "") + body


def h2oai_lines(td, rows):
    """The header and the first `rows` rows of x_group as pyarrow's writer
    renders them, in plain Python."""
    cols = td.columns
    out = [",".join(f'"{c.name}"' for c in cols) + "\n"]
    for i in range(rows):
        vals = []
        for c in cols:
            if c.nulls is not None and c.nulls[i]:
                vals.append("")
            elif c.strdict is not None:
                vals.append('"' + str(c.strdict.values[c.data[i]]) + '"')
            elif c.data.dtype.kind == "f":
                vals.append(arrow_double(float(c.data[i])))
            else:
                vals.append(str(int(c.data[i])))
        out.append(",".join(vals) + "\n")
    return out


def exact_column(col, sel):
    """A result column's live values as int64 or float64 on the card."""
    x = col.data[sel]
    if getattr(col, "hi", None) is not None:
        x = (col.hi[sel].to(torch.int64) << 32) + (x.to(torch.int64)
                                                   & 0xFFFFFFFF)
    return x.to(torch.float64) if x.is_floating_point() \
        else x.to(torch.int64)


def same_result_values(name, want, got):
    """same_result, with integer columns compared as int64 (the loaded
    table's integers are BIGINT, phase 10's INTEGER)."""
    if want.schema.names != got.schema.names:
        raise AssertionError(f"{name}: columns {got.schema.names}")
    ws, gs = want.batch.sel, got.batch.sel
    if int(ws.sum()) != int(gs.sum()):
        raise AssertionError(f"{name}: {int(gs.sum())} rows against "
                             f"{int(ws.sum())}")
    for f, g, a, b in zip(want.schema.fields, got.schema.fields,
                          want.batch.columns, got.batch.columns):
        x, y = exact_column(a, ws), exact_column(b, gs)
        na = torch.zeros_like(ws[ws]) if a.nulls is None else a.nulls[ws]
        nb = torch.zeros_like(gs[gs]) if b.nulls is None else b.nulls[gs]
        if not torch.equal(na, nb):
            raise AssertionError(f"{name}.{f.name}: NULLs differ")
        if f.strdict is not None:
            # the same labels: each side's codes through its dictionary
            wl = np.asarray(f.strdict.values)[x.cpu().numpy()]
            gl = np.asarray(g.strdict.values)[y.cpu().numpy()]
            ok = np.array_equal(wl, gl)
        elif x.is_floating_point() or y.is_floating_point():
            ok = bool(torch.isclose(x.to(torch.float64), y.to(torch.float64),
                                    rtol=FLOAT_RTOL, atol=0.0,
                                    equal_nan=True).all())
        else:
            ok = torch.equal(x, y)
        if not ok:
            raise AssertionError(f"{name}.{f.name}: values differ")


def h2oai_csv_phase(con, H, dev, card, ms):
    """Phases 20b-d on phase 10's x_group (100,000,000 rows): b: COPY
    x_group TO the h2oai file, its first 10,000 lines against pyarrow's
    rules in plain Python; c: in a second connection, CREATE TABLE x_group
    AS SELECT * FROM read_csv_auto(file), as db-benchmark's DuckDB script
    loads it, every column equal to phase 10's; d: q1-q10 there equal
    phase 10's results."""
    import shutil
    import ddb_tpu_torch
    from ddb_tpu_torch.bench import cmpx_probe
    from ddb_tpu_torch.storage import csv_sniffer, csvscan, csvwrite

    td = con.catalog.get_table("x_group")
    n = td.num_rows
    work = work_dir("20b", 9 * 10 ** 9)
    path = os.path.join(work, H2OAI_CSV)
    try:
        # ---- 20b: write ---------------------------------------------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (count,), = con.execute(f"COPY x_group TO '{path}'").fetchall()
        secs = time.perf_counter() - t0
        size = os.path.getsize(path)
        if count != n:
            raise AssertionError(f"phase 20b: COPY wrote {count} rows")
        print(f"phase 20b: COPY x_group TO {H2OAI_CSV}: {n} rows, "
              f"{size / 1e9:.3f} GB in {secs:.2f} s, "
              f"{size / secs / 1e6:.1f} MB/s; "
              f"{csvwrite.STATS['slow_float_rows']} doubles took numpy's "
              f"shortest repr [{card}]")
        ms["csv_write_s"] = secs
        with open(path) as f:
            head = [next(f) for _ in range(10001)]
        want = h2oai_lines(td, 10000)
        for i, (w, g) in enumerate(zip(want, head)):
            if w != g:
                raise AssertionError(f"phase 20b: line {i + 1}: {g!r} "
                                     f"against {w!r}")
        print("phase 20b: the header and the first 10,000 rows equal "
              "pyarrow's rules rendered in plain Python")

        # ---- 20c: load ----------------------------------------------------
        con2 = ddb_tpu_torch.connect(device="cuda")
        resident_path(con2, "20c", n)
        t0 = time.perf_counter()
        sn = csv_sniffer.sniff(path)
        sniff_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        con2.execute(f"CREATE TABLE x_group AS SELECT * FROM "
                     f"read_csv_auto('{path}')")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        tm = dict(csvscan.TIMINGS)
        st = dict(csvscan.STATS)
        parse_s = sum(tm.values())
        split = ", ".join(f"{k} {v:.2f}" for k, v in tm.items())
        print(f"phase 20c: CREATE TABLE x_group AS SELECT * FROM "
              f"read_csv_auto: {load_s:.2f} s, {size / load_s / 1e9:.3f} GB/s "
              f"of file bytes; the parse {parse_s:.2f} s ({split}; sniff "
              f"{sniff_s:.3f} s, delimiter {sn.delimiter!r}, types "
              f"{sn.column_types}); {st['chunks']} chunks; peak "
              f"{peak / 2**30:.2f} GiB above the allocation before the "
              f"statement (the parse {st['peak_bytes'] / 2**30:.2f} GiB); "
              f"{st['slow_float_rows']} doubles off the fast path, "
              f"{st['host_rows']} fields typed on the host, "
              f"{st['odd_quote_chunks']} chunks re-read for odd quoting "
              f"[{card}]")
        ms["csv_load_s"] = load_s
        got = con2.catalog.get_table("x_group")
        if got.num_rows != n:
            raise AssertionError(f"phase 20c: {got.num_rows} rows")
        for w, g in zip(td.columns, got.columns):
            where = f"phase 20c {w.name}"
            if w.strdict is not None:
                lut = np.searchsorted(w.strdict.values, g.strdict.values)
                if not np.array_equal(np.asarray(w.strdict.values)[lut],
                                      np.asarray(g.strdict.values)) or \
                        not np.array_equal(lut[g.data], w.data):
                    raise AssertionError(f"{where}: labels differ")
            elif w.data.dtype.kind == "f":
                if not np.array_equal(w.data.view(np.int64),
                                      g.data.view(np.int64)):
                    raise AssertionError(f"{where}: not bit for bit")
            elif repr(g.dtype) != "BIGINT" or not np.array_equal(
                    w.data.astype(np.int64), g.data):
                raise AssertionError(f"{where}: {g.dtype!r} values differ")
            if (w.nulls is not None and w.nulls.any()) or \
                    (g.nulls is not None and g.nulls.any()):
                raise AssertionError(f"{where}: NULLs")
        print(f"phase 20c: every column equals phase 10's: id1-id3 by "
              f"their labels, id4-id6, v1 and v2 as BIGINT values, v3 bit "
              f"for bit")

        # ---- 20d: the queries ---------------------------------------------
        got.device_batch(device=dev)
        for q in sorted(H.QUERIES):
            sql = H.QUERIES[q]
            want_r = con.execute(sql)
            got_r = con2.execute(sql)
            on_card([got_r], f"phase 20d q{q}")
            same_result_values(f"phase 20d q{q}", want_r, got_r)
            del want_r, got_r
            t = statistics.median(cmpx_probe.times_ms(
                lambda: (con2.execute(sql), torch.cuda.synchronize()), 3))
            ms[f"h2oai_csv_q{q}"] = t
            print(f"phase 20d: h2oai q{q} on the loaded table: {t:.4f} ms "
                  f"median of 3 against {ms[f'h2oai_q{q}']:.4f} ms on "
                  f"phase 10's; equals phase 10's result [{card}]")
        del con2, got
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def lineitem_csv_phase(con, dev, card, F, launches, worst):
    """Phases 20e-f on phase 4's lineitem after RF1: e: COPY lineitem TO a
    '|' file without a header; in a second connection the declared
    CREATE TABLE lineitem, COPY lineitem FROM the file, every column equal
    to phase 4's, and SQL Q1/Q6 equal to q1_kernel/q6_kernel over the
    reloaded columns (their launches added to `launches`); f: Parquet
    through pyarrow where it imports, else the port's error naming it."""
    import shutil
    import ddb_tpu_torch
    from ddb_tpu_torch.storage import csvscan, csvwrite

    td = con.catalog.get_table("lineitem")
    n = td.num_rows
    work = work_dir("20e", 4 * 10 ** 9)
    path = os.path.join(work, "lineitem.tbl")
    try:
        t0 = time.perf_counter()
        (count,), = con.execute(f"COPY lineitem TO '{path}' (DELIMITER '|', "
                                f"HEADER false)").fetchall()
        secs = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"phase 20e: COPY lineitem TO a '|' file: {count} rows, "
              f"{size / 1e9:.3f} GB in {secs:.2f} s, "
              f"{size / secs / 1e6:.1f} MB/s [{card}]")
        if count != n or csvwrite.STATS["rows"] != n:
            raise AssertionError(f"phase 20e: {count} rows written")
        con2 = ddb_tpu_torch.connect(device="cuda")
        resident_path(con2, "20e", n)
        con2.execute(LINEITEM_DECL)
        t0 = time.perf_counter()
        (loaded,), = con2.execute(f"COPY lineitem FROM '{path}' "
                                  f"(DELIMITER '|', HEADER false)").fetchall()
        secs = time.perf_counter() - t0
        tm = ", ".join(f"{k} {v:.2f}" for k, v in csvscan.TIMINGS.items())
        print(f"phase 20e: COPY lineitem FROM: {loaded} rows in {secs:.2f} "
              f"s, {size / secs / 1e9:.3f} GB/s of file bytes ({tm}); "
              f"{csvscan.STATS['host_rows']} fields typed on the host, "
              f"{csvscan.STATS['odd_quote_chunks']} chunks re-read for odd "
              f"quoting [{card}]")
        td2 = con2.catalog.get_table("lineitem")
        same_table("phase 20e", td, td2)
        rev = lineitem_kernels_phase("20e", con2, td2, dev, F, launches,
                                     worst)
        print(f"phase 20e: every column equals phase 4's; SQL Q1 and Q6 "
              f"(revenue {decimal.Decimal(rev).scaleb(-4)}) over the "
              f"reloaded lineitem equal q1_kernel and q6_kernel exactly")

        # ---- 20f: Parquet -------------------------------------------------
        try:
            import pyarrow
            have = pyarrow.__version__
        except ModuleNotFoundError:
            have = None
        print(f"phase 20f: pyarrow {have or 'absent'}")
        pq_path = os.path.join(work, "lineitem.parquet")
        if have is None:
            for sql in (f"COPY lineitem TO '{pq_path}' (FORMAT parquet)",
                        f"SELECT * FROM read_parquet('{pq_path}')"):
                try:
                    con2.execute(sql)
                except ModuleNotFoundError as e:
                    if "pyarrow" not in str(e):
                        raise
                else:
                    raise AssertionError(f"phase 20f: {sql} ran without "
                                         f"pyarrow")
            print("phase 20f: COPY ... (FORMAT parquet) and read_parquet "
                  "raise ModuleNotFoundError naming pyarrow, as the "
                  "reference does without it")
        else:
            con2.execute(f"CREATE TABLE lineitem_pq AS SELECT * FROM "
                         f"lineitem LIMIT {PARQUET_ROWS}")
            tdp = con2.catalog.get_table("lineitem_pq")
            t0 = time.perf_counter()
            con2.execute(f"COPY lineitem_pq TO '{pq_path}' (FORMAT parquet)")
            w_s = time.perf_counter() - t0
            con3 = ddb_tpu_torch.connect(device="cuda")
            resident_path(con3, "20f", n)
            t0 = time.perf_counter()
            con3.execute(f"CREATE TABLE lineitem AS SELECT * FROM "
                         f"read_parquet('{pq_path}')")
            r_s = time.perf_counter() - t0
            td3 = con3.catalog.get_table("lineitem")
            if td3.num_rows != PARQUET_ROWS:
                raise AssertionError(f"phase 20f: {td3.num_rows} rows")
            same_table("phase 20f", tdp, td3, widths=False)
            lineitem_kernels_phase("20f", con3, td3, dev, F, launches, worst)
            print(f"phase 20f: {PARQUET_ROWS} rows of phase 4's lineitem: "
                  f"COPY TO Parquet {w_s:.2f} s "
                  f"({os.path.getsize(pq_path) / 1e9:.3f} GB), read_parquet "
                  f"into a third connection {r_s:.2f} s; every column equals "
                  f"phase 4's and SQL Q1/Q6 equal the kernels [{card}]")
            del con3, td3, tdp
        del con2, td2
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def lineitem_kernels_phase(phase, con, td, dev, F, launches, worst):
    """SQL Q1/Q6 on `con` against q1_kernel/q6_kernel over its lineitem,
    counting the kernels' launches from zero; returns Q6's revenue."""
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES
    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    res1 = con.execute(TPCH_QUERIES[1])
    res6 = con.execute(TPCH_QUERIES[6])
    rows1, rows6 = res1.fetchall(), res6.fetchall()
    kin = F.lineitem_kernel_inputs(td, dev)
    q1_args = [kin[c] for c in ("qty", "ext", "disc", "tax", "ship", "gid")]
    q6_args = [kin[c] for c in ("qty", "ext", "disc", "ship")]
    sums = F.q1_fused_aggregate(*q1_args, Q1_CUTOFF).cpu().numpy()
    rev = int(F.q6_fused_filter_sum(*q6_args, Q6_CUT))
    got = dict(F.LAUNCHES)
    if min(got.values()) < 1:
        raise AssertionError(f"phase {phase}: launches {got}")
    for k, v in got.items():
        launches[k] += v
    on_card([res1, res6], f"phase {phase}")
    check_q1(rows1, sums, F)
    if rows6 != [(decimal.Decimal(rev).scaleb(-4),)] or rev <= 0:
        raise AssertionError(f"phase {phase}: Q6 {rows6} != kernel {rev}")
    plain1 = F.q1_fused_aggregate_plain(*q1_args, Q1_CUTOFF).cpu().numpy()
    plain6 = int(F.q6_fused_filter_sum_plain(*q6_args, Q6_CUT))
    if not (np.array_equal(plain1, sums) and plain6 == rev):
        raise AssertionError(f"phase {phase}: kernel != plain version")
    worst["q1"] = max(worst["q1"], int(np.abs(plain1 - sums).max()))
    worst["q6"] = max(worst["q6"], abs(plain6 - rev))
    print(f"phase {phase}: kernel launches {got}")
    return rev


class MemFS:
    """An fsspec-shaped filesystem held in memory, for `mem://` paths: a
    test double of a remote store, as tests/test_cachefs.py's."""

    def __init__(self):
        self.files = {}
        self.opens = 0

    def open(self, path, mode="rb"):
        import io
        self.opens += 1
        return io.BytesIO(self.files[path][1])

    def modified(self, path):
        return self.files[path][0]


def cachefs_phase(card):
    """Phase 20g: read_csv_auto('mem://...') through the caching
    filesystem equals the local read on the card, and a second read is a
    cache hit that opens nothing."""
    import shutil
    import ddb_tpu_torch
    from ddb_tpu_torch.bench import csv_cases
    from ddb_tpu_torch.storage import cachefs

    work = work_dir("20g", 1 << 20)
    fs = MemFS()
    try:
        text = csv_cases.random_file(np.random.default_rng(6), 3000,
                                     newlines=False)
        local = os.path.join(work, "r.csv")
        with open(local, "w") as f:
            f.write(text)
        fs.files["r.csv"] = (1, text.encode())
        con = ddb_tpu_torch.connect(device="cuda")
        con.register_filesystem("mem", fs)
        sql = "SELECT * FROM read_csv_auto('{}') ORDER BY ALL"
        want = con.execute(sql.format(local)).fetchall()
        hits = cachefs.STATS["hits"]
        first = con.execute(sql.format("mem://r.csv"))
        on_card([first], "phase 20g")
        second = con.execute(sql.format("mem://r.csv")).fetchall()
        if first.fetchall() != want or second != want or not want:
            raise AssertionError("phase 20g: mem:// != the local file")
        if fs.opens != 1 or cachefs.STATS["hits"] != hits + 1:
            raise AssertionError(f"phase 20g: {fs.opens} opens, "
                                 f"{cachefs.STATS}")
        con.unregister_filesystem("mem")
        print(f"phase 20g: read_csv_auto('mem://r.csv') equals the local "
              f"read ({len(want)} rows); the second read was a cache hit "
              f"(1 open) [{card}]")
    finally:
        cachefs.unregister_filesystem("mem")
        cachefs.clear_cache()
        shutil.rmtree(work, ignore_errors=True)


FULL_PRECISION_ROWS = 10_000_000


def full_precision_phase(dev, card):
    """Phase 20h: a DOUBLE column of arbitrary values (16 and 17
    significant digits, as COPY TO writes them) written with COPY TO and
    read back with COPY FROM.  Both are off their fast paths: the writer
    takes numpy's shortest repr, the reader numpy's parse, each in one
    conversion a chunk, and no field is typed row by row.  The first 1,000
    lines equal pyarrow's rules in plain Python; the column reads back bit
    for bit."""
    import shutil
    import ddb_tpu_torch
    from ddb_tpu_torch.storage import csvscan, csvwrite

    n = FULL_PRECISION_ROWS
    work = work_dir("20h", 2 * 10 ** 9)
    path = os.path.join(work, "x.csv")
    try:
        gen = torch.Generator(device=dev).manual_seed(20)
        x = torch.randn(n, generator=gen, device=dev,
                        dtype=torch.float64).cpu().numpy()
        con = ddb_tpu_torch.connect(device="cuda")
        con.register("f", {"x": x})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (count,), = con.execute(f"COPY f TO '{path}'").fetchall()
        w_s = time.perf_counter() - t0
        slow_w = csvwrite.STATS["slow_float_rows"]
        size = os.path.getsize(path)
        with open(path) as fh:
            head = [next(fh) for _ in range(1001)]
        want = ['"x"\n'] + [arrow_double(float(v)) + "\n" for v in x[:1000]]
        if head != want or count != n:
            raise AssertionError(f"phase 20h: {count} rows; the first lines "
                                 f"differ from pyarrow's rules")
        con.execute("CREATE TABLE g (x DOUBLE)")
        t0 = time.perf_counter()
        con.execute(f"COPY g FROM '{path}'")
        r_s = time.perf_counter() - t0
        st = dict(csvscan.STATS)
        got = con.catalog.get_table("g").columns[0].data
        if not np.array_equal(got.view(np.int64), x.view(np.int64)):
            raise AssertionError("phase 20h: not bit for bit")
        if st["host_rows"] or st["odd_quote_chunks"]:
            raise AssertionError(f"phase 20h: {st}")
        print(f"phase 20h: {n} doubles of 16 and 17 digits, {size / 1e9:.3f} "
              f"GB: COPY TO {w_s:.2f} s ({slow_w} formatted through numpy's "
              f"repr), COPY FROM {r_s:.2f} s ({st['slow_float_rows']} "
              f"parsed through numpy, {st['host_rows']} fields typed row by "
              f"row); the column reads back bit for bit [{card}]")
        del con
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 23: the repo's measuring programs (bench/h2oai_scale.py,
# bench/operators.py, bench/flagship.py)
# ---------------------------------------------------------------------------

H2OAI_SCALE_TIMEOUT_S = 900     # from its start, beside phases 18 and 17c
H2OAI_SCALE_HOST_GIB = 16       # 1e8 rows on the host (4.4 GB), q10's answer
# the runs of 23a, one process each, one after the other: phase 9 (numpy
# at 1e7 rows, uniform keys); DuckDB's checksums at 1e8 rows; numpy at 1e7
# and Zipf 1.1; BASELINE config 4 (1e8 rows at Zipf 1.1) timed on one
# device and over four shards
H2OAI_SCALE_RUNS = (
    ("9", ["--n", str(H2OAI_CHECKED_ROWS), "--skew", "0", "--check"]),
    ("i", ["--n", "100000000", "--skew", "0", "--oracle-1e8"]),
    ("ii", ["--n", "10000000", "--skew", "1.1", "--check"]),
    ("iii", ["--n", "100000000", "--skew", "1.1", "--runs", str(WARM_RUNS),
             "--dist", "4"]),
)
OPERATOR_FRAC_MAX = 1.05        # at 59,986,052 rows; above it the probe is wrong


def start_h2oai_scale(device="cuda"):
    """Phase 23a, started: H2OAI_SCALE_RUNS through `python -m
    ddb_tpu_torch.bench.h2oai_scale`, each in a process of its own, one
    after the other from a thread (the first failure ends the series);
    their records and logs go to a temporary directory."""
    import tempfile
    import threading
    avail = mem_available_gib()
    if avail < H2OAI_SCALE_HOST_GIB:
        raise AssertionError(f"phase 23a: MemAvailable {avail:.1f} GiB, "
                             f"under the {H2OAI_SCALE_HOST_GIB} GiB that "
                             f"1e8 rows need on the host")
    root = os.path.dirname(os.path.abspath(__file__))
    state = {"dir": tempfile.mkdtemp(prefix="ddb_tpu_torch_phase23_"),
             "runs": {}, "proc": None, "stop": False, "device": device,
             "t0": time.perf_counter(), "mem_gib": avail}

    def work():
        for label, args in H2OAI_SCALE_RUNS:
            if state["stop"]:
                return
            base = os.path.join(state["dir"], label)
            t0 = time.perf_counter()
            with open(base + ".log", "w") as log:
                state["proc"] = subprocess.Popen(
                    [sys.executable, "-m", "ddb_tpu_torch.bench.h2oai_scale",
                     *args, "--device", device, "--json", base + ".json"],
                    cwd=root, stdout=subprocess.DEVNULL, stderr=log)
                rc = state["proc"].wait()
            state["runs"][label] = {"rc": rc, "s": time.perf_counter() - t0}
            if rc != 0:
                return

    state["thread"] = threading.Thread(target=work, daemon=True)
    state["thread"].start()
    return state


def stop_h2oai_scale(state):
    """Ends phase 23a's series and its process if they still run, and
    removes its files."""
    import shutil
    state["stop"] = True
    proc = state["proc"]
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.wait()
    state["thread"].join()
    shutil.rmtree(state["dir"], ignore_errors=True)


def _gib(b):
    return b / 2**30


def finish_h2oai_scale(state, card):
    """Phase 23a, read: waits for the series (at most
    H2OAI_SCALE_TIMEOUT_S from its start) and fails on a nonzero exit, a
    checksum unlike DuckDB's, a failed numpy check, or rows over four
    shards unlike one device's."""
    left = state["t0"] + H2OAI_SCALE_TIMEOUT_S - time.perf_counter()
    state["thread"].join(timeout=max(left, 1.0))
    if state["thread"].is_alive():
        raise AssertionError(f"phase 23a: still running after "
                             f"{H2OAI_SCALE_TIMEOUT_S} s")
    recs = {}
    for label, args in H2OAI_SCALE_RUNS:
        run = state["runs"].get(label)
        base = os.path.join(state["dir"], label)
        if run is None or run["rc"] != 0:
            if os.path.exists(base + ".log"):
                with open(base + ".log") as f:
                    print(f.read()[-6000:])
            raise AssertionError(f"phase 23a({label}): {' '.join(args)} "
                                 f"gave {run}")
        with open(base + ".json") as f:
            recs[label] = rec = json.load(f)
        t = rec["table"]
        tag = "phase 9" if label == "9" else f"phase 23a({label})"
        print(f"{tag}: {' '.join(args)}: {t['n']} rows, K "
              f"{t['k']}, skew {t['skew']}: generated in "
              f"{rec['generate_s']:.1f} s, resident in "
              f"{rec['resident_s']:.1f} s "
              f"({_gib(rec.get('resident_bytes', 0)):.2f} GiB); process "
              f"{run['s']:.1f} s [{rec.get('card', rec['device'])}]")
    rec = recs["9"]
    print(f"phase 9: q1-q10 at {rec['table']['n']} rows equal numpy (q6 and "
          f"q8 their oracles) in {rec['check']['s']:.1f} s, in phase 23a's "
          f"series beside phase 18; live rows {rec['check']['groups']}")
    # (i): DuckDB's own checksums at 1e8 rows
    rec = recs["i"]
    for q, ours in rec["ours"].items():
        print(f"phase 23a(i): q{q} {ours} against DuckDB's "
              f"{rec['oracle'][q]}: {'match' if rec['match'][q] else 'DIFFER'}"
              f" ({rec['queries'][q]['ms']:.1f} ms CTAS and checksum)")
    if not (len(rec["match"]) == 10 and all(rec["match"].values())):
        raise AssertionError(f"phase 23a(i): checksums differ from "
                             f"DuckDB's: {rec['match']}")
    print("phase 23a(i): all ten checksums at 1e8 rows match DuckDB's "
          "(integers exactly, floats to 1e-9)")
    # (ii): numpy at 1e7 rows and Zipf 1.1
    rec = recs["ii"]
    print(f"phase 23a(ii): every answer at 1e7 rows, skew 1.1 equals numpy "
          f"in {rec['check']['s']:.1f} s; live rows {rec['check']['groups']}")
    # (iii): BASELINE config 4, one device and four shards
    rec = recs["iii"]
    for q, r in rec["queries"].items():
        times = r["times_ms"]
        print(f"phase 23a(iii): h2oai q{q} at skew 1.1: "
              f"{r['median_ms']:.4f} ms median of {len(times)} (min "
              f"{min(times):.4f}, max {max(times):.4f}), "
              f"{rec['table']['n'] / (r['median_ms'] / 1e3):.4e} rows/s, "
              f"peak {_gib(r.get('peak_bytes', 0)):.2f} GiB; {r['groups']} "
              f"groups; checksum {r['checksum']} ({r['ms']:.1f} ms CTAS and "
              f"checksum); beside phase 18's host work "
              f"[{rec.get('card', rec['device'])}]")
    dist = rec["dist"]
    bad = {}
    for q, st in dist["status"].items():
        print(f"phase 23a(iii): q{q} over {dist['devices']} shards: "
              f"{st['groups']} rows, equal to one device's: {st['equal']}; "
              f"{st['ms']:.1f} ms; fallbacks {st['fallback']}")
        if st["equal"] is not True or st["fallback"]:
            bad[q] = st
    st = dist["exchange_stats"]
    print(f"phase 23a(iii): exchange retries {st['exchange_retries']}, "
          f"overflow rows {st['exchange_overflow_rows']}")
    if bad or len(dist["status"]) != 10:
        raise AssertionError(f"phase 23a(iii): over four shards: {bad}")
    print(f"phase 23a: ran in {time.perf_counter() - state['t0']:.1f} s "
          f"from its start [{card}]")
    return recs


def operators_phase(F, card, launches, work):
    """Phase 23b: bench/operators.py at the reference's 6,291,456 rows and
    at 59,986,052, each operator held to its plain computation; at the
    larger size no roofline fraction may read above OPERATOR_FRAC_MAX.
    Counts the Q1 kernel's launches; returns the larger size's file."""
    from ddb_tpu_torch.bench import operators
    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    recs, path = {}, None
    for n in (operators.REFERENCE_ROWS, operators.LARGE_ROWS):
        t0 = time.perf_counter()
        rec = recs[n] = operators.run(n)
        path = os.path.join(work, f"operators_{n}.json")
        with open(path, "w") as f:
            json.dump(rec, f)
        for name, r in rec["results"].items():
            print(f"phase 23b: {name} at {n} rows: {r['rows_per_sec']:.4e} "
                  f"rows/s, {r['ms']:.4f} ms a launch, "
                  f"{r['roofline_frac']:.4f} of its roofline "
                  f"{r['roofline']:.4e} [{rec['chip']}]")
        print(f"phase 23b: {n} rows in {time.perf_counter() - t0:.1f} s")
    got = dict(F.LAUNCHES)
    if got["q1"] < 1:
        raise AssertionError(f"phase 23b: the Q1 kernel never launched: "
                             f"{got}")
    for k, v in got.items():
        launches[k] += v
    over = {op: r["roofline_frac"] for op, r in
            recs[operators.LARGE_ROWS]["results"].items()
            if r["roofline_frac"] > OPERATOR_FRAC_MAX}
    if over:
        raise AssertionError(f"phase 23b: fractions above "
                             f"{OPERATOR_FRAC_MAX} at "
                             f"{operators.LARGE_ROWS} rows: {over}")
    print(json.dumps({"operators": {
        str(n): {op: {k: r[k] for k in ("rows_per_sec", "roofline",
                                        "roofline_frac", "ms")}
                 for op, r in rec["results"].items()}
        for n, rec in recs.items()}, "launches": got, "card": card}))
    return path


def flagship_phase(F, card, launches, operators_path):
    """Phase 23c: bench/flagship.py's line, from q1_kernel and q6_kernel
    launches that the kernels record counts."""
    from ddb_tpu_torch.bench import flagship
    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    line = flagship.run(operators_path=operators_path)
    got = dict(F.LAUNCHES)
    if min(got.values()) < 1:
        raise AssertionError(f"phase 23c: kernel launches {got}")
    for k, v in got.items():
        launches[k] += v
    print(f"phase 23c: flagship: {line['value']:.4e} rows/s, "
          f"{line['vs_baseline']:.4f} of 3.35 TB/s over 24 B a row; "
          f"kernel launches {got} [{card}]")
    print(json.dumps(line))
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    profile = "--profile" in argv
    t_start = time.perf_counter()
    # ---- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import ddb_tpu_torch
    from ddb_tpu_torch import kernels
    from ddb_tpu_torch.bench.fused_agg_cases import (cases, port_case_inputs,
                                                     port_cases)
    from ddb_tpu_torch.bench.operators import card_line
    from ddb_tpu_torch.bench import cmpx_probe, tpch, window_cases
    from ddb_tpu_torch.bench import h2oai as H
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES, register_synth_lineitem
    from ddb_tpu_torch.ops import cmpx as C
    from ddb_tpu_torch.ops import aggregate as A
    from ddb_tpu_torch.ops import fused_agg as F

    timed_ms = cmpx_probe.time_ms      # median of 7 warm runs, CUDA events
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"phase 1: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; host MemAvailable "
          f"{mem_available_gib():.1f} GiB")

    # ---- 2. build ----------------------------------------------------------
    lib = kernels.load()
    print(f"phase 2: built {lib.path.name} in {lib.build_seconds:.2f} s")
    # the database files' native library (g++ and zlib), built in place
    from ddb_tpu_torch.storage import persist
    t0 = time.perf_counter()
    dtb = persist.build_native(force=True)
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(f"phase 2: built {os.path.relpath(dtb)} with {gxx} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line \
                or "Compiling entry" in line:
            print("  ptxas:", line.strip().removeprefix("ptxas info    : "))

    # ---- 3. kernels vs plain versions --------------------------------------
    worst = check_kernels_vs_plain(F, cases(), dev)
    worst["q1"] = max(worst["q1"], check_q1_port_cases(
        F, port_cases(), port_case_inputs, dev))
    if F.LAUNCHES["q1"] == 0 or F.LAUNCHES["q6"] == 0:
        raise AssertionError(f"phase 3: kernels did not launch: "
                             f"{F.LAUNCHES}")

    # ---- 4. the main path at SF10 scale ------------------------------------
    t0 = time.perf_counter()
    con = ddb_tpu_torch.connect(device="cuda")
    register_synth_lineitem(con, SF10_LINEITEM_ROWS, seed=0)
    resident_path(con, 4, SF10_LINEITEM_ROWS)
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
    A.LAUNCHES["dense"] = 0
    t0 = time.perf_counter()
    results, rows1, rows6, kin, sums, rev = main_path()
    launches = dict(F.LAUNCHES, dense=A.LAUNCHES["dense"])
    print(f"phase 4: main path ran in {time.perf_counter() - t0:.2f} s "
          f"(first run); kernel launches {launches}")
    for k, v in launches.items():
        if v < 1:       # dense: SQL Q1's aggregate (csrc/dense_agg.cu)
            raise AssertionError(f"phase 4: kernel {k} never launched")
    on_card(results, "phase 4")
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
    # the same columns one row in: 4 bytes off alignment, 4-byte loads
    q1_off = [c[1:] for c in q1_args]
    if not torch.equal(F.q1_fused_aggregate(*q1_off, Q1_CUTOFF),
                       F.q1_fused_aggregate_plain(*q1_off, Q1_CUTOFF)):
        raise AssertionError("phase 4: full-size Q1 kernel with 4-byte "
                             "loads != plain version")
    print("phase 4: full-size kernels == plain versions, Q1 with 16-byte "
          "and with 4-byte loads")

    # ---- 5. timings --------------------------------------------------------
    n = td.num_rows
    all_ms = {name: cmpx_probe.times_ms(fn, WARM_RUNS) for name, fn in (
        ("sql_q1", lambda: con.execute(TPCH_QUERIES[1]).fetchall()),
        ("sql_q6", lambda: con.execute(TPCH_QUERIES[6]).fetchall()),
        ("q1_plain", lambda: F.q1_fused_aggregate_plain(*q1_args,
                                                        Q1_CUTOFF)),
        ("q1", lambda: F.q1_fused_aggregate(*q1_args, Q1_CUTOFF)),
        ("q1_4_byte_loads", lambda: F.q1_fused_aggregate(*q1_off,
                                                         Q1_CUTOFF)),
        ("q6", lambda: F.q6_fused_filter_sum(*q6_args, Q6_CUT)),
        ("q6_plain", lambda: F.q6_fused_filter_sum_plain(*q6_args, Q6_CUT)),
        # probes, not library calls for Q1: each streams the kernel's
        # six columns (24 B a row) once; the clone also writes them
        ("probe_six_sums", lambda: [
            torch.sum(c, dtype=torch.int64) for c in q1_args]),
        ("probe_six_maxima", lambda: [c.max() for c in q1_args]),
        ("probe_six_clones", lambda: [c.clone() for c in q1_args]))}
    ms = {name: statistics.median(t) for name, t in all_ms.items()}
    for name, t in ms.items():
        print(f"phase 5: {name}: {t:.4f} ms median of {WARM_RUNS} "
              f"(min {min(all_ms[name]):.4f}, max {max(all_ms[name]):.4f}),"
              f" {n / (t / 1e3):.4e} rows/s at {n} rows [{card}]")
    # a median above brackets one call with events, so it holds the time
    # the device waits for the host inside the wrapper; queued launches
    # show the kernel (and the zeroing of its output) alone
    b2b = {}
    for name, fn in (
            ("q1", lambda: F.q1_fused_aggregate(*q1_args, Q1_CUTOFF)),
            ("q6", lambda: F.q6_fused_filter_sum(*q6_args, Q6_CUT))):
        b2b[name] = back_to_back_ms(fn)
        print(f"phase 5: {name}: {b2b[name]:.4f} ms a launch over 20 "
              f"launches queued back to back [{card}; {clocks_line()}]")
    for name, what, nbytes in (
            ("probe_six_sums", "six torch.sum(dtype=int64) calls", n * 24),
            ("probe_six_maxima", "six torch.max calls", n * 24),
            ("probe_six_clones", "six clone() calls, read + write", n * 48)):
        print(f"phase 5: probe: {what} over the Q1 columns moved "
              f"{nbytes / ms.pop(name) / 1e9:.4f} TB/s; the Q1 kernel reads "
              f"{n * 24 / ms['q1'] / 1e9:.4f} TB/s [{card}]")
    for vec in (True, False):
        shape = F.q1_launch_shape(dev, vec)
        print(f"phase 5: q1_kernel with {'16' if vec else '4'}-byte loads: "
              f"{shape.blocks(n)} blocks of "
              f"{shape.threads} threads at {n} rows, {shape.registers} "
              f"registers a thread, {shape.shared_bytes} B of dynamic "
              f"shared memory a block, {shape.resident_blocks} resident "
              f"blocks ({shape.resident_blocks * shape.threads // 32} warps)"
              f" an SM on {shape.sms} SMs")

    ms["dense"] = dense_phase(con, n, card)

    # ---- 17a, b, f: streamed at the defaults, before RF1 -----------------
    del kin, q1_args, q1_off, q6_args, results
    t17 = time.perf_counter()
    rates = h2d_probe(dev, card)
    streamed_sf10(con, td, dev, card, F, sums, rev, ms, rates["pinned"])
    phase17_s = time.perf_counter() - t17

    # ---- 4, continued: RF1 grows the table; the kernels see the rows ---
    rf1 = ddb_tpu_torch.connect(device="cuda")
    register_synth_lineitem(rf1, RF1_LINEITEM_ROWS, seed=1)
    rf1_table = rf1.catalog.get_table("lineitem")
    rf1_table.name = "lineitem_rf1"
    con.catalog.add_table(rf1_table)
    del rf1, rf1_table
    t0 = time.perf_counter()
    con.execute("INSERT INTO lineitem SELECT * FROM lineitem_rf1")
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    td.device_batch(device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    for k in F.LAUNCHES:
        F.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    results, rows1, rows6, kin, sums, rev = main_path()
    rf1_launches = dict(F.LAUNCHES)
    print(f"phase 4: RF1 INSERT INTO lineitem SELECT of "
          f"{RF1_LINEITEM_ROWS} rows in {insert_s * 1e3:.1f} ms; the table "
          f"({td.num_rows} rows) re-uploaded in {upload_s * 1e3:.1f} ms; "
          f"then the main path in {time.perf_counter() - t0:.2f} s, "
          f"kernel launches {rf1_launches} [{card}]")
    if td.num_rows != n + RF1_LINEITEM_ROWS or len(td._device_batches) != 1 \
            or min(rf1_launches.values()) < 1:
        raise AssertionError(f"phase 4 after RF1: {td.num_rows} rows, "
                             f"{len(td._device_batches)} cached batches, "
                             f"launches {rf1_launches}")
    on_card(results, "phase 4 after RF1")
    check_q1(rows1, sums, F)
    want6 = decimal.Decimal(rev).scaleb(-4)
    if rows6 != [(want6,)]:
        raise AssertionError(f"Q6 after RF1: SQL {rows6} != kernel {want6}")
    plain1 = F.q1_fused_aggregate_plain(
        *[kin[c] for c in ("qty", "ext", "disc", "tax", "ship", "gid")],
        Q1_CUTOFF).cpu().numpy()
    plain6 = int(F.q6_fused_filter_sum_plain(
        *[kin[c] for c in ("qty", "ext", "disc", "ship")], Q6_CUT))
    if not (np.array_equal(plain1, sums) and plain6 == rev):
        raise AssertionError("phase 4 after RF1: kernel != plain version")
    print(f"phase 4: after RF1, SQL Q1 and Q6 (revenue {want6}) equal the "
          f"kernels over the grown table exactly; both kernels equal their "
          f"plain versions")

    # ---- 20e, f: the grown table through a '|' file (and Parquet) --------
    t0 = time.perf_counter()
    del kin, results
    lineitem_csv_phase(con, dev, card, F, launches, worst)
    phase20_s = time.perf_counter() - t0

    del con, td
    torch.cuda.empty_cache()
    print(f"phase 5: dropped the lineitem table of phase 4; "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB resident")

    # ---- 6. compare-exchange kernel vs plain version -----------------------
    for name, hi, lo, rows, stages, dmin in cmpx_probe.cases():
        worst["cmpx"] = max(worst.get("cmpx", 0), check_cmpx(
            C, name, torch.from_numpy(hi).to(dev),
            torch.from_numpy(lo).to(dev), rows, stages, dmin))
    cmpx_in = cmpx_probe.make_inputs(seed=0, device=dev)
    worst["cmpx"] = max(worst["cmpx"], check_cmpx(
        C, "probe shape", *cmpx_in, cmpx_probe.ROWS, cmpx_probe.STAGES, 1))
    large = cmpx_probe.make_inputs(CMPX_LARGE_TILES, seed=1, device=dev)
    worst["cmpx"] = max(worst["cmpx"], check_cmpx(
        C, "large shape", *large, cmpx_probe.ROWS, cmpx_probe.STAGES, 1))
    ms["cmpx_large"] = cmpx_probe.run(inputs=large)[0]["ms"]
    ms["cmpx_large_plain"] = timed_ms(
        lambda: C.cmpx_stages_plain(*large), runs=3)
    ms["cmpx_large_clone"] = timed_ms(
        lambda: (large[0].clone(), large[1].clone()))
    large_pairs = large[0].numel()
    del large
    torch.cuda.empty_cache()

    # ---- 7. the join path at SF10 scale ------------------------------------
    t0 = time.perf_counter()
    con = ddb_tpu_torch.connect(device="cuda")
    host = tpch.register_synth_join_tables(
        con, tpch.SF10_CUSTOMERS, tpch.SF10_ORDERS, seed=0)
    for t in ("customer", "orders", "lineitem"):
        con.catalog.get_table(t).device_batch(device=dev)
    torch.cuda.synchronize()
    counts = {t: con.catalog.get_table(t).num_rows
              for t in ("customer", "orders", "lineitem")}
    resident_path(con, 7, counts["lineitem"])
    print(f"phase 7: {counts} rows resident on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")

    def join_path():
        rec, _ = cmpx_probe.run(inputs=cmpx_in)
        res3 = con.execute(TPCH_QUERIES[3])
        res4 = con.execute(TPCH_QUERIES[4])
        return rec, (res3, res4), res3.fetchall(), res4.fetchall()

    for k in C.LAUNCHES:
        C.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    cmpx_rec, results, rows3, rows4 = join_path()
    launches.update(C.LAUNCHES)
    print(f"phase 7: join path ran in {time.perf_counter() - t0:.2f} s "
          f"(first run); kernel launches {dict(C.LAUNCHES)}")
    if launches["cmpx"] < 1:
        raise AssertionError("phase 7: kernel cmpx never launched")
    on_card(results, "phase 7")
    for t in counts:
        copies = list(con.catalog.get_table(t)._device_batches)
        if len(copies) != 1:
            raise AssertionError(f"phase 7: {t} is resident {len(copies)} "
                                 f"times: {copies}")
    t0 = time.perf_counter()
    oracle3, oracle4 = tpch.q3_oracle(host), tpch.q4_oracle(host)
    check_q3(rows3, oracle3)
    if rows4 != oracle4 or not rows4:
        raise AssertionError(f"Q4: SQL {rows4} != oracle {oracle4}")
    print(f"phase 7: SQL Q3 (top 10 of {len(oracle3)} groups) and Q4 "
          f"({sum(n for _, n in rows4)} orders) equal the numpy oracle "
          f"exactly ({time.perf_counter() - t0:.1f} s on the host)")
    for row in rows3[:3]:
        print("  Q3", row)
    for row in rows4:
        print("  Q4", row)
    ms["cmpx"] = cmpx_rec["ms"]
    print(f"phase 7: {json.dumps(cmpx_rec)}")

    # ---- 8. timings of the join path ---------------------------------------
    for name, q in (("sql_q3", 3), ("sql_q4", 4)):
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        ms[name] = timed_ms(lambda: con.execute(TPCH_QUERIES[q]).fetchall())
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"phase 8: {name}: {ms[name]:.4f} ms median of {WARM_RUNS}, "
              f"{counts['lineitem'] / (ms[name] / 1e3):.4e} lineitem rows/s;"
              f" peak {peak / 2**30:.2f} GiB on the card, "
              f"{(peak - before) / 2**30:.2f} GiB above the tables "
              f"[{card}]")
    b2b["cmpx"] = back_to_back_ms(lambda: C.cmpx_stages(
        *cmpx_in, cmpx_probe.ROWS, cmpx_probe.STAGES, 1))
    print(f"phase 8: cmpx: {b2b['cmpx']:.4f} ms a launch over 20 launches "
          f"queued back to back [{card}; {clocks_line()}]")
    ms["cmpx_plain"] = timed_ms(lambda: C.cmpx_stages_plain(*cmpx_in))
    ms["cmpx_clone"] = timed_ms(
        lambda: (cmpx_in[0].clone(), cmpx_in[1].clone()))
    pairs = cmpx_in[0].numel()
    for name, np_ in (("cmpx", pairs), ("cmpx_plain", pairs),
                      ("cmpx_clone", pairs), ("cmpx_large", large_pairs),
                      ("cmpx_large_plain", large_pairs),
                      ("cmpx_large_clone", large_pairs)):
        print(f"phase 8: {name}: {ms[name]:.4f} ms, "
              f"{np_ * cmpx_probe.STAGES / ms[name] / 1e6:.1f} G "
              f"element-stages/s at {np_} pairs [{card}]")
    if profile:
        profile_sql(con, TPCH_QUERIES[3], "sql_q3")
        profile_sql(con, TPCH_QUERIES[4], "sql_q4")

    # ---- 19a, c: distributed joins and the exchange at SF10 ----------------
    t19 = time.perf_counter()
    dist_joins_phase(con, dev, card, rows3, oracle3, ms)
    dist_exchange_phase(con, dev, card)
    phase19_s = time.perf_counter() - t19
    del results, oracle3, oracle4

    # ---- 16. DML at SF10 on phase 7's resident tables ---------------------
    t0 = time.perf_counter()
    _, rows3, rows4 = dml_phase(con, host, dev, card)
    print(f"phase 16: ran in {time.perf_counter() - t0:.1f} s")

    # ---- 17e, g: the external join and the buffer manager -----------------
    t17 = time.perf_counter()
    memory_phase(con, dev, card, rows3, rows4)
    phase17_s += time.perf_counter() - t17
    del con, host
    torch.cuda.empty_cache()

    # ---- 9. runs in phase 23a's series of processes, beside phase 18 -------

    # ---- 10. h2oai group-by suite, full size ---------------------------------
    t0 = time.perf_counter()
    con = H.register(
        ddb_tpu_torch.connect(device="cuda"),
        H.generate(H2OAI_FULL_ROWS, k=H2OAI_K, seed=H2OAI_SEED))
    resident_path(con, 10, H2OAI_FULL_ROWS)
    t1 = time.perf_counter()
    con.catalog.get_table("x_group").device_batch(device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    print(f"phase 10: x_group {H2OAI_FULL_ROWS} rows: generated and "
          f"registered in {t1 - t0:.1f} s, resident on the card in "
          f"{time.perf_counter() - t1:.1f} s more, "
          f"{resident / 2**30:.2f} GiB [{card}]")

    for q in sorted(H.QUERIES):
        first, times, peak, syncs, live, _ = time_query(
            con, H.QUERIES[q], dev)
        all_ms[f"h2oai_q{q}"] = times
        t = ms[f"h2oai_q{q}"] = statistics.median(times)
        print(f"phase 10: h2oai q{q}: {t:.4f} ms median of {WARM_RUNS} "
              f"(min {min(times):.4f}, max {max(times):.4f}; first run "
              f"{first:.1f}), "
              f"{H2OAI_FULL_ROWS / (t / 1e3):.4e} rows/s, {live} result "
              f"rows, {syncs} host synchronisations a query; peak "
              f"{peak / 2**30:.2f} GiB on the card, "
              f"{(peak - resident) / 2**30:.2f} GiB above the table "
              f"[{card}]")
    rows8, groups8, groups6 = check_h2oai_full(con, H, dev)
    print(f"phase 10: q8's {rows8} rows hold max(v3) of each of {groups8} "
          f"id6 groups, at most 2 a group; q6 has {groups6} groups")
    if profile:
        profile_sql(con, H.QUERIES[6], "h2oai_q6", fetch=False)
        profile_sql(con, H.QUERIES[8], "h2oai_q8", fetch=False)

    # ---- 17d: the suite at the defaults --------------------------------------
    t17 = time.perf_counter()
    streamed_h2oai(con, H, dev, card, ms, resident)
    phase17_s += time.perf_counter() - t17

    # ---- 19b: the h2oai suite over four shards -------------------------------
    t19 = time.perf_counter()
    dist_h2oai_phase(con, H, dev, card, ms)
    phase19_s += time.perf_counter() - t19
    print(f"phase 19: ran in {phase19_s:.1f} s in all")

    # ---- 20b-d: the h2oai file written, loaded and queried ----------------
    t0 = time.perf_counter()
    h2oai_csv_phase(con, H, dev, card, ms)
    phase20_s += time.perf_counter() - t0
    del con
    torch.cuda.empty_cache()

    # ---- 11. device agreement on the window and holistic corpus --------------
    t0 = time.perf_counter()
    on_gpu = ddb_tpu_torch.connect(device="cuda")
    on_cpu = ddb_tpu_torch.connect(device="cpu")
    for name, tcols in window_cases.tables().items():
        on_gpu.register(name, tcols)
        on_cpu.register(name, tcols)
    corpus = {**window_cases.WINDOW, **window_cases.PORT_ONLY,
              **{"agg_" + k: v for k, v in window_cases.HOLISTIC.items()}}
    for name, sql in corpus.items():
        res = on_gpu.execute(sql)
        on_card([res], f"phase 11 {name}")
        # entropy near 0 is a difference of two logarithms
        same_rows(name, on_cpu.execute(sql).fetchall(), res.fetchall(),
                  atol=1e-12 if "entropy" in name else 0.0)
        if name in window_cases.EXPECTED and not name.startswith("agg_") \
                and res.fetchall() != window_cases.EXPECTED[name]:
            raise AssertionError(f"phase 11 {name}: not the expected rows")
    print(f"phase 11: {len(corpus)} window and holistic-aggregate "
          f"statements give the same rows on the card and on the CPU "
          f"({time.perf_counter() - t0:.1f} s)")

    # ---- 12. the dbgen loader -------------------------------------------------
    t0 = time.perf_counter()
    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "data", "tpch_sf0.01")
    tpch.load_tpch(on_gpu, data_dir)
    tpch.load_tpch(on_cpu, data_dir)
    loaded = {t: on_gpu.catalog.get_table(t).num_rows
              for t in tpch.TPCH_SCHEMAS}
    for q in TPCH_LOADER_QUERIES:
        res = on_gpu.execute(TPCH_QUERIES[q])
        on_card([res], f"phase 12 Q{q}")
        rows = res.fetchall()
        if not rows:
            raise AssertionError(f"phase 12: TPC-H {q} returned no rows")
        same_rows(f"TPC-H {q}", on_cpu.execute(TPCH_QUERIES[q]).fetchall(),
                  rows)
    print(f"phase 12: loaded {loaded} rows without an Arrow reader; TPC-H "
          f"{TPCH_LOADER_QUERIES} agree on the card and on the CPU "
          f"({time.perf_counter() - t0:.1f} s)")
    del on_gpu, on_cpu

    # ---- 20a, g, h: the CSV corpus on both devices; the caching
    # filesystem; doubles at full precision ----------------------------------
    t0 = time.perf_counter()
    csv_agreement_phase(card)
    cachefs_phase(card)
    full_precision_phase(dev, card)
    phase20_s += time.perf_counter() - t0
    print(f"phase 20: ran in {phase20_s:.1f} s in all")


    select_phases(dev, card, profile, ms, all_ms)

    # ---- 22a, started: the reference's test files in a process of their
    # own, beside phase 18, whose first minutes are the table's draw and
    # the CHECKPOINT's codec search on one host core (the card idle) ------
    suite, scale = start_refsuite(), None
    try:
        # ---- 23a, started: the h2oai programs, beside phase 18 too ------
        torch.cuda.empty_cache()
        scale = start_h2oai_scale()
        # ---- 18. durable databases and the client surface at SF10 -------
        t0 = time.perf_counter()
        phase21_s = durable_phase(dev, card, launches)
        print(f"phase 18: ran in {time.perf_counter() - t0 - phase21_s:.1f}"
              " s (phase 21 apart)")

        # ---- 17c: SF30 lineitem streamed, never resident ----------------
        t17 = time.perf_counter()
        sf30_phase(dev, card, F, rates["pinned"])
        phase17_s += time.perf_counter() - t17
        print(f"phase 17: ran in {phase17_s:.1f} s in all")

        # ---- 22a and 23a, read ----------------------------------------------
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        finish_refsuite(suite, card)
        finish_h2oai_scale(scale, card)
    finally:
        stop_refsuite(suite)
        if scale is not None:
            stop_h2oai_scale(scale)
    print(f"phase 22a, 23a: read in {time.perf_counter() - t0:.1f} s")
    # ---- 22b: the sort probe ----------------------------------------------
    sort_phase(card)
    # ---- 22c: the sort studies -------------------------------------------
    vpu = sort_studies_phase(card)
    launches["vpu_chain"] = vpu["launches"]
    worst["vpu_chain"] = 0
    ms["vpu_chain"], ms["vpu_chain_plain"] = vpu["ms"], vpu["plain_ms"]
    b2b["vpu_chain"] = vpu["b2b"]
    # ---- 23b, c: the operator probes at two sizes; the flagship's line ----
    import shutil
    import tempfile
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="ddb_tpu_torch_phase23_")
    try:
        flagship_phase(F, card, launches,
                       operators_phase(F, card, launches, work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 23b, c: ran in {time.perf_counter() - t0:.1f} s")
    print(f"chip_smoke: phases 1-23 ran in "
          f"{time.perf_counter() - t_start:.1f} s")

    # every input read once and every output written once; the operations
    # the function needs on this run's inputs
    bounds = {
        "q1": bound(n * 6 * 4 + F.GROUPS * F.PAYLOADS * 8,
                    n * Q1_OPS_PER_ROW),
        "q6": bound(n * 4 * 4 + 8, n * Q6_OPS_PER_ROW),
        "cmpx": bound(pairs * 2 * 4 * 2, pairs * cmpx_probe.STAGES
                      * CMPX_OPS_PER_ELEMENT_STAGE),
        "cmpx_large": bound(large_pairs * 2 * 4 * 2,
                            large_pairs * cmpx_probe.STAGES
                            * CMPX_OPS_PER_ELEMENT_STAGE),
        "vpu_chain": bound(vpu["n"] * 4 * 2, vpu["n"] * VPU_CHAIN_OPS),
    }
    for name, (b_ms, by) in bounds.items():
        print(f"bound: {name}: {b_ms:.4f} ms by {by}; measured "
              f"{ms[name]:.4f} ms, the bound is {b_ms / ms[name]:.3f} of it "
              f"[{card}]")
    # the compare-exchange bound at the int32 rate phase 22c measured (at
    # 8 times the study's size)
    for name, np_ in (("cmpx", pairs), ("cmpx_large", large_pairs)):
        nops = np_ * cmpx_probe.STAGES * CMPX_OPS_PER_ELEMENT_STAGE
        at = nops / vpu["rate"] * 1e3
        print(f"bound: {name} at the measured {vpu['rate']:.4e} int32 "
              f"ops/s: {at:.4f} ms by operations (at the published "
              f"{INT32_OP_PER_S:.4e}: {nops / INT32_OP_PER_S * 1e3:.4f} ms);"
              f" measured {ms[name]:.4f} ms, {at / ms[name]:.3f} of it "
              f"[{card}]")

    def record(name, key, source, replaces):
        # library_ms: no single PyTorch call computes any of the three
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": worst[key], "ms": ms[key],
                "plain_ms": ms[key + "_plain"], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": None,
                "back_to_back_ms": b2b[key]}

    print(json.dumps({"kernels": [
        record("q1_fused_aggregate", "q1",
               "ddb_tpu_torch/csrc/fused_agg.cu",
               "ddb_tpu/ops/pallas_agg.py:502"),
        record("q6_fused_filter_sum", "q6",
               "ddb_tpu_torch/csrc/fused_agg.cu",
               "ddb_tpu/ops/pallas_agg.py:575"),
        record("cmpx_stages", "cmpx", "ddb_tpu_torch/csrc/cmpx.cu",
               "scripts/exp_mosaic_cmpx.py:59"),
        # no TPU kernel: the XLA fusion the sort study times (case vpu_chain)
        record("vpu_chain", "vpu_chain", "ddb_tpu_torch/csrc/vpu_chain.cu",
               "scripts/bench_sort_study.py:120"),
        # no TPU kernel: the JAX package's dense path is XLA (phase 5b)
        {"name": "dense_sums", "route": "cuda",
         "source": "ddb_tpu_torch/csrc/dense_agg.cu", "replaces": None,
         "launches": launches["dense"],
         "max_abs_err": ms["dense"]["max_abs_err"],
         "ms": ms["dense"]["dense_sums"],
         "plain_ms": ms["dense"]["masked_loop"],
         "bound_ms": ms["dense"]["bound_ms"],
         "bound_by": ms["dense"]["bound_by"],
         "bound_live_rows_ms": ms["dense"]["bound_live_ms"],
         "library_ms": None,
         "back_to_back_ms": ms["dense"]["dense_sums_queued"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

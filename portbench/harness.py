"""One run of one cell: set-up, the measured window, the reference, the
result line.

Set-up draws the configuration's tables from the seed, registers each with
the program as a pyarrow Table (Connection.register), applies the
configuration's settings and sends one warm round, which also fetches
every answer table that a query names to verify.  The window is a
closed loop of one connection: rounds of the mix, a round started only
while the time left holds the longest round so far.  After the window the
program's state is freed and the reference answers each distinct query
text once on the same device; every answer of the window is compared with
its text's, and every row of each answer table the warm round fetched
with the reference's row for that group.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import columns, trace
from .compare import Tally
from .mix import Mix

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "ddb_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: Mix
    end_to_end: list        # metric entries of BENCHMARK.json
    per_layer: list
    limits: dict


def load_cell(workload: str, bench: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = json.loads(Path(bench).read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench}")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((Path(bench).parent / entry["file"]).read_text())
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in moved)]
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return Cell(workload, w["chips"], config,
                Mix.load(HERE / "traffic" / f"{w['traffic']}.json"),
                e2e, per_layer, limits["limits"])


def reader(name: str):
    """metrics/<name>.py's read()."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not
    load: jax, jaxlib, flax and the JAX package, whole names only."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Run:
    """What one run needs besides the cell: the device, the clock it
    started on, and the hooks a test uses to break the timed path."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool,
                 device: str = "cuda", t0: float | None = None):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.traced, self.device = traced, device
        self.t0 = time.perf_counter() if t0 is None else t0
        self.log = []           # earlier lines of standard output
        self.verified = []      # (request, rows of its answer table)

    # -- hooks ------------------------------------------------------------
    def program_tables(self, tables: dict) -> dict:
        """The tables handed to the program (a test may cut them)."""
        return tables

    def connect(self):
        import ddb_tpu_torch
        return ddb_tpu_torch.connect(self.device)

    def fetch(self, request, result):
        return result.fetchall()

    # -- the run ------------------------------------------------------------
    def span(self, name):
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def send(self, con, request, verify=False) -> list | None:
        """One request: its statements in order; the fetched rows, or None
        if a statement raised.  With `verify`, the request's verify
        statement too, its rows kept in self.verified."""
        rows = None
        try:
            with self.span(request.query):
                for step, sql, fetch in request.steps:
                    if verify and request.verify \
                            and step == request.verify[0]:
                        self.verified.append((request, self.fetch(
                            request, con.execute(request.verify[1]))))
                    with self.span(f"{request.query}.{step}"):
                        res = con.execute(sql)
                    if fetch:
                        with self.span(f"{request.query}.fetch"):
                            rows = self.fetch(request, res)
            return rows
        except Exception as e:   # a failed request is counted, not fatal
            print(f"request {request.key} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            for sql in self.cell.mix.on_failure:
                with contextlib.suppress(Exception):
                    con.execute(sql)
            return None

    def sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def execute(self) -> dict:
        import torch
        cell, mix = self.cell, self.cell.mix
        gen = importlib.import_module(
            f"portbench.generators.{cell.config['generator']}")
        ref = importlib.import_module(
            f"portbench.reference.{cell.config['reference']}")
        t_gen = time.perf_counter()
        tables = gen.generate(cell.config, self.seed)
        kinds = gen.kinds(cell.config)
        rows = {t: len(next(iter(c.values()))) for t, c in tables.items()}
        t_arrow = time.perf_counter()
        arrow = {t: columns.arrow_table(cols, kinds[t])
                 for t, cols in self.program_tables(tables).items()}

        t_reg = time.perf_counter()
        con = self.connect()
        for key, value in cell.config.get("settings", {}).items():
            con.execute(f"SET {key} = {value}")
        for t, table in arrow.items():
            con.register(t, table)
        del arrow
        t_warm = time.perf_counter()
        for req in mix.round(columns.seed_rng(self.seed, 0)):
            if self.send(con, req, verify=True) is None:
                self.log.append(f"the warm round failed at {req.key}")
        self.sync()
        warm_s = time.perf_counter() - t_warm
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - self.t0
        self.log.append(
            f"setup: start {t_gen - self.t0!r} s, generate {t_arrow - t_gen!r}"
            f" s, arrow {t_reg - t_arrow!r} s, register {t_warm - t_reg!r} s,"
            f" warm round {warm_s!r} s; rows {rows}")

        answers, latencies = [], []
        rng = columns.seed_rng(self.seed, 1)
        prof = trace.Profiler(self.device == "cuda") if self.traced \
            else contextlib.nullcontext()
        with prof:
            with self.span(trace.WINDOW):
                start = time.perf_counter()
                deadline = start + self.seconds
                end, longest = start, 0.0
                # whole rounds: one starts while the time left holds the
                # longest round so far
                while not answers or deadline - end >= longest:
                    for req in mix.round(rng):
                        t = time.perf_counter()
                        answers.append((req, self.send(con, req)))
                        latencies.append(time.perf_counter() - t)
                    longest = max(longest, time.perf_counter() - end)
                    end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if self.device == "cuda" \
            else 0
        del con
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

        # the reference, once for each distinct text, after the window
        t_ref = time.perf_counter()
        state = ref.prepare(tables, kinds, self.device)
        want = {}
        for req, _ in answers:
            if req.key not in want:
                want[req.key] = ref.answer(state, req.reference,
                                           dict(req.params))
        groups = [(req, got, ref.answer(state, req.verify[2],
                                        dict(req.params))[0])
                  for req, got in self.verified]
        del state
        tally = Tally(cell.limits)
        for req, got in answers:
            tally.add(req.key, got, want[req.key][0])
        for req, got, table in groups:
            tally.add((req.key, req.verify[2]), got, table)
        self.log.append(f"reference: {len(want)} texts and "
                        f"{len(groups)} answer tables in "
                        f"{time.perf_counter() - t_ref:.3f} s")
        if tally.first_mismatch:
            self.log.append(f"first mismatch: {tally.first_mismatch!r}")

        result = {"correct": tally.correct, "attempted": len(answers),
                  "failed": tally.failed}
        if self.traced:
            t = prof.trace
            t.queries = len(answers)
            t.min_bytes = sum(
                mix.read_bytes(req.query, rows, kinds, columns.width)
                + mix.write_bytes(req.query, want[req.key][1])
                for req, _ in answers)
            t.peak_bytes_per_s = self.peak_bytes_per_s()
            result["metrics"] = self.per_layer(t)
            result["breakdown"] = trace.breakdown(t)
            self.log.append("idle seconds by span: " + json.dumps(
                trace.idle_by_span(t)))
        else:
            result["metrics"] = self.end_to_end(
                answers, latencies, end - start, peak, setup_s)
        self.log.append(f"setup_s {setup_s!r} warm_round_s {warm_s!r} "
                        f"window_s {end - start!r}")
        by_query = {}
        for (req, _), lat in zip(answers, latencies):
            by_query.setdefault(req.query, []).append(lat * 1e3)
        for q, lat in sorted(by_query.items()):
            self.log.append(f"{q}: {len(lat)} requests, median "
                            f"{statistics.median(lat)!r} ms")
        result["device"] = self.device_record(peak, prof if self.traced
                                              else None)
        result["checks"] = tally.numbers()
        return result

    def peak_bytes_per_s(self):
        if self.device != "cuda":
            return None
        import torch
        peaks = json.loads((HERE / "peaks.json").read_text())
        return peaks.get(torch.cuda.get_device_name(0), {}).get(
            "hbm_bytes_per_s")

    def end_to_end(self, answers, latencies, window_s, peak, setup_s):
        values = {
            "queries_per_s": len(answers) / window_s,
            "query_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
            "peak_device_GiB": peak / 2**30,
            "setup_s": setup_s,
        }
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                for m in self.cell.end_to_end}

    def per_layer(self, t: trace.Trace) -> dict:
        out = {}
        for m in self.cell.per_layer:
            v = reader(m["name"])(t)
            if v is None:
                self.log.append(f"{m['name']}: not measured")
            else:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out

    def device_record(self, peak, prof) -> dict:
        import torch
        if self.device == "cuda":
            rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": self.cell.chips, "memory_peak_bytes": peak}
        else:
            rec = {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": peak}
        if prof is not None:
            rec["busy_s"] = trace.device_busy_us(prof.trace) / 1e6
            rec["window_s"] = prof.trace.window_s
        return rec

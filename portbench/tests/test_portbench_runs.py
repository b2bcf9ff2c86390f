"""Whole runs on the CPU at a tiny size (the look for a chip skipped):
the result line, and each fault of the timed path that the cell can have
comes out not correct."""

import os
import subprocess
import sys
from decimal import Decimal
from pathlib import Path

import pytest

from portbench.harness import Run
from portbench.tests.conftest import MIXES, tiny

ROOT = Path(__file__).resolve().parents[2]


def _run(cell, cls=Run, traced=False, seed=987654321987):
    return cls(cell, seed=seed, seconds=0.3, traced=traced,
               device="cpu").execute()


def test_a_run_is_correct_and_reports_its_metrics(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= len(cell.mix.queries)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 or name == "peak_device_GiB"
               for name, m in res["metrics"].items())
    assert list(res)[-1] == "checks"
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_a_traced_run_on_the_cpu_reads_no_device_metric(cell):
    res = _run(cell, traced=True)
    assert res["correct"]
    assert res["metrics"] == {}           # no CUDA kernel: not measured
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["breakdown"]["idle_gaps"][0][1] > 0


def _altered(v):
    if isinstance(v, bool) or v is None:
        return v
    if isinstance(v, (int, Decimal)):
        return v + 1
    if isinstance(v, float):
        return v * (1 + 1e-6)
    return v


class AnswerAltered(Run):
    """The last field of the first row of every 3rd answer, altered (a
    window holds at least one round, so one of its answers is)."""

    def fetch(self, request, result):
        rows = result.fetchall()
        self.fetched = getattr(self, "fetched", 0) + 1
        if self.fetched % 3 == 0 and rows:
            rows[0] = (*rows[0][:-1], _altered(rows[0][-1]))
        return rows


class KeysPermuted(Run):
    """The keys of every answer of more than one row rotated by a row, each
    group's values left where they were."""

    def fetch(self, request, result):
        rows = result.fetchall()
        if len(rows) < 2:
            return rows
        return [(rows[i - 1][0], *row[1:]) for i, row in enumerate(rows)]


class HalfTheRows(Run):
    """Every table handed to the program without the second half of its
    rows (the mean then taken over the rest)."""

    def program_tables(self, tables):
        return {t: {c: v[:len(v) // 2] for c, v in cols.items()}
                for t, cols in tables.items()}


class _StaleAns:
    def __init__(self, con):
        self.con, self.made = con, False

    def execute(self, sql):
        if sql.startswith("DROP TABLE ans"):
            return None
        if sql.startswith("CREATE TEMP TABLE ans"):
            if self.made:
                return None
            self.made = True
        return self.con.execute(sql)

    def __getattr__(self, name):
        return getattr(self.con, name)


class StateUnchanged(Run):
    """CREATE TEMP TABLE ans leaves the answer it made first."""

    def connect(self):
        return _StaleAns(super().connect())


@pytest.mark.parametrize("fault", [AnswerAltered, HalfTheRows])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("mix", [m for m in MIXES if m[1] == "basic"])
def test_keys_paired_with_the_wrong_values_are_not_correct(mix):
    res = _run(tiny(*mix), KeysPermuted)
    assert not res["correct"], res["checks"]
    assert res["checks"]["exact_mismatches"]["value"] > 0


@pytest.mark.parametrize("mix", [m for m in MIXES if "h2oai" in m[0]])
def test_an_answer_table_left_unchanged_is_not_correct(mix):
    res = _run(tiny(*mix), StateUnchanged)
    assert not res["correct"], res["checks"]


def test_the_command_needs_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "tpch_sf10.scan_agg", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=120)
    assert out.returncode == 2, out.stderr
    assert out.stdout == ""

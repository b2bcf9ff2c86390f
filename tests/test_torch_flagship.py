"""bench/flagship.py, the port of bench.py, on the CPU: the line's keys
are bench.py's, the Q6 entry's revenue is SQL Q6's over the same
synth_lineitem (whole units of quantity), the operators' rows fold in
with their origin, and a kernel that raises makes main() raise."""

import ast
import decimal
import json
import os

import pytest
import torch

import ddb_tpu_torch
from ddb_tpu_torch.bench import flagship, operators
from ddb_tpu_torch.bench.tpch import TPCH_QUERIES, register_synth_lineitem
from ddb_tpu_torch.ops import fused_agg

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 30_000


@pytest.fixture(scope="module", autouse=True)
def small_join():
    """The join probe at a CPU's size: 4,096 build and 8,192 probe rows
    (the card's are 2^20 and 6,291,456)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(operators, "JOIN_BUILD_ROWS", 1 << 12)
        mp.setattr(operators, "REFERENCE_ROWS", 1 << 13)
        yield


@pytest.fixture(scope="module")
def line(tmp_path_factory):
    path = tmp_path_factory.mktemp("ops") / "ops.json"
    operators.main(["--out", str(path), "--rows", "4000", "--device",
                    "cpu"])
    return flagship.run(N, device="cpu", operators_path=str(path))


def _bench_py_keys():
    """The keys of the dict bench.py's _bench_pallas prints."""
    with open(os.path.join(_ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "_bench_pallas")
    out = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "out")
    return [k.value for k in out.value.keys], out


def test_the_lines_keys_are_bench_pys(line):
    keys, out = _bench_py_keys()
    assert list(line) == keys
    metric = out.value.values[keys.index("metric")].value
    assert line["metric"] == metric == "tpch_q1_sf1_agg_rows_per_sec"
    assert line["unit"] == "rows/s" and line["kernel"] == "q1_kernel"
    assert line["vs_baseline"] == line["value"] / (3.35e12 / 24)
    assert line["suite"]["q1_agg_q1_kernel"] == line["value"]
    json.dumps(line)                     # one JSON line


def test_q6_revenue_is_sql_q6s_over_the_same_lineitem(line):
    con = register_synth_lineitem(ddb_tpu_torch.connect(device="cpu"), N,
                                  seed=0)
    (rev,), = con.execute(TPCH_QUERIES[6]).fetchall()
    assert rev > 0
    assert decimal.Decimal(line["suite"]["q6_revenue"]).scaleb(-4) == rev
    suite = line["suite"]
    assert suite["q6_filter_rows_per_sec"] == max(
        suite["q6_filter_cuda_rows_per_sec"],
        suite["q6_filter_plain_rows_per_sec"])
    assert suite["q6_filter_roofline_frac"] == \
        suite["q6_filter_rows_per_sec"] / (3.35e12 / 16)


def test_the_join_probe_and_the_operators_fold_in(line):
    suite = line["suite"]
    assert suite["join_probe_live_rows_per_sec"] > 0
    assert 0 < suite["join_probe_live_roofline_frac"]
    for key in ("hbm_probe", "filter", "sort", "join_probe",
                "exchange_pack", "aggregate"):
        assert suite[f"{key}_rows_per_sec"] > 0, key
        assert suite[f"{key}_source"].startswith(
            "operators file ops.json, 4000 rows, cpu (host), measured_at "), \
            key


def test_main_prints_one_line(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_ROWS", "5000")
    assert flagship.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and json.loads(out[0])["suite"]["rows"] == 5000


@pytest.mark.parametrize("kernel", ["q1_fused_aggregate",
                                    "q6_fused_filter_sum"])
def test_a_kernel_that_raises_makes_main_raise(monkeypatch, capsys, kernel):
    def broken(*a, **k):
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error 1")

    monkeypatch.setenv("BENCH_ROWS", "5000")
    monkeypatch.setattr(fused_agg, kernel, broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        flagship.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_a_wrong_kernel_result_raises(monkeypatch):
    monkeypatch.setattr(fused_agg, "q6_fused_filter_sum",
                        lambda *a: torch.tensor(1, dtype=torch.int64))
    with pytest.raises(AssertionError, match="Q6"):
        flagship.run(5000, device="cpu")


def test_run_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.run(1000)

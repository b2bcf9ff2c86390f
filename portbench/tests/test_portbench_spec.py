"""BENCHMARK.json against the benchmark's contract, the traffic files
against their sources, and the imports of every module here."""

import ast
import datetime
import json
import re
from pathlib import Path

import pytest

from portbench import columns
from portbench.mix import Mix

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_the_spec_has_the_contracts_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.fullmatch(n) for n in names)
    assert len({x["name"] for x in SPEC["end_to_end"] + SPEC["per_layer"]}) \
        == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"]
        assert set(cfg["reduced"]) == set(configs[w["config"]]["reduced"])
        assert all(k in cfg for k in cfg["reduced"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        limits = json.loads((HERE / "limits" / f"{w['name']}.json")
                            .read_text())["limits"]
        assert limits["failed"] == 0 and limits["exact_mismatches"] == 0
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)


def test_every_traffic_file_is_tested_on_the_cpu():
    from portbench.tests.conftest import MIXES
    assert sorted(t for _, t in MIXES) == sorted(
        p.stem for p in (HERE / "traffic").glob("*.json"))


def _mix(name):
    return Mix.load(HERE / "traffic" / f"{name}.json")


def distinct_texts(mix: Mix) -> int:
    """How many distinct texts a mix can draw."""
    total = 0
    for q in mix.queries:
        n = 1
        for d in q["params"].values():
            (kind, arg), = d.items()
            if kind == "choice":
                n *= len(arg)
            elif kind in ("int", "hundredths", "year"):
                n *= arg[1] - arg[0] + 1
            elif kind == "month":
                y0, m0 = map(int, arg[0].split("-"))
                y1, m1 = map(int, arg[1].split("-"))
                n *= y1 * 12 + m1 - (y0 * 12 + m0) + 1
            else:
                n *= (datetime.date.fromisoformat(arg[1])
                      - datetime.date.fromisoformat(arg[0])).days + 1
        total += n
    return total


def test_tpch_mixes_draw_the_specs_parameters():
    assert distinct_texts(_mix("scan_agg")) == 61 + 80
    assert distinct_texts(_mix("join")) == 155 + 58
    rng = columns.seed_rng(3)
    mix = _mix("join")
    drawn = {r.key for _ in range(4000) for r in mix.round(rng)}
    dates = {dict(k[1])["date"] for k in drawn if k[0] == "q4"}
    assert min(dates) == "1993-01-01" and max(dates) == "1997-10-01"
    days = {dict(k[1])["date"] for k in drawn if k[0] == "q3"}
    assert min(days) == "1995-03-01" and max(days) == "1995-03-31"
    q6 = _mix("scan_agg")
    sql = q6.request(q6.by_name["q6"], rng).steps[0][1]
    assert "interval '1' year" in sql and "{" not in sql


def test_a_seed_draws_the_same_requests():
    mix = _mix("scan_agg")
    a = [mix.round(columns.seed_rng(9, 1)) for _ in range(3)]
    b = [mix.round(columns.seed_rng(9, 1)) for _ in range(3)]
    assert a == b


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_imports_jax_or_the_jax_package(path):
    banned = {"jax", "jaxlib", "flax", "ddb_tpu"}
    if path.parent.name == "reference":
        banned.add("ddb_tpu_torch")
    assert not _imports(path) & banned

"""The benchmark's own tests: on the CPU at tiny sizes, and one marked
`card` that runs only where a CUDA device is (it skips elsewhere, decided
inside the test)."""

import json

import pytest

from portbench.harness import HERE, Cell
from portbench.mix import Mix

# every traffic file, with the configuration of its family
MIXES = [("tpch_sf10", "scan_agg"), ("tpch_sf10", "join"),
         ("h2oai_G1_1e8_1e2_0_0", "basic"),
         ("h2oai_G1_1e8_1e2_0_0", "advanced")]
LIMITS = {"failed": 0, "exact_mismatches": 0, "float_rel_gap": 1e-9}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


def tiny(config: str, traffic: str) -> Cell:
    """A configuration under a mix at a size a CPU test holds: SF0.02 for
    TPC-H, 2e5 rows for h2oai (K = 100, so id3 and id6 take 2,000
    values)."""
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    if cfg["generator"] == "tpch":
        cfg.update(scale_factor=0.02)
    else:
        cfg.update(rows=200_000)
    mix = Mix.load(HERE / "traffic" / f"{traffic}.json")
    assert mix.family == cfg["generator"]
    e2e = [{"name": "queries_per_s", "unit": "queries/s"},
           {"name": "setup_s", "unit": "s"}]
    return Cell(f"{config}.{traffic}", 1, cfg, mix, e2e, [], LIMITS)


@pytest.fixture(params=MIXES, ids=lambda m: f"{m[0]}.{m[1]}")
def cell(request):
    return tiny(*request.param)


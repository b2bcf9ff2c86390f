"""The advanced questions' configuration: the dataset of the basic one,
a deployment of its own."""

import json

import pytest

from portbench.harness import HERE, load_cell

BASIC = json.loads((HERE / "configs" / "h2oai_G1_1e8_1e2_0_0.json")
                   .read_text())
ADVANCED = json.loads(
    (HERE / "configs" / "h2oai_G1_1e8_1e2_0_0_advanced.json").read_text())


@pytest.mark.parametrize("key", ["generator", "reference", "rows", "k",
                                 "na_pct", "sorted", "settings", "reduced",
                                 "assumed"])
def test_the_advanced_configuration_draws_the_basic_dataset(key):
    assert ADVANCED[key] == BASIC[key]


def test_the_advanced_configuration_has_a_source_of_its_own():
    assert ADVANCED["source"] != BASIC["source"]
    assert "q6-q10" in ADVANCED["source"]


def test_the_advanced_cell_runs_its_configuration_and_the_advanced_mix():
    cell = load_cell("h2oai_G1_1e8_1e2_0_0.advanced")
    assert cell.config == ADVANCED
    assert [q["name"] for q in cell.mix.queries] == \
        ["q6", "q7", "q8", "q9", "q10"]

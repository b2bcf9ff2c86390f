"""The yardstick held to the upstream engine: at seed 108 and 1e8 rows
the reference's ten h2oai checksums equal DuckDB's own, from its CLI over
the same table (docs/H2OAI_SCALE_1e8.json, "oracle"): integers exactly,
floats to a relative 1e-9.

    python3 -m pytest portbench/tests -m card
"""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
def test_reference_checksums_equal_duckdbs_at_1e8_rows():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from portbench.generators import h2oai as gen
    from portbench.reference import h2oai as ref

    oracle = json.loads((ROOT / "docs" / "H2OAI_SCALE_1e8.json")
                        .read_text())["oracle"]
    config = {"rows": 100_000_000, "k": 100}
    state = ref.prepare(gen.generate(config, 108), gen.kinds(config),
                        "cuda")
    for q in range(1, 11):
        (row,), _ = ref.answer(state, f"q{q}", {})
        fields = oracle[str(q)].split(",")
        assert len(fields) == len(row), q
        for want, got in zip(fields, row):
            if "." in want or "e" in want:
                assert isinstance(got, float)
                assert got == pytest.approx(float(want), rel=1e-9), q
            else:
                assert got == int(want) and isinstance(got, int), q

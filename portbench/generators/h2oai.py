"""h2oai db-benchmark's group-by table x_group (G1_<rows>_<K>_<NA>_<sorted>)
drawn from a seed.

A frozen copy of ddb_tpu_torch/bench/h2oai_scale.py's generate_scale:
the same draws in the same order (its skew left at 0), so at seed 108,
1e8 rows and K = 100 the table is the one over which DuckDB's own CLI gave the
checksums in docs/H2OAI_SCALE_1e8.json.  id1-id3 are strings 'id001'..
(id1, id2: K values, 3 digits; id3: rows/K values, 10 digits), held as
codes into their labels; id4-id6, v1, v2 INTEGER; v3 DOUBLE rounded to 6
decimals.
"""

from __future__ import annotations

import numpy as np

from ..columns import seed_rng

ID_DIGITS = {"id1": 3, "id2": 3, "id3": 10}


def labels(name: str, count: int) -> tuple:
    """'id001'.. for the numbers 1..count of an id column; zero-padded,
    so label order is number order."""
    return tuple(f"id{v:0{ID_DIGITS[name]}d}" for v in range(1, count + 1))


def kinds(config: dict) -> dict:
    k, big = config["k"], max(config["rows"] // config["k"], 1)
    return {"x_group": {
        "id1": ("dict", labels("id1", k)), "id2": ("dict", labels("id2", k)),
        "id3": ("dict", labels("id3", big)), "id4": ("int32",),
        "id5": ("int32",), "id6": ("int32",), "v1": ("int32",),
        "v2": ("int32",), "v3": ("float64",)}}


def _codes(rng, k, n):
    return rng.integers(0, k, n).astype(np.int32)


def generate_scale(n, k=100, seed=108):
    """The columns of x_group, every id as the number in its label."""
    rng = seed_rng(seed)
    big = max(n // k, 1)
    return {
        "id1": _codes(rng, k, n) + 1,
        "id2": _codes(rng, k, n) + 1,
        "id3": _codes(rng, big, n) + 1,
        "id4": _codes(rng, k, n) + 1,
        "id5": _codes(rng, k, n) + 1,
        "id6": rng.integers(1, big + 1, n).astype(np.int32),
        "v1": rng.integers(1, 6, n).astype(np.int32),
        "v2": rng.integers(1, 16, n).astype(np.int32),
        "v3": np.round(rng.uniform(0, 100, n), 6),
    }


def generate(config: dict, seed: int) -> dict:
    """{"x_group": columns}, id1-id3 as codes (number - 1) into labels()."""
    if config.get("na_pct"):
        raise ValueError("NA variants are not generated")
    cols = generate_scale(config["rows"], config["k"], seed)
    for name in ID_DIGITS:
        cols[name] -= 1
    return {"x_group": cols}

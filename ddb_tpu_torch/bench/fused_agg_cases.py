"""Input sets for checking the fused Q1/Q6 kernels (ops/fused_agg.py).

The same seeds, sizes and bounds as the reference package's kernel tests
(tests/test_pallas.py), including the contract edges: disc = 100,
ext near 2^31, qty up to 2^20, and 256K rows at maximum ext.
Each case is (name, kernel, int32 numpy columns, scalar cutoff).
"""

from __future__ import annotations

import numpy as np


def _q1_columns(seed, n, extreme):
    rng = np.random.default_rng(seed)
    if extreme:
        cols = [rng.integers(0, 1 << 20, n), rng.integers(0, (1 << 31) - 1, n),
                rng.integers(0, 101, n)]
    else:
        cols = [rng.integers(100, 5100, n), rng.integers(90000, 520000000, n),
                rng.integers(0, 11, n)]
    cols += [rng.integers(0, 9, n), rng.integers(8000, 10600, n),
             rng.integers(0, 6, n)]
    return [c.astype(np.int32) for c in cols]


def _q6_random():
    n = 64 * 1024
    rng = np.random.default_rng(9)
    return [rng.integers(1, 51, n).astype(np.int32),
            rng.integers(90000, 520000000, n).astype(np.int32),
            rng.integers(0, 11, n).astype(np.int32),
            rng.integers(8000, 10600, n).astype(np.int32)]


def _q6_max_ext():
    n = 256 * 1024
    return [np.zeros(n, np.int32), np.full(n, (1 << 31) - 1, np.int32),
            np.full(n, 7, np.int32), np.full(n, 8800, np.int32)]


def cases():
    """[(name, "q1" | "q6", columns, cutoff)] in test_pallas.py order."""
    out = []
    for name, seed, n, extreme in (("q1_v2", 3, 4096, False),
                                   ("q1_v3", 5, 8192, False),
                                   ("q1_v3_extreme", 6, 2048, True),
                                   ("q1_v4", 7, 8192, False),
                                   ("q1_v4_extreme", 8, 2048, True),
                                   ("q1_v7", 9, 8192, False)):
        out.append((name, "q1", _q1_columns(seed, n, extreme),
                    9000 if extreme else 10471))
    out.append(("q6", "q6", _q6_random(), 8766))
    out.append(("q6_max_ext", "q6", _q6_max_ext(), 8766))
    return out

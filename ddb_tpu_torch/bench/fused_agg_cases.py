"""Input sets for checking the fused Q1/Q6 kernels (ops/fused_agg.py).

The same seeds, sizes and bounds as the reference package's kernel tests
(tests/test_pallas.py), including the contract edges: disc = 100,
ext near 2^31, qty up to 2^20, and 256K rows at maximum ext.
Each case is (name, kernel, int32 numpy columns, scalar cutoff).

`port_cases()` adds what only the port's Q1 kernel must take: any row
count, columns whose storage is not 16-byte aligned, rows that the
cutoff filters while their gid is outside [0, 6), and enough rows at the
contract's maxima in one thread to cross the kernel's flush interval.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _one_group(n, disc):
    """n rows of group 3 at the contract's maxima (qty 2^20, ext 2^31 - 1,
    tax 8), all passing the cutoff."""
    return [np.full(n, v, np.int32)
            for v in (1 << 20, (1 << 31) - 1, disc, 8, 0, 3)]


def port_cases():
    """[(name, columns, offsets, cutoff, blocks)] for q1_fused_aggregate.

    Column c of a case is columns[c][offsets[c]:]; `port_case_inputs`
    cuts it on the device, so that a non-zero offset leaves the tensor's
    storage 4, 8 or 12 bytes off a 16-byte boundary.  `blocks` is the
    grid to ask for (None: the wrapper's own).  One block over 300,000
    rows gives each thread about 1,172 rows: two flushes inside the loop
    and the last one."""
    aligned = (0,) * 6
    out = [(f"rows_{n}", _q1_columns(20 + i, n, False), aligned, 10471, None)
           for i, n in enumerate((0, 1, 3, 5, 1001, (1 << 16) + 1))]
    for k in (1, 2, 3):
        out.append((f"offset_{k}", _q1_columns(30 + k, 4099 + k, False),
                    (k,) * 6, 10471, None))
    for name, seed, n, extreme, offsets in (
            ("offsets_mixed", 34, 4099, False, (3, 1, 2, 0, 3, 1)),
            ("offsets_mixed_extreme", 35, 2051, True, (1, 2, 3, 1, 0, 2))):
        cols = [c[:n + k] for c, k in
                zip(_q1_columns(seed, n + 3, extreme), offsets)]
        out.append((name, cols, offsets, 9000 if extreme else 10471, None))
    out.append(("all_filtered", _q1_columns(36, 5000, False), aligned, 0,
                None))
    out.append(("one_group_maxima", _one_group(300_000, 0), aligned, 10471,
                1))
    out.append(("one_group_maxima_offset_1", _one_group(300_001, 0),
                (1,) * 6, 10471, 1))
    out.append(("one_group_max_disc", _one_group(300_000, 100), aligned,
                10471, 1))
    # flushes inside the loop while the cutoff splits every warp
    out.append(("extreme_one_block", _q1_columns(38, 300_003, True), aligned,
                9000, 1))
    out.append(("extreme_one_block_offset_2", _q1_columns(39, 300_002, True),
                (2,) * 6, 9000, 1))
    cols = _q1_columns(37, 4096, False)
    filtered = np.flatnonzero(cols[4] > 10471)
    cols[5][filtered] = np.resize(
        np.array([7, -1, (1 << 31) - 1], np.int32), filtered.size)
    out.append(("filtered_rows_with_gid_outside", cols, aligned, 10471,
                None))
    return out


def port_case_inputs(case, device):
    """(numpy columns, tensors on `device`) of one `port_cases()` entry,
    each cut at its offset after the move to the device."""
    _, cols, offsets, _, _ = case
    return ([c[k:] for c, k in zip(cols, offsets)],
            [torch.from_numpy(c).to(device)[k:]
             for c, k in zip(cols, offsets)])

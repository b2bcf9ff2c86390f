"""Probe: compare-exchange stage throughput on the GPU.

    python -m ddb_tpu_torch.bench.cmpx_probe [--tiles 96] [--rows 512]
        [--stages 45] [--dmin 1] [--seed 0] [--device cuda]

The counterpart of scripts/exp_mosaic_cmpx.py:main.  It makes the (hi,
lo) int32 tiles from a seed with numpy as that script does, runs
`ops.cmpx.cmpx_stages` over them (the inner loop of any bitonic
sort/merge kernel) and prints milliseconds and giga element-stages per
second: the number that decides whether a hand-written merge kernel can
beat the library's sort.  Times come from CUDA events around the launch
alone, so no round-trip constant is subtracted.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from ..ops import cmpx

ROWS = 512            # rows per tile: a tile is 64K int32 lanes
TILES = 96            # 6M elements in all
STAGES = 45           # the stages of one 512-row bitonic block
_CHUNK_TILES = 96     # tiles drawn at a time (bounds the host's memory)


def make_inputs(tiles: int = TILES, rows: int = ROWS, seed: int = 0,
                device="cuda"):
    """hi, lo int32 [tiles * rows, 128] on `device`, uniform in
    [0, 2^31).  Drawn hi then lo, 96 tiles at a time, so up to 96 tiles
    they are the script's own arrays for the same seed."""
    rng = np.random.default_rng(seed)
    his, los = [], []
    for start in range(0, tiles, _CHUNK_TILES):
        shape = (min(_CHUNK_TILES, tiles - start) * rows, cmpx.LANES)
        for parts in (his, los):
            a = rng.integers(0, 1 << 31, shape, dtype=np.int64)
            parts.append(torch.from_numpy(a.astype(np.int32)).to(device))
    return torch.cat(his), torch.cat(los)


def cases(seed: int = 0):
    """Small inputs that pin the semantics, as (name, hi, lo, rows,
    stages, dmin) with numpy int32 arrays: negative hi and lo, ties in
    hi, all-equal pairs, rows already in order, 64- and 512-row tiles,
    dmin 1 and 2, one tile and several, and stage counts that end inside
    the cycle of five distances."""
    rng = np.random.default_rng(seed)
    full = (-2**31, 2**31)

    def draw(tiles, rows, hi_range=full, lo_range=full):
        shape = (tiles * rows, cmpx.LANES)
        return (rng.integers(*hi_range, shape).astype(np.int32),
                rng.integers(*lo_range, shape).astype(np.int32))

    out = [("signed_64x1", *draw(1, 64), 64, 45, 1),
           ("ties_in_hi_64x3", *draw(3, 64, (-2, 2)), 64, 45, 1),
           ("ties_in_both_64x2", *draw(2, 64, (0, 2), (-1, 1)), 64, 13, 1),
           ("signed_512x2", *draw(2, 512), 512, 45, 1),
           ("dmin2_64x2", *draw(2, 64, (-3, 3)), 64, 45, 2),
           ("dmin2_512x3", *draw(3, 512), 512, 7, 2),
           ("dmin16_512x1", *draw(1, 512, (-3, 3)), 512, 45, 16),
           ("one_stage_64x1", *draw(1, 64), 64, 1, 1),
           ("no_stage_64x1", *draw(1, 64), 64, 0, 1)]
    equal = np.full((64, cmpx.LANES), -7, dtype=np.int32)
    out.append(("all_equal_64x1", equal, equal.copy(), 64, 45, 1))
    ramp = np.repeat(np.arange(-256, 256, dtype=np.int32)[:, None],
                     cmpx.LANES, 1)
    out.append(("sorted_512x1", ramp // 4, ramp.copy(), 512, 45, 1))
    out.append(("reversed_512x1", (ramp // 4)[::-1].copy(),
                ramp[::-1].copy(), 512, 45, 1))
    return out


def times_ms(fn, runs: int = 7) -> list:
    """Milliseconds of each of `runs` warm calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def time_ms(fn, runs: int = 7) -> float:
    """Median milliseconds of `runs` warm calls, by CUDA events."""
    return statistics.median(times_ms(fn, runs))


def run(tiles: int = TILES, rows: int = ROWS, stages: int = STAGES,
        dmin: int = 1, seed: int = 0, device="cuda", runs: int = 7,
        inputs=None):
    """Run the probe; returns its record and the kernel's (hi, lo)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the probe times the CUDA kernel: it needs a "
                           f"CUDA device, not {device}")
    hi, lo = inputs if inputs is not None \
        else make_inputs(tiles, rows, seed, device)
    out = cmpx.cmpx_stages(hi, lo, rows, stages, dmin)
    ms = time_ms(lambda: cmpx.cmpx_stages(hi, lo, rows, stages, dmin), runs)
    n = hi.numel()
    return {"tiles": hi.shape[0] // rows, "rows": rows, "stages": stages,
            "dmin": dmin, "pairs": n, "ms": ms,
            "giga_elt_stages_per_s": n * stages / (ms / 1e3) / 1e9,
            "device": torch.cuda.get_device_name(device)}, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", type=int, default=TILES)
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--stages", type=int, default=STAGES)
    ap.add_argument("--dmin", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    rec, _ = run(a.tiles, a.rows, a.stages, a.dmin, a.seed, a.device)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The control of a cell's comparison: the reference put in the program's
place, computed in the precision below the configuration's (float32 for
every float and decimal step), and held to the same limits.  A sound
comparison finds it not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --rounds 40

For each seed it draws the tables and `rounds` rounds of the window's
requests as a run does, answers each distinct text, and each answer table
that the warm round verifies, with both references on the card, and
prints the numbers compared beside their limits.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from . import columns
from .compare import Tally
from .harness import load_cell


def control(cell, seed: int, rounds: int, device: str) -> dict:
    gen = importlib.import_module(
        f"portbench.generators.{cell.config['generator']}")
    ref = importlib.import_module(
        f"portbench.reference.{cell.config['reference']}")
    tables = gen.generate(cell.config, seed)
    kinds = gen.kinds(cell.config)
    rng = columns.seed_rng(seed, 1)
    requests = [r for _ in range(rounds) for r in cell.mix.round(rng)]
    checks = [(r.key, r.reference, r.params) for r in requests] + [
        ((r.key, r.verify[2]), r.verify[2], r.params)
        for r in cell.mix.round(columns.seed_rng(seed, 0)) if r.verify]
    answers = {}
    for dtype in (torch.float64, torch.float32):
        state = ref.prepare(tables, kinds, device, dtype)
        for key, name, params in checks:
            if (key, dtype) not in answers:
                answers[key, dtype] = ref.answer(state, name,
                                                 dict(params))[0]
        del state
    tally = Tally(cell.limits)
    for key, _, _ in checks:
        tally.add(key, answers[key, torch.float32],
                  answers[key, torch.float64])
    return {"seed": seed, "requests": len(requests),
            "correct": tally.correct, "checks": tally.numbers()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--rounds", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in map(int, args.seeds.split(",")):
        print(json.dumps(control(cell, seed, args.rounds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

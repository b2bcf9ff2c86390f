"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

Runs on the machine it is started on and needs the cell's number of CUDA
devices; without them it prints no result and exits 2.  The last line of
standard output is the result's JSON object; the numbers compared with
the reference, each beside its limit, are the last lines of standard
error and the last key of that object.  Exits 3, with no result, if jax,
jaxlib, flax or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent.parent / ".portbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")

    import torch

    from .harness import Run, banned_modules, load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    result = run.execute()
    for line in run.log:
        print(line)
    if args.trace and not result["device"]["busy_s"] > 0:
        print("the trace holds no device activity", file=sys.stderr)
        return 1
    banned = banned_modules()
    if banned:
        print(f"loaded modules the benchmark must not load: {banned}",
              file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

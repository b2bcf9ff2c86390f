"""The reference's own test files, run against the port.

Each file named in FILES is copied from `tests/test_<name>.py` to
`tests/test_torch_ref_<name>.py` by `rewrite(name, text)`:

- every `ddb_tpu` becomes `ddb_tpu_torch`;
- every `connect(...)` and `Connection(...)` goes through this module's
  `connect` and `Connection`, which open the connection on `device()`:
  the torch device that DDB_TORCH_REF_DEVICE names, the CPU when it is
  unset.  "cuda" without CUDA raises; nothing falls back to the CPU;
- then the hunks of HUNKS apply, each named: the seams where the port's
  structure differs from the reference's (a method's name, a device
  argument, torch tensors where the reference passes jax arrays).

No copy skips, marks or loosens anything its reference file does not.
The copies import neither jax nor ddb_tpu, so they run where JAX is
absent, without tests/conftest.py (which imports it):

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_ref_*.py
    DDB_TORCH_REF_DEVICE=cuda python -m pytest --noconftest ... # the card

Regenerate the copies after a reference file or a hunk changes:

    python -m ddb_tpu_torch.testing.refsuite [name ...]

tests/test_torch_ref_copy.py holds every copy to its rewrite byte for
byte.  With DDB_TORCH_REF_REPORT set to a file name, the process writes
there, at exit, the connections opened by device type and the peak of
device memory allocated on the card (bytes, 0 when CUDA was not used).
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import re
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
TESTS = ROOT / "tests"

# The reference's test files that run against the port, by name
# (tests/test_<name>.py).
FILES = (
    "advice_r4", "advice_r5", "bit", "cachefs", "capi", "concurrency",
    "copy_arrow", "dependencies", "dml", "export_db", "external_sort",
    "foreign_key", "index", "json", "lists", "macro", "mvcc", "nested_cast",
    "persist", "pivot", "r4_breadth", "redo", "relation", "rowgroups_spill",
    "sketch", "sql", "statements", "streaming", "system", "tiled",
    "timestamptz", "tz", "udf", "union_type", "wal", "wide_sums", "window",
    "window_over_agg",
)

# The reference's test files that are not copied, with the reason.
LEFT_OUT = {
    "tpch": "needs the upstream source tree's TPC-H answers, which the "
            "repository does not hold",
    "tpcds": "needs the upstream source tree's TPC-DS query texts",
    "sqllogic": "needs the upstream source tree's sqllogictest scripts",
    "clickbench": "needs the upstream source tree's ClickBench query texts",
    "differential": "needs the oracle CLI built from the upstream source",
    "h2oai": "needs the oracle CLI: its 12 tests all skip with "
             "'oracle CLI not built'",
    "pallas": "tests the Pallas kernels; the port's CUDA kernels have "
              "tests/test_torch_fused_agg.py and test_torch_cmpx.py",
    "join_kernels": "tests the jitted join kernels; the port's have "
                    "tests/test_torch_join.py",
    "substrate": "tests the XLA substrate; the port's has "
                 "tests/test_torch_substrate.py",
    "parallel": "tests shard_map over a jax mesh; the port's mesh has "
                "tests/test_torch_parallel.py",
    "dist_executor": "tests the jax distributed executor; the port's has "
                     "tests/test_torch_dist_executor.py",
}

DEVICE_ENV = "DDB_TORCH_REF_DEVICE"
REPORT_ENV = "DDB_TORCH_REF_REPORT"

# connections opened through connect() and Connection(), by device type
OPENED: collections.Counter = collections.Counter()


def device() -> torch.device:
    """The device every copied test connects on: DDB_TORCH_REF_DEVICE,
    the CPU when it is unset."""
    return torch.device(os.environ.get(DEVICE_ENV, "cpu"))


def connect(database=None):
    """The reference's `connect(database=None)` on `device()`."""
    from .. import api
    con = api.connect(device(), database)
    OPENED[con.device.type] += 1
    return con


def Connection(database=None):  # noqa: N802 - stands for the class
    """The reference's `Connection(database=None)` on `device()`."""
    from .. import api
    dev = device()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Connection(device='cuda'): CUDA is not "
                           "available")
    con = api.Connection(dev, database)
    OPENED[con.device.type] += 1
    return con


class _Arrays:
    """What the reference's tests call of jax.numpy on the arrays they
    hand to an operator: `asarray`, here a torch tensor on device()."""

    @staticmethod
    def asarray(a):
        return torch.as_tensor(np.asarray(a), device=device())


arrays = _Arrays()


def _report(path):
    peak = torch.cuda.max_memory_allocated() \
        if torch.cuda.is_available() and torch.cuda.is_initialized() else 0
    with open(path, "w") as f:
        json.dump({"connections": dict(OPENED), "peak_bytes": int(peak)}, f)


if os.environ.get(REPORT_ENV):
    atexit.register(_report, os.environ[REPORT_ENV])


# ---------------------------------------------------------------------------
# the rewrite
# ---------------------------------------------------------------------------

HEADER = ("# Generated from tests/test_{name}.py by "
          "ddb_tpu_torch/testing/refsuite.py\n"
          "# (python -m ddb_tpu_torch.testing.refsuite {name}); "
          "do not edit.\n")

_IMPORT = "from ddb_tpu_torch.testing import refsuite\n"


class Hunk(NamedTuple):
    """A seam of one copy: `old` (the text after the generic rules)
    occurs `count` times in its file and becomes `new`."""
    name: str
    old: str
    new: str
    count: int = 1


_BUILD_CAPI = """    r = subprocess.run([{targets}],
                       cwd=NATIVE, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(os.path.join(NATIVE, ".."))
    env.pop("JAX_PLATFORMS", None){comment}
    r = subprocess.run([os.path.join(NATIVE, "{client}")], cwd=NATIVE,
"""
_BUILD_CAPI_PORT = """    native = str(capi.build().dir)
    env = capi.child_env(str(refsuite.device()))
    r = subprocess.run([os.path.join(native, "{client}")], cwd=native,
"""

HUNKS: Dict[str, List[Hunk]] = {
    # the port's C API: ddb_tpu_torch/capi.py builds the port's libraries
    # and links the reference's smoke clients against them in its own
    # build directory, reading the interpreter's flags from sysconfig (no
    # python3-config); the clients connect on refsuite.device()
    "capi": [
        Hunk("the port's build",
             'NATIVE = os.path.join(os.path.dirname(__file__), "..", '
             '"native")\n',
             "from ddb_tpu_torch import capi\n"),
        Hunk("no python3-config",
             '\n                    or shutil.which("python3-config") '
             'is None', "", 2),
        Hunk("capi_smoke through capi.build()",
             _BUILD_CAPI.format(targets='"make", "libddb_tpu.so", '
                                        '"capi_smoke"',
                                comment="   # capi defaults to cpu itself",
                                client="capi_smoke"),
             _BUILD_CAPI_PORT.format(client="capi_smoke")),
        Hunk("adbc_smoke through capi.build()",
             _BUILD_CAPI.format(targets='"make", "libddb_tpu.so", '
                                        '"libddb_tpu_adbc.so",\n'
                                        '                        '
                                        '"adbc_smoke"',
                                comment="", client="adbc_smoke"),
             _BUILD_CAPI_PORT.format(client="adbc_smoke"))],
    # the port caches a table's batch per device (TableData.device_batch)
    "external_sort": [
        Hunk("the per-device batch cache",
             "assert td._device_batch is None",
             "assert not td._device_batches")],
    "streaming": [
        Hunk("the per-device batch cache",
             "assert td._device_batch is None",
             "assert not td._device_batches")],
    # TableData.device_batch_rows takes the device as a keyword
    "index": [
        Hunk("device_batch_rows's device",
             """    def spy(self, cols, rows):
        calls.append(len(rows))
        return orig(self, cols, rows)
""", """    def spy(self, cols, rows, *, device):
        calls.append(len(rows))
        return orig(self, cols, rows, device=device)
""")],
    # the follower's connection is made on a device (redo.py's seam)
    "redo": [
        Hunk("the follower's device", "Follower(stream)",
             "Follower(stream, device=refsuite.device())", 4)],
    # the sketches take torch tensors on the device (the reference's
    # import line is spelled in two parts, so that no line of the port
    # reads as an import of jax)
    "sketch": [
        Hunk("torch tensors for jax arrays",
             "    import " + "jax.numpy as jnp\n",
             "    from ddb_tpu_torch.testing.refsuite import arrays as jnp\n",
             2)],
    # physical.ExecContext carries the device; execute's second
    # positional parameter is the device, so the context is a keyword
    "system": [
        Hunk("ExecContext on the device",
             """    ctx = physical.ExecutionContext(
        progress=lambda d, t: seen.append((d, t)))
    physical.execute(plan, ctx)
""", """    ctx = physical.ExecContext(
        refsuite.device(), progress=lambda d, t: seen.append((d, t)))
    physical.execute(plan, ctx=ctx)
""")],
}


def _generic(text: str) -> str:
    text = re.sub(r"\bddb_tpu\b", "ddb_tpu_torch", text)
    text = text.replace("ddb_tpu_torch.connect(", "refsuite.connect(")
    return text.replace("from ddb_tpu_torch import Connection\n",
                        "from ddb_tpu_torch.testing.refsuite import "
                        "Connection\n")


def rewrite(name: str, text: str) -> str:
    """The copy of the reference's tests/test_<name>.py."""
    text = _generic(text)
    for hunk in HUNKS.get(name, ()):
        if text.count(hunk.old) != hunk.count:
            raise ValueError(f"test_{name}.py: hunk {hunk.name!r} occurs "
                             f"{text.count(hunk.old)} times, not "
                             f"{hunk.count}")
        text = text.replace(hunk.old, hunk.new)
    if re.search(r"\brefsuite\.", text):
        # before the first top-level import
        m = re.search(r"(?m)^(?:import |from (?!__future__))", text)
        text = text[:m.start()] + _IMPORT + text[m.start():]
    return HEADER.format(name=name) + text


def source(name: str) -> Path:
    return TESTS / f"test_{name}.py"


def copy_path(name: str) -> Path:
    return TESTS / f"test_torch_ref_{name}.py"


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(FILES)
    for name in names:
        if name not in FILES:
            raise SystemExit(f"{name}: not one of refsuite.FILES")
        copy_path(name).write_text(rewrite(name, source(name).read_text()))
        print(copy_path(name).relative_to(ROOT))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the port's C API and its C clients, and run them.

`build()` compiles with the C compiler, at first use, into
_build/capi/<hash>/ next to this file, the hash covering the sources and
the flags, so an edited source rebuilds and an unchanged one is reused:

* libddb_tpu.so from native/capi.c: the C ABI of native/include/
  ddb_tpu_c.h over an embedded CPython that imports
  ddb_tpu_torch.capi_bridge;
* libddb_tpu_adbc.so from native/adbc.c: the ADBC driver over that ABI;
* capi_fetch from native/capi_fetch.c: runs SQL over a database through
  the C ABI and prints what `fetch_lines` describes;
* capi_smoke and adbc_smoke: the repository's own smoke clients
  (native/capi_smoke.c, native/adbc_smoke.c at the repository's root,
  read where they are), linked against the two libraries above.

Python's include and link flags are those of the interpreter that runs
the build (`sysconfig`), not those of whichever python3-config comes
first on PATH.  A C program started with `child_env()` embeds that same
interpreter: CPython finds its prefix from the first python3 on PATH.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Dict, List, Optional

_HERE = Path(__file__).resolve().parent
ROOT = _HERE.parent
SRC_DIR = _HERE / "native"
BUILD_DIR = _HERE / "_build" / "capi"
CFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra")

# the lines of capi_fetch's output that carry wall milliseconds
TIME_PREFIX = "time "
SHOWN_ROWS = 10                       # capi_fetch.c: SHOWN_ROWS
INT_CODES = frozenset(range(1, 7))    # BOOLEAN .. HUGEINT
FLOAT_CODES = frozenset((7, 8, 9))    # FLOAT, DOUBLE, DECIMAL


class Build:
    """The built libraries and programs, and what each build took."""

    def __init__(self, directory: Path, seconds: Dict[str, float]):
        self.dir = directory
        self.seconds = seconds          # {} when loaded from _build/

    def __getitem__(self, name: str) -> str:
        return str(self.dir / name)


_BUILD: Optional[Build] = None


def _cc() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if not cc:
        raise RuntimeError("no C compiler: the C API needs cc (or set CC)")
    return cc


def python_flags():
    """(include flags, link flags) of the running interpreter."""
    get = sysconfig.get_config_var
    inc = get("INCLUDEPY")
    libdir = get("LIBDIR")
    if not (Path(inc) / "Python.h").exists():
        raise RuntimeError(f"no Python.h under {inc}: the C API needs "
                           "the interpreter's headers")
    link = [f"-L{libdir}", f"-lpython{get('VERSION')}{get('ABIFLAGS') or ''}",
            f"-Wl,-rpath,{libdir}"]
    link += (get("LIBS") or "").split() + (get("SYSLIBS") or "").split()
    return [f"-I{inc}"], link


def _targets(inc, link):
    """[(output, [compiler arguments])] in build order."""
    here = ["-L.", "-Wl,-rpath,$ORIGIN"]
    smoke = ROOT / "native"
    return [
        ("libddb_tpu.so", [*inc, "-shared", "-o", "libddb_tpu.so",
                           str(SRC_DIR / "capi.c"), *link]),
        ("libddb_tpu_adbc.so", ["-shared", "-o", "libddb_tpu_adbc.so",
                                str(SRC_DIR / "adbc.c"), *here,
                                "-lddb_tpu"]),
        ("capi_fetch", ["-o", "capi_fetch", str(SRC_DIR / "capi_fetch.c"),
                        *here, "-lddb_tpu", *link]),
        ("capi_smoke", ["-o", "capi_smoke", str(smoke / "capi_smoke.c"),
                        *here, "-lddb_tpu", *link]),
        ("adbc_smoke", ["-o", "adbc_smoke", str(smoke / "adbc_smoke.c"),
                        *here, "-lddb_tpu_adbc", "-lddb_tpu", *link]),
    ]


def build() -> Build:
    """The C API and its clients, built on first use."""
    global _BUILD
    if _BUILD is not None:
        return _BUILD
    cc = _cc()
    inc, link = python_flags()
    targets = _targets(inc, link)
    h = hashlib.sha256(" ".join([cc, *CFLAGS]).encode())
    for _, args in targets:
        h.update(" ".join(args).encode())
        for a in args:
            if a.endswith(".c"):
                h.update(Path(a).read_bytes())
    for header in sorted((SRC_DIR / "include").glob("*.h")):
        h.update(header.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16]
    seconds: Dict[str, float] = {}
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        for name, args in targets:
            t0 = time.perf_counter()
            res = subprocess.run([cc, *CFLAGS, *args], cwd=tmp,
                                 capture_output=True, text=True)
            seconds[name] = time.perf_counter() - t0
            if res.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(f"building {name} failed "
                                   f"({res.returncode}):\n{res.stderr}")
        try:
            os.rename(tmp, out)
        except OSError:               # another process built it first
            shutil.rmtree(tmp, ignore_errors=True)
    _BUILD = Build(out, seconds)
    return _BUILD


def child_env(platform: Optional[str] = None) -> Dict[str, str]:
    """The environment of a C program that embeds the engine: the running
    interpreter's directory first on PATH, the repository first on
    PYTHONPATH, and DDB_CAPI_PLATFORM set to `platform` (a torch device)
    or unset, which connects on the card."""
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(
        [os.path.dirname(sys.executable)]
        + [p for p in env.get("PATH", "").split(os.pathsep) if p])
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if platform is None:
        env.pop("DDB_CAPI_PLATFORM", None)
    else:
        env["DDB_CAPI_PLATFORM"] = platform
    return env


def _c_cell(v):
    """(i, d, s) as capi.c's materialize stores a lowered value."""
    if isinstance(v, bool):
        return int(v), float(v), None
    if isinstance(v, int):
        i = v if -2**63 <= v < 2**63 else -1    # PyLong_AsLongLong
        return i, float(i), None
    if isinstance(v, float):
        if not -2.0**63 <= v < 2.0**63:
            raise ValueError(f"{v!r}: (int64_t) of it is undefined in C")
        return int(v), v, None
    if isinstance(v, str):
        return 0, 0.0, v
    raise ValueError(f"{type(v).__name__} cells are not modelled")


def fetch_lines(k: int, names: List[str], codes: List[int],
                columns: List[list]) -> List[str]:
    """The lines capi_fetch prints for statement `k` whose result the
    bridge lowered to `names`, `codes` and `columns` (capi_bridge.query),
    but for its "time " lines."""
    nrows = len(columns[0]) if columns else 0
    cells = [[None if v is None else _c_cell(v) for v in col]
             for col in columns]

    def text(j, c):
        if c is None:
            return "NULL"
        i, d, s = c
        if codes[j] in INT_CODES:
            if s is not None:
                raise ValueError("text in an integer column is not "
                                 "modelled")
            return str(i)
        if codes[j] in FLOAT_CODES:
            if s is not None:
                raise ValueError("text in a float column is not modelled")
            return "%.17g" % d
        return s if s is not None else str(i)

    out = [f"statement {k} rows {nrows} cols {len(names)}"]
    out += [f"column {k} {j} {codes[j]} {n}" for j, n in enumerate(names)]
    for i in range(min(nrows, SHOWN_ROWS)):
        out.append(f"row {k} {i} " + "\t".join(
            text(j, cells[j][i]) for j in range(len(names))))
    for j in range(len(names)):
        live = [c for c in cells[j] if c is not None]
        if codes[j] in INT_CODES or codes[j] in FLOAT_CODES:
            s = 0.0
            for c in live:
                s += c[1]
            out.append(f"checksum {k} {j} " + "%.17g" % s)
        else:
            out.append(f"checksum {k} {j} "
                       f"{sum(len(text(j, c).encode()) for c in live)}")
    return out


def untimed(stdout: str) -> List[str]:
    """capi_fetch's output lines but for the "time " lines."""
    return [ln for ln in stdout.splitlines()
            if not ln.startswith(TIME_PREFIX)]


def timings(stdout: str) -> Dict[str, object]:
    """{"open": ms, "connect": ms, "query": {k: [ms of each run]}} from
    capi_fetch's "time " lines."""
    out: Dict[str, object] = {"query": {}}
    for ln in stdout.splitlines():
        if not ln.startswith(TIME_PREFIX):
            continue
        w = ln.split()
        if w[1] == "query":
            out["query"].setdefault(int(w[2]), []).append(float(w[4]))
        else:
            out[w[1]] = float(w[2])
    return out

"""Build and load the port's CUDA kernels.

The sources in csrc/ compile with nvcc into one shared library with a
plain C interface, loaded through ctypes.  The build happens at first
use, into _build/ next to this file, under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads the library already built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (restype is int: the CUDA error, 0 = launched)
    "q1_launch_info": [ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)],
    "q1_fused_aggregate": [_P] * 6 + [ctypes.c_int32, ctypes.c_int64, _P,
                                      ctypes.c_int32, ctypes.c_int32, _P],
    "q6_fused_filter_sum": [_P] * 4 + [ctypes.c_int32, ctypes.c_int64, _P,
                                       ctypes.c_int32, _P],
    "cmpx_stages": [_P] * 4 + [ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_int32, _P],
    "vpu_chain": [_P, _P, ctypes.c_int64, ctypes.c_int32, _P, _P],
    "dense_launch_info": [ctypes.c_int32, ctypes.c_int32,
                          ctypes.POINTER(ctypes.c_int32)],
    "dense_aggregate": [_P, ctypes.c_int32, ctypes.c_int32, _P],
}


class Library:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when loaded from _build/
        self.build_log = build_log           # nvcc/ptxas output
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self._lib, name)


_LIBRARY = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set NVCC or put nvcc on PATH)")


def cuobjdump() -> str:
    """The toolkit's disassembler, beside nvcc."""
    path = Path(_nvcc()).parent / "cuobjdump"
    if not path.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc: {path}")
    return str(path)


def load() -> Library:
    """The kernel library, built from csrc/ on first use."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.read_bytes())
    so = BUILD_DIR / f"kernels_{h.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                              *map(str, sources)],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)
    _LIBRARY = Library(so, seconds, log)
    return _LIBRARY

"""A chain of 96 int32 min/max operations: the card's integer op rate.

The counterpart of the case `vpu_chain` of scripts/bench_sort_study.py:
x = k + add, then 48 times x = min(max(x, lo_c), hi_c).  XLA fuses the
chain into one pass; here csrc/vpu_chain.cu does, with the bounds passed
at run time so the compiler cannot fold them.  `reference_bounds()` are
the script's (lo_c = -c, hi_c = 1 << (c % 24)).  A wrapper given a CPU
tensor runs the plain torch version; given a CUDA tensor it launches the
kernel or raises.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import re
import subprocess

import numpy as np
import torch

CHAIN = 96              # operations an element: 48 max, 48 min

LAUNCHES = {"vpu_chain": 0}


def reference_bounds() -> np.ndarray:
    """The script's bounds, int32 [96]: max's operand -c at 2c, min's
    1 << (c % 24) at 2c + 1."""
    c = np.arange(CHAIN // 2)
    out = np.empty(CHAIN, dtype=np.int32)
    out[0::2] = -c
    out[1::2] = 1 << (c % 24)
    return out


def _bounds(bounds) -> np.ndarray:
    """The bounds as a contiguous int32 [96] array (host memory)."""
    b = np.asarray(bounds).reshape(-1)
    if b.shape != (CHAIN,) or b.dtype.kind not in "iu" or \
            int(b.min()) < -2**31 or int(b.max()) >= 2**31:
        raise ValueError(f"vpu_chain takes {CHAIN} int32 bounds, got "
                         f"{b.dtype} {b.shape}")
    return np.ascontiguousarray(b, dtype=np.int32)


def _check(x):
    if x.dtype != torch.int32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("vpu_chain takes a contiguous int32 vector; got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def vpu_chain(x, bounds, add: int = 0):
    """The chain over x + add (int32, wrapping)."""
    _check(x)
    b = _bounds(bounds)
    if x.device.type == "cpu":
        return vpu_chain_plain(x, b, add)
    from .. import kernels
    out = torch.empty_like(x)
    # the kernel's parameter is copied from b during the call
    err = kernels.load().vpu_chain(
        x.data_ptr(), out.data_ptr(), x.numel(), int(add), b.ctypes.data,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vpu_chain kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["vpu_chain"] += 1
    return out


def vpu_chain_plain(x, bounds, add: int = 0):
    """Plain torch version of vpu_chain: one pass over memory an
    operation."""
    _check(x)
    b = _bounds(bounds).tolist()
    y = x + int(add)
    for c in range(CHAIN // 2):
        y = torch.clamp(y, min=b[2 * c])
        y = torch.clamp(y, max=b[2 * c + 1])
    return y


def sass_minmax_count() -> int:
    """Integer min/max instructions (IMNMX, VIMNMX) in vpu_chain_kernel
    as `cuobjdump -sass` disassembles the built library."""
    from .. import kernels
    text = subprocess.run([kernels.cuobjdump(), "-sass",
                           str(kernels.load().path)], check=True,
                          capture_output=True, text=True).stdout
    count = 0
    for section in text.split("Function : ")[1:]:
        if "vpu_chain_kernel" in section.split("\n", 1)[0]:
            count += len(re.findall(r"\bV?IMNMX\b", section))
    return count

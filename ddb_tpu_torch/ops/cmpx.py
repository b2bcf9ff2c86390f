"""Compare-exchange stages of a bitonic network on (hi, lo) int32 pairs.

Port of the kernel in scripts/exp_mosaic_cmpx.py (the closure `kernel`
inside main(), launched by main.run): the inner loop of a bitonic
sort/merge.  `hi` and `lo` are int32 [tiles * rows, 128].  Within every
tile of `rows` rows, and every one of the 128 lanes on its own, stage
t = 0 .. stages-1 works at row distance d = dmin << (t % 5): row i and
row i ^ d exchange so that the row with bit d clear holds the
lexicographic minimum of the two (hi, lo) pairs and the other the
maximum.  hi and lo both compare as signed int32.  Lanes never exchange
with each other, and tiles never do.

The script reads DMIN from the environment when it traces; here `dmin`
is an argument.  A wrapper given CPU tensors runs the plain torch
version beside it; given CUDA tensors it launches the kernel
(csrc/cmpx.cu) or raises.  `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

LANES = 128
_GROUP = 32     # rows closed under the five distances dmin << 0..4

LAUNCHES = {"cmpx": 0}


def _check(hi, lo, rows: int, stages: int, dmin: int):
    for x in (hi, lo):
        if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES \
                or not x.is_contiguous():
            raise ValueError("cmpx_stages inputs must be contiguous int32 "
                             f"[tiles * rows, {LANES}]; got {x.dtype} "
                             f"{tuple(x.shape)}")
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError("cmpx_stages: hi and lo differ in shape or device")
    if hi.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {hi.device}")
    if dmin < 1 or dmin & (dmin - 1):
        raise ValueError(f"dmin must be a power of two, got {dmin}")
    if not dmin << 4 < rows or rows % (_GROUP * dmin):
        raise ValueError(f"rows ({rows}) must be a multiple of "
                         f"{_GROUP} * dmin ({_GROUP * dmin}): the largest "
                         "distance, dmin << 4, must pair rows of one tile")
    if hi.shape[0] % rows:
        raise ValueError(f"{hi.shape[0]} rows are not whole tiles of {rows}")
    if stages < 0:
        raise ValueError(f"stages must not be negative, got {stages}")


def cmpx_stages(hi, lo, rows: int = 512, stages: int = 45, dmin: int = 1):
    """(hi, lo) after `stages` compare-exchange stages on every tile."""
    _check(hi, lo, rows, stages, dmin)
    if hi.device.type == "cpu":
        return cmpx_stages_plain(hi, lo, rows, stages, dmin)
    from .. import kernels
    out_hi, out_lo = torch.empty_like(hi), torch.empty_like(lo)
    err = kernels.load().cmpx_stages(
        hi.data_ptr(), lo.data_ptr(), out_hi.data_ptr(), out_lo.data_ptr(),
        hi.shape[0], int(stages), int(dmin),
        torch.cuda.current_stream(hi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cmpx_stages kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["cmpx"] += 1
    return out_hi, out_lo


def cmpx_stages_plain(hi, lo, rows: int = 512, stages: int = 45,
                      dmin: int = 1):
    """Plain torch version of cmpx_stages (same contract).  Per stage the
    rows are viewed as [n / 2d, 2, d, 128]: the two halves are the
    partners, the first takes the minimum and the second the maximum."""
    _check(hi, lo, rows, stages, dmin)
    h, l = hi.clone(), lo.clone()
    for t in range(stages):
        d = dmin << (t % 5)
        hv, lv = h.view(-1, 2, d, LANES), l.view(-1, 2, d, LANES)
        h0, h1, l0, l1 = hv[:, 0], hv[:, 1], lv[:, 0], lv[:, 1]
        gt = (h0 > h1) | ((h0 == h1) & (l0 > l1))
        h = torch.stack([torch.where(gt, h1, h0), torch.where(gt, h0, h1)],
                        1).view(-1, LANES)
        l = torch.stack([torch.where(gt, l1, l0), torch.where(gt, l0, l1)],
                        1).view(-1, LANES)
    return h, l

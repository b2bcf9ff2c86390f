"""Single-pass fused filter + aggregate for TPC-H Q1 and Q6 on the GPU.

Port of ddb_tpu/ops/pallas_agg.py.  The four Q1 entry points there
(q1_fused_aggregate, _v3, _v4, _v7) are TPU layouts of one function; here
they are one CUDA kernel, and Q6 is a second (csrc/fused_agg.cu, which
notes what bounds each on the card).  The result contracts are kept:

* `q1_fused_aggregate` -> int64 [GROUPS, PAYLOADS] sums of qty, ext, disc,
  count, dpA, dpB, chA, chB per group gid = returnflag*2 + linestatus over
  rows with ship <= cutoff, where disc_price = dpA*2^16 + dpB and
  charge = chA*2^16 + chB; `q1_results_from_sums` recombines them.
* `q6_fused_filter_sum` -> int64 scalar Σ ext*disc over
  cut <= ship < cut+365, 5 <= disc <= 7, qty < 24.

Inputs are int32 columns of any (equal) length on one device.  A wrapper
given CPU tensors runs the plain torch version beside it; given CUDA
tensors it launches the kernel or raises.  `LAUNCHES` counts kernel
launches, per kernel.

The Q1 kernel packs a row's eight payloads into `Q1_WORDS` 64-bit words
(the constants below state the fields; csrc/fused_agg.cu holds the same
values) and unpacks them into int64 after every `FLUSH_ROWS` rows of a
thread, before any field can overflow at the input contract's maxima:
disc <= 100, tax <= 8, qty <= 2^20, 0 <= ext < 2^31, all non-negative.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

GROUPS = 6
PAYLOADS = 8        # qty, ext, disc, count, dpA, dpB, chA, chB

LAUNCHES = {"q1": 0, "q6": 0}

_THREADS = 256          # block size of both kernels (csrc/fused_agg.cu)
_BLOCKS_PER_SM = 8      # Q6's grid; Q1's is one resident wave

# Q1's packed words: (word, shift, bits) of each packed field, in the
# kernel's kDiscShift / kCountShift / kDpBShift.  ext, chA and chB have a
# whole word each.
Q1_WORDS = 5
Q1_FIELDS = {"qty": (0, 0, 32), "disc": (0, 32, 16), "count": (0, 48, 16),
             "dpA": (1, 0, 32), "dpB": (1, 32, 32)}
FLUSH_ROWS = 512        # kFlushRows

_q1_shapes = {}         # (device index, vec) -> Q1LaunchShape


def _columns(cols):
    """Validate the int32 input columns; returns (device, n_rows)."""
    dev, n = cols[0].device, cols[0].shape[0]
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != n \
                or c.device != dev or not c.is_contiguous():
            raise ValueError("fused aggregate inputs must be contiguous "
                             "1-D int32 tensors of one length on one "
                             f"device; got {c.dtype} {tuple(c.shape)} "
                             f"on {c.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev, n


def _launch_shape(dev, n):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-n // _THREADS), sms * _BLOCKS_PER_SM))


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


class Q1LaunchShape(NamedTuple):
    """What one instantiation of the Q1 kernel needs on one device."""
    threads: int            # a block
    shared_bytes: int       # dynamic shared memory a block
    registers: int          # a thread
    resident_blocks: int    # an SM, from the occupancy calculator
    sms: int

    def blocks(self, n: int) -> int:
        """The kernel's grid for n rows: one resident wave, or fewer
        blocks where the rows do not give each a chunk (four rows a
        thread)."""
        return max(1, min(-(-n // (4 * self.threads)),
                          self.sms * self.resident_blocks))


def q1_launch_shape(dev, vec: bool) -> Q1LaunchShape:
    """The launch shape of the Q1 kernel on CUDA device `dev`: with
    16-byte loads (`vec`) or its 4-byte instantiation.  The first call per
    device also sets the kernel up for its dynamic shared memory."""
    key = (dev.index if dev.index is not None
           else torch.cuda.current_device(), bool(vec))
    shape = _q1_shapes.get(key)
    if shape is None:
        from .. import kernels
        info = (ctypes.c_int32 * 4)()
        with torch.cuda.device(key[0]):
            _check_launch("q1_launch_info",
                          kernels.load().q1_launch_info(int(vec), info))
        sms = torch.cuda.get_device_properties(key[0]).multi_processor_count
        shape = _q1_shapes[key] = Q1LaunchShape(*info, sms)
        if shape.resident_blocks < 1:
            raise RuntimeError(f"the Q1 kernel does not fit an SM of device "
                               f"{key[0]}: {shape}")
    return shape


def q1_fused_aggregate(qty, ext, disc, tax, ship, gid, cutoff: int, *,
                       blocks: int | None = None):
    """Q1 sums [GROUPS, PAYLOADS] (int64) of rows with ship <= cutoff.

    `blocks` sets the kernel's grid in place of one resident wave; any
    count gives the same sums (a small grid makes each thread's share of
    rows long, which the kernel's checks use).  Columns whose storage is
    not 16-byte aligned take the kernel's 4-byte loads."""
    cols = (qty, ext, disc, tax, ship, gid)
    dev, n = _columns(cols)
    if dev.type == "cpu":
        return q1_fused_aggregate_plain(*cols, cutoff)
    from .. import kernels
    vec = all(c.data_ptr() % 16 == 0 for c in cols)
    shape = q1_launch_shape(dev, vec)
    if blocks is None:
        blocks = shape.blocks(n)
    elif blocks < 1:
        raise ValueError(f"blocks must be at least 1, got {blocks}")
    out = torch.zeros((GROUPS, PAYLOADS), dtype=torch.int64, device=dev)
    _check_launch("q1_fused_aggregate", kernels.load().q1_fused_aggregate(
        *(c.data_ptr() for c in cols), int(cutoff), n, out.data_ptr(),
        int(vec), int(blocks), torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES["q1"] += 1
    return out


def q1_fused_aggregate_plain(qty, ext, disc, tax, ship, gid, cutoff: int):
    """Plain torch version of q1_fused_aggregate (same contract)."""
    q, e, d, t = (x.to(torch.int64) for x in (qty, ext, disc, tax))
    m, f = 100 - d, 100 + t
    dpA, dpB = (e >> 16) * m, (e & 0xFFFF) * m
    vals = (q, e, d, torch.ones_like(q), dpA, dpB, dpA * f, dpB * f)
    cid = torch.where(ship <= cutoff, gid, GROUPS)
    return torch.stack([torch.stack([torch.where(cid == g, v, 0).sum()
                                     for v in vals])
                        for g in range(GROUPS)])


def q6_fused_filter_sum(qty, ext, disc, ship, cut: int):
    """Q6 revenue Σ ext*disc (int64 0-d tensor) over the Q6 predicate."""
    cols = (qty, ext, disc, ship)
    dev, n = _columns(cols)
    if dev.type == "cpu":
        return q6_fused_filter_sum_plain(*cols, cut)
    from .. import kernels
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    _check_launch("q6_fused_filter_sum", kernels.load().q6_fused_filter_sum(
        *(c.data_ptr() for c in cols), int(cut), n, out.data_ptr(),
        _launch_shape(dev, n), torch.cuda.current_stream(dev).cuda_stream))
    LAUNCHES["q6"] += 1
    return out[0]


def q6_fused_filter_sum_plain(qty, ext, disc, ship, cut: int):
    """Plain torch version of q6_fused_filter_sum (same contract)."""
    m = ((ship >= cut) & (ship < cut + 365)
         & (disc >= 5) & (disc <= 7) & (qty < 24))
    return torch.where(m, ext.to(torch.int64) * disc, 0).sum()


# ---------------------------------------------------------------------------
# host helpers carried over from ddb_tpu/ops/pallas_agg.py (numpy, exact)
# ---------------------------------------------------------------------------

def q1_results_from_sums(sums: np.ndarray):
    """[GROUPS, PAYLOADS] int64 -> per-group Q1 aggregates (host, exact).
    Returns dict of arrays: sum_qty, sum_base_price, sum_disc_price,
    sum_charge, sum_disc, count."""
    sums = np.asarray(sums)
    qty, ext, disc, cnt = sums[:, 0], sums[:, 1], sums[:, 2], sums[:, 3]
    dp = sums[:, 4] * (1 << 16) + sums[:, 5]
    ch = sums[:, 6] * (1 << 16) + sums[:, 7]
    return dict(sum_qty=qty, sum_base_price=ext, sum_disc_price=dp,
                sum_charge=ch, sum_disc=disc, count=cnt)


def reference_sums(qty, ext, disc, tax, ship, gid, cutoff):
    """Slow exact reference (numpy int64) for validating the kernel."""
    qty, ext, disc, tax, ship, gid = (np.asarray(x, dtype=np.int64)
                                      for x in (qty, ext, disc, tax,
                                                ship, gid))
    sel = ship <= cutoff
    m = 100 - disc
    n = 100 + tax
    e_hi, e_lo = ext >> 16, ext & 0xFFFF
    pl_ = (qty, ext, disc, np.ones_like(qty), e_hi * m, e_lo * m,
           e_hi * m * n, e_lo * m * n)
    out = np.zeros((GROUPS, PAYLOADS), dtype=np.int64)
    for g in range(GROUPS):
        mask = sel & (gid == g)
        for p, v in enumerate(pl_):
            out[g, p] = v[mask].sum()
    return out


def q6_reference(qty, ext, disc, ship, cut):
    """Exact numpy oracle for q6_fused_filter_sum."""
    m = ((ship >= cut) & (ship < cut + 365)
         & (disc >= 5) & (disc <= 7) & (qty < 24))
    return int((ext.astype(np.int64) * disc)[m].sum())


def lineitem_kernel_inputs(td, device):
    """The kernels' int32 input columns from a lineitem table's resident
    device batch (the benchmark path): l_quantity in whole units (the
    table stores DECIMAL(15,2), scaled by 100), l_extendedprice,
    l_discount and l_tax in cents, l_shipdate in days, and
    gid = returnflag*2 + linestatus from the A/N/R and F/O dictionary
    codes.  Rows past the table's end are cut off."""
    b = td.device_batch(device=device)
    n = td.num_rows
    col = {c.name: b.columns[i].data[:n] for i, c in enumerate(td.columns)}

    def i32(x):
        return x.to(torch.int32).contiguous()

    return dict(
        qty=i32(torch.div(col["l_quantity"], 100, rounding_mode="floor")),
        ext=i32(col["l_extendedprice"]), disc=i32(col["l_discount"]),
        tax=i32(col["l_tax"]), ship=i32(col["l_shipdate"]),
        gid=i32(col["l_returnflag"] * 2 + col["l_linestatus"]))

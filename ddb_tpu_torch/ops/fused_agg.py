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
"""

from __future__ import annotations

import numpy as np
import torch

GROUPS = 6
PAYLOADS = 8        # qty, ext, disc, count, dpA, dpB, chA, chB

LAUNCHES = {"q1": 0, "q6": 0}

_THREADS = 256          # block size of both kernels (csrc/fused_agg.cu)
_BLOCKS_PER_SM = 8


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


def q1_fused_aggregate(qty, ext, disc, tax, ship, gid, cutoff: int):
    """Q1 sums [GROUPS, PAYLOADS] (int64) of rows with ship <= cutoff."""
    cols = (qty, ext, disc, tax, ship, gid)
    dev, n = _columns(cols)
    if dev.type == "cpu":
        return q1_fused_aggregate_plain(*cols, cutoff)
    from .. import kernels
    out = torch.zeros((GROUPS, PAYLOADS), dtype=torch.int64, device=dev)
    _check_launch("q1_fused_aggregate", kernels.load().q1_fused_aggregate(
        *(c.data_ptr() for c in cols), int(cutoff), n, out.data_ptr(),
        _launch_shape(dev, n), torch.cuda.current_stream(dev).cuda_stream))
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

"""Approximate aggregation sketches: HyperLogLog + quantile digest
(PyTorch port of ddb_tpu/ops/sketch.py).

Parity targets: the reference's HyperLogLog behind
approx_count_distinct (reference: third_party/hyperloglog/,
src/core_functions/aggregate/distributive/approx_count.cpp) and the
t-digest behind approx_quantile (third_party/tdigest/).

  * HLL registers are one `scatter_reduce_(amax)` of the ranks into the
    dense 2^p register file (the TPU design sorted by register first,
    because scatter serializes there).
  * registers are MERGEABLE by elementwise max.
  * the quantile digest is a weighted compressed CDF (sorted centroid/
    weight pairs, KLL-style), mergeable by concat + re-compress.
"""

from __future__ import annotations

import torch

from . import hashing
from .order import sort_pass

HLL_P = 14                       # 2^14 = 16384 registers (reference: 2^14)
HLL_M = 1 << HLL_P

F64 = torch.float64
I64 = torch.int64


def _clz64(x):
    """Leading zero bits of non-zero int64 bit patterns (binary search
    over the top half, quarter, ...; torch has no clz)."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_clear = hashing.lshr(x, 64 - s) == 0
        n = n + torch.where(top_clear, s, 0)
        x = torch.where(top_clear, x << s, x)
    return n


def hll_registers(values, sel, nulls=None):
    """Dense (HLL_M,) int32 register file for the live values."""
    live = sel if nulls is None else (sel & ~nulls)
    h = hashing.hash64(values.to(I64))
    bucket = hashing.lshr(h, 64 - HLL_P)
    rest = (h << HLL_P) | 1                          # sentinel stops clz
    rank = torch.where(live, _clz64(rest) + 1, 0).to(torch.int32)
    bucket = torch.where(live, bucket, HLL_M)        # dead rows: trash slot
    regs = torch.zeros(HLL_M + 1, dtype=torch.int32, device=sel.device)
    return regs.scatter_reduce_(0, bucket, rank, "amax")[:HLL_M]


def hll_merge(a, b):
    return torch.maximum(a, b)


def hll_estimate(regs):
    """Bias-corrected cardinality estimate (Flajolet et al. 2007 with
    the small-range linear-counting correction the reference's
    implementation also applies)."""
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / torch.sum(torch.exp2(-regs.to(F64)))
    zeros = torch.sum(regs == 0).to(F64)
    linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
    small = raw <= 2.5 * m
    est = torch.where(small & (zeros > 0), linear, raw)
    return torch.round(est).to(I64)


def hll_count_distinct(values, sel, nulls=None):
    return hll_estimate(hll_registers(values, sel, nulls))


# ---------------------------------------------------------------------------
# mergeable quantile digest (KLL-style compressed CDF)
# ---------------------------------------------------------------------------

DIGEST_K = 256


def _centroids(bucket, weighted, weights, k: int):
    zeros = torch.zeros(k, dtype=F64, device=bucket.device)
    sums = zeros.index_add(0, bucket, weighted)
    cnts = zeros.index_add(0, bucket, weights)
    return sums / torch.clamp(cnts, min=1.0), cnts


def quantile_digest(values, sel, nulls=None, k: int = DIGEST_K):
    """(centroids[k] float64, weights[k] float64): a compressed CDF.
    Built from a full sort; each centroid is the mean of an equal-count
    run."""
    live = sel if nulls is None else (sel & ~nulls)
    n = values.shape[0]
    sv = sort_pass(torch.where(live, values.to(F64), float("inf")),
                   stable=False).values
    cnt = live.sum(dtype=I64)
    # bucket of sorted position i: floor(i * k / cnt)
    pos = torch.arange(n, dtype=I64, device=sel.device)
    bucket = torch.clamp(pos * k // torch.clamp(cnt, min=1), 0, k - 1)
    inb = pos < cnt
    return _centroids(torch.where(inb, bucket, k - 1),
                      torch.where(inb, sv, 0.0), inb.to(F64), k)


def digest_merge(c1, w1, c2, w2, k: int = DIGEST_K):
    """Merge two digests: weighted concat, sort, recompress to k."""
    sc, order = torch.sort(torch.cat([c1, c2]), stable=True)
    sw = torch.cat([w1, w2])[order]
    total = torch.sum(sw)
    cum = torch.cumsum(sw, 0) - sw          # exclusive prefix weight
    bucket = torch.clamp((cum * k / torch.clamp(total, min=1.0)).to(I64),
                         0, k - 1)
    return _centroids(bucket, sc * sw, sw, k)


def digest_quantile(centroids, weights, q: float):
    """Approximate q-quantile from a digest (linear interpolation over
    cumulative centroid weights)."""
    total = torch.sum(weights)
    target = q * torch.clamp(total - 1.0, min=0.0)
    cum = torch.cumsum(weights, 0) - weights / 2.0
    # piecewise-linear CDF inversion: index = count of midpoints <= target
    idx = torch.sum(cum <= target) - 1
    last = centroids.shape[0] - 1
    i0, i1 = torch.clamp(idx, 0, last), torch.clamp(idx + 1, 0, last)
    c0, c1 = centroids[i0], centroids[i1]
    m0, m1 = cum[i0], cum[i1]
    frac = torch.where(m1 > m0,
                       (target - m0) / torch.clamp(m1 - m0, min=1e-300), 0.0)
    return c0 + (c1 - c0) * torch.clamp(frac, 0.0, 1.0)

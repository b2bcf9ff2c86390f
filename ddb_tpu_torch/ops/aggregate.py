"""Grouped and ungrouped aggregation (PyTorch port of
ddb_tpu/ops/aggregate.py).

Three paths, as in the reference package:

* `dense_group_aggregate`: perfect-hash path for tiny key domains (TPC-H
  Q1): one masked reduction per (group, payload).
* `group_and_aggregate`: the general path.  One stable sort over the
  encoded keys puts each group's rows together; group boundaries give
  every sorted row its group slot, and per-group results are reductions
  into those slots (`index_add_` / `scatter_reduce_`).  This replaces the
  segmented `lax.associative_scan`s of the TPU design, which avoided
  scatter because XLA scatter serializes on the TPU; on the GPU scatter
  runs in parallel.  Integer sums stay exact; float sums may be reduced in
  another order than on the CPU.
* `ungrouped_aggregate`: all rows into one value (TPC-H Q6).

NULLs are ignored; empty/all-NULL groups yield NULL (except COUNT).
Integer/decimal sums accumulate exact int64 when plan/bounds.py proves no
overflow, else exact two-limb i128-style sums (`_WIDE_KINDS`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .order import sort_permutation


class AggPayload(NamedTuple):
    """One aggregate input: function kind + evaluated argument.

    kinds: sum|sum_float|avg|min|max|count|count_star|any_value|last|
           product|var_samp|var_pop|stddev_samp|stddev_pop|
           covar_samp|covar_pop|corr (two-argument: data2)|sum_wide|avg_wide"""
    kind: str
    data: Optional[torch.Tensor]      # None for count_star
    nulls: Optional[torch.Tensor]
    data2: Optional[torch.Tensor] = None   # second argument (corr/covar)


_VAR_KINDS = ("var_samp", "var_pop", "stddev_samp", "stddev_pop")
_COVAR_KINDS = ("covar_samp", "covar_pop", "corr")

# wide (i128-style) sums: accumulate two int64 limbs (lo = v & 0xffffffff,
# hi = v >> 32); exact for any count <= 2^31 of int64 inputs.  Selected by
# plan/bounds.py overflow analysis.
_WIDE_KINDS = ("sum_wide", "avg_wide")
_LO_MASK = 0xFFFFFFFF

F64 = torch.float64
I64 = torch.int64


def _split_limbs(v64):
    return v64 & _LO_MASK, v64 >> 32


def _finalize_wide(slo, shi):
    """Summed limbs -> (composed int64, true high limb).

    composed = value mod 2^64 (exact whenever the value fits int64); the
    true value is always hi * 2^32 + (composed & 0xffffffff) since int64
    wrap preserves the low bits."""
    return slo + (shi << 32), shi + (slo >> 32)


def _compose_f64(slo, shi):
    return shi.to(F64) * float(2 ** 32) + slo.to(F64)


def _finalize_var(kind, s1, s2, cnt):
    """Population/sample variance & stddev from Σx, Σx², n (float64)."""
    n = torch.clamp(cnt, min=1).to(F64)
    mean = s1 / n
    m2 = torch.clamp(s2 / n - mean * mean, min=0.0)
    if kind.endswith("_pop"):
        var, bad = m2, cnt == 0
    else:
        var, bad = m2 * n / torch.clamp(n - 1, min=1), cnt <= 1
    if kind.startswith("stddev"):
        return torch.sqrt(var), bad
    return var, bad


def _finalize_covar(kind, sx, sy, sxy, sxx, syy, cnt):
    n = torch.clamp(cnt, min=1).to(F64)
    mx, my = sx / n, sy / n
    cov_p = sxy / n - mx * my
    if kind == "covar_pop":
        return cov_p, cnt == 0
    if kind == "covar_samp":
        return cov_p * n / torch.clamp(n - 1, min=1), cnt <= 1
    vx = torch.clamp(sxx / n - mx * mx, min=0.0)
    vy = torch.clamp(syy / n - my * my, min=0.0)
    denom = torch.sqrt(vx * vy)
    # corr over a constant/singleton group is NaN like the reference;
    # NULL only for the empty group
    return torch.where(denom == 0, torch.full_like(denom, float("nan")),
                       cov_p / denom), cnt == 0


def _extreme(dt, kind):
    if dt.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    if dt == torch.bool:
        return kind == "min"
    info = torch.iinfo(dt)
    return info.max if kind == "min" else info.min


def _acc_dtype(kind, dt):
    if kind == "sum_float" or dt.is_floating_point:
        return F64
    return I64


# ---------------------------------------------------------------------------
# general sort-based path
# ---------------------------------------------------------------------------

def group_and_aggregate(key_ops: Sequence[torch.Tensor],
                        key_data: Sequence,   # list[(data, nulls)]
                        payloads: Sequence[AggPayload],
                        sel: torch.Tensor,
                        num_groups_cap: int):
    """Returns (group_cols, agg_results, group_sel, ngroups).

    key_ops: encoded sort operands (ops/sortkey.py) — grouping order.
    group_cols: [(data, nulls)] per key column at group granularity.
    agg_results: [(data, nulls)] per payload.  All shapes [num_groups_cap].
    """
    cap = sel.shape[0]
    dev = sel.device
    perm = sort_permutation(key_ops, sel)
    valid_s = sel[perm]
    diff = torch.zeros(cap, dtype=torch.bool, device=dev)
    diff[0] = True
    for k in key_ops:
        ks = k[perm]
        diff[1:] |= ks[1:] != ks[:-1]
    boundary = diff & valid_s
    ngroups = boundary.sum().to(torch.int32)
    # every live sorted row's group slot; dead rows go to the trash slot
    slot = torch.where(valid_s, torch.cumsum(boundary, 0) - 1,
                       torch.full_like(perm, cap))
    pos = torch.arange(cap, dtype=I64, device=dev)
    ncap = num_groups_cap

    def fit(a):
        a = a[:cap]
        if a.shape[0] >= ncap:
            return a[:ncap]
        return torch.cat([a, torch.zeros(ncap - a.shape[0], dtype=a.dtype,
                                         device=dev)])

    def seg_sum(v):
        return fit(torch.zeros(cap + 1, dtype=v.dtype, device=dev)
                   .index_add_(0, slot, v))

    def seg_reduce(v, how, init):
        return fit(torch.full((cap + 1,), init, dtype=v.dtype, device=dev)
                   .scatter_reduce_(0, slot, v, how))

    # the last sorted row of each group carries its key values
    last = seg_reduce(pos, "amax", 0)
    gsel = torch.arange(ncap, device=dev) < ngroups
    group_cols = []
    for d, n in key_data:
        src = perm[last]
        group_cols.append((d[src], None if n is None else n[src]))

    results = []
    for p in payloads:
        if p.kind == "count_star":
            results.append((torch.where(gsel, seg_sum(valid_s.to(I64)), 0),
                            None))
            continue
        data_s = p.data[perm]
        notnull = valid_s if p.nulls is None else (valid_s & ~p.nulls[perm])
        cnt = seg_sum(notnull.to(I64))
        empty = (cnt == 0) | ~gsel
        if p.kind == "count":
            results.append((torch.where(gsel, cnt, 0), None))
        elif p.kind in ("sum", "sum_float", "avg"):
            acc = _acc_dtype(p.kind, data_s.dtype)
            s = seg_sum(torch.where(notnull, data_s.to(acc), 0))
            if p.kind == "avg":
                s = s.to(F64) / torch.clamp(cnt, min=1)
            results.append((s, empty))
        elif p.kind in _WIDE_KINDS:
            lo, hi = _split_limbs(torch.where(notnull, data_s.to(I64), 0))
            slo, shi = seg_sum(lo), seg_sum(hi)
            if p.kind == "avg_wide":
                results.append((_compose_f64(slo, shi)
                                / torch.clamp(cnt, min=1), empty))
            else:
                results.append((_finalize_wide(slo, shi), empty))
        elif p.kind == "product":
            v = torch.where(notnull, data_s.to(F64), 1.0)
            results.append((seg_reduce(v, "prod", 1.0), empty))
        elif p.kind in ("min", "max"):
            v = data_s.to(torch.int32) if data_s.dtype == torch.bool \
                else data_s
            big = _extreme(v.dtype, p.kind)
            m = seg_reduce(torch.where(notnull, v, big), "a" + p.kind, big)
            results.append((m.to(data_s.dtype), empty))
        elif p.kind in ("any_value", "last"):
            # first (any_value) / last non-NULL row of the group
            if p.kind == "any_value":
                at = seg_reduce(torch.where(notnull, pos, cap), "amin", cap)
            else:
                at = seg_reduce(torch.where(notnull, pos, -1), "amax", -1)
            results.append((data_s[torch.clamp(at, 0, cap - 1)], empty))
        elif p.kind in _VAR_KINDS:
            x = torch.where(notnull, data_s.to(F64), 0.0)
            out, bad = _finalize_var(p.kind, seg_sum(x), seg_sum(x * x), cnt)
            results.append((out, bad | ~gsel))
        elif p.kind in _COVAR_KINDS:
            x = torch.where(notnull, data_s.to(F64), 0.0)
            y = torch.where(notnull, p.data2[perm].to(F64), 0.0)
            out, bad = _finalize_covar(
                p.kind, seg_sum(x), seg_sum(y), seg_sum(x * y),
                seg_sum(x * x), seg_sum(y * y), cnt)
            results.append((out, bad | ~gsel))
        else:
            raise NotImplementedError(f"aggregate {p.kind}")
    return group_cols, results, gsel, ngroups


# ---------------------------------------------------------------------------
# small-domain dense aggregation (PerfectHashAggregate analog,
# reference: src/execution/perfect_aggregate_hashtable.cpp) — masked loop,
# one linear pass per (group, payload): suits Q1-style tiny domains.
# ---------------------------------------------------------------------------

MAX_MASKED_DOMAIN = 16


def dense_group_aggregate(gid: torch.Tensor, domain: int,
                          payloads: Sequence[AggPayload], sel: torch.Tensor):
    """gid in [0, domain) per row (invalid rows may hold any value).
    Returns (agg_results, counts) with tensors of shape [domain]."""
    results = []
    group_masks = [sel & (gid == g) for g in range(domain)]
    counts = torch.stack([m.sum(dtype=I64) for m in group_masks])

    def per_group(masks, v, fill):
        return torch.stack([torch.where(m, v, fill).sum() for m in masks])

    for p in payloads:
        if p.kind == "count_star":
            results.append((counts, None))
            continue
        live_masks = group_masks
        if p.nulls is not None:
            live_masks = [m & ~p.nulls for m in group_masks]
        nn = torch.stack([m.sum(dtype=I64) for m in live_masks])
        if p.kind == "count":
            results.append((nn, None))
        elif p.kind in ("sum", "sum_float", "avg"):
            s = per_group(live_masks,
                          p.data.to(_acc_dtype(p.kind, p.data.dtype)), 0)
            if p.kind == "avg":
                s = s.to(F64) / torch.clamp(nn, min=1)
            results.append((s, nn == 0))
        elif p.kind in _WIDE_KINDS:
            lo, hi = _split_limbs(p.data.to(I64))
            slo, shi = per_group(live_masks, lo, 0), \
                per_group(live_masks, hi, 0)
            if p.kind == "avg_wide":
                results.append((_compose_f64(slo, shi)
                                / torch.clamp(nn, min=1), nn == 0))
            else:
                results.append((_finalize_wide(slo, shi), nn == 0))
        elif p.kind in ("min", "max"):
            big = _extreme(p.data.dtype, p.kind)
            red = torch.amin if p.kind == "min" else torch.amax
            s = torch.stack([red(torch.where(m, p.data, big))
                             for m in live_masks])
            results.append((s, nn == 0))
        elif p.kind == "any_value":
            # torch refuses argmax over bool
            idxs = torch.stack([m.to(torch.int32).argmax()
                                for m in live_masks])
            results.append((p.data[idxs], nn == 0))
        elif p.kind == "product":
            d = p.data.to(F64)
            s = torch.stack([torch.where(m, d, 1.0).prod()
                             for m in live_masks])
            results.append((s, nn == 0))
        elif p.kind in _VAR_KINDS:
            d = p.data.to(F64)
            v, bad = _finalize_var(p.kind, per_group(live_masks, d, 0.0),
                                   per_group(live_masks, d * d, 0.0), nn)
            results.append((v, bad))
        elif p.kind in _COVAR_KINDS:
            x, y = p.data.to(F64), p.data2.to(F64)
            v, bad = _finalize_covar(
                p.kind, *(per_group(live_masks, t, 0.0)
                          for t in (x, y, x * y, x * x, y * y)), nn)
            results.append((v, bad))
        else:
            raise NotImplementedError(f"aggregate {p.kind}")
    return results, counts


def ungrouped_aggregate(payloads: Sequence[AggPayload], sel: torch.Tensor):
    """All-rows aggregation -> per-payload (scalar, isnull)."""
    results = []
    for p in payloads:
        if p.kind == "count_star":
            results.append((sel.sum(dtype=I64), None))
            continue
        live = sel if p.nulls is None else (sel & ~p.nulls)
        cnt = live.sum(dtype=I64)
        if p.kind == "count":
            results.append((cnt, None))
        elif p.kind in ("sum", "sum_float", "avg"):
            s = torch.where(live, p.data.to(_acc_dtype(p.kind, p.data.dtype)),
                        0).sum()
            if p.kind == "avg":
                s = s.to(F64) / torch.clamp(cnt, min=1)
            results.append((s, cnt == 0))
        elif p.kind in _WIDE_KINDS:
            lo, hi = _split_limbs(torch.where(live, p.data.to(I64), 0))
            slo, shi = lo.sum(), hi.sum()
            if p.kind == "avg_wide":
                results.append((_compose_f64(slo, shi)
                                / torch.clamp(cnt, min=1), cnt == 0))
            else:
                results.append((_finalize_wide(slo, shi), cnt == 0))
        elif p.kind == "product":
            results.append((torch.where(live, p.data.to(F64), 1.0).prod(),
                            cnt == 0))
        elif p.kind in ("min", "max"):
            v = torch.where(live, p.data, _extreme(p.data.dtype, p.kind))
            results.append((v.amin() if p.kind == "min" else v.amax(),
                            cnt == 0))
        elif p.kind == "any_value":
            results.append((p.data[live.to(torch.int32).argmax()],
                            cnt == 0))
        elif p.kind == "last":
            pos = torch.arange(live.shape[0], dtype=I64, device=live.device)
            idx = torch.where(live, pos, -1).amax()
            results.append((p.data[torch.clamp(idx, min=0)], cnt == 0))
        elif p.kind in _VAR_KINDS:
            x = torch.where(live, p.data.to(F64), 0.0)
            results.append(_finalize_var(p.kind, x.sum(), (x * x).sum(),
                                         cnt))
        elif p.kind in _COVAR_KINDS:
            x = torch.where(live, p.data.to(F64), 0.0)
            y = torch.where(live, p.data2.to(F64), 0.0)
            results.append(_finalize_covar(
                p.kind, x.sum(), y.sum(), (x * y).sum(), (x * x).sum(),
                (y * y).sum(), cnt))
        else:
            raise NotImplementedError(f"aggregate {p.kind}")
    return results

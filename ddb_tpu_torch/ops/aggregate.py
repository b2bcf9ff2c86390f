"""Grouped and ungrouped aggregation (PyTorch port of
ddb_tpu/ops/aggregate.py).

Three paths, as in the reference package:

* `dense_group_aggregate`: perfect-hash path for tiny key domains (TPC-H
  Q1).  Its counts, integer sums and averages take one `dense_sums` call
  (one pass of csrc/dense_agg.cu on CUDA tensors, its plain version on
  CPU tensors), the other kinds one masked reduction per (group,
  payload).
* `group_and_aggregate`: the general path.  One stable sort over the
  encoded keys puts each group's rows together; group boundaries give
  every sorted row its group slot, and per-group results are reductions
  into those slots (`index_add_` / `scatter_reduce_`; integer sums and
  counts are differences of one prefix sum at the groups' last rows).  This replaces the
  segmented `lax.associative_scan`s of the TPU design, which avoided
  scatter because XLA scatter serializes on the TPU; on the GPU scatter
  runs in parallel.  Integer sums stay exact; float sums may be reduced in
  another order than on the CPU.
* `ungrouped_aggregate`: all rows into one value (TPC-H Q6).

The holistic aggregates (DISTINCT, quantile, mode, arg_min/arg_max,
entropy) sort by (group keys, value) and read positions: group starts
come from `torch.nonzero` over the boundary mask, not from a compaction
sort, and run lengths from differences of run starts.  Their group order
is `group_and_aggregate`'s over the same key operands.

NULLs are ignored; empty/all-NULL groups yield NULL (except COUNT).
Integer/decimal sums accumulate exact int64 when plan/bounds.py proves no
overflow, else exact two-limb i128-style sums (`_WIDE_KINDS`).

Host reads (each one a device synchronisation): `sort_permutation` reads
the key spans once; the bit aggregates read the longest group once; each
holistic function reads the number of its groups (and runs) through
`torch.nonzero`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from .order import sort_permutation


class AggPayload(NamedTuple):
    """One aggregate input: function kind + evaluated argument.

    kinds: sum|sum_float|avg|min|max|count|count_star|any_value|last|
           product|bit_and|bit_or|bit_xor|var_samp|var_pop|stddev_samp|
           stddev_pop|covar_samp|covar_pop|corr (two-argument: data2)|
           sum_wide|avg_wide"""
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


def _split_limbs(v64, hi=None):
    """(lo, hi) limbs of int64 values; `hi` is the high limb of a wide
    (two-limb) argument, whose composed int64 keeps only its low bits."""
    return v64 & _LO_MASK, v64 >> 32 if hi is None else hi


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


_BIT_OPS = {"bit_and": torch.bitwise_and, "bit_or": torch.bitwise_or,
            "bit_xor": torch.bitwise_xor}
_BIT_NEUTRAL = {"bit_and": -1, "bit_or": 0, "bit_xor": 0}
BIT_KINDS = ("bit_and", "bit_or", "bit_xor")


# ---------------------------------------------------------------------------
# segments of a sorted sequence
# ---------------------------------------------------------------------------

def _changes(ops_sorted, n: int, device):
    """bool[n]: row 0, and every row where an operand differs from the
    row before."""
    diff = torch.zeros(n, dtype=torch.bool, device=device)
    diff[:1] = True
    for k in ops_sorted:
        diff[1:] |= k[1:] != k[:-1]
    return diff


def seg_bounds(boundary):
    """For segments that start where `boundary` is set (boundary[0] must
    be): (seg, starts, ends) with seg[i] the segment of row i, and
    starts[s] / ends[s] the first / last row of segment s.  A segment's
    start, end or a value at either is then a gather: `starts[seg]`,
    `v[ends[seg]]`.  Reads the number of segments on the host."""
    n = boundary.shape[0]
    seg = torch.cumsum(boundary, 0) - 1
    starts = torch.nonzero(boundary).squeeze(1)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)]) - 1
    return seg, starts, ends


def seg_scan(v, seg, combine, longest: int):
    """Inclusive scan of v with `combine`, restarting at every segment
    (seg: each row's segment id, rows of a segment adjacent): log-step
    doubling, ceil(log2(longest)) passes over v, where `longest` bounds
    the rows of a segment.  Adds within a segment only, so a float sum
    never sees another segment's magnitude."""
    d = 1
    while d < longest:
        same = seg[d:] == seg[:-d]
        v = torch.cat([v[:d], torch.where(same, combine(v[:-d], v[d:]),
                                          v[d:])])
        d *= 2
    return v


def seg_cumsum_int(v, seg, starts):
    """Inclusive running sum of an integer v inside each segment, exact:
    a global prefix sum minus the prefix before the segment's start."""
    c = torch.cumsum(v, 0)
    return c - (c - v)[starts][seg]


def _neutral(kind, like):
    """0-d tensor: the bit aggregate's neutral element in like's dtype."""
    return torch.tensor(_BIT_NEUTRAL[kind], device=like.device).to(like.dtype)


def _bit_reduce(v, kind):
    """Bitwise and/or/xor of all of v (a halving tree; torch has no
    bitwise reduction)."""
    op = _BIT_OPS[kind]
    while v.shape[0] > 1:
        if v.shape[0] % 2:
            v = torch.cat([v, _neutral(kind, v).reshape(1)])
        half = v.shape[0] // 2
        v = op(v[:half], v[half:])
    return v[0]


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
    diff[:1] = True          # a fill, not a one-element copy from the host
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
    gsel = torch.arange(ncap, device=dev) < ngroups

    def fit(a):
        a = a[:cap]
        if a.shape[0] >= ncap:
            return a[:ncap]
        return torch.cat([a, torch.zeros(ncap - a.shape[0], dtype=a.dtype,
                                         device=dev)])

    def seg_sum(v):
        """Per-group sum of a per-row tensor that is 0 on dead rows."""
        if v.dtype.is_floating_point:
            return fit(torch.zeros(cap + 1, dtype=v.dtype, device=dev)
                       .index_add_(0, slot, v))
        # integers: a prefix sum read at the groups' last rows, exact in
        # wrapping int64 and free of atomics
        at_end = torch.cumsum(v, 0)[last]
        before = torch.cat([at_end.new_zeros(1), at_end[:-1]])
        return torch.where(gsel, at_end - before, 0)

    def seg_reduce(v, how, init):
        return fit(torch.full((cap + 1,), init, dtype=v.dtype, device=dev)
                   .scatter_reduce_(0, slot, v, how))

    # the last sorted row of each group carries its key values; only
    # those rows write, each to its own slot (a 64-bit scatter_reduce_
    # over every row takes seconds at 1e8 rows)
    is_last = torch.ones(cap, dtype=torch.bool, device=dev)
    is_last[:-1] = boundary[1:] | ~valid_s[1:]
    last = torch.zeros(cap + 1, dtype=I64, device=dev)
    last[torch.where(is_last & valid_s, slot, cap)] = pos
    last = fit(last)
    group_cols = []
    for d, n in key_data:
        src = perm[last]
        group_cols.append((d[src], None if n is None else n[src]))

    results = []
    longest = None        # rows of the largest group, read when needed
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
            lo, hi = _split_limbs(
                torch.where(notnull, data_s.to(I64), 0),
                None if p.data2 is None
                else torch.where(notnull, p.data2[perm], 0))
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
            # first (any_value) / last non-NULL row of the group; int32
            # positions, whose scatter_reduce_ is a native atomic
            pos32 = pos.to(torch.int32)
            if p.kind == "any_value":
                at = seg_reduce(torch.where(notnull, pos32, cap), "amin",
                                cap)
            else:
                at = seg_reduce(torch.where(notnull, pos32, -1), "amax", -1)
            results.append((data_s[torch.clamp(at, 0, cap - 1).to(I64)],
                            empty))
        elif p.kind in BIT_KINDS:
            # no scatter_reduce_ mode is bitwise: scan inside each group,
            # then read the group's last row
            if longest is None:
                longest = int(seg_sum(valid_s.to(I64)).max())
            v = torch.where(notnull, data_s, _neutral(p.kind, data_s))
            run = seg_scan(v, slot, _BIT_OPS[p.kind], longest)
            results.append((run[last], empty))
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
# reference: src/execution/perfect_aggregate_hashtable.cpp).  The
# exact-integer kinds take one `dense_sums` call (one pass of
# csrc/dense_agg.cu on CUDA tensors); the other kinds take the masked
# loop: one linear pass per (group, payload).
# ---------------------------------------------------------------------------

MAX_MASKED_DOMAIN = 16

# kinds that dense_sums computes: counts over any data, sums and averages
# over integer or decimal data
_COUNTED_KINDS = ("count_star", "count")
_SUMMED_KINDS = ("sum", "avg") + _WIDE_KINDS

# csrc/dense_agg.cu: kThreads, kMaxCols (columns of a launch's argument),
# kMaxCells (table cells a thread), kRowsPerStep<false> (the smaller)
DENSE_THREADS = 256
DENSE_MAX_COLS = 32
DENSE_MAX_CELLS = 113
_DENSE_ROWS_PER_STEP = 16 * DENSE_THREADS

LAUNCHES = {"dense": 0}


class DenseCol(NamedTuple):
    """One column that dense_sums counts or sums over the live rows
    (csrc/dense_agg.cu: DenseCol)."""
    data: Optional[torch.Tensor]    # int32/int64 values; None: a count
    nulls: Optional[torch.Tensor]   # bool, True = NULL: the row is skipped
    count: bool                     # a word of its non-NULL rows first
    sum: int                        # 0: none; 1: v; 2: v's limbs (v &
    #   0xffffffff, v >> 32) in two words; 3: v & 0xffffffff alone (a
    #   wide sum whose high limbs are the next column, summed by mode 1)

    @property
    def words(self) -> int:
        return int(self.count) + (2 if self.sum == 2 else int(self.sum > 0))


def _in_dense_sums(p: AggPayload) -> bool:
    return p.kind in _COUNTED_KINDS or (
        p.kind in _SUMMED_KINDS and not p.data.dtype.is_floating_point)


def _ident(t):
    return None if t is None else (t.data_ptr(), t.dtype, tuple(t.shape),
                                   t.stride())


def _as_values(t, dtypes=(torch.int32, I64)):
    """A contiguous int32 or int64 copy of integer data (views when it is
    one already); other integer and bool dtypes widen to int64, as the
    masked loop's sums do."""
    if t is None:
        return None
    return (t if t.dtype in dtypes else t.to(I64)).contiguous()


def dense_plan(payloads: Sequence[AggPayload]):
    """The columns dense_sums reads for `payloads` (every one a kind it
    computes) and where each payload finds its words: (cols, where),
    where[i] = (count word, first sum word or None); a wide sum's high
    limb is the word after its low one.  Word 0 counts each group's live
    rows; each column's words follow in order.  Payloads that sum one
    tensor under one NULL mask share columns, and counts under a NULL
    mask a summed column already counts share its word."""
    cols, first, counted, word = [], {}, {}, 1
    where = [None] * len(payloads)

    def add(key, *group):
        nonlocal word
        if key not in first:
            first[key] = word
            for col in group:
                cols.append(col)
                if col.count:
                    counted.setdefault(_ident(col.nulls), word)
                word += col.words
        return first[key]

    payloads = [p._replace(nulls=None if p.nulls is None
                           else p.nulls.contiguous()) for p in payloads]
    for i, p in enumerate(payloads):
        if p.kind in _SUMMED_KINDS:
            data, count = _as_values(p.data), p.nulls is not None
            hi = p.data2 if p.kind in _WIDE_KINDS else None
            if hi is not None:       # the column's own high limbs
                group = (DenseCol(data, p.nulls, count, 3),
                         DenseCol(_as_values(hi, (I64,)), p.nulls, False, 1))
            else:
                group = (DenseCol(data, p.nulls, count,
                                  2 if p.kind in _WIDE_KINDS else 1),)
            w = add((_ident(p.data), _ident(p.nulls), _ident(hi),
                     group[0].sum), *group)
            where[i] = (w, w + 1) if count else (0, w)
    for i, p in enumerate(payloads):
        if p.kind in _COUNTED_KINDS:
            if p.kind == "count_star" or p.nulls is None:
                where[i] = (0, None)
            else:
                w = counted.get(_ident(p.nulls))
                if w is None:
                    w = add((None, _ident(p.nulls)),
                            DenseCol(None, p.nulls, True, 0))
                where[i] = (w, None)
    return cols, where


def _dense_results(payloads, where, sums):
    """Each payload's (result, isnull) from dense_sums' words, finalised
    as the masked loop finalises them."""
    results = []
    for p, (cw, sw) in zip(payloads, where):
        nn = sums[cw]
        if p.kind in _COUNTED_KINDS:
            results.append((nn, None))
        elif p.kind in _WIDE_KINDS:
            slo, shi = sums[sw], sums[sw + 1]
            if p.kind == "avg_wide":
                results.append((_compose_f64(slo, shi)
                                / torch.clamp(nn, min=1), nn == 0))
            else:
                results.append((_finalize_wide(slo, shi), nn == 0))
        else:
            s = sums[sw]
            if p.kind == "avg":
                s = s.to(F64) / torch.clamp(nn, min=1)
            results.append((s, nn == 0))
    return results


def _check_dense(gid, domain, sel, cols):
    """Validate dense_sums' inputs."""
    n = gid.shape[0] if gid.dim() == 1 else -1
    if gid.dtype != torch.int32 or n < 0 or not gid.is_contiguous():
        raise ValueError(f"dense_sums: gid must be a contiguous int32 "
                         f"vector; got {gid.dtype} {tuple(gid.shape)}")
    if not 1 <= domain <= MAX_MASKED_DOMAIN:
        raise ValueError(f"dense_sums: domain {domain} outside "
                         f"[1, {MAX_MASKED_DOMAIN}]")
    if gid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_sums: unsupported device {gid.device}")
    tensors = [(sel, (torch.bool,), "sel")]
    for k, c in enumerate(cols):
        if c.sum not in (0, 1, 2, 3) or (c.data is None) != (c.sum == 0) \
                or not (c.count or c.sum):
            raise ValueError(f"dense_sums: column {k} sums in mode "
                             f"{c.sum} over {'no ' * (c.data is None)}data"
                             f" and counts {'no ' * (not c.count)}rows")
        tensors += [(c.data, (torch.int32, I64), f"column {k}'s data"),
                    (c.nulls, (torch.bool,), f"column {k}'s NULLs")]
    for t, dtypes, what in tensors:
        if t is None:
            continue
        if t.dtype not in dtypes or t.dim() != 1 or t.shape[0] != n \
                or t.device != gid.device or not t.is_contiguous():
            raise ValueError(f"dense_sums: {what} must be a contiguous "
                             f"vector of {n} {dtypes} on {gid.device}; got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def dense_sums(gid: torch.Tensor, domain: int, sel: torch.Tensor,
               cols: Sequence[DenseCol]):
    """int64 [words, domain] over the live rows (sel set, 0 <= gid <
    domain; dead rows may hold any gid): word 0 each group's count, then
    each column's words in order (its non-NULL count if `count`, then its
    sum by mode, DenseCol.sum), as dense_plan lays them out.  Sums wrap
    in int64, as the masked loop's do.

    CPU tensors take dense_sums_plain; CUDA tensors launch
    csrc/dense_agg.cu (one launch for each run of columns whose table
    fits a block, `LAUNCHES["dense"]` counting them) or raise."""
    _check_dense(gid, domain, sel, cols)
    if gid.device.type == "cpu":
        return dense_sums_plain(gid, domain, sel, cols)
    words = 1 + sum(c.words for c in cols)
    out = torch.zeros((words, domain), dtype=I64, device=gid.device)
    for first, run in _dense_runs(domain, cols):
        _launch_dense(gid, domain, sel, out, first, run)
    return out


def dense_sums_plain(gid, domain, sel, cols):
    """Plain torch version of dense_sums (same contract): one index_add_
    a word."""
    live = sel & (gid >= 0) & (gid < domain)
    slot = torch.where(live, gid.to(I64), domain)

    def per_group(v):
        return torch.zeros(domain + 1, dtype=I64, device=gid.device) \
            .index_add_(0, slot, v)[:domain]

    words = [per_group(torch.ones_like(slot))]
    for c in cols:
        keep = None if c.nulls is None else ~c.nulls
        if c.count:
            words.append(per_group(torch.ones_like(slot) if keep is None
                                   else keep.to(I64)))
        if c.data is None:
            continue
        v = c.data.to(I64)
        if keep is not None:
            v = torch.where(keep, v, 0)
        lo, hi = _split_limbs(v)
        words.extend(per_group(x) for x in
                     ((v,), (lo, hi), (lo,))[c.sum - 1])
    return torch.stack(words)


def _dense_runs(domain, cols):
    """The launches of a dense_sums call: (first word, columns) each, runs
    of consecutive columns whose words (with the group count in the first)
    fit DENSE_MAX_CELLS cells and DENSE_MAX_COLS columns."""
    runs, run, first, words = [], [], 0, 1
    for c in cols:
        if run and (domain * (words + c.words) > DENSE_MAX_CELLS
                    or len(run) == DENSE_MAX_COLS):
            runs.append((first, run))
            first, run, words = first + words, [], 0
        run.append(c)
        words += c.words
    runs.append((first, run))
    return runs


class _DenseColArgs(ctypes.Structure):
    """csrc/dense_agg.cu: DenseCol."""
    _fields_ = [("data", ctypes.c_void_p), ("nulls", ctypes.c_void_p),
                ("width", ctypes.c_int32), ("word", ctypes.c_int32),
                ("count", ctypes.c_int32), ("sum", ctypes.c_int32)]


class _DenseArgs(ctypes.Structure):
    """csrc/dense_agg.cu: DenseArgs."""
    _fields_ = [("gid", ctypes.c_void_p), ("sel", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("domain", ctypes.c_int32), ("words", ctypes.c_int32),
                ("count_word", ctypes.c_int32), ("ncols", ctypes.c_int32),
                ("cols", _DenseColArgs * DENSE_MAX_COLS)]


class DenseLaunchShape(NamedTuple):
    """What one instantiation of the dense kernel needs for a table of
    `cells` cells a thread on one device."""
    threads: int            # a block
    shared_bytes: int       # dynamic shared memory a block
    registers: int          # a thread
    resident_blocks: int    # an SM, from the occupancy calculator
    sms: int

    def blocks(self, n: int) -> int:
        """One resident wave, or fewer blocks where the rows do not give
        each a step (16 rows a thread)."""
        return max(1, min(-(-n // _DENSE_ROWS_PER_STEP),
                          self.sms * self.resident_blocks))


_dense_shapes = {}      # (device index, vec, cells) -> DenseLaunchShape


def dense_launch_shape(dev, vec: bool, cells: int) -> DenseLaunchShape:
    """The dense kernel's launch shape on CUDA device `dev` with 16-byte
    loads (`vec`) or per-row loads, for `cells` table cells a thread.  The
    first call also holds the kernel's argument layout to _DenseArgs."""
    key = (dev.index if dev.index is not None
           else torch.cuda.current_device(), bool(vec), int(cells))
    shape = _dense_shapes.get(key)
    if shape is None:
        from .. import kernels
        info = (ctypes.c_int32 * 9)()
        with torch.cuda.device(key[0]):
            err = kernels.load().dense_launch_info(int(vec), int(cells), info)
        if err != 0:
            raise RuntimeError(f"dense_launch_info failed: CUDA error {err}")
        layout = (ctypes.sizeof(_DenseArgs), _DenseArgs.cols.offset,
                  ctypes.sizeof(_DenseColArgs), DENSE_MAX_COLS,
                  DENSE_MAX_CELLS)
        if tuple(info[4:9]) != layout or info[0] != DENSE_THREADS:
            raise RuntimeError(f"csrc/dense_agg.cu's layout {tuple(info)} "
                               f"!= the wrapper's {layout}")
        sms = torch.cuda.get_device_properties(key[0]).multi_processor_count
        shape = _dense_shapes[key] = DenseLaunchShape(*info[:4], sms)
        if shape.resident_blocks < 1:
            raise RuntimeError(f"the dense kernel does not fit an SM of "
                               f"device {key[0]}: {shape}")
    return shape


def _dense_args(gid, domain, sel, out, first, run):
    """(_DenseArgs, vec) of one launch over the columns `run`, whose words
    start at `first` in out [words, domain]; vec: every pointer allows the
    kernel's 16-byte loads (4-byte for sel and the NULL masks)."""
    vec = gid.data_ptr() % 16 == 0 and sel.data_ptr() % 4 == 0
    args = _DenseArgs(gid=gid.data_ptr(), sel=sel.data_ptr(),
                      out=out.data_ptr() + first * domain * 8,
                      n=gid.shape[0], domain=domain,
                      count_word=0 if first == 0 else -1, ncols=len(run))
    word = 1 if first == 0 else 0
    for k, c in enumerate(run):
        vec = vec and (c.data is None or c.data.data_ptr() % 16 == 0) and \
            (c.nulls is None or c.nulls.data_ptr() % 4 == 0)
        args.cols[k] = _DenseColArgs(
            data=None if c.data is None else c.data.data_ptr(),
            nulls=None if c.nulls is None else c.nulls.data_ptr(),
            width=4 if c.data is None else c.data.element_size(), word=word,
            count=int(c.count), sum=c.sum)
        word += c.words
    args.words = word
    return args, vec


def _launch_dense(gid, domain, sel, out, first, run):
    """One launch of the dense kernel over the columns `run`."""
    from .. import kernels
    args, vec = _dense_args(gid, domain, sel, out, first, run)
    shape = dense_launch_shape(gid.device, vec, domain * args.words)
    err = kernels.load().dense_aggregate(
        ctypes.addressof(args), int(vec),
        shape.blocks(args.n),
        torch.cuda.current_stream(gid.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_aggregate kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["dense"] += 1


def dense_group_aggregate(gid: torch.Tensor, domain: int,
                          payloads: Sequence[AggPayload], sel: torch.Tensor):
    """gid in [0, domain) per row (invalid rows may hold any value).
    Returns (agg_results, counts) with tensors of shape [domain].

    The counts, integer sums and averages come from one dense_sums call
    (csrc/dense_agg.cu on CUDA tensors, its plain version on CPU
    tensors), the other kinds from the masked loop, each result in its
    payload's place; bit-identical to dense_group_aggregate_plain."""
    summed = [i for i, p in enumerate(payloads) if _in_dense_sums(p)]
    cols, where = dense_plan([payloads[i] for i in summed])
    sums = dense_sums(gid.contiguous(), domain, sel.contiguous(), cols)
    results = [None] * len(payloads)
    for i, r in zip(summed, _dense_results([payloads[i] for i in summed],
                                           where, sums)):
        results[i] = r
    rest = [i for i, r in enumerate(results) if r is None]
    if rest:
        rest_results, _ = dense_group_aggregate_plain(
            gid, domain, [payloads[i] for i in rest], sel)
        for i, r in zip(rest, rest_results):
            results[i] = r
    return results, sums[0]


def dense_group_aggregate_plain(gid: torch.Tensor, domain: int,
                                payloads: Sequence[AggPayload],
                                sel: torch.Tensor):
    """Plain torch version of dense_group_aggregate (same contract): one
    masked reduction per (group, payload)."""
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
            lo, hi = _split_limbs(p.data.to(I64), p.data2)
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
            lo, hi = _split_limbs(
                torch.where(live, p.data.to(I64), 0),
                None if p.data2 is None else torch.where(live, p.data2, 0))
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
        elif p.kind in BIT_KINDS:
            v = torch.where(live, p.data, _neutral(p.kind, p.data))
            results.append((_bit_reduce(v, p.kind), cnt == 0))
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


# ---------------------------------------------------------------------------
# DISTINCT and holistic aggregates: sort by (group keys, value), then read
# positions.  One call per aggregate; group order matches
# group_and_aggregate over the same key_ops (same ascending key sort), and
# a group whose payload is all NULL keeps its slot.
# ---------------------------------------------------------------------------

class _SortedGroups:
    """Rows sorted by (key_ops, inner_ops), dead rows last, with the
    groups the key_ops form among the live rows.  Reads the number of
    groups on the host (`torch.nonzero`)."""

    def __init__(self, key_ops, inner_ops, sel, num_groups_cap: int):
        self.cap, self.dev, self.ncap = sel.shape[0], sel.device, \
            num_groups_cap
        self.perm = sort_permutation([*key_ops, *inner_ops], sel)
        self.sel_s = sel[self.perm]
        self.boundary = self.changes(key_ops) & self.sel_s
        self.starts = torch.nonzero(self.boundary).squeeze(1)
        self.ngroups = self.starts.shape[0]
        # dead rows go to the trash slot past the last group
        self.slot = torch.where(self.sel_s,
                                torch.cumsum(self.boundary, 0) - 1,
                                self.ngroups)
        self.gsel = torch.arange(self.ncap, device=self.dev) < self.ngroups

    def changes(self, ops):
        return _changes([o[self.perm] for o in ops], self.cap, self.dev)

    def sum(self, v, slot=None):
        slot = self.slot if slot is None else slot
        return torch.zeros(self.ngroups + 1, dtype=v.dtype, device=self.dev
                           ).index_add_(0, slot, v)[:self.ngroups]

    def reduce(self, v, how, init, slot=None):
        slot = self.slot if slot is None else slot
        return torch.full((self.ngroups + 1,), init, dtype=v.dtype,
                          device=self.dev
                          ).scatter_reduce_(0, slot, v, how)[:self.ngroups]

    def fit(self, a):
        """A per-group tensor as [num_groups_cap], zero past the groups."""
        if a.shape[0] >= self.ncap:
            return a[:self.ncap]
        return torch.cat([a, torch.zeros(self.ncap - a.shape[0],
                                         dtype=a.dtype, device=self.dev)])

    def null_where(self, bad):
        return self.fit(bad) | ~self.gsel


def _live(payload: AggPayload, sel):
    return sel if payload.nulls is None else (sel & ~payload.nulls)


def _inv(live):
    return (~live).to(torch.int32)


def _runs(run_boundary, live_s):
    """(first row of every run, its count of live rows).  A run's rows
    are all live or all not, since liveness is one of the sort operands.
    Reads the number of runs on the host."""
    rstarts = torch.nonzero(run_boundary).squeeze(1)
    ends = torch.cat([rstarts[1:],
                      rstarts.new_full((1,), run_boundary.shape[0])])
    return rstarts, torch.where(live_s[rstarts], ends - rstarts, 0)


def _entropy(n, csum):
    """log2(n) - sum(c log2 c) / n  from the live count and the runs'
    summed c log2 c."""
    nf = torch.clamp(n, min=1).to(F64)
    return torch.log2(nf) - csum / nf


def _c_log_c(c):
    return c.to(F64) * torch.log2(torch.clamp(c, min=1).to(F64))


def _distinct_result(kind, data_s, first_occ, cnt, total, prod):
    """One DISTINCT aggregate from the first occurrences; `total` sums a
    per-row tensor over the group (or everything), `prod` multiplies."""
    if kind == "count":
        return cnt, None
    if kind in ("sum", "sum_float", "avg"):
        acc = _acc_dtype(kind, data_s.dtype)
        s = total(torch.where(first_occ, data_s.to(acc), 0))
        if kind == "avg":
            s = s.to(F64) / torch.clamp(cnt, min=1)
        return s, cnt == 0
    if kind in _WIDE_KINDS:
        lo, hi = _split_limbs(torch.where(first_occ, data_s.to(I64), 0))
        slo, shi = total(lo), total(hi)
        if kind == "avg_wide":
            return _compose_f64(slo, shi) / torch.clamp(cnt, min=1), cnt == 0
        return _finalize_wide(slo, shi), cnt == 0
    if kind == "product":
        return prod(torch.where(first_occ, data_s.to(F64), 1.0)), cnt == 0
    raise NotImplementedError(f"distinct {kind}")


def group_distinct_aggregate(key_ops, value_ops, payload: AggPayload,
                             sel, num_groups_cap: int):
    """One DISTINCT aggregate per call: sort by (group keys, value) and
    aggregate only the first occurrence of each (group, value) pair
    (reference: distinct_aggregate_data.cpp).  Returns (result, isnull)
    tensors of shape [num_groups_cap]."""
    g = _SortedGroups(key_ops, value_ops, sel, num_groups_cap)
    data_s = payload.data[g.perm]
    notnull = g.sel_s if payload.nulls is None \
        else (g.sel_s & ~payload.nulls[g.perm])
    first_occ = (g.boundary | g.changes(value_ops)) & notnull
    cnt = g.sum(first_occ.to(I64))
    out, bad = _distinct_result(
        payload.kind, data_s, first_occ, cnt, g.sum,
        lambda v: g.reduce(v, "prod", 1.0))
    if bad is None:
        return g.fit(out), None
    if isinstance(out, tuple):
        return (g.fit(out[0]), g.fit(out[1])), g.null_where(bad)
    return g.fit(out), g.null_where(bad)


def ungrouped_distinct(value_ops, payload: AggPayload, sel):
    """DISTINCT aggregate without GROUP BY -> (scalar, isnull)."""
    live = _live(payload, sel)
    perm = sort_permutation(value_ops, live)
    first_occ = _changes([v[perm] for v in value_ops], sel.shape[0],
                         sel.device) & live[perm]
    return _distinct_result(
        payload.kind, payload.data[perm], first_occ,
        first_occ.sum(dtype=I64), torch.sum, torch.prod)


def group_entropy(key_ops, value_ops, payload: AggPayload, sel,
                  num_groups_cap: int):
    """Shannon entropy (log2) of the value distribution per group
    (reference: core_functions/aggregate/distributive/entropy.cpp):
    sort (group, value) and turn run lengths c into
    log2(n) - sum(c log2 c) / n."""
    live = _live(payload, sel)
    inner = [_inv(live), *value_ops]
    g = _SortedGroups(key_ops, inner, sel, num_groups_cap)
    live_s = live[g.perm]
    rstarts, c = _runs(g.boundary | g.changes(inner) | g.changes([sel]),
                       live_s)
    csum = g.sum(_c_log_c(c), g.slot[rstarts])
    n = g.sum(live_s.to(I64))
    return g.fit(_entropy(n, csum)), g.null_where(n == 0)


def ungrouped_entropy(value_ops, payload: AggPayload, sel):
    live = _live(payload, sel)
    perm = sort_permutation(value_ops, live)
    live_s = live[perm]
    _, c = _runs(_changes([v[perm] for v in value_ops] + [live_s],
                          sel.shape[0], sel.device), live_s)
    n = live.sum(dtype=I64)
    return _entropy(n, _c_log_c(c).sum()), n == 0


def _quantile(data_s, starts, cnts, q: float, interpolate: bool):
    """The q-quantile of each sorted run of `cnts` values starting at
    `starts` (reference: holistic aggregates in
    extension/core_functions/aggregate/holistic/)."""
    last = data_s.shape[0] - 1
    frac = q * (cnts.to(F64) - 1)
    lo = torch.clamp(torch.floor(frac).to(I64), min=0)
    hi = torch.clamp(torch.ceil(frac).to(I64), min=0)
    vlo = data_s[torch.clamp(starts + lo, 0, last)]
    if not interpolate:
        return vlo
    vhi = data_s[torch.clamp(starts + hi, 0, last)]
    w = frac - torch.floor(frac)
    return vlo.to(F64) * (1 - w) + vhi.to(F64) * w


def group_quantile(key_ops, value_ops, payload: AggPayload, q: float,
                   sel, num_groups_cap: int, interpolate: bool):
    """Per-group quantile of payload.data ordered by value_ops.  Groups
    are formed over all selected rows; inside each group the rows with a
    payload sort first, so the group's start is the quantile's base.
    Returns (result float64|value dtype, isnull)."""
    live = _live(payload, sel)
    g = _SortedGroups(key_ops, [_inv(live), *value_ops], sel,
                      num_groups_cap)
    cnts = g.sum(live[g.perm].to(I64))
    out = _quantile(payload.data[g.perm], g.starts, cnts, q, interpolate)
    return g.fit(out), g.null_where(cnts == 0)


def ungrouped_quantile(value_ops, payload: AggPayload, q: float, sel,
                       interpolate: bool):
    live = _live(payload, sel)
    perm = sort_permutation(value_ops, live)
    cnt = live.sum(dtype=I64)
    zero = torch.zeros((), dtype=I64, device=sel.device)
    return _quantile(payload.data[perm], zero, cnt, q, interpolate), cnt == 0


def group_mode(key_ops, value_ops, payload: AggPayload, sel,
               num_groups_cap: int):
    """Per-group most frequent value (reference: holistic mode,
    extension/core_functions/aggregate/holistic/mode.cpp): one sort by
    (group, value), run lengths, then per group the first run of the
    greatest length.  Values ascend inside a group, so tied counts go to
    the smallest value."""
    live = _live(payload, sel)
    inner = [_inv(live), *value_ops]
    g = _SortedGroups(key_ops, inner, sel, num_groups_cap)
    rstarts, c = _runs(g.boundary | g.changes(inner) | g.changes([sel]),
                       live[g.perm])
    rslot = g.slot[rstarts]
    nruns = rstarts.shape[0]
    best = torch.zeros(g.ngroups + 1, dtype=I64, device=g.dev
                       ).scatter_reduce_(0, rslot, c, "amax")
    ridx = torch.arange(nruns, dtype=I64, device=g.dev)
    first = g.reduce(torch.where((c == best[rslot]) & (c > 0), ridx, nruns),
                     "amin", nruns, rslot)
    at = g.perm[rstarts[torch.clamp(first, max=nruns - 1)]]
    return g.fit(payload.data[at]), g.null_where(best[:g.ngroups] == 0)


def ungrouped_mode(value_ops, payload: AggPayload, sel):
    """Most frequent value over all selected rows (ties -> smallest)."""
    live = _live(payload, sel)
    perm = sort_permutation(value_ops, live)
    live_s = live[perm]
    rstarts, c = _runs(_changes([v[perm] for v in value_ops] + [live_s],
                                sel.shape[0], sel.device), live_s)
    # argmax returns the first maximum; values ascend, so ties break small
    return payload.data[perm[rstarts[torch.argmax(c)]]], ~live.any()


def _argext_live(by_nulls, payload: AggPayload, sel, keep_null_payload):
    live = sel if by_nulls is None else (sel & ~by_nulls)
    if payload.nulls is not None and not keep_null_payload:
        # arg_min/arg_max skip NULL payloads; the _null variants keep
        # them (reference: arg_min_max.cpp ArgMinMaxNull)
        live = live & ~payload.nulls
    return live


def _argext_at(at, live, payload: AggPayload, keep_null_payload):
    isnull = ~live[at]
    if keep_null_payload and payload.nulls is not None:
        isnull = isnull | payload.nulls[at]
    return payload.data[at], isnull


def group_argext(key_ops, by_ops, by_nulls, payload: AggPayload, sel,
                 num_groups_cap: int, is_max: bool,
                 keep_null_payload: bool = False):
    """arg_min/arg_max: payload value at the row where the BY key is
    extremal, per group (reference: arg_min_max.cpp): one stable sort
    puts each group's BY-extremal row first.  Rows where either the BY
    key or the payload is NULL are ignored, so the result falls back to
    the next-extremal row with a non-NULL payload.  Among rows tied on
    the BY key the first input row wins."""
    live = _argext_live(by_nulls, payload, sel, keep_null_payload)
    ops = [~o for o in by_ops] if is_max else list(by_ops)
    g = _SortedGroups(key_ops, [_inv(live), *ops], sel, num_groups_cap)
    out, isnull = _argext_at(g.perm[g.starts], live, payload,
                             keep_null_payload)
    return g.fit(out), g.null_where(isnull)


def ungrouped_argext(by_ops, by_nulls, payload: AggPayload, sel,
                     is_max: bool, keep_null_payload: bool = False):
    live = _argext_live(by_nulls, payload, sel, keep_null_payload)
    ops = [~o for o in by_ops] if is_max else list(by_ops)
    return _argext_at(sort_permutation(ops, live)[0], live, payload,
                      keep_null_payload)

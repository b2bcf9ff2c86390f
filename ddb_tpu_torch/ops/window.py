"""Window functions (PyTorch port of ddb_tpu/ops/window.py).

Replacement for the reference's window executor (reference:
src/execution/operator/aggregate/physical_window.cpp,
src/function/window/window_segment_tree.cpp).  One stable sort by
(partition keys, order keys) puts partitions and peer groups together;
every function is then computed in that sorted space and scattered back
to the input rows.

Where the TPU design ran segmented `associative_scan`s, most of what it
needs is a fill, not a scan: with the segments' first and last rows from
`seg_bounds`, a partition's start or end, a peer group's start or end and
"the value at the segment's end" are gathers.  Integer running sums are
a global prefix sum minus the prefix at the segment's start (exact);
float running sums and running min/max are true segmented scans and run
as log-step doubling passes (`seg_scan`), which add only inside a
partition, so no partition inherits the rounding of the rows before it.
Framed sums are differences of those per-partition running sums (the
reference package takes them from one global prefix sum, so its float
frames carry the rounding of every row sorted before them).

Default frame semantics (duckdb): with ORDER BY, aggregates use
RANGE UNBOUNDED PRECEDING .. CURRENT ROW (peer rows share the value at the
END of their peer group); without ORDER BY the whole partition.

Host reads (each one a device synchronisation), per call: the sort's key
spans (1), the partitions' and, where a function needs them, the peer
groups' count (`torch.nonzero`, 1 each); per function: the longest
partition for a float running sum or a running min/max (1), the widest
frame for a framed min/max (1), and one more sort's spans for each
RANGE/GROUPS bound and each DISTINCT aggregate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from . import sortkey
from .aggregate import (F64, I64, _acc_dtype, _changes, _extreme, seg_bounds,
                        seg_cumsum_int, seg_scan)
from .order import sort_permutation

# A framed min/max builds a sparse table of (levels, rows) values; past
# this size it raises instead of exhausting the device.
MAX_SPARSE_TABLE_BYTES = 16 << 30


class WindowSpec(NamedTuple):
    kind: str              # row_number|rank|dense_rank|percent_rank|
    #                        cume_dist|ntile|sum|sum_float|min|max|count|
    #                        count_star|avg|first_value|last_value|lag|
    #                        lead|nth_value
    data: Optional[torch.Tensor]
    nulls: Optional[torch.Tensor]
    offset: int = 1        # lag/lead offset; nth_value's n; ntile's k
    has_order: bool = True
    whole_partition: bool = False   # force whole-partition frame
    rows_frame: Optional[tuple] = None   # (preceding|None, following|None)
    # RANGE value frame (reference: window_boundaries_state in
    # function/window/window_executor.cpp): value distances over ONE
    # numeric order key
    range_frame: Optional[tuple] = None  # (preceding|None, following|None)
    order_val: Optional[torch.Tensor] = None      # raw order-key values
    order_val_nulls: Optional[torch.Tensor] = None
    order_desc: bool = False
    order_nulls_first: bool = False
    order_dtype: object = None
    # GROUPS frame: peer-group distances (reference: WindowBoundary
    # EXPR_PRECEDING_GROUPS, function/window/window_boundaries_state.cpp)
    groups_frame: Optional[tuple] = None
    # frame exclusion: None | "current row" | "group" | "ties"
    # (reference: WindowExcludeMode, window_executor.cpp)
    exclude: Optional[str] = None
    # DISTINCT aggregate over the whole partition (count/sum/avg)
    distinct: bool = False


class _Sorted:
    """The sorted space of one (partition, order) signature: rows by
    (dead last, partition keys, order keys), ties in input order.  Dead
    rows form segments of their own, so with an empty PARTITION BY they
    never join the one partition."""

    def __init__(self, part_ops, order_ops, sel):
        self.cap, self.dev = sel.shape[0], sel.device
        self.part_ops = list(part_ops)
        self.sel = sel
        self.perm = sort_permutation([*part_ops, *order_ops], sel)
        self.valid = sel[self.perm]
        self.pos = torch.arange(self.cap, dtype=I64, device=self.dev)
        self.pb = _changes([k[self.perm] for k in part_ops] + [self.valid],
                           self.cap, self.dev)
        self.ob = self.pb | _changes([k[self.perm] for k in order_ops],
                                     self.cap, self.dev)
        self.pseg, self.pstarts, self.pends = seg_bounds(self.pb)
        self.part_start = self.pstarts[self.pseg]
        self._part_end = self._peers = self._longest = None

    @property
    def part_end(self):
        if self._part_end is None:
            self._part_end = self.pends[self.pseg]
        return self._part_end

    @property
    def peers(self):
        """(oseg, peer_first, peer_end) of every row."""
        if self._peers is None:
            oseg, starts, ends = seg_bounds(self.ob)
            self._peers = (oseg, starts[oseg], ends[oseg])
        return self._peers

    @property
    def longest(self) -> int:
        """Rows of the largest partition (a host read)."""
        if self._longest is None:
            self._longest = int((self.pends - self.pstarts).max()) + 1
        return self._longest

    def dense_rank(self):
        oseg = self.peers[0]
        return oseg - oseg[self.part_start] + 1

    def running_sum(self, v):
        """Inclusive running sum of v inside each partition."""
        if v.dtype.is_floating_point:
            return seg_scan(v, self.pseg, torch.add, self.longest)
        return seg_cumsum_int(v, self.pseg, self.pstarts)

    def frame_value(self, running, whole: bool):
        """Map a running (inclusive) scan to the default-frame value:
        whole partition => value at partition end; RANGE current-row =>
        value at peer-group end."""
        return running[self.part_end if whole else self.peers[2]]

    def part_total(self, v):
        """Per row, the sum of v over the row's partition."""
        tot = torch.zeros(self.pstarts.shape[0], dtype=v.dtype,
                          device=self.dev).index_add_(0, self.pseg, v)
        return tot[self.pseg]


def compute_windows(part_ops: Sequence[torch.Tensor],
                    order_ops: Sequence[torch.Tensor],
                    specs: Sequence[WindowSpec],
                    sel: torch.Tensor):
    """Returns list[(data, nulls)] per spec, aligned to ORIGINAL row order.
    Rows with sel=False get unspecified values (masked upstream)."""
    S = _Sorted(part_ops, order_ops, sel)
    out = []
    for s in specs:
        d, n = _compute_sorted(S, s)
        # back to input order: sorted row i is input row perm[i]
        od = torch.empty_like(d)
        od[S.perm] = d
        on = None
        if n is not None:
            on = torch.empty_like(n)
            on[S.perm] = n
        out.append((od, on))
    return out


def _compute_sorted(S: _Sorted, s: WindowSpec):
    """(data, nulls) of one spec in the sorted space."""
    if s.kind in ("min", "max") and s.data.dtype == torch.bool:
        # torch has no min/max reductions over bool
        d, n = _compute_sorted(S, s._replace(data=s.data.to(torch.int32)))
        return d.to(torch.bool), n
    cap, pos, part_start = S.cap, S.pos, S.part_start
    data_s = None if s.data is None else s.data[S.perm]
    nn_s = None if s.nulls is None else s.nulls[S.perm]
    notnull = S.valid if nn_s is None else (S.valid & ~nn_s)

    if s.kind == "row_number":
        return pos - part_start + 1, None
    if s.kind == "rank":
        return S.peers[1] - part_start + 1, None
    if s.kind == "dense_rank":
        return S.dense_rank(), None
    if s.kind in ("percent_rank", "cume_dist", "ntile"):
        psize = (S.part_end - part_start + 1).to(F64)
        if s.kind == "percent_rank":
            rk = (S.peers[1] - part_start).to(F64)
            return rk / torch.clamp(psize - 1, min=1), None
        if s.kind == "cume_dist":
            # peers share the value at the END of their peer group
            return (S.peers[2] - part_start + 1).to(F64) / psize, None
        rn0 = (pos - part_start).to(F64)
        return torch.floor(rn0 * float(s.offset) / psize).to(I64) + 1, None
    if s.kind in ("lag", "lead"):
        k = s.offset
        at = pos - k if s.kind == "lag" else pos + k
        outside = (at < part_start) | (at > S.part_end)
        at = torch.clamp(at, 0, cap - 1)
        isnull = outside if nn_s is None else (outside | nn_s[at])
        return data_s[at], isnull

    has_frame = (s.rows_frame is not None or s.range_frame is not None
                 or s.groups_frame is not None)

    if s.distinct:
        if s.kind not in ("count", "sum", "sum_float", "avg") or has_frame:
            raise NotImplementedError(
                f"DISTINCT window {s.kind} with a frame")
        return _distinct_over_partition(S, s)

    # value functions through explicit frames + nth_value
    # (reference: WindowValueExecutor, function/window/
    # window_value_function.cpp)
    if s.kind == "nth_value" or (
            s.kind in ("first_value", "last_value") and has_frame):
        lo_i, hi_i = _frame_bounds(S, s)
        empty = hi_i < lo_i
        if s.kind == "first_value":
            p = lo_i
        elif s.kind == "last_value":
            p = hi_i
        else:
            p = lo_i + (s.offset - 1)
            empty = empty | (p > hi_i)
        p = torch.clamp(p, 0, cap - 1)
        return data_s[p], empty if nn_s is None else (empty | nn_s[p])

    if s.kind == "first_value":
        return data_s[part_start], None if nn_s is None \
            else nn_s[part_start]
    if s.kind == "last_value":
        # default frame: value at current peer-group end
        peer_end = S.peers[2]
        return data_s[peer_end], None if nn_s is None else nn_s[peer_end]

    if (has_frame or s.exclude) \
            and s.kind in ("sum", "sum_float", "avg", "count",
                           "count_star", "min", "max"):
        return _framed_aggregate(S, s, data_s, notnull)

    # aggregates over the default frame
    whole = s.whole_partition or not s.has_order
    if s.kind in ("count_star", "count"):
        v = (S.valid if s.kind == "count_star" else notnull).to(I64)
        return _default_sum(S, v, whole), None
    cnt_f = _default_sum(S, notnull.to(I64), whole)
    if s.kind in ("sum", "sum_float", "avg"):
        acc = _acc_dtype(s.kind, data_s.dtype)
        out = _default_sum(S, torch.where(notnull, data_s.to(acc), 0),
                           whole)
        if s.kind == "avg":
            out = out.to(F64) / torch.clamp(cnt_f, min=1)
        return out, cnt_f == 0
    if s.kind in ("min", "max"):
        big = _extreme(data_s.dtype, s.kind)
        v = torch.where(notnull, data_s, big)
        if whole:
            ext = torch.full((S.pstarts.shape[0],), big, dtype=v.dtype,
                             device=S.dev
                             ).scatter_reduce_(0, S.pseg, v, "a" + s.kind)
            return ext[S.pseg], cnt_f == 0
        run = seg_scan(v, S.pseg, _minmax(s.kind), S.longest)
        return S.frame_value(run, False), cnt_f == 0
    raise NotImplementedError(f"window {s.kind}")


def _minmax(kind):
    return torch.minimum if kind == "min" else torch.maximum


def _default_sum(S: _Sorted, v, whole: bool):
    """Sum of v over the default frame: the whole partition, or up to the
    end of the current peer group."""
    if whole:
        return S.part_total(v)
    return S.frame_value(S.running_sum(v), False)


def _distinct_over_partition(S: _Sorted, s: WindowSpec):
    """DISTINCT count/sum/avg over the whole partition (reference:
    WindowDistinctAggregator, function/window/
    window_distinct_aggregator.cpp): an auxiliary sort by (partition,
    value) marks first occurrences; their per-partition totals are the
    result.  Both sorts order the partitions alike, so partition p of the
    auxiliary sort is partition p of the main one."""
    data, sel = s.data, S.sel
    nn = s.nulls if s.nulls is not None else torch.zeros_like(sel)
    vkey = data
    if data.dtype.is_floating_point:
        # the bit pattern's order: a total order that keeps NaNs together
        bits = data.to(F64).contiguous().view(I64)
        vkey = torch.where(bits < 0, bits ^ (2**63 - 1), bits)
    perm = sort_permutation([*S.part_ops, nn.to(torch.int32), vkey], sel)
    a_valid, a_nn, a_v = sel[perm], nn[perm], data[perm]
    apb = _changes([k[perm] for k in S.part_ops] + [a_valid], S.cap, S.dev)
    first_occ = apb.clone()
    first_occ[1:] |= (a_v[1:] != a_v[:-1]) | (a_nn[1:] != a_nn[:-1])
    live = a_valid & ~a_nn & first_occ
    aseg = torch.cumsum(apb, 0) - 1
    nparts = S.pstarts.shape[0]

    def total(v):
        return torch.zeros(nparts, dtype=v.dtype, device=S.dev
                           ).index_add_(0, aseg, v)[S.pseg]

    cnt = total(live.to(I64))
    if s.kind == "count":
        return cnt, None
    acc = _acc_dtype(s.kind, a_v.dtype)
    tot = total(torch.where(live, a_v.to(acc), 0))
    if s.kind == "avg":
        tot = tot.to(F64) / torch.clamp(cnt, min=1)
    return tot, cnt == 0


def _framed_aggregate(S: _Sorted, s: WindowSpec, data_s, notnull):
    """sum/avg/count/min/max over an explicit ROWS / RANGE / GROUPS frame:
    sliding sums via prefix differences; sliding min/max via sparse-table
    range queries (the analog of the reference's window segment tree,
    src/function/window/window_segment_tree.cpp).  EXCLUDE subtracts the
    excluded sub-interval (sums) or splits the query interval in two
    (extrema)."""
    cap, pos = S.cap, S.pos
    lo_i, hi_i = _frame_bounds(S, s)
    hi_i = torch.clamp(hi_i, 0, cap - 1)
    lo_i = torch.clamp(lo_i, 0, cap - 1)
    empty = hi_i < lo_i
    hi_i = torch.maximum(hi_i, lo_i)

    # excluded sub-interval [xlo, xhi] (clipped to the frame);
    # xhi < xlo means nothing is excluded
    if s.exclude in ("group", "ties"):
        xlo = torch.maximum(lo_i, S.peers[1])
        xhi = torch.minimum(hi_i, S.peers[2])
    elif s.exclude == "current row":
        xlo = torch.maximum(lo_i, pos)
        xhi = torch.minimum(hi_i, pos)
    else:
        xlo = torch.ones_like(pos)
        xhi = torch.zeros_like(pos)
    xlo = torch.clamp(xlo, 0, cap - 1)
    xhi = torch.clamp(xhi, -1, cap - 1)
    cur_in = (lo_i <= pos) & (pos <= hi_i) & ~empty

    def rng_sum(pref, base, lo, hi):
        return pref[hi] - (pref[lo] - base[lo])

    if s.kind in ("min", "max"):
        op = _minmax(s.kind)
        big = _extreme(data_s.dtype, s.kind)
        v = torch.where(notnull, data_s, big)
        nnl = notnull.to(I64)
        prefc = torch.cumsum(nnl, 0)
        if s.exclude:
            has_x = xhi >= xlo
            # left part [lo_i, xlo-1], right part [xhi+1, hi_i]
            lhi = torch.maximum(xlo - 1, lo_i)
            lempty = empty | (xlo <= lo_i)
            rlo = torch.clamp(torch.minimum(xhi + 1, hi_i), 0, cap - 1)
            rempty = empty | (xhi >= hi_i)
            a = _range_extrema(v, lo_i, lhi, op, big)
            b = _range_extrema(v, rlo, hi_i, op, big)
            a = torch.where(lempty & has_x, big, a)
            b = torch.where(rempty & has_x, big, b)
            out = op(a, b)
            wcnt = torch.where(empty, 0, rng_sum(prefc, nnl, lo_i, hi_i)) \
                - torch.where(has_x, rng_sum(prefc, nnl, xlo,
                                             torch.maximum(xhi, xlo)), 0)
            if s.exclude == "ties":
                # keep the current row itself
                out = torch.where(cur_in & notnull, op(out, data_s), out)
                wcnt = wcnt + torch.where(cur_in, nnl, 0)
        elif s.rows_frame == (None, 0):
            # running frame: a segmented scan suffices
            out = seg_scan(v, S.pseg, op, S.longest)
            wcnt = seg_cumsum_int(nnl, S.pseg, S.pstarts)
        else:
            out = _range_extrema(v, lo_i, hi_i, op, big)
            wcnt = torch.where(empty, 0, rng_sum(prefc, nnl, lo_i, hi_i))
        return out, wcnt == 0

    if s.kind == "count_star":
        v = nn_cnt = S.valid.to(I64)
    elif s.kind == "count":
        v = nn_cnt = notnull.to(I64)
    else:
        acc = _acc_dtype(s.kind, data_s.dtype)
        v = torch.where(notnull, data_s.to(acc), 0)
        nn_cnt = notnull.to(I64)
    # a frame lies inside one partition, so the partition's own running
    # sum serves: a float frame then never sees another partition's
    # magnitude
    pref = S.running_sum(v)
    prefc = torch.cumsum(nn_cnt, 0)
    wsum = torch.where(empty, 0, rng_sum(pref, v, lo_i, hi_i))
    wcnt = torch.where(empty, 0, rng_sum(prefc, nn_cnt, lo_i, hi_i))
    if s.exclude:
        has_x = (xhi >= xlo) & ~empty
        xhi = torch.maximum(xhi, xlo)
        wsum = wsum - torch.where(has_x, rng_sum(pref, v, xlo, xhi), 0)
        wcnt = wcnt - torch.where(has_x, rng_sum(prefc, nn_cnt, xlo, xhi), 0)
        if s.exclude == "ties":
            wsum = wsum + torch.where(cur_in, v, 0)
            wcnt = wcnt + torch.where(cur_in, nn_cnt, 0)
    if s.kind in ("count", "count_star"):
        return wcnt, None
    if s.kind == "avg":
        return wsum.to(F64) / torch.clamp(wcnt, min=1), wcnt == 0
    return wsum, wcnt == 0


def _frame_bounds(S: _Sorted, s: WindowSpec):
    """(lo_i, hi_i) sorted-space positions of the spec's frame; the
    dialect-default frame (RANGE unbounded-preceding..current peer end,
    or the whole partition without ORDER BY) when no explicit frame."""
    if s.rows_frame is not None:
        pre, post = s.rows_frame
        lo_i = S.part_start if pre is None else \
            torch.maximum(S.pos - pre, S.part_start)
        hi_i = S.part_end if post is None else \
            torch.minimum(S.pos + post, S.part_end)
        return lo_i, hi_i
    if s.range_frame is not None:
        return _range_frame_bounds(S, s)
    if s.groups_frame is not None:
        return _groups_frame_bounds(S, s)
    if s.whole_partition or not s.has_order:
        return S.part_start, S.part_end
    # default: partition start .. end of current peer group
    return S.part_start, S.peers[2]


def _groups_frame_bounds(S: _Sorted, s: WindowSpec):
    """Positions (lo_i, hi_i) of a GROUPS frame: peer-group distances
    (reference: GROUPS boundaries in
    function/window/window_boundaries_state.cpp).  The group index is
    the dense rank of the row's peer group within its partition."""
    pre, post = s.groups_frame
    dr = S.dense_rank()                       # 1-based group idx
    lo_i, hi_i = S.part_start, S.part_end
    if pre is not None:
        lo_i = S.part_start + _rank_in_partition(S, S.valid, dr, dr - pre,
                                                 strict=True)
    if post is not None:
        hi_i = S.part_start + _rank_in_partition(S, S.valid, dr, dr + post,
                                                 strict=False) - 1
    return lo_i, hi_i


def _range_extrema(v, lo, hi, op, ident):
    """min/max of v[lo..hi] (inclusive, lo<=hi) per row via a sparse
    table: power-of-two interval extrema, then two gathers per row.  Only
    the levels the widest frame needs are built (one host read), and a
    table beyond MAX_SPARSE_TABLE_BYTES raises."""
    n = v.shape[0]
    width = hi - lo + 1
    # level k = floor(log2(width)); two overlapping 2^k windows cover it
    top = max(int(width.max()), 1).bit_length() - 1
    nbytes = (top + 1) * n * v.element_size()
    if nbytes > MAX_SPARSE_TABLE_BYTES:
        raise MemoryError(
            f"framed min/max: a frame of {1 << top} rows over {n} rows "
            f"needs a sparse table of {nbytes} bytes, over the limit of "
            f"{MAX_SPARSE_TABLE_BYTES}")
    levels = [v]
    for k in range(top):
        step = 1 << k
        prev = levels[-1]
        pad = torch.full((min(step, n),), ident, dtype=v.dtype,
                         device=v.device)
        levels.append(op(prev, torch.cat([prev[step:], pad])))
    flat = torch.stack(levels).reshape(-1)            # (K, n)
    # floor(log2(width)) by comparing with the powers of two (no clz)
    k = torch.zeros_like(width)
    for j in range(1, top + 1):
        k += width >= (1 << j)
    return op(flat[k * n + lo],
              flat[k * n + hi - (torch.ones_like(k) << k) + 1])


def _rank_in_partition(S: _Sorted, count_mask, enc_vals, enc_thr,
                       strict: bool):
    """Per row i: number of rows j in i's partition with count_mask[j]
    and enc_vals[j] < enc_thr[i] (<= when strict=False).  Both sequences
    are merged in ONE sort (queries tie-broken before/after equal reals),
    then a running count inside each partition answers every query.  The
    partition id keeps dead rows in segments of their own, so they never
    contaminate counts — required when PARTITION BY is empty."""
    cap, dev = S.cap, S.dev
    keys = torch.cat([S.pseg, S.pseg])
    vals = torch.cat([enc_vals.to(I64), enc_thr.to(I64)])
    # strict: queries sort BEFORE equal reals, so equal values are not
    # counted
    real_tag, query_tag = (1, 0) if strict else (0, 1)
    tag = torch.cat([torch.full((cap,), real_tag, dtype=torch.int32,
                                device=dev),
                     torch.full((cap,), query_tag, dtype=torch.int32,
                                device=dev)])
    cm = torch.cat([count_mask.to(I64),
                    torch.zeros(cap, dtype=I64, device=dev)])
    perm = sort_permutation([keys, vals, tag],
                            torch.ones(2 * cap, dtype=torch.bool,
                                       device=dev))
    keys_m, cm_m = keys[perm], cm[perm]
    seg, starts, _ = seg_bounds(_changes([keys_m], 2 * cap, dev))
    cnt = torch.empty(2 * cap, dtype=I64, device=dev)
    cnt[perm] = seg_cumsum_int(cm_m, seg, starts)
    return cnt[cap:]


def _range_frame_bounds(S: _Sorted, s: WindowSpec):
    """Positions (lo_i, hi_i) of a RANGE value frame in the sorted space
    (reference: function/window/window_executor.cpp value boundaries).
    NULL-order rows frame over their own peer group."""
    pre, post = s.range_frame
    oval_s = s.order_val[S.perm]
    o_isnull = torch.zeros_like(S.valid) if s.order_val_nulls is None \
        else s.order_val_nulls[S.perm]
    o_notnull = S.valid & ~o_isnull

    def enc(x):
        e = sortkey._orderable(x, s.order_dtype).to(I64)
        return ~e if s.order_desc else e

    enc_real = torch.where(o_notnull, enc(oval_s), 2**63 - 1)
    # base position of the non-NULL region within each partition
    total_nulls = S.part_total(o_isnull.to(I64))
    base = S.part_start + (total_nulls if s.order_nulls_first else 0)

    sign = -1 if s.order_desc else 1
    if pre is not None:
        lo_i = base + _rank_in_partition(
            S, o_notnull, enc_real, enc(oval_s - sign * pre), strict=True)
    else:
        lo_i = base
    if post is not None:
        hi_i = base + _rank_in_partition(
            S, o_notnull, enc_real, enc(oval_s + sign * post),
            strict=False) - 1
    else:
        hi_i = base + S.part_total(o_notnull.to(I64)) - 1
    # NULL-order rows: frame = their peer group
    lo_i = torch.where(o_isnull, S.peers[1], lo_i)
    hi_i = torch.where(o_isnull, S.peers[2], hi_i)
    return lo_i, hi_i

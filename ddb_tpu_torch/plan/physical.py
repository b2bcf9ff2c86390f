"""Physical execution of bound logical plans (PyTorch port of
ddb_tpu/plan/physical.py): scan, filter, project, aggregate (plain,
DISTINCT and holistic), window, joins (equi, range, asof, nested-loop
outer, cross product, positional), UNION ALL, order, top-N, limit and
distinct.

Execution is eager: each operator runs its torch ops on the device the
caller names and returns a concrete Batch.  (The reference package
defers operators into a fusion DAG that XLA compiles per pipeline; that
DAG is not ported.)  Where the reference fetches live counts and match
totals to the host in one transfer per pipeline breaker, this executor
reads them with `.tolist()`/`int()` where it needs them.  The
aggregates whose results are of variable size (`_HOST_AGG_KINDS`),
samples, CTEs and unnest raise NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Column, Schema, bucket_capacity, torch_dtype
from ..expr import ir
from ..expr.compile import evaluate, select_mask
from ..ops import aggregate as agg_ops
from ..ops import join as join_ops
from ..ops import order as order_ops
from ..ops import sketch, sortkey
from ..ops import window as win_ops
from ..types import TypeId
from . import bounds as B
from . import logical as L


def execute(node: L.LogicalNode, device: torch.device
            ) -> Tuple[Schema, Batch]:
    """Run a bound, optimized plan; every batch lives on `device`."""
    fn = _EXEC.get(type(node))
    if fn is None:
        raise NotImplementedError(
            f"{type(node).__name__} is not ported (scans, filters, "
            "projections, aggregates, windows, joins, UNION ALL, order, "
            "limit and distinct are)")
    return fn(node, device)


def _gather(b: Batch, idx, sel, count) -> Batch:
    """Batch whose rows are b's rows at `idx` (all limbs and masks)."""
    cols = tuple(Column(c.data[idx],
                        None if c.nulls is None else c.nulls[idx],
                        None if c.hi is None else c.hi[idx])
                 for c in b.columns)
    return Batch(cols, sel, count)


def _filtered(b: Batch, pred) -> Batch:
    m = select_mask(pred, b)
    return Batch(b.columns, m, m.sum(dtype=torch.int32))


# ---- scan -----------------------------------------------------------------

def _zone_map_groups(node: L.Get):
    """Row-group zone-map pruning for a filtered scan (reference:
    per-segment CheckZonemap, src/storage/table/column_segment.cpp).
    Returns the surviving group ids when at least one group is provably
    filter-free, else None (whole-table scan).  The residual filter mask
    still applies to the surviving rows."""
    from ..storage import table as table_mod

    if not node.filters:
        return None
    tbl = node.table
    if tbl.num_rows <= table_mod.ROW_GROUP_SIZE:
        return None
    stats = tbl.row_group_stats()
    pred = ir.make_and(node.filters)
    idxs = node.column_indices if node.column_indices is not None \
        else range(len(tbl.columns))
    keep = []
    for g, row in enumerate(stats):
        cols, nullable = [], []
        for i in idxs:
            mn, mx, hn = row[i]
            cols.append(None if mn is None else (float(mn), float(mx)))
            nullable.append(hn)
        if B.pred_maybe_true(pred, cols, nullable):
            keep.append(g)
    table_mod.SCAN_STATS["groups_total"] += len(stats)
    table_mod.SCAN_STATS["groups_skipped"] += len(stats) - len(keep)
    return None if len(keep) == len(stats) else keep


def _exec_get(node: L.Get, device):
    gids = _zone_map_groups(node)
    if gids is not None:
        batch = node.table.device_batch_groups(node.column_indices, gids,
                                               device=device)
    else:
        batch = node.table.device_batch(node.column_indices, device=device)
    if node.filters:
        batch = _filtered(batch, ir.make_and(node.filters))
    return node.schema, batch


def _exec_filter(node: L.Filter, device):
    _, b = execute(node.child, device)
    return node.schema, _filtered(b, node.predicate)


def _exec_project(node: L.Project, device):
    _, b = execute(node.child, device)
    cols = []
    for e in node.exprs:
        # bare column refs pass through unchanged, preserving wide
        # (two-limb) columns exactly
        if isinstance(e, ir.ColRef):
            cols.append(b.columns[e.index])
            continue
        cols.append(Column(*evaluate(e, b)))
    return node.schema, Batch(tuple(cols), b.sel, b.count)


# ---- aggregation ----------------------------------------------------------

_DENSE_KINDS = {"count_star", "count", "sum", "sum_float", "avg",
                "sum_wide", "avg_wide", "min", "max", "any_value",
                "var_samp", "var_pop", "stddev_samp", "stddev_pop",
                "covar_samp", "covar_pop", "corr"}
# kinds whose results are of variable size: the reference package
# computes them on the host (_exec_aggregate_host); not ported
_HOST_AGG_KINDS = ("collect", "string_agg", "histogram", "approx_top_k",
                   "mad", "udaf")
# below this batch capacity approx_count_distinct counts exactly; from it
# on it estimates with HyperLogLog (ops/sketch.py; reference:
# approx_count.cpp)
HLL_MIN_CAPACITY = 1 << 17


def _perfect_hash_domain(node: L.Aggregate):
    """If every group key has a small dense domain, return per-key domain
    sizes (else None).  VARCHAR dict codes and BOOLEAN qualify."""
    sizes = []
    for g in node.groups:
        sd = getattr(g, "strdict", None)
        if g.dtype.id == TypeId.VARCHAR and sd is not None:
            sizes.append(len(sd) + 1)          # +1 for NULL slot
        elif g.dtype.id == TypeId.BOOLEAN:
            sizes.append(3)
        else:
            return None
    total = int(np.prod(sizes))
    return None if total > agg_ops.MAX_MASKED_DOMAIN else sizes


def _wide_aggs(node: L.Aggregate, capacity: int):
    """Indices of sum/avg aggregates that need two-limb (i128) accumulation:
    int/decimal argument whose int64 sum cannot be proven overflow-free by
    interval analysis (plan/bounds.py) for this batch capacity."""
    wide = set()
    child_bounds = None
    for i, a in enumerate(node.aggs):
        if a.kind not in ("sum", "avg") or a.arg is None:
            continue
        at = a.arg.dtype
        if not (at.is_integer or at.id == TypeId.DECIMAL):
            continue
        if child_bounds is None:
            child_bounds = B.node_bounds(node.child)
        bd = B.expr_bounds(a.arg, child_bounds)
        if not B.sum_fits_int64(bd, capacity):
            wide.add(i)
    return wide


def _payloads(node: L.Aggregate, b: Batch):
    wide = _wide_aggs(node, b.capacity)
    ps = []
    for i, a in enumerate(node.aggs):
        if a.kind == "count_star":
            ps.append(agg_ops.AggPayload("count_star", None, None))
            continue
        d, n = evaluate(a.arg, b)
        d2 = None
        if a.arg2 is not None:
            d2, n2 = evaluate(a.arg2, b)
            if n2 is not None:
                n = n2 if n is None else (n | n2)
        kind = a.kind
        if kind == "sum" and a.arg.dtype.id in (TypeId.FLOAT,
                                                TypeId.DOUBLE):
            kind = "sum_float"
        elif kind in ("sum", "avg") and i in wide:
            kind = {"sum": "sum_wide", "avg": "avg_wide"}[kind]
        ps.append(agg_ops.AggPayload(kind, d, n, d2))
    return ps


def _agg_column(a: L.AggSpec, d, n) -> Column:
    if isinstance(d, tuple):          # wide sum: (composed, high limb)
        return Column(d[0], n, d[1])
    if (a.kind == "avg" or (a.kind == "quantile" and a.interpolate)) \
            and a.arg is not None and a.arg.dtype.id == TypeId.DECIMAL:
        # integer sum was in fixed-point: scale back to a true double
        d = d / T.decimal_scale_factor(a.arg.dtype.scale)
    return Column(d.to(torch_dtype(a.dtype.np_dtype)), n)


def _agg_output(node: L.Aggregate, group_cols, agg_results, gsel,
                ngroups) -> Batch:
    cols = [Column(d, n) for d, n in group_cols]
    cols += [_agg_column(a, d, n) for a, (d, n) in zip(node.aggs,
                                                         agg_results)]
    return Batch(tuple(cols), gsel, ngroups)


def _is_special(a: L.AggSpec) -> bool:
    """Aggregates that need a sort of their own by (group, value)."""
    return a.kind in ("quantile", "mode", "arg_min", "arg_max", "entropy",
                      "approx_count_distinct") \
        or (a.distinct and a.kind != "count_star")


def _keep_null_payload(a: L.AggSpec) -> bool:
    return getattr(a, "extra", None) == "keep_null_payload"


def _ungrouped_special(a: L.AggSpec, p, b: Batch):
    """(scalar, isnull) of one DISTINCT or holistic aggregate over all
    live rows."""
    if a.kind in ("arg_min", "arg_max"):
        bd, bn = evaluate(a.arg2, b)
        return agg_ops.ungrouped_argext(
            sortkey.encode_key(bd, bn, a.arg2.dtype), bn, p, b.sel,
            a.kind == "arg_max", keep_null_payload=_keep_null_payload(a))
    vops = sortkey.encode_key(p.data, p.nulls, a.arg.dtype)
    if a.kind == "quantile":
        return agg_ops.ungrouped_quantile(vops, p, a.quantile, b.sel,
                                          a.interpolate)
    if a.kind == "mode":
        return agg_ops.ungrouped_mode(vops, p, b.sel)
    if a.kind == "entropy":
        return agg_ops.ungrouped_entropy(vops, p, b.sel)
    if a.kind == "approx_count_distinct":
        if b.capacity >= HLL_MIN_CAPACITY:
            return sketch.hll_count_distinct(vops[0], b.sel, p.nulls), None
        p = agg_ops.AggPayload("count", p.data, p.nulls)
    return agg_ops.ungrouped_distinct(vops, p, b.sel)


def _exec_aggregate(node: L.Aggregate, device):
    for a in node.aggs:
        if a.kind in _HOST_AGG_KINDS:
            raise NotImplementedError(
                f"aggregate {a.kind} (the variable-size aggregates "
                f"{', '.join(_HOST_AGG_KINDS)} are not ported)")
    _, b = execute(node.child, device)
    dev = b.device

    if not node.groups:
        res = [_ungrouped_special(a, p, b) if _is_special(a)
               else agg_ops.ungrouped_aggregate([p], b.sel)[0]
               for a, p in zip(node.aggs, _payloads(node, b))]
        # one live row in a 128-slot batch, as the reference package
        cols = []
        for a, (v, isn) in zip(node.aggs, res):
            n = None
            if isn is not None:
                n = torch.zeros(128, dtype=torch.bool, device=dev)
                n[0] = isn
            if isinstance(v, tuple):
                d = torch.zeros(128, dtype=torch.int64, device=dev)
                h = torch.zeros(128, dtype=torch.int64, device=dev)
                d[0], h[0] = v
                v = (d, h)
            else:
                v = v.expand(128).clone()
            cols.append(_agg_column(a, v, n))
        sel = torch.zeros(128, dtype=torch.bool, device=dev)
        sel[0] = True
        return node.schema, Batch(tuple(cols), sel,
                                  torch.tensor(1, dtype=torch.int32,
                                               device=dev))

    # any DISTINCT aggregate or kind outside the dense set bypasses the
    # perfect-hash path
    sizes = None
    if all(a.kind in _DENSE_KINDS and not _is_special(a)
           for a in node.aggs):
        sizes = _perfect_hash_domain(node)
    if sizes is None:
        return node.schema, local_grouped_aggregate(node, b)

    strides = [int(np.prod(sizes[i + 1:])) for i in range(len(sizes))]
    domain = int(np.prod(sizes))
    gid = torch.zeros(b.capacity, dtype=torch.int32, device=dev)
    key_dtypes = []
    for g, size, stride in zip(node.groups, sizes, strides):
        d, n = evaluate(g, b)
        code = d.to(torch.int32)
        if n is not None:
            code = torch.where(n, size - 1, code)
        key_dtypes.append(d.dtype)
        gid = gid + code * stride
    results, counts = agg_ops.dense_group_aggregate(
        gid, domain, _payloads(node, b), b.sel)
    gsel = counts > 0
    # reconstruct key values from the dense slot code
    slot = torch.arange(domain, dtype=torch.int32, device=dev)
    group_cols = []
    for dt, size, stride in zip(key_dtypes, sizes, strides):
        code = torch.remainder(torch.div(slot, stride,
                                         rounding_mode="floor"), size)
        group_cols.append((code.to(dt), code == (size - 1)))
    return node.schema, _agg_output(node, group_cols, results, gsel,
                                    gsel.sum(dtype=torch.int32))


def local_grouped_aggregate(node: L.Aggregate, b: Batch) -> Batch:
    """Sort-based grouped aggregation of one batch.  The plain aggregates
    share one sort by the group keys; each DISTINCT or holistic one
    sorts again by (group keys, its value), in the same group order."""
    key_ops, key_data = [], []
    for g in node.groups:
        d, n = evaluate(g, b)
        key_ops.extend(sortkey.encode_key(d, n, g.dtype))
        key_data.append((d, n))
    ps = _payloads(node, b)
    gcap = b.capacity
    plain = [i for i, a in enumerate(node.aggs) if not _is_special(a)]
    group_cols, plain_res, gsel, ng = agg_ops.group_and_aggregate(
        key_ops, key_data, [ps[i] for i in plain], b.sel, gcap)
    results = [None] * len(ps)
    for i, r in zip(plain, plain_res):
        results[i] = r
    for i, (a, p) in enumerate(zip(node.aggs, ps)):
        if not _is_special(a):
            continue
        if a.kind in ("arg_min", "arg_max"):
            bd, bn = evaluate(a.arg2, b)
            results[i] = agg_ops.group_argext(
                key_ops, sortkey.encode_key(bd, bn, a.arg2.dtype), bn, p,
                b.sel, gcap, a.kind == "arg_max",
                keep_null_payload=_keep_null_payload(a))
            continue
        vops = sortkey.encode_key(p.data, p.nulls, a.arg.dtype)
        if a.kind == "quantile":
            results[i] = agg_ops.group_quantile(
                key_ops, vops, p, a.quantile, b.sel, gcap, a.interpolate)
        elif a.kind == "mode":
            results[i] = agg_ops.group_mode(key_ops, vops, p, b.sel, gcap)
        elif a.kind == "entropy":
            results[i] = agg_ops.group_entropy(key_ops, vops, p, b.sel, gcap)
        else:       # DISTINCT, or approx_count_distinct counted exactly
            if a.kind == "approx_count_distinct":
                p = agg_ops.AggPayload("count", p.data, p.nulls)
            results[i] = agg_ops.group_distinct_aggregate(
                key_ops, vops, p, b.sel, gcap)
    return _agg_output(node, group_cols, results, gsel, ng)


# ---- joins ----------------------------------------------------------------

def _compact(batch: Batch, new_cap: int) -> Batch:
    """Move live rows to the front, in row order, and set the capacity to
    new_cap (at least the live count)."""
    dev = batch.device
    idx = torch.nonzero(batch.sel).squeeze(1)[:new_cap]
    live = idx.shape[0]
    idx = torch.cat([idx, torch.zeros(new_cap - live, dtype=torch.int64,
                                      device=dev)])
    return _gather(batch, idx, torch.arange(new_cap, device=dev) < live,
                   batch.count)


def _shrink(b: Batch, n: int, always=False) -> Batch:
    """Compact to the bucket of the live count n when that is smaller
    than the capacity.  `always` moves live rows to the front even when
    the capacity stays (needed before `[:n]` packing slices)."""
    want = min(bucket_capacity(max(n, 1)), b.capacity)
    return _compact(b, want) if (want < b.capacity or always) else b


def _live_counts(*batches):
    return torch.stack([b.count.to(torch.int64) for b in batches]).tolist()


def _joinable_int64(data, dtype):
    """Map a key column to int64 such that equality is preserved."""
    if dtype.id in (TypeId.FLOAT, TypeId.DOUBLE):
        d = data.to(torch.float64)
        d = torch.where(d == 0.0, 0.0, d)          # canonicalize -0.0
        return d.contiguous().view(torch.int64)
    return data.to(torch.int64)


def _key_arrays(conds, b: Batch, side: str):
    datas, nulls = [], []
    for c in conds:
        e = c.left if side == "left" else c.right
        d, n = evaluate(e, b)
        datas.append(_joinable_int64(d, e.dtype))
        nulls.append(n)
    return datas, nulls


def _combine_live(sel, nulls):
    live = sel
    for n in nulls:
        if n is not None:
            live = live & ~n
    return live


def _densify_keys(lds, l_live, rds, r_live):
    """Multi-key join: assign dense ids by group-sorting both sides
    together (exact, collision-free).  Returns int64 ids per side, equal
    exactly when all keys are equal; rows not live get -1."""
    nl = lds[0].shape[0]
    live = torch.cat([l_live, r_live])
    keys = [torch.cat([ld, rd]) for ld, rd in zip(lds, rds)]
    perm = order_ops.sort_permutation(keys, live)
    boundary = torch.zeros(perm.shape[0], dtype=torch.bool,
                           device=perm.device)
    boundary[:1] = True
    for k in keys:
        ks = k[perm]
        boundary[1:] |= ks[1:] != ks[:-1]
    gid = torch.cumsum(boundary, 0) - 1
    out = torch.empty_like(gid)
    out[perm] = torch.where(live[perm], gid, -1)
    return out[:nl], out[nl:]


def _equi_keys(conds, lb: Batch, l_live, rb: Batch, r_live):
    """One int64 key per side for the equality conditions (dense ids when
    there are several), with the rows that may match."""
    lds, lns = _key_arrays(conds, lb, "left")
    rds, rns = _key_arrays(conds, rb, "right")
    l_live = _combine_live(l_live, lns)
    r_live = _combine_live(r_live, rns)
    if len(lds) == 1:
        return lds[0], l_live, rds[0], r_live
    lk, rk = _densify_keys(lds, l_live, rds, r_live)
    return lk, l_live & (lk >= 0), rk, r_live & (rk >= 0)


def _mark_nulls(node: L.Join, lb: Batch, rb: Batch, has):
    """NULL mask for a 3-valued IN mark column (node.mark_in).

    mark is NULL where no match AND (a correlation-matching build row has
    a NULL IN-value, OR the probe IN-value is NULL and some build row
    matches the correlation keys).  Uncorrelated joins reduce both
    conditions to scalars (build-has-null / build-nonempty).
    Reference: ScanStructure::NextMarkJoin, join_hashtable.cpp."""
    _, lnull = evaluate(node.conds[0].left, lb)
    _, rnull = evaluate(node.conds[0].right, rb)
    probe_null = lnull if lnull is not None else torch.zeros_like(lb.sel)
    corr = node.conds[1:]
    if not corr:
        nonempty = rb.sel.any()
        hasnull = (rb.sel & rnull).any() if rnull is not None \
            else torch.zeros_like(nonempty)
        return ~has & ((probe_null & nonempty) | hasnull)
    # correlated: does any build row match the correlation keys at all
    # (n_any), and does one of those carry a NULL IN-value (n_null)?
    lk, l_live, rk, r_live = _equi_keys(corr, lb, lb.sel, rb, rb.sel)

    def any_match(build_live):
        bt = join_ops.build(rk, None, build_live)
        return join_ops.probe_ranges(bt, lk, None, l_live)[1] > 0

    n_null = any_match(r_live & rnull) if rnull is not None \
        else torch.zeros_like(lb.sel)
    return ~has & (n_null | (probe_null & any_match(r_live)))


def _pad(a, cap):
    pad = cap - a.shape[0]
    if pad <= 0:
        return a[:cap]
    return torch.cat([a, torch.zeros(pad, dtype=a.dtype, device=a.device)])


def _nulls_or_false(c: Column):
    return c.nulls if c.nulls is not None \
        else torch.zeros(c.data.shape[0], dtype=torch.bool,
                         device=c.data.device)


def _take(b: Batch, idx):
    """b's columns (data and NULL masks) at row positions idx."""
    return [Column(c.data[idx], None if c.nulls is None else c.nulls[idx])
            for c in b.columns]


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _outer_concat(lparts, rparts, extra_l: int, extra_r: int, lb, rb, cap):
    """Columns of an outer join's output: the matched pairs (lparts,
    rparts), then, when extra_l, lb's rows NULL-padded on the right,
    then, when extra_r, rb's rows NULL-padded on the left; each column
    padded to cap."""
    dev = lb.device

    def extend(pair: Column, own: Column, tail):
        """pair, then per tail entry own's rows (None) or n NULL rows."""
        any_null = own.nulls is not None or any(t is not None for t in tail)
        parts = [pair] + [own if n is None else Column(
            torch.zeros(n, dtype=own.data.dtype, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev)) for n in tail]
        datas = [p.data for p in parts]
        nulls = [_nulls_or_false(p) for p in parts] if any_null else None
        return Column(_pad(_cat(datas), cap),
                      _pad(_cat(nulls), cap) if any_null else None)

    ltail = [None] * bool(extra_l) + [extra_r] * bool(extra_r)
    rtail = [extra_l] * bool(extra_l) + [None] * bool(extra_r)
    return [extend(p, c, ltail) for p, c in zip(lparts, lb.columns)] \
        + [extend(p, c, rtail) for p, c in zip(rparts, rb.columns)]


def _exec_nl_outer(node: L.Join, device):
    """Nested-loop OUTER join with an arbitrary predicate and no equi/
    range keys (reference: physical_nested_loop_join.cpp outer paths):
    all pairs are materialized, the predicate selects matches, and
    unmatched preserved-side rows append NULL-padded."""
    _, lb = execute(node.left, device)
    _, rb = execute(node.right, device)
    jt = node.join_type
    nl_live, nr_live = _live_counts(lb, rb)
    lb, rb = _shrink(lb, nl_live), _shrink(rb, nr_live)
    nl, nr = lb.capacity, rb.capacity
    extra_l = nl if jt in ("left", "full") else 0
    extra_r = nr if jt in ("right", "full") else 0
    cap = bucket_capacity(nl * nr + extra_l + extra_r)

    li = torch.arange(nl, device=lb.device).repeat_interleave(nr)
    ri = torch.arange(nr, device=lb.device).repeat(nl)
    lparts, rparts = _take(lb, li), _take(rb, ri)
    pair_sel = lb.sel[li] & rb.sel[ri]
    pairs = Batch(tuple(lparts + rparts), pair_sel,
                  pair_sel.sum(dtype=torch.int32))
    match = select_mask(node.extra, pairs)
    m2 = match.reshape(nl, nr)
    selparts = [match]
    if extra_l:
        selparts.append(lb.sel & ~m2.any(dim=1))
    if extra_r:
        selparts.append(rb.sel & ~m2.any(dim=0))
    sel = _pad(torch.cat(selparts), cap)
    cols = _outer_concat(lparts, rparts, extra_l, extra_r, lb, rb, cap)
    return node.schema, Batch(tuple(cols), sel, sel.sum(dtype=torch.int32))


def _probe(node: L.Join, lb: Batch, rb: Batch):
    """(BuildTable over rb, and per row of lb its (lo, cnt) range of
    sorted build slots), by the join's kind of key."""
    if node.asof:
        le, rop, re_ = node.range_cond
        ld, ln = evaluate(le, lb)
        rd, rn = evaluate(re_, rb)
        lt = sortkey._orderable(ld, le.dtype).to(torch.int64)
        rt = sortkey._orderable(rd, re_.dtype).to(torch.int64)
        if rop in ("<", "<="):
            # earliest build >= probe == latest over negated times
            lt, rt = ~lt, ~rt
        l_live = _combine_live(lb.sel, [ln])
        r_live = _combine_live(rb.sel, [rn])
        if node.conds:
            lk, l_live, rk, r_live = _equi_keys(node.conds, lb, l_live,
                                                rb, r_live)
        else:
            lk, rk = torch.zeros_like(lt), torch.zeros_like(rt)
        return join_ops.asof_probe(rk, rt, r_live, lk, lt, l_live,
                                   rop in ("<", ">"))
    if not node.conds and node.range_cond is not None:
        # sort-based range join: order-preserving key encodings
        le, rop, re_ = node.range_cond
        ld, ln = evaluate(le, lb)
        rd, rn = evaluate(re_, rb)
        lk = sortkey._orderable(ld, le.dtype).to(torch.int64)
        rk = sortkey._orderable(rd, re_.dtype).to(torch.int64)
        bt = join_ops.build(rk, None, _combine_live(rb.sel, [rn]))
        return (bt, *join_ops.range_probe(
            bt, lk, None, _combine_live(lb.sel, [ln]), rop))
    lk, l_live, rk, r_live = _equi_keys(node.conds, lb, lb.sel, rb, rb.sel)
    bt = join_ops.build(rk, None, r_live)
    return (bt, *join_ops.probe_ranges(bt, lk, None, l_live))


def _flags(targets, keep, cap: int):
    """bool[cap]: positions named by targets[keep].  Dropped targets go
    to an extra slot past the end, which is sliced off."""
    out = torch.zeros(cap + 1, dtype=torch.bool, device=targets.device)
    out[torch.where(keep, targets, cap)] = True
    return out[:cap]


def _exec_join(node: L.Join, device):
    if not node.conds and node.range_cond is None \
            and node.extra is not None \
            and node.join_type in ("left", "right", "full"):
        return _exec_nl_outer(node, device)
    _, lb = execute(node.left, device)
    _, rb = execute(node.right, device)
    jt = node.join_type

    # recompaction: when a side is very sparse (selective filters
    # upstream), shrinking it first makes the build sort, the probe and
    # the expansion gathers far cheaper (the analog of the reference's
    # dynamic radix-bit repartitioning, join_hashtable.hpp:375-428).
    # Compaction keeps row order, so it never changes a result.
    n_l_live, n_r_live = _live_counts(lb, rb)
    if (bucket_capacity(max(n_l_live, 1)) <= lb.capacity // 8
            or bucket_capacity(max(n_r_live, 1)) <= rb.capacity // 8):
        lb, rb = _shrink(lb, n_l_live), _shrink(rb, n_r_live)
    cap_l, cap_r = lb.capacity, rb.capacity
    bt, lo, cnt = _probe(node, lb, rb)

    def marked(has):
        """The semi/anti/mark output from the per-probe-row match flag."""
        if jt == "semi":
            m = lb.sel & has
            return Batch(lb.columns, m, m.sum(dtype=torch.int32))
        if jt == "anti":
            m = lb.sel & ~has
            return Batch(lb.columns, m, m.sum(dtype=torch.int32))
        mnull = _mark_nulls(node, lb, rb, has) \
            if (node.mark_in and node.conds) else None
        return Batch(lb.columns + (Column(has, mnull),), lb.sel, lb.count)

    if jt in ("semi", "anti", "mark") and node.extra is None:
        return node.schema, marked(cnt > 0)

    out_cap = bucket_capacity(max(int(join_ops.match_total(cnt)), 1))
    pi, bpos, valid = join_ops.expand(lo, cnt, out_cap)
    brow = bt.srow[bpos]
    lparts, rparts = _take(lb, pi), _take(rb, brow)
    if node.extra is not None:
        pairs = Batch(tuple(lparts + rparts), valid,
                      valid.sum(dtype=torch.int32))
        valid = select_mask(node.extra, pairs)

    if jt in ("semi", "anti", "mark"):
        # residual condition: expand matches, filter pairs, then reduce to
        # a per-probe-row matched flag (reference: ScanStructure semi/anti
        # with non-equality conditions, physical_hash_join.cpp)
        return node.schema, marked(_flags(pi, valid, cap_l))

    # inner/left/right/full: [0, out_cap) = expanded matches, then cap_l
    # left-outer slots, then cap_r right-outer slots, each validated by
    # its own mask
    ext_l = cap_l if jt in ("left", "full") else 0
    ext_r = cap_r if jt in ("right", "full") else 0
    sels = [valid]
    if ext_l:
        probe_matched = _flags(pi, valid, cap_l) \
            if node.extra is not None else cnt > 0
        sels.append(lb.sel & ~probe_matched)
    if ext_r:
        build_matched = _flags(brow, valid, cap_r) \
            if node.extra is not None \
            else join_ops.matched_build_mask(bt, lo, cnt, cap_r)
        sels.append(rb.sel & ~build_matched)
    sel = _cat(sels)
    cols = _outer_concat(lparts, rparts, ext_l, ext_r, lb, rb,
                         sel.shape[0])
    return node.schema, Batch(tuple(cols), sel, sel.sum(dtype=torch.int32))


# ---- window -----------------------------------------------------------------

def _exec_window(node: L.Window, device):
    _, b = execute(node.child, device)
    return node.schema, local_window(node, b)


def _window_spec(f, b: Batch) -> win_ops.WindowSpec:
    """The operator's spec of one window function: its evaluated
    argument and its decoded frame."""
    data = nulls = None
    kind = f.kind
    if f.arg is not None:
        data, nulls = evaluate(f.arg, b)
        if kind == "sum" and f.arg.dtype.id in (TypeId.FLOAT, TypeId.DOUBLE):
            kind = "sum_float"
    frames = {"rows_frame": None, "range_frame": None, "groups_frame": None}
    order = {}
    exclude = None
    if f.frame is not None:
        fkind, pre, post = f.frame[:3]
        exclude = f.frame[3] if len(f.frame) > 3 else None
        if fkind in ("rows", "groups"):
            frames[fkind + "_frame"] = (pre, post)
        elif (pre, post) != (None, 0) or exclude:
            # (None, 0) without EXCLUDE is the dialect's default frame
            if len(f.order) != 1:
                raise NotImplementedError(
                    "RANGE value frame needs exactly one ORDER BY key")
            ok = f.order[0]
            oval, onull = evaluate(ok.expr, b)
            order = dict(order_val=oval, order_val_nulls=onull,
                         order_desc=ok.desc,
                         order_nulls_first=not ok.nulls_last,
                         order_dtype=ok.expr.dtype)
            frames["range_frame"] = (pre, post)
    return win_ops.WindowSpec(
        kind, data, nulls, f.offset, has_order=bool(f.order),
        exclude=exclude, distinct=getattr(f, "distinct", False),
        **frames, **order)


def local_window(node: L.Window, b: Batch) -> Batch:
    """Window computation over one batch: the functions are grouped by
    their (partition, order) signature, and each group takes one sort."""
    groups = {}
    for i, f in enumerate(node.fns):
        key = (tuple(repr(p) for p in f.partition),
               tuple((repr(k.expr), k.desc, k.nulls_last) for k in f.order))
        groups.setdefault(key, []).append((i, f))

    results = [None] * len(node.fns)
    for fns in groups.values():
        f0 = fns[0][1]
        part_ops = []
        for p in f0.partition:
            d, n = evaluate(p, b)
            part_ops.extend(sortkey.encode_key(d, n, p.dtype))
        outs = win_ops.compute_windows(
            part_ops, _order_keys(f0.order, b),
            [_window_spec(f, b) for _, f in fns], b.sel)
        for (i, f), (d, n) in zip(fns, outs):
            if f.kind == "avg" and f.arg is not None \
                    and f.arg.dtype.id == TypeId.DECIMAL:
                d = d / T.decimal_scale_factor(f.arg.dtype.scale)
            results[i] = Column(d.to(torch_dtype(f.dtype.np_dtype)), n)
    return Batch(b.columns + tuple(results), b.sel, b.count)


def _concat_batches(parts, ns):
    """Concatenate batches (same column layout), preserving live rows:
    each part's live rows move to the front and are sliced to its live
    count, so the parts pack densely."""
    cap = bucket_capacity(max(sum(ns), 1))
    parts = [_shrink(p, n, always=True) for p, n in zip(parts, ns)]
    cols = []
    for ci in range(len(parts[0].columns)):
        any_null = any(p.columns[ci].nulls is not None for p in parts)
        d = torch.cat([p.columns[ci].data[:n] for p, n in zip(parts, ns)])
        nn = torch.cat([_nulls_or_false(p.columns[ci])[:n]
                        for p, n in zip(parts, ns)]) if any_null else None
        cols.append(Column(_pad(d, cap),
                           None if nn is None else _pad(nn, cap)))
    sel = _pad(torch.cat([p.sel[:n] for p, n in zip(parts, ns)]), cap)
    return Batch(tuple(cols), sel, sel.sum(dtype=torch.int32))


def _exec_union(node: L.Union, device):
    _, lb = execute(node.left, device)
    _, rb = execute(node.right, device)
    return node.schema, _concat_batches([lb, rb], _live_counts(lb, rb))


def _exec_cross(node: L.CrossProduct, device):
    _, lb = execute(node.left, device)
    _, rb = execute(node.right, device)
    nl_live, nr_live = _live_counts(lb, rb)
    lb, rb = _shrink(lb, nl_live), _shrink(rb, nr_live)
    nl, nr = lb.capacity, rb.capacity
    cap = bucket_capacity(nl * nr)
    li = torch.arange(nl, device=lb.device).repeat_interleave(nr)
    ri = torch.arange(nr, device=lb.device).repeat(nl)
    cols = [Column(_pad(c.data, cap),
                   None if c.nulls is None else _pad(c.nulls, cap))
            for c in _take(lb, li) + _take(rb, ri)]
    sel = _pad(lb.sel[li] & rb.sel[ri], cap)
    return node.schema, Batch(tuple(cols), sel, sel.sum(dtype=torch.int32))


def _exec_positional(node: L.Positional, device):
    """Row-i-pairs-row-i join, shorter side NULL-padded (reference:
    physical_positional_join.cpp)."""
    _, lb = execute(node.left, device)
    _, rb = execute(node.right, device)
    nl, nr = _live_counts(lb, rb)
    n = max(nl, nr)
    cap = bucket_capacity(max(n, 1))
    pos = torch.arange(cap, device=lb.device)
    cols = []
    for b, live in ((_shrink(lb, nl, always=True), nl),
                    (_shrink(rb, nr, always=True), nr)):
        for c in b.columns:
            cols.append(Column(_pad(c.data, cap),
                               _pad(_nulls_or_false(c), cap)
                               | (pos >= live)))
    return node.schema, Batch(tuple(cols), pos < n,
                              torch.tensor(n, dtype=torch.int32,
                                           device=lb.device))


# ---- order / limit / distinct ---------------------------------------------

def _order_keys(keys, b: Batch):
    key_ops = []
    for k in keys:
        d, n = evaluate(k.expr, b)
        key_ops.extend(sortkey.encode_key(d, n, k.expr.dtype, desc=k.desc,
                                          nulls_last=k.nulls_last))
    return key_ops


def _exec_order(node: L.Order, device):
    _, b = execute(node.child, device)
    perm = order_ops.sort_permutation(_order_keys(node.keys, b), b.sel)
    return node.schema, _gather(b, perm, b.sel[perm], b.count)


def _exec_topn(node: L.TopN, device):
    """Fused ORDER BY + LIMIT (reference: physical_top_n.cpp): sort the
    keys only, then gather limit+offset rows of every column."""
    _, b = execute(node.child, device)
    k = min(node.limit + node.offset, 1 << 14, b.capacity)
    perm = order_ops.sort_permutation(_order_keys(node.keys, b),
                                      b.sel)[:k]
    live = b.sel[perm] & (torch.arange(k, device=b.device) >= node.offset)
    return node.schema, _gather(b, perm, live, live.sum(dtype=torch.int32))


def _exec_limit(node: L.Limit, device):
    _, b = execute(node.child, device)
    if node.percent is not None:
        # LIMIT n%: floor(count * pct / 100) rows (reference:
        # physical_limit_percent.cpp)
        klim = int(np.floor(int(b.count) * node.percent / 100.0))
    else:
        klim = node.limit if node.limit is not None else 1 << 60
    m = order_ops.limit_mask(b.sel, node.offset, klim)
    return node.schema, Batch(b.columns, m, m.sum(dtype=torch.int32))


def _exec_distinct(node: L.Distinct, device):
    schema, b = execute(node.child, device)
    key_ops, key_data = [], []
    for f, c in zip(schema.fields, b.columns):
        key_ops.extend(sortkey.encode_key(c.data, c.nulls, f.dtype))
        key_data.append((c.data, c.nulls))
    group_cols, _, gsel, ng = agg_ops.group_and_aggregate(
        key_ops, key_data, [], b.sel, b.capacity)
    return node.schema, Batch(tuple(Column(d, n) for d, n in group_cols),
                              gsel, ng)


_EXEC = {
    L.Get: _exec_get,
    L.Filter: _exec_filter,
    L.Project: _exec_project,
    L.Aggregate: _exec_aggregate,
    L.Window: _exec_window,
    L.Join: _exec_join,
    L.CrossProduct: _exec_cross,
    L.Positional: _exec_positional,
    L.Union: _exec_union,
    L.Order: _exec_order,
    L.TopN: _exec_topn,
    L.Limit: _exec_limit,
    L.Distinct: _exec_distinct,
}

"""Physical execution of bound logical plans (PyTorch port of
ddb_tpu/plan/physical.py): scan, filter, project, aggregate (plain,
DISTINCT and holistic), window, joins (equi, range, asof, nested-loop
outer, cross product, positional), UNION ALL, order, top-N, limit and
distinct, sample, unnest, materialized and recursive CTEs, and the
aggregates of variable size, which run on the host.

Execution is eager: each operator runs its torch ops on the device the
caller names and returns a concrete Batch.  (The reference package
defers operators into a fusion DAG that XLA compiles per pipeline; that
DAG is not ported.)  Where the reference fetches live counts and match
totals to the host in one transfer per pipeline breaker, this executor
reads them with `.tolist()`/`int()` where it needs them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import (Batch, Column, Schema, bucket_capacity,
                     current_bind_device, make_batch, to_numpy,
                     torch_dtype)
from ..expr import ir
from ..expr.compile import evaluate, evaluate_const, select_mask
from ..ops import aggregate as agg_ops
from ..ops import join as join_ops
from ..ops import order as order_ops
from ..ops import sketch, sortkey
from ..ops import window as win_ops
from ..spans import span
from ..types import TypeId
from . import bounds as B
from . import logical as L


class ExecContext:
    """What one query's execution carries: the device every batch lives
    on, the batches of the CTEs materialized so far, and the profiler
    and progress hooks (the reference's ExecutionContext).  The memo
    lives for one query; kept on the plan node it would hold a batch in
    the plan cache."""

    def __init__(self, device, profiler=None, progress=None):
        self.device = torch.device(device)
        self.memo = {}
        self.profiler = profiler      # profiler.QueryProfiler
        self.progress = progress      # callable(done_nodes, total_nodes)
        self._total_nodes = 0
        self._done_nodes = 0

    def _report(self):
        if self.progress is not None and self._total_nodes:
            self.progress(self._done_nodes, self._total_nodes)


def _count_nodes(node: L.LogicalNode) -> int:
    return 1 + sum(_count_nodes(c) for c in node.children())


def execute(node: L.LogicalNode, device=None, ctx: ExecContext = None
            ) -> Tuple[Schema, Batch]:
    """Run a bound, optimized plan; every batch lives on `device`, or on
    the device of `ctx` when the caller hands one in (to profile the
    operators or report progress).

    Without either the call comes from the binder, which folds an
    uncorrelated subquery or a recursive CTE over growing dictionaries
    while it binds: the plan runs on the device of the statement being
    bound (`batch.bind_device`) and the result is handed back on the
    host, where the binder reads it.  Outside `bind_device` such a call
    raises: no device is assumed."""
    if ctx is not None:
        return _run(node, ctx)
    if device is not None:
        return _run(node, ExecContext(device))
    schema, b = _run(node, ExecContext(current_bind_device()))
    return schema, _to_device(b, torch.device("cpu"))


def _run(node: L.LogicalNode, ctx: ExecContext) -> Tuple[Schema, Batch]:
    if ctx.progress is not None:
        ctx._total_nodes = _count_nodes(node)
        ctx._done_nodes = 0
    schema, b = _execute(node, ctx)
    if ctx.progress is not None:
        ctx._done_nodes = ctx._total_nodes
        ctx._report()
    return schema, b


def _execute(node: L.LogicalNode, ctx: ExecContext) -> Tuple[Schema, Batch]:
    fn = _EXEC.get(type(node))
    if fn is None:
        raise NotImplementedError(
            f"{type(node).__name__} has no executor in this package")
    name = type(node).__name__
    # one span an operator, around the profiler's and the progress hooks
    with span("ddb.exec." + name):
        if ctx.progress is not None:
            schema, b = fn(node, ctx)
            ctx._done_nodes += 1
            ctx._report()
            return schema, b
        if ctx.profiler is not None:
            # the live count's read (a host synchronisation on the card)
            # is inside the timed window, so an operator's time is its
            # device work, not the host's launches.  It is recorded after
            # the window closes: the operator's profile exists only then
            # (the reference records inside, where every cardinality
            # stays -1)
            with ctx.profiler.operator(name, node):
                schema, b = fn(node, ctx)
                int(b.count)
            ctx.profiler.record_cardinality(node, b)
            return schema, b
        return fn(node, ctx)


def _to_device(b: Batch, device) -> Batch:
    def mv(t):
        return None if t is None else t.to(device)
    return Batch(tuple(Column(mv(c.data), mv(c.nulls), mv(c.hi))
                       for c in b.columns), mv(b.sel), mv(b.count))


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


def _index_scan_rows(node: L.Get):
    """Row ids from a point-lookup index when the scan filters pin an
    index's key columns with constants and the match is selective (the
    reference: table_scan.cpp TryScanIndex).  None means a full scan.
    The constants fold on the host, as the binder folds them."""
    td = node.table
    if not td.indexes or not node.filters:
        return None
    eqs, los, his = {}, {}, {}
    indexed_cols = {c.lower() for ix in td.indexes.values()
                    for c in ix.columns}
    for f in node.filters:
        if not (isinstance(f, ir.Cmp) and isinstance(f.left, ir.ColRef)
                and not ir.referenced_columns(f.right)):
            continue
        try:
            col = td.columns[node.column_indices[f.left.index]]
        except (IndexError, TypeError):
            return None
        cname = col.name.lower()
        if cname not in indexed_cols:
            continue
        try:
            d, nmask = evaluate_const(f.right)
            if nmask is not None and bool(nmask[0]):
                continue
            v = d.numpy()[0].astype(col.data.dtype)
        except Exception:
            continue
        if f.op == "==":
            eqs[cname] = v
        elif f.op in ("<", "<="):
            his[cname] = (v, f.op == "<")
        elif f.op in (">", ">="):
            los[cname] = (v, f.op == ">")
    for ix in td.indexes.values():
        cols = [c.lower() for c in ix.columns]
        rows = None
        if cols and all(c in eqs for c in cols):
            rows = ix.lookup_eq(td, [eqs[c] for c in cols])
        elif len(cols) == 1 and (cols[0] in los or cols[0] in his):
            lo = los.get(cols[0])
            hi = his.get(cols[0])
            rows = ix.lookup_range(
                td, lo[0] if lo else None, hi[0] if hi else None,
                lo_strict=bool(lo and lo[1]),
                hi_strict=bool(hi and hi[1]))
        if rows is None:
            continue
        # selective enough to beat the full-column device pass?
        if len(rows) * 4 <= td.num_rows or len(rows) <= 4096:
            return np.sort(rows)
    return None


def _exec_get(node: L.Get, ctx):
    rows = _index_scan_rows(node)
    gids = None if rows is not None else _zone_map_groups(node)
    if rows is not None:
        # the filters below still apply: the index pre-selects, the mask
        # keeps exactness (other conjuncts, boundary semantics)
        batch = node.table.device_batch_rows(node.column_indices, rows,
                                             device=ctx.device)
    elif gids is not None:
        batch = node.table.device_batch_groups(node.column_indices, gids,
                                               device=ctx.device)
    else:
        batch = node.table.device_batch(node.column_indices,
                                        device=ctx.device)
    if node.filters:
        batch = _filtered(batch, ir.make_and(node.filters))
    return node.schema, batch


def _exec_filter(node: L.Filter, ctx):
    _, b = _execute(node.child, ctx)
    return node.schema, _filtered(b, node.predicate)


def _exec_project(node: L.Project, ctx):
    _, b = _execute(node.child, ctx)
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
# kinds whose results are of variable size, or that call back into
# Python: computed on the host over fetched rows (_exec_aggregate_host)
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
            if isinstance(a.arg, ir.ColRef):
                # a wide column's own high limb (a partial sum merged by
                # plan/tiled.py), where the reference reads the low word
                d2 = b.columns[a.arg.index].hi
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


def scalar_batch(node: L.Aggregate, res, dev) -> Batch:
    """An ungrouped aggregate's (value, isnull) per aggregate as one live
    row in a 128-slot batch, as the reference package returns it."""
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
    return Batch(tuple(cols), sel,
                 torch.tensor(1, dtype=torch.int32, device=dev))


def _exec_aggregate(node: L.Aggregate, ctx):
    if any(a.kind in _HOST_AGG_KINDS for a in node.aggs):
        return _exec_aggregate_host(node, ctx)
    _, b = _execute(node.child, ctx)
    dev = b.device

    if not node.groups:
        res = [_ungrouped_special(a, p, b) if _is_special(a)
               else agg_ops.ungrouped_aggregate([p], b.sel)[0]
               for a, p in zip(node.aggs, _payloads(node, b))]
        return node.schema, scalar_batch(node, res, dev)

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


# ---- unnest (host expansion) ------------------------------------------------

def _exec_unnest(node: "L.Unnest", ctx):
    """Expand a LIST column into rows (reference: physical_unnest.cpp).
    List payloads live on the host (there is no variable-length device
    representation), so unnest fetches the child's live rows and uploads
    the expanded batch."""
    from ..storage.strings import StringDictionary
    cschema, b = _execute(node.child, ctx)
    datas = [_fetch_column(c, b.sel) for c in b.columns]
    store = cschema.fields[node.index].strdict
    ids, idn = datas[node.index]
    nlists = len(store)
    lens = store.lengths() if nlists else np.zeros(0, np.int64)
    reps = np.zeros(len(ids), dtype=np.int64)
    valid = (ids >= 0) & (ids < nlists)
    if idn is not None:
        valid &= ~idn
    reps[valid] = lens[ids[valid].astype(np.int64)]
    total = int(reps.sum())
    elems = []
    for i in np.nonzero(reps)[0]:
        elems.extend(store.items[int(ids[i])])
    et = node.schema.fields[node.index].dtype
    if et.id == TypeId.VARCHAR:
        sd = node.schema.fields[node.index].strdict
        newd, codes, en = StringDictionary.encode(elems)
        sd.values = newd.values
        sd._lookup = None
        ed, enul = codes, (en if en.any() else None)
    else:
        enul = np.array([v is None for v in elems], dtype=bool)
        ed = np.array([T.encode_literal(v, et) if v is not None else 0
                       for v in elems], dtype=et.np_dtype)
        enul = enul if enul.any() else None
    arrays, nulls = [], []
    for j, (d, n) in enumerate(datas):
        if j == node.index:
            arrays.append(ed)
            nulls.append(enul)
        else:
            arrays.append(np.repeat(d, reps))
            nulls.append(np.repeat(n, reps) if n is not None else None)
    if total == 0:
        arrays = [np.zeros(0, dtype=a.dtype) for a in arrays]
        nulls = [None] * len(arrays)
    return node.schema, make_batch(arrays, nulls, total, device=ctx.device)


# ---- host aggregation for var-size results (list / string_agg) -------------

# live rows the host aggregates have pulled off the device
HOST_AGG_STATS = {"rows_fetched": 0}


def _fetch_column(c: Column, sel):
    """(values, NULL mask or None) of the live rows of a column, on the
    host, in row order.  The live rows are picked on the device, so only
    they cross to the host.  A wide (two-limb) column comes recombined,
    as Python ints."""
    d = to_numpy(c.data[sel])
    if c.hi is not None:
        d = to_numpy(c.hi[sel]).astype(object) * (1 << 32) \
            + (d & np.int64(0xFFFFFFFF)).astype(object)
    return d, (None if c.nulls is None else to_numpy(c.nulls[sel]))


def _string_agg_vectorized(a, ds, ns, starts, ends, ngroups, aorder,
                           nrows):
    """Vectorized string_agg finalize: decode every value once, build
    ONE global joined string with separators, then slice per group by
    cumulative character offsets — host work is bounded to final string
    slicing, no per-group Python value loop (reference: vectorized
    nested aggregates, extension/core_functions/aggregate/nested/).
    Returns (res, rn) or None when the shape needs the generic loop."""
    if a.kind != "string_agg" or a.distinct or aorder is not None \
            or nrows == 0:
        return None
    sd = getattr(a.arg, "strdict", None)
    tid = a.arg.dtype.id
    if sd is not None:
        vals = np.asarray(sd.values, dtype=object)[ds].astype(str)
    elif a.arg.dtype.is_integer:
        vals = ds.astype(np.int64).astype(str)
    elif tid == TypeId.DATE:
        vals = ds.astype("datetime64[D]").astype(str)
    elif tid == TypeId.BOOLEAN:
        vals = np.where(ds.astype(bool), "True", "False")
    else:
        return None        # floats/decimals: repr fidelity via the loop
    sep = a.extra
    live = ~ns if ns is not None else np.ones(nrows, dtype=bool)
    gid = np.zeros(nrows, dtype=np.int64)
    gid[starts[1:]] = 1
    gid = np.cumsum(gid)
    sv = vals[live]
    g2 = gid[live]
    res = [""] * ngroups
    rn = [True] * ngroups
    if len(sv) == 0:
        return res, rn
    is_first = np.ones(len(sv), dtype=bool)
    is_first[1:] = g2[1:] != g2[:-1]
    lens = np.char.str_len(sv)
    parts = np.where(is_first, sv, np.char.add(sep, sv))
    big = "".join(parts.tolist())
    plens = lens + np.where(is_first, 0, len(sep))
    cend = np.cumsum(plens)
    first_idx = np.nonzero(is_first)[0]
    cstart = cend[first_idx] - plens[first_idx]
    last = np.append(first_idx[1:] - 1, len(sv) - 1)
    gids = g2[first_idx]
    for j in range(len(first_idx)):
        res[gids[j]] = big[cstart[j]:cend[last[j]]]
        rn[gids[j]] = False
    return res, rn


def _decode_host(vals, nulls, dtype, sd):
    out = []
    for i, v in enumerate(vals):
        if nulls is not None and nulls[i]:
            out.append(None)
        elif sd is not None:
            out.append(sd.decode_one(int(v)))
        else:
            out.append(T.decode_value(v, dtype))
    return out


def _exec_aggregate_host(node: L.Aggregate, ctx):
    """Aggregation with variable-size results (list()/string_agg) runs on
    host: sorted groupby over fetched arrays, python-list payloads into
    the specs' stores (reference: nested aggregates in
    extension/core_functions/aggregate/nested/list.cpp)."""
    from ..storage.strings import StringDictionary
    cschema, b = _execute(node.child, ctx)

    def fetch(e):
        if isinstance(e, ir.ColRef):     # keeps a wide column's high limb
            return _fetch_column(b.columns[e.index], b.sel)
        return _fetch_column(Column(*evaluate(e, b)), b.sel)

    G = [fetch(g) for g in node.groups]
    AV = [(None, None) if a.arg is None else fetch(a.arg)
          for a in node.aggs]
    nrows = int(b.count)
    HOST_AGG_STATS["rows_fetched"] += nrows

    if node.groups:
        seq = []
        for (d, n) in reversed(G):
            seq.append(d)
            seq.append(n if n is not None
                       else np.zeros(len(d), dtype=bool))
        order = np.lexsort(tuple(seq))
        bounds = np.zeros(nrows, dtype=bool)
        if nrows:
            bounds[0] = True
            for (d, n) in G:
                ds = d[order]
                bounds[1:] |= ds[1:] != ds[:-1]
                if n is not None:
                    ns = n[order]
                    bounds[1:] |= ns[1:] != ns[:-1]
        starts = np.nonzero(bounds)[0]
        ends = np.append(starts[1:], nrows)
    else:
        order = np.arange(nrows)
        starts = np.array([0])
        ends = np.array([nrows])
    ngroups = len(starts)

    arrays, nulls_out = [], []
    for (d, n) in G:
        arrays.append(d[order][starts])
        nulls_out.append(n[order][starts] if n is not None else None)

    for a, (d, n) in zip(node.aggs, AV):
        ds = d[order] if d is not None else None
        ns = n[order] if n is not None else None
        aorder = None
        if getattr(a, "order_by", None):
            # agg(x ORDER BY ...): per-group reorder by the modifier's
            # keys (reference: ORDER_MODIFIER on bound aggregate
            # expressions, bound_aggregate_expression.hpp)
            seq = []
            for (oe, desc, nl) in reversed(a.order_by):
                kd, kn = fetch(oe)
                kd = kd[order]
                kn = kn[order] if kn is not None \
                    else np.zeros(len(kd), dtype=bool)
                if kd.dtype == bool:
                    kd = kd.astype(np.int8)
                seq.append(-kd if desc else kd)
                seq.append(kn.astype(np.int8) if nl
                           else (~kn).astype(np.int8))
            aorder = seq
        fast = _string_agg_vectorized(a, ds, ns, starts, ends,
                                      ngroups, aorder, nrows)
        if fast is not None:
            res, rn = fast
        else:
            res, rn = [], []
        for s, e in (() if fast is not None else zip(starts, ends)):
            if a.kind == "count_star":
                res.append(e - s)
                rn.append(False)
                continue
            if aorder is not None and e > s:
                loc = np.lexsort(tuple(k[s:e] for k in aorder))
                dd = ds[s:e][loc]
                live = ~ns[s:e][loc] if ns is not None \
                    else np.ones(e - s, dtype=bool)
                dd = dd[live]
                if a.kind == "count":
                    res.append(len(dd))
                    rn.append(False)
                    continue
                if a.kind in ("collect", "string_agg"):
                    sd = getattr(a.arg, "strdict", None)
                    vals = _decode_host(dd, None, a.arg.dtype, sd)
                    if a.distinct:
                        seen, uniq = set(), []
                        for v in vals:
                            if v not in seen:
                                seen.add(v)
                                uniq.append(v)
                        vals = uniq
                    if a.kind == "collect":
                        res.append(vals)
                        rn.append(False)
                    else:
                        res.append(a.extra.join(str(v) for v in vals))
                        rn.append(len(vals) == 0)
                    continue
            dd = ds[s:e]
            live = ~ns[s:e] if ns is not None else np.ones(e - s,
                                                           dtype=bool)
            dd = dd[live]
            if a.kind == "count":
                res.append(len(dd))
                rn.append(False)
                continue
            if a.kind in ("collect", "string_agg", "histogram",
                          "approx_top_k"):
                sd = getattr(a.arg, "strdict", None)
                vals = _decode_host(dd, None, a.arg.dtype, sd)
                if a.kind == "histogram":
                    # MAP<value, count>, keys ascending (reference:
                    # core_functions/aggregate/holistic/histogram.cpp)
                    from collections import Counter
                    extra = getattr(a, "extra", None)
                    if isinstance(extra, tuple) and extra[0] in (
                            "bins", "exact"):
                        mode_, bounds = extra
                        if mode_ == "exact":
                            c = Counter(v for v in vals
                                        if v in set(bounds))
                            res.append([(b, c.get(b, 0))
                                        for b in bounds])
                        else:
                            sb = sorted(bounds)
                            counts = {b: 0 for b in sb}
                            over = 0
                            for v in vals:
                                for b in sb:
                                    if v <= b:
                                        counts[b] += 1
                                        break
                                else:
                                    over += 1
                            items = [(b, counts[b]) for b in sb]
                            if over:
                                items.append((2**63 - 1, over))
                            res.append(items)
                        rn.append(False)
                        continue
                    c = Counter(vals)
                    res.append(sorted(c.items()))
                    rn.append(len(c) == 0)
                    continue
                if a.kind == "approx_top_k":
                    from collections import Counter
                    c = Counter(vals)
                    top = sorted(c.items(), key=lambda kv: (-kv[1],))
                    res.append([k for k, _n in top[:a.extra]])
                    rn.append(len(c) == 0)
                    continue
                if a.distinct:
                    seen, uniq = set(), []
                    for v in vals:
                        if v not in seen:
                            seen.add(v)
                            uniq.append(v)
                    vals = uniq
                if a.kind == "collect":
                    res.append(vals)
                    rn.append(False)
                else:
                    res.append(a.extra.join(str(v) for v in vals))
                    rn.append(len(vals) == 0)
                continue
            if a.kind == "udaf":
                # user aggregate: row-wise init/update/finalize
                # callbacks over decoded Python values (reference:
                # duckdb_create_aggregate_function,
                # src/main/capi/aggregate_function-c.cpp)
                init, update, finalize = a.extra
                sd2 = getattr(a.arg, "strdict", None)
                vals = _decode_host(dd, None, a.arg.dtype, sd2)
                if a.distinct:
                    seen, uniq = set(), []
                    for v in vals:
                        if v not in seen:
                            seen.add(v)
                            uniq.append(v)
                    vals = uniq
                st = init()
                for v in vals:
                    update(st, v)
                r = finalize(st)
                res.append(r)
                rn.append(r is None)
                continue
            if len(dd) == 0:
                res.append(0)
                rn.append(True)
                continue
            rn.append(False)
            if a.kind in ("sum", "sum_float"):
                res.append(dd.sum())
            elif a.kind == "avg":
                res.append(float(dd.astype(np.float64).mean()))
            elif a.kind == "min":
                res.append(dd.min())
            elif a.kind == "max":
                res.append(dd.max())
            elif a.kind == "any_value":
                res.append(dd[0])
            elif a.kind == "mad":
                # median absolute deviation (reference:
                # core_functions/aggregate/holistic/mad.cpp)
                med = np.median(dd.astype(np.float64))
                res.append(float(np.median(
                    np.abs(dd.astype(np.float64) - med))))
            else:
                raise NotImplementedError(
                    f"{a.kind} cannot combine with list aggregates yet")
        if a.kind in ("collect", "approx_top_k"):
            a.store.replace_all([r if not isnull else []
                                 for r, isnull in zip(res, rn)])
            arrays.append(np.arange(ngroups, dtype=np.int32))
            nulls_out.append(np.array(rn) if any(rn) else None)
        elif a.kind == "histogram":
            for r, isnull in zip(res, rn):
                a.store.add(r if not isnull else [])
            arrays.append(np.arange(ngroups, dtype=np.int32))
            nulls_out.append(np.array(rn) if any(rn) else None)
        elif a.kind == "string_agg":
            newd, codes, _ = StringDictionary.encode(
                [r if not isnull else "" for r, isnull in zip(res, rn)])
            a.store.values = newd.values
            a.store._lookup = None
            arrays.append(codes)
            nulls_out.append(np.array(rn) if any(rn) else None)
        elif a.kind == "udaf":
            if a.dtype.id == TypeId.VARCHAR:
                newd, codes, _ = StringDictionary.encode(
                    ["" if isnull else str(r)
                     for r, isnull in zip(res, rn)])
                a.store.values = newd.values
                a.store._lookup = None
                arrays.append(codes)
            else:
                want = np.dtype(a.dtype.np_dtype)
                vals2 = [0 if isnull else r
                         for r, isnull in zip(res, rn)]
                if a.dtype.id == TypeId.DECIMAL:
                    vals2 = [int(round(float(v)
                                       * 10 ** a.dtype.scale))
                             for v in vals2]
                arrays.append(np.array(vals2).astype(want))
            nulls_out.append(np.array(rn) if any(rn) else None)
        elif a.kind == "avg":
            arrays.append(np.array(res, dtype=np.float64))
            nulls_out.append(np.array(rn) if any(rn) else None)
        else:
            want = np.dtype(a.dtype.np_dtype)
            arrays.append(np.array(res).astype(want))
            nulls_out.append(np.array(rn) if any(rn) else None)

    return node.schema, make_batch(arrays, nulls_out, ngroups,
                                   device=ctx.device)


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


def _exec_nl_outer(node: L.Join, ctx):
    """Nested-loop OUTER join with an arbitrary predicate and no equi/
    range keys (reference: physical_nested_loop_join.cpp outer paths):
    all pairs are materialized, the predicate selects matches, and
    unmatched preserved-side rows append NULL-padded."""
    _, lb = _execute(node.left, ctx)
    _, rb = _execute(node.right, ctx)
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


def _exec_join(node: L.Join, ctx):
    if not node.conds and node.range_cond is None \
            and node.extra is not None \
            and node.join_type in ("left", "right", "full"):
        return _exec_nl_outer(node, ctx)
    _, lb = _execute(node.left, ctx)
    _, rb = _execute(node.right, ctx)
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

def _exec_window(node: L.Window, ctx):
    _, b = _execute(node.child, ctx)
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


def _high_limb(c: Column):
    """A column's high limb (the value shifted right by 32): its own when
    it is wide, else the one its int64 values have."""
    return c.hi if c.hi is not None else c.data.to(torch.int64) >> 32


def _wide_key(c: Column):
    """Sort-key words of a wide column's high limb, none for a narrow
    column: with the low word's they tell two wide values apart."""
    if c.hi is None:
        return []
    return sortkey.encode_key(c.hi, c.nulls, T.BIGINT)


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
        hi = None
        if any(p.columns[ci].hi is not None for p in parts):
            hi = _pad(torch.cat([_high_limb(p.columns[ci])[:n]
                                 for p, n in zip(parts, ns)]), cap)
        cols.append(Column(_pad(d, cap),
                           None if nn is None else _pad(nn, cap), hi))
    sel = _pad(torch.cat([p.sel[:n] for p, n in zip(parts, ns)]), cap)
    return Batch(tuple(cols), sel, sel.sum(dtype=torch.int32))


def _exec_union(node: L.Union, ctx):
    _, lb = _execute(node.left, ctx)
    _, rb = _execute(node.right, ctx)
    return node.schema, _concat_batches([lb, rb], _live_counts(lb, rb))


def _exec_cross(node: L.CrossProduct, ctx):
    _, lb = _execute(node.left, ctx)
    _, rb = _execute(node.right, ctx)
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


def _exec_positional(node: L.Positional, ctx):
    """Row-i-pairs-row-i join, shorter side NULL-padded (reference:
    physical_positional_join.cpp)."""
    _, lb = _execute(node.left, ctx)
    _, rb = _execute(node.right, ctx)
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


# ---- sample -----------------------------------------------------------------

def _exec_sample(node: L.Sample, ctx):
    """USING SAMPLE: `percent` keeps each live row with probability
    amount/100; `rows` ranks the live rows by a random draw and keeps
    the first `amount`.  The draws come from a generator on the batch's
    device seeded with node.seed: the same seed gives the same rows on
    one device (the CPU's and the card's streams differ)."""
    _, b = _execute(node.child, ctx)
    g = torch.Generator(device=b.device)
    g.manual_seed(int(node.seed))
    u = torch.rand(b.capacity, dtype=torch.float64, generator=g,
                   device=b.device)
    if node.method == "percent":
        m = b.sel & (u < node.amount / 100.0)
    else:
        # dead rows draw 2.0 and rank after every live row
        first = torch.argsort(torch.where(b.sel, u, 2.0),
                              stable=True)[:int(node.amount)]
        m = torch.zeros_like(b.sel)
        m[first] = True
        m &= b.sel
    return node.schema, Batch(b.columns, m, m.sum(dtype=torch.int32))


# ---- CTEs -------------------------------------------------------------------

_MAX_RECURSION = 100000


def _exec_materialize(node: L.Materialize, ctx):
    """Shared CTE barrier: the child runs once a query, and every site
    that references it takes the same batch (reference: materialized CTE
    execution, operator/set/physical_cte.cpp)."""
    hit = ctx.memo.get(id(node))
    if hit is None:
        _, b = _execute(node.child, ctx)
        hit = ctx.memo[id(node)] = (node.schema, b)
    return hit


def _exec_cte_ref(node: L.CTERef, ctx):
    if node.cell is None or node.cell.batch is None:
        raise RuntimeError(f"recursive CTE ref {node.name} outside its "
                           "fixpoint loop")
    return node.schema, node.cell.batch


def _new_rows(schema: Schema, acc: Batch, res: Batch) -> Batch:
    """Rows of `res` that are not in `acc`, de-duplicated, in key order
    (UNION recursion step; reference: physical_recursive_cte.cpp
    ProbeHT).  Both are sorted together by (all columns, acc before
    res): a res row is new iff it is the first of its key group."""
    na = acc.capacity
    both = _concat_cols(acc, res)
    live = torch.cat([acc.sel, res.sel])
    key_ops = []
    for f, c in zip(schema.fields, both):
        key_ops.extend(sortkey.encode_key(c.data, c.nulls, f.dtype))
        key_ops.extend(_wide_key(c))
    from_res = torch.arange(live.shape[0], device=live.device) >= na
    perm = order_ops.sort_permutation(key_ops + [from_res.to(torch.int32)],
                                      live)
    first = torch.zeros_like(live)
    first[:1] = True
    for k in key_ops:
        ks = k[perm]
        first[1:] |= ks[1:] != ks[:-1]
    new = first & from_res[perm] & live[perm]
    return _gather(Batch(tuple(both), live, None), perm, new,
                   new.sum(dtype=torch.int32))


def _concat_cols(a: Batch, b: Batch):
    """Columns of a's slots followed by b's (same layout)."""
    cols = []
    for ca, cb in zip(a.columns, b.columns):
        nn = None
        if ca.nulls is not None or cb.nulls is not None:
            nn = torch.cat([_nulls_or_false(ca), _nulls_or_false(cb)])
        hi = None
        if ca.hi is not None or cb.hi is not None:
            hi = torch.cat([_high_limb(ca), _high_limb(cb)])
        cols.append(Column(torch.cat([ca.data, cb.data]), nn, hi))
    return cols


def _exec_recursive_cte(node: L.RecursiveCTE, ctx):
    """WITH RECURSIVE: the recursive term runs against the rows the last
    round produced until a round produces none.  UNION ALL keeps every
    round's rows; UNION keeps the rows not seen before.  Each round reads
    one count on the host."""
    schema = node.schema
    _, base = _execute(node.base, ctx)
    if not node.union_all:
        base = _distinct_rows(schema, base)
    n = int(base.count)
    base = _shrink(base, n, always=True)
    parts, ns = [base], [n]
    acc, n_acc, working = base, n, base
    it = 0
    try:
        while n > 0:
            it += 1
            if it > _MAX_RECURSION:
                raise RuntimeError("recursive CTE exceeded max iteration "
                                   f"count ({_MAX_RECURSION})")
            node.cell.batch = working
            _, res = _execute(node.recursive, ctx)
            if not node.union_all:
                res = _new_rows(schema, acc, res)
            n = int(res.count)
            if n == 0:
                break
            working = _shrink(res, n, always=True)
            parts.append(working)
            ns.append(n)
            if not node.union_all:
                acc = _concat_batches([acc, working], [n_acc, n])
                n_acc += n
    finally:
        node.cell.batch = None
    return schema, _concat_batches(parts, ns)


# ---- order / limit / distinct ---------------------------------------------

def _order_keys(keys, b: Batch):
    """Sort words of the ORDER BY keys.  A key that is a wide (two-limb)
    column sorts by its high limb, then by its low 32 bits as an unsigned
    number; the reference sorts it by the low word alone."""
    key_ops = []
    for k in keys:
        d, n = evaluate(k.expr, b)
        hi = b.columns[k.expr.index].hi \
            if isinstance(k.expr, ir.ColRef) else None
        if hi is not None:
            key_ops.extend(sortkey.encode_key(hi, n, T.BIGINT, desc=k.desc,
                                              nulls_last=k.nulls_last))
            d = d.to(torch.int64) & 0xFFFFFFFF
            if n is not None:
                # the high word's operands place the NULLs; their low
                # words tie
                d, n = torch.where(n, 0, d), None
        key_ops.extend(sortkey.encode_key(d, n, k.expr.dtype, desc=k.desc,
                                          nulls_last=k.nulls_last))
    return key_ops


def _exec_order(node: L.Order, ctx):
    _, b = _execute(node.child, ctx)
    perm = order_ops.sort_permutation(_order_keys(node.keys, b), b.sel)
    return node.schema, _gather(b, perm, b.sel[perm], b.count)


def _exec_topn(node: L.TopN, ctx):
    """Fused ORDER BY + LIMIT (reference: physical_top_n.cpp): sort the
    keys only, then gather limit+offset rows of every column."""
    _, b = _execute(node.child, ctx)
    k = min(node.limit + node.offset, 1 << 14, b.capacity)
    perm = order_ops.sort_permutation(_order_keys(node.keys, b),
                                      b.sel)[:k]
    live = b.sel[perm] & (torch.arange(k, device=b.device) >= node.offset)
    return node.schema, _gather(b, perm, live, live.sum(dtype=torch.int32))


def _exec_limit(node: L.Limit, ctx):
    _, b = _execute(node.child, ctx)
    if node.percent is not None:
        # LIMIT n%: floor(count * pct / 100) rows (reference:
        # physical_limit_percent.cpp)
        klim = int(np.floor(int(b.count) * node.percent / 100.0))
    else:
        klim = node.limit if node.limit is not None else 1 << 60
    m = order_ops.limit_mask(b.sel, node.offset, klim)
    return node.schema, Batch(b.columns, m, m.sum(dtype=torch.int32))


def _exec_distinct(node: L.Distinct, ctx):
    schema, b = _execute(node.child, ctx)
    return node.schema, _distinct_rows(schema, b)


def _distinct_rows(schema: Schema, b: Batch) -> Batch:
    """b's distinct live rows, in key order.  A wide column's high limb
    is one more key, handed back as the column's limb."""
    key_ops, key_data = [], []
    for f, c in zip(schema.fields, b.columns):
        key_ops.extend(sortkey.encode_key(c.data, c.nulls, f.dtype))
        key_data.append((c.data, c.nulls))
    wide = [i for i, c in enumerate(b.columns) if c.hi is not None]
    for i in wide:
        key_ops.extend(_wide_key(b.columns[i]))
        key_data.append((b.columns[i].hi, b.columns[i].nulls))
    group_cols, _, gsel, ng = agg_ops.group_and_aggregate(
        key_ops, key_data, [], b.sel, b.capacity)
    n = len(b.columns)
    hi_of = {i: group_cols[n + j][0] for j, i in enumerate(wide)}
    return Batch(tuple(Column(d, nn, hi_of.get(i))
                       for i, (d, nn) in enumerate(group_cols[:n])),
                 gsel, ng)


class ConstBatch(L.LogicalNode):
    """Pre-materialized batch as a leaf plan node (the out-of-core paths
    of plan/tiled.py splice a joined or gathered result into a sub-plan
    with it).  The batch lies on the device the plan runs on."""

    def __init__(self, schema, batch):
        self.schema = schema
        self.batch = batch

    def children(self):
        return []


_EXEC = {
    ConstBatch: lambda n, c: (n.schema, n.batch),
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
    L.Unnest: _exec_unnest,
    L.Sample: _exec_sample,
    L.Materialize: _exec_materialize,
    L.CTERef: _exec_cte_ref,
    L.RecursiveCTE: _exec_recursive_cte,
}

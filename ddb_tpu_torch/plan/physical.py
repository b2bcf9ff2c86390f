"""Physical execution of bound logical plans (PyTorch port of
ddb_tpu/plan/physical.py), for single-table plans: scan, filter, project,
aggregate, order, top-N, limit and distinct.

Execution is eager: each operator runs its torch ops on the device the
caller names and returns a concrete Batch.  (The reference package
defers operators into a fusion DAG that XLA compiles per pipeline; that
DAG is not ported.)  Joins, windows, unions, samples, CTEs and unnest
raise NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import Batch, Column, Schema, torch_dtype
from ..expr import ir
from ..expr.compile import evaluate, select_mask
from ..ops import aggregate as agg_ops
from ..ops import order as order_ops
from ..ops import sortkey
from ..types import TypeId
from . import bounds as B
from . import logical as L


def execute(node: L.LogicalNode, device: torch.device
            ) -> Tuple[Schema, Batch]:
    """Run a bound, optimized plan; every batch lives on `device`."""
    fn = _EXEC.get(type(node))
    if fn is None:
        raise NotImplementedError(
            f"{type(node).__name__} is outside the ported single-table "
            "slice")
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
# kinds whose reference implementation lives in ops/aggregate.py's
# holistic section or on the host; not part of this slice
_UNPORTED_KINDS = ("quantile", "mode", "arg_min", "arg_max", "entropy",
                   "approx_count_distinct", "collect", "string_agg",
                   "histogram", "approx_top_k", "mad", "udaf")


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
    if a.kind == "avg" and a.arg is not None \
            and a.arg.dtype.id == TypeId.DECIMAL:
        # integer sum was in fixed-point: scale back to a true double
        d = d / T.decimal_scale_factor(a.arg.dtype.scale)
    return Column(d.to(torch_dtype(a.dtype.np_dtype)), n)


def _agg_output(node: L.Aggregate, group_cols, agg_results, gsel,
                ngroups) -> Batch:
    cols = [Column(d, n) for d, n in group_cols]
    cols += [_agg_column(a, d, n) for a, (d, n) in zip(node.aggs,
                                                         agg_results)]
    return Batch(tuple(cols), gsel, ngroups)


def _exec_aggregate(node: L.Aggregate, device):
    for a in node.aggs:
        if a.kind in _UNPORTED_KINDS or (a.distinct
                                         and a.kind != "count_star"):
            raise NotImplementedError(
                f"aggregate {'DISTINCT ' if a.distinct else ''}{a.kind}")
    _, b = execute(node.child, device)
    dev = b.device

    if not node.groups:
        res = agg_ops.ungrouped_aggregate(_payloads(node, b), b.sel)
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

    sizes = None
    if all(a.kind in _DENSE_KINDS for a in node.aggs):
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
    """Sort-based grouped aggregation of one batch."""
    key_ops, key_data = [], []
    for g in node.groups:
        d, n = evaluate(g, b)
        key_ops.extend(sortkey.encode_key(d, n, g.dtype))
        key_data.append((d, n))
    group_cols, results, gsel, ng = agg_ops.group_and_aggregate(
        key_ops, key_data, _payloads(node, b), b.sel, b.capacity)
    return _agg_output(node, group_cols, results, gsel, ng)


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
    L.Order: _exec_order,
    L.TopN: _exec_topn,
    L.Limit: _exec_limit,
    L.Distinct: _exec_distinct,
}

"""Distributed plan executor: SQL plans over a mesh of shards (PyTorch
port of ddb_tpu/parallel/executor.py).

Bound logical plans run with their base tables row-sharded over the mesh
(parallel/mesh.py):

  Get/Filter/Project  per shard
  Aggregate           local partial aggregate per shard -> hash exchange
                      of the partials -> final aggregate; DISTINCT and
                      holistic aggregates exchange raw rows by group key
  Join                hash exchange of both sides -> local sorted-probe
                      join per shard (co-partitioned keys)
  Order               sampled range partition -> local sort per shard
  Window              hash exchange on the PARTITION BY keys
  Limit               a global prefix count (plain) or per-shard top-k
  the rest            gathered to one device, the single-device executor

A sharded relation is a list of per-shard `Batch`es.  The reference runs
each operator as one `shard_map` program; here every such program is a
loop over the shards, split where the program calls a collective
(parallel/exchange.py).  Capacities are the reference's power-of-two
choices, and an exchange that overflows is retried with doubled
capacities, at most five times, reading the overflow on the host once an
attempt.

Deviations of structure, none of which changes a row:
  * the gather: the reference gathers through the host (`np.asarray`);
    here the shards are concatenated on the mesh's first device;
  * work that does not depend on the retried capacity (key hashes, the
    local partial aggregate) runs once, not once an attempt, and an
    attempt whose exchange overflowed stops before its local operator;
  * an aggregate that falls back to the gathered path decides so before
    its child runs, where the reference runs the child twice;
  * NULL masks and high limbs travel only for the columns that have
    them; the reference sends an int8 NULL flag for every column and
    no high limb.  So a wide (two-limb) sum keeps its high limb through
    the exchanges, and the partial sums of an integer aggregate whose
    total may pass int64 merge in two limbs (ROADMAP fault 3.17);
  * an operator holding an expression that fills a run-time dictionary
    on the host (`__stringify__`, `__pyudf__`) gathers, so that every
    row's code indexes one dictionary; evaluated shard by shard, each
    shard would refill it (inside the reference's `shard_map`, such an
    expression fails to trace).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from ..batch import Batch, Column, Schema, bucket_capacity
from ..expr import ir
from ..expr.compile import evaluate, select_mask
from ..ops import aggregate as agg_ops
from ..ops import hashing
from ..ops import join as join_ops
from ..ops import order as order_ops
from ..ops import sortkey
from ..plan import logical as L
from ..plan import physical
from .exchange import all_gather, all_to_all_exchange, axis_index, psum
from .mesh import AXIS, row_sharding

# aggregate kinds the distributed path decomposes into mergeable partials
_DIST_AGG_KINDS = {"sum", "sum_float", "count", "count_star", "min",
                   "max", "avg"}

# aggregates that need a group's rows on one shard: the distributed path
# exchanges raw rows by group hash instead of mergeable partials
# (reference: distinct_aggregate_data.cpp re-partitions full inputs)
_ROW_EXCHANGE_KINDS = {"quantile", "mode", "entropy", "arg_min",
                       "arg_max", "median", "approx_count_distinct"}

# functions that fill a run-time dictionary on the host
_HOST_SEAMS = ("__stringify__", "__pyudf__")

# skew/overflow observability: each doubling retry of an aggregate or
# window exchange's capacity adds one (joins and sorts retry silently,
# as in the reference)
STATS = {"exchange_retries": 0, "exchange_overflow_rows": 0}

_RETRIES = 5


class DistContext:
    def __init__(self, mesh):
        self.mesh = mesh
        self.n = mesh.shape[AXIS]
        if mesh.size != self.n:
            raise NotImplementedError("the executor runs over a 1-D mesh")
        self.devices = mesh.devices
        self.device = mesh.devices[0]

    def shard_batch(self, batch: Batch, cap: int = None) -> List[Batch]:
        """Pad a batch so its capacity divides the mesh and split its
        rows into the mesh's shards."""
        if cap is None:
            cap = max(bucket_capacity(batch.capacity), self.n * 128)
        cap = -(-cap // self.n) * self.n

        def shards(t):
            return None if t is None else row_sharding(
                self.mesh, physical._pad(t, cap))

        cols = [[shards(t) or [None] * self.n
                 for t in (c.data, c.nulls, c.hi)] for c in batch.columns]
        return [Batch(tuple(Column(d[i], nn[i], hi[i])
                            for d, nn, hi in cols),
                      s, s.sum(dtype=torch.int32))
                for i, s in enumerate(shards(batch.sel))]

    def gather(self, parts: List[Batch]) -> Batch:
        """The shards' rows concatenated in shard order on the first
        device.  Consumes `parts`: each column leaves the shards once it
        is copied, so that the gather holds one column twice at most."""
        dev = self.device

        def cat(ts):
            return torch.cat([t.to(dev, non_blocking=True) for t in ts])

        cols = []
        for i, lay in enumerate(_layout(parts)):
            cs = [b.columns[i] for b in parts]
            cols.append(Column(
                cat([c.data for c in cs]),
                cat([physical._nulls_or_false(c) for c in cs])
                if lay.nulls else None,
                cat([physical._high_limb(c) for c in cs])
                if lay.hi else None))
            del cs
            for k, b in enumerate(parts):
                parts[k] = b._replace(columns=b.columns[:i] + (None,)
                                      + b.columns[i + 1:])
        sel = cat([b.sel for b in parts])
        parts.clear()
        return Batch(tuple(cols), sel, sel.sum(dtype=torch.int32))

    def overflow(self, per_shard) -> int:
        """The shards' overflow counts summed: one host read."""
        return int(torch.stack([o.to(self.device) for o in per_shard])
                   .sum())


def execute_distributed(plan: L.LogicalNode, mesh) -> Tuple[Schema, Batch]:
    """Execute a plan over the mesh; the result is gathered on the mesh's
    first device."""
    ctx = DistContext(mesh)
    schema, parts = _exec(plan, ctx)
    return schema, ctx.gather(parts)


def _single(ctx, schema, batch):
    """A single-device result as a sharded relation."""
    return schema, ctx.shard_batch(batch, batch.capacity)


def _capacity(parts) -> int:
    return sum(b.capacity for b in parts)


def _each(fn, parts) -> list:
    """fn over every shard; consumes `parts`, each shard's input
    released once its output exists."""
    out = []
    for i in range(len(parts)):
        b, parts[i] = parts[i], None
        out.append(fn(b))
    return out


def _exec(node: L.LogicalNode, ctx: DistContext):
    if isinstance(node, (L.RecursiveCTE, L.CTERef)):
        # fixpoint loops are host-driven; they run on the single-device
        # executor (their inputs are small working tables)
        return _single(ctx, *physical.execute(node, ctx.device))
    if _holds_host_seam(node):
        return _exec_gathered(node, ctx)
    if isinstance(node, L.Get):
        return _exec_get(node, ctx)
    if isinstance(node, L.Filter):
        _, parts = _exec(node.child, ctx)
        return node.schema, [physical._filtered(b, node.predicate)
                             for b in parts]
    if isinstance(node, L.Project):
        _, parts = _exec(node.child, ctx)
        # bare column refs pass through, high limbs included
        return node.schema, [
            Batch(tuple(b.columns[e.index] if isinstance(e, ir.ColRef)
                        else Column(*evaluate(e, b)) for e in node.exprs),
                  b.sel, b.count) for b in parts]
    if isinstance(node, L.Aggregate):
        return _exec_aggregate(node, ctx)
    if isinstance(node, L.Join):
        return _exec_join(node, ctx)
    if isinstance(node, L.Order):
        return _exec_order(node, ctx)
    if isinstance(node, L.Distinct):
        return _exec_distinct(node, ctx)
    if isinstance(node, L.Window):
        return _exec_window(node, ctx)
    if isinstance(node, L.Limit):
        return _exec_limit(node, ctx)
    # everything else: gather and run the single-device executor
    return _exec_gathered(node, ctx)


def _holds_host_seam(node) -> bool:
    """Whether an expression the node holds itself (not its children's)
    fills a run-time dictionary on the host."""
    def exprs(x):
        if isinstance(x, ir.Expr):
            yield from ir.walk(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                yield from exprs(y)
        elif dataclasses.is_dataclass(x) and not isinstance(
                x, (L.LogicalNode, Schema)):
            for f in dataclasses.fields(x):
                yield from exprs(getattr(x, f.name))

    if not dataclasses.is_dataclass(node):
        return False
    own = [getattr(node, f.name) for f in dataclasses.fields(node)]
    return any(isinstance(e, ir.Func) and e.name in _HOST_SEAMS
               for x in own if not isinstance(x, (L.LogicalNode, Schema))
               for e in exprs(x))


def _exec_limit(node: L.Limit, ctx: DistContext):
    """Plain LIMIT/OFFSET keeps the rows sharded: a global prefix count.
    LIMIT over ORDER BY keeps each shard's local top (limit + offset)
    rows, gathers those few and finishes with one small single-device
    sort (reference: PhysicalTopN's per-thread heaps merged at finalize,
    physical_top_n.cpp)."""
    child = node.child
    k = None
    if node.limit is not None and node.percent is None:
        k = int(node.limit) + int(node.offset or 0)
    if not isinstance(child, L.Order) and node.percent is None \
            and (node.limit is not None or node.offset):
        # each shard keeps the rows whose global selected-row index lies
        # in [offset, offset+limit), from an all_gather of the per-shard
        # counts (reference: PhysicalLimit's shared row counter,
        # physical_limit.cpp)
        _, parts = _exec(child, ctx)
        off = int(node.offset or 0)
        lim = int(node.limit) if node.limit is not None else None
        local = [torch.cumsum(b.sel.to(torch.int64), 0) for b in parts]
        totals = all_gather([c[-1] for c in local], ctx.devices)
        out = []
        for b, c, tot, rank in zip(parts, local, totals,
                                   axis_index(ctx.devices)):
            below = torch.arange(ctx.n, device=b.device) < rank
            gidx = torch.where(below, tot, 0).sum() + c - 1
            keep = b.sel & (gidx >= off)
            if lim is not None:
                keep = keep & (gidx < off + lim)
            out.append(Batch(b.columns, keep, keep.sum(dtype=torch.int32)))
        return node.schema, out
    if not isinstance(child, L.Order) or k is None or k > 1 << 16:
        return _exec_gathered(node, ctx)
    _, parts = _exec(child.child, ctx)
    kcap = bucket_capacity(max(k, 128))
    tops = []
    for b in parts:
        perm = order_ops.sort_permutation(
            physical._order_keys(child.keys, b), b.sel)[:kcap]
        tops.append(physical._gather(b, perm, b.sel[perm], None))
    small = ctx.gather(tops)
    # final: one small single-device Order + Limit over n_shards * kcap
    order2 = copy.copy(child)
    order2.child = physical.ConstBatch(child.child.schema, small)
    lim2 = copy.copy(node)
    lim2.child = order2
    return _single(ctx, *physical.execute(lim2, ctx.device))


# ---- row exchanges ------------------------------------------------------------

class _ColLayout(NamedTuple):
    nulls: bool
    hi: bool


def _layout(parts) -> List[_ColLayout]:
    """Which columns carry a NULL mask or a high limb on some shard."""
    return [_ColLayout(any(b.columns[i].nulls is not None for b in parts),
                       any(b.columns[i].hi is not None for b in parts))
            for i in range(len(parts[0].columns))]


def _flat(b: Batch, layout) -> list:
    """A shard's columns as the arrays an exchange moves."""
    out = []
    for c, lay in zip(b.columns, layout):
        out.append(c.data)
        if lay.nulls:
            out.append(physical._nulls_or_false(c))
        if lay.hi:
            out.append(physical._high_limb(c))
    return out


def _unflat(arrays, layout, sel) -> Batch:
    cols = []
    it = iter(arrays)
    for lay in layout:
        d = next(it)
        nn = next(it) if lay.nulls else None
        hi = next(it) if lay.hi else None
        cols.append(Column(d, nn, hi))
    return Batch(tuple(cols), sel, sel.sum(dtype=torch.int32))


def _hash_pid(exprs, b: Batch, n_shards: int):
    """Target shard of every row by the hash of `exprs` (NULL as -1)."""
    h = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
    for e in exprs:
        d, nmask = evaluate(e, b)
        k = d.to(torch.int64)
        if nmask is not None:
            k = torch.where(nmask, -1, k)
        h = hashing.hash_combine(h, k)
    return hashing.partition_of(h, n_shards)


def _exchange_rows(ctx, parts, pid, ex_cap: int, what: str):
    """Every row to the shard `pid` names, doubling ex_cap on overflow;
    the exchanged shards."""
    layout = _layout(parts)
    flat = [_flat(b, layout) for b in parts]
    sels = [b.sel for b in parts]
    for _ in range(_RETRIES):
        ex, evalid, overflow = all_to_all_exchange(
            flat, sels, pid, ctx.n, ex_cap, ctx.devices)
        overflow = ctx.overflow(overflow)
        if overflow == 0:
            return [_unflat(a, layout, v) for a, v in zip(ex, evalid)]
        del ex, evalid
        STATS["exchange_retries"] += 1
        STATS["exchange_overflow_rows"] += overflow
        ex_cap = bucket_capacity(ex_cap * 2)
    raise RuntimeError(f"{what} exchange overflow after retries")


def _exec_window(node: L.Window, ctx: DistContext):
    """Window functions: exchange raw rows on the PARTITION BY keys so
    that each partition lies wholly on one shard, then the single-device
    window operator per shard (reference: PartitionedHashGroup,
    window_executor.cpp).  Needs one non-empty partition signature shared
    by every function; otherwise the result is global and gathers."""
    sigs = {tuple(repr(p) for p in f.partition) for f in node.fns}
    if len(sigs) != 1 or not node.fns[0].partition:
        return _exec_gathered(node, ctx)
    _, parts = _exec(node.child, ctx)
    per_shard = _capacity(parts) // ctx.n
    ex_cap = bucket_capacity(
        max(per_shard * 2 // max(ctx.n // 2, 1), 256))
    pid = [_hash_pid(node.fns[0].partition, b, ctx.n) for b in parts]
    eparts = _exchange_rows(ctx, parts, pid, ex_cap, "window")
    del parts
    return node.schema, _each(lambda b: physical.local_window(node, b),
                              eparts)


def _exec_gathered(node: L.LogicalNode, ctx: DistContext):
    """Fallback: the children run distributed and are gathered, then the
    single-device operator runs over them."""
    kids = node.children()
    if not kids:
        return _single(ctx, *physical.execute(node, ctx.device))
    gathered = [(k, ctx.gather(_exec(k, ctx)[1])) for k in kids]
    new = copy.copy(node)
    for attr in ("child", "left", "right"):
        if hasattr(new, attr):
            old = getattr(node, attr)
            for k, kb in gathered:
                if k is old:
                    setattr(new, attr, physical.ConstBatch(k.schema, kb))
    return _single(ctx, *physical.execute(new, ctx.device))


def _exec_get(node: L.Get, ctx: DistContext):
    batch = node.table.device_batch(node.column_indices, device=ctx.device)
    cap = bucket_capacity(max(batch.capacity, ctx.n * 128))
    parts = ctx.shard_batch(batch, cap)
    if node.filters:
        pred = ir.make_and(node.filters)
        parts = [physical._filtered(b, pred) for b in parts]
    return node.schema, parts


# ---------------------------------------------------------------------------
# distributed aggregate
# ---------------------------------------------------------------------------

def _exec_aggregate(node: L.Aggregate, ctx: DistContext):
    needs_rows = any(
        (a.distinct and a.kind != "count_star")
        or a.kind in _ROW_EXCHANGE_KINDS for a in node.aggs)
    unsupported = any(
        a.kind in physical._HOST_AGG_KINDS
        or (a.kind not in _DIST_AGG_KINDS
            and a.kind not in _ROW_EXCHANGE_KINDS
            and a.kind != "count_star") for a in node.aggs)
    if unsupported or (needs_rows and
                       (not node.groups or physical._wide_aggs(node, 1))):
        # host-finalized aggregates and ungrouped specials: the child runs
        # distributed, the final (small) aggregation gathers
        return _exec_gathered(node, ctx)
    _, parts = _exec(node.child, ctx)
    if needs_rows:
        return _exec_aggregate_rows(node, ctx, parts)
    if not node.groups:
        return _exec_ungrouped(node, ctx, parts)

    n_shards = ctx.n
    per_shard = _capacity(parts) // n_shards
    ex_cap = bucket_capacity(max(per_shard // max(n_shards // 2, 1), 128))
    wide = physical._wide_aggs(node, _capacity(parts))

    # local partial aggregates: the arrays that cross the exchange
    local = _each(lambda b: _partial_aggregate(node, b, wide, n_shards),
                  parts)
    arrays, gsels, pids, shapes, merges = (list(x) for x in zip(*local))
    del local
    shape, merge = shapes[0], merges[0]
    if any(x != shape for x in shapes):
        raise RuntimeError("shards disagree on the partials' layout")

    for _ in range(_RETRIES):
        ex, evalid, overflow = all_to_all_exchange(
            arrays, gsels, pids, n_shards, ex_cap, ctx.devices)
        overflow = ctx.overflow(overflow)
        if overflow == 0:
            break
        del ex, evalid
        STATS["exchange_retries"] += 1
        STATS["exchange_overflow_rows"] += overflow
        ex_cap = bucket_capacity(ex_cap * 2)
    else:
        raise RuntimeError(
            f"aggregate exchange overflow ({overflow} rows) after retries")
    del arrays

    out = []
    ng = len(node.groups)
    final_cap = n_shards * ex_cap
    for s in range(n_shards):
        flat, ev = ex[s], evalid[s]
        ex[s] = evalid[s] = None
        res = _unflat_results(flat, shape)
        del flat
        ekey_data = res[:ng]
        key_ops = []
        for (d, nn), g in zip(ekey_data, node.groups):
            key_ops.extend(sortkey.encode_key(d, nn, g.dtype))
        eparts = [_merge_payload(kind, d, nn)
                  for kind, (d, nn) in zip(_merge_kinds(merge), res[ng:])]
        gcols, finals, gsel, ngroups = agg_ops.group_and_aggregate(
            key_ops, ekey_data, eparts, ev, final_cap)
        cols = [Column(d, nn) for d, nn in gcols]
        for a, (kind, i1, i2) in zip(node.aggs, merge):
            d, nn = _recombine(kind, finals, i1, i2, gsel)
            cols.append(physical._agg_column(a, d, nn))
        out.append(Batch(tuple(cols), gsel, ngroups))
    return node.schema, out


def _partial_aggregate(node, b: Batch, wide, n_shards: int):
    """One shard's partial aggregate: (the arrays of its groups and
    partials, its live groups, their target shards, the arrays' shape,
    the recombination plan)."""
    key_ops, key_data = _group_keys(node.groups, b)
    ps, merge = _partials(node, b, wide)
    gcols, partials, gsel, _ = agg_ops.group_and_aggregate(
        key_ops, key_data, ps, b.sel, b.capacity)
    h = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
    for d, _nmask in gcols:
        h = hashing.hash_combine(h, d.to(torch.int64))
    flat, shape = _flat_results(gcols + partials)
    return flat, gsel, hashing.partition_of(h, n_shards), shape, merge


def _group_keys(groups, b: Batch):
    key_ops, key_data = [], []
    for g in groups:
        d, n = evaluate(g, b)
        key_ops.extend(sortkey.encode_key(d, n, g.dtype))
        key_data.append((d, n))
    return key_ops, key_data


def _partials(node: L.Aggregate, b: Batch, wide):
    """A shard's payloads decomposed into mergeable partials, and per
    aggregate how to recombine them: (kind, index, second index).  An
    integer sum that may pass int64 over the whole relation (`wide`)
    merges in two limbs, whatever one shard's partial needs."""
    parts, merge = [], []
    for i, p in enumerate(physical._payloads(node, b)):
        if p.kind in ("avg", "avg_wide"):
            s = "sum_wide" if p.kind == "avg_wide" else "sum"
            parts.append(agg_ops.AggPayload(s, p.data, p.nulls, p.data2))
            parts.append(agg_ops.AggPayload("count", p.data, p.nulls))
            merge.append(("avg_wide" if i in wide else "avg",
                          len(parts) - 2, len(parts) - 1))
            continue
        parts.append(p)
        kind = p.kind
        if kind == "sum" and i in wide:
            kind = "sum_wide"
        merge.append((kind, len(parts) - 1, None))
    return parts, merge


def _merge_kinds(merge):
    """The final aggregate's kind of every partial, in partial order."""
    kinds = {}
    for kind, i1, i2 in merge:
        if kind in ("avg", "avg_wide"):
            kinds[i1] = "sum_wide" if kind == "avg_wide" else "sum"
            kinds[i2] = "sum"
        else:
            kinds[i1] = {"count": "sum", "count_star": "sum"}.get(kind, kind)
    return [kinds[i] for i in range(len(kinds))]


def _merge_payload(kind, d, nn):
    """The final aggregate's payload over exchanged partials; a two-limb
    partial is (composed, high limb)."""
    if isinstance(d, tuple):
        return agg_ops.AggPayload(kind, d[0], nn, d[1])
    return agg_ops.AggPayload(kind, d, nn)


def _recombine(kind, finals, i1, i2, gsel):
    if kind in ("avg", "avg_wide"):
        s, _ = finals[i1]
        c, _ = finals[i2]
        if isinstance(s, tuple):
            lo, hi = s[0] & 0xFFFFFFFF, s[1]
            s = hi.to(torch.float64) * float(2 ** 32) + lo.to(torch.float64)
        return s.to(torch.float64) / torch.clamp(c, min=1), c == 0
    d, nmask = finals[i1]
    if kind in ("count", "count_star"):
        return torch.where(gsel, d, 0), None
    return d, nmask


def _flat_results(results):
    """[(data, nulls)] (data may be a (composed, high limb) pair) as flat
    arrays, with their shape: per result, (two limbs, has nulls)."""
    flat, shape = [], []
    for d, nn in results:
        pair = isinstance(d, tuple)
        flat.extend(d if pair else (d,))
        if nn is not None:
            flat.append(nn)
        shape.append((pair, nn is not None))
    return flat, shape


def _unflat_results(flat, shape):
    out = []
    it = iter(flat)
    for pair, has_nulls in shape:
        d = (next(it), next(it)) if pair else next(it)
        out.append((d, next(it) if has_nulls else None))
    return out


def _exec_aggregate_rows(node: L.Aggregate, ctx: DistContext, parts):
    """DISTINCT and holistic aggregates (quantile, mode, arg_min/arg_max,
    entropy): exchange raw rows by group key so that every group lies
    wholly on one shard, then the single-device sort-based aggregation
    per shard."""
    per_shard = _capacity(parts) // ctx.n
    ex_cap = bucket_capacity(
        max(per_shard * 2 // max(ctx.n // 2, 1), 256))
    pid = [_hash_pid(node.groups, b, ctx.n) for b in parts]
    eparts = _exchange_rows(ctx, parts, pid, ex_cap, "aggregate row")
    del parts
    return node.schema, _each(
        lambda b: physical.local_grouped_aggregate(node, b), eparts)


def _exec_ungrouped(node, ctx, parts):
    """Ungrouped aggregate: local partials per shard, then the partials
    of every shard merged on the first (the reference lets XLA insert
    the cross-shard reductions)."""
    wide = physical._wide_aggs(node, _capacity(parts))
    per_shard, merge = [], None
    for b in parts:
        ps, merge = _partials(node, b, wide)
        per_shard.append(agg_ops.ungrouped_aggregate(ps, b.sel))
    dev = ctx.device
    finals = []
    for j, kind in enumerate(_merge_kinds(merge)):
        vals = [r[j][0] for r in per_shard]
        nulls = [r[j][1] for r in per_shard]
        if isinstance(vals[0], tuple):
            d = tuple(torch.stack([v[k].to(dev) for v in vals])
                      for k in range(2))
        else:
            d = torch.stack([v.to(dev) for v in vals])
        nn = None if nulls[0] is None \
            else torch.stack([x.to(dev) for x in nulls])
        finals.append(agg_ops.ungrouped_aggregate(
            [_merge_payload(kind, d, nn)],
            torch.ones(len(vals), dtype=torch.bool, device=dev))[0])
    one = torch.ones((), dtype=torch.bool, device=dev)
    res = [_recombine(kind, finals, i1, i2, one)
           for kind, i1, i2 in merge]
    return _single(ctx, node.schema, physical.scalar_batch(node, res, dev))


# ---------------------------------------------------------------------------
# distributed join
# ---------------------------------------------------------------------------

def _exec_join(node: L.Join, ctx: DistContext):
    """Distributed equi-join: both sides are co-partitioned by the hash of
    the join keys, then each shard resolves its partition locally,
    outer/mark semantics included, which are shard-local facts once equal
    keys are co-located (reference: partitioned hash join,
    physical_hash_join.cpp:542-600).

    Covers inner/left/right/full/semi/anti/mark, several conditions
    (combined hash + local key densify) and residual `extra` predicates.
    Range/asof joins and correlated mark joins with NULL tracking gather."""
    jt = node.join_type
    if jt not in ("inner", "left", "right", "full", "semi", "anti",
                  "mark"):
        return _exec_gathered(node, ctx)
    if not node.conds or node.range_cond is not None or node.asof:
        return _exec_gathered(node, ctx)
    if jt == "mark" and node.mark_in and len(node.conds) > 1:
        return _exec_gathered(node, ctx)

    _, lparts = _exec(node.left, ctx)
    _, rparts = _exec(node.right, ctx)
    n_shards = ctx.n
    lcap_per = _capacity(lparts) // n_shards
    rcap_per = _capacity(rparts) // n_shards
    ex_cap = bucket_capacity(max(lcap_per, rcap_per, 128) * 2
                             // max(n_shards // 2, 1))
    ex_cap = max(ex_cap, 256)
    out_cap = bucket_capacity(max(lcap_per * 2, 256))

    lside = _join_side(node, lparts, "left", n_shards)
    rside = _join_side(node, rparts, "right", n_shards)
    for _ in range(_RETRIES):
        out = _join_attempt(node, ctx, lside, rside, ex_cap, out_cap)
        if out is not None:
            return node.schema, out
        # skew/expansion backstop: double the capacities (reference:
        # dynamic radix-bit repartitioning, join_hashtable.hpp:375-428)
        ex_cap *= 2
        out_cap *= 4
    raise RuntimeError("join exchange overflow after retries")


class _Side(NamedTuple):
    arrays: list      # per shard: keys, key NULL masks, then the columns
    sels: list
    pids: list
    key_nulls: list   # per condition: whether a NULL mask travels
    layout: list


def _join_side(node: L.Join, parts, side: str, n_shards: int) -> _Side:
    keys, nulls = [], []
    for b in parts:
        ks, ns = physical._key_arrays(node.conds, b, side)
        keys.append(ks)
        nulls.append(ns)
    key_nulls = [any(ns[i] is not None for ns in nulls)
                 for i in range(len(node.conds))]
    layout = _layout(parts)
    arrays, pids = [], []
    for b, ks, ns in zip(parts, keys, nulls):
        h = torch.zeros(b.capacity, dtype=torch.int64, device=b.device)
        for k in ks:
            h = hashing.hash_combine(h, k)
        pids.append(hashing.partition_of(h, n_shards))
        flags = [torch.zeros_like(b.sel) if x is None else x
                 for x, keep in zip(ns, key_nulls) if keep]
        arrays.append(ks + flags + _flat(b, layout))
    return _Side(arrays, [b.sel for b in parts], pids, key_nulls, layout)


def _received(side: _Side, flat, sel, nc: int):
    """(keys, key NULL masks or None, live rows, the exchanged batch) of
    one shard's received rows; the exchange keeps rows whose keys are
    NULL (valid = sel): outer, anti and mark joins need them."""
    it = iter(flat)
    keys = [next(it) for _ in range(nc)]
    nulls = [next(it) if keep else None for keep in side.key_nulls]
    b = _unflat(list(it), side.layout, sel)
    return keys, nulls, physical._combine_live(sel, nulls), b


def _join_attempt(node: L.Join, ctx: DistContext, lside: _Side,
                  rside: _Side, ex_cap: int, out_cap: int):
    """One attempt at the given capacities: the joined shards, or None
    when an exchange or an expansion overflowed."""
    jt = node.join_type
    nc = len(node.conds)
    el, elsel, lof = all_to_all_exchange(
        lside.arrays, lside.sels, lside.pids, ctx.n, ex_cap, ctx.devices)
    er, ersel, rof = all_to_all_exchange(
        rside.arrays, rside.sels, rside.pids, ctx.n, ex_cap, ctx.devices)
    shards = []
    for s in range(ctx.n):
        lks, lns, l_live, lb = _received(lside, el[s], elsel[s], nc)
        rks, rns, r_live, rb = _received(rside, er[s], ersel[s], nc)
        if nc == 1:
            lk2, rk2 = lks[0], rks[0]
        else:
            lk2, rk2 = physical._densify_keys(lks, l_live, rks, r_live)
            l_live = l_live & (lk2 >= 0)
            r_live = r_live & (rk2 >= 0)
        bt = join_ops.build(rk2, None, r_live)
        lo, cnt = join_ops.probe_ranges(bt, lk2, None, l_live)
        shards.append((lb, rb, lns, rns, bt, lo, cnt))
    del el, er
    marks = jt in ("semi", "anti", "mark") and node.extra is None
    overflow = [a + b for a, b in zip(lof, rof)]
    if not marks:
        overflow = [o + torch.clamp(join_ops.match_total(sh[6]) - out_cap,
                                    min=0)
                    for o, sh in zip(overflow, shards)]
    if ctx.overflow(overflow):
        return None

    if marks:
        if jt == "mark" and node.mark_in:
            # global build facts for SQL's three-valued IN marks
            hasnull = psum([(rb.sel & rns[0]).sum() if rns[0] is not None
                            else torch.zeros((), dtype=torch.int64,
                                             device=rb.device)
                            for _, rb, _, rns, *_ in shards], ctx.devices)
            nonempty = psum([rb.sel.sum() for _, rb, *_ in shards],
                            ctx.devices)
        out = []
        for s, (lb, rb, lns, rns, bt, lo, cnt) in enumerate(shards):
            has = cnt > 0
            if jt == "semi" or jt == "anti":
                m = lb.sel & (has if jt == "semi" else ~has)
                out.append(Batch(lb.columns, m, m.sum(dtype=torch.int32)))
                continue
            mnull = None
            if node.mark_in:
                pnull = lns[0] if lns[0] is not None \
                    else torch.zeros_like(lb.sel)
                mnull = ~has & ((pnull & (nonempty[s] > 0))
                                | (hasnull[s] > 0))
            out.append(Batch(lb.columns + (Column(has, mnull),), lb.sel,
                             lb.count))
        return out

    out = []
    for s in range(ctx.n):
        (lb, rb, lns, rns, bt, lo, cnt), shards[s] = shards[s], None
        cap_l, cap_r = lb.capacity, rb.capacity
        pi, bpos, valid = join_ops.expand(lo, cnt, out_cap)
        brow = bt.srow[bpos]
        lparts, rparts = physical._take(lb, pi), physical._take(rb, brow)
        if node.extra is not None:
            # residual predicate over the expanded pairs (reference:
            # non-equality conditions in ScanStructure::Next)
            pairs = Batch(tuple(lparts + rparts), valid,
                          valid.sum(dtype=torch.int32))
            valid = valid & select_mask(node.extra, pairs)
            if jt in ("semi", "anti", "mark"):
                matched = physical._flags(pi, valid, cap_l)
                if jt == "mark":
                    out.append(Batch(lb.columns + (Column(matched, None),),
                                     lb.sel, lb.count))
                    continue
                m = lb.sel & (matched if jt == "semi" else ~matched)
                out.append(Batch(lb.columns, m, m.sum(dtype=torch.int32)))
                continue
            probe_matched = physical._flags(pi, valid, cap_l)
            build_matched = physical._flags(brow, valid, cap_r)
        else:
            probe_matched = cnt > 0
            build_matched = join_ops.matched_build_mask(bt, lo, cnt, cap_r)
        # [matches][left-outer][right-outer], each with its own mask
        ext_l = cap_l if jt in ("left", "full") else 0
        ext_r = cap_r if jt in ("right", "full") else 0
        sels = [valid]
        if ext_l:
            sels.append(lb.sel & ~probe_matched)
        if ext_r:
            sels.append(rb.sel & ~build_matched)
        sel = physical._cat(sels)
        cols = physical._outer_concat(lparts, rparts, ext_l, ext_r, lb, rb,
                                      sel.shape[0])
        out.append(Batch(tuple(cols), sel, sel.sum(dtype=torch.int32)))
    return out


# ---------------------------------------------------------------------------
# distributed sort (sample-based range partition + local sort)
# ---------------------------------------------------------------------------

_N_SAMPLES = 64


def _exec_order(node: L.Order, ctx: DistContext):
    """ORDER BY: sample the first sort key to pick range boundaries (the
    same on every shard, from an all_gather), route every row to its
    range's shard, then one local sort per shard.  Rows with equal
    first-key values land on one shard, so the shard-major concatenation
    is sorted (the parallel analog of the reference's sorted-run merge,
    common/sorting/sorted_run_merger.hpp).  A wide (two-limb) first key
    is sampled by its high limb, as the port's sort orders it."""
    _, parts = _exec(node.child, ctx)
    cap_per = max(_capacity(parts) // ctx.n, 1)
    ex_cap = bucket_capacity(max(cap_per * 2, 256))
    layout = _layout(parts)
    key_ops, p01, samples = [], [], []
    big = torch.iinfo(torch.int64).max
    for b in parts:
        ops = physical._order_keys(node.keys, b)
        first = physical._order_keys(node.keys[:1], b)
        p0 = first[0].to(torch.int64)
        p1 = first[1].to(torch.int64) if len(first) > 1 \
            else torch.zeros_like(p0)
        s0, s1 = _lexsorted(torch.where(b.sel, p0, big),
                            torch.where(b.sel, p1, big))
        stride = max(b.capacity // _N_SAMPLES, 1)
        samples.append(torch.stack((s0[::stride][:_N_SAMPLES],
                                    s1[::stride][:_N_SAMPLES])))
        key_ops.append(ops)
        p01.append((p0, p1))
    bounds = []
    for g in all_gather(samples, ctx.devices):
        g0, g1 = _lexsorted(g[:, 0].reshape(-1), g[:, 1].reshape(-1))
        bidx = (torch.arange(1, ctx.n, device=g.device) * g0.shape[0]) \
            // ctx.n
        bounds.append((g0[bidx], g1[bidx]))
    pids = []
    for (p0, p1), (b0, b1) in zip(p01, bounds):
        # shard = boundaries at or below the row's (p0, p1): equal
        # first-key rows land on one shard, making ties local
        ge = (p0[:, None] > b0[None, :]) \
            | ((p0[:, None] == b0[None, :]) & (p1[:, None] >= b1[None, :]))
        pids.append(ge.sum(dim=1, dtype=torch.int32))
    del p01
    flat = [ops + _flat(b, layout) for ops, b in zip(key_ops, parts)]
    nko = len(key_ops[0])
    sels = [b.sel for b in parts]
    del parts, key_ops
    for _ in range(_RETRIES):
        ex, exsel, overflow = all_to_all_exchange(
            flat, sels, pids, ctx.n, ex_cap, ctx.devices)
        if ctx.overflow(overflow) == 0:
            break
        del ex, exsel
        ex_cap *= 2   # range skew backstop: double and try again
    else:
        raise RuntimeError("order exchange overflow after retries")
    del flat

    def local_sort(s):
        arrays, sel = ex[s], exsel[s]
        ex[s] = exsel[s] = None
        perm = order_ops.sort_permutation(list(arrays[:nko]), sel)
        return _unflat([a[perm] for a in arrays[nko:]], layout, sel[perm])
    return node.schema, _each(local_sort, list(range(ctx.n)))


def _lexsorted(a, b):
    """(a, b) sorted by a, then b."""
    perm = order_ops.sort_pass(b).indices
    perm = perm[order_ops.sort_pass(a[perm]).indices]
    return a[perm], b[perm]


def _exec_distinct(node: L.Distinct, ctx: DistContext):
    """DISTINCT = grouped aggregate over every column with no payloads
    (reference: distinct lowers to aggregate, physical_plan_generator)."""
    groups = [ir.ColRef(i, f.dtype, f.name, f.strdict)
              for i, f in enumerate(node.child.schema.fields)]
    agg = L.Aggregate(node.child, groups, [],
                      list(node.child.schema.names), node.schema)
    return _exec_aggregate(agg, ctx)

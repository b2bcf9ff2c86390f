"""Out-of-core tiled execution: host-to-device streaming aggregation, TopN,
sort and the Grace-partitioned external join (PyTorch port of
ddb_tpu/plan/tiled.py).

The TPU analog of the reference's external (spilling) operator modes
(reference: radix_partitioned_hashtable.cpp abandon-HT external mode,
storage/temporary_memory_manager.hpp arbitration): when a base table
exceeds `external_threshold_rows`, aggregation pipelines stream the table
through device memory in fixed-size row tiles:

  per tile (every tile padded to one capacity):
      scan tile -> filters/projections -> PARTIAL aggregate -> compact
  combine:  concatenate partial groups on host (small) ->
            merge aggregate (sum/min/max of partials, avg = sum/count)
  finish:   run the plan above the Aggregate over the merged result

Only decomposable aggregates stream (sum/count/min/max/avg); plans with
holistic aggregates (quantile/distinct) run in memory.  The matchers and
the partial/merge planning are the reference's host code; they choose
the same path for every plan.

The reference overlaps the upload of tile k+1 with tile k through XLA's
asynchronous dispatch.  Eager PyTorch does not do that by itself, so on
a CUDA device `_TileFeed` copies tiles from page-locked host memory on a
stream of its own: a column of at least `REGISTER_MIN_BYTES` is
registered in place with cudaHostRegister once for its lifetime (or
read in place, if it is page-locked already), a smaller one is staged
through a page-locked buffer; tile k+1's copy is enqueued before tile
k's partial is read on the host, and the two device buffers alternate.
On the CPU the same code copies tiles without streams.  Two named
deviations from the reference: `_to_host` keeps the high limb of a wide
partial, and `_partial_specs` divides a DECIMAL average by its scale
once (the reference divides twice).
"""

from __future__ import annotations

import copy
import time
import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..batch import (Batch, Column, Schema, bucket_capacity, make_batch,
                     to_numpy, torch_dtype)
from ..expr import ir
from ..types import TypeId
from . import logical as L
from . import physical

MERGEABLE = {"sum", "min", "max", "count", "count_star", "avg"}

_UPPER = (L.Project, L.Order, L.Limit, L.Filter, L.Distinct)
_LOWER = (L.Filter, L.Project)

# what the tiled paths moved to the device and how long it took, summed
# over statements until reset: tiles, host bytes copied to the device,
# seconds of host staging copies, and (CUDA) ms of the copy stream's
# copies and of the compute stream from a tile's arrival to its partial
# on the host
STREAM_STATS = {"tiles": 0, "bytes": 0, "staging_s": 0.0, "copy_ms": 0.0,
                "compute_ms": 0.0}

# a host column this large is registered in place (page-locked) rather
# than staged: glibc maps every allocation above 32 MiB on pages of its
# own, so two registrations never share a page
REGISTER_MIN_BYTES = 1 << 26


def _max_get_rows(node: L.LogicalNode) -> int:
    """Largest base-table row count anywhere under `node`."""
    if isinstance(node, L.Get):
        return node.table.num_rows
    best = 0
    for attr in ("child", "left", "right", "base", "recursive"):
        ch = getattr(node, attr, None)
        if isinstance(ch, L.LogicalNode):
            best = max(best, _max_get_rows(ch))
    return best


# join types whose probe rows aggregate independently per tile (build-side
# unmatched rows of RIGHT/FULL joins would double-count across tiles)
_STREAM_JOINS = ("inner", "left", "semi", "anti")


def find_tiled_pipeline(plan: L.LogicalNode, threshold: int):
    """Locate upper* -> Aggregate -> (Filter|Project|Join)* -> Get(big).

    Joins stream when the BIG table feeds the probe (left) side and the
    build side is small: each probe tile joins against the full build
    input independently.  Returns (upper, agg, lower, get)."""
    upper: List[L.LogicalNode] = []
    node = plan
    while isinstance(node, _UPPER):
        upper.append(node)
        node = node.child
    if not isinstance(node, L.Aggregate):
        return None
    agg = node
    for a in agg.aggs:
        if a.kind not in MERGEABLE or a.distinct:
            return None
    lower: List[L.LogicalNode] = []
    node = agg.child
    while True:
        if isinstance(node, _LOWER):
            lower.append(node)
            node = node.child
            continue
        if isinstance(node, L.Join) \
                and node.join_type in _STREAM_JOINS \
                and not getattr(node, "asof", False) \
                and _max_get_rows(node.left) > threshold \
                and _max_get_rows(node.right) <= threshold:
            lower.append(node)
            node = node.left
            continue
        break
    if not isinstance(node, L.Get):
        return None
    if node.table.num_rows <= threshold:
        return None
    return upper, agg, lower, node


def _partial_specs(agg: L.Aggregate):
    """Decompose aggregates into mergeable partials.

    Returns (partial_specs, merge_specs, final_exprs) where final_exprs
    reproduce the ORIGINAL agg output columns (positions after groups)
    from the merge-aggregate output.  A DECIMAL average is the promoted
    sum over the count: the promotion to DOUBLE already removes the
    scale (the reference divides by 10^scale once more, so its tiled
    average is 10^scale times too small)."""
    ng = len(agg.groups)
    partials: List[L.AggSpec] = []
    merges: List[L.AggSpec] = []
    finals: List[ir.Expr] = []

    def add(kind, arg, dtype, merge_kind):
        i = len(partials)
        partials.append(L.AggSpec(kind, arg, dtype, f"__p{i}"))
        mref = ir.ColRef(ng + i, dtype, f"__p{i}",
                         getattr(arg, "strdict", None)
                         if kind in ("min", "max") else None)
        merges.append(L.AggSpec(merge_kind, mref, dtype, f"__m{i}"))
        return ng + i    # column position in the merge-agg output

    for a in agg.aggs:
        if a.kind == "count_star":
            pos = add("count_star", None, T.BIGINT, "sum")
            finals.append(ir.ColRef(pos, T.BIGINT, a.name))
        elif a.kind == "count":
            pos = add("count", a.arg, T.BIGINT, "sum")
            finals.append(ir.ColRef(pos, T.BIGINT, a.name))
        elif a.kind in ("sum", "min", "max"):
            mk = a.kind if a.kind in ("min", "max") else "sum"
            pos = add(a.kind, a.arg, a.dtype, mk)
            ref = ir.ColRef(pos, a.dtype, a.name)
            ref.strdict = getattr(a.arg, "strdict", None) \
                if a.kind in ("min", "max") else None
            finals.append(ref)
        elif a.kind == "avg":
            at = a.arg.dtype
            if at.id == TypeId.DECIMAL:
                sdt = T.DECIMAL(18, at.scale)
            elif at.is_integer:
                sdt = T.HUGEINT
            else:
                sdt = T.DOUBLE
            spos = add("sum", a.arg, sdt, "sum")
            cpos = add("count", a.arg, T.BIGINT, "sum")
            s = ir.promote(ir.ColRef(spos, sdt, "__s"), T.DOUBLE)
            c = ir.promote(ir.ColRef(cpos, T.BIGINT, "__c"), T.DOUBLE)
            finals.append(ir.Arith("/", s, c, T.DOUBLE))
        else:                                    # pragma: no cover
            raise AssertionError(a.kind)
    return partials, merges, finals


def _tile_source(get: L.Get) -> Tuple[L.CTECell, L.LogicalNode]:
    """A mailbox standing for the table's scan, with its pushed filters."""
    cell = L.CTECell()
    node: L.LogicalNode = L.CTERef("__tile", get.schema, cell)
    if get.filters:
        node = L.Filter(node, ir.make_and(get.filters))
    return cell, node


def _rebuild(nodes, node: L.LogicalNode, join_left=False) -> L.LogicalNode:
    """Copies of `nodes` (outermost first) stacked on `node`."""
    for ln in reversed(nodes):
        n2 = copy.copy(ln)
        if join_left and isinstance(ln, L.Join):
            n2.left = node      # tile feeds the probe side
        else:
            n2.child = node
        node = n2
    return node


class _TiledPlan:
    """Plans built once for a tiled aggregation pipeline."""

    def __init__(self, plan, upper, agg, lower, get, tile_rows: int):
        self.get = get
        self.tile_rows = tile_rows
        self.cap = bucket_capacity(tile_rows)

        # tile subplan: Get replaced by a CTERef mailbox
        self.cell, node = _tile_source(get)
        node = _rebuild(lower, node, join_left=True)
        partials, merges, finals = _partial_specs(agg)
        self.tile_plan = L.Aggregate(node, agg.groups, partials,
                                     list(agg.group_names))

        # merge plan over the concatenated partials
        self.merge_cell = L.CTECell()
        pschema = self.tile_plan.schema
        merge_ref = L.CTERef("__partials", pschema, self.merge_cell)
        ng = len(agg.groups)
        groups2 = [ir.ColRef(i, f.dtype, f.name, f.strdict)
                   for i, f in enumerate(pschema.fields[:ng])]
        merge_agg = L.Aggregate(merge_ref, groups2, merges,
                                list(agg.group_names))
        proj_exprs = [ir.ColRef(i, f.dtype, f.name, f.strdict)
                      for i, f in enumerate(merge_agg.schema.fields[:ng])]
        proj_exprs += finals
        self.merge_plan = L.Project(merge_agg, proj_exprs,
                                    list(agg.schema.names), agg.schema)

        # plan above the aggregate, fed from a mailbox with agg's schema
        self.final_cell = L.CTECell()
        self.upper_plan = _rebuild(
            upper, L.CTERef("__agged", agg.schema, self.final_cell))


# ---------------------------------------------------------------------------
# moving tiles and partials between the host and the device
# ---------------------------------------------------------------------------

_REGISTERED = {}      # id(owning ndarray) -> its address


def _unregister(key, ptr):
    _REGISTERED.pop(key, None)
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _registered(a: np.ndarray) -> Optional[torch.Tensor]:
    """`a` as a CPU tensor over page-locked memory: its owning array is
    registered with cudaHostRegister once and unregistered when it is
    collected, unless it is page-locked already (a materialised result's
    column, `batch.to_pinned_numpy`).  None when the owner is under
    REGISTER_MIN_BYTES (such a column is staged).  Raises when the
    registration fails."""
    owner = a
    while isinstance(owner.base, np.ndarray):
        owner = owner.base
    if owner.nbytes < REGISTER_MIN_BYTES:
        return None
    key = id(owner)
    if key not in _REGISTERED and not torch.from_numpy(owner).is_pinned():
        ptr = owner.ctypes.data
        err = torch.cuda.cudart().cudaHostRegister(ptr, owner.nbytes, 0)
        if int(err) != 0:
            raise RuntimeError(f"cudaHostRegister of {owner.nbytes} bytes "
                               f"failed: {err}")
        _REGISTERED[key] = ptr
        weakref.finalize(owner, _unregister, key, ptr)
    return torch.from_numpy(a)


class _TileFeed:
    """Streams host columns onto `device` in tiles of `tile_rows` rows,
    each a Batch padded to `cap` slots (the last tile's padding zeroed).

    On CUDA every tile is copied from page-locked memory on a copy stream
    of its own, into one of two device buffers that alternate; the
    compute stream waits for the copy's event.  Tile k+1's copy is
    enqueued before tile k is handed out, so it runs while tile k
    computes.  A buffer is written again only two tiles later, after the
    caller has read the partial computed from it to the host: the caller
    must do so before it asks for the next tile.  On the CPU the tiles
    are copied in turn, without streams."""

    def __init__(self, arrays, nulls, n: int, tile_rows: int, cap: int,
                 device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.n, self.tile_rows, self.cap = n, tile_rows, cap
        self.arrays = [np.ascontiguousarray(a) for a in arrays]
        self.nulls = [None if m is None else np.ascontiguousarray(m, bool)
                      for m in nulls]
        # every host array to move: the data, then the NULL masks
        self.host = self.arrays + [m for m in self.nulls if m is not None]
        self.bufs = [[torch.empty(cap, dtype=torch_dtype(h.dtype),
                                  device=self.device) for h in self.host]
                     for _ in range(2)]
        self.sources = [None] * len(self.host)
        self.staging = None
        if self.cuda:
            self.sources = [_registered(h) for h in self.host]
            self.staging = [[None if src is not None else torch.empty(
                cap, dtype=torch_dtype(h.dtype), pin_memory=True)
                for h, src in zip(self.host, self.sources)]
                for _ in range(2)]
            self.stream = torch.cuda.Stream(self.device)
            self.ready = [torch.cuda.Event() for _ in range(2)]
            self.copy_events = []
        self.arange = torch.arange(cap, device=self.device)

    def _enqueue(self, k: int):
        """Copy tile k into buffer k % 2."""
        s = k % 2
        lo = k * self.tile_rows
        hi = min(lo + self.tile_rows, self.n)
        m = hi - lo
        t0 = time.perf_counter()
        parts = []
        for j, h in enumerate(self.host):
            if self.sources[j] is not None:
                parts.append(self.sources[j][lo:hi])
                continue
            part = torch.from_numpy(h[lo:hi])
            if self.cuda:
                part = self.staging[s][j][:m].copy_(part)
            parts.append(part)
        STREAM_STATS["staging_s"] += time.perf_counter() - t0
        STREAM_STATS["bytes"] += sum(p.numel() * p.element_size()
                                     for p in parts)
        STREAM_STATS["tiles"] += 1
        if not self.cuda:
            for buf, part in zip(self.bufs[s], parts):
                buf[:m].copy_(part)
                buf[m:].zero_()
            return
        with torch.cuda.stream(self.stream):
            start, end = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            start.record()
            for buf, part in zip(self.bufs[s], parts):
                if not part.is_pinned():
                    raise RuntimeError("a tile's host memory is not "
                                       "page-locked")
                buf[:m].copy_(part, non_blocking=True)
                if m < self.cap:
                    buf[m:].zero_()
            end.record()
            self.ready[s].record()
        self.copy_events.append((start, end))

    def _batch(self, k: int) -> Batch:
        s = k % 2
        lo = k * self.tile_rows
        m = min(lo + self.tile_rows, self.n) - lo
        bufs = iter(self.bufs[s])
        data = [next(bufs) for _ in self.arrays]
        cols = []
        for d, nm in zip(data, self.nulls):
            mask = next(bufs) if nm is not None else None
            # a tile without NULLs carries no mask, as the reference's
            # make_batch leaves it
            if mask is not None and not nm[lo:lo + m].any():
                mask = None
            cols.append(Column(d, mask))
        return Batch(tuple(cols), self.arange < m,
                     torch.full((), m, dtype=torch.int32,
                                device=self.device))

    def __iter__(self):
        ntiles = (self.n + self.tile_rows - 1) // self.tile_rows
        if ntiles == 0:
            return
        try:
            self._enqueue(0)
            for k in range(ntiles):
                if k + 1 < ntiles:
                    self._enqueue(k + 1)
                if not self.cuda:
                    yield self._batch(k)
                    continue
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(self.ready[k % 2])
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(cur)
                yield self._batch(k)
                end.record(cur)
                end.synchronize()
                STREAM_STATS["compute_ms"] += start.elapsed_time(end)
        finally:
            if self.cuda:
                self.stream.synchronize()
                STREAM_STATS["copy_ms"] += sum(
                    a.elapsed_time(b) for a, b in self.copy_events)


def _to_host(batch: Batch):
    """Live rows of a (small, compacted) partial batch on the host:
    (data, NULL masks, high limbs).  The live rows are picked on the
    device.  A wide column's high limb comes along (the reference reads
    its low word alone)."""
    idx = torch.nonzero(batch.sel).squeeze(1)
    data, nulls, his = [], [], []
    for c in batch.columns:
        data.append(to_numpy(c.data[idx]))
        nulls.append(None if c.nulls is None else to_numpy(c.nulls[idx]))
        his.append(None if c.hi is None else to_numpy(c.hi[idx]))
    return data, nulls, his


def _collect(parts, out):
    """Append one batch's (data, nulls, his) to per-column lists."""
    if out is None:
        return [[[x] for x in lists] for lists in parts]
    for acc, lists in zip(out, parts):
        for a, x in zip(acc, lists):
            a.append(x)
    return out


def _combine(out):
    """Concatenate collected parts: (data, nulls, his) per column.  A
    mask or high limb that some parts lack is filled: no NULL, or the
    high limb of the narrow int64 values."""
    data_l, null_l, hi_l = out
    data = [np.concatenate(ds) for ds in data_l]
    nulls, his = [], []
    for ds, ms, hs in zip(data_l, null_l, hi_l):
        nulls.append(np.concatenate(
            [m if m is not None else np.zeros(len(d), dtype=bool)
             for d, m in zip(ds, ms)])
            if any(m is not None for m in ms) else None)
        his.append(np.concatenate(
            [h if h is not None else d.astype(np.int64) >> 32
             for d, h in zip(ds, hs)])
            if any(h is not None for h in hs) else None)
    return data, nulls, his


def _upload(data, nulls, his, count, device) -> Batch:
    """make_batch, with the high limbs of wide columns."""
    b = make_batch(data, nulls, count, device=device)
    if all(h is None for h in his):
        return b
    cols = []
    for c, h in zip(b.columns, his):
        if h is not None:
            hi = torch.zeros(b.capacity, dtype=torch.int64, device=device)
            hi[:len(h)] = torch.from_numpy(h).to(device)
            c = c._replace(hi=hi)
        cols.append(c)
    return Batch(tuple(cols), b.sel, b.count)


def _stream(tp, get: L.Get, plan: L.LogicalNode, device):
    """Run `plan` over every tile of `get`'s table (fed through tp.cell);
    the per-column lists of the results' live rows, or None without
    tiles."""
    table = get.table
    cols = [table.columns[i] for i in get.column_indices]
    feed = _TileFeed([c.data for c in cols], [c.nulls for c in cols],
                     table.num_rows, tp.tile_rows, tp.cap, device)
    out = None
    try:
        for tile in feed:
            tp.cell.batch = tile
            _, res = physical.execute(plan, device)
            out = _collect(_to_host(res), out)
            del res
    finally:
        tp.cell.batch = None
    return out


def execute_tiled(plan: L.LogicalNode, config, device) -> Optional[
        Tuple[Schema, Batch]]:
    """Execute `plan` out-of-core if it matches a tiled shape; None if
    the plan is not tileable (the caller runs it in memory)."""
    threshold = int(config.get("external_threshold_rows"))
    found = find_tiled_pipeline(plan, threshold)
    if found is None:
        return None
    upper, agg, lower, get = found
    tp = getattr(plan, "_tiled_plan", None)
    if tp is None or tp.get is not get \
            or tp.tile_rows != int(config.get("tile_rows")):
        tp = _TiledPlan(plan, upper, agg, lower, get,
                        int(config.get("tile_rows")))
        plan._tiled_plan = tp

    parts = _stream(tp, get, tp.tile_plan, device)
    if parts is None:
        return None
    # combine partials -> merge aggregate -> original upper plan
    data, nulls, his = _combine(parts)
    total = len(data[0]) if data else 0
    tp.merge_cell.batch = _upload(data, nulls, his, total, device)
    try:
        _, mbatch = physical.execute(tp.merge_plan, device)
    finally:
        tp.merge_cell.batch = None
    tp.final_cell.batch = mbatch
    try:
        return physical.execute(tp.upper_plan, device)
    finally:
        tp.final_cell.batch = None


# ---------------------------------------------------------------------------
# out-of-core TopN: Limit -> Order -> (Filter|Project)* -> Get(big)
# (reference: external sort, src/common/sort/ + physical_top_n.cpp keeps a
# bounded heap; here per-tile TopN then a final TopN over <= tiles*k
# candidate rows)
# ---------------------------------------------------------------------------

def find_tiled_topn(plan: L.LogicalNode, threshold: int):
    node = plan
    if not isinstance(node, L.Limit) or node.limit is None:
        return None
    limit = node
    node = node.child
    if not isinstance(node, L.Order):
        return None
    order = node
    lower: List[L.LogicalNode] = []
    node = order.child
    while isinstance(node, _LOWER):
        lower.append(node)
        node = node.child
    if not isinstance(node, L.Get):
        return None
    if node.table.num_rows <= threshold:
        return None
    k = limit.limit + limit.offset
    if k >= node.table.num_rows:
        return None
    return limit, order, lower, node, k


class _TiledTopN:
    """Plans built once for a tiled TopN pipeline."""

    def __init__(self, limit: L.Limit, order: L.Order, lower, get,
                 tile_rows: int, k: int):
        self.get = get
        self.tile_rows = tile_rows
        self.cap = bucket_capacity(tile_rows)

        self.cell, node = _tile_source(get)
        node = _rebuild(lower, node)
        # per-tile candidates: top (limit+offset) under the same keys
        self.tile_plan = L.Limit(L.Order(node, order.keys), k, 0)
        self.row_schema = self.tile_plan.schema

        # final TopN over the concatenated candidates
        self.final_cell = L.CTECell()
        fnode: L.LogicalNode = L.CTERef("__cands", self.row_schema,
                                        self.final_cell)
        self.final_plan = L.Limit(L.Order(fnode, order.keys),
                                  limit.limit, limit.offset)


def execute_tiled_topn(plan: L.LogicalNode, config, device) -> Optional[
        Tuple[Schema, Batch]]:
    threshold = int(config.get("external_threshold_rows"))
    found = find_tiled_topn(plan, threshold)
    if found is None:
        return None
    limit, order, lower, get, k = found
    tp = getattr(plan, "_tiled_topn", None)
    if tp is None or tp.get is not get \
            or tp.tile_rows != int(config.get("tile_rows")):
        tp = _TiledTopN(limit, order, lower, get,
                        int(config.get("tile_rows")), k)
        plan._tiled_topn = tp

    cands = _stream(tp, get, tp.tile_plan, device)
    if cands is None:
        return None
    data, nulls, his = _combine(cands)
    total = len(data[0]) if data else 0
    tp.final_cell.batch = _upload(data, nulls, his, total, device)
    try:
        return physical.execute(tp.final_plan, device)
    finally:
        tp.final_cell.batch = None


# ---------------------------------------------------------------------------
# external full sort (reference: sorted-run spill + k-way merge,
# src/common/sorting/sorted_run.cpp + sorted_run_merger.hpp:22)
# ---------------------------------------------------------------------------

def find_tiled_sort(plan: L.LogicalNode, threshold: int):
    """Match [Project]* Order [Filter/Project]* Get over a big table."""
    upper: List[L.LogicalNode] = []
    node = plan
    while isinstance(node, L.Project):
        upper.append(node)
        node = node.child
    if not isinstance(node, L.Order):
        return None
    order = node
    lower: List[L.LogicalNode] = []
    node = order.child
    while isinstance(node, _LOWER):
        lower.append(node)
        node = node.child
    if not isinstance(node, L.Get):
        return None
    if node.table.num_rows <= threshold:
        return None
    return upper, order, lower, node


def _np_orderable(d: np.ndarray, dtype) -> np.ndarray:
    """Host port of ops/sortkey._orderable (same total order)."""
    if d.dtype == np.float32:
        bits = d.view(np.int32)
        return np.where(bits < 0, bits ^ np.int32(2**31 - 1), bits)
    if d.dtype == np.float64:
        bits = d.view(np.int64)
        return np.where(bits < 0, bits ^ np.int64(2**63 - 1), bits)
    if d.dtype == np.bool_:
        return d.astype(np.int32)
    return d


def _host_sort_perm(keys, order: L.Order) -> np.ndarray:
    """Stable permutation sorting host key columns per the ORDER BY spec
    (the merge phase of the external sort: the device produced the runs,
    the host, the spill tier, merges)."""
    ops = []
    for (d, nmask), k in zip(keys, order.keys):
        v = _np_orderable(np.asarray(d), k.expr.dtype)
        if k.desc:
            v = ~v if v.dtype.kind in "iu" else -v
        if nmask is not None:
            nullkey = np.where(nmask,
                               np.int32(1 if k.nulls_last else 0),
                               np.int32(0 if k.nulls_last else 1))
            v = np.where(nmask, np.zeros_like(v), v)
            ops.append(nullkey)
            ops.append(v)
        else:
            ops.append(v)
    return np.lexsort(tuple(reversed(ops)))


class _TiledSort:
    """Plans built once for an external full sort."""

    def __init__(self, upper, order: L.Order, lower, get,
                 tile_rows: int):
        self.get = get
        self.order = order
        self.tile_rows = tile_rows
        self.cap = bucket_capacity(tile_rows)

        # per-tile plan: lower ops + a projection emitting the ORDER BY
        # key columns FOLLOWED by every payload column
        self.cell, node = _tile_source(get)
        node = _rebuild(lower, node)
        base = node.schema
        key_exprs = [k.expr for k in order.keys]
        pay_exprs = [ir.ColRef(i, f.dtype, f.name, f.strdict)
                     for i, f in enumerate(base.fields)]
        names = [f"__k{i}" for i in range(len(key_exprs))] \
            + list(base.names)
        self.nkeys = len(key_exprs)
        self.tile_plan = L.Project(node, key_exprs + pay_exprs, names)
        self.out_schema = base

        # upper projections re-run tile-wise over the sorted rows
        self.final_cell = L.CTECell()
        self.final_plan = _rebuild(
            upper, L.CTERef("__sorted", base, self.final_cell))


def execute_tiled_sort(plan: L.LogicalNode, config, device) -> Optional[
        Tuple[Schema, Batch]]:
    """Out-of-core ORDER BY: the device scans/filters tiles and emits key +
    payload columns; the host holds the runs and merges (np.lexsort over
    the encoded keys); upper projections re-run tile-wise.  The full
    table never materializes in device memory."""
    threshold = int(config.get("external_threshold_rows"))
    found = find_tiled_sort(plan, threshold)
    if found is None:
        return None
    upper, order, lower, get = found
    tp = getattr(plan, "_tiled_sort", None)
    if tp is None or tp.get is not get \
            or tp.tile_rows != int(config.get("tile_rows")):
        tp = _TiledSort(upper, order, lower, get,
                        int(config.get("tile_rows")))
        plan._tiled_sort = tp

    runs = _stream(tp, get, tp.tile_plan, device)
    if runs is None:
        return None
    comb, combn, _ = _combine(runs)
    nk = tp.nkeys
    perm = _host_sort_perm(list(zip(comb[:nk], combn[:nk])), tp.order)
    sorted_data = [d[perm] for d in comb[nk:]]
    sorted_nulls = [m[perm] if m is not None else None
                    for m in combn[nk:]]
    total = len(perm)

    if not upper:
        return tp.out_schema, make_batch(sorted_data, sorted_nulls, total,
                                         device=device)

    # upper projections tile-wise (keeps device residency bounded)
    fschema = tp.final_plan.schema
    feed = _TileFeed(sorted_data, sorted_nulls, total, tp.tile_rows,
                     tp.cap, device)
    out = None
    try:
        for tile in feed:
            tp.final_cell.batch = tile
            _, fb = physical.execute(tp.final_plan, device)
            out = _collect(_to_host(fb), out)
            del fb
    finally:
        tp.final_cell.batch = None
    if out is None:
        # zero result rows: no tile ever ran the final projection
        zl = [np.zeros(0, dtype=f.dtype.np_dtype) for f in fschema.fields]
        return fschema, make_batch(zl, [None] * len(zl), 0, device=device)
    data, nulls, _ = _combine(out)
    return fschema, make_batch(data, nulls, len(data[0]), device=device)


# ---------------------------------------------------------------------------
# external (Grace-partitioned) equi-join: when the build side exceeds the
# TemporaryMemoryManager grant (or the external row threshold), both sides
# hash-partition to spill files and partition PAIRS join independently
# through the normal in-memory kernels.
# (reference: JoinHashTable external mode,
# src/execution/join_hashtable.cpp:609-735 radix partitioning +
# temporary_memory_manager.hpp:70 reservation arbitration)
# ---------------------------------------------------------------------------

_EXT_JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti")
# rough per-row working-set estimate for the build side (key + run index
# + payload slot ids), matching ops/join.py's sorted-build layout
_BUILD_BYTES_PER_ROW = 24

EXTERNAL_JOIN_STATS = {"joins": 0, "partitions": 0}


def _ext_join_eligible(node: L.LogicalNode) -> bool:
    return (isinstance(node, L.Join) and bool(node.conds)
            and node.range_cond is None and not node.asof
            and node.join_type in _EXT_JOIN_TYPES)


def _find_external_join(node: L.LogicalNode, threshold: int):
    """First eligible Join (top-down) whose build (right) side exceeds
    the external row threshold OR the TemporaryMemoryManager budget."""
    from ..storage import tempmem

    if isinstance(node, L.Materialize):
        return None
    if _ext_join_eligible(node):
        rows_r = _max_get_rows(node.right)
        budget = tempmem.MEMORY.budget_bytes
        over_budget = (budget is not None
                       and rows_r * _BUILD_BYTES_PER_ROW > budget
                       * tempmem.TemporaryMemoryManager
                       .MAXIMUM_FREE_MEMORY_RATIO)
        if rows_r > threshold or over_budget:
            return node
    for attr in ("child", "left", "right", "base", "recursive"):
        ch = getattr(node, attr, None)
        if isinstance(ch, L.LogicalNode):
            hit = _find_external_join(ch, threshold)
            if hit is not None:
                return hit
    return None


def _partition_ids(schema, batch, conds, side: str, nparts: int):
    """Host partition ids per capacity slot (-1 = dead row).  The hash
    is the reference's (ops/hashing.py), so every row lands in the
    reference's partition."""
    from ..ops import hashing

    ds, ns = physical._key_arrays(conds, batch, side)
    h = torch.zeros(batch.sel.shape[0], dtype=torch.int64,
                    device=batch.sel.device)
    for d, nm in zip(ds, ns):
        k = d.to(torch.int64)
        if nm is not None:
            k = torch.where(nm, -1, k)
        h = hashing.hash_combine(h, k)
    pid = hashing.partition_of(h, nparts)
    return to_numpy(torch.where(batch.sel, pid, -1))


def execute_external_join(plan: L.LogicalNode, config, device):
    """If the plan contains an oversized equi-join, execute that join as
    a Grace-partitioned external join (partitions spilled via
    TemporaryFileManager) and run the remaining plan over the spliced
    result.  Returns (schema, batch) or None if nothing qualifies."""
    try:
        threshold = int(config.get("external_threshold_rows"))
    except Exception:
        return None
    if threshold is None or threshold <= 0:
        return None
    node = _find_external_join(plan, threshold)
    if node is None:
        return None

    from ..storage import tempmem

    rows_r = _max_get_rows(node.right)
    est = rows_r * _BUILD_BYTES_PER_ROW
    grant = tempmem.MEMORY.reserve(est)
    try:
        if grant >= est and rows_r <= threshold:
            return None
        if grant > 0:
            nparts = int(np.ceil(est / grant))
        else:
            nparts = 8
        nparts = int(min(max(2, 1 << int(np.ceil(np.log2(
            max(nparts, 2))))), 64))

        lschema, lb = physical.execute(node.left, device)
        rschema, rb = physical.execute(node.right, device)
        pid_l = _partition_ids(lschema, lb, node.conds, "left", nparts)
        pid_r = _partition_ids(rschema, rb, node.conds, "right", nparts)

        def host_cols(batch):
            data = [to_numpy(c.data) for c in batch.columns]
            nulls = [to_numpy(c.nulls) if c.nulls is not None else None
                     for c in batch.columns]
            return data, nulls

        ldata, lnulls = host_cols(lb)
        rdata, rnulls = host_cols(rb)

        # spill every partition of both sides, then release the inputs
        tokens = []
        for p in range(nparts):
            li = np.nonzero(pid_l == p)[0]
            ri = np.nonzero(pid_r == p)[0]
            larrs = [d[li] for d in ldata] + \
                [(m[li] if m is not None else None) for m in lnulls]
            rarrs = [d[ri] for d in rdata] + \
                [(m[ri] if m is not None else None) for m in rnulls]
            tokens.append((tempmem.FILES.write(larrs), len(ldata),
                           tempmem.FILES.write(rarrs), len(rdata)))
        del ldata, lnulls, rdata, rnulls, lb, rb

        EXTERNAL_JOIN_STATS["joins"] += 1
        EXTERNAL_JOIN_STATS["partitions"] += nparts

        out = None
        for ltok, lw, rtok, rw in tokens:
            lraw = tempmem.FILES.read(ltok)
            rraw = tempmem.FILES.read(rtok)
            tempmem.FILES.delete(ltok)
            tempmem.FILES.delete(rtok)
            nl = len(lraw[0]) if lraw[0] is not None else 0
            nr = len(rraw[0]) if rraw[0] is not None else 0
            if nl == 0 and nr == 0:
                continue
            if nl == 0 and node.join_type in ("inner", "left", "semi",
                                              "anti"):
                continue
            if nr == 0 and node.join_type in ("inner", "semi"):
                continue
            lbp = make_batch(lraw[:lw], lraw[lw:], nl, device=device)
            rbp = make_batch(rraw[:rw], rraw[rw:], nr, device=device)
            sub = copy.copy(node)
            sub.left = physical.ConstBatch(lschema, lbp)
            sub.right = physical.ConstBatch(rschema, rbp)
            _, b2 = physical.execute(sub, device)
            out = _collect(_to_host(b2), out)
            del b2
        if out is None:
            # all partitions empty: typed empty result
            zl = [np.zeros(0, f.dtype.np_dtype)
                  for f in node.schema.fields]
            final = make_batch(zl, [None] * len(zl), 0, device=device)
        else:
            merged, mnulls, his = _combine(out)
            mnulls = [m if m is not None and m.any() else None
                      for m in mnulls]
            final = _upload(merged, mnulls, his, len(merged[0]), device)

        spliced = _replace_node(plan, node,
                                physical.ConstBatch(node.schema, final))
        return physical.execute(spliced, device)
    finally:
        tempmem.MEMORY.release(grant)


def _replace_node(plan: L.LogicalNode, target: L.LogicalNode,
                  replacement: L.LogicalNode) -> L.LogicalNode:
    if plan is target:
        return replacement
    new = copy.copy(plan)
    changed = False
    for attr in ("child", "left", "right", "base", "recursive"):
        ch = getattr(plan, attr, None)
        if isinstance(ch, L.LogicalNode):
            sub = _replace_node(ch, target, replacement)
            if sub is not ch:
                setattr(new, attr, sub)
                changed = True
    return new if changed else plan

"""Distributed relational operators over a mesh (PyTorch port of
ddb_tpu/parallel/dist.py).

Each operator goes local op -> hash exchange -> local op, over the local
kernels of ops/aggregate.py and ops/join.py:

  groupby:  local pre-aggregate (absorbs skew) -> exchange by key hash
            -> final local aggregate per shard
  join:     exchange both sides by key hash -> local sorted-probe join

The inputs are global tensors, split into the mesh's row shards as the
reference's `P("d")` in_specs split them; every output is the shards'
results stacked on the first shard's device, [n_shards, cap].
"""

from __future__ import annotations

import torch

from ..ops import aggregate as agg_ops
from ..ops import join as join_ops
from .exchange import exchange_by_key
from .mesh import AXIS, row_sharding


def _stacked(mesh, per_shard):
    """Per-shard result tuples -> one [n_shards, ...] tensor per field,
    on the mesh's first device."""
    dev = mesh.devices[0]
    return tuple(torch.stack([x.to(dev) for x in field])
                 for field in zip(*per_shard))


def dist_groupby_sum(mesh, keys, vals, valid, *, group_cap: int,
                     exchange_cap: int):
    """Distributed SELECT key, sum(val), count(*) GROUP BY key.

    keys/vals: [n_global] int64; valid: [n_global] bool.  Returns the
    per-shard group tables (gkey, gsum, gcount, gvalid, overflow), each
    [n_shards, group_cap] ([n_shards] for overflow)."""
    n_shards = mesh.shape[AXIS]
    ks, vs, sels = (row_sharding(mesh, t) for t in (keys, vals, valid))
    # 1. local pre-aggregate (sort + segment): absorbs key skew
    gk, gsum, gcnt, gsel = [], [], [], []
    for k, v, sel in zip(ks, vs, sels):
        payloads = [agg_ops.AggPayload("sum", v, None),
                    agg_ops.AggPayload("count_star", None, None)]
        gcols, aggs, s, _ = agg_ops.group_and_aggregate(
            [k], [(k, None)], payloads, sel, k.shape[0])
        gk.append(gcols[0][0])
        gsum.append(aggs[0][0])
        gcnt.append(aggs[1][0])
        gsel.append(s)
    # 2. exchange the partial groups by key hash
    ex, evalid, overflow = exchange_by_key(
        gk, [list(t) for t in zip(gk, gsum, gcnt)], gsel, n_shards,
        exchange_cap, mesh.devices)
    # 3. final aggregate of the partials
    out = []
    for (ek, esum, ecnt), ev, of in zip(ex, evalid, overflow):
        payloads = [agg_ops.AggPayload("sum", esum, None),
                    agg_ops.AggPayload("sum", ecnt, None)]
        gcols, aggs, s, _ = agg_ops.group_and_aggregate(
            [ek], [(ek, None)], payloads, ev, group_cap)
        out.append((gcols[0][0], aggs[0][0], aggs[1][0], s, of))
    return _stacked(mesh, out)


def _exchange_sides(mesh, lkey, lval, lvalid, rkey, rval, rvalid,
                    exchange_cap):
    """Both sides split into row shards and exchanged by key hash."""
    n_shards = mesh.shape[AXIS]
    sides = []
    for key, val, valid in ((lkey, lval, lvalid), (rkey, rval, rvalid)):
        ks, vs, sels = (row_sharding(mesh, t) for t in (key, val, valid))
        sides.append(exchange_by_key(ks, [list(t) for t in zip(ks, vs)],
                                     sels, n_shards, exchange_cap,
                                     mesh.devices))
    return sides


def _local_join(elk, elsel, erk, ersel, out_cap):
    bt = join_ops.build(erk, None, ersel)
    lo, cnt = join_ops.probe_ranges(bt, elk, None, elsel)
    pi, bpos, valid = join_ops.expand(lo, cnt, out_cap)
    return pi, bt.srow[bpos], valid


def dist_join_inner(mesh, lkey, lval, lvalid, rkey, rval, rvalid, *,
                    exchange_cap: int, out_cap: int):
    """Distributed inner equi-join: per-shard matched pairs (lkey, lval,
    rval, valid) of a fixed per-shard capacity, and the overflow."""
    (lx, lsel, lof), (rx, rsel, rof) = _exchange_sides(
        mesh, lkey, lval, lvalid, rkey, rval, rvalid, exchange_cap)
    out = []
    for (elk, elv), elsel, (erk, erv), ersel, a, b in zip(
            lx, lsel, rx, rsel, lof, rof):
        pi, brow, valid = _local_join(elk, elsel, erk, ersel, out_cap)
        out.append((elk[pi], elv[pi], erv[brow], valid, a + b))
    return _stacked(mesh, out)


def dist_join_groupby_step(mesh, *, lkey, lval, lvalid, rkey, rval, rvalid,
                           exchange_cap: int, out_cap: int, group_cap: int):
    """A distributed pipeline step: join two sharded relations on key,
    then group the join result by key and sum lval*rval (the shape of
    TPC-H Q3's join + aggregate)."""
    (lx, lsel, _), (rx, rsel, _) = _exchange_sides(
        mesh, lkey, lval, lvalid, rkey, rval, rvalid, exchange_cap)
    out = []
    for (elk, elv), elsel, (erk, erv), ersel in zip(lx, lsel, rx, rsel):
        pi, brow, valid = _local_join(elk, elsel, erk, ersel, out_cap)
        jk = elk[pi]
        # keys are already co-partitioned: the local group-by is final
        payloads = [agg_ops.AggPayload("sum", elv[pi] * erv[brow], None),
                    agg_ops.AggPayload("count_star", None, None)]
        gcols, aggs, gsel, _ = agg_ops.group_and_aggregate(
            [jk], [(jk, None)], payloads, valid, group_cap)
        out.append((gcols[0][0], aggs[0][0], aggs[1][0], gsel))
    return _stacked(mesh, out)

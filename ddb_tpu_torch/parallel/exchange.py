"""Hash-partition exchange between the shards of a mesh (PyTorch port of
ddb_tpu/parallel/exchange.py).

The reference runs these functions inside `shard_map`, one program per
shard, and moves rows with `lax.all_to_all`.  Here every function takes
per-shard lists (entry s belongs to shard s of the mesh) and is split at
its collective: each shard packs its send buffer, `all_to_all` hands
block j of every shard to shard j, and each shard reads what it received.

Protocol, the reference's (fixed shapes, one gather per array):
  1. per shard: pid = high-bits(hash64(key)) % n_shards
  2. a stable sort of the pids; torch has no sort that carries payloads,
     so each payload is gathered by the sort's permutation
  3. per-partition counts (binary searches in the sorted pids: no host
     read) and a [n_shards, cap] send buffer cut from the sorted rows;
     rows beyond cap count as overflow, which the caller reads once and
     retries with a larger cap
  4. the all-to-all: shard j receives block j of every shard, in source
     order, as [n_shards * cap] arrays
  5. the received validity mask says which slots hold rows

The reference pads the sorted arrays with `cap` zeros so that every
block's slice stays in bounds; here the block's row indices are clamped
to the last row instead.  The slots that differ are invalid either way.
Between shards on one device a payload block is gathered straight into
its slots of the receive buffer, so that no send buffer exists beside
it (four shards on one card hold every shard's buffers together);
between devices it is gathered on the source and moves with a
non-blocking copy.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import hashing


# ---- collectives over per-shard lists ----------------------------------------

def all_to_all(blocks, devices):
    """blocks[src][dst] -> recv[dst][src], each received block on shard
    dst's device (lax.all_to_all with tiled=False)."""
    n = len(blocks)
    return [[blocks[src][dst].to(devices[dst], non_blocking=True)
             for src in range(n)] for dst in range(n)]


def all_gather(values, devices):
    """One tensor per shard -> on every shard, all of them stacked in
    shard order (lax.all_gather)."""
    return [torch.stack([v.to(dev, non_blocking=True) for v in values])
            for dev in devices]


def psum(values, devices):
    """One tensor per shard -> their sum, on every shard (lax.psum)."""
    return [g.sum(0) for g in all_gather(values, devices)]


def axis_index(devices):
    """Every shard's position on the axis, on its device
    (lax.axis_index)."""
    return [torch.tensor(i, dtype=torch.int32, device=dev)
            for i, dev in enumerate(devices)]


# ---- the exchange ---------------------------------------------------------------

def partition_ids(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    return hashing.partition_of(hashing.hash64(key), n_shards)


class _SendPlan(NamedTuple):
    take: torch.Tensor        # [n_shards, cap] row of each send slot
    valid: torch.Tensor       # [n_shards, cap] bool, the slot holds a row
    overflow: torch.Tensor    # scalar int64, rows beyond cap


def _send_plan(valid: torch.Tensor, pid: torch.Tensor, n_shards: int,
               cap: int) -> _SendPlan:
    """One shard's send buffer layout: its live rows stably sorted by
    target shard, cut into per-target runs of at most cap rows."""
    n = valid.shape[0]
    dev = valid.device
    p = torch.where(valid, pid.to(torch.int32), n_shards)
    sp, perm = torch.sort(p, stable=True)
    targets = torch.arange(n_shards, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sp, targets)
    counts = torch.searchsorted(sp, targets, right=True) - starts
    overflow = torch.clamp(counts - cap, min=0).sum()
    slot = torch.arange(cap, dtype=torch.int64, device=dev)
    send_valid = slot[None, :] < torch.clamp(counts, max=cap)[:, None]
    idx = starts[:, None] + slot[None, :]
    take = perm[idx.clamp_(max=max(n - 1, 0))]
    if n < 2**31:
        take = take.to(torch.int32)
    return _SendPlan(take, send_valid, overflow)


def _route(arrays, plans, devices, cap):
    """One payload's exchange: block dst of shard src (its rows
    plans[src].take[dst]) lands in slots [src*cap, (src+1)*cap) of shard
    dst's receive buffer."""
    n = len(plans)
    out = [torch.empty(n * cap, dtype=arrays[0].dtype, device=dev)
           for dev in devices]
    for src, (a, pl) in enumerate(zip(arrays, plans)):
        for dst, dev in enumerate(devices):
            slot = out[dst][src * cap:(src + 1) * cap]
            if a.device == dev:
                torch.index_select(a, 0, pl.take[dst], out=slot)
            else:
                slot.copy_(torch.index_select(a, 0, pl.take[dst]),
                           non_blocking=True)
    return out


def all_to_all_exchange(arrays, valid, pid, n_shards: int, cap: int,
                        devices=None):
    """Route rows to their owning shard.

    arrays[s]: shard s's per-row payload arrays [n]; valid[s]: [n] live
    mask; pid[s]: [n] target shard ids.  Returns (out_arrays[s]: tuple of
    [n_shards*cap] arrays, out_valid[s], overflow[s])."""
    if devices is None:
        devices = [v.device for v in valid]
    plans = [_send_plan(v, p, n_shards, cap) for v, p in zip(valid, pid)]
    out_valid = [torch.cat(r) for r in all_to_all(
        [pl.valid for pl in plans], devices)]
    out = [[] for _ in plans]
    for j in range(len(arrays[0])):
        recv = _route([a[j] for a in arrays], plans, devices, cap)
        for s, r in enumerate(recv):
            out[s].append(r)
    return [tuple(o) for o in out], out_valid, [pl.overflow for pl in plans]


def exchange_by_key(key, arrays, valid, n_shards: int, cap: int,
                    devices=None):
    """Hash-partition every shard's rows by `key` across the shards."""
    pid = [partition_ids(k, n_shards) for k in key]
    return all_to_all_exchange(arrays, valid, pid, n_shards, cap, devices)


def all_to_all_exchange_2level(arrays, valid, pid, n_hosts: int,
                               n_chips: int, cap: int, devices=None):
    """Two-level shuffle over a (hosts x chips) mesh: rows reach global
    shard pid = host*n_chips + chip through

      phase A  an all-to-all among the chips of each host: every row
               moves to its target chip column, carrying its target host
      phase B  an all-to-all among the hosts of each chip column

    so that phase B moves each row across hosts once.  The per-shard
    lists are in the mesh's host-major order.  Returns (out_arrays[s]:
    tuple of [n_hosts*n_chips*cap] arrays, out_valid[s], overflow[s])."""
    g = n_hosts * n_chips
    if devices is None:
        devices = [v.device for v in valid]
    chip_t = [(p % n_chips).to(torch.int32) for p in pid]
    host_t = [torch.div(p, n_chips, rounding_mode="floor").to(torch.int32)
              for p in pid]
    outs_a, valid_a, ovf_a = [None] * g, [None] * g, [None] * g
    for h in range(n_hosts):
        ids = [h * n_chips + c for c in range(n_chips)]
        o, v, ov = all_to_all_exchange(
            [list(arrays[i]) + [host_t[i]] for i in ids],
            [valid[i] for i in ids], [chip_t[i] for i in ids], n_chips, cap,
            [devices[i] for i in ids])
        for k, i in enumerate(ids):
            outs_a[i], valid_a[i], ovf_a[i] = o[k], v[k], ov[k]
    outs_b, valid_b, ovf = [None] * g, [None] * g, [None] * g
    for c in range(n_chips):
        ids = [h * n_chips + c for h in range(n_hosts)]
        o, v, ov = all_to_all_exchange(
            [outs_a[i][:-1] for i in ids], [valid_a[i] for i in ids],
            [outs_a[i][-1] for i in ids], n_hosts, n_chips * cap,
            [devices[i] for i in ids])
        for k, i in enumerate(ids):
            outs_b[i], valid_b[i], ovf[i] = o[k], v[k], ovf_a[i] + ov[k]
    return outs_b, valid_b, ovf

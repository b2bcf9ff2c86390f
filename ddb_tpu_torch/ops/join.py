"""Equi-, range- and asof-join kernels: sorted build + binary-search probe.

PyTorch port of ddb_tpu/ops/join.py.  The contracts are the reference's:

  build   = stable sort of the build keys; `srow` maps a sorted slot to
            its original build row, `rstart`/`rend` give every slot its
            key run (the run-length index is the hash table)
  probe   = per probe row (lo, count): its key's run of sorted build
            slots; (0, 0) for rows with no match
  expand  = output j -> (probe row pi, build slot bpos), outputs ordered
            by probe row, then by slot (so by build row within a run)

The reference reaches these results with merge sorts and forward-fill
scans, because a TPU serializes scatters and XLA has no search
primitive.  Here the probe is `torch.searchsorted` into the sorted build
keys, `expand` is `repeat_interleave` (its extra memory is proportional
to the output), and `matched_build_mask` is a difference array plus one
scatter.  Positions are int64 tensors throughout (torch's index type);
the reference's are int32 with the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .order import sort_pass

_KEY_SENTINEL = 2**63 - 1   # invalid rows sort last, never match


class BuildTable(NamedTuple):
    skey: torch.Tensor      # [bcap] int64 keys, sorted, invalid = sentinel
    srow: torch.Tensor      # [bcap] int64 original row per sorted slot
    rstart: torch.Tensor    # [bcap] int64 run start (sorted slot) per slot
    rend: torch.Tensor      # [bcap] int64 run end (inclusive) per slot
    nbuild: torch.Tensor    # scalar int64 valid build rows


def _live(sel, null):
    return sel if null is None else (sel & ~null)


def _masked_key(key, live):
    return torch.where(live, key.to(torch.int64), _KEY_SENTINEL)


def build(key, key_null, sel) -> BuildTable:
    """Sort build keys; NULL keys never match (SQL equi-join)."""
    live = _live(sel, key_null)
    n = key.shape[0]
    skey, srow = sort_pass(_masked_key(key, live))
    if n == 0:
        return BuildTable(skey, srow, srow, srow,
                          live.sum(dtype=torch.int64))
    edge = skey[1:] != skey[:-1]
    one = torch.ones(1, dtype=torch.bool, device=key.device)
    is_start = torch.cat([one, edge])
    is_last = torch.cat([edge, one])
    # run r spans slots [starts[r], ends[r]]; a running count of the run
    # starts gives every slot its run.  (torch's cummax/cummin scans
    # would do, but are two orders slower on the card than cumsum.)
    run = torch.cumsum(is_start, 0) - 1
    rstart = torch.nonzero(is_start).squeeze(1)[run]
    rend = torch.nonzero(is_last).squeeze(1)[run]
    return BuildTable(skey, srow, rstart, rend,
                      live.sum(dtype=torch.int64))


def _probe_key(pkey, pkey_null, psel):
    """(masked int64 probe keys, rows that may match).  A live key equal
    to the sentinel never matches."""
    live = _live(psel, pkey_null)
    pk = _masked_key(pkey, live)
    return pk, live & (pk != _KEY_SENTINEL)


def probe_ranges(bt: BuildTable, pkey, pkey_null, psel):
    """Per probe row: (lo, count) of matching sorted build slots."""
    pk, ok = _probe_key(pkey, pkey_null, psel)
    nb = bt.skey.shape[0]
    if nb == 0:
        z = torch.zeros(pk.shape[0], dtype=torch.int64, device=pk.device)
        return z, z.clone()
    # the insertion point is the run start when the key is present
    lo = torch.searchsorted(bt.skey, pk).clamp_(max=nb - 1)
    match = ok & (bt.skey[lo] == pk)
    cnt = torch.where(match, bt.rend[lo] - lo + 1, 0)
    return torch.where(match, lo, 0), cnt


def range_probe(bt: BuildTable, pkey, pkey_null, psel, op: str):
    """Per probe row: (lo, count) of build slots with `probe <op> build`
    over ORDER-PRESERVING int64 keys (sortkey._orderable encodings).

    The build side is sorted, so every inequality match set is a
    contiguous prefix or suffix of the sorted build slots (reference:
    operator/join/physical_piecewise_merge_join.cpp).  A probe key's rank
    among the build keys comes from one binary search."""
    pk, ok = _probe_key(pkey, pkey_null, psel)
    nvalid = bt.nbuild
    if op in ("<", ">="):      # build rows with key <= v
        rank = torch.searchsorted(bt.skey, pk, right=True)
    elif op in ("<=", ">"):    # build rows with key < v
        rank = torch.searchsorted(bt.skey, pk)
    else:
        raise ValueError(f"range_probe op {op}")
    if op in ("<", "<="):      # suffix after the rank
        lo, cnt = rank, nvalid - rank
    else:                      # prefix below the rank
        lo, cnt = torch.zeros_like(rank), rank
    cnt = cnt.clamp(min=0)
    return torch.where(ok, lo, 0), torch.where(ok, cnt, 0)


def _lexsort(keys):
    """Permutation sorting by keys[0], then keys[1], ...; ties keep row
    order (stable sorts chained from the last key to the first)."""
    perm = sort_pass(keys[-1]).indices
    for k in reversed(keys[:-1]):
        perm = perm[sort_pass(k[perm]).indices]
    return perm


def asof_probe(rk, rt, r_live, lk, lt, l_live, strict: bool):
    """AsOf join: per probe row, the single LATEST build row with equal
    key and build-time <= probe-time (< if strict).  Keys are
    equality-preserving int64; times are ORDER-PRESERVING int64 encodings
    (pre-negate both sides to express >=-directional asof as <=).

    Reference: operator/join/physical_asof_join.cpp.  One combined
    (key, time) sort of build and probe rows; the build rows
    at-or-before a probe row in that order are counted, and the latest
    of them matches when it carries the probe's key.  Returns
    (BuildTable, lo, cnt) compatible with the generic expand/outer
    machinery (cnt in {0, 1})."""
    nb, npr = rk.shape[0], lk.shape[0]
    dev = rk.device
    bkey = _masked_key(rk, r_live)
    pkey = _masked_key(lk, l_live)
    rt, lt = rt.to(torch.int64), lt.to(torch.int64)

    # sorted-build srow (stable: same slot numbering as the merged sort)
    srow = _lexsort([bkey, rt])
    skey = bkey[srow]

    # inclusive: builds BEFORE probes at equal (key, time); strict: after
    btag = torch.full((nb,), int(strict), dtype=torch.int8, device=dev)
    ptag = torch.full((npr,), int(not strict), dtype=torch.int8, device=dev)
    mk = torch.cat([bkey, pkey])
    midx = _lexsort([mk, torch.cat([rt, lt]), torch.cat([btag, ptag])])
    mk = mk[midx]
    is_build = midx < nb
    # the latest build row at-or-before each row is the nbuilds-th build
    # row of the merged order: a gather, where a running max would scan
    nbuilds = torch.cumsum(is_build, 0)                 # at-or-before, incl
    fk = mk[torch.nonzero(is_build).squeeze(1)][(nbuilds - 1).clamp(min=0)]
    found_m = (nbuilds > 0) & (fk == mk) & (mk != _KEY_SENTINEL)

    lo_all = torch.empty(nb + npr, dtype=torch.int64, device=dev)
    lo_all[midx] = (nbuilds - 1).clamp_(min=0)
    f_all = torch.empty(nb + npr, dtype=torch.bool, device=dev)
    f_all[midx] = found_m
    zeros = torch.zeros(nb, dtype=torch.int64, device=dev)
    bt = BuildTable(skey, srow, zeros, zeros, r_live.sum(dtype=torch.int64))
    return bt, lo_all[nb:], (f_all[nb:] & l_live).to(torch.int64)


def match_total(count):
    return count.sum(dtype=torch.int64)


def expand(lo, count, out_cap: int):
    """Flatten match ranges: output j -> (probe row pi, build slot bpos),
    padded to out_cap with `valid` false (the first out_cap matches when
    there are more).  Reads the match total on the host."""
    n = count.shape[0]
    dev = count.device
    count = count.to(torch.int64)
    cum = torch.cumsum(count, 0)                        # inclusive
    total = int(cum[-1]) if n else 0
    pi = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=dev), count,
        output_size=total)[:out_cap]
    m = pi.shape[0]
    j = torch.arange(m, dtype=torch.int64, device=dev)
    # probe row i owns outputs [cum[i] - count[i], cum[i])
    bpos = lo.to(torch.int64)[pi] + (j - (cum - count)[pi])
    pad = torch.zeros(out_cap - m, dtype=torch.int64, device=dev)
    valid = torch.arange(out_cap, dtype=torch.int64, device=dev) < total
    return torch.cat([pi, pad]), torch.cat([bpos, pad]), valid


def matched_build_mask(bt: BuildTable, lo, count, cap_build: int):
    """bool[cap_build] -- which ORIGINAL build rows had >=1 probe match.
    (RIGHT/FULL joins; reference tracks found_match flags,
    join_hashtable.hpp:70-118.)

    A sorted build slot s is covered iff some probe range [lo, lo+cnt)
    contains it: (#starts <= s) > (#ends <= s), a running sum over a
    difference array.  One scatter maps slots back to build rows."""
    n = bt.skey.shape[0]
    dev = bt.skey.device
    has = (count > 0).to(torch.int64)
    lo = lo.to(torch.int64)
    delta = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    delta.index_add_(0, torch.where(count > 0, lo, n), has)
    delta.index_add_(0, torch.where(count > 0, lo + count, n), -has)
    covered = torch.cumsum(delta[:n], 0) > 0
    out = torch.zeros(n, dtype=torch.bool, device=dev)
    out[bt.srow] = covered
    return out[:cap_build]

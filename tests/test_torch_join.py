"""The port's join operators (ddb_tpu_torch/ops/join.py) against the
reference package's (ddb_tpu/ops/join.py): the same numpy inputs, made
from a seed, go through both.  Every result is an integer or a mask and
must match exactly, position by position: the sorted keys, the slot to
build-row map, the run bounds, (lo, count) per probe row, the expansion's
(probe row, build slot, valid) and the matched-build mask.  The port's
positions are int64 where the reference's are int32; values are compared.

The cases mirror tests/test_join_kernels.py (duplicates on both sides,
NULL keys, dead rows) and add empty sides, a key equal to the sentinel
and an out_cap above and below the match total."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddb_tpu import types as JT
from ddb_tpu.batch import Batch as JBatch, Column as JColumn
from ddb_tpu.ops import join as JJ
from ddb_tpu.plan import physical as JP
from test_torch_reference_jit import (fast_reference_compiles,  # noqa: F401
                                      jitted_module)
from ddb_tpu_torch import types as TT
from ddb_tpu_torch.batch import Batch as TBatch, Column as TColumn
from ddb_tpu_torch.ops import join as TJ
from ddb_tpu_torch.plan import physical as TP

# the reference's operators under jax.jit (test_torch_reference_jit.py)
JJ = jitted_module(JJ)

SENTINEL = 2**63 - 1


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _sides(seed, nb=None, npr=None, nkeys=30):
    rng = np.random.default_rng(seed)
    if nb is None:
        nb, npr = rng.integers(3, 200, 2)
    return dict(
        bk=rng.integers(0, nkeys, nb).astype(np.int64),
        bsel=rng.random(nb) > 0.2, bnull=rng.random(nb) > 0.8,
        pk=rng.integers(0, nkeys, npr).astype(np.int64),
        psel=rng.random(npr) > 0.2, pnull=rng.random(npr) > 0.8)


def _edge(name):
    z = np.zeros(0, dtype=np.int64)
    zb = np.zeros(0, dtype=bool)
    one = dict(bk=np.array([5, 5, 7], dtype=np.int64),
               bsel=np.ones(3, bool), bnull=None,
               pk=np.array([5, 6, 7, 5], dtype=np.int64),
               psel=np.ones(4, bool), pnull=None)
    if name == "no_null_masks":
        return one
    if name == "empty_build":
        return dict(one, bk=z, bsel=zb)
    if name == "empty_probe":
        return dict(one, pk=z, psel=zb)
    if name == "all_dead":
        return dict(one, bsel=np.zeros(3, bool))
    if name == "sentinel_key":
        # a live key equal to the sentinel never matches, on either side
        return dict(one, bk=np.array([SENTINEL, 5, SENTINEL], np.int64),
                    pk=np.array([SENTINEL, 5, 4, SENTINEL], np.int64))
    if name == "negative_keys":
        return dict(one, bk=np.array([-3, -2**62, 0], np.int64),
                    pk=np.array([0, -3, -2**62, -1], np.int64))
    raise KeyError(name)


SEEDS = [7, 11, 23]
EDGES = ["no_null_masks", "empty_build", "empty_probe", "all_dead",
         "sentinel_key", "negative_keys"]
CASES = [(f"seed{s}", _sides(s)) for s in SEEDS] \
    + [("one_key", _sides(5, 64, 64, nkeys=1)),
       ("unique_keys", _sides(6, 40, 90, nkeys=10**6))] \
    + [(e, _edge(e)) for e in EDGES]
IDS = [c[0] for c in CASES]


def _builds(c):
    return (JJ.build(_j(c["bk"]), _j(c["bnull"]), _j(c["bsel"])),
            TJ.build(_t(c["bk"]), _t(c["bnull"]), _t(c["bsel"])))


def _same_build(got, want):
    for field in ("skey", "srow", "rstart", "rend"):
        _same(getattr(got, field), getattr(want, field))
    assert int(got.nbuild) == int(want.nbuild)


# the reference's build takes no empty side (its executors never give it
# one: capacities are at least 1); the port's is tested on its own below
NONEMPTY = [(n, c) for n, c in CASES if c["bk"].shape[0]]
NONEMPTY_IDS = [c[0] for c in NONEMPTY]


@pytest.mark.parametrize("name,c", NONEMPTY, ids=NONEMPTY_IDS)
def test_build(name, c):
    want, got = _builds(c)
    _same_build(got, want)


@pytest.mark.parametrize("name,c", NONEMPTY, ids=NONEMPTY_IDS)
def test_probe_ranges(name, c):
    jbt, tbt = _builds(c)
    want = JJ.probe_ranges(jbt, _j(c["pk"]), _j(c["pnull"]), _j(c["psel"]))
    got = TJ.probe_ranges(tbt, _t(c["pk"]), _t(c["pnull"]), _t(c["psel"]))
    _same(got[0], want[0])
    _same(got[1], want[1])


def test_probe_ranges_against_brute_force():
    c = _sides(3, 150, 170)
    _, tbt = _builds(c)
    lo, cnt = (_np(x) for x in TJ.probe_ranges(
        tbt, _t(c["pk"]), _t(c["pnull"]), _t(c["psel"])))
    skey, srow = _np(tbt.skey), _np(tbt.srow)
    blive = c["bsel"] & ~c["bnull"]
    for i in range(len(lo)):
        if not c["psel"][i] or c["pnull"][i]:
            assert (lo[i], cnt[i]) == (0, 0)
            continue
        rows = np.flatnonzero((c["bk"] == c["pk"][i]) & blive)
        assert cnt[i] == len(rows)
        if len(rows):
            # a run's slots are in ascending build-row order
            assert list(srow[lo[i]:lo[i] + cnt[i]]) == list(rows)
            assert (skey[lo[i]:lo[i] + cnt[i]] == c["pk"][i]).all()
        else:
            assert lo[i] == 0


def test_empty_build_side_matches_nothing():
    c = _edge("empty_build")
    tbt = TJ.build(_t(c["bk"]), None, _t(c["bsel"]))
    assert int(tbt.nbuild) == 0 and tbt.skey.shape[0] == 0
    lo, cnt = TJ.probe_ranges(tbt, _t(c["pk"]), None, _t(c["psel"]))
    assert not lo.any() and not cnt.any() and lo.shape[0] == 4


@pytest.mark.parametrize("op", ["<", "<=", ">", ">="])
@pytest.mark.parametrize("name,c", NONEMPTY, ids=NONEMPTY_IDS)
def test_range_probe(name, c, op):
    jbt, tbt = _builds(c)
    want = JJ.range_probe(jbt, _j(c["pk"]), _j(c["pnull"]), _j(c["psel"]),
                          op)
    got = TJ.range_probe(tbt, _t(c["pk"]), _t(c["pnull"]), _t(c["psel"]),
                         op)
    _same(got[0], want[0])
    _same(got[1], want[1])


def test_range_probe_rejects_other_operators():
    _, tbt = _builds(_edge("no_null_masks"))
    with pytest.raises(ValueError):
        TJ.range_probe(tbt, torch.zeros(1, dtype=torch.int64), None,
                       torch.ones(1, dtype=torch.bool), "=")


def _asof_inputs(seed, nb=None, npr=None):
    rng = np.random.default_rng(seed)
    if nb is None:
        nb, npr = rng.integers(3, 150, 2)
    return dict(rk=rng.integers(0, 10, nb).astype(np.int64),
                rt=rng.integers(0, 50, nb).astype(np.int64),
                rlive=rng.random(nb) > 0.2,
                lk=rng.integers(0, 10, npr).astype(np.int64),
                lt=rng.integers(0, 50, npr).astype(np.int64),
                llive=rng.random(npr) > 0.2)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("seed", [3, 19, 31])
def test_asof_probe(seed, strict):
    a = _asof_inputs(seed)
    jbt, jlo, jf = JJ.asof_probe(*(_j(a[k]) for k in a), strict)
    tbt, tlo, tf = TJ.asof_probe(*(_t(a[k]) for k in a), strict)
    _same(tbt.skey, jbt.skey)
    _same(tbt.srow, jbt.srow)
    assert int(tbt.nbuild) == int(jbt.nbuild)
    _same(tf, jf)
    # lo names a slot only where a match was found
    found = _np(jf) > 0
    _same(_np(tlo)[found], _np(jlo)[found])
    assert ((_np(tlo) >= 0) & (_np(tlo) < max(len(a["rk"]), 1))).all()


@pytest.mark.parametrize("strict", [False, True])
def test_asof_probe_against_brute_force(strict):
    # many ties in (key, time): strictness decides them
    a = _asof_inputs(2, 120, 140)
    a["rt"] //= 8
    a["lt"] //= 8
    tbt, lo, found = TJ.asof_probe(*(_t(a[k]) for k in a), strict)
    lo, found, srow = _np(lo), _np(found), _np(tbt.srow)
    for i in range(len(lo)):
        mask = a["rlive"] & (a["rk"] == a["lk"][i]) & (
            (a["rt"] < a["lt"][i]) if strict else (a["rt"] <= a["lt"][i]))
        if not a["llive"][i] or not mask.any():
            assert not found[i]
            continue
        assert found[i] == 1
        got = srow[lo[i]]
        assert mask[got] and a["rt"][got] == a["rt"][mask].max()


def _ranges(seed, n=60, top=5):
    """(lo, count) as a probe would give them: counts with many zeros."""
    c = _sides(seed, 80, n, nkeys=12)
    _, tbt = _builds(c)
    lo, cnt = TJ.probe_ranges(tbt, _t(c["pk"]), _t(c["pnull"]),
                              _t(c["psel"]))
    return c, _np(lo), _np(cnt)


@pytest.mark.parametrize("slack", [0, 3, 64, -5],
                         ids=["exact", "plus3", "plus64", "cut_short"])
@pytest.mark.parametrize("seed", [1, 2])
def test_expand(seed, slack):
    _, lo, cnt = _ranges(seed)
    cap = max(int(cnt.sum()) + slack, 1)
    want = JJ.expand(jnp.asarray(lo.astype(np.int32)),
                     jnp.asarray(cnt.astype(np.int32)), cap)
    got = TJ.expand(_t(lo), _t(cnt), cap)
    for g, w in zip(got, want):
        _same(g, w)
    assert int(TJ.match_total(_t(cnt))) == int(JJ.match_total(
        jnp.asarray(cnt))) == int(cnt.sum())


def test_expand_orders_outputs_by_probe_row_then_slot():
    lo = np.array([4, 0, 0, 1], dtype=np.int64)
    cnt = np.array([2, 0, 3, 1], dtype=np.int64)
    pi, bpos, valid = (_np(x) for x in TJ.expand(_t(lo), _t(cnt), 8))
    assert list(pi) == [0, 0, 2, 2, 2, 3, 0, 0]
    assert list(bpos) == [4, 5, 0, 1, 2, 1, 0, 0]
    assert list(valid) == [True] * 6 + [False] * 2


def test_expand_of_no_matches():
    pi, bpos, valid = TJ.expand(torch.zeros(5, dtype=torch.int64),
                                torch.zeros(5, dtype=torch.int64), 4)
    assert not valid.any() and pi.shape[0] == bpos.shape[0] == 4
    want = JJ.expand(jnp.zeros(5, jnp.int32), jnp.zeros(5, jnp.int32), 4)
    for g, w in zip((pi, bpos, valid), want):
        _same(g, w)


@pytest.mark.parametrize("seed", [1, 2, 9])
def test_matched_build_mask(seed):
    c, lo, cnt = _ranges(seed)
    jbt, tbt = _builds(c)
    nb = len(c["bk"])
    for cap in (nb, nb - 7):
        want = JJ.matched_build_mask(jbt, jnp.asarray(lo.astype(np.int32)),
                                     jnp.asarray(cnt.astype(np.int32)), cap)
        got = TJ.matched_build_mask(tbt, _t(lo), _t(cnt), cap)
        _same(got, want)
    # brute force: a live build row is matched when a live probe row has
    # its key
    plive = c["psel"] & ~c["pnull"]
    blive = c["bsel"] & ~c["bnull"]
    exp = blive & np.isin(c["bk"], c["pk"][plive])
    assert np.array_equal(_np(TJ.matched_build_mask(tbt, _t(lo), _t(cnt),
                                                    nb)), exp)


def test_matched_build_mask_with_overlapping_ranges():
    # range joins give overlapping prefixes and suffixes
    c = _sides(4, 50, 40, nkeys=20)
    jbt, tbt = _builds(c)
    for op in ("<", ">="):
        jlo, jcnt = JJ.range_probe(jbt, _j(c["pk"]), _j(c["pnull"]),
                                   _j(c["psel"]), op)
        tlo, tcnt = TJ.range_probe(tbt, _t(c["pk"]), _t(c["pnull"]),
                                   _t(c["psel"]), op)
        _same(TJ.matched_build_mask(tbt, tlo, tcnt, 50),
              JJ.matched_build_mask(jbt, jlo, jcnt, 50))


# ---- the executor's helpers that line up one to one -----------------------

def _batches(seed, cap=64):
    rng = np.random.default_rng(seed)
    sel = rng.random(cap) < 0.4
    a = rng.integers(-50, 50, cap).astype(np.int64)
    b = rng.normal(size=cap)
    bn = rng.random(cap) < 0.3
    jb = JBatch((JColumn(jnp.asarray(a), None),
                 JColumn(jnp.asarray(b), jnp.asarray(bn))),
                jnp.asarray(sel), jnp.int32(sel.sum()))
    tb = TBatch((TColumn(_t(a), None), TColumn(_t(b), _t(bn))), _t(sel),
                torch.tensor(int(sel.sum()), dtype=torch.int32))
    return jb, tb, int(sel.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_compact(seed):
    jb, tb, live = _batches(seed)
    for cap in (64, 32):
        assert live <= cap
        want, got = JP._compact(jb, cap), TP._compact(tb, cap)
        _same(got.sel, want.sel)
        keep = _np(want.sel)
        assert keep.sum() == live and keep[:live].all()
        for g, w in zip(got.columns, want.columns):
            assert _np(g.data).shape == _np(w.data).shape
            assert np.array_equal(_np(g.data)[keep], _np(w.data)[keep])
            assert (g.nulls is None) == (w.nulls is None)
            if w.nulls is not None:
                assert np.array_equal(_np(g.nulls)[keep], _np(w.nulls)[keep])


def test_joinable_int64_floats():
    x = np.array([0.0, -0.0, 1.5, -1.5, np.inf, np.nan, 1e-300])
    want = JP._joinable_int64(jnp.asarray(x), JT.DOUBLE)
    got = TP._joinable_int64(_t(x), TT.DOUBLE)
    _same(got, want)
    assert _np(got)[0] == _np(got)[1] == 0        # -0.0 joins 0.0
    f = x.astype(np.float32)
    _same(TP._joinable_int64(_t(f), TT.FLOAT),
          JP._joinable_int64(jnp.asarray(f), JT.FLOAT))
    i = np.array([-3, 7], dtype=np.int32)
    _same(TP._joinable_int64(_t(i), TT.INTEGER),
          JP._joinable_int64(jnp.asarray(i), JT.INTEGER))


@pytest.mark.parametrize("seed", [0, 5])
def test_densify_keys(seed):
    """Ids need not be the reference's numbers: they must be equal exactly
    when all keys are equal, on both sides, and -1 for dead rows."""
    rng = np.random.default_rng(seed)
    nl, nr = 70, 50
    lds = [rng.integers(0, 4, nl).astype(np.int64),
           rng.integers(-2, 2, nl).astype(np.int64)]
    rds = [rng.integers(0, 4, nr).astype(np.int64),
           rng.integers(-2, 2, nr).astype(np.int64)]
    ll, rl = rng.random(nl) < 0.8, rng.random(nr) < 0.8
    wl, wr = JP._densify_keys([_j(d) for d in lds], _j(ll),
                              [_j(d) for d in rds], _j(rl))
    gl, gr = TP._densify_keys([_t(d) for d in lds], _t(ll),
                              [_t(d) for d in rds], _t(rl))
    got = np.concatenate([_np(gl), _np(gr)])
    want = np.concatenate([_np(wl), _np(wr)])
    live = np.concatenate([ll, rl])
    assert (got[~live] == -1).all() and (want[~live] == -1).all()
    assert (got[live] >= 0).all()
    keys = list(zip(np.concatenate([lds[0], rds[0]]),
                    np.concatenate([lds[1], rds[1]])))
    seen = {}
    for k, g, w, ok in zip(keys, got, want, live):
        if ok:
            assert seen.setdefault(k, (g, w)) == (g, w)
    assert len({g for g, _ in seen.values()}) == len(seen)
    assert len({w for _, w in seen.values()}) == len(seen)

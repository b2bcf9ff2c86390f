"""The DISTINCT, holistic and bit aggregates of ddb_tpu_torch.ops.aggregate
against their counterparts in ddb_tpu.ops.aggregate on the same
numpy-seeded inputs (NULLs, dead rows, a group whose payload is all NULL,
ties), and their SQL forms through both packages' connect().

Integers, dates, strings and NULLs must match exactly.  Floats (avg,
quantile_cont, entropy, float sums) are held to 1e-12 relative: the two
packages add in different orders.  Entropy near zero is a difference of
two logarithms, so it also gets 1e-12 absolute."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu import types as RT
from ddb_tpu.ops import aggregate as ragg
from ddb_tpu.ops import sortkey as rsk
from test_torch_reference_jit import (fast_reference_compiles,  # noqa: F401
                                      jitted_module)
from ddb_tpu_torch import types as PT
from ddb_tpu_torch.bench import window_cases
from ddb_tpu_torch.ops import aggregate as pagg
from ddb_tpu_torch.ops import sortkey as psk

# the reference's operators under jax.jit (test_torch_reference_jit.py)
ragg = jitted_module(ragg, eager=("group_quantile", "ungrouped_quantile"))

RTOL = 1e-12
CAP = 256


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


class Inputs:
    """Two group keys (the second with NULLs), payloads with NULLs and
    ties, dead rows, and one group (k1 == 3) whose payloads are all
    NULL."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.sel = rng.random(CAP) < 0.8
        self.k1 = rng.integers(0, 5, CAP).astype(np.int32)
        self.k2 = rng.integers(0, 3, CAP).astype(np.int32)
        self.k2_nulls = rng.random(CAP) < 0.1
        self.ints = rng.integers(-5, 6, CAP).astype(np.int32)
        self.floats = rng.choice([-2.5, -0.0, 0.0, 1.25, 3.5, 1e9, 7.0],
                                 CAP)
        self.nulls = (rng.random(CAP) < 0.2) | (self.k1 == 3)
        # BY key with ties and NULLs; the payload and its NULL mask are
        # functions of it, so rows tied on the BY key carry equal payloads
        self.by = rng.integers(0, 8, CAP).astype(np.int32)
        self.by_nulls = rng.random(CAP) < 0.15
        self.by_payload = (self.by * 3 + 1).astype(np.int32)
        self.by_payload_nulls = self.by % 4 == 1

    def ops(self, sk, types, conv):
        """(key_ops, key_data) with one package's sortkey module."""
        key_ops = sk.encode_key(conv(self.k1), None, types.INTEGER) \
            + sk.encode_key(conv(self.k2), conv(self.k2_nulls),
                            types.INTEGER)
        return key_ops, [(conv(self.k1), None),
                         (conv(self.k2), conv(self.k2_nulls))]

    def value(self, sk, types, conv, data, nulls, desc=False):
        dt = types.DOUBLE if data.dtype.kind == "f" else types.INTEGER
        return sk.encode_key(conv(data), conv(nulls), dt, desc=desc)


@pytest.fixture(scope="module")
def inp():
    return Inputs()


def _both(inp, data, nulls):
    """Per package: (key_ops, value_ops, payload arrays, sel)."""
    out = []
    for sk, types, conv in ((rsk, RT, _j), (psk, PT, _t)):
        key_ops, _ = inp.ops(sk, types, conv)
        out.append((key_ops, inp.value(sk, types, conv, data, nulls),
                    conv(data), conv(nulls), conv(inp.sel)))
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, atol=0.0):
    """(data, isnull) of the port against the reference: NULL masks
    equal, data equal where not NULL (floats to RTOL)."""
    (gd, gn), (wd, wn) = got, want
    assert (gn is None) == (wn is None)
    live = np.ones(np.shape(_np(gd if not isinstance(gd, tuple) else gd[0])),
                   dtype=bool)
    if gn is not None:
        assert np.array_equal(_np(gn), _np(wn))
        live = ~_np(gn)
    if isinstance(wd, tuple):
        assert all(np.array_equal(_np(g)[live], _np(w)[live])
                   for g, w in zip(gd, wd))
        return
    g, w = _np(gd), _np(wd)
    assert g.dtype == w.dtype and g.shape == w.shape
    if g.dtype.kind == "f":
        np.testing.assert_allclose(g[live], w[live], rtol=RTOL, atol=atol)
    else:
        assert np.array_equal(g[live], w[live])


def _payload(mod, kind, data, nulls):
    return mod.AggPayload(kind, data, nulls)


# ---- DISTINCT ---------------------------------------------------------------

@pytest.mark.parametrize("kind,floats", [
    ("count", False), ("sum", False), ("avg", False), ("product", False),
    ("sum_wide", False), ("avg_wide", False), ("count", True),
    ("sum_float", True), ("avg", True)])
@pytest.mark.parametrize("ncap", [CAP, 64])
def test_group_distinct_aggregate(inp, kind, floats, ncap):
    data = inp.floats if floats else inp.ints
    (rk, rv, rd, rn, rs), (pk, pv, pd, pn, ps) = _both(inp, data, inp.nulls)
    want = ragg.group_distinct_aggregate(rk, rv, _payload(ragg, kind, rd, rn),
                                         rs, ncap)
    got = pagg.group_distinct_aggregate(pk, pv, _payload(pagg, kind, pd, pn),
                                        ps, ncap)
    _same(got, want)


@pytest.mark.parametrize("kind,floats", [
    ("count", False), ("sum", False), ("avg", False), ("product", False),
    ("sum_wide", False), ("avg_wide", False), ("sum_float", True)])
def test_ungrouped_distinct(inp, kind, floats):
    data = inp.floats if floats else inp.ints
    (_, rv, rd, rn, rs), (_, pv, pd, pn, ps) = _both(inp, data, inp.nulls)
    _same(pagg.ungrouped_distinct(pv, _payload(pagg, kind, pd, pn), ps),
          ragg.ungrouped_distinct(rv, _payload(ragg, kind, rd, rn), rs))


def test_distinct_of_unknown_kind_raises(inp):
    (_, _, _, _, _), (pk, pv, pd, pn, ps) = _both(inp, inp.ints, inp.nulls)
    with pytest.raises(NotImplementedError, match="distinct min"):
        pagg.group_distinct_aggregate(pk, pv, _payload(pagg, "min", pd, pn),
                                      ps, CAP)


# ---- quantile ---------------------------------------------------------------

@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("floats", [True, False])
def test_group_quantile(inp, q, interpolate, floats):
    data = inp.floats if floats else inp.ints
    (rk, rv, rd, rn, rs), (pk, pv, pd, pn, ps) = _both(inp, data, inp.nulls)
    want = ragg.group_quantile(rk, rv, _payload(ragg, "quantile", rd, rn), q,
                               rs, CAP, interpolate)
    got = pagg.group_quantile(pk, pv, _payload(pagg, "quantile", pd, pn), q,
                              ps, CAP, interpolate)
    _same(got, want)
    # the all-NULL group keeps its slot: NULL, and groups after it live
    nulls = _np(got[1])
    ngroups = len({(a, b if not n else None) for a, b, n, s in zip(
        inp.k1, inp.k2, inp.k2_nulls, inp.sel) if s})
    assert nulls[:ngroups].sum() >= 1 and not nulls[:ngroups].all()
    assert nulls[ngroups:].all()


@pytest.mark.parametrize("q", [0.0, 0.5, 0.77])
@pytest.mark.parametrize("interpolate", [True, False])
def test_ungrouped_quantile(inp, q, interpolate):
    (_, rv, rd, rn, rs), (_, pv, pd, pn, ps) = _both(inp, inp.floats,
                                                      inp.nulls)
    _same(pagg.ungrouped_quantile(pv, _payload(pagg, "quantile", pd, pn), q,
                                  ps, interpolate),
          ragg.ungrouped_quantile(rv, _payload(ragg, "quantile", rd, rn), q,
                                  rs, interpolate))


# ---- mode -------------------------------------------------------------------

@pytest.mark.parametrize("floats", [True, False])
def test_group_mode(inp, floats):
    data = inp.floats if floats else inp.ints
    (rk, rv, rd, rn, rs), (pk, pv, pd, pn, ps) = _both(inp, data, inp.nulls)
    _same(pagg.group_mode(pk, pv, _payload(pagg, "mode", pd, pn), ps, CAP),
          ragg.group_mode(rk, rv, _payload(ragg, "mode", rd, rn), rs, CAP))


def test_mode_ties_go_to_the_smallest_value():
    # one group; 4 and -1 both appear three times, 9 twice
    data = np.zeros(CAP, dtype=np.int32)
    data[:8] = [4, 9, -1, 4, -1, 9, 4, -1]
    sel = np.arange(CAP) < 8
    key = [torch.zeros(CAP, dtype=torch.int32)]
    vops = psk.encode_key(_t(data), None, PT.INTEGER)
    p = pagg.AggPayload("mode", _t(data), None)
    out, isnull = pagg.group_mode(key, vops, p, _t(sel), CAP)
    assert int(out[0]) == -1 and not bool(isnull[0]) and bool(isnull[1])
    out, isnull = pagg.ungrouped_mode(vops, p, _t(sel))
    assert int(out) == -1 and not bool(isnull)
    rkey = [jnp.zeros(CAP, dtype=jnp.int32)]
    rv = rsk.encode_key(_j(data), None, RT.INTEGER)
    rp = ragg.AggPayload("mode", _j(data), None)
    assert int(ragg.group_mode(rkey, rv, rp, _j(sel), CAP)[0][0]) == -1


def test_ungrouped_mode(inp):
    (_, rv, rd, rn, rs), (_, pv, pd, pn, ps) = _both(inp, inp.ints,
                                                      inp.nulls)
    _same(pagg.ungrouped_mode(pv, _payload(pagg, "mode", pd, pn), ps),
          ragg.ungrouped_mode(rv, _payload(ragg, "mode", rd, rn), rs))


# ---- arg_min / arg_max --------------------------------------------------------

def _argext_args(inp, sk, types, conv):
    key_ops, _ = inp.ops(sk, types, conv)
    by_ops = sk.encode_key(conv(inp.by), conv(inp.by_nulls), types.INTEGER)
    return key_ops, by_ops, conv(inp.by_nulls), conv(inp.by_payload), \
        conv(inp.by_payload_nulls), conv(inp.sel)


@pytest.mark.parametrize("is_max", [False, True])
@pytest.mark.parametrize("keep_null_payload", [False, True])
def test_group_and_ungrouped_argext(inp, is_max, keep_null_payload):
    rk, rb, rbn, rd, rn, rs = _argext_args(inp, rsk, RT, _j)
    pk, pb, pbn, pd, pn, ps = _argext_args(inp, psk, PT, _t)
    rp, pp = (m.AggPayload("arg", d, n)
              for m, d, n in ((ragg, rd, rn), (pagg, pd, pn)))
    _same(pagg.group_argext(pk, pb, pbn, pp, ps, CAP, is_max,
                            keep_null_payload),
          ragg.group_argext(rk, rb, rbn, rp, rs, CAP, is_max,
                            keep_null_payload))
    _same(pagg.ungrouped_argext(pb, pbn, pp, ps, is_max, keep_null_payload),
          ragg.ungrouped_argext(rb, rbn, rp, rs, is_max, keep_null_payload))


def test_argext_ties_take_the_first_input_row():
    by = np.zeros(CAP, dtype=np.int32)
    by[:6] = [3, 7, 7, 1, 1, 7]
    payload = np.arange(CAP, dtype=np.int32) + 100
    sel = np.arange(CAP) < 6
    key = [torch.zeros(CAP, dtype=torch.int32)]
    bops = psk.encode_key(_t(by), None, PT.INTEGER)
    p = pagg.AggPayload("arg", _t(payload), None)
    for is_max, row in ((True, 1), (False, 3)):
        out, _ = pagg.group_argext(key, bops, None, p, _t(sel), CAP, is_max)
        assert int(out[0]) == 100 + row
        out, _ = pagg.ungrouped_argext(bops, None, p, _t(sel), is_max)
        assert int(out) == 100 + row


# ---- entropy ------------------------------------------------------------------

@pytest.mark.parametrize("floats", [True, False])
def test_group_and_ungrouped_entropy(inp, floats):
    data = inp.floats if floats else inp.ints
    (rk, rv, rd, rn, rs), (pk, pv, pd, pn, ps) = _both(inp, data, inp.nulls)
    rp, pp = _payload(ragg, "entropy", rd, rn), \
        _payload(pagg, "entropy", pd, pn)
    _same(pagg.group_entropy(pk, pv, pp, ps, CAP),
          ragg.group_entropy(rk, rv, rp, rs, CAP), atol=1e-12)
    _same(pagg.ungrouped_entropy(pv, pp, ps),
          ragg.ungrouped_entropy(rv, rp, rs), atol=1e-12)


# ---- bit aggregates, last and product on the plain paths ----------------------

@pytest.mark.parametrize("kind", ["bit_and", "bit_or", "bit_xor", "last",
                                  "product", "any_value"])
def test_plain_paths_have_the_kind(inp, kind):
    data = inp.ints.astype(np.int64) * 1234567 if kind.startswith("bit") \
        else inp.ints
    rk, rkd = inp.ops(rsk, RT, _j)
    pk, pkd = inp.ops(psk, PT, _t)
    rp = ragg.AggPayload(kind, _j(data), _j(inp.nulls))
    pp = pagg.AggPayload(kind, _t(data), _t(inp.nulls))
    rcols, rres, rgsel, rng_ = ragg.group_and_aggregate(rk, rkd, [rp],
                                                        _j(inp.sel), CAP)
    pcols, pres, pgsel, png = pagg.group_and_aggregate(pk, pkd, [pp],
                                                       _t(inp.sel), CAP)
    assert int(rng_) == int(png)
    assert np.array_equal(_np(pgsel), _np(rgsel))
    _same(pres[0], rres[0])
    _same(pagg.ungrouped_aggregate([pp], _t(inp.sel))[0],
          ragg.ungrouped_aggregate([rp], _j(inp.sel))[0])


def test_bit_aggregates_without_nulls_and_odd_lengths():
    rng = np.random.default_rng(4)
    for n in (1, 2, 3, 129, 1000):
        v = rng.integers(-2**40, 2**40, n)
        for kind, fn in (("bit_and", np.bitwise_and.reduce),
                         ("bit_or", np.bitwise_or.reduce),
                         ("bit_xor", np.bitwise_xor.reduce)):
            assert int(pagg._bit_reduce(_t(v), kind)) == int(fn(v))


def test_seg_scan_is_a_segmented_running_sum():
    seg = torch.tensor([0, 0, 0, 1, 2, 2, 2, 2, 2, 3])
    v = torch.arange(1.0, 11.0, dtype=torch.float64)
    got = pagg.seg_scan(v, seg, torch.add, longest=5)
    assert got.tolist() == [1, 3, 6, 4, 5, 11, 18, 26, 35, 10]
    starts = torch.tensor([0, 3, 4, 9])
    assert pagg.seg_cumsum_int(v.long(), seg, starts).tolist() \
        == got.long().tolist()


# ---- SQL ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, cols in window_cases.tables().items():
        ref.register(name, cols)
        port.register(name, cols)
    return ref, port


def same_rows(want, got, atol=0.0):
    assert len(want) == len(got)
    for rw, rg in zip(want, got):
        assert len(rw) == len(rg)
        for w, g in zip(rw, rg):
            if isinstance(w, float):
                assert isinstance(g, float)
                assert (math.isnan(w) and math.isnan(g)) or \
                    math.isclose(w, g, rel_tol=RTOL, abs_tol=atol), (rw, rg)
            else:
                assert type(w) is type(g) and w == g, (rw, rg)


@pytest.mark.parametrize("name", list(window_cases.HOLISTIC))
def test_holistic_sql_matches_reference(cons, name):
    ref, port = cons
    sql = window_cases.HOLISTIC[name]
    want = ref.execute(sql)
    got = port.execute(sql)
    assert got.column_names == want.column_names
    same_rows(want.fetchall(), got.fetchall(),
              atol=1e-12 if "entropy" in name else 0.0)
    assert name == "filtered_to_nothing" or len(want.fetchall()) > 0


@pytest.mark.parametrize("rows,grouped", [(1000, False), (1000, True),
                                          (140_000, False),
                                          (140_000, True)])
def test_approx_count_distinct_below_and_above_the_sketch_threshold(
        rows, grouped):
    # 140,000 rows make a batch of 2^18 slots: from 2^17 on, the
    # ungrouped form estimates with HyperLogLog; below, and grouped, it
    # counts exactly
    rng = np.random.default_rng(rows)
    data = {"g": rng.integers(0, 4, rows).astype(np.int32),
            "x": rng.integers(0, 30_000, rows)}
    sql = "select g, approx_count_distinct(x) from t group by g order by g" \
        if grouped else "select approx_count_distinct(x) from t"
    want = ddb_tpu.connect().register("t", data).execute(sql).fetchall()
    got = ddb_tpu_torch.connect(device="cpu").register("t", data) \
        .execute(sql).fetchall()
    assert got == want
    exact = len(np.unique(data["x"]))
    if not grouped:
        sketched = rows >= 1 << 17
        assert (got[0][0] != exact) == sketched
        assert abs(got[0][0] - exact) <= 0.03 * exact

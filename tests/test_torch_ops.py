"""The port's operators against the reference package's: the same numpy
inputs (made from a seed) go through each ddb_tpu function (JAX on the
CPU) and its ddb_tpu_torch counterpart (torch on the CPU).

Tolerances: integers, decimals, dates, masks and permutations exact;
floats 1e-12 relative (the two sum in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddb_tpu import types as JT
from ddb_tpu.batch import Batch as JBatch, Column as JColumn
from ddb_tpu.expr import compile as JC, ir as JIR
from ddb_tpu.ops import aggregate as JA, order as JO, sortkey as JK
from test_torch_reference_jit import (fast_reference_compiles,  # noqa: F401
                                      jitted_module)
from ddb_tpu_torch import types as TT
from ddb_tpu_torch.batch import Batch as TBatch, Column as TColumn
from ddb_tpu_torch.expr import compile as TC, ir as TIR
from ddb_tpu_torch.ops import aggregate as TA, order as TO, sortkey as TK

# the reference's operators under jax.jit (test_torch_reference_jit.py)
JA, JO = jitted_module(JA), jitted_module(JO)

RTOL = 1e-12
CAP = 512


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b, where=None):
    """Exact for integers/bools, RTOL for floats; `where` restricts."""
    a, b = _np(a), _np(b)
    if where is not None:
        a, b = a[where], b[where]
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        sel=rng.random(CAP) < 0.8,
        gid=rng.integers(0, 6, CAP).astype(np.int32),
        ints=rng.integers(-1000, 1000, CAP).astype(np.int64),
        # near 2^62: an int64 sum overflows, so wide limbs are needed
        big=((1 << 62) - rng.integers(0, 1 << 40, CAP)).astype(np.int64),
        f=rng.normal(size=CAP),
        g=rng.normal(size=CAP) * 3 + 1,
        nulls=rng.random(CAP) < 0.2,
        key=rng.integers(0, 9, CAP).astype(np.int32),
        key2=rng.integers(-3, 3, CAP).astype(np.int64),
        key_nulls=rng.random(CAP) < 0.1,
    )


# (kind, data, data2, with nulls)
_PAYLOADS = [
    ("count_star", None, None, False),
    ("count", "ints", None, True),
    ("sum", "ints", None, True),
    ("sum_float", "f", None, True),
    ("avg", "ints", None, False),
    ("sum_wide", "big", None, True),
    ("avg_wide", "big", None, False),
    ("min", "ints", None, True),
    ("max", "f", None, False),
    ("any_value", "ints", None, True),
    ("var_samp", "f", None, True),
    ("var_pop", "g", None, False),
    ("stddev_samp", "g", None, True),
    ("stddev_pop", "f", None, False),
    ("covar_samp", "f", "g", True),
    ("covar_pop", "f", "g", False),
    ("corr", "f", "g", True),
]


def _payloads(x, mod, to):
    out = []
    for kind, d, d2, nulls in _PAYLOADS:
        out.append(mod.AggPayload(
            kind, None if d is None else to(x[d]),
            to(x["nulls"]) if nulls else None,
            None if d2 is None else to(x[d2])))
    return out


def _same_result(j, t, where=None):
    (jd, jn), (td, tn) = j, t
    assert (jn is None) == (tn is None)
    if jn is not None:
        _same(jn, tn, where)
    live = None if jn is None else ~_np(jn)
    if where is not None:
        live = where if live is None else (live & where)
    if isinstance(jd, tuple):        # wide: (composed, high limb)
        _same(jd[0], td[0], live)
        _same(jd[1], td[1], live)
    else:
        _same(jd, td, live)


def test_dense_group_aggregate():
    x = _inputs(1)
    jr, jc = JA.dense_group_aggregate(
        jnp.asarray(x["gid"]), 6, _payloads(x, JA, jnp.asarray),
        jnp.asarray(x["sel"]))
    tr, tc = TA.dense_group_aggregate(
        torch.from_numpy(x["gid"]), 6, _payloads(x, TA, torch.from_numpy),
        torch.from_numpy(x["sel"]))
    _same(jc, tc)
    assert len(jr) == len(tr) == len(_PAYLOADS)
    for j, t in zip(jr, tr):
        _same_result(j, t)


def test_ungrouped_aggregate():
    x = _inputs(2)
    jr = JA.ungrouped_aggregate(_payloads(x, JA, jnp.asarray),
                                jnp.asarray(x["sel"]))
    tr = TA.ungrouped_aggregate(_payloads(x, TA, torch.from_numpy),
                                torch.from_numpy(x["sel"]))
    for j, t in zip(jr, tr):
        _same_result(j, t)


def test_ungrouped_wide_sum_exceeds_int64():
    x = _inputs(3)
    p = [TA.AggPayload("sum_wide", torch.from_numpy(x["big"]), None)]
    (lo, hi), isnull = TA.ungrouped_aggregate(
        p, torch.from_numpy(x["sel"]))[0]
    exact = sum(int(v) for v in x["big"][x["sel"]])
    assert exact > 2 ** 63 and not bool(isnull)
    assert int(hi) * (1 << 32) + (int(lo) & 0xFFFFFFFF) == exact


@pytest.mark.parametrize("two_keys", [False, True])
def test_group_and_aggregate(two_keys):
    x = _inputs(4)
    keys = [("key", "key_nulls", JT.INTEGER, TT.INTEGER)]
    if two_keys:
        keys.append(("key2", None, JT.BIGINT, TT.BIGINT))

    def run(mod, kmod, T, to):
        key_ops, key_data = [], []
        for name, nname, jt, tt in keys:
            d = to(x[name])
            n = to(x[nname]) if nname else None
            key_ops.extend(kmod.encode_key(d, n, jt if T is JT else tt))
            key_data.append((d, n))
        return mod.group_and_aggregate(key_ops, key_data,
                                       _payloads(x, mod, to),
                                       to(x["sel"]), CAP)

    jg, jr, jsel, jng = run(JA, JK, JT, jnp.asarray)
    tg, tr, tsel, tng = run(TA, TK, TT, torch.from_numpy)
    assert int(jng) == int(tng) > 0
    _same(jsel, tsel)
    live = _np(jsel)
    for (jd, jn), (td, tn) in zip(jg, tg):
        assert (jn is None) == (tn is None)
        keyed = live if jn is None else live & ~_np(jn)
        if jn is not None:
            _same(jn, tn, live)
        _same(jd, td, keyed)
    for j, t in zip(jr, tr):
        _same_result(j, t, live)


def _key_cases():
    rng = np.random.default_rng(5)
    n = 64
    nulls = rng.random(n) < 0.25
    dbl = rng.normal(size=n) * 1e3
    dbl[:6] = [-0.0, 0.0, np.nan, -np.inf, np.inf, -1e-300]
    return [
        ("int", rng.integers(-50, 50, n).astype(np.int32), "INTEGER"),
        ("decimal", rng.integers(-10**12, 10**12, n).astype(np.int64),
         ("DECIMAL", 15, 2)),
        ("date", rng.integers(-20000, 20000, n).astype(np.int32), "DATE"),
        ("double", dbl, "DOUBLE"),
        ("float", dbl.astype(np.float32), "FLOAT"),
        ("varchar", rng.integers(0, 7, n).astype(np.int32), "VARCHAR"),
    ], nulls


def _dtype(T, spec):
    return T.DECIMAL(*spec[1:]) if isinstance(spec, tuple) \
        else getattr(T, spec)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("nulls_last", [False, True])
@pytest.mark.parametrize("with_nulls", [False, True])
def test_encode_key(desc, nulls_last, with_nulls):
    cases, nulls = _key_cases()
    for name, data, spec in cases:
        jn = jnp.asarray(nulls) if with_nulls else None
        tn = torch.from_numpy(nulls) if with_nulls else None
        j = JK.encode_key(jnp.asarray(data), jn, _dtype(JT, spec),
                          desc=desc, nulls_last=nulls_last)
        t = TK.encode_key(torch.from_numpy(data), tn, _dtype(TT, spec),
                          desc=desc, nulls_last=nulls_last)
        assert len(j) == len(t), name
        for a, b in zip(j, t):
            assert _np(a).dtype == _np(b).dtype, name
            assert np.array_equal(_np(a), _np(b)), name


@pytest.mark.parametrize("wide", [False, True], ids=["packed", "general"])
def test_sort_permutation(wide):
    rng = np.random.default_rng(6)
    n = 300
    k1 = rng.integers(0, 5, n).astype(np.int32)
    if wide:
        # spans the whole int64 range: cannot pack into 63 bits
        k2 = rng.integers(-(1 << 62), 1 << 62, n) * 2
    else:
        k2 = rng.integers(-20, 20, n)
    sel = rng.random(n) < 0.7
    j = JO.sort_permutation([jnp.asarray(k1), jnp.asarray(k2)],
                            jnp.asarray(sel))
    t = TO.sort_permutation([torch.from_numpy(k1), torch.from_numpy(k2)],
                            torch.from_numpy(sel))
    assert np.array_equal(_np(j).astype(np.int64), _np(t))


def test_limit_mask():
    sel = np.random.default_rng(7).random(200) < 0.5
    j = JO.limit_mask(jnp.asarray(sel), 5, 17)
    t = TO.limit_mask(torch.from_numpy(sel), 5, 17)
    assert np.array_equal(_np(j), _np(t)) and int(_np(t).sum()) == 17


def _exprs(ir, T):
    """Decimal/integer arithmetic over columns a (DECIMAL(15,4)),
    b (DECIMAL(15,2)), i and k (BIGINT, k has zeros and NULLs)."""
    d4, d2, bi = T.DECIMAL(15, 4), T.DECIMAL(15, 2), T.BIGINT
    a, b = ir.ColRef(0, d4, "a"), ir.ColRef(1, d2, "b")
    i, k = ir.ColRef(2, bi, "i"), ir.ColRef(3, bi, "k")
    return [
        ir.Cast(a, d2, d4),                          # round half away
        ir.Cast(b, d4, d2),
        ir.Cast(a, T.INTEGER, d4),
        ir.Cast(a, T.DOUBLE, d4),
        ir.Arith("*", a, b, T.DECIMAL(18, 6)),
        ir.Arith("+", ir.Cast(b, d4, d2), a, d4),
        ir.Arith("-", a, ir.Cast(b, d4, d2), d4),
        ir.Arith("//", i, k, bi),                    # truncating division
        ir.Arith("%", i, k, bi),
        ir.Arith("/", i, k, T.DOUBLE),
        ir.Cmp("<", a, ir.Cast(b, d4, d2)),
        ir.Case([(ir.Cmp(">", i, ir.Const(0, bi)), a)],
                ir.Arith("-", ir.Const(0, d4), a, d4), d4),
        ir.BoolOp("or", [ir.Cmp("==", k, ir.Const(0, bi)),
                         ir.IsNull(k)]),
    ]


def test_decimal_and_integer_arithmetic():
    rng = np.random.default_rng(8)
    n = 256
    cols = [rng.integers(-10**8, 10**8, n),
            rng.integers(-10**6, 10**6, n),
            rng.integers(-50, 50, n),
            rng.integers(-4, 4, n)]
    cols[0][:8] = [50, -50, 150, -150, 49, -49, 5050, -5050]  # .xx50 ties
    knulls = rng.random(n) < 0.2
    cols = [c.astype(np.int64) for c in cols]
    jb = JBatch(tuple(JColumn(jnp.asarray(c), jnp.asarray(knulls)
                              if j == 3 else None)
                      for j, c in enumerate(cols)),
                jnp.ones(n, dtype=bool), jnp.int32(n))
    tb = TBatch(tuple(TColumn(torch.from_numpy(c), torch.from_numpy(knulls)
                              if j == 3 else None)
                      for j, c in enumerate(cols)),
                torch.ones(n, dtype=torch.bool), torch.tensor(n))
    for je, te in zip(_exprs(JIR, JT), _exprs(TIR, TT)):
        jd, jn = JC.evaluate(je, jb)
        td, tn = TC.evaluate(te, tb)
        assert _np(jd).dtype == _np(td).dtype, te
        assert (jn is None) == (tn is None), te
        live = None
        if jn is not None:
            assert np.array_equal(_np(jn), _np(tn)), te
            live = ~_np(jn)
        _same(jd, td, live)


def _func_cases(ir, T):
    """(name, Func expr) over columns d (DATE), x (DOUBLE, NULLs),
    y (DOUBLE), i (BIGINT)."""
    d, x = ir.ColRef(0, T.DATE, "d"), ir.ColRef(1, T.DOUBLE, "x")
    y, i = ir.ColRef(2, T.DOUBLE, "y"), ir.ColRef(3, T.BIGINT, "i")
    out = [(n, ir.Func(n, [d], T.BIGINT))
           for n in ("year", "month", "day", "quarter", "dayofweek",
                     "isodow")]
    out += [(n, ir.Func(n, [d], T.DATE))
            for n in ("date_trunc_year", "date_trunc_month")]
    out += [(n, ir.Func(n, [x], T.DOUBLE))
            for n in ("abs", "floor", "ceil", "sqrt", "ln", "log", "log2",
                      "exp", "sign", "trunc")]
    out += [("abs_int", ir.Func("abs", [i], T.BIGINT)),
            ("round", ir.Func("round", [x], T.DOUBLE, 2)),
            ("pow", ir.Func("pow", [y, x], T.DOUBLE))]
    out += [(n, ir.Func(n, [x, y], T.DOUBLE))
            for n in ("coalesce", "least", "greatest", "nullif", "ifnull")]
    return out


@pytest.mark.parametrize("idx", range(len(_func_cases(TIR, TT))),
                         ids=[n for n, _ in _func_cases(TIR, TT)])
def test_scalar_functions(idx):
    rng = np.random.default_rng(9)
    n = 300
    cols = [rng.integers(-800_000, 100_000, n).astype(np.int32),
            rng.normal(size=n) * 50,
            rng.normal(size=n) * 3,
            rng.integers(-10**9, 10**9, n)]
    cols[1][:4] = [-2.5, 2.5, 0.125, 0.0]
    cols[2][:4] = cols[1][:4]          # nullif hits
    xnulls = rng.random(n) < 0.2
    jb = JBatch(tuple(JColumn(jnp.asarray(c), jnp.asarray(xnulls)
                              if j == 1 else None)
                      for j, c in enumerate(cols)),
                jnp.ones(n, dtype=bool), jnp.int32(n))
    tb = TBatch(tuple(TColumn(torch.from_numpy(c), torch.from_numpy(xnulls)
                              if j == 1 else None)
                      for j, c in enumerate(cols)),
                torch.ones(n, dtype=torch.bool), torch.tensor(n))
    _, je = _func_cases(JIR, JT)[idx]
    _, te = _func_cases(TIR, TT)[idx]
    jd, jn = JC.evaluate(je, jb)
    td, tn = TC.evaluate(te, tb)
    assert (jn is None) == (tn is None)
    live = None
    if jn is not None:
        assert np.array_equal(_np(jn), _np(tn))
        live = ~_np(jn)
    a, b = _np(jd), _np(td)
    if live is not None:
        a, b = a[live], b[live]
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, equal_nan=True)
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64))

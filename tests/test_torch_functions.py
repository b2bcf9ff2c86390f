"""ddb_tpu_torch.expr.functions.dispatch against ddb_tpu's, one case a
function name, on the same numpy-seeded columns (NULLs, zeros, negative
values, dates and timestamps before 1970), and the scalar-function
statements of bench/select_cases.py through both packages' connect().

Integers, dates, booleans and NULL masks must match exactly; floats to
1e-12 relative (XLA on the CPU and torch differ in the last place of
transcendentals).  random() draws from another generator than the
reference's and is held by its properties.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu import batch as rbatch
from ddb_tpu import types as RT
from ddb_tpu.expr import compile as rcompile
from ddb_tpu.expr import functions as rfunctions
from ddb_tpu.expr import ir as rir
from ddb_tpu_torch import batch as pbatch
from ddb_tpu_torch import types as PT
from ddb_tpu_torch.bench import select_cases
from ddb_tpu_torch.expr import compile as pcompile
from ddb_tpu_torch.expr import functions as pfunctions
from ddb_tpu_torch.expr import ir as pir

from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

RTOL = 1e-12
CAP = 256
US_DAY = 86_400_000_000


def _columns():
    """{name: (type name, values, NULL mask or None)}."""
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(0, 3, CAP), 3)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -3.5]
    i = rng.integers(-30, 30, CAP)
    i[:8] = [0, 1, -1, 20, 21, -7, 25, 2]
    big = rng.integers(-2**62, 2**62, CAP)
    big[:4] = [0, -1, 2**63 - 1, -2**63]
    days = rng.integers(-40000, 40000, CAP)
    days[:6] = [0, -1, 1, -719468, 11016, 19782]     # epoch, 0000-03-01, leap
    us = rng.integers(-3_000_000_000, 3_000_000_000, CAP) * 1_000_000 \
        + rng.integers(0, 1_000_000, CAP)
    us[:4] = [0, -1, 1, -US_DAY]
    us2 = us + rng.integers(-900, 900, CAP) * US_DAY \
        + rng.integers(0, US_DAY, CAP)
    return {
        "x": ("DOUBLE", x, rng.random(CAP) < 0.1),
        "y": ("DOUBLE", np.round(rng.normal(0, 3, CAP), 3), None),
        "u": ("DOUBLE", np.round(rng.random(CAP) * 0.98 + 0.01, 6), None),
        "p": ("DOUBLE", np.round(rng.random(CAP) * 20 + 1.01, 4),
              rng.random(CAP) < 0.1),
        "g": ("DOUBLE", np.round(rng.random(CAP) * 24 - 6, 2) + 0.005, None),
        "sec": ("DOUBLE", np.round(rng.random(CAP) * 59, 0) + 0.25, None),
        "i": ("BIGINT", i, rng.random(CAP) < 0.1),
        "j": ("BIGINT", rng.integers(-12, 13, CAP), rng.random(CAP) < 0.1),
        "i32": ("INTEGER", i.astype(np.int32), None),
        "i16": ("SMALLINT", (i * 37).astype(np.int16), None),
        "i8": ("TINYINT", i.astype(np.int8), None),
        "big": ("BIGINT", big, None),
        "months": ("BIGINT", rng.integers(-30, 30, CAP), None),
        "d": ("DATE", days.astype(np.int32), rng.random(CAP) < 0.1),
        "ts": ("TIMESTAMP", us, rng.random(CAP) < 0.1),
        "ts2": ("TIMESTAMP", us2, None),
        "yy": ("BIGINT", rng.integers(1890, 2100, CAP), None),
        "mm": ("BIGINT", rng.integers(1, 13, CAP), None),
        "dd": ("BIGINT", rng.integers(1, 29, CAP), rng.random(CAP) < 0.05),
        "hh": ("BIGINT", rng.integers(0, 24, CAP), None),
        "mi": ("BIGINT", rng.integers(0, 60, CAP), None),
    }


COLS = _columns()
NAMES = list(COLS)
SEL = np.random.default_rng(4).random(CAP) < 0.85


def _batches():
    jcols, tcols = [], []
    for tname, vals, nulls in COLS.values():
        jcols.append(rbatch.Column(
            jnp.asarray(vals), None if nulls is None else jnp.asarray(nulls)))
        tcols.append(pbatch.Column(
            torch.from_numpy(vals),
            None if nulls is None else torch.from_numpy(nulls)))
    return (rbatch.Batch(tuple(jcols), jnp.asarray(SEL),
                         jnp.int32(SEL.sum())),
            pbatch.Batch(tuple(tcols), torch.from_numpy(SEL),
                         torch.tensor(int(SEL.sum()), dtype=torch.int32)))


JB, TB = _batches()

def _zone(name, to_wall):
    from ddb_tpu import tz
    trans, offs = tz.zone_table(name)
    return (trans, offs) if to_wall else (trans + offs, -offs)


def case(name, args, out="DOUBLE", extra=None):
    return dict(name=name, args=args.split() if args else [], out=out,
                extra=extra)


_M1 = ["sin", "cos", "tan", "atan", "sinh", "cosh", "tanh", "sign",
       "radians", "degrees", "cbrt", "asinh", "exp", "trunc"]
CASES = {
    **{f: case(f, "x") for f in _M1},
    **{f: case(f, "u") for f in ("asin", "acos", "atanh")},
    **{f: case(f, "p") for f in ("ln", "log", "log2", "log10", "acosh",
                                 "cot", "lgamma")},
    "gamma": case("gamma", "g"),
    "gamma_positive": case("gamma", "p"),
    "sign_of_ints": case("sign", "i"),
    **{f: case(f, "x", "BOOLEAN") for f in ("isnan", "isinf", "isfinite",
                                            "signbit")},
    "atan2": case("atan2", "x y"),
    "nextafter": case("nextafter", "x y"),
    "gcd": case("gcd", "i j", "BIGINT"),
    "lcm": case("lcm", "i j", "BIGINT"),
    "lcm_with_zero": case("lcm", "i i", "BIGINT"),
    "factorial": case("factorial", "i", "BIGINT"),
    "even": case("even", "x"),
    "even_of_ints": case("even", "i"),
    "abs": case("abs", "x"),
    "abs_of_ints": case("abs", "i", "BIGINT"),
    "round": case("round", "x"),
    "round_2": case("round", "y", extra=2),
    "round_neg": case("round", "p", extra=-1),
    "floor": case("floor", "x"),
    "ceil": case("ceil", "x"),
    "sqrt": case("sqrt", "p"),
    "pow": case("pow", "p y"),
    "power": case("power", "u x"),
    "coalesce": case("coalesce", "x p y"),
    "coalesce_ints": case("coalesce", "i j", "BIGINT"),
    "least": case("least", "x p y"),
    "greatest": case("greatest", "i j", "BIGINT"),
    "greatest_nulls": case("greatest", "x p"),
    "nullif": case("nullif", "i j", "BIGINT"),
    "ifnull": case("ifnull", "i j", "BIGINT"),
    "ifnull_no_nulls": case("ifnull", "y x"),
    "rowid": case("rowid", "", "BIGINT"),
    "floordiv_pow52": case("floordiv_pow52", "big", "BIGINT"),
    "bit_count": case("bit_count", "big", "BIGINT"),
    "bit_count_small": case("bit_count", "i", "BIGINT"),
    "bit_count_int32": case("bit_count", "i32", "BIGINT"),
    "bit_count_int16": case("bit_count", "i16", "BIGINT"),
    "bit_count_int8": case("bit_count", "i8", "BIGINT"),
    **{f: case(f, "d", "BIGINT") for f in (
        "year", "month", "day", "quarter", "dayofweek", "isodow",
        "dayofyear", "week", "isoyear", "yearweek", "century", "decade",
        "millennium")},
    **{f: case(f, "d", "DATE") for f in (
        "date_trunc_year", "date_trunc_month", "date_trunc_week",
        "last_day")},
    "add_months_days": case("add_months_days", "d", "DATE", extra=1),
    "add_months_days_back": case("add_months_days", "d", "DATE", extra=-13),
    "add_months_us": case("add_months_us", "ts", "TIMESTAMP", extra=11),
    "add_months_us_back": case("add_months_us", "ts", "TIMESTAMP", extra=-1),
    "add_months_dyn_us": case("add_months_dyn_us", "ts months", "TIMESTAMP"),
    "months_between_us": case("months_between_us", "ts ts2", "BIGINT"),
    "months_between_us_rev": case("months_between_us", "ts2 ts", "BIGINT"),
    "ts_date": case("ts_date", "ts", "DATE"),
    "ts_trunc_minute": case("ts_trunc", "ts", "TIMESTAMP",
                            extra=60_000_000),
    "ts_trunc_day": case("ts_trunc", "ts", "TIMESTAMP", extra=US_DAY),
    **{f: case(f, "ts", "BIGINT") for f in (
        "ts_hour", "ts_minute", "ts_second", "ts_millisecond",
        "ts_microsecond")},
    "time_bucket": case("time_bucket", "ts", "TIMESTAMP",
                        extra=(900_000_000, 0)),
    "time_bucket_origin": case("time_bucket", "ts", "TIMESTAMP",
                               extra=(7 * US_DAY, 4 * US_DAY)),
    "epoch_date": case("epoch", "d", "BIGINT"),
    "epoch_ts": case("epoch", "ts", "BIGINT"),
    "epoch_ms_date": case("epoch_ms", "d", "BIGINT"),
    "epoch_ms_ts": case("epoch_ms", "ts", "BIGINT"),
    "epoch_raw_us": case("epoch_raw", "ts", "BIGINT", extra="epoch_us"),
    "epoch_raw_ms": case("epoch_raw", "ts", "BIGINT", extra="epoch_ms"),
    "epoch_raw_ns": case("epoch_raw", "ts2", "BIGINT", extra="epoch_ns"),
    "epoch_raw_date": case("epoch_raw", "d", "BIGINT", extra="epoch_ms"),
    "to_timestamp": case("to_timestamp", "sec", "TIMESTAMP"),
    "to_timestamp_negative": case("to_timestamp", "i", "TIMESTAMP"),
    "make_date": case("make_date", "yy mm dd", "DATE"),
    "make_time": case("make_time", "hh mi sec", "TIME"),
    "make_timestamp": case("make_timestamp", "yy mm dd hh mi sec",
                           "TIMESTAMP"),
    "make_timestamp_micros": case("make_timestamp", "ts", "TIMESTAMP"),
    # zone tables after 1970 only: before it the reference's lookup is off
    # by one transition (ROADMAP.md section 3); test_torch_tz.py holds the
    # port's against zoneinfo there
    "tz_shift_to_wall": case("tz_shift", "ts_recent", "TIMESTAMP",
                             extra=("Europe/Berlin", True)),
    "tz_shift_to_utc": case("tz_shift", "ts_recent", "TIMESTAMPTZ",
                            extra=("America/New_York", False)),
    "timetz_from_tz": case("timetz_from_tz", "ts_wall ts_recent", "TIMETZ"),
}

# derived columns of the zone cases
_recent = np.abs(COLS["ts"][1]) + 200 * US_DAY
COLS["ts_recent"] = ("TIMESTAMP", _recent, COLS["ts"][2])
COLS["ts_wall"] = ("TIMESTAMP", _recent + np.where(
    np.arange(CAP) % 2 == 0, 3_600_000_000, -5 * 3_600_000_000), None)
NAMES = list(COLS)
JB, TB = _batches()


def _func(ir, types, c):
    args = [ir.ColRef(NAMES.index(a), getattr(types, COLS[a][0]), a)
            for a in c["args"]]
    extra = c["extra"]
    if c["name"] == "tz_shift":
        extra = _zone(*extra)
    return ir.Func(c["name"], args, getattr(types, c["out"]), extra)


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_matches_reference(name):
    c = CASES[name]
    wd, wn = rcompile.evaluate(_func(rir, RT, c), JB)
    gd, gn = pcompile.evaluate(_func(pir, PT, c), TB)
    wd, gd = np.asarray(wd), gd.numpy()
    live = SEL.copy()
    assert (wn is None) == (gn is None), name
    if wn is not None:
        wn, gn = np.asarray(wn), gn.numpy()
        assert np.array_equal(wn[live], gn[live])
        live &= ~wn
    assert gd.shape == wd.shape == (CAP,)
    assert gd.dtype == wd.dtype, (gd.dtype, wd.dtype)
    assert live.sum() > CAP // 2
    if wd.dtype.kind == "f":
        np.testing.assert_allclose(gd[live], wd[live], rtol=RTOL, atol=0,
                                   equal_nan=True)
    else:
        assert np.array_equal(gd[live], wd[live])


def _names_in_dispatch(fn):
    """Every function name that a dispatch compares `name` against."""
    src = inspect.getsource(fn)
    names = set(re.findall(r'name == "(\w+)"', src))
    for group in re.findall(r'name in \(([^)]*)\)', src):
        names |= set(re.findall(r'"(\w+)"', group))
    return names


def test_port_dispatch_handles_every_name_of_the_reference():
    want = _names_in_dispatch(rfunctions.dispatch) \
        | set(rfunctions._MATH1) | set(rfunctions._BOOL_MATH1)
    have = _names_in_dispatch(pfunctions.dispatch) \
        | set(pfunctions._MATH1) | set(pfunctions._BOOL_MATH1)
    assert len(want) > 90
    assert want - have == set()
    assert have - want == set()          # and no function of its own


def test_every_name_has_a_case():
    names = _names_in_dispatch(rfunctions.dispatch) \
        | set(rfunctions._MATH1) | set(rfunctions._BOOL_MATH1)
    covered = {c["name"] for c in CASES.values()}
    # the host seams are driven through SQL (test_torch_tz.py,
    # test_torch_lists.py); random() by test_random_properties
    assert names - covered == {"__stringify__", "__pyudf__", "random"}


def test_random_properties():
    e = pir.Func("random", [], PT.DOUBLE, 1234)
    d, n = pcompile.evaluate(e, TB)
    d2, _ = pcompile.evaluate(e, TB)
    other, _ = pcompile.evaluate(pir.Func("random", [], PT.DOUBLE, 99), TB)
    assert n is None and d.dtype == torch.float64 and d.shape == (CAP,)
    assert bool(((d >= 0) & (d < 1)).all())
    assert torch.equal(d, d2)                     # same seed, same draws
    assert not torch.equal(d, other)
    assert d.unique().numel() == CAP
    assert 0.4 < float(d.mean()) < 0.6


def test_modulo_and_division_floor_before_1970():
    # the instant one microsecond before the epoch is 23:59:59.999999
    # of 1969-12-31
    us = torch.tensor([-1, -US_DAY - 1, -60_000_001], dtype=torch.int64)
    b = pbatch.Batch((pbatch.Column(us, None),),
                     torch.ones(3, dtype=torch.bool),
                     torch.tensor(3, dtype=torch.int32))
    col = pir.ColRef(0, PT.TIMESTAMP, "ts")

    def run(name, out, extra=None):
        return pcompile.evaluate(pir.Func(name, [col], out, extra),
                                 b)[0].tolist()

    assert run("ts_hour", PT.BIGINT) == [23, 23, 23]
    assert run("ts_minute", PT.BIGINT) == [59, 59, 58]
    assert run("ts_second", PT.BIGINT) == [59, 59, 59]
    assert run("ts_date", PT.DATE) == [-1, -2, -1]
    assert run("ts_trunc", PT.TIMESTAMP, 60_000_000) \
        == [-60_000_000, -US_DAY - 60_000_000, -120_000_000]
    assert run("epoch_ms", PT.BIGINT) == [-1000, -86_401_000, -61_000]
    assert run("time_bucket", PT.TIMESTAMP, (3_600_000_000, 0)) \
        == [-3_600_000_000, -US_DAY - 3_600_000_000, -3_600_000_000]


def test_edge_values():
    ints = torch.tensor([0, -4, 21, 25, -3, 6], dtype=torch.int64)
    other = torch.tensor([0, 6, 0, -5, -3, 4], dtype=torch.int64)
    nulls = torch.tensor([False, False, False, False, True, False])
    b = pbatch.Batch((pbatch.Column(ints, nulls), pbatch.Column(other, None)),
                     torch.ones(6, dtype=torch.bool),
                     torch.tensor(6, dtype=torch.int32))
    a, o = pir.ColRef(0, PT.BIGINT, "a"), pir.ColRef(1, PT.BIGINT, "o")

    def run(name, args, out=PT.BIGINT):
        d, n = pcompile.evaluate(pir.Func(name, args, out), b)
        return [None if (n is not None and n[i]) else v
                for i, v in enumerate(d.tolist())]

    assert run("factorial", [a]) \
        == [1, 1, 2432902008176640000, 2432902008176640000, None, 720]
    assert run("gcd", [a, o]) == [0, 2, 21, 5, None, 2]
    assert run("lcm", [a, o]) == [0, 12, 0, 25, None, 12]
    assert run("even", [a], PT.DOUBLE) == [0.0, -4.0, 22.0, 26.0, None, 6.0]
    assert run("bit_count", [a]) == [0, 62, 3, 3, None, 2]
    x = torch.tensor([-8.0, 27.0, -0.5, -1.5, -2.5, 0.0], dtype=torch.float64)
    bx = pbatch.Batch((pbatch.Column(x, None),), b.sel, b.count)
    cx = pir.ColRef(0, PT.DOUBLE, "x")
    cb = pcompile.evaluate(pir.Func("cbrt", [cx], PT.DOUBLE), bx)[0]
    assert cb.tolist()[:2] == pytest.approx([-2.0, 3.0], rel=RTOL)
    g = pcompile.evaluate(pir.Func("gamma", [cx], PT.DOUBLE), bx)[0]
    # gamma is negative on (-1, 0) and (-3, -2), positive on (-2, -1)
    assert g[2] < 0 and g[3] > 0 and g[4] < 0
    assert float(g[2]) == pytest.approx(-3.5449077018110318, rel=RTOL)


# ---- SQL ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, cols in select_cases.tables().items():
        ref.register(name, cols)
        port.register(name, cols)
    return ref, port


@pytest.mark.parametrize("name", list(select_cases.FUNCTIONS))
def test_function_sql_matches_reference(cons, name):
    ref, port = cons
    sql = select_cases.FUNCTIONS[name]
    want, got = ref.execute(sql), port.execute(sql)
    assert got.column_names == want.column_names
    assert first_difference(want.fetchall(),
                                         got.fetchall()) is None
    assert len(got.fetchall()) > 0


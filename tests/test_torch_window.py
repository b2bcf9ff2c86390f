"""ddb_tpu_torch.ops.window.compute_windows against
ddb_tpu.ops.window.compute_windows per kind and frame form on the same
numpy-seeded inputs (NULLs, ties, dead rows, with and without PARTITION
BY), and the SQL corpus of bench/window_cases.py through both packages'
connect().

Integers, dates, strings and NULLs must match exactly, floats to 1e-12
relative.  One named exception: a float sum over an explicit frame.  The
reference takes it as a difference of one global prefix sum, so its
result carries rounding of the size of the whole prefix; the port sums
inside the partition.  Those cases get an absolute tolerance of 1e-12 of
the summed magnitudes of all rows, and the port's own accuracy is held
against math.fsum in test_float_frames_do_not_inherit_other_partitions.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu import types as RT
from ddb_tpu.ops import sortkey as rsk
from ddb_tpu.ops import window as rwin
from ddb_tpu_torch import types as PT
from ddb_tpu_torch.bench import window_cases
from ddb_tpu_torch.ops import sortkey as psk
from ddb_tpu_torch.ops import window as pwin
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

RTOL = 1e-12
CAP = 256


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


class Inputs:
    def __init__(self, seed=1):
        rng = np.random.default_rng(seed)
        self.sel = rng.random(CAP) < 0.75
        self.p = rng.integers(0, 5, CAP).astype(np.int32)
        self.p_nulls = rng.random(CAP) < 0.08
        self.o = rng.integers(0, 10, CAP).astype(np.int32)
        self.o_nulls = rng.random(CAP) < 0.1
        self.of = np.round(rng.normal(0, 3, CAP), 1)      # float order key
        self.ints = rng.integers(-20, 20, CAP).astype(np.int32)
        self.floats = np.round(rng.normal(0, 50, CAP), 2)
        self.nulls = rng.random(CAP) < 0.2
        self.float_magnitude = float(np.abs(self.floats).sum())


INP = Inputs()

# ORDER BY variants: (order key, its NULL mask, type name, desc,
# nulls_last); None = no ORDER BY
ORDERS = {
    "asc": ("o", "o_nulls", "INTEGER", False, True),
    "desc_nulls_first": ("o", "o_nulls", "INTEGER", True, False),
    "float": ("of", None, "DOUBLE", False, True),
    "none": None,
}


def _spec(kind, data=None, frame_atol=False, **kw):
    return dict(kind=kind, data=data, frame_atol=frame_atol, kw=kw)


def _frames(prefix, field, frames, kinds):
    return {f"{prefix}_{k}_{d or 'x'}_{pre}_{post}".replace("None", "u")
            .replace("-", "m"):
            _spec(k, d, frame_atol=(d == "floats" and k != "count"
                                    and k not in ("min", "max")),
                  **{field: (pre, post)})
            for pre, post in frames for k, d in kinds}


_AGGS = [("sum", "ints"), ("sum_float", "floats"), ("avg", "ints"),
         ("avg", "floats"), ("count", "ints"), ("count_star", None),
         ("min", "ints"), ("max", "floats")]

# specs that need an ORDER BY (run with every ordered variant's operands)
ORDERED = {
    "row_number": _spec("row_number"), "rank": _spec("rank"),
    "dense_rank": _spec("dense_rank"),
    "percent_rank": _spec("percent_rank"), "cume_dist": _spec("cume_dist"),
    "ntile3": _spec("ntile", offset=3), "ntile100": _spec("ntile", offset=100),
    "lag1": _spec("lag", "ints", offset=1),
    "lag3_float": _spec("lag", "floats", offset=3),
    "lag0": _spec("lag", "ints", offset=0),
    "lead1": _spec("lead", "floats", offset=1),
    "lead7": _spec("lead", "ints", offset=7),
    "first_value": _spec("first_value", "ints"),
    "last_value": _spec("last_value", "floats"),
    "nth_value2": _spec("nth_value", "ints", offset=2),
    "nth_value3_rows": _spec("nth_value", "floats", offset=3,
                             rows_frame=(2, 2)),
    "first_value_rows": _spec("first_value", "ints", rows_frame=(1, 1)),
    "last_value_rows": _spec("last_value", "ints", rows_frame=(2, -1)),
    "first_value_groups": _spec("first_value", "ints", groups_frame=(1, 0)),
    **{f"default_{k}_{d or 'x'}": _spec(k, d) for k, d in _AGGS},
    **_frames("rows", "rows_frame",
              [(2, 0), (1, 1), (None, 0), (0, None), (None, None), (-3, 5),
               (4, -2)], _AGGS),
    **_frames("groups", "groups_frame",
              [(1, 1), (2, 0), (0, 1), (None, 1), (1, None)],
              [("sum", "ints"), ("count_star", None), ("min", "ints"),
               ("sum_float", "floats")]),
    **{f"exclude_{ex.replace(' ', '_')}_{k}_{d or 'x'}":
       _spec(k, d, frame_atol=(d == "floats"), rows_frame=(2, 2), exclude=ex)
       for ex in ("current row", "group", "ties")
       for k, d in [("sum", "ints"), ("count", "ints"), ("min", "ints"),
                    ("max", "floats"), ("avg", "floats"),
                    ("count_star", None)]},
    "exclude_group_default_frame": _spec("sum", "ints", exclude="group"),
    "exclude_ties_groups": _spec("max", "ints", groups_frame=(1, 1),
                                 exclude="ties"),
}

# RANGE value frames: one numeric ORDER BY key, whose raw values the spec
# carries
RANGE_FRAMES = [(2, 0), (1, 3), (None, 2), (2, None), (0, 0)]
RANGE_KINDS = [("sum", "ints"), ("count_star", None), ("max", "ints"),
               ("first_value", "ints"), ("sum_float", "floats")]

# specs without ORDER BY: whole-partition frames and DISTINCT
UNORDERED = {
    **{f"whole_{k}_{d or 'x'}": _spec(k, d, has_order=False)
       for k, d in _AGGS},
    "first_value": _spec("first_value", "floats", has_order=False),
    "last_value": _spec("last_value", "ints", has_order=False),
    "row_number": _spec("row_number", has_order=False),
    **{f"distinct_{k}_{d}": _spec(k, d, has_order=False, distinct=True)
       for k, d in [("count", "ints"), ("sum", "ints"), ("avg", "ints"),
                    ("count", "floats"), ("sum_float", "floats")]},
}


def _cases():
    out = []
    for part in ("p", "nopart"):
        for order in ("asc", "desc_nulls_first"):
            out += [(part, order, n) for n in ORDERED]
        out += [(part, "none", n) for n in UNORDERED]
        for order in ("asc", "desc_nulls_first", "float"):
            out += [(part, order, f"range_{k}_{pre}_{post}".replace(
                "None", "u")) for pre, post in RANGE_FRAMES
                for k, _ in RANGE_KINDS]
    return out


def _range_specs(order):
    key, nulls, tname, desc, nulls_last = ORDERS[order]
    specs = {}
    for pre, post in RANGE_FRAMES:
        for k, d in RANGE_KINDS:
            # a float key measures distances in tenths
            scale = 0.5 if tname == "DOUBLE" else 1
            frame = tuple(None if x is None else x * scale
                          for x in (pre, post))
            specs[f"range_{k}_{pre}_{post}".replace("None", "u")] = _spec(
                k, d, frame_atol=(d == "floats"), range_frame=frame,
                order_val=key, order_val_nulls=nulls, order_desc=desc,
                order_nulls_first=not nulls_last, order_dtype=tname)
    return specs


def _group_specs(order):
    if order == "none":
        return UNORDERED
    specs = dict(ORDERED) if order != "float" else {}
    specs.update(_range_specs(order))
    return specs


@functools.lru_cache(maxsize=None)
def _computed(part, order):
    """{spec name: (reference (data, nulls), port (data, nulls))} of one
    (PARTITION BY, ORDER BY) signature: one compute_windows call a
    package."""
    specs = _group_specs(order)
    outs = []
    for win, sk, types, conv in ((rwin, rsk, RT, _j), (pwin, psk, PT, _t)):
        part_ops = sk.encode_key(conv(INP.p), conv(INP.p_nulls),
                                 types.INTEGER) if part == "p" else []
        order_ops = []
        if ORDERS[order] is not None:
            key, nulls, tname, desc, nulls_last = ORDERS[order]
            order_ops = sk.encode_key(
                conv(getattr(INP, key)),
                None if nulls is None else conv(getattr(INP, nulls)),
                getattr(types, tname), desc=desc, nulls_last=nulls_last)
        wspecs = []
        for s in specs.values():
            kw = dict(s["kw"])
            for field in ("order_val", "order_val_nulls"):
                if kw.get(field) is not None:
                    kw[field] = conv(getattr(INP, kw[field]))
            if "order_dtype" in kw:
                kw["order_dtype"] = getattr(types, kw["order_dtype"])
            data = None if s["data"] is None \
                else conv(getattr(INP, s["data"]))
            wspecs.append(win.WindowSpec(
                s["kind"], data, None if data is None else conv(INP.nulls),
                **kw))
        outs.append(win.compute_windows(part_ops, order_ops, wspecs,
                                        conv(INP.sel)))
    return {name: (r, p) for name, r, p in zip(specs, *outs)}


def _np(x):
    return None if x is None else \
        (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))


@pytest.mark.parametrize("part,order,name", _cases())
def test_compute_windows_matches_reference(part, order, name):
    (wd, wn), (gd, gn) = _computed(part, order)[name]
    spec = _group_specs(order)[name]
    wd, wn, gd, gn = map(_np, (wd, wn, gd, gn))
    live = INP.sel.copy()
    assert (wn is None) == (gn is None)
    if wn is not None:
        assert np.array_equal(wn[live], gn[live])
        live &= ~wn
    assert wd.dtype == gd.dtype and wd.shape == gd.shape == (CAP,)
    if wd.dtype.kind == "f":
        atol = RTOL * INP.float_magnitude if spec["frame_atol"] else 0.0
        np.testing.assert_allclose(gd[live], wd[live], rtol=RTOL, atol=atol)
    else:
        assert np.array_equal(gd[live], wd[live])
    assert live.any() or spec["kw"].get("rows_frame") in ((4, -2), (-3, 5))


def test_every_kind_and_frame_form_of_the_reference_is_compared():
    kinds = {s["kind"] for s in (*ORDERED.values(), *UNORDERED.values(),
                                 *_range_specs("asc").values())}
    assert kinds == {"row_number", "rank", "dense_rank", "percent_rank",
                     "cume_dist", "ntile", "lag", "lead", "first_value",
                     "last_value", "nth_value", "sum", "sum_float", "avg",
                     "count", "count_star", "min", "max"}
    fields = set().union(*(s["kw"] for s in (
        *ORDERED.values(), *UNORDERED.values(),
        *_range_specs("asc").values())))
    assert set(pwin.WindowSpec._fields) - fields \
        == {"kind", "data", "nulls", "whole_partition"}
    assert pwin.WindowSpec._fields == rwin.WindowSpec._fields


def test_whole_partition_flag_and_unknown_kinds():
    sel = _t(INP.sel)
    part = psk.encode_key(_t(INP.p), None, PT.INTEGER)
    order = psk.encode_key(_t(INP.o), None, PT.INTEGER)
    d = _t(INP.ints)
    whole, total = pwin.compute_windows(part, order, [
        pwin.WindowSpec("sum", d, None, whole_partition=True),
        pwin.WindowSpec("sum", d, None, rows_frame=(None, None))], sel)
    assert torch.equal(whole[0][sel], total[0][sel])
    with pytest.raises(NotImplementedError, match="window median"):
        pwin.compute_windows(part, order,
                             [pwin.WindowSpec("median", d, None)], sel)
    with pytest.raises(NotImplementedError, match="DISTINCT window"):
        pwin.compute_windows(part, order, [pwin.WindowSpec(
            "sum", d, None, distinct=True, rows_frame=(1, 1))], sel)


def test_offsets_beyond_the_batch_are_null():
    sel = _t(INP.sel)
    order = psk.encode_key(_t(INP.o), None, PT.INTEGER)
    for kind in ("lag", "lead"):
        (d, n), = pwin.compute_windows([], order, [pwin.WindowSpec(
            kind, _t(INP.ints), None, offset=CAP + 44)], sel)
        assert d.shape == (CAP,) and bool(n[sel].all())


def test_ties_resolve_by_input_row():
    # all ORDER BY keys equal: row_number, lag and first_value must
    # follow the input order
    sel = torch.ones(CAP, dtype=torch.bool)
    order = [torch.zeros(CAP, dtype=torch.int32)]
    data = torch.arange(CAP, dtype=torch.int64) * 10
    rn, lag, first = pwin.compute_windows([], order, [
        pwin.WindowSpec("row_number", None, None),
        pwin.WindowSpec("lag", data, None),
        pwin.WindowSpec("first_value", data, None)], sel)
    assert rn[0].tolist() == list(range(1, CAP + 1))
    assert lag[0][1:].tolist() == data[:-1].tolist() and bool(lag[1][0])
    assert int(first[0].max()) == 0


def test_float_frames_do_not_inherit_other_partitions():
    # a partition of 1e15-sized values sorts before one of 1e-3-sized
    # values: framed and running sums of the second must stay exact to
    # 1e-12 of ITS magnitude (a global prefix sum would lose them whole)
    rng = np.random.default_rng(8)
    n = CAP
    part = (np.arange(n) >= n // 2).astype(np.int32)
    vals = np.where(part == 0, rng.normal(0, 1e15, n),
                    rng.normal(0, 1e-3, n))
    sel = torch.ones(n, dtype=torch.bool)
    pops = psk.encode_key(_t(part), None, PT.INTEGER)
    oops = [torch.arange(n, dtype=torch.int32)]
    d = _t(vals)
    framed, running, avg = pwin.compute_windows(pops, oops, [
        pwin.WindowSpec("sum_float", d, None, rows_frame=(3, 2)),
        pwin.WindowSpec("sum_float", d, None),
        pwin.WindowSpec("avg", d, None, rows_frame=(None, 0))], sel)
    for i in range(n):
        lo = max(i - 3, 0 if part[i] == 0 else n // 2)
        hi = min(i + 2, n // 2 - 1 if part[i] == 0 else n - 1)
        start = 0 if part[i] == 0 else n // 2
        scale = np.abs(vals[start:start + n // 2]).sum()
        want_f = math.fsum(vals[lo:hi + 1])
        want_r = math.fsum(vals[start:i + 1])
        assert abs(float(framed[0][i]) - want_f) <= RTOL * scale
        assert abs(float(running[0][i]) - want_r) <= RTOL * scale
        assert abs(float(avg[0][i]) - want_r / (i - start + 1)) \
            <= RTOL * scale


def test_framed_minmax_table_is_bounded(monkeypatch):
    sel = _t(INP.sel)
    order = psk.encode_key(_t(INP.o), None, PT.INTEGER)
    spec = pwin.WindowSpec("min", _t(INP.ints), None, rows_frame=(40, 40))
    pwin.compute_windows([], order, [spec], sel)
    monkeypatch.setattr(pwin, "MAX_SPARSE_TABLE_BYTES", 4 * CAP * 3)
    with pytest.raises(MemoryError, match="sparse table"):
        pwin.compute_windows([], order, [spec], sel)
    # a narrow frame needs fewer levels and still fits
    pwin.compute_windows([], order, [spec._replace(rows_frame=(1, 1))], sel)


# ---- SQL ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, cols in window_cases.tables().items():
        ref.register(name, cols)
        port.register(name, cols)
    return ref, port


# float sums over explicit frames, see the module docstring
GLOBAL_PREFIX_CASES = {"rows_centered_avg"}


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


@pytest.mark.parametrize("name", list(window_cases.WINDOW))
def test_window_sql_matches_reference(cons, name):
    ref, port = cons
    sql = window_cases.WINDOW[name]
    want = ref.execute(sql)
    got = port.execute(sql)
    assert got.batch.sel.device.type == "cpu"
    assert got.column_names == want.column_names
    atol = 0.0
    if name in GLOBAL_PREFIX_CASES:
        f = [x for x in window_cases.tables()["w"]["f"] if x is not None]
        atol = RTOL * sum(abs(x) for x in f)
    same_rows(want.fetchall(), got.fetchall(), atol)
    if name in window_cases.EXPECTED:
        assert got.fetchall() == window_cases.EXPECTED[name]
    else:
        assert len(got.fetchall()) > 0


@pytest.mark.parametrize("name", list(window_cases.PORT_ONLY))
def test_window_sql_the_reference_cannot_run(cons, name):
    ref, port = cons
    sql = window_cases.PORT_ONLY[name]
    with pytest.raises(Exception):
        ref.execute(sql).fetchall()
    assert port.execute(sql).fetchall() == window_cases.EXPECTED[name]


def test_corpus_holds_every_statement_of_the_reference_window_tests():
    import os
    import re
    root = os.path.dirname(os.path.abspath(__file__))
    corpus = " ".join(window_cases.WINDOW.values())
    squeezed = re.sub(r"\s+", " ", corpus)
    for fn in ("test_window.py", "test_window_over_agg.py"):
        with open(os.path.join(root, fn)) as f:
            src = f.read()
        # every OVER clause of the reference's tests appears in the corpus
        for m in re.finditer(r"OVER\s*(\([^()]*(?:\([^()]*\)[^()]*)*\)|win)",
                             re.sub(r'"\s*\n\s*"', "", src)):
            clause = re.sub(r"\s+", " ", m.group(0))
            assert clause in squeezed, (fn, clause)

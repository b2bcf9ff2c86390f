"""bench/clickbench.py of ddb_tpu_torch against ddb_tpu's on the CPU at
50,000 rows: the generator's columns (the port's decoded from codes and
dictionaries), every statement of SHAPES through both packages'
connect(), and the three numpy oracles.

Rows must match exactly, floats to 1e-12 relative.  The statements are
written in the shape of ClickBench queries; the suite's official texts
are not in the repository.  HAVING and OFFSET take smaller numbers than
at 1e8 rows, where the defaults of shapes() apply: at this size they
would leave nothing.  sel_sample draws from another generator than the
reference's and is held by its properties.
"""

import math

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.bench import clickbench as rcb
from ddb_tpu_torch.bench import clickbench as pcb
from ddb_tpu_torch.bench import select_cases
from ddb_tpu_torch.plan import physical

from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

N = 50_000
MIN_COUNT, OFFSET = 100, 100
SMALL = pcb.shapes(MIN_COUNT, OFFSET)


@pytest.fixture(scope="module")
def data():
    return rcb.generate(N), pcb.generate(N)


@pytest.fixture(scope="module")
def cons(data):
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    rcb.register(ref, data[0])
    pcb.register(port, data[1])
    return ref, port


def test_generator_matches_reference(data):
    want, got = data
    assert list(got) == list(want) and len(want) == 25
    for name in want:
        g = got[name]
        if isinstance(g, pcb.Coded):
            assert g.codes.dtype == np.int32
            assert list(g.values) == sorted(set(g.values))
            assert np.array_equal(g.decode(), want[name]), name
        else:
            assert g.dtype == want[name].dtype, name
            assert np.array_equal(g, want[name]), name


def test_registered_table_matches_reference(cons):
    ref, port = cons
    rt, pt = ref.catalog.get_table("hits"), port.catalog.get_table("hits")
    assert pt.num_rows == rt.num_rows == N
    for w, g in zip(rt.columns, pt.columns, strict=True):
        assert (w.name, repr(w.dtype)) == (g.name, repr(g.dtype))
        if w.strdict is None:
            assert g.strdict is None and np.array_equal(w.data, g.data)
        else:
            assert np.array_equal(w.strdict.values[w.data],
                                  g.strdict.values[g.data])


@pytest.mark.parametrize("name", [n for n in SMALL if n not in pcb.DRAWS])
def test_shape_matches_reference(cons, name):
    ref, port = cons
    want, got = ref.execute(SMALL[name]), port.execute(SMALL[name])
    assert got.column_names == want.column_names
    assert got.batch.sel.device.type == "cpu"
    assert first_difference(want.fetchall(),
                                         got.fetchall()) is None
    assert len(got.fetchall()) > 0
    assert port.execute(SMALL[name]).fetchall() == got.fetchall()


def test_shapes_differ_from_the_small_ones_only_in_their_numbers():
    assert list(pcb.SHAPES) == list(SMALL)
    for name, sql in pcb.SHAPES.items():
        small = SMALL[name]
        assert sql.replace("> 100000", f"> {MIN_COUNT}") \
            .replace("OFFSET 1000", f"OFFSET {OFFSET}") == small
    assert pcb.shapes() == pcb.SHAPES


def test_sample_shape_properties(cons, data):
    ref, port = cons
    sql = SMALL["sel_sample"]
    (cnt, total), = port.execute(sql).fetchall()
    assert abs(cnt - N * 0.01) <= 5 * math.sqrt(N * 0.01 * 0.99)
    assert 800 * cnt <= total < 2560 * cnt
    assert port.execute(sql).fetchall() == [(cnt, total)]     # REPEATABLE
    (rcnt, _), = ref.execute(sql).fetchall()
    assert abs(rcnt - N * 0.01) <= 5 * math.sqrt(N * 0.01 * 0.99)


def test_like_count_oracle(cons, data):
    _, port = cons
    want = pcb.like_count_oracle(data[1])
    assert port.execute(SMALL["cb_like_count"]).fetchall() == want
    urls = data[0]["URL"]
    assert want == [(int(sum("google" in u for u in urls)),)]


def test_len_oracle(cons, data):
    _, port = cons
    want = pcb.len_oracle(data[1], MIN_COUNT)
    got = port.execute(SMALL["cb_len"]).fetchall()
    assert len(want) == 25
    assert first_difference(want, got) is None


def test_trunc_minute_oracle(cons, data):
    _, port = cons
    want = pcb.trunc_minute_oracle(data[1], OFFSET)
    assert len(want) == 10
    assert port.execute(SMALL["cb_trunc_minute"]).fetchall() == want


def test_models_go_to_the_host_reduced(cons):
    _, port = cons
    before = physical.HOST_AGG_STATS["rows_fetched"]
    rows = port.execute(SMALL["sel_models"]).fetchall()
    # 100 regions x 20 models: the device's DISTINCT leaves 2,000 rows
    assert physical.HOST_AGG_STATS["rows_fetched"] - before == 2000
    assert len(rows) == 100 and all(len(r[1]) == 20 for r in rows)
    assert all(r[2].split(",") == r[1] for r in rows)
    back = port.execute(SMALL["sel_models_unnest"]).fetchall()
    assert back == [(r[0], m) for r in rows for m in r[1]]


def test_day_spine_has_a_row_a_day(cons, data):
    _, port = cons
    rows = port.execute(SMALL["sel_day_spine"]).fetchall()
    assert len(rows) == 90
    days = np.bincount(data[1]["EventDate"] - 15860, minlength=90)
    # the spine starts on 2013-06-04 (day 15860)
    assert [c for _, c in rows] == days[:90].tolist()

"""The aggregates of variable size, which run on the host, in
ddb_tpu_torch against ddb_tpu on the CPU: list, string_agg (DISTINCT,
ORDER BY), histogram in its three modes, approx_top_k, mad and user
aggregates, alone and mixed with sum/avg/min/max, through both packages'
connect() on the statements of bench/select_cases.py.

Rows must match exactly (lists and maps element by element), floats to
1e-12 relative.  One named deviation: a wide (two-limb) sum as the
operand of a host aggregate, which the reference package reads by its
low word only (ROADMAP.md section 3).
"""

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch.bench import select_cases
from ddb_tpu_torch.plan import physical

from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401


@pytest.fixture(scope="module")
def cons():
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, cols in select_cases.tables().items():
        ref.register(name, cols)
        port.register(name, cols)
    select_cases.setup(ref)
    select_cases.setup(port)
    return ref, port


@pytest.mark.parametrize("name", list(select_cases.HOST_AGG))
def test_host_aggregate_sql_matches_reference(cons, name):
    ref, port = cons
    sql = select_cases.HOST_AGG[name]
    want, got = ref.execute(sql), port.execute(sql)
    assert got.column_names == want.column_names
    assert got.batch.sel.device.type == "cpu"
    assert first_difference(want.fetchall(),
                                         got.fetchall()) is None
    assert len(got.fetchall()) > 0
    # the stores are refilled by a second run of the cached plan
    assert first_difference(
        got.fetchall(), port.execute(sql).fetchall()) is None


def test_every_host_kind_is_in_the_corpus(cons, monkeypatch):
    _, port = cons
    kinds = set()
    inner = physical._exec_aggregate_host

    def recording(node, ctx):
        kinds.update(a.kind for a in node.aggs)
        return inner(node, ctx)

    monkeypatch.setattr(physical, "_exec_aggregate_host", recording)
    for sql in select_cases.HOST_AGG.values():
        port.execute(sql)
    assert set(physical._HOST_AGG_KINDS) <= kinds
    assert {"sum", "avg", "min", "max", "count", "count_star",
            "any_value"} <= kinds


def test_histogram_modes(cons):
    _, port = cons
    m, = port.execute(select_cases.HOST_AGG["histogram_bins"]).fetchone()
    assert m[10] == 11 and m[20] == 10 and m[2**63 - 1] == 19
    me, = port.execute(select_cases.HOST_AGG["histogram_exact"]).fetchone()
    assert me == {5: 1, 99: 0}
    plain = port.execute("SELECT histogram(k) FROM g").fetchone()[0]
    k = select_cases.tables()["g"]["k"]
    assert plain == {int(v): int((k == v).sum()) for v in np.unique(k)}


def test_wide_sum_operand_is_recombined(cons):
    ref, port = cons
    sql = select_cases.DEVIATIONS["host_over_wide_sum"]
    g = select_cases.tables()["g"]
    want = {}
    for key, v in zip(g["g"], g["v"]):
        want[key] = want.get(key, 0) + (v or 0) * 300000000000000000
    got = port.execute(sql).fetchall()
    assert got == [(k, [want[k]]) for k in sorted(want)]
    assert max(want.values()) > 2**63          # it does not fit int64
    # the reference returns the low word's wrap-around
    assert ref.execute(sql).fetchall() != got


def test_rows_fetched_are_counted(cons):
    _, port = cons
    before = physical.HOST_AGG_STATS["rows_fetched"]
    port.execute(select_cases.HOST_AGG["list_ungrouped"])
    assert physical.HOST_AGG_STATS["rows_fetched"] == before + 3
    # the device reduces first: the host sees the distinct rows only
    before = physical.HOST_AGG_STATS["rows_fetched"]
    port.execute(select_cases.HOST_AGG["host_over_device_distinct"])
    n = port.execute("SELECT count(*) FROM (SELECT DISTINCT g, s FROM g "
                     "WHERE s IS NOT NULL)").fetchone()[0]
    assert physical.HOST_AGG_STATS["rows_fetched"] == before + n
    assert n < select_cases.ROWS


def test_collect_without_order_by_keeps_input_order(cons):
    ref, port = cons
    sql = "SELECT k, list(id) FROM (SELECT k, v AS id FROM g) GROUP BY k " \
          "ORDER BY k"
    got = port.execute(sql).fetchall()
    assert got == ref.execute(sql).fetchall()
    g = select_cases.tables()["g"]
    for k, ids in got:
        assert ids == [v for kk, v in zip(g["k"], g["v"])
                       if kk == k and v is not None]


def test_user_aggregate_registry(cons):
    _, port = cons
    assert set(port._agg_udfs) == {"geomean", "firstlast"}
    v0 = port.catalog.version
    port.create_aggregate("cnt", lambda: [0],
                          lambda st, v: st.__setitem__(0, st[0] + 1),
                          lambda st: st[0])
    assert port.catalog.version > v0          # cached plans are dropped
    assert port.execute("SELECT cnt(v) FROM gm").fetchall() == [(3,)]
    del port._agg_udfs["cnt"]

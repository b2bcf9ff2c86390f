"""Time zones, TIMETZ casts, temporal values rendered to VARCHAR, and
Python scalar functions in ddb_tpu_torch against ddb_tpu on the CPU,
through both packages' connect() on the statements of
bench/select_cases.py (those of the reference package's test_tz,
test_timestamptz and test_udf).

Rows must match exactly, floats to 1e-12 relative.  One named deviation:
instants before 1970 under a zone, where the reference package's device
lookup is off by one transition (ROADMAP.md section 3); the port is held
against zoneinfo there.
"""

import datetime
from zoneinfo import ZoneInfo

import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu import tz as rtz
from ddb_tpu_torch import batch as pbatch
from ddb_tpu_torch import types as PT
from ddb_tpu_torch import tz as ptz
from ddb_tpu_torch.bench import select_cases
from ddb_tpu_torch.expr import compile as pcompile
from ddb_tpu_torch.expr import functions as pfunctions
from ddb_tpu_torch.expr import ir as pir

from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

UTC = datetime.timezone.utc


def _connections(zone=None):
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    for name, cols in select_cases.tables().items():
        ref.register(name, cols)
        port.register(name, cols)
    select_cases.setup(ref)
    select_cases.setup(port)
    if zone:
        select_cases.set_timezone(ref, zone)
        select_cases.set_timezone(port, zone)
    return ref, port


@pytest.fixture(scope="module")
def cons():
    return _connections()


@pytest.fixture(scope="module")
def zoned():
    return _connections(select_cases.ZONE)


def _compare(ref, port, sql):
    want, got = ref.execute(sql), port.execute(sql)
    assert got.column_names == want.column_names
    assert first_difference(want.fetchall(),
                                         got.fetchall()) is None
    assert len(got.fetchall()) > 0
    return got


@pytest.mark.parametrize("name", list(select_cases.TZ))
def test_tz_sql_matches_reference(cons, name):
    _compare(*cons, select_cases.TZ[name])


@pytest.mark.parametrize("name", list(select_cases.ZONED))
def test_zoned_sql_matches_reference(zoned, name):
    _compare(*zoned, select_cases.ZONED[name])


@pytest.mark.parametrize("name", ["stringify_timestamps", "stringify_dates",
                                  "udf_varchar_return", "udf_over_seeded",
                                  "timezone_column"])
def test_cached_plan_gives_the_same_rows_again(cons, name):
    # the runtime dictionaries (out_sd.values) are rewritten by each
    # execution of a plan; the second run of the same text must agree
    _, port = cons
    sql = select_cases.TZ[name]
    first = port.execute(sql).fetchall()
    again = port.execute(sql)
    assert again.fetchall() == first
    # and after another statement filled other dictionaries in between
    port.execute(select_cases.TZ["udf_varchar_return_length"])
    assert port.execute(sql).fetchall() == first


def test_unknown_zone_errors(cons):
    _, port = cons
    with pytest.raises(Exception):
        port.execute("SELECT timezone('Not/AZone', "
                     "TIMESTAMP '2024-01-01 00:00:00')")


def test_instants_before_1970_follow_zoneinfo(cons):
    ref, port = cons
    sql = select_cases.DEVIATIONS["timezone_before_1970"]
    got = port.execute(sql).fetchall()
    ny, berlin = ZoneInfo("America/New_York"), ZoneInfo("Europe/Berlin")
    want = []
    for t in sorted(select_cases.tables()["old"]["t"]):
        want.append((t, t.replace(tzinfo=ny).astimezone(UTC),
                     t.replace(tzinfo=UTC).astimezone(berlin)
                     .replace(tzinfo=None)))
    assert got == want
    # the reference's device lookup lands one transition off here
    assert ref.execute(sql).fetchall() != want


def test_zone_tables_are_the_reference_ones():
    for zone in ("America/New_York", "Europe/Berlin", "Asia/Kolkata", "UTC"):
        for a, b in zip(rtz.zone_table(zone), ptz.zone_table(zone)):
            assert np.array_equal(a, b)


def test_zone_tables_go_to_the_device_once_a_plan(cons, monkeypatch):
    _, port = cons
    sql = select_cases.TZ["timezone_column"]
    port.execute(sql)
    made = []
    real = torch.as_tensor

    def counting(*a, **kw):
        made.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(pfunctions.torch, "as_tensor", counting)
    port.execute(sql)
    assert made == []            # the cached plan's node keeps its tables


def test_timetz_casts_pack_like_the_reference():
    us = torch.tensor([0, 1, 86_399_999_999, 45_296_000_000,
                       -1, -86_400_000_001], dtype=torch.int64)
    for src, dst in ((PT.TIME, PT.TIMETZ), (PT.TIMESTAMP, PT.TIMETZ),
                     (PT.TIMESTAMPTZ, PT.TIMETZ)):
        packed = pcompile._cast_data(us, src, dst)
        tod = torch.remainder(us, 86_400_000_000) \
            if src != PT.TIME else us
        assert torch.equal(packed, tod * 131072 + 57599)
        back = pcompile._cast_data(packed, PT.TIMETZ, PT.TIME)
        assert torch.equal(back, torch.remainder(tod, 86_400_000_000))
    # an offset of +05:00 comes back as the wall clock there
    packed = torch.tensor([(36_000_000_000 - 18_000_000_000) * 131072
                           + (57599 - 18000)], dtype=torch.int64)
    assert pcompile._cast_data(packed, PT.TIMETZ, PT.TIME).tolist() \
        == [36_000_000_000]


def test_python_function_runs_only_on_live_non_null_rows(cons):
    _, port = cons
    seen = []

    def spy(x):
        seen.append(x)
        return x * 2

    port.create_function("spy", spy)
    rows = port.execute("SELECT spy(a) FROM u WHERE a <> 2 ORDER BY a"
                        ).fetchall()
    assert rows == [(2,), (6,)]
    assert sorted(seen) == [1, 3]       # not the filtered row, not the NULL
    del port._udfs["spy"]


def test_python_function_that_raises_fails_the_query(cons):
    _, port = cons
    port.create_function("boom", lambda x: 1 // 0)
    with pytest.raises(ZeroDivisionError):
        port.execute("SELECT boom(a) FROM u")
    del port._udfs["boom"]


def test_host_seams_are_counted(cons):
    _, port = cons
    before = dict(pfunctions.HOST_CALLS)
    port.execute(select_cases.TZ["stringify_timestamps"])
    assert pfunctions.HOST_CALLS["stringify"] == before["stringify"] + 1
    port.execute(select_cases.TZ["udf_varchar_return_length"])
    assert pfunctions.HOST_CALLS["pyudf"] == before["pyudf"] + 1
    assert pfunctions.HOST_CALLS["dictlookup"] == before["dictlookup"] + 1


def test_function_registry_bumps_the_catalog(cons):
    _, port = cons
    v0 = port.catalog.version
    port.create_function("ident", lambda x: x, "BIGINT")
    assert port.catalog.version > v0
    assert port._udfs["ident"][1] == PT.BIGINT
    port.create_function("ident", lambda x: x, PT.DOUBLE)
    assert port._udfs["ident"][1] == PT.DOUBLE
    del port._udfs["ident"]

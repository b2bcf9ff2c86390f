# Generated from tests/test_tz.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite tz); do not edit.
"""Time-zone conversions (reference: extension/icu/icu-timezone.cpp;
ground truth here is Python's zoneinfo over the same tzdata)."""

from ddb_tpu_torch.testing import refsuite
import datetime
from zoneinfo import ZoneInfo

import numpy as np
import pytest

import ddb_tpu_torch
from ddb_tpu_torch import tz as tzmod

UTC = datetime.timezone.utc
NY = ZoneInfo("America/New_York")


def _us(dt):
    return int(dt.timestamp() * 1_000_000)


@pytest.mark.parametrize("wall", [
    datetime.datetime(2024, 1, 15, 12, 0, 0),      # EST
    datetime.datetime(2024, 7, 15, 12, 0, 0),      # EDT
    datetime.datetime(2024, 3, 10, 1, 59, 59),     # just before spring-fwd
    datetime.datetime(2024, 11, 3, 0, 30, 0),      # before fall-back
    datetime.datetime(1969, 6, 1, 0, 0, 0),        # pre-epoch
    datetime.datetime(2035, 6, 1, 0, 0, 0),        # future (TZif v2 rules)
])
def test_wall_to_utc_matches_zoneinfo(wall):
    want = _us(wall.replace(tzinfo=NY))
    wall_us = _us(wall.replace(tzinfo=UTC))
    got = int(tzmod.wall_to_utc_np(
        np.asarray([wall_us], np.int64), "America/New_York")[0])
    assert got == want


@pytest.mark.parametrize("instant", [
    datetime.datetime(2024, 1, 15, 17, 0, 0, tzinfo=UTC),
    datetime.datetime(2024, 7, 15, 16, 0, 0, tzinfo=UTC),
    datetime.datetime(2024, 3, 10, 6, 59, 59, tzinfo=UTC),
    datetime.datetime(2024, 3, 10, 7, 0, 0, tzinfo=UTC),
])
def test_utc_to_wall_matches_zoneinfo(instant):
    local = instant.astimezone(NY).replace(tzinfo=UTC)
    got = int(tzmod.utc_to_wall_np(
        np.asarray([_us(instant)], np.int64), "America/New_York")[0])
    assert got == _us(local)


def test_sql_timezone_function():
    con = refsuite.connect()
    # wall clock in NY -> UTC instant (winter: +5h)
    rows = con.execute(
        "SELECT timezone('America/New_York', "
        "TIMESTAMP '2024-01-15 12:00:00')").fetchall()
    # r4: TIMESTAMP AT TIME ZONE returns TIMESTAMPTZ (aware instant)
    assert rows == [(datetime.datetime(2024, 1, 15, 17, 0, 0,
                                       tzinfo=UTC),)]
    # summer: +4h
    rows = con.execute(
        "SELECT TIMESTAMP '2024-07-15 12:00:00' "
        "AT TIME ZONE 'America/New_York'").fetchall()
    assert rows == [(datetime.datetime(2024, 7, 15, 16, 0, 0,
                                       tzinfo=UTC),)]
    # inverse direction
    rows = con.execute(
        "SELECT from_utc_timestamp(TIMESTAMP '2024-01-15 17:00:00', "
        "'America/New_York')").fetchall()
    assert rows == [(datetime.datetime(2024, 1, 15, 12, 0, 0),)]


def test_sql_timezone_column():
    con = refsuite.connect()
    con.execute("CREATE TABLE e (t TIMESTAMP)")
    con.execute("INSERT INTO e VALUES (TIMESTAMP '2024-01-15 12:00:00'),"
                " (TIMESTAMP '2024-07-15 12:00:00'), (NULL)")
    rows = con.execute(
        "SELECT timezone('America/New_York', t) FROM e ORDER BY t"
    ).fetchall()
    assert rows == [(datetime.datetime(2024, 1, 15, 17, 0,
                                       tzinfo=UTC),),
                    (datetime.datetime(2024, 7, 15, 16, 0,
                                       tzinfo=UTC),),
                    (None,)]


def test_unknown_zone_errors():
    con = refsuite.connect()
    with pytest.raises(Exception):
        con.execute("SELECT timezone('Not/AZone', "
                    "TIMESTAMP '2024-01-01 00:00:00')")


def test_current_date_and_timestamp():
    con = refsuite.connect()
    (d, ts, lts) = con.execute(
        "SELECT current_date, current_timestamp, "
        "current_localtimestamp").fetchall()[0]
    # r4: current_timestamp is TIMESTAMP WITH TIME ZONE (aware)
    now = datetime.datetime.now(UTC)
    assert abs((ts - now).total_seconds()) < 60
    now = now.replace(tzinfo=None)
    assert d in (now.date(), (now - datetime.timedelta(days=1)).date(),
                 (now + datetime.timedelta(days=1)).date())
    con.execute("SET timezone = 'America/New_York'")
    (lts2,) = con.execute("SELECT current_localtimestamp").fetchall()[0]
    off = (lts2 - datetime.datetime.now(UTC).replace(tzinfo=None)
           ).total_seconds()
    assert -6 * 3600 < off < -3 * 3600   # NY is UTC-4/-5


def test_timetz_real_type():
    """TIMETZ as a real logical type (round-5): UTC-instant ordering
    with descending-offset tiebreak, session-zone attachment for
    offset-less strings, TIME/TIMESTAMPTZ casts (reference: dtime_tz_t,
    src/include/duckdb/common/types/time.hpp; oracle-verified)."""
    import ddb_tpu_torch
    con = refsuite.connect()
    assert con.execute(
        "select timetz '10:00:00+05' < timetz '06:30:00+00'"
    ).fetchall() == [(True,)]
    assert con.execute(
        "select timetz '10:00:00+05' = timetz '05:00:00+00'"
    ).fetchall() == [(False,)]
    assert con.execute(
        "select (timetz '10:00:00+05')::varchar").fetchall() \
        == [('10:00:00+05',)]
    assert con.execute(
        "select ('2023-08-20 16:15:03.123456'::TIMESTAMP::TIMETZ)"
        "::varchar").fetchall() == [('16:15:03.123456+00',)]
    # ORDER BY = UTC order, ties broken by larger offset first
    rows = con.execute(
        "select t::varchar from (select unnest([timetz '05:00:00+00', "
        "timetz '10:00:00+05', timetz '00:00:00-05']) as t) "
        "order by t").fetchall()
    assert [r[0] for r in rows] == \
        ['10:00:00+05', '05:00:00+00', '00:00:00-05']
    # session zone attaches to offset-less strings
    con.execute("SET TimeZone='Asia/Singapore'")
    con.execute("create table stz(t timetz)")
    con.execute("insert into stz values ('12:34:56')")
    assert con.execute("select t::varchar from stz").fetchall() \
        == [('12:34:56+08',)]
    con.execute("SET TimeZone='UTC'")


def test_time_parsing_edges():
    import ddb_tpu_torch
    con = refsuite.connect()
    assert con.execute("select try_cast('11' as time)").fetchall() \
        == [(None,)]
    assert con.execute(
        "select try_cast('11:' as time)::varchar").fetchall() \
        == [('11:00:00',)]
    assert con.execute(
        "select '14:42:04.999999999'::TIME::VARCHAR").fetchall() \
        == [('14:42:04.999999',)]
    assert con.execute(
        "select ('2021-08-20'::TIME)::varchar").fetchall() \
        == [('00:00:00',)]
    # 24:00:00 is a valid TIME and survives rendering
    assert str(con.execute(
        "select try_cast('24:00:00' as time)").fetchall()[0][0]) \
        == "24:00:00"

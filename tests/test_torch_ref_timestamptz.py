# Generated from tests/test_timestamptz.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite timestamptz); do not edit.
"""TIMESTAMPTZ as a real logical type + interval arithmetic.

Reference parity targets: LogicalType::TIMESTAMP_TZ
(src/include/duckdb/common/types.hpp:185-234), ICU timezone ops
(extension/icu/icu-timezone.cpp), Interval::Add
(src/common/types/interval.cpp).
"""
from ddb_tpu_torch.testing import refsuite
import datetime

import ddb_tpu_torch


def fetch(con, sql):
    return con.execute(sql).fetchall()


def one(con, sql):
    return fetch(con, sql)[0][0]


def test_typeof_and_literal():
    con = refsuite.connect()
    assert one(con, "SELECT typeof('2024-01-01 00:00:00+02'"
                    "::TIMESTAMPTZ)") == "TIMESTAMP WITH TIME ZONE"
    v = one(con, "SELECT '2024-01-01 00:00:00+02'::TIMESTAMPTZ")
    assert v == datetime.datetime(2023, 12, 31, 22, 0,
                                  tzinfo=datetime.timezone.utc)


def test_with_time_zone_syntax():
    con = refsuite.connect()
    assert one(con, "SELECT typeof(CAST('2024-01-01' AS TIMESTAMP "
                    "WITH TIME ZONE))") == "TIMESTAMP WITH TIME ZONE"


def test_session_timezone_cast():
    con = refsuite.connect()
    con.execute("SET TimeZone='America/New_York'")
    # wall clock in NY -> instant (EST = UTC-5)
    v = one(con, "SELECT '2024-01-01 12:00:00'::TIMESTAMPTZ")
    assert v == datetime.datetime(2024, 1, 1, 17, 0,
                                  tzinfo=datetime.timezone.utc)
    # instant -> session wall for naive cast
    v = one(con, "SELECT ('2024-01-01 17:00:00+00'::TIMESTAMPTZ)"
                 "::TIMESTAMP")
    assert v == datetime.datetime(2024, 1, 1, 12, 0)
    # extraction happens in the session zone
    assert one(con, "SELECT year('2024-01-01 03:00:00+00'"
                    "::TIMESTAMPTZ)") == 2023


def test_at_time_zone():
    con = refsuite.connect()
    # naive AT TIME ZONE -> instant (TIMESTAMPTZ)
    v = one(con, "SELECT '2021-01-01 05:00:00'::TIMESTAMP "
                 "AT TIME ZONE 'America/New_York'")
    assert v == datetime.datetime(2021, 1, 1, 10, 0,
                                  tzinfo=datetime.timezone.utc)
    # TIMESTAMPTZ AT TIME ZONE -> wall clock (naive)
    v = one(con, "SELECT ('2021-01-01 10:00:00+00'::TIMESTAMPTZ) "
                 "AT TIME ZONE 'America/New_York'")
    assert v == datetime.datetime(2021, 1, 1, 5, 0)


def test_storage_order_aggregate():
    con = refsuite.connect()
    con.execute("CREATE TABLE tt(t TIMESTAMPTZ)")
    con.execute("INSERT INTO tt VALUES ('2024-06-15 10:00:00+05'), "
                "(NULL), ('2024-06-15 03:00:00-03')")
    rows = fetch(con, "SELECT t FROM tt ORDER BY t")
    assert rows[0][0] == datetime.datetime(
        2024, 6, 15, 5, 0, tzinfo=datetime.timezone.utc)
    assert rows[2][0] is None
    assert one(con, "SELECT count(*) FROM tt WHERE t > "
                    "'2024-06-15 05:30:00+00'") == 1


def test_comparison_mixed():
    con = refsuite.connect()
    assert one(con, "SELECT '2024-01-01 00:00:00+00'::TIMESTAMPTZ = "
                    "'2024-01-01 01:00:00+01'::TIMESTAMPTZ") is True
    assert one(con, "SELECT '2024-01-01 00:00:00+00'::TIMESTAMPTZ > "
                    "TIMESTAMP '2023-01-01 00:00:00'") is True


def test_now_is_tstz():
    con = refsuite.connect()
    assert one(con, "SELECT typeof(now())") == "TIMESTAMP WITH TIME ZONE"
    assert one(con, "SELECT typeof(current_timestamp)") \
        == "TIMESTAMP WITH TIME ZONE"


def test_interval_add_hours():
    con = refsuite.connect()
    assert one(con, "SELECT TIMESTAMP '2024-01-01 00:00:00' + "
                    "INTERVAL 1 HOUR") \
        == datetime.datetime(2024, 1, 1, 1, 0)
    assert one(con, "SELECT '2024-01-01 00:00:00+00'::TIMESTAMPTZ "
                    "+ INTERVAL 90 MINUTE") \
        == datetime.datetime(2024, 1, 1, 1, 30,
                             tzinfo=datetime.timezone.utc)


def test_interval_add_months_clamps():
    con = refsuite.connect()
    assert one(con, "SELECT TIMESTAMP '2024-01-31 10:00:00' + "
                    "INTERVAL 1 MONTH") \
        == datetime.datetime(2024, 2, 29, 10, 0)
    assert one(con, "SELECT TIMESTAMP '2024-03-31 10:00:00' - "
                    "INTERVAL 1 MONTH") \
        == datetime.datetime(2024, 2, 29, 10, 0)
    con.execute("CREATE TABLE ti(t TIMESTAMP)")
    con.execute("INSERT INTO ti VALUES ('2023-01-31 01:02:03')")
    assert one(con, "SELECT t + INTERVAL 1 MONTH FROM ti") \
        == datetime.datetime(2023, 2, 28, 1, 2, 3)
    assert one(con, "SELECT t + INTERVAL 1 YEAR FROM ti") \
        == datetime.datetime(2024, 1, 31, 1, 2, 3)


def test_timestamp_difference_is_interval():
    con = refsuite.connect()
    v = one(con, "SELECT TIMESTAMP '2024-01-02 02:00:00' - "
                 "TIMESTAMP '2024-01-01 00:00:00'")
    assert v == datetime.timedelta(days=1, hours=2)


def test_time_interval_wraps():
    con = refsuite.connect()
    assert one(con, "SELECT TIME '23:30:00' + INTERVAL 1 HOUR") \
        == datetime.time(0, 30)


def test_date_subday_interval_promotes():
    con = refsuite.connect()
    assert one(con, "SELECT DATE '2024-01-01' + INTERVAL 36 HOUR") \
        == datetime.datetime(2024, 1, 2, 12, 0)


def test_render_format():
    from ddb_tpu_torch.testing.sqllogic import _RENDER_TZ, _format_value
    _RENDER_TZ[0] = "UTC"
    v = datetime.datetime(2024, 1, 1, 10, 30,
                          tzinfo=datetime.timezone.utc)
    assert _format_value(v) == "2024-01-01 10:30:00+00"
    _RENDER_TZ[0] = "Asia/Kolkata"     # +05:30
    assert _format_value(v) == "2024-01-01 16:00:00+05:30"
    _RENDER_TZ[0] = "UTC"
    assert _format_value(datetime.timedelta(days=1, hours=2)) \
        == "1 day 02:00:00"
    assert _format_value(datetime.timedelta(hours=-2)) == "-02:00:00"


def test_tstz_group_by_and_join():
    con = refsuite.connect()
    con.execute("CREATE TABLE ev(t TIMESTAMPTZ, v INTEGER)")
    con.execute("INSERT INTO ev VALUES "
                "('2024-01-01 10:00:00+00', 1), "
                "('2024-01-01 11:00:00+01', 2), "   # same instant as #1
                "('2024-01-02 00:00:00+00', 3)")
    rows = fetch(con, "SELECT t, sum(v) FROM ev GROUP BY t ORDER BY t")
    assert len(rows) == 2
    assert rows[0][1] == 3

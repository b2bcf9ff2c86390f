# Generated from tests/test_wide_sums.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite wide_sums); do not edit.
"""Wide (i128-style two-limb) SUM/AVG exactness — the TPU-native analog of
the reference's hugeint aggregate states (reference:
extension/core_functions/aggregate/distributive/sum.cpp,
src/common/types/hugeint.cpp).  Narrow proofs come from plan/bounds.py
interval analysis; these tests cover both the forced-wide and the
proven-narrow paths."""

import decimal

import pytest

from ddb_tpu_torch.testing.refsuite import Connection


BIG = decimal.Decimal("9000000000000000.99")   # raw 9.0e17 at scale 2


@pytest.fixture()
def con():
    c = Connection()
    c.sql("CREATE TABLE t (g INTEGER, x DECIMAL(18,2))")
    c.sql("INSERT INTO t VALUES "
          + ",".join(f"({i % 2},{BIG})" for i in range(40)))
    return c


def test_ungrouped_wide_sum(con):
    (v,), = con.sql("SELECT sum(x) FROM t").fetchall()
    assert v == BIG * 40                      # 3.6e19 — beyond int64


def test_grouped_wide_sum(con):
    rows = con.sql("SELECT g, sum(x) FROM t GROUP BY g ORDER BY g") \
        .fetchall()
    assert rows == [(0, BIG * 20), (1, BIG * 20)]


def test_wide_avg(con):
    (v,), = con.sql("SELECT avg(x) FROM t").fetchall()
    assert abs(v - float(BIG)) < 1.0


def test_wide_distinct_sum(con):
    (v,), = con.sql("SELECT sum(DISTINCT x) FROM t").fetchall()
    assert v == BIG


def test_hugeint_sum_beyond_int64():
    c = Connection()
    c.sql("CREATE TABLE b (x BIGINT)")
    c.sql("INSERT INTO b VALUES (9000000000000000000),"
          "(9000000000000000000),(-1)")
    (v,), = c.sql("SELECT sum(x) FROM b").fetchall()
    assert v == 17999999999999999999


def test_order_by_wide_sum(con):
    rows = con.sql(
        "SELECT g, sum(x) s FROM t GROUP BY g ORDER BY s, g").fetchall()
    assert [g for g, _ in rows] == [0, 1]


def test_narrow_proof_still_exact():
    c = Connection()
    c.sql("CREATE TABLE s (x DECIMAL(10,2))")
    c.sql("INSERT INTO s VALUES (1.50),(2.25),(NULL)")
    (v,), = c.sql("SELECT sum(x) FROM s").fetchall()
    assert v == decimal.Decimal("3.75")


def test_sum_result_type_is_decimal38():
    c = Connection()
    c.sql("CREATE TABLE s (x DECIMAL(10,2))")
    c.sql("INSERT INTO s VALUES (1.00)")
    r = c.sql("SELECT sum(x) FROM s")
    t = r.column_types[0]
    assert repr(t) == "DECIMAL(38,2)"


def test_wide_sum_in_having():
    c = Connection()
    c.sql("CREATE TABLE t2 (g INTEGER, x DECIMAL(18,2))")
    c.sql("INSERT INTO t2 VALUES "
          + ",".join(f"(0,{BIG})" for _ in range(4))
          + ",(1, 5.00)")
    rows = c.sql("SELECT g FROM t2 GROUP BY g "
                 "HAVING sum(x) > 100 ORDER BY g").fetchall()
    assert rows == [(0,)]

# Generated from tests/test_advice_r4.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite advice_r4); do not edit.
"""Regression tests for round-3 advisor findings (ADVICE.md)."""
from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture
def con():
    c = refsuite.connect()
    yield c
    c.close()


def test_insert_default_values_no_defaults(con):
    # ADVICE r3: IndexError when no column has a DEFAULT
    con.execute("CREATE TABLE nd(a INTEGER, b VARCHAR)")
    con.execute("INSERT INTO nd DEFAULT VALUES")
    assert con.execute("SELECT * FROM nd").fetchall() == [(None, None)]


def test_insert_default_values_mixed(con):
    con.execute("CREATE TABLE md(a INTEGER DEFAULT 7, b VARCHAR)")
    con.execute("INSERT INTO md DEFAULT VALUES")
    assert con.execute("SELECT * FROM md").fetchall() == [(7, None)]


def test_udf_not_called_on_filtered_rows(con):
    # ADVICE r3: UDF raising on filtered-out / NULL rows crashed query
    d = {1: 100, 2: 200}
    con.create_function("lk_adv", lambda a: d[a], "BIGINT")
    con.execute("CREATE TABLE ufr(a INTEGER)")
    con.execute("INSERT INTO ufr VALUES (1),(2),(99),(NULL)")
    rows = con.execute(
        "SELECT lk_adv(a) FROM ufr WHERE a < 3 ORDER BY a").fetchall()
    assert rows == [(100,), (200,)]


def test_argext_null_payload_fallback(con):
    # ADVICE r3: arg_min/arg_max must skip NULL-payload rows and fall
    # back to the next-extremal row (reference: arg_min_max.cpp)
    con.execute("CREATE TABLE amx(g INTEGER, by_ INTEGER, p VARCHAR)")
    con.execute("INSERT INTO amx VALUES (1,1,NULL),(1,2,'b'),(1,3,'c'),"
                "(2,5,NULL)")
    assert con.execute(
        "SELECT g, arg_min(p, by_) FROM amx GROUP BY g ORDER BY g"
    ).fetchall() == [(1, 'b'), (2, None)]
    assert con.execute(
        "SELECT arg_min(p, by_), arg_max(p, by_) FROM amx"
    ).fetchall() == [('b', 'c')]


def test_wal_negative_increment_sequence(tmp_path):
    # ADVICE r3: WAL replay used max(), re-issuing values for
    # negative-increment sequences after a crash
    db = str(tmp_path / "seqneg.dtb")
    c = refsuite.connect(db)
    c.execute("CREATE SEQUENCE sneg INCREMENT -1 START 10 MINVALUE 0")
    assert c.execute("SELECT nextval('sneg')").fetchone()[0] == 10
    assert c.execute("SELECT nextval('sneg')").fetchone()[0] == 9
    # simulate a crash: flush the WAL but skip checkpoint-on-close so
    # reopen goes through WAL replay
    c._wal.flush()
    c._wal = None
    c2 = refsuite.connect(db)
    assert c2.execute("SELECT nextval('sneg')").fetchone()[0] == 8
    c2.close()

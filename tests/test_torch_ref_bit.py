# Generated from tests/test_bit.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite bit); do not edit.
"""BIT (bitstring) type tests.

Reference: test/sql/types/bit/*.test + src/common/types/bit.cpp.  BIT is
dictionary-encoded (canonical '0'/'1' text, int32 codes on device); all
operators are bind-time per-code tables.
"""

from ddb_tpu_torch.testing import refsuite
import pytest

import ddb_tpu_torch


@pytest.fixture
def con():
    return refsuite.connect()


def q(con, sql):
    return con.sql(sql).fetchall()


def test_bit_cast_and_roundtrip(con):
    assert q(con, "SELECT '0101011'::BIT") == [("0101011",)]
    assert q(con, "SELECT '0101011'::BITSTRING") == [("0101011",)]
    assert q(con, "SELECT NULL::BIT") == [(None,)]
    assert q(con, "SELECT TRY_CAST('102' AS BIT)") == [(None,)]
    assert q(con, "SELECT TRY_CAST('101' AS BIT)") == [("101",)]
    with pytest.raises(Exception, match="empty string"):
        q(con, "SELECT ''::BIT")
    with pytest.raises(Exception, match="Invalid character"):
        q(con, "SELECT '0121'::BIT")
    with pytest.raises(Exception, match="modifiers"):
        q(con, "SELECT '0101011'::BIT(10)")


def test_bit_table_storage(con):
    con.sql("CREATE TABLE bits (b bit)")
    con.sql("INSERT INTO bits VALUES ('101011010'), ('111'), (NULL)")
    assert q(con, "SELECT b FROM bits") == \
        [("101011010",), ("111",), (None,)]
    assert q(con, "SELECT b FROM bits WHERE b = '111'") == [("111",)]
    # bad inserts roll back whole statement
    with pytest.raises(Exception, match="Invalid character"):
        con.sql("INSERT INTO bits VALUES ('1A10')")
    assert q(con, "SELECT count(*) FROM bits") == [(3,)]
    with pytest.raises(Exception, match="empty string"):
        con.sql("INSERT INTO bits VALUES ('')")


def test_bit_functions(con):
    assert q(con, "SELECT bit_length('0'::BIT)") == [(1,)]
    assert q(con, "SELECT octet_length('101010111'::BIT)") == [(2,)]
    assert q(con, "SELECT bit_count('10101'::BIT)") == [(3,)]
    assert q(con, "SELECT get_bit('1010000'::BIT, 0)") == [(1,)]
    assert q(con, "SELECT set_bit('11111'::BIT, 0, 0)") == [("01111",)]
    assert q(con, "SELECT bit_position('010'::BIT, '1110101'::BIT)") \
        == [(4,)]
    assert q(con, "SELECT bit_position('11'::BIT, '000'::BIT)") == [(0,)]
    assert q(con, "SELECT bitstring('0101011'::VARCHAR, 15)") \
        == [("000000000101011",)]
    assert q(con, "SELECT bitstring('1'::BIT, 6)") == [("000001",)]
    with pytest.raises(Exception, match="out of valid range"):
        q(con, "SELECT get_bit('10101'::BIT, 6)")
    with pytest.raises(Exception, match="must be 1 or 0"):
        q(con, "SELECT set_bit('11111'::BIT, 2, 7)")
    with pytest.raises(Exception, match="Length must be"):
        q(con, "SELECT bitstring('0101011'::BIT, 3)")
    # per-code tables over a stored column
    con.sql("CREATE TABLE bt (b bit)")
    con.sql("INSERT INTO bt VALUES ('101001111'), ('00111')")
    assert q(con, "SELECT bit_length(b), bit_count(b) FROM bt") == \
        [(9, 6), (5, 3)]
    assert q(con, "SELECT set_bit(b, 3, 0) FROM bt") == \
        [("101001111",), ("00101",)]


def test_bit_operators(con):
    assert q(con, "SELECT '10101'::BIT & '10001'::BIT") == [("10001",)]
    assert q(con, "SELECT '1011'::BIT | '0001'::BIT") == [("1011",)]
    assert q(con, "SELECT xor('101'::BIT, '001'::BIT)") == [("100",)]
    assert q(con, "SELECT ~('101'::BIT)") == [("010",)]
    assert q(con, "SELECT '0110101'::BIT << 3") == [("0101000",)]
    assert q(con, "SELECT '0110101'::BIT >> 2") == [("0001101",)]
    with pytest.raises(Exception, match="different sizes"):
        q(con, "SELECT '010110'::BIT & '11000'::BIT")
    with pytest.raises(Exception, match="negative"):
        q(con, "SELECT '010101'::BIT << -2")
    # column (x) constant and column (x) column pair tables
    con.sql("CREATE TABLE bo (b bit)")
    con.sql("INSERT INTO bo VALUES ('101111011010'), ('110001100100')")
    assert q(con, "SELECT b & '011100011011'::BIT FROM bo") == \
        [("001100011010",), ("010000000000",)]
    assert q(con, "SELECT b | b FROM bo") == \
        [("101111011010",), ("110001100100",)]


def test_bit_blob_casts(con):
    assert q(con, "SELECT 'ab'::BLOB") == [(b"ab",)]
    assert q(con, "SELECT 'ab'::BLOB::BIT") == [("0110000101100010",)]
    assert q(con, "SELECT ('ab'::BLOB::BIT << 2)::BLOB") == \
        [(b"\x85\x88",)]
    # int -> bit uses the type's two's-complement width
    assert q(con, "SELECT 2::BIT") == \
        [("00000000000000000000000000000010",)]
    assert q(con, "SELECT (2::BIT & 2::BIT) = 2::BIT") == [(True,)]


def test_integer_bitwise(con):
    assert q(con, "SELECT 5 & 3, 5 | 3, xor(5, 3), ~5, 1 << 4, "
                  "256 >> 4") == [(1, 7, 6, -6, 16, 16)]
    con.sql("CREATE TABLE iv (x integer)")
    con.sql("INSERT INTO iv VALUES (1), (2), (12)")
    assert q(con, "SELECT x & 6, x | 1, x << 1, x >> 1 FROM iv") == \
        [(0, 1, 2, 0), (2, 3, 4, 1), (4, 13, 24, 6)]
    assert q(con, "SELECT 3 ^ 4") == [(81.0,)]


def test_bit_persistence(tmp_path):
    p = str(tmp_path / "bits.dtb")
    c = refsuite.connect(p)
    c.sql("CREATE TABLE bits (b bit)")
    c.sql("INSERT INTO bits VALUES ('10101')")
    c.sql("CHECKPOINT")
    c.close()
    c2 = refsuite.connect(p)
    assert q(c2, "SELECT b FROM bits") == [("10101",)]
    # declared BIT survives the round trip: validation still applies
    with pytest.raises(Exception, match="Invalid character"):
        c2.sql("INSERT INTO bits VALUES ('9')")
    c2.close()


def test_lateral_alias_refs(con):
    # select-item aliases usable in later items and WHERE (reference:
    # bind_select_node.cpp alias binding)
    assert q(con, "SELECT 1 AS x, x+1") == [(1, 2)]
    assert q(con, "SELECT 2 AS a, a*a AS b, b+a") == [(2, 4, 6)]
    assert q(con, "SELECT 1 AS 'my alias'") == [(1,)]
    con.sql("CREATE TABLE la (v integer)")
    con.sql("INSERT INTO la VALUES (1), (5)")
    assert q(con, "SELECT v*2 AS d FROM la WHERE d > 5") == [(10,)]
    # real columns take precedence over aliases
    assert q(con, "SELECT v+1 AS v FROM la WHERE v = 1") == [(2,)]

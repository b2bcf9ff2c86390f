# Generated from tests/test_pivot.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite pivot); do not edit.
"""PIVOT/UNPIVOT rewrites + cross-dictionary set-op alignment
(reference: parser/statement/pivot_statement.cpp,
planner/binder/tableref/bind_pivot.cpp)."""

import pytest

from ddb_tpu_torch.testing.refsuite import Connection


@pytest.fixture()
def con():
    c = Connection()
    c.sql("CREATE TABLE cities (country VARCHAR, nm VARCHAR, yr INTEGER,"
          " population INTEGER)")
    c.sql("INSERT INTO cities VALUES "
          "('NL','Ams',2000,1005),('NL','Ams',2010,1065),"
          "('US','Sea',2000,564),('US','Sea',2010,608),"
          "('US','NY',2000,8015),('US','NY',2010,8175)")
    return c


def test_pivot_discovered_values(con):
    r = con.sql("PIVOT cities ON yr USING sum(population)")
    assert r.column_names == ["country", "nm", "2000", "2010"]
    assert r.fetchall() == [("NL", "Ams", 1005, 1065),
                            ("US", "NY", 8015, 8175),
                            ("US", "Sea", 564, 608)]


def test_pivot_in_list_group_by(con):
    r = con.sql("PIVOT cities ON yr IN (2000, 2010) USING sum(population)"
                " GROUP BY country")
    assert r.fetchall() == [("NL", 1005, 1065), ("US", 8579, 8783)]


def test_pivot_multiple_aggs(con):
    r = con.sql("PIVOT cities ON yr IN (2000) USING sum(population) AS s,"
                " count(*) AS c GROUP BY country")
    assert r.column_names == ["country", "2000_s", "2000_c"]
    assert r.fetchall() == [("NL", 1005, 1), ("US", 8579, 2)]


def test_unpivot(con):
    r = con.sql("UNPIVOT cities ON yr, population INTO NAME k VALUE v")
    rows = sorted(r.fetchall())
    assert ("NL", "Ams", "yr", 2000) in rows
    assert ("NL", "Ams", "population", 1005) in rows
    assert len(rows) == 12


def test_union_across_dictionaries():
    c = Connection()
    c.sql("CREATE TABLE a1 (s VARCHAR)")
    c.sql("INSERT INTO a1 VALUES ('x'),('y')")
    c.sql("CREATE TABLE a2 (s VARCHAR)")
    c.sql("INSERT INTO a2 VALUES ('y'),('z')")
    assert sorted(c.sql(
        "SELECT s FROM a1 UNION SELECT s FROM a2").fetchall()) \
        == [("x",), ("y",), ("z",)]
    assert c.sql("SELECT s FROM a1 EXCEPT SELECT s FROM a2").fetchall() \
        == [("x",)]
    assert c.sql("SELECT s FROM a1 INTERSECT SELECT s FROM a2").fetchall() \
        == [("y",)]

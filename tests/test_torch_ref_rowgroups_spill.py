# Generated from tests/test_rowgroups_spill.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite rowgroups_spill); do not edit.
"""Row-group zone maps + TemporaryMemoryManager spill (round-5).

Reference: RowGroup/ColumnSegment zone-map skipping
(src/storage/table/row_group.hpp:70, column_segment.cpp CheckZonemap)
and TemporaryMemoryManager/TemporaryFileManager external-join
arbitration (src/storage/temporary_memory_manager.hpp:70,
execution/join_hashtable.cpp:609-735 external mode).
"""

from ddb_tpu_torch.testing import refsuite
import numpy as np
import pytest

import ddb_tpu_torch
from ddb_tpu_torch.plan import tiled
from ddb_tpu_torch.storage import table as TM
from ddb_tpu_torch.storage import tempmem


@pytest.fixture()
def con():
    c = refsuite.connect()
    yield c
    c.execute("SET memory_limit='100GB'")


def test_row_group_zone_map_skips_groups(con):
    n = 400_000
    v = np.arange(n, dtype=np.int64)
    w = np.random.default_rng(0).integers(0, 100, n)
    con.register("zm", {"v": v, "w": w})
    before = dict(TM.SCAN_STATS)
    r = con.execute("select count(*), sum(w) from zm "
                    "where v >= 300000 and v < 300500").fetchall()
    after = dict(TM.SCAN_STATS)
    assert r == [(500, int(w[300000:300500].sum()))]
    assert after["groups_total"] > before["groups_total"]
    assert after["groups_skipped"] > before["groups_skipped"]


def test_row_group_stats_invalidate_on_mutation(con):
    n = 300_000
    con.register("zmu", {"v": np.arange(n, dtype=np.int64)})
    t = con.catalog.get_table("zmu")
    s1 = t.row_group_stats()
    assert len(s1) == (n + TM.ROW_GROUP_SIZE - 1) // TM.ROW_GROUP_SIZE
    con.execute("insert into zmu values (99999999)")
    s2 = t.row_group_stats()
    assert int(s2[-1][0][1]) == 99999999


def test_external_join_spills_and_matches(con):
    rng = np.random.default_rng(1)
    nb, npr = 40_000, 90_000
    con.register("jb", {"k": rng.integers(0, 20_000, nb),
                        "b": rng.integers(0, 100, nb)})
    con.register("jp", {"k": rng.integers(0, 20_000, npr),
                        "p": rng.integers(0, 100, npr)})
    queries = [
        "select count(*), sum(b+p) from jp join jb on jp.k = jb.k",
        "select count(*), sum(coalesce(b,0)+coalesce(p,0)) "
        "from jp left join jb on jp.k = jb.k",
        "select count(*), sum(coalesce(b,0)+coalesce(p,0)) "
        "from jp full join jb on jp.k = jb.k",
        "select count(*) from jp where k in (select k from jb)",
    ]
    refs = [con.execute(q).fetchall() for q in queries]
    con.execute("SET memory_limit='100KB'")
    spilled0 = tempmem.FILES.stats()["bytes_spilled"]
    for q, ref in zip(queries, refs):
        before = tiled.EXTERNAL_JOIN_STATS["joins"]
        got = con.execute(q).fetchall()
        assert got == ref
        assert tiled.EXTERNAL_JOIN_STATS["joins"] == before + 1
    assert tempmem.FILES.stats()["bytes_spilled"] > spilled0


def test_external_join_string_keys(con):
    rng = np.random.default_rng(5)
    ks = np.array([f"key{int(x):05d}"
                   for x in rng.integers(0, 3000, 20_000)])
    ks2 = np.array([f"key{int(x):05d}"
                    for x in rng.integers(0, 3000, 30_000)])
    con.register("sjb", {"k": ks, "b": rng.integers(0, 10, 20_000)})
    con.register("sjp", {"k": ks2, "p": rng.integers(0, 10, 30_000)})
    q = "select count(*), sum(b*p) from sjp join sjb on sjp.k = sjb.k"
    ref = con.execute(q).fetchall()
    con.execute("SET memory_limit='100KB'")
    assert con.execute(q).fetchall() == ref


def test_tempmem_reservation_api():
    m = tempmem.TemporaryMemoryManager(1_000_000)
    g = m.reserve(10_000_000)
    assert 0 < g <= 850_000
    m.release(g)
    assert m.stats()["reserved_bytes"] == 0
    # no budget -> full grant
    m2 = tempmem.TemporaryMemoryManager(None)
    assert m2.reserve(123) == 123

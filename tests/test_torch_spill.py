"""The memory side of out-of-core execution through ddb_tpu (JAX on the
CPU) and ddb_tpu_torch (device="cpu"): the Grace-partitioned external
join of tests/test_rowgroups_spill.py under SET memory_limit='100KB',
the TemporaryMemoryManager, the buffer manager's LRU eviction
(tests/test_persist.py), the BUFFER_CACHE row of duckdb_memory(),
PRAGMA verify_external and SET tile_rows.  Each fixture puts back the
memory limit, MANAGER and MEMORY of both packages."""

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.plan import tiled as ref_tiled
from ddb_tpu.storage import buffer as ref_buffer
from ddb_tpu.storage import tempmem as ref_tempmem
from ddb_tpu_torch.plan import tiled as port_tiled
from ddb_tpu_torch.storage import buffer as port_buffer
from ddb_tpu_torch.storage import tempmem as port_tempmem
from ddb_tpu_torch.storage.table import from_reference_table
from test_torch_sql import first_difference
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

PACKAGES = (("ref", ref_tiled, ref_buffer, ref_tempmem),
            ("port", port_tiled, port_buffer, port_tempmem))


@pytest.fixture()
def restore():
    """Put back each package's buffer-manager limit and working-set
    budget, whatever the test set."""
    saved = [(b.MANAGER.limit_bytes, t.MEMORY.budget_bytes)
             for _, _, b, t in PACKAGES]
    yield
    for (limit, budget), (_, _, b, t) in zip(saved, PACKAGES):
        b.MANAGER.set_limit(limit)
        t.MEMORY.set_budget(budget)


def _pair():
    return ddb_tpu.connect(), ddb_tpu_torch.connect(device="cpu")


def _register(ref, port, name, cols):
    ref.register(name, cols)
    port.catalog.add_table(from_reference_table(ref.catalog.get_table(name)))


# ---- tests/test_rowgroups_spill.py -------------------------------------------

JOINS = [
    "select count(*), sum(b+p) from jp join jb on jp.k = jb.k",
    "select count(*), sum(coalesce(b,0)+coalesce(p,0)) "
    "from jp left join jb on jp.k = jb.k",
    "select count(*), sum(coalesce(b,0)+coalesce(p,0)) "
    "from jp full join jb on jp.k = jb.k",
    "select count(*) from jp where k in (select k from jb)",
]


@pytest.fixture(scope="module")
def joined():
    ref, port = _pair()
    rng = np.random.default_rng(1)
    # a fifth of the reference test's rows and keys (its JAX plans
    # compile for every partition shape): 4 to 16 partitions
    nb, npr = 8_000, 18_000
    _register(ref, port, "jb", {"k": rng.integers(0, 4_000, nb),
                                "b": rng.integers(0, 100, nb)})
    _register(ref, port, "jp", {"k": rng.integers(0, 4_000, npr),
                                "p": rng.integers(0, 100, npr)})
    return ref, port


@pytest.mark.parametrize("i", range(len(JOINS)))
def test_external_join_spills_and_matches(joined, restore, i):
    """Each join kind: in memory, then Grace-partitioned under a 100 KB
    limit in both packages, which spill and give the same rows."""
    q = JOINS[i]
    ref, port = joined
    in_memory = port.execute(q).fetchall()
    got = {}
    for (key, tiled, _, tempmem), con in zip(PACKAGES, (ref, port)):
        con.execute("SET memory_limit='100KB'")
        spilled = tempmem.FILES.stats()["bytes_spilled"]
        joins = tiled.EXTERNAL_JOIN_STATS["joins"]
        got[key] = con.execute(q).fetchall()
        assert tiled.EXTERNAL_JOIN_STATS["joins"] == joins + 1
        assert tempmem.FILES.stats()["bytes_spilled"] > spilled
    assert first_difference(got["ref"], got["port"]) is None
    assert first_difference(in_memory, got["port"]) is None


def test_external_join_string_keys(restore):
    ref, port = _pair()
    rng = np.random.default_rng(5)
    ks = np.array([f"key{int(x):05d}"
                   for x in rng.integers(0, 1000, 6_000)])
    ks2 = np.array([f"key{int(x):05d}"
                    for x in rng.integers(0, 1000, 9_000)])
    _register(ref, port, "sjb", {"k": ks, "b": rng.integers(0, 10, 6_000)})
    _register(ref, port, "sjp", {"k": ks2, "p": rng.integers(0, 10, 9_000)})
    q = "select count(*), sum(b*p) from sjp join sjb on sjp.k = sjb.k"
    in_memory = port.execute(q).fetchall()
    rows = {}
    for (key, tiled, _, _), con in zip(PACKAGES, (ref, port)):
        con.execute("SET memory_limit='100KB'")
        joins = tiled.EXTERNAL_JOIN_STATS["joins"]
        rows[key] = con.execute(q).fetchall()
        assert tiled.EXTERNAL_JOIN_STATS["joins"] == joins + 1
    assert rows["port"] == rows["ref"] == in_memory


def test_tempmem_reservation_api():
    m = port_tempmem.TemporaryMemoryManager(1_000_000)
    g = m.reserve(10_000_000)
    assert 0 < g <= 850_000
    m.release(g)
    assert m.stats()["reserved_bytes"] == 0
    # no budget -> full grant
    m2 = port_tempmem.TemporaryMemoryManager(None)
    assert m2.reserve(123) == 123


# ---- tests/test_persist.py: the buffer manager -------------------------------

def test_buffer_manager_eviction():
    class FakeTD:
        def __init__(self):
            self.dropped = 0

        def invalidate_cache(self):
            self.dropped += 1

    bm = port_buffer.BufferManager(limit_bytes=100)
    a, b, c = FakeTD(), FakeTD(), FakeTD()
    bm.note_use(a, 60)
    bm.note_use(b, 60)          # evicts a
    assert a.dropped == 1 and bm.total_bytes == 60
    bm.note_use(c, 200)         # over budget alone: keeps only c
    assert b.dropped == 1
    assert bm.stats()["cached_tables"] == 1


def _three_tables(con):
    for i in range(3):
        con.execute(f"CREATE TABLE m{i} (a INTEGER)")
        rows = ",".join(f"({j})" for j in range(5000))
        con.execute(f"INSERT INTO m{i} VALUES {rows}")


def test_memory_limit_setting_evicts(restore):
    con = ddb_tpu_torch.connect(device="cpu")
    _three_tables(con)
    evictions = port_buffer.MANAGER.evictions
    con.execute("SET memory_limit = '40KB'")
    for i in range(3):
        con.execute(f"SELECT sum(a) FROM m{i}").fetchall()
    assert port_buffer.MANAGER.limit_bytes == 40000
    assert port_buffer.MANAGER.total_bytes <= 40000
    assert port_buffer.MANAGER.evictions > evictions
    # the evicted tables lost their device batches
    resident = [bool(con.catalog.get_table(f"m{i}")._device_batches)
                for i in range(3)]
    assert resident == [False, True, True]      # 20,000 bytes each
    # correctness survives eviction (host copy is the backing store)
    assert con.execute("SELECT sum(a) FROM m0").fetchall() \
        == [(12497500,)]


def test_buffer_cache_row_of_duckdb_memory(restore):
    con = ddb_tpu_torch.connect(device="cpu")
    _three_tables(con)
    con.execute("SET memory_limit = '50KB'")
    for i in (0, 1, 2, 0):
        con.execute(f"SELECT count(*) FROM m{i}").fetchall()
        # the plan cache would hand back the first call's table, as the
        # reference's does
        con._plan_cache.clear()
        st = port_buffer.MANAGER.stats()
        (used, limit), = con.execute(
            "SELECT memory_usage_bytes, memory_limit_bytes "
            "FROM duckdb_memory() WHERE tag = 'BUFFER_CACHE'").fetchall()
        assert (used, limit) == (st["cached_bytes"], 50_000)
        assert 0 < used <= limit
    tags = [r[0] for r in con.execute(
        "SELECT tag FROM duckdb_memory()").fetchall()]
    assert tags == ["cpu", "BUFFER_CACHE"]


def test_a_dropped_table_leaves_the_buffer_manager(restore):
    """The manager holds a weak handle: a table that is dropped and
    collected takes its entry and its bytes with it."""
    import gc
    import weakref
    con = ddb_tpu_torch.connect(device="cpu")
    con.execute("CREATE TABLE gone AS SELECT range AS a FROM range(1000)")
    con.execute("SELECT sum(a) FROM gone").fetchall()
    td = con.catalog.get_table("gone")
    key, alive = id(td._cache_handle), weakref.ref(td)
    assert port_buffer.MANAGER._entries[key][1] == 8000
    del td
    con.execute("DROP TABLE gone")
    con._plan_cache.clear()
    gc.collect()
    assert alive() is None and key not in port_buffer.MANAGER._entries


# ---- PRAGMA verify_external, SET tile_rows -------------------------------------

VERIFIED = [
    "SELECT g, count(*), sum(v), avg(v) FROM t GROUP BY g ORDER BY g",
    "SELECT v, g FROM t WHERE v < 50 ORDER BY v, g",
    "SELECT count(*), sum(t.v) FROM t JOIN u ON t.g = u.g",
]


def test_pragma_verify_external(monkeypatch):
    """Every SELECT also runs through the out-of-core paths (threshold 1,
    tiles of 2,048) and the rows are compared; the disable_ form turns
    only that variant off."""
    ref, port = _pair()
    rng = np.random.default_rng(2)
    _register(ref, port, "t", {"g": rng.integers(0, 9, 5000),
                               "v": rng.integers(0, 1000, 5000)})
    _register(ref, port, "u", {"g": np.arange(9), "w": np.arange(9)})
    calls = []
    for name in ("execute_tiled", "execute_tiled_sort",
                 "execute_external_join"):
        def wrapped(plan, config, device, _fn=getattr(port_tiled, name),
                    _name=name):
            res = _fn(plan, config, device)
            if res is not None:
                calls.append((_name, config.get("tile_rows")))
            return res
        monkeypatch.setattr(port_tiled, name, wrapped)
    for con in (ref, port):
        assert con.execute("PRAGMA verify_external") is None
        assert con.config.get("verify_external") is True
        assert con.config.get("enable_verification") is True
    for sql in VERIFIED:
        assert first_difference(ref.execute(sql).fetchall(),
                                port.execute(sql).fetchall()) is None
    assert [c for c, _ in calls] == ["execute_tiled", "execute_tiled_sort",
                                     "execute_external_join"]
    assert {t for _, t in calls} == {2048}
    for con in (ref, port):
        con.execute("PRAGMA disable_verify_external")
        assert con.config.get("verify_external") is False
        assert con.config.get("enable_verification") is True


def test_set_tile_rows_changes_the_number_of_tiles():
    con = ddb_tpu_torch.connect(device="cpu")
    con.register("t", {"v": np.arange(20_000, dtype=np.int64) % 97})
    con.execute("SET external_threshold_rows = 1000")
    sql = "SELECT v, count(*) FROM t GROUP BY v ORDER BY v"
    seen = {}
    for tile in (8192, 2048):
        con.execute(f"SET tile_rows = {tile}")
        before = port_tiled.STREAM_STATS["tiles"]
        seen[tile] = (con.execute(sql).fetchall(),
                      port_tiled.STREAM_STATS["tiles"] - before)
    assert seen[8192][1] == 3 and seen[2048][1] == 10
    assert seen[8192][0] == seen[2048][0] and len(seen[2048][0]) == 97

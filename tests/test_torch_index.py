"""The point-lookup index (storage/index.py, plan/physical.py:
_index_scan_rows) and CREATE/DROP INDEX through ddb_tpu.connect() and
ddb_tpu_torch.connect(device="cpu"): the sequences of the reference's
tests/test_index.py with the harness of test_torch_dml.py, each run as
it is, inside BEGIN ... COMMIT and inside BEGIN ... ROLLBACK, and the
index scan held to being taken.

test_index_persists and test_index_wal_replay need a database file: they
are in tests/test_torch_persist.py and tests/test_torch_wal.py."""

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch import api
from test_torch_dml import MODES, run_both
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

N = 20000


def _big(con):
    rng = np.random.default_rng(3)
    con.register("big", {"id": np.arange(N), "g": rng.integers(0, 50, N),
                         "v": rng.integers(0, 1000, N)})


INDEX = {
    "index_point_lookup_exact": [
        "SELECT g, v FROM big WHERE id = 12345",
        "CREATE INDEX idx_id ON big(id)",
        "SELECT g, v FROM big WHERE id = 12345"],
    "index_range_scan": [
        "SELECT count(*), sum(v) FROM big WHERE id >= 100 AND id < 200",
        "CREATE INDEX idx_id ON big(id)",
        "SELECT count(*), sum(v) FROM big WHERE id >= 100 AND id < 200",
        "SELECT count(*) FROM big WHERE id > 19990",
        "SELECT count(*) FROM big WHERE id <= 3 AND v >= 0"],
    "index_incremental_insert": [
        "CREATE INDEX idx_id ON big(id)",
        "SELECT v FROM big WHERE id = 5",
        "INSERT INTO big VALUES (1000000, 1, 42)",
        "SELECT v FROM big WHERE id = 1000000"],
    "index_after_delete_update": [
        "CREATE INDEX idx_id ON big(id)",
        "SELECT v FROM big WHERE id = 10",
        "DELETE FROM big WHERE id = 10",
        "SELECT v FROM big WHERE id = 10",
        "UPDATE big SET v = 7 WHERE id = 11",
        "SELECT v FROM big WHERE id = 11"],
    "unique_index_rejects_duplicates": [
        "CREATE TABLE u (k INTEGER, s VARCHAR)",
        "INSERT INTO u VALUES (1, 'a'), (2, 'b')",
        "CREATE UNIQUE INDEX uk ON u(k)",
        "INSERT INTO u VALUES (2, 'dup')",
        "SELECT count(*) FROM u",
        "INSERT INTO u VALUES (3, 'c')",
        "CREATE UNIQUE INDEX uk2 ON u(s)",
        "INSERT INTO u VALUES (4, 'c')",
        "CREATE UNIQUE INDEX uk3 ON u(s)"],
    "multicol_index": [
        "SELECT count(*) FROM big WHERE g = 7 AND v = 500",
        "CREATE INDEX gidx ON big(g, v)",
        "SELECT count(*) FROM big WHERE g = 7 AND v = 500",
        "SELECT id FROM big WHERE g = 11 AND v = 140 ORDER BY id"],
    "duckdb_indexes_listing": [
        "CREATE UNIQUE INDEX idx_id ON big(id)",
        "SELECT index_name, table_name, is_unique FROM duckdb_indexes()"],
    "drop_index": [
        "CREATE INDEX idx_id ON big(id)",
        "CREATE INDEX idx_id ON big(v)",
        "CREATE INDEX IF NOT EXISTS idx_id ON big(v)",
        "DROP INDEX idx_id",
        "SELECT index_name FROM duckdb_indexes()",
        "DROP INDEX idx_id",
        "DROP INDEX IF EXISTS idx_id",
        "CREATE INDEX bad ON big(nope)"],
    "alter_blocked_by_index": [
        "CREATE INDEX idx_v ON big(v)",
        "ALTER TABLE big ALTER COLUMN v SET DATA TYPE BIGINT",
        "ALTER TABLE big ALTER COLUMN v SET DEFAULT 3",
        "SELECT count(*) FROM big WHERE v = 3"],
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(INDEX))
def test_index_sequence_matches_reference(name, mode):
    run_both(INDEX[name], mode, setup=[_big])


def test_index_scan_path_used(monkeypatch):
    """The port's scan feeds the index's rows, on the connection's
    device; so does the reference's (tests/test_index.py:32)."""
    fed = {}
    for pkg, con in (("ref", ddb_tpu.connect()),
                     ("port", ddb_tpu_torch.connect(device="cpu"))):
        _big(con)
        con.execute("CREATE INDEX idx_id ON big(id)")
        cls = type(con.catalog.get_table("big"))
        orig = cls.device_batch_rows
        calls = fed[pkg] = []

        def spy(self, cols, rows, *args, **kw):
            calls.append((len(rows), kw.get("device")))
            return orig(self, cols, rows, *args, **kw)

        monkeypatch.setattr(cls, "device_batch_rows", spy)
        assert len(con.execute("SELECT v FROM big WHERE id = 77")
                   .fetchall()) == 1
        con.execute("SELECT count(*) FROM big WHERE id >= 100 AND id < 200"
                    ).fetchall()
        # not selective enough: a full scan
        con.execute("SELECT count(*) FROM big WHERE id >= 0").fetchall()
    assert [n for n, _ in fed["ref"]] == [n for n, _ in fed["port"]] \
        == [1, 100]
    assert all(d == ddb_tpu_torch.connect(device="cpu").device
               for _, d in fed["port"])


def test_transaction_clones_share_the_cached_batches():
    con = ddb_tpu_torch.connect(device="cpu")
    _big(con)
    con.execute("CREATE INDEX idx_id ON big(id)")
    con.execute("SELECT v FROM big WHERE id = 5").fetchall()
    con.execute("SELECT sum(v) FROM big").fetchall()
    td = con.catalog.get_table("big")
    clone = api._clone_table(td)
    assert clone._device_batches == td._device_batches
    assert clone._device_batches is not td._device_batches
    # a mutation of the clone drops only the clone's caches
    con.execute("BEGIN")
    con.execute("UPDATE big SET v = -1 WHERE id = 5")
    assert td._device_batches and td.indexes["idx_id"]._version == td.version
    assert con.execute("SELECT v FROM big WHERE id = 5").fetchall() == [(-1,)]
    con.execute("ROLLBACK")
    assert con.catalog.get_table("big") is td
    assert con.execute("SELECT v FROM big WHERE id = 5").fetchall() != \
        [(-1,)]

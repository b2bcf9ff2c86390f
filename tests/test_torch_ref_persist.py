# Generated from tests/test_persist.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite persist); do not edit.
"""Native single-file persistence (native/dtbfile.cpp + storage/persist.py;
reference counterpart: single-file checkpoint, test/persistence)."""

from ddb_tpu_torch.testing import refsuite
import decimal
import os

import pytest

import ddb_tpu_torch


def test_save_load_roundtrip(tmp_path):
    path = str(tmp_path / "db.dtb")
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, s VARCHAR, d DECIMAL(10,2))")
    con.execute("INSERT INTO t VALUES (1, 'hello', 1.25), "
                "(2, NULL, 2.50), (3, 'world', NULL)")
    con.execute("CREATE VIEW v AS SELECT a FROM t WHERE a > 1")
    con.save(path)

    con2 = refsuite.connect(path)
    rows = con2.execute("SELECT * FROM t ORDER BY a").fetchall()
    assert rows == [(1, "hello", decimal.Decimal("1.25")),
                    (2, None, decimal.Decimal("2.50")),
                    (3, "world", None)]
    assert con2.execute("SELECT count(*) FROM v").fetchall() == [(2,)]


def test_atomic_overwrite(tmp_path):
    path = str(tmp_path / "db.dtb")
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER)")
    con.execute("INSERT INTO t VALUES (1)")
    con.save(path)
    con.execute("INSERT INTO t VALUES (2)")
    con.save(path)     # atomic replace
    con2 = refsuite.connect(path)
    assert con2.execute("SELECT count(*) FROM t").fetchall() == [(2,)]


def test_corruption_detected(tmp_path):
    path = str(tmp_path / "db.dtb")
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER)")
    con.execute("INSERT INTO t VALUES (42)")
    con.save(path)
    # flip a byte in the blob region
    data = bytearray(open(path, "rb").read())
    data[-2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    con2 = refsuite.connect()
    with pytest.raises(IOError):
        con2.load(path)


def test_missing_file():
    con = refsuite.connect()
    with pytest.raises(IOError):
        con.load("/tmp/definitely_missing.dtb")


def test_compressed_blobs_roundtrip(tmp_path):
    # data blobs compress (delta-varint ints, RLE masks, zlib dicts) and
    # decompress bit-exactly (native codecs, native/dtbfile.cpp;
    # reference: src/storage/compression/)
    import os
    path = str(tmp_path / "c.dtb")
    con = refsuite.connect()
    con.execute("CREATE TABLE t (a INTEGER, b BIGINT, s VARCHAR)")
    rows = ",".join(f"({i % 100},{i * 1000},'name{i % 50}')"
                    for i in range(2000))
    con.execute(f"INSERT INTO t VALUES {rows}")
    con.save(path)
    raw_bytes = 2000 * (4 + 8 + 4)
    assert os.path.getsize(path) < raw_bytes // 2
    con2 = refsuite.connect()
    con2.load(path)
    assert con2.execute("SELECT count(*), sum(a), sum(b), min(s)"
                        " FROM t").fetchall() \
        == [(2000, 99000, 1999000000, "name0")]


def test_buffer_manager_eviction():
    from ddb_tpu_torch.storage.buffer import BufferManager

    class FakeTD:
        def __init__(self):
            self.dropped = 0

        def invalidate_cache(self):
            self.dropped += 1

    bm = BufferManager(limit_bytes=100)
    a, b, c = FakeTD(), FakeTD(), FakeTD()
    bm.note_use(a, 60)
    bm.note_use(b, 60)          # evicts a
    assert a.dropped == 1 and bm.total_bytes == 60
    bm.note_use(c, 200)         # over budget alone: keeps only c
    assert b.dropped == 1
    assert bm.stats()["cached_tables"] == 1


def test_memory_limit_setting_evicts():
    con = refsuite.connect()
    for i in range(3):
        con.execute(f"CREATE TABLE m{i} (a INTEGER)")
        rows = ",".join(f"({j})" for j in range(5000))
        con.execute(f"INSERT INTO m{i} VALUES {rows}")
    con.execute("SET memory_limit = '40KB'")
    for i in range(3):
        con.execute(f"SELECT sum(a) FROM m{i}").fetchall()
    from ddb_tpu_torch.storage.buffer import MANAGER
    assert MANAGER.limit_bytes == 40000
    assert MANAGER.total_bytes <= 40000
    # correctness survives eviction (host copy is the backing store)
    assert con.execute("SELECT sum(a) FROM m0").fetchall() \
        == [(12497500,)]
    MANAGER.set_limit(None)     # don't throttle later tests


def test_round5_codecs_roundtrip():
    """Bitpacking (codec 6), ALP-class floats (7), roaring-class
    validity (8) — reference: src/storage/compression/
    {bitpacking,alp,roaring}/.  Smallest-wins selection must pick them
    on favorable data and every payload must round-trip exactly."""
    import numpy as np

    from ddb_tpu_torch.storage import persist as P

    lib = P._load_lib()
    rng = np.random.default_rng(0)

    def roundtrip(data, kind, elem=0):
        codec, payload = P._compress_blob(lib, data, kind, elem)
        back = P._decompress_blob(lib, codec, payload, len(data), elem)
        assert back == data
        return codec, len(payload)

    ints = rng.integers(1000, 1200, 50_000).astype(np.int64).tobytes()
    codec, sz = roundtrip(ints, "ints", 8)
    assert codec == P._BITPACK and sz < len(ints) // 4

    fl = np.round(rng.uniform(0, 1000, 50_000), 2).tobytes()
    codec, sz = roundtrip(fl, "floats", 8)
    assert codec == P._ALP and sz < len(fl) // 2

    # irrational floats: ALP must not miscompress (falls back exactly)
    roundtrip(rng.standard_normal(20_000).tobytes(), "floats", 8)

    m = np.zeros(300_000, np.uint8)
    m[rng.integers(0, 300_000, 100)] = 1
    codec, sz = roundtrip(m.tobytes(), "mask")
    assert codec == P._ROARING and sz < 2000

    roundtrip(rng.integers(0, 2, 200_000).astype(np.uint8).tobytes(),
              "mask")

# Generated from tests/test_cachefs.py by ddb_tpu_torch/testing/refsuite.py
# (python -m ddb_tpu_torch.testing.refsuite cachefs); do not edit.
"""Caching filesystem seam (reference: caching_file_system.cpp +
register_filesystem): scheme:// paths route through a registered
fsspec-style handler with a local revalidating cache."""

from ddb_tpu_torch.testing import refsuite
import os

import pytest

import ddb_tpu_torch
from ddb_tpu_torch.storage import cachefs


class FakeFS:
    """fsspec-shaped mock 'remote' filesystem over a local directory."""

    def __init__(self, root):
        self.root = root
        self.opens = 0

    def open(self, path, mode="rb"):
        self.opens += 1
        return open(os.path.join(self.root, path), mode)

    def modified(self, path):
        return os.path.getmtime(os.path.join(self.root, path))


@pytest.fixture()
def remote(tmp_path):
    root = tmp_path / "remote"
    root.mkdir()
    (root / "t.csv").write_text("a,b\n1,2\n3,4\n")
    fs = FakeFS(str(root))
    cachefs.register_filesystem("mock", fs)
    yield fs, root
    cachefs.unregister_filesystem("mock")
    cachefs.clear_cache()


def test_remote_read_and_cache_hit(remote):
    fs, root = remote
    con = refsuite.connect()
    r = con.execute("select * from read_csv_auto('mock://t.csv') "
                    "order by a").fetchall()
    assert r == [(1, 2), (3, 4)]
    assert fs.opens == 1
    before = dict(cachefs.STATS)
    r2 = con.execute("select sum(b) from read_csv_auto('mock://t.csv')"
                     ).fetchall()
    assert r2 == [(6,)]
    assert fs.opens == 1                      # served from cache
    assert cachefs.STATS["hits"] > before["hits"]


def test_cache_revalidates_on_change(remote):
    fs, root = remote
    con = refsuite.connect()
    con.execute("select * from read_csv_auto('mock://t.csv')")
    (root / "t.csv").write_text("a,b\n9,9\n")
    os.utime(root / "t.csv", (1e9, 2e9))     # force mtime change
    r = con.execute("select * from read_csv_auto('mock://t.csv')"
                    ).fetchall()
    assert r == [(9, 9)]
    assert fs.opens == 2


def test_unregistered_scheme_errors():
    con = refsuite.connect()
    with pytest.raises(Exception, match="no filesystem registered"):
        con.execute("select * from read_csv_auto('nope://x.csv')")

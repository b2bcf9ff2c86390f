"""Out-of-core tiled execution through ddb_tpu (JAX on the CPU) and
ddb_tpu_torch (device="cpu"): the statements of tests/test_tiled.py at
its settings (threshold 50,000 rows, tiles of 65,536), a 20,000-row
TopN and tiled sorts, one with no result rows.  TPC-H and NULLs that
only some tiles hold are in test_torch_tiled_tpch.py (each file stays
under a minute in one process: the reference compiles every plan).

Every statement must give the port's in-memory rows and the reference's
tiled rows (floats to 1e-9 relative, the rest exactly), and take the
same out-of-core entry point in both packages; the entry point is read
by wrapping the four `execute_*` functions of each package.  The named
deviation here: the reference reads a wide partial sum by its low word
alone (the other, fault 3.15, is in test_torch_tiled_tpch.py)."""

import math
import os

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.bench.tpch import TPCH_QUERIES, load_tbl
from ddb_tpu.plan import tiled as ref_tiled
from ddb_tpu_torch.plan import tiled as port_tiled
from ddb_tpu_torch.storage.table import from_reference_table
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

RTOL = 1e-9
IN_MEMORY = 100_000_000
ENTRY_POINTS = ("execute_tiled", "execute_tiled_topn", "execute_tiled_sort",
                "execute_external_join")
_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "tpch_sf0.01")


@pytest.fixture()
def entries(monkeypatch):
    """{"ref": [...], "port": [...]}: the entry points that took each
    statement since the last clear."""
    taken = {"ref": [], "port": []}
    for key, mod in (("ref", ref_tiled), ("port", port_tiled)):
        for name in ENTRY_POINTS:
            def wrapped(*args, _fn=getattr(mod, name), _name=name,
                        _key=key):
                res = _fn(*args)
                if res is not None:
                    taken[_key].append(_name)
                return res
            monkeypatch.setattr(mod, name, wrapped)
    return taken


def _same(want, got) -> bool:
    if len(want) != len(got):
        return False
    for rw, rg in zip(want, got):
        for w, g in zip(rw, rg):
            if isinstance(w, float) and isinstance(g, float):
                if not (math.isclose(w, g, rel_tol=RTOL)
                        or (math.isnan(w) and math.isnan(g))):
                    return False
            elif type(w) is not type(g) or w != g:
                return False
    return True


def _rows(con, sql, threshold=IN_MEMORY, tile=None):
    con.execute(f"SET external_threshold_rows = {threshold}")
    if tile is not None:
        con.execute(f"SET tile_rows = {tile}")
    con._plan_cache.clear()
    try:
        return con.execute(sql).fetchall()
    finally:
        con.execute(f"SET external_threshold_rows = {IN_MEMORY}")


def _pair():
    return ddb_tpu.connect(), ddb_tpu_torch.connect(device="cpu")


def _carry(ref, port, name):
    port.catalog.add_table(from_reference_table(ref.catalog.get_table(name)))


def check(ref, port, entries, sql, threshold, tile, entry):
    """Port tiled == port in memory == reference tiled, and both packages
    take `entry` (None: in memory)."""
    in_memory = _rows(port, sql)
    entries["ref"].clear()
    entries["port"].clear()
    got = _rows(port, sql, threshold, tile)
    want = _rows(ref, sql, threshold, tile)
    assert entries["port"] == entries["ref"] == ([entry] if entry else [])
    assert _same(in_memory, got), (in_memory[:3], got[:3])
    assert _same(want, got), (want[:3], got[:3])
    return got


# ---- tests/test_tiled.py ---------------------------------------------------

BIG_ROWS = 140_000      # three tiles of 65,536 above the 50,000 threshold


@pytest.fixture(scope="module")
def big():
    ref, port = _pair()
    rng = np.random.default_rng(3)
    n = BIG_ROWS
    ref.register("big", {
        "g": rng.integers(0, 7, n),
        "v": rng.integers(0, 1000, n),
        "f": rng.random(n),
        "s": np.array(["alpha", "beta", "gamma", "delta"])[
            rng.integers(0, 4, n)]})
    ref.register("dim", {
        "g": np.arange(7),
        "label": np.array(["g0", "g1", "g2", "g3", "g4", "g5", "g6"]),
        "w": np.arange(7) * 10})
    for t in ("big", "dim"):
        _carry(ref, port, t)
    return ref, port


TILED = {
    "grouped": ("SELECT g, count(*), sum(v), min(v), max(v), avg(f), min(s), "
                "max(s) FROM big WHERE v >= 10 GROUP BY g ORDER BY g",
                "execute_tiled"),
    "ungrouped": ("SELECT count(*), sum(v), avg(v) FROM big WHERE g < 5",
                  "execute_tiled"),
    "fallback_holistic": ("SELECT median(v) FROM big", None),
    "with_order_limit": ("SELECT g, sum(v) AS s FROM big GROUP BY g "
                         "ORDER BY s DESC LIMIT 3", None),
    "topn": ("SELECT v, f, s FROM big WHERE g = 3 ORDER BY v DESC, f ASC "
             "LIMIT 25", None),
    "topn_offset": ("SELECT v, s FROM big ORDER BY v, s LIMIT 10 OFFSET 7",
                    None),
    "topn_strings": ("SELECT s, v FROM big ORDER BY s DESC, v DESC LIMIT 12",
                     None),
    "join_agg": ("SELECT d.label, count(*), sum(b.v + d.w) FROM big b, dim d "
                 "WHERE b.g = d.g AND b.v < 900 GROUP BY d.label "
                 "ORDER BY d.label", "execute_tiled"),
    "semi_join_agg": ("SELECT count(*), sum(v) FROM big WHERE g IN "
                      "(SELECT g FROM dim WHERE w >= 30)", "execute_tiled"),
    # above optimizer.TOPN_MAX (16,384): Limit over Order, tiled
    "topn_20000": ("SELECT v, f FROM big ORDER BY v DESC, f LIMIT 20000",
                   "execute_tiled_topn"),
    "sort": ("SELECT v, f, s FROM big WHERE v < 3 ORDER BY v, f",
             "execute_tiled_sort"),
    "sort_projected": ("SELECT v * 2 AS w, s FROM big WHERE v < 3 "
                       "ORDER BY v, f", "execute_tiled_sort"),
    "sort_no_rows": ("SELECT v + 1 AS w FROM big WHERE v < 0 ORDER BY v",
                     "execute_tiled_sort"),
}


@pytest.mark.parametrize("name", list(TILED))
def test_tiled_statement_matches(big, entries, name):
    sql, entry = TILED[name]
    rows = check(*big, entries, sql, 50_000, 65_536, entry)
    if name != "sort_no_rows":
        assert rows
    else:
        assert rows == []


# ---- the named deviations ---------------------------------------------------

def test_wide_partial_keeps_its_high_limb(entries):
    """Tile 0's partial sum of four values near 2^62 exceeds int64: the
    port merges both limbs and gives the exact sum, as in memory; the
    reference reads the partial's low word and wraps."""
    ref, port = _pair()
    n = 4096
    v = np.zeros(n, dtype=np.int64)
    v[0:8:2] = 4_000_000_000_000_000_000       # group 0, tile 0
    v[2049] = 5                                 # group 1, tile 2
    ref.register("w", {"g": np.arange(n) % 2, "v": v})
    _carry(ref, port, "w")
    exact = {g: int(v[np.arange(n) % 2 == g].sum(dtype=object))
             for g in (0, 1)}
    sql = "SELECT g, sum(v) FROM w GROUP BY g ORDER BY g"
    in_memory = _rows(port, sql)
    got = _rows(port, sql, 1000, 1024)
    want = _rows(ref, sql, 1000, 1024)
    assert entries["port"] == entries["ref"] == ["execute_tiled"]
    assert got == in_memory == [(0, exact[0]), (1, exact[1])]
    assert max(exact.values()) > 2**63
    assert want[0][1] != exact[0] and want[1] == (1, exact[1])


def test_batch_to_host_and_live_indices_match_the_reference():
    """batch.batch_to_host and host_compact_indices on tensors: the live
    rows in order, NULL masks, and a wide column as Python ints."""
    import jax.numpy as jnp
    import torch

    from ddb_tpu import batch as ref_batch
    from ddb_tpu_torch import batch as port_batch
    sel = np.array([True, False, True, True, False])
    data = np.array([5, -1, 2**40, -3, 7], dtype=np.int64)
    nulls = np.array([False, True, False, True, False])
    hi = np.array([3, 0, -2, 1, 9], dtype=np.int64)
    ref = ref_batch.Batch(
        (ref_batch.Column(jnp.asarray(data), jnp.asarray(nulls),
                          jnp.asarray(hi)),
         ref_batch.Column(jnp.asarray(data), None)),
        jnp.asarray(sel), jnp.asarray(np.int32(3)))
    port = port_batch.Batch(
        (port_batch.Column(torch.from_numpy(data), torch.from_numpy(nulls),
                           torch.from_numpy(hi)),
         port_batch.Column(torch.from_numpy(data), None)),
        torch.from_numpy(sel), torch.tensor(3, dtype=torch.int32))
    (rd, rn), (pd, pn) = (ref_batch.batch_to_host(ref, None),
                          port_batch.batch_to_host(port, None))
    assert [list(x) for x in pd] == [list(x) for x in rd]
    assert pd[0][0] == 3 * 2**32 + 5 and pn[1] is None
    assert (pn[0] == rn[0]).all()
    assert list(port_batch.host_compact_indices(port)) \
        == list(ref_batch.host_compact_indices(ref)) == [0, 2, 3]

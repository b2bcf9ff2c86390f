"""ddb_tpu_torch.parallel: the exchange, dist.py's operators and the wide
sums of the distributed aggregate, on eight shards on the CPU.

The data of tests/test_parallel.py, held to numpy oracles; the routing of
every row held to the reference's hash (ddb_tpu.ops.hashing, plain jnp, no
shard_map).  The reference's own distributed operators are not called
here (they compile for minutes on the CPU)."""

import collections
import decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu.ops import hashing as ref_hashing
from ddb_tpu_torch.parallel import exchange as X
from ddb_tpu_torch.parallel import executor as EX
from ddb_tpu_torch.parallel.dist import (dist_groupby_sum,
                                         dist_join_groupby_step,
                                         dist_join_inner)
from ddb_tpu_torch.parallel.mesh import AXIS, Mesh, make_mesh
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def mesh():
    return Mesh([CPU] * 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_mesh_shapes():
    m = make_mesh(devices=[CPU] * 8)
    assert m.shape == {AXIS: 8} and m.size == 8
    assert make_mesh(4, devices=[CPU] * 8).shape[AXIS] == 4
    m2 = Mesh([[CPU] * 4] * 2, ("h", AXIS))
    assert m2.shape == {"h": 2, AXIS: 4} and m2.size == 8
    with pytest.raises(NotImplementedError):
        EX.DistContext(m2)


def test_dist_groupby_sum(mesh):
    rng = np.random.default_rng(0)
    n = 8 * 256
    keys = rng.integers(0, 37, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    gk, gs, gc, gv, of = dist_groupby_sum(
        mesh, _t(keys), _t(vals), torch.ones(n, dtype=torch.bool),
        group_cap=128, exchange_cap=64)
    assert int(of.sum()) == 0
    got = {}
    for k, s, c, v in zip(gk.reshape(-1).tolist(), gs.reshape(-1).tolist(),
                          gc.reshape(-1).tolist(), gv.reshape(-1).tolist()):
        if v:
            assert k not in got, "key appeared on two shards"
            got[k] = (s, c)
    want_s, want_c = collections.defaultdict(int), collections.Counter()
    for k, v in zip(keys.tolist(), vals.tolist()):
        want_s[k] += v
        want_c[k] += 1
    assert got == {k: (want_s[k], want_c[k]) for k in want_s}


def test_dist_groupby_skew(mesh):
    """90 % of the rows hit one key: the local pre-aggregate absorbs it."""
    rng = np.random.default_rng(1)
    n = 8 * 512
    keys = np.where(rng.random(n) < 0.9, 7,
                    rng.integers(0, 1000, n)).astype(np.int64)
    gk, gs, gc, gv, of = dist_groupby_sum(
        mesh, _t(keys), torch.ones(n, dtype=torch.int64),
        torch.ones(n, dtype=torch.bool), group_cap=1024, exchange_cap=600)
    assert int(of.sum()) == 0
    got = {k: s for k, s, v in zip(gk.reshape(-1).tolist(),
                                   gs.reshape(-1).tolist(),
                                   gv.reshape(-1).tolist()) if v}
    assert got[7] == int((keys == 7).sum())


def _join_data():
    rng = np.random.default_rng(2)
    n = 8 * 128
    lk = rng.integers(0, 50, n).astype(np.int64)
    lv = rng.integers(1, 10, n).astype(np.int64)
    rk = np.arange(50, dtype=np.int64)
    rv = rng.integers(1, 5, 50).astype(np.int64)
    rk_pad, rv_pad = np.zeros(n, np.int64), np.zeros(n, np.int64)
    rvalid = np.zeros(n, dtype=bool)
    rk_pad[:50], rv_pad[:50], rvalid[:50] = rk, rv, True
    return dict(lkey=_t(lk), lval=_t(lv),
                lvalid=torch.ones(n, dtype=torch.bool), rkey=_t(rk_pad),
                rval=_t(rv_pad), rvalid=_t(rvalid)), \
        lk, lv, dict(zip(rk.tolist(), rv.tolist()))


def test_dist_join_groupby(mesh):
    args, lk, lv, rmap = _join_data()
    gk, gs, gc, gv = dist_join_groupby_step(
        mesh, **args, exchange_cap=512, out_cap=4096, group_cap=256)
    got = {k: s for k, s, v in zip(gk.reshape(-1).tolist(),
                                   gs.reshape(-1).tolist(),
                                   gv.reshape(-1).tolist()) if v}
    want = collections.defaultdict(int)
    for k, v in zip(lk.tolist(), lv.tolist()):
        want[k] += v * rmap[k]
    assert got == dict(want)


def test_dist_join_inner(mesh):
    args, lk, lv, rmap = _join_data()
    ek, elv, erv, valid, of = dist_join_inner(
        mesh, *args.values(), exchange_cap=512, out_cap=4096)
    assert int(of.sum()) == 0
    m = valid.reshape(-1)
    got = sorted(zip(ek.reshape(-1)[m].tolist(), elv.reshape(-1)[m].tolist(),
                     erv.reshape(-1)[m].tolist()))
    assert got == sorted((k, v, rmap[k])
                         for k, v in zip(lk.tolist(), lv.tolist()))


def test_two_level_exchange():
    """Hierarchical (hosts x chips) shuffle: every row reaches the global
    shard its pid names, and every row arrives once."""
    n_hosts, n_chips = 2, 4
    m = Mesh([[CPU] * n_chips] * n_hosts, ("h", AXIS))
    per = 64
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1000, 8 * per).astype(np.int64)
    pids = rng.integers(0, 8, 8 * per).astype(np.int32)
    rows = np.arange(8 * per, dtype=np.int64)
    shard = [slice(i * per, (i + 1) * per) for i in range(8)]
    out, valid, ovf = X.all_to_all_exchange_2level(
        [[_t(vals[s]), _t(pids[s]).to(torch.int64), _t(rows[s])]
         for s in shard], [torch.ones(per, dtype=torch.bool)] * 8,
        [_t(pids[s]) for s in shard], n_hosts, n_chips, per, m.devices)
    assert sum(int(o) for o in ovf) == 0
    seen = []
    for me, ((v, p, r), ok) in enumerate(zip(out, valid)):
        assert v.shape[0] == n_hosts * n_chips * per
        assert bool((p[ok] == me).all())
        seen.extend(r[ok].tolist())
        assert np.array_equal(v[ok].numpy(), vals[r[ok].numpy()])
    assert sorted(seen) == rows.tolist()


def _reference_pid(keys: np.ndarray, n: int) -> np.ndarray:
    return np.asarray(ref_hashing.partition_of(
        ref_hashing.hash64(jnp.asarray(keys)), n))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_exchange_routes_rows_as_the_reference_hash(n):
    """exchange_by_key sends every live row to partition_of(hash64(key),
    n) of the reference, once, with its payload; dead rows stay behind."""
    rng = np.random.default_rng(n)
    per = 512
    keys = np.concatenate([
        np.array([0, 1, -1, 2**63 - 1, -2**63, 2**62], np.int64),
        rng.integers(-2**63, 2**63 - 1, n * per - 6, dtype=np.int64)])
    live = rng.random(n * per) < 0.9
    rows = np.arange(n * per, dtype=np.int64)
    want = _reference_pid(keys, n)
    shard = [slice(i * per, (i + 1) * per) for i in range(n)]
    out, valid, ovf = X.exchange_by_key(
        [_t(keys[s]) for s in shard], [[_t(keys[s]), _t(rows[s])]
                                       for s in shard],
        [_t(live[s]) for s in shard], n, per)
    assert sum(int(o) for o in ovf) == 0
    got = np.full(n * per, -1)
    for me, ((k, r), ok) in enumerate(zip(out, valid)):
        r = r[ok].numpy()
        assert np.all(got[r] == -1), "a row arrived twice"
        got[r] = me
        assert np.array_equal(k[ok].numpy(), keys[r])
        # source-major: each source's rows arrive in its own row order
        src = r // per
        assert np.all(np.diff(src) >= 0)
        for s in range(n):
            assert np.all(np.diff(r[src == s]) > 0)
    assert np.array_equal(got[live], want[live])
    assert np.all(got[~live] == -1)


def test_exchange_counts_the_rows_over_capacity():
    n, per, cap = 4, 256, 32
    keys = np.zeros(n * per, np.int64)          # every row to one shard
    out, valid, ovf = X.exchange_by_key(
        [_t(keys[i * per:(i + 1) * per]) for i in range(n)],
        [[_t(keys[i * per:(i + 1) * per])] for i in range(n)],
        [torch.ones(per, dtype=torch.bool)] * n, n, cap)
    assert [int(o) for o in ovf] == [per - cap] * n
    assert sum(int(v.sum()) for v in valid) == n * cap


@pytest.mark.parametrize("n", [4, 8])
def test_executor_routes_group_keys_as_the_reference(n):
    """The executor's row exchanges route by the reference's
    (hash_combine(0, key) >> 33) % n, NULLs as -1."""
    rng = np.random.default_rng(3)
    keys = rng.integers(-2**40, 2**40, 4096, dtype=np.int64)
    h = ref_hashing.hash_combine(jnp.zeros(4096, dtype=jnp.uint64),
                                 jnp.asarray(keys))
    want = np.asarray((h >> jnp.uint64(33)).astype(jnp.int32) % n)
    from ddb_tpu_torch import types as T
    from ddb_tpu_torch.batch import Batch, Column
    from ddb_tpu_torch.expr import ir
    b = Batch((Column(_t(keys), None),), torch.ones(4096, dtype=torch.bool),
              torch.tensor(4096))
    got = EX._hash_pid([ir.ColRef(0, T.BIGINT, "k")], b, n)
    assert np.array_equal(got.numpy(), want)


# ---- wide (two-limb) sums through the distributed aggregate -------------------

BIG_DEC = decimal.Decimal("9000000000000000.99")   # raw 9.0e17 at scale 2
BIG_INT = 2**62 + 12345


def _wide_pair():
    """Groups whose DECIMAL and BIGINT sums pass 2^63."""
    sizes = {0: 20, 1: 1, 2: 11, 3: 5}
    rows = ",".join(f"({g},{BIG_DEC},{BIG_INT - g})"
                    for g, k in sizes.items() for _ in range(k))
    port = ddb_tpu_torch.connect(device="cpu")
    port.execute("CREATE TABLE w (g INTEGER, x DECIMAL(18,2), y BIGINT)")
    port.execute(f"INSERT INTO w VALUES {rows}")
    return port, sizes


def test_wide_sums_keep_their_high_limb_through_the_exchange(
        mesh, monkeypatch):
    """The partials of sum(x) and sum(y) cross the exchange with their
    high limbs and merge in two limbs: the totals pass 2^63 and stay
    exact.  (The reference's distributed aggregate sends one int64 word a
    partial and no high limb: ROADMAP fault 3.17.)"""
    from test_torch_dist_executor import dist_plan
    port, sizes = _wide_pair()
    gathered = []
    orig = EX._exec_gathered
    monkeypatch.setattr(EX, "_exec_gathered",
                        lambda node, ctx: gathered.append(node)
                        or orig(node, ctx))
    want = {g: (BIG_DEC * k, (BIG_INT - g) * k) for g, k in sizes.items()}
    assert max(int(y) for _, y in want.values()) > 2**63
    sql = "SELECT g, sum(x), sum(y), avg(y), count(*) FROM w GROUP BY g"
    schema, batch = EX.execute_distributed(dist_plan(port, sql), mesh)
    rows = ddb_tpu_torch.api.QueryResult(schema, batch).fetchall()
    assert not gathered
    assert {g: (x, y) for g, x, y, _, _ in rows} == want
    for g, _, y, avg, cnt in rows:
        assert cnt == sizes[g] and avg == pytest.approx(y / cnt, rel=1e-15)
    assert sorted(rows) == sorted(port.execute(sql).fetchall())

    sql = "SELECT sum(x), sum(y), min(y), count(*) FROM w"
    schema, batch = EX.execute_distributed(dist_plan(port, sql), mesh)
    rows = ddb_tpu_torch.api.QueryResult(schema, batch).fetchall()
    total = sum(sizes.values())
    assert rows == [(sum(x for x, _ in want.values()),
                     sum(y for _, y in want.values()), BIG_INT - 3, total)]
    assert rows == port.execute(sql).fetchall()
    assert not gathered


def test_a_sum_near_the_int64_limit_stays_narrow_where_it_fits(mesh):
    """Sums just under 2^63 that the bounds cannot prove narrow take two
    limbs and equal the single-device executor's."""
    from test_torch_dist_executor import dist_plan
    port = ddb_tpu_torch.connect(device="cpu")
    port.register("n", {"g": np.arange(64) % 4,
                        "y": np.full(64, (2**63 - 1) // 64, np.int64)})
    sql = "SELECT g, sum(y) FROM n GROUP BY g"
    schema, batch = EX.execute_distributed(dist_plan(port, sql), mesh)
    rows = ddb_tpu_torch.api.QueryResult(schema, batch).fetchall()
    assert sorted(rows) == sorted(port.execute(sql).fetchall()) \
        == [(g, 16 * ((2**63 - 1) // 64)) for g in range(4)]


# ---- PRAGMA verify_parallelism --------------------------------------------------

def test_verify_parallelism_runs_the_distributed_variant(monkeypatch):
    port = ddb_tpu_torch.connect(device="cpu")
    port.register("t", {"a": np.arange(300) % 7, "b": np.arange(300)})
    meshes = []
    orig = EX.execute_distributed

    def spy(plan, m):
        meshes.append(m)
        return orig(plan, m)

    monkeypatch.setattr(EX, "execute_distributed", spy)
    port.execute("PRAGMA verify_parallelism")
    rows = port.execute("SELECT a, sum(b) FROM t GROUP BY a").fetchall()
    assert len(rows) == 7
    assert len(meshes) == 1 and meshes[0].devices == (CPU,) * 8
    # a distributed variant that disagrees fails the statement
    def no_rows(plan, m):
        schema, b = orig(plan, m)
        return schema, b._replace(sel=torch.zeros_like(b.sel))

    monkeypatch.setattr(EX, "execute_distributed", no_rows)
    with pytest.raises(RuntimeError, match="distributed"):
        port.execute("SELECT a, count(*) FROM t GROUP BY a")
    port.execute("PRAGMA disable_verify_parallelism")
    port.execute("SELECT a, count(*) FROM t GROUP BY a")


def test_verify_parallelism_matches_the_reference_session():
    rows = {}
    for pkg, con in (("ref", ddb_tpu.connect()),
                     ("port", ddb_tpu_torch.connect(device="cpu"))):
        con.execute("CREATE TABLE t (a INTEGER, b VARCHAR)")
        con.execute("INSERT INTO t VALUES (1, 'x'), (2, 'y'), (3, 'x')")
        con.execute("SET verify_parallelism = true")
        rows[pkg] = con.execute(
            "SELECT current_setting('verify_parallelism')").fetchall()
    assert rows["port"] == rows["ref"]

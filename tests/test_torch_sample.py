"""USING SAMPLE in ddb_tpu_torch.  The reference package draws from
jax.random and this one from a torch.Generator, so the sampled rows
cannot match; the executor is held by the properties both must have:
`rows` keeps exactly min(amount, live) live rows; `percent` keeps a count
within 5 standard deviations of the binomial mean; the same seed gives
the same rows twice on one device; sampled rows are live rows.  The
reference package is held to the same properties on the same statements.
"""

import math

import numpy as np
import pytest
import torch

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch.batch import make_batch
from ddb_tpu_torch.plan import logical as L
from ddb_tpu_torch.plan import physical
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

N = 20_000


@pytest.fixture(scope="module")
def cons():
    rng = np.random.default_rng(2)
    cols = {"id": np.arange(N, dtype=np.int64),
            "v": rng.integers(0, 100, N).astype(np.int32)}
    ref = ddb_tpu.connect()
    port = ddb_tpu_torch.connect(device="cpu")
    ref.register("s", cols)
    port.register("s", cols)
    return ref, port


@pytest.mark.parametrize("which", ["reference", "port"])
@pytest.mark.parametrize("amount", [0, 1, 10, 1000, N, N + 5])
def test_rows_keeps_exactly_min_amount_live(cons, which, amount):
    con = cons[which == "port"]
    rows = con.execute(
        f"SELECT id FROM (SELECT * FROM s WHERE v < 50) USING SAMPLE "
        f"{amount} ROWS").fetchall()
    live = con.execute("SELECT count(*) FROM s WHERE v < 50").fetchall()[0][0]
    assert len(rows) == min(amount, live)
    assert len({r[0] for r in rows}) == len(rows)


@pytest.mark.parametrize("which", ["reference", "port"])
@pytest.mark.parametrize("pct", [1, 10, 50, 90])
def test_percent_is_within_five_deviations(cons, which, pct):
    con = cons[which == "port"]
    got = con.execute(
        f"SELECT count(*) FROM s USING SAMPLE {pct} PERCENT").fetchall()[0][0]
    p = pct / 100.0
    assert abs(got - N * p) <= 5 * math.sqrt(N * p * (1 - p))


@pytest.mark.parametrize("spec", ["10 PERCENT REPEATABLE (42)",
                                  "500 ROWS REPEATABLE (7)",
                                  "10 PERCENT"])
def test_same_seed_same_rows(cons, spec):
    _, port = cons
    sql = f"SELECT id FROM s USING SAMPLE {spec}"
    first = port.execute(sql).fetchall()
    assert port.execute(sql).fetchall() == first        # cached plan
    port._plan_cache.clear()
    assert port.execute(sql).fetchall() == first        # bound anew


def test_other_seed_other_rows(cons):
    _, port = cons
    a = port.execute("SELECT id FROM s USING SAMPLE 10 PERCENT "
                     "REPEATABLE (1)").fetchall()
    b = port.execute("SELECT id FROM s USING SAMPLE 10 PERCENT "
                     "REPEATABLE (2)").fetchall()
    assert a != b


def test_sampled_rows_are_live_rows(cons):
    _, port = cons
    rows = port.execute("SELECT id, v FROM (SELECT * FROM s WHERE v >= 90) "
                        "USING SAMPLE 50 PERCENT REPEATABLE (3)").fetchall()
    assert rows and all(v >= 90 for _, v in rows)
    rows = port.execute("SELECT id, v FROM (SELECT * FROM s WHERE v >= 90) "
                        "USING SAMPLE 100 ROWS REPEATABLE (3)").fetchall()
    assert len(rows) == 100 and all(v >= 90 for _, v in rows)


def test_executor_draws_from_a_seeded_generator_on_the_batch_device():
    b = make_batch([np.arange(1000, dtype=np.int64)], device="cpu")
    dead = b._replace(sel=b.sel & (torch.arange(b.capacity) % 3 != 0))
    leaf = physical_leaf(dead)
    out = []
    for seed in (5, 5, 6):
        node = L.Sample(leaf, "rows", 100, seed)
        _, s = physical._execute(node, physical.ExecContext("cpu"))
        assert int(s.count) == 100 and int(s.sel.sum()) == 100
        assert not bool((s.sel & ~dead.sel).any())      # subset of live rows
        out.append(s.sel)
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    # the global generator's state plays no part
    torch.manual_seed(0)
    _, s = physical._execute(L.Sample(leaf, "rows", 100, 5),
                             physical.ExecContext("cpu"))
    assert torch.equal(s.sel, out[0])


def physical_leaf(batch):
    """A plan leaf that returns `batch`."""
    from ddb_tpu_torch import types as PT
    from ddb_tpu_torch.batch import Field, Schema

    class Leaf(L.LogicalNode):
        schema = Schema((Field("x", PT.BIGINT),))

        def children(self):
            return []

    physical._EXEC[Leaf] = lambda node, ctx: (node.schema, batch)
    return Leaf()

"""The reference's small helpers with a meaning on torch tensors, against
the reference's on the same inputs: ops/order.py compact_permutation and
apply_permutation, Batch.column and Batch.with_columns, and
parallel/exchange.py ShardBatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddb_tpu import batch as ref_batch
from ddb_tpu.ops import order as ref_order
from ddb_tpu.parallel import exchange as ref_exchange
from ddb_tpu_torch import batch
from ddb_tpu_torch.ops import order
from ddb_tpu_torch.parallel import exchange


@pytest.mark.parametrize("n,p", [(1, 0.5), (257, 0.0), (1000, 0.3),
                                 (4096, 1.0)])
def test_compact_permutation_is_the_references(n, p):
    sel = np.random.default_rng(n).random(n) < p
    want = np.asarray(ref_order.compact_permutation(jnp.asarray(sel)))
    got = order.compact_permutation(torch.from_numpy(sel))
    assert np.array_equal(got.numpy(), want)


def test_apply_permutation_is_the_references():
    rng = np.random.default_rng(1)
    n = 300
    data = [rng.integers(-50, 50, n), rng.random(n)]
    nulls = [None, rng.random(n) < 0.2]
    sel = rng.random(n) < 0.6
    perm = rng.permutation(n)
    want_cols, want_sel = ref_order.apply_permutation(
        [(jnp.asarray(d), None if m is None else jnp.asarray(m))
         for d, m in zip(data, nulls)], jnp.asarray(sel), jnp.asarray(perm))
    got_cols, got_sel = order.apply_permutation(
        [(torch.from_numpy(d), None if m is None else torch.from_numpy(m))
         for d, m in zip(data, nulls)], torch.from_numpy(sel),
        torch.from_numpy(perm))
    assert np.array_equal(got_sel.numpy(), np.asarray(want_sel))
    for (gd, gm), (wd, wm) in zip(got_cols, want_cols):
        assert np.array_equal(gd.numpy(), np.asarray(wd))
        assert (gm is None) == (wm is None)
        if wm is not None:
            assert np.array_equal(gm.numpy(), np.asarray(wm))


def test_batch_column_and_with_columns_are_the_references():
    vals = [np.arange(8), np.arange(8) * 2.5]
    sel = np.arange(8) % 3 != 0
    ref = ref_batch.Batch(tuple(ref_batch.Column(jnp.asarray(v), None)
                                for v in vals), jnp.asarray(sel),
                          jnp.asarray(int(sel.sum()), jnp.int32))
    port = batch.Batch(tuple(batch.Column(torch.from_numpy(v), None)
                             for v in vals), torch.from_numpy(sel),
                       torch.tensor(int(sel.sum()), dtype=torch.int32))
    for i in range(2):
        assert np.array_equal(port.column(i).data.numpy(),
                              np.asarray(ref.column(i).data))
    ref2 = ref.with_columns([ref.column(1)])
    port2 = port.with_columns([port.column(1)])
    assert isinstance(port2, batch.Batch) and isinstance(port2.columns,
                                                         tuple)
    assert len(port2.columns) == len(ref2.columns) == 1
    assert np.array_equal(port2.columns[0].data.numpy(),
                          np.asarray(ref2.columns[0].data))
    assert port2.sel is port.sel and port2.count is port.count


def test_shard_batch_has_the_references_fields():
    assert exchange.ShardBatch._fields == ref_exchange.ShardBatch._fields
    sb = exchange.ShardBatch((torch.arange(4),), torch.ones(4, dtype=bool))
    assert sb.arrays[0].shape == sb.valid.shape

"""The port's compare-exchange stages (ddb_tpu_torch/ops/cmpx.py) against
a numpy oracle written from the `i ^ d` formulation, and against the TPU
kernel's own formulation.

The TPU kernel is a closure inside main() of scripts/exp_mosaic_cmpx.py
(lines 34-55) and cannot be imported, and that script stays as it is.  Its
body is restated here with jnp.roll in place of pltpu.roll (both rotate
rows towards higher indices), DMIN as an argument instead of an
environment variable, and one call per tile, as its grid makes.

All values are integers: every comparison is exact.  The CUDA kernel runs
only on a card; there chip_smoke.py holds it against the plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddb_tpu_torch.bench import cmpx_probe
from ddb_tpu_torch.ops import cmpx as C
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

CASES = cmpx_probe.cases()
_IDS = [c[0] for c in CASES]


def _oracle(hi, lo, rows, stages, dmin):
    """Row i exchanges with row i ^ d of its lane (same tile, since the
    tile is a multiple of 2d rows); bit d clear keeps the minimum."""
    h, l = hi.astype(np.int64), lo.astype(np.int64)
    i = np.arange(h.shape[0])
    for t in range(stages):
        d = dmin << (t % 5)
        p = i ^ d
        assert ((p // rows) == (i // rows)).all()
        mine, theirs = (h << 32) + (l + 2**31), (h[p] << 32) + (l[p] + 2**31)
        upper = ((i & d) != 0)[:, None]
        take = np.where(upper, theirs > mine, theirs < mine)
        h, l = np.where(take, h[p], h), np.where(take, l[p], l)
    return h.astype(np.int32), l.astype(np.int32)


def _script_kernel(h, l, stages, dmin):
    """scripts/exp_mosaic_cmpx.py:34-55 on one tile, with jnp.roll."""
    rows = h.shape[0]
    riota = jnp.arange(rows, dtype=jnp.int32)[:, None] \
        * jnp.ones((1, 128), jnp.int32)
    for t in range(stages):
        d = dmin << (t % 5)
        up = jnp.roll(h, rows - d, 0)
        dn = jnp.roll(h, d, 0)
        upl = jnp.roll(l, rows - d, 0)
        dnl = jnp.roll(l, d, 0)
        bit = (riota & d) != 0
        ph = jnp.where(bit, dn, up)
        pl_ = jnp.where(bit, dnl, upl)
        gt = (h > ph) | ((h == ph) & (l > pl_))
        want_min = ~bit
        take_partner = want_min == gt
        h = jnp.where(take_partner, ph, h)
        l = jnp.where(take_partner, pl_, l)
    return h, l


def _port(hi, lo, rows, stages, dmin, fn=C.cmpx_stages):
    h, l = fn(torch.from_numpy(hi), torch.from_numpy(lo), rows, stages, dmin)
    return h.numpy(), l.numpy()


@pytest.mark.parametrize("name,hi,lo,rows,stages,dmin", CASES, ids=_IDS)
def test_plain_matches_xor_oracle(name, hi, lo, rows, stages, dmin):
    want = _oracle(hi, lo, rows, stages, dmin)
    got = _port(hi, lo, rows, stages, dmin, C.cmpx_stages_plain)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("name,hi,lo,rows,stages,dmin", CASES, ids=_IDS)
def test_plain_matches_script_formulation(name, hi, lo, rows, stages, dmin):
    got = _port(hi, lo, rows, stages, dmin)
    for t in range(hi.shape[0] // rows):
        tile = slice(t * rows, (t + 1) * rows)
        wh, wl = _script_kernel(jnp.asarray(hi[tile]), jnp.asarray(lo[tile]),
                                stages, dmin)
        assert np.array_equal(got[0][tile], np.asarray(wh))
        assert np.array_equal(got[1][tile], np.asarray(wl))


def test_stages_keep_each_lane_a_permutation_and_sort_groups():
    # 45 stages at distances 1..16 leave every lane's pairs a permutation
    # of its inputs; tiles and lanes never mix
    _, hi, lo, rows, stages, dmin = CASES[1]
    h, l = _port(hi, lo, rows, stages, dmin)
    key_in = (hi.astype(np.int64) << 32) + lo
    key_out = (h.astype(np.int64) << 32) + l
    for t in range(hi.shape[0] // rows):
        tile = slice(t * rows, (t + 1) * rows)
        assert np.array_equal(np.sort(key_in[tile], 0),
                              np.sort(key_out[tile], 0))


def test_cpu_tensors_launch_nothing_and_inputs_stay():
    _, hi, lo, rows, stages, dmin = CASES[0]
    th, tl = torch.from_numpy(hi.copy()), torch.from_numpy(lo.copy())
    before = dict(C.LAUNCHES)
    C.cmpx_stages(th, tl, rows, stages, dmin)
    assert C.LAUNCHES == before
    assert np.array_equal(th.numpy(), hi) and np.array_equal(tl.numpy(), lo)


@pytest.mark.parametrize("kwargs", [
    dict(rows=64, dmin=4),         # dmin << 4 == rows: partner off the tile
    dict(rows=64, dmin=3),         # not a power of two
    dict(rows=96),                 # 128 rows are not whole tiles of 96
    dict(rows=48),                 # not a multiple of 32
    dict(rows=64, stages=-1),
], ids=["dmin_too_large", "dmin_not_pow2", "ragged_tiles", "rows_not_32",
        "negative_stages"])
def test_rejects_bad_arguments(kwargs):
    a = torch.zeros((128, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        C.cmpx_stages(a, a, **kwargs)


@pytest.mark.parametrize("hi,lo", [
    (torch.zeros((64, 128), dtype=torch.int64),
     torch.zeros((64, 128), dtype=torch.int32)),
    (torch.zeros((64, 64), dtype=torch.int32),
     torch.zeros((64, 64), dtype=torch.int32)),
    (torch.zeros((64, 128), dtype=torch.int32),
     torch.zeros((128, 128), dtype=torch.int32)),
    (torch.zeros((128, 128), dtype=torch.int32)[::2],
     torch.zeros((64, 128), dtype=torch.int32)),
], ids=["dtype", "lanes", "shapes_differ", "strided"])
def test_rejects_bad_tensors(hi, lo):
    with pytest.raises(ValueError):
        C.cmpx_stages(hi, lo, rows=64)


def test_probe_inputs_are_the_scripts():
    # scripts/exp_mosaic_cmpx.py:82-87 for seed 0, at 2 tiles' worth of
    # the stream's start (the script draws hi whole, then lo)
    hi, lo = cmpx_probe.make_inputs(tiles=2, rows=64, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    want_hi = rng.integers(0, 1 << 31, (128, 128), dtype=np.int64)
    want_lo = rng.integers(0, 1 << 31, (128, 128), dtype=np.int64)
    assert hi.dtype == torch.int32 and lo.dtype == torch.int32
    assert np.array_equal(hi.numpy(), want_hi.astype(np.int32))
    assert np.array_equal(lo.numpy(), want_lo.astype(np.int32))


def test_probe_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        cmpx_probe.run(tiles=1, rows=64, device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc "
                    "there); run python3 chip_smoke.py on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name,hi,lo,rows,stages,dmin", CASES, ids=_IDS)
def test_cuda_kernel_matches_plain(cuda_device, name, hi, lo, rows, stages,
                                   dmin):
    th = torch.from_numpy(hi).to(cuda_device)
    tl = torch.from_numpy(lo).to(cuda_device)
    before = C.LAUNCHES["cmpx"]
    got = C.cmpx_stages(th, tl, rows, stages, dmin)
    want = C.cmpx_stages_plain(th, tl, rows, stages, dmin)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert C.LAUNCHES["cmpx"] == before + 1

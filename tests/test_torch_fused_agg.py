"""The port's fused Q1/Q6 aggregates (ddb_tpu_torch/ops/fused_agg.py)
against the reference package's Pallas kernels (ddb_tpu/ops/pallas_agg.py,
run in interpret mode as tests/test_pallas.py runs them) and the exact
numpy oracles.  Integer results: exact equality."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddb_tpu.ops import pallas_agg as P
from ddb_tpu_torch import kernels
from ddb_tpu_torch.bench.fused_agg_cases import (cases, port_case_inputs,
                                                 port_cases)
from ddb_tpu_torch.ops import fused_agg as F
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

CASES = cases()
# what only the port's Q1 kernel must take (ragged, misaligned, ...)
PORT_CASES = port_cases()
PORT_IDS = [c[0] for c in PORT_CASES]

# case name -> the reference entry point it mirrors (tests/test_pallas.py)
_REFERENCE = {
    "q1_v2": P.q1_fused_aggregate,
    "q1_v3": P.q1_fused_aggregate_v3,
    "q1_v3_extreme": P.q1_fused_aggregate_v3,
    "q1_v4": P.q1_fused_aggregate_v4,
    "q1_v4_extreme": P.q1_fused_aggregate_v4,
    "q1_v7": P.q1_fused_aggregate_v7,
    "q6": P.q6_fused_filter_sum,
    "q6_max_ext": P.q6_fused_filter_sum,
}


def _port(kind, cols, cut):
    t = [torch.from_numpy(c) for c in cols]
    if kind == "q1":
        return F.q1_fused_aggregate(*t, cut).numpy()
    return int(F.q6_fused_filter_sum(*t, cut))


@pytest.mark.parametrize("name,kind,cols,cut", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_oracle(name, kind, cols, cut):
    got = _port(kind, cols, cut)
    if kind == "q1":
        assert np.array_equal(got, P.reference_sums(*cols, cut))
        assert np.array_equal(got, F.reference_sums(*cols, cut))
    else:
        assert got == P.q6_reference(*cols, cut) == F.q6_reference(*cols,
                                                                   cut)


@pytest.mark.parametrize("name,kind,cols,cut", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(name, kind, cols, cut):
    n = cols[0].shape[0]
    kw = {"tile_sublanes": 64} if name == "q6_max_ext" else {}
    want = _REFERENCE[name](*(jnp.asarray(c) for c in cols), cut,
                            n_rows=n, interpret=True, **kw)
    got = _port(kind, cols, cut)
    if kind == "q1":
        assert np.array_equal(got, np.asarray(want))
    else:
        assert got == int(want)


@pytest.mark.parametrize("case", PORT_CASES, ids=PORT_IDS)
def test_port_case_plain_matches_oracle(case):
    _, _, _, cut, blocks = case
    cols, tensors = port_case_inputs(case, "cpu")
    got = F.q1_fused_aggregate(*tensors, cut, blocks=blocks).numpy()
    assert np.array_equal(got, P.reference_sums(*cols, cut))
    assert np.array_equal(got, F.reference_sums(*cols, cut))


def _q1_pack(qty, ext, disc, tax):
    """The kernel's packed words of each row, uint64 [rows, Q1_WORDS],
    from the layout that ops/fused_agg.py states."""
    q, e, d, t = (x.astype(np.uint64) for x in (qty, ext, disc, tax))
    m, f = np.uint64(100) - d, np.uint64(100) + t
    dpA, dpB = (e >> np.uint64(16)) * m, (e & np.uint64(0xFFFF)) * m
    words = np.zeros((q.shape[0], F.Q1_WORDS), np.uint64)
    fields = dict(qty=q, disc=d, count=np.ones_like(q), dpA=dpA, dpB=dpB)
    for name, (word, shift, bits) in F.Q1_FIELDS.items():
        assert (fields[name] >> np.uint64(bits) == 0).all()
        words[:, word] |= fields[name] << np.uint64(shift)
    words[:, 2], words[:, 3], words[:, 4] = e, dpA * f, dpB * f
    return words


def _q1_unpack(words):
    """uint64 [Q1_WORDS] sums of packed words -> the 8 payload sums."""
    def field(name):
        word, shift, bits = F.Q1_FIELDS[name]
        return (int(words[word]) >> shift) & ((1 << bits) - 1)
    return [field("qty"), int(words[2]), field("disc"), field("count"),
            field("dpA"), field("dpB"), int(words[3]), int(words[4])]


@pytest.mark.parametrize("disc", [0, 100], ids=["max_dp", "max_disc"])
def test_q1_packed_sums_survive_a_flush_interval(disc):
    # a thread packs FLUSH_ROWS rows between flushes, and one more at the
    # ragged tail; at the contract's maxima no field may reach its
    # neighbour
    n = F.FLUSH_ROWS + 1
    cols = [np.full(n, v, np.int32)
            for v in (1 << 20, (1 << 31) - 1, disc, 8)]
    sums = _q1_pack(*cols).sum(axis=0, dtype=np.uint64)
    ship, gid = np.zeros(n, np.int32), np.zeros(n, np.int32)
    want = F.reference_sums(*cols, ship, gid, 0)[0]
    assert _q1_unpack(sums) == want.tolist()
    # and the test can see an overflow: 656 rows of disc 100 pass 2^16
    over = _q1_pack(*(np.full(656, v, np.int32)
                      for v in (0, 0, 100, 0))).sum(axis=0, dtype=np.uint64)
    assert _q1_unpack(over)[2] != 656 * 100


def test_q1_packing_constants_match_the_kernel_source():
    src = (kernels.SRC_DIR / "fused_agg.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert constant("kFlushRows") == F.FLUSH_ROWS
    assert constant("kWords") == F.Q1_WORDS
    assert constant("kGroups") == F.GROUPS
    assert constant("kPayloads") == F.PAYLOADS
    assert constant("kDiscShift") == F.Q1_FIELDS["disc"][1]
    assert constant("kCountShift") == F.Q1_FIELDS["count"][1]
    assert constant("kDpBShift") == F.Q1_FIELDS["dpB"][1]
    # the widths follow from the shifts: fields fill their words
    for word in (0, 1):
        spans = sorted((shift, bits) for w, shift, bits
                       in F.Q1_FIELDS.values() if w == word)
        assert spans[0][0] == 0 and sum(b for _, b in spans) == 64
        assert all(a[0] + a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # the kernel's block size and unroll divide the flush interval
    per_iter = 4 * constant("kQ1Unroll")
    assert F.FLUSH_ROWS % per_iter == 0
    assert constant("kQ1Threads") == F._THREADS


def test_q1_limb_reconstruction():
    sums = np.arange(F.GROUPS * F.PAYLOADS, dtype=np.int64).reshape(
        F.GROUPS, F.PAYLOADS)
    r = F.q1_results_from_sums(sums)
    assert r["sum_disc_price"][0] == 4 * (1 << 16) + 5
    assert r["count"][1] == sums[1, 3]
    want = P.q1_results_from_sums(sums)
    assert all(np.array_equal(r[k], want[k]) for k in want)


def test_ragged_length_and_cpu_launches_nothing():
    # any row count (the TPU contract needed n % 1024 == 0)
    name, kind, cols, cut = CASES[0]
    cols = [c[:1000] for c in cols]
    before = dict(F.LAUNCHES)
    got = _port(kind, cols, cut)
    assert np.array_equal(got, F.reference_sums(*cols, cut))
    assert F.LAUNCHES == before


def test_rejects_mismatched_inputs():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        F.q6_fused_filter_sum(a, a, a.to(torch.int64), a, 0)
    with pytest.raises(ValueError):
        F.q6_fused_filter_sum(a, a, a[:4], a, 0)


def test_whole_unit_q6_selects_rows_and_matches_sql():
    # synth_lineitem stores l_quantity scaled by 100; fed in whole units,
    # the Q6 kernel's predicate fires and its revenue equals SQL Q6's
    import decimal

    import ddb_tpu_torch
    from ddb_tpu_torch.bench.tpch import TPCH_QUERIES, register_synth_lineitem

    con = ddb_tpu_torch.connect(device="cpu")
    register_synth_lineitem(con, 64 * 1024, seed=0)
    kin = F.lineitem_kernel_inputs(con.catalog.get_table("lineitem"), "cpu")
    rev = int(F.q6_fused_filter_sum(kin["qty"], kin["ext"], kin["disc"],
                                    kin["ship"], 8766))
    assert rev > 0
    (sql_rev,), = con.execute(TPCH_QUERIES[6]).fetchall()
    assert sql_rev == decimal.Decimal(rev).scaleb(-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc "
                    "there); run python3 chip_smoke.py on the card")
    return torch.device("cuda", 0)


# the reference's cases, then the port's own in their five-field form
_CUDA_CASES = [(name, kind, (name, cols, (0,) * len(cols), cut, None))
               for name, kind, cols, cut in CASES] \
    + [(c[0], "q1", c) for c in PORT_CASES]


@pytest.mark.parametrize("name,kind,case", _CUDA_CASES,
                         ids=[c[0] for c in _CUDA_CASES])
def test_cuda_kernel_matches_plain(cuda_device, name, kind, case):
    _, _, offsets, cut, blocks = case
    _, t = port_case_inputs(case, cuda_device)
    before = dict(F.LAUNCHES)
    if kind == "q1":
        assert [x.data_ptr() % 16 for x in t] == [4 * k for k in offsets]
        got = F.q1_fused_aggregate(*t, cut, blocks=blocks)
        want = F.q1_fused_aggregate_plain(*t, cut)
    else:
        got = F.q6_fused_filter_sum(*t, cut)
        want = F.q6_fused_filter_sum_plain(*t, cut)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert F.LAUNCHES[kind] == before[kind] + 1

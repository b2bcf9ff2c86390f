"""The port's fused Q1/Q6 aggregates (ddb_tpu_torch/ops/fused_agg.py)
against the reference package's Pallas kernels (ddb_tpu/ops/pallas_agg.py,
run in interpret mode as tests/test_pallas.py runs them) and the exact
numpy oracles.  Integer results: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ddb_tpu.ops import pallas_agg as P
from ddb_tpu_torch.bench.fused_agg_cases import cases
from ddb_tpu_torch.ops import fused_agg as F

CASES = cases()

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


@pytest.mark.parametrize("name,kind,cols,cut", CASES,
                         ids=[c[0] for c in CASES])
def test_cuda_kernel_matches_plain(cuda_device, name, kind, cols, cut):
    t = [torch.from_numpy(c).to(cuda_device) for c in cols]
    before = dict(F.LAUNCHES)
    if kind == "q1":
        got = F.q1_fused_aggregate(*t, cut)
        want = F.q1_fused_aggregate_plain(*t, cut)
    else:
        got = F.q6_fused_filter_sum(*t, cut)
        want = F.q6_fused_filter_sum_plain(*t, cut)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert F.LAUNCHES[kind] == before[kind] + 1

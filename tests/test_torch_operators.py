"""bench/operators.py, the port of scripts/bench_operators.py, on the CPU:
every probe's result against its plain answer, the join probe and the
exchange pack against the reference's ops/join.py and pack on the same
inputs through JAX, and the result keys and roofline formulas of the
reference script with this card's constants."""

import math
import os
import re

import jax
import jax.lax as lax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddb_tpu.ops import hashing as ref_hashing
from ddb_tpu.ops import join as ref_join
from ddb_tpu_torch.bench import operators
from ddb_tpu_torch.ops import join as join_ops
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
N = 20_000


@pytest.fixture(scope="module", autouse=True)
def small_join():
    """The join probe's build side at a CPU's size (the card's is 2^20)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(operators, "JOIN_BUILD_ROWS", 1 << 12)
        yield


@pytest.fixture(scope="module")
def record():
    return operators.run(N, device="cpu")


def test_result_keys_are_the_reference_scripts(record):
    with open(os.path.join(_ROOT, "scripts", "bench_operators.py")) as f:
        src = f.read()
    assert set(record["results"]) == set(
        re.findall(r'results\["(\w+)"\] = ', src))
    assert record["rows"] == N and record["chip"] == "cpu (host)"
    for name, r in record["results"].items():
        for key in ("rows_per_sec", "roofline", "roofline_frac", "config",
                    "measured_at", "ms", "samples_ms"):
            assert key in r, (name, key)
        assert len(r["samples_ms"]) == operators.RUNS
        assert r["roofline_frac"] == r["rows_per_sec"] / r["roofline"]


def test_rooflines_are_the_reference_formulas_for_this_card(record):
    bw = operators.HBM_BW
    assert bw == 3.35e12
    r = record["results"]
    assert r["_hbm_probe"]["roofline"] == bw / 12
    assert r["_hbm_probe"]["bytes_per_sec"] == \
        12 * r["_hbm_probe"]["rows_per_sec"]
    assert r["filter"]["roofline"] == bw / 12
    assert r["aggregate"]["roofline"] == bw / 24
    assert r["sort"]["roofline"] == r["sort"]["rows_per_sec"]
    assert r["sort"]["merge_model_roofline"] == \
        bw / (12 * math.ceil(math.log2(N)))
    assert r["exchange_pack"]["roofline"] == max(
        r["exchange_pack"]["rows_per_sec"],
        r["exchange_pack"]["sorts_only_rows_per_sec"])
    assert r["join_probe"]["roofline"] == \
        N / (r["join_probe"]["sorts_only_ms"] / 1e3)


def test_each_probe_fails_on_a_wrong_answer(monkeypatch):
    rng = np.random.default_rng(0)

    def wrong_probe(bt, pk, pkn, psel):
        lo, cnt = orig(bt, pk, pkn, psel)
        cnt = cnt.clone()
        cnt[0] = 0
        return lo, cnt

    orig = join_ops.probe_ranges
    monkeypatch.setattr(join_ops, "probe_ranges", wrong_probe)
    with pytest.raises(AssertionError, match="join_probe"):
        operators.bench_join({}, 2000, rng, CPU)
    from ddb_tpu_torch.ops import fused_agg
    monkeypatch.setattr(fused_agg, "q1_fused_aggregate",
                        lambda *a: fused_agg.q1_fused_aggregate_plain(
                            *a[:5], torch.zeros_like(a[5]), a[6]))
    with pytest.raises(AssertionError, match="aggregate"):
        operators.bench_aggregate({}, 2000, rng, CPU)


def _join_inputs(n, nb):
    rng = np.random.default_rng(0)
    return (rng.permutation(nb).astype(np.int64),
            rng.integers(0, nb + nb // 4, n).astype(np.int64))


def test_join_probe_counts_equal_the_references(fast_reference_compiles):
    n, nb = 6000, 1024
    bk, pk = _join_inputs(n, nb)
    bsel, psel = np.ones(nb, bool), np.ones(n, bool)
    rbt = ref_join.build(jnp.asarray(bk), None, jnp.asarray(bsel))
    rlo, rcnt = ref_join.probe_ranges(rbt, jnp.asarray(pk), None,
                                      jnp.asarray(psel))
    bt = join_ops.build(torch.from_numpy(bk), None, torch.from_numpy(bsel))
    lo, cnt = join_ops.probe_ranges(bt, torch.from_numpy(pk), None,
                                    torch.from_numpy(psel))
    assert np.array_equal(cnt.numpy(), np.asarray(rcnt))
    assert np.array_equal(lo.numpy(), np.asarray(rlo))
    assert 0 < int(cnt.sum()) < n       # a fifth of the keys miss


def _reference_pack(keys, pay, sel, n_shards, cap):
    """The reference script's pack_once (scripts/bench_operators.py
    _bench_exchange): its send buffers and each block's row count."""
    pid = ref_hashing.partition_of(ref_hashing.hash64(keys), n_shards)
    p = jnp.where(sel, pid, n_shards)
    sp, sk, spay = lax.sort([p, keys, pay], num_keys=1, is_stable=True)
    counts = jnp.stack([(sp == q).astype(jnp.int32).sum()
                        for q in range(n_shards)])
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    padded = jnp.concatenate([sk, jnp.zeros(cap, dtype=sk.dtype)])
    paddedp = jnp.concatenate([spay, jnp.zeros(cap, dtype=spay.dtype)])
    send = jnp.stack([lax.dynamic_slice(padded, (starts[q],), (cap,))
                      for q in range(n_shards)])
    sendp = jnp.stack([lax.dynamic_slice(paddedp, (starts[q],), (cap,))
                       for q in range(n_shards)])
    return send, sendp, counts


def test_exchange_pack_equals_the_references(fast_reference_compiles):
    n, n_shards = 4096, operators.EXCHANGE_SHARDS
    cap = (n // n_shards) * 2
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 40, n).astype(np.int64)
    pay = rng.integers(0, 1 << 30, n).astype(np.int64)
    sel = rng.random(n) < 0.9
    want, wantp, counts = (np.asarray(x) for x in jax.jit(
        _reference_pack, static_argnums=(3, 4))(
        jnp.asarray(keys), jnp.asarray(pay), jnp.asarray(sel), n_shards,
        cap))
    send, sendp, valid, overflow = operators.exchange_send(
        torch.from_numpy(keys), torch.from_numpy(pay),
        torch.from_numpy(sel), n_shards, cap)
    assert int(overflow) == 0
    assert np.array_equal(valid.sum(1).numpy(), counts)
    live = valid.numpy()
    # the slots past a block's rows differ by design: the reference pads
    # with zeros and the port clamps (parallel/exchange.py); the live
    # slots hold the same rows in the same order, so their sums agree
    slot = np.arange(cap)[None, :] < counts[:, None]
    assert np.array_equal(live, slot)
    assert np.array_equal(send.numpy()[live], want[slot])
    assert np.array_equal(sendp.numpy()[live], wantp[slot])
    assert int(send[valid].sum() + sendp[valid].sum()) == \
        int(want[slot].sum() + wantp[slot].sum()) == \
        int(keys[sel].sum() + pay[sel].sum())


def test_main_writes_the_record(tmp_path, capsys):
    out = tmp_path / "ops.json"
    assert operators.main(["--out", str(out), "--rows", "3000", "--op",
                           "filter", "--device", "cpu"]) == 0
    import json
    rec = json.loads(out.read_text())
    assert list(rec["results"]) == ["filter"] and rec["rows"] == 3000
    assert "filter" in capsys.readouterr().out


def test_run_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        operators.run(1000)

"""bench/h2oai_scale.py (the port of scripts/run_h2oai_scale.py) against the
reference script and ddb_tpu: the same draws at skew 0 and 1.1, DuckDB's
checksums, the harness's checksum queries through both packages over the
same 20,000 rows, the suite over eight CPU shards, and the refusal of the
1e8 oracle for any other table.

K is 10, not the benchmark's 100: at 20,000 rows and K = 100 the (id2,
id4) groups of q9 hold about 2 rows each, so their correlation is NaN in
both packages and the checksum proves nothing."""

import importlib.util
import json
import os

import numpy as np
import pytest

import ddb_tpu
import ddb_tpu_torch
from ddb_tpu_torch.bench import h2oai, h2oai_scale
from test_torch_reference_jit import fast_reference_compiles  # noqa: F401

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K = 20_000, 10


@pytest.fixture(scope="module")
def script():
    """scripts/run_h2oai_scale.py, imported by its path."""
    path = os.path.join(_ROOT, "scripts", "run_h2oai_scale.py")
    spec = importlib.util.spec_from_file_location("run_h2oai_scale", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _as_numbers(ref_cols):
    """The reference script's (kind, codes, dictionary) columns as
    numbers: a string id is its code plus one."""
    return {name: (data + 1 if kind == "str" else data)
            for name, (kind, data, _) in ref_cols.items()}


@pytest.mark.parametrize("skew", [0.0, 1.1])
def test_generate_scale_draws_the_reference_scripts_columns(script, skew):
    ref = script.generate_scale(N, k=K, skew=skew)
    port = h2oai_scale.generate_scale(N, k=K, skew=skew)
    assert list(port) == list(ref)
    for name, (kind, data, d) in ref.items():
        got = port[name]
        assert got.dtype == data.dtype, name
        if kind == "str":
            # the label of number v is the dictionary's entry of code v - 1
            assert np.array_equal(d[got - 1], d[data]), name
            assert np.array_equal(h2oai.id_labels(name, len(d)), d), name
        assert np.array_equal(got, _as_numbers(ref)[name]), name


def test_generate_scale_at_skew_0_is_the_suites_generator():
    scale = h2oai_scale.generate_scale(N, k=K, seed=108)
    plain = h2oai.generate(N, k=K, seed=108)
    assert list(scale) == list(plain)
    for name in plain:
        assert np.array_equal(scale[name], plain[name]), name


def test_skewed_keys_are_zipf():
    cols = h2oai_scale.generate_scale(200_000, k=100, skew=1.1)
    share = np.sort(np.bincount(cols["id1"]))[::-1] / 200_000
    assert 0.22 < share[0] < 0.25          # 23.4 % of the rows
    assert 0.61 < share[:10].sum() < 0.64  # 62.6 %


def test_oracle_1e8_is_duckdbs_checksums():
    with open(os.path.join(_ROOT, "docs", "H2OAI_SCALE_1e8.json")) as f:
        doc = json.load(f)
    assert {int(q): v for q, v in doc["oracle"].items()} \
        == h2oai_scale.ORACLE_1E8
    assert doc["n"] == h2oai_scale.ORACLE_1E8_TABLE["n"]
    assert doc["skew"] == h2oai_scale.ORACLE_1E8_TABLE["skew"]
    # the reference's own checksums pass the comparison, DuckDB's digits
    # and all
    for q, ours in doc["ours"].items():
        assert h2oai_scale.checksums_match(ours, doc["oracle"][q]), q


def test_checksums_match_is_the_scripts(script):
    pairs = [("1,2.0", "1,2.0"), ("1,2.0", "1,2.000000000001"),
             ("1,2.0", "2,2.0"), ("1,2.0", "1,2.1"), ("1", "1,2"),
             ("a,1", "b,1"), ("nan", "nan"), (",1", ",1")]
    for a, b in pairs:
        assert h2oai_scale.checksums_match(a, b) \
            == script.checksums_match(a, b), (a, b)
    rows = [(1, 2.5, None, "x"), (0.1 + 0.2, -3)]
    for row in rows:
        assert h2oai_scale.fmt_row(row) == script.fmt_row(row)
    assert h2oai_scale.RESULT_QUERIES == script.RESULT_QUERIES


def _reference_checksums(script, ref_cols):
    """The reference script's loop through ddb_tpu on the CPU."""
    from ddb_tpu.bench.h2oai import QUERIES
    con = ddb_tpu.connect()
    script.register_scale(con, ref_cols)
    out = {}
    for q in sorted(QUERIES):
        con.execute(f"CREATE OR REPLACE TEMP TABLE ans AS {QUERIES[q]}")
        out[q] = script.fmt_row(
            con.execute(script.RESULT_QUERIES[q]).fetchall()[0])
        con.execute("DROP TABLE ans")
    return out


@pytest.mark.parametrize("skew", [0.0, 1.1])
def test_checksums_equal_the_references(script, fast_reference_compiles,
                                        skew):
    want = _reference_checksums(
        script, script.generate_scale(N, k=K, skew=skew))
    con = h2oai_scale.register_scale(
        ddb_tpu_torch.connect(device="cpu"),
        h2oai_scale.generate_scale(N, k=K, skew=skew))
    got = h2oai_scale.run(con)
    for q in sorted(want):
        assert h2oai_scale.checksums_match(got[q]["checksum"], want[q]), \
            (q, got[q]["checksum"], want[q])
        # integers exactly: every field that is not a float
        for w, g in zip(want[q].split(","), got[q]["checksum"].split(",")):
            if "." not in w and "e" not in w:
                assert w == g, (q, w, g)
        assert "nan" not in want[q], (q, want[q])
        assert got[q]["groups"] == int(want[q].split(",")[-1])
    assert "ans" not in con.catalog.tables


def test_dist_8_gives_the_single_device_rows():
    con = h2oai_scale.register_scale(
        ddb_tpu_torch.connect(device="cpu"),
        h2oai_scale.generate_scale(4000, k=K, skew=1.1))
    rec = h2oai_scale.run_dist(con, 8)
    assert rec["devices"] == 8
    for q, st in rec["status"].items():
        assert st["equal"] is True, (q, st)
        assert st["fallback"] == [], (q, st)
        assert st["groups"] == int(con.execute(
            f"SELECT count(*) FROM ({h2oai.QUERIES[q]}) t").fetchall()[0][0])
    assert set(rec["exchange_stats"]) == {"exchange_retries",
                                          "exchange_overflow_rows"}
    assert con.mesh is None


def test_same_rows_names_a_difference():
    con = h2oai_scale.register_scale(
        ddb_tpu_torch.connect(device="cpu"),
        h2oai_scale.generate_scale(2000, k=K))
    a = con.execute(h2oai.QUERIES[3])
    b = con.execute(h2oai.QUERIES[3].replace("sum(v1)", "sum(v1) + 1"))
    assert h2oai_scale.same_rows("q3", a, a, ["id3"]) == 200
    with pytest.raises(AssertionError, match="q3.v1: values differ"):
        h2oai_scale.same_rows("q3", a, b, ["id3"])


def test_check_numpy_holds_the_skewed_answers():
    cols = h2oai_scale.generate_scale(5000, k=K, skew=1.1)
    con = h2oai_scale.register_scale(ddb_tpu_torch.connect(device="cpu"),
                                     cols)
    _, groups = h2oai_scale.check_numpy(con, cols)
    assert groups[1] == K and groups[10] > 0
    cols["v1"] = cols["v1"].copy()
    cols["v1"][0] += 1                 # the table no longer matches
    with pytest.raises(AssertionError, match="q1 sum"):
        h2oai_scale.check_numpy(con, cols)


@pytest.mark.parametrize("argv", [
    ["--n", "20000"], ["--k", "10"], ["--seed", "7"], ["--skew", "1.1"],
    ["--n", "100000000", "--skew", "0.5"]])
def test_oracle_1e8_refuses_any_other_table(argv):
    with pytest.raises(SystemExit, match="--oracle-1e8 holds only"):
        h2oai_scale.main(argv + ["--oracle-1e8", "--device", "cpu"])


def test_main_on_the_cpu_writes_its_record(tmp_path, capsys):
    path = tmp_path / "out.json"
    rc = h2oai_scale.main(["--n", "3000", "--k", "10", "--skew", "1.1",
                           "--queries", "1,6,10", "--runs", "2",
                           "--check", "--dist", "4", "--device", "cpu",
                           "--json", str(path)])
    assert rc == 0
    rec = json.loads(path.read_text())
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["table"] == {"n": 3000, "k": 10, "seed": 108, "skew": 1.1}
    assert sorted(rec["ours"]) == ["1", "10", "6"]
    assert len(rec["queries"]["6"]["times_ms"]) == 2
    assert rec["ours"]["10"].endswith(",3000,3000")
    assert all(s["equal"] is True for s in rec["dist"]["status"].values())


def test_main_needs_cuda_unless_told():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        h2oai_scale.main(["--n", "1000"])

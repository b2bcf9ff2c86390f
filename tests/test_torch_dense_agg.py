"""The dense (perfect-hash) grouped aggregate: csrc/dense_agg.cu through
ops/aggregate.py's dense_sums, and the split of dense_group_aggregate
between it and the masked loop.

On the CPU, dense_group_aggregate runs dense_sums' plain version and
must give the masked loop's results bit for bit; dense_sums_plain is
held to a numpy oracle.  The tests that take `cuda_device` run the kernel
on the card against the same loop and skip elsewhere:

    python3 -m pytest tests/test_torch_dense_agg.py -q      # on the card
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ddb_tpu_torch.ops import aggregate as A

P = A.AggPayload
KERNEL_SOURCE = (Path(A.__file__).resolve().parents[1] / "csrc"
                 / "dense_agg.cu")

# kinds in the order a case draws them; the last three take the loop
_KINDS = ["sum", "count_star", "avg", "sum_wide", "count", "avg_wide",
          "sum", "avg", "count", "sum_wide", "sum_float", "min", "var_samp"]


def make_case(n, domain, payloads, *, nulls=True, dtype="mixed",
              data2=False, offset=0, sel="random", seed=0, mixed=False):
    """Host arrays of one call: (gid, sel, [(kind, data, nulls, data2)]).
    Dead rows carry any gid; live ones a gid in [0, domain).  Columns are
    `offset` elements into their storage (a slice at an odd offset is off
    the kernel's 16-byte and 4-byte boundaries)."""
    rng = np.random.default_rng(seed)
    m = n + offset
    live = {"random": rng.random(m) < 0.7, "none": np.zeros(m, bool),
            "all": np.ones(m, bool)}[sel]
    gid = np.where(live, rng.integers(0, domain, m),
                   rng.integers(-2**31, 2**31 - 1, m)).astype(np.int32)
    kinds = [k for k in _KINDS if mixed or k not in
             ("sum_float", "min", "var_samp")]
    out = []
    for i in range(payloads):
        kind = kinds[i % len(kinds)]
        dt = {"mixed": (np.int32, np.int64)[i % 2], "int32": np.int32,
              "int64": np.int64}[dtype]
        if kind in ("sum_float", "var_samp"):
            data = rng.normal(size=m) * 1e3
        elif dt == np.int32:
            data = rng.integers(-2**31, 2**31, m).astype(np.int32)
        else:
            data = rng.integers(-2**62, 2**62, m, dtype=np.int64)
        nl = rng.random(m) < 0.25 if nulls and i % 3 != 2 else None
        hi = None
        if data2 and kind in A._WIDE_KINDS:
            hi = rng.integers(-2**40, 2**40, m, dtype=np.int64)
        out.append((kind, None if kind == "count_star" else data, nl, hi))
    return gid, live, out


def to_device(case, device, offset=0):
    gid, sel, pays = case

    def t(a):
        return None if a is None else torch.from_numpy(a).to(device)[offset:]

    return t(gid), t(sel), [P(k, t(d), t(nl), t(hi))
                            for k, d, nl, hi in pays]


def same(a, b):
    """Bit-identical results: None, tensors of one dtype, or tuples."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and \
            all(same(x, y) for x, y in zip(a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return torch.equal(torch.isnan(a), torch.isnan(b)) and \
            torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    return torch.equal(a, b)


def assert_same_call(want, got):
    (wr, wc), (gr, gc) = want, got
    assert same(wc, gc)
    assert len(wr) == len(gr)
    for i, (w, g) in enumerate(zip(wr, gr)):
        assert same(w[0], g[0]) and same(w[1], g[1]), i


# (id, n, domain, payloads, make_case keywords)
CASES = [
    ("d1", 5000, 1, 4, {}),
    ("d2", 5000, 2, 6, {}),
    ("d12_q1_shape", 20000, 12, 8, {}),
    ("d16", 20000, 16, 10, {}),
    ("d16_one_payload", 3000, 16, 1, {}),
    ("no_nulls", 9000, 12, 7, {"nulls": False}),
    ("int32", 9000, 6, 6, {"dtype": "int32"}),
    ("int64", 9000, 6, 6, {"dtype": "int64"}),
    ("wide_with_data2", 9000, 12, 6, {"data2": True}),
    ("n0", 0, 12, 5, {}),
    ("n_less_than_a_block", 100, 12, 5, {}),
    ("ragged_4099", 4099, 12, 5, {}),
    ("ragged_65537", 65537, 3, 5, {}),
    ("unaligned", 9001, 12, 6, {"offset": 1}),
    ("unaligned_3", 9001, 16, 9, {"offset": 3, "data2": True}),
    ("sel_none", 9000, 12, 6, {"sel": "none"}),
    ("sel_all", 9000, 12, 6, {"sel": "all"}),
    ("mixed_kinds", 9000, 12, 13, {"mixed": True}),
    ("mixed_kinds_d16", 9000, 16, 13, {"mixed": True, "data2": True}),
]


def _case(n, domain, payloads, kw, device):
    offset = kw.get("offset", 0)
    host = make_case(n, domain, payloads, **kw)
    return to_device(host, device, offset)


@pytest.mark.parametrize("name,n,domain,payloads,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_fused_split_equals_the_masked_loop_on_cpu(name, n, domain,
                                                   payloads, kw):
    gid, sel, pays = _case(n, domain, payloads, kw, "cpu")
    before = dict(A.LAUNCHES)
    assert_same_call(A.dense_group_aggregate_plain(gid, domain, pays, sel),
                     A.dense_group_aggregate(gid, domain, pays, sel))
    assert A.LAUNCHES == before


@pytest.mark.parametrize("name,n,domain,payloads,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_dense_sums_plain_equals_numpy(name, n, domain, payloads, kw):
    gid, sel, pays = _case(n, domain, payloads, kw, "cpu")
    cols, _ = A.dense_plan([p for p in pays if A._in_dense_sums(p)])
    got = A.dense_sums(gid, domain, sel, cols).numpy()
    g, live = gid.numpy(), sel.numpy() & (gid.numpy() >= 0) \
        & (gid.numpy() < domain)
    want = [[int(np.sum(live & (g == k))) for k in range(domain)]]
    for c in cols:
        keep = live if c.nulls is None else live & ~c.nulls.numpy()
        if c.count:
            want.append([int(np.sum(keep & (g == k)))
                         for k in range(domain)])
        if c.data is None:
            continue
        v = c.data.numpy().astype(np.int64)
        for x in ([v], [v & 0xFFFFFFFF, v >> 32], [v & 0xFFFFFFFF])[
                c.sum - 1]:
            # int64 sums wrap, as Python integers taken mod 2^64 do
            want.append([(int(x[keep & (g == k)].astype(object).sum())
                          + 2**63) % 2**64 - 2**63 for k in range(domain)])
    assert got.shape == (len(want), domain)
    assert got.tolist() == want


def test_cpu_wrapper_is_the_masked_loop():
    gid, sel, pays = _case(5000, 12, 8, {}, "cpu")
    before = dict(A.LAUNCHES)
    assert_same_call(A.dense_group_aggregate_plain(gid, 12, pays, sel),
                     A.dense_group_aggregate(gid, 12, pays, sel))
    assert A.LAUNCHES == before


def test_mixed_call_puts_every_result_in_its_place():
    gid, sel, pays = _case(4000, 6, 4, {}, "cpu")
    x = torch.linspace(-3.0, 5.0, 4000, dtype=torch.float64)
    ints = torch.arange(4000, dtype=torch.int64) - 1234
    mixed = [P("sum_float", x, None), pays[0], P("min", ints, None),
             pays[1], P("var_samp", x, pays[1].nulls), pays[2], pays[3]]
    want = A.dense_group_aggregate_plain(gid, 6, mixed, sel)
    got = A.dense_group_aggregate(gid, 6, mixed, sel)
    assert_same_call(want, got)
    # only the kinds dense_sums computes reach it
    cols, where = A.dense_plan([p for p in mixed if A._in_dense_sums(p)])
    assert len(where) == 4
    assert all(c.data is None or not c.data.dtype.is_floating_point
               for c in cols)
    assert not any(A._in_dense_sums(p) for p in
                   (mixed[0], mixed[2], mixed[4], P("avg", x, None)))


def test_plan_shares_a_column_and_a_null_count():
    x = torch.arange(10, dtype=torch.int64)
    nl = torch.zeros(10, dtype=torch.bool)
    cols, where = A.dense_plan([
        P("sum", x, nl), P("avg", x, nl), P("count", x, nl),
        P("count", x, None), P("count_star", None, None), P("sum", x, None),
        P("sum_wide", x, None)])
    assert [(c.words, c.count, c.sum) for c in cols] == [
        (2, True, 1), (1, False, 1), (2, False, 2)]
    assert where == [(1, 2), (1, 2), (1, None), (0, None), (0, None),
                     (0, 3), (0, 4)]
    # a wide sum with high limbs of its own: low limbs, then the column
    hi = x * 7
    cols, where = A.dense_plan([P("count", x, nl), P("avg_wide", x, nl, hi),
                                P("sum_wide", x, nl, hi)])
    assert [(c.data is hi, c.count, c.sum) for c in cols] == [
        (False, True, 3), (True, False, 1)]
    assert where == [(1, None), (1, 2), (1, 2)]
    # a count under a mask no summed column has gets its own word
    cols, where = A.dense_plan([P("count", x, nl)])
    assert [(c.data, c.count) for c in cols] == [(None, True)]
    assert where == [(1, None)]


def test_small_integer_data_widens_as_the_loop_does():
    d = torch.tensor([-3, 4, 120], dtype=torch.int8)
    b = torch.tensor([True, False, True])
    cols, _ = A.dense_plan([P("sum", d, None), P("sum", b, None)])
    assert [c.data.dtype for c in cols] == [torch.int64, torch.int64]
    gid = torch.zeros(3, dtype=torch.int32)
    sel = torch.ones(3, dtype=torch.bool)
    assert A.dense_sums(gid, 1, sel, cols).tolist() == [[3], [121], [2]]


@pytest.mark.parametrize("domain", [1, 2, 12, 16])
def test_runs_fit_a_block_and_cover_every_word(domain):
    _, _, pays = _case(100, domain, 10, {"data2": True}, "cpu")
    cols, _ = A.dense_plan(pays * 4)      # one column a distinct tensor
    runs = A._dense_runs(domain, cols)
    word = 0
    for first, run in runs:
        words = (1 if first == 0 else 0) + sum(c.words for c in run)
        assert first == word and run
        assert domain * words <= A.DENSE_MAX_CELLS
        assert len(run) <= A.DENSE_MAX_COLS
        word += words
    assert word == 1 + sum(c.words for c in cols)
    assert [c for _, run in runs for c in run] == cols


def test_constants_match_the_kernel_source():
    src = KERNEL_SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([0-9]+);",
                             src).group(1))

    assert const("kThreads") == A.DENSE_THREADS
    assert const("kMaxCols") == A.DENSE_MAX_COLS
    assert const("kMaxCells") == A.DENSE_MAX_CELLS
    # the grid's rows a step: the per-row instantiation's, the smaller
    units = re.search(r"constexpr int kU = kVec \? ([0-9]+) : ([0-9]+);",
                      src).groups()
    assert 4 * min(map(int, units)) * const("kThreads") \
        == A._DENSE_ROWS_PER_STEP
    # the table of a full launch fits one block's shared memory
    assert A.DENSE_MAX_CELLS * A.DENSE_THREADS * 8 <= 232448
    # every cell fits: a column has at most three words, a domain 16 slots
    assert A.MAX_MASKED_DOMAIN * 4 <= A.DENSE_MAX_CELLS
    # the ctypes structures as the source declares them, field by field
    for struct, cls in (("DenseCol", A._DenseColArgs),
                        ("DenseArgs", A._DenseArgs)):
        body = re.search(rf"struct {struct} {{(.*?)\n}};", src, re.S).group(1)
        fields = re.findall(r"^\s+[\w\s\*]+?\**\s*(\w+)(?:\[\w+\])?;", body,
                            re.M)
        assert fields == [f[0] for f in cls._fields_]


def test_kernel_arguments_of_a_launch():
    n = 64
    gid = torch.zeros(n + 1, dtype=torch.int32)
    sel = torch.ones(n + 1, dtype=torch.bool)
    nl = torch.zeros(n + 1, dtype=torch.bool)
    i64 = torch.arange(n + 1, dtype=torch.int64)
    i32 = torch.arange(n + 1, dtype=torch.int32)
    hi = i64 * 3
    run = [A.DenseCol(i64, nl, True, 3), A.DenseCol(hi, nl, False, 1),
           A.DenseCol(None, nl, True, 0), A.DenseCol(i32, None, False, 2),
           A.DenseCol(i64, None, False, 1)]
    out = torch.zeros((1 + sum(c.words for c in run), 12), dtype=torch.int64)
    args, vec = A._dense_args(gid[:n], 12, sel[:n], out, 0, run)
    assert vec and (args.n, args.domain, args.count_word) == (n, 12, 0)
    assert args.words == out.shape[0] == 8 and args.ncols == 5
    got = [(c.data, c.nulls, c.width, c.word, c.count, c.sum)
           for c in args.cols[:args.ncols]]
    assert got == [
        (i64.data_ptr(), nl.data_ptr(), 8, 1, 1, 3),
        (hi.data_ptr(), nl.data_ptr(), 8, 3, 0, 1),
        (None, nl.data_ptr(), 4, 4, 1, 0),
        (i32.data_ptr(), None, 4, 5, 0, 2),
        (i64.data_ptr(), None, 8, 7, 0, 1)]
    # a later launch holds no group count; its words start at `first`
    args, _ = A._dense_args(gid[:n], 12, sel[:n], out, 4, run[3:])
    assert args.count_word == -1 and args.words == 3
    assert args.out == out.data_ptr() + 4 * 12 * 8
    # one column off the 16-byte boundary takes the per-row loads
    _, vec = A._dense_args(gid[:n], 12, sel[:n], out, 0,
                           [run[4]._replace(data=i64[1:])])
    assert not vec
    _, vec = A._dense_args(gid[1:], 12, sel[1:], out, 0, [])
    assert not vec


def test_rejects_what_the_kernel_does_not_take():
    gid = torch.zeros(8, dtype=torch.int32)
    sel = torch.ones(8, dtype=torch.bool)
    col = A.DenseCol(torch.zeros(8, dtype=torch.int64), None, False, 1)
    with pytest.raises(ValueError):
        A.dense_sums(gid.to(torch.int64), 2, sel, [col])
    with pytest.raises(ValueError):
        A.dense_sums(gid, 2, sel[:4], [col])
    with pytest.raises(ValueError):
        A.dense_sums(gid, 17, sel, [col])
    with pytest.raises(ValueError):
        A.dense_sums(gid, 2, sel, [col._replace(data=col.data[:4])])
    with pytest.raises(ValueError):
        A.dense_sums(gid, 2, sel, [col._replace(data=col.data.double())])
    with pytest.raises(ValueError):
        A.dense_sums(gid, 2, sel, [col._replace(data=None)])
    with pytest.raises(ValueError):
        A.dense_sums(gid, 2, sel, [col._replace(sum=4)])
    with pytest.raises(ValueError):
        A.dense_sums(gid, 2, sel, [col._replace(data=None, sum=0)])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel builds with nvcc "
                    "there); run this file on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name,n,domain,payloads,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_kernel_equals_the_masked_loop(cuda_device, name, n, domain,
                                       payloads, kw):
    gid, sel, pays = _case(n, domain, payloads, kw, cuda_device)
    cols, _ = A.dense_plan([p for p in pays if A._in_dense_sums(p)])
    before = A.LAUNCHES["dense"]
    got = A.dense_group_aggregate(gid, domain, pays, sel)
    torch.cuda.synchronize()
    assert A.LAUNCHES["dense"] == before + len(A._dense_runs(domain, cols))
    assert_same_call(A.dense_group_aggregate_plain(gid, domain, pays, sel),
                     got)
    sums = A.dense_sums(gid, domain, sel, cols)
    assert torch.equal(sums, A.dense_sums_plain(gid, domain, sel, cols))


def test_kernel_where_each_block_takes_several_steps(cuda_device):
    # more rows than one resident wave takes in a step (132 blocks of
    # 8,192 rows on an H100): each thread's table takes several steps
    gid, sel, pays = _case(3_000_001, 12, 8, {"data2": True}, cuda_device)
    cols, _ = A.dense_plan([p for p in pays if A._in_dense_sums(p)])
    for first, run in A._dense_runs(12, cols):
        cells = 12 * (int(first == 0) + sum(c.words for c in run))
        shape = A.dense_launch_shape(gid.device, True, cells)
        # 16-byte loads take twice the rows of a per-row step
        assert gid.numel() > 2 * shape.blocks(gid.numel()) \
            * 2 * A._DENSE_ROWS_PER_STEP
    got = A.dense_sums(gid, 12, sel, cols)
    assert torch.equal(got, A.dense_sums_plain(gid, 12, sel, cols))


def test_sql_q1_takes_one_launch_and_gives_the_reference_rows(cuda_device):
    from portbench import columns
    from portbench.compare import Tally
    from portbench.harness import Run, load_cell
    from portbench.reference import tpch as ref
    from portbench.generators import tpch as gen

    cell = load_cell("tpch_sf10.scan_agg")
    cell.config.update(scale_factor=0.05)
    run = Run(cell, seed=2**31 + 5, seconds=0.0, traced=False,
              device="cuda")
    tables = gen.generate(cell.config, run.seed)
    kinds = gen.kinds(cell.config)
    con = run.connect()
    for key, value in cell.config["settings"].items():
        con.execute(f"SET {key} = {value}")
    con.register("lineitem", columns.arrow_table(tables["lineitem"],
                                                 kinds["lineitem"]))
    state = ref.prepare({"lineitem": tables["lineitem"]},
                        {"lineitem": kinds["lineitem"]}, "cuda")
    q1 = cell.mix.by_name["q1"]
    rng = columns.seed_rng(3)
    tally = Tally(cell.limits)
    for _ in range(3):
        req = cell.mix.request(q1, rng)
        before = A.LAUNCHES["dense"]
        got = run.send(con, req)
        assert A.LAUNCHES["dense"] == before + 1
        want, _ = ref.answer(state, req.reference, dict(req.params))
        tally.add(req.key, got, want)
    assert tally.correct, (tally.numbers(), tally.first_mismatch)

"""Every query of every traffic file, through the program on the CPU at a
tiny size, gives the reference's answer; the control does not."""

import importlib

import pytest
import torch

from portbench import columns
from portbench.compare import Tally
from portbench.control import control
from portbench.harness import Run


def _program(cell):
    run = Run(cell, seed=2**31 + 11, seconds=0.0, traced=False, device="cpu")
    gen = importlib.import_module(
        f"portbench.generators.{cell.config['generator']}")
    ref = importlib.import_module(
        f"portbench.reference.{cell.config['reference']}")
    tables = gen.generate(cell.config, run.seed)
    kinds = gen.kinds(cell.config)
    con = run.connect()
    for key, value in cell.config["settings"].items():
        con.execute(f"SET {key} = {value}")
    for t, cols in tables.items():
        con.register(t, columns.arrow_table(cols, kinds[t]))
    return run, con, ref.prepare(tables, kinds, "cpu"), ref


def test_every_query_gives_the_reference_answer(cell):
    run, con, state, ref = _program(cell)
    rng = columns.seed_rng(5)
    tally = Tally(cell.limits)
    for q in cell.mix.queries:
        for _ in range(3):
            req = cell.mix.request(q, rng)
            got = run.send(con, req)
            want, result_rows = ref.answer(state, req.reference,
                                           dict(req.params))
            assert got is not None, req.key
            assert result_rows >= len(want) >= 1
            tally.add(req.key, got, want)
    assert tally.correct, (tally.numbers(), tally.first_mismatch)


def test_the_control_is_not_correct(cell):
    out = control(cell, seed=-3, rounds=2, device="cpu")
    assert not out["correct"], out


def test_exact_fields_need_the_same_type():
    tally = Tally({"failed": 0, "exact_mismatches": 0,
                   "float_rel_gap": 1e-9})
    tally.add("k", [(1, 2.0)], [(1, 2.0)])
    assert tally.correct
    tally.add("k", [(1.0, 2.0)], [(1, 2.0)])      # an int as a float
    assert tally.exact_mismatches == 1 and not tally.correct


@pytest.mark.parametrize("got,gap", [(1.0 + 1e-12, 1e-12), (float("nan"),
                                                           float("inf"))])
def test_float_gap_is_relative(got, gap):
    tally = Tally({"failed": 0, "exact_mismatches": 0,
                   "float_rel_gap": 1e-9})
    tally.add("k", [(got,)], [(1.0,)])
    assert tally.float_rel_gap == pytest.approx(gap, rel=1e-3)


def test_reference_float_type_is_the_controls():
    # the control's references really compute in float32
    from portbench.reference import h2oai
    cols = {"x_group": {"v3": torch.tensor([0.1, 0.2]).double().numpy()}}
    assert h2oai.State(cols, "cpu", torch.float32).v3.dtype == torch.float32

"""The suite's clock (tests/_suite_clock.py): a call past its limit raises
TimeoutError by name, a limit inside another leaves the outer one armed,
a test that hangs fails by its nodeid while the run goes on, and xdist
hands the longest files out first."""

import signal
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import pytest

import _suite_clock
from _suite_clock import time_limit


def test_time_limit_raises_by_name():
    with pytest.raises(TimeoutError, match="x ran past its limit of 1 s"):
        with time_limit(1, "x"):
            time.sleep(3)


def test_a_fast_block_leaves_the_timer_as_it_found_it():
    before = signal.getitimer(signal.ITIMER_REAL)[0]
    with time_limit(1, "fast"):
        pass
    after = signal.getitimer(signal.ITIMER_REAL)[0]
    assert before - 0.5 < after <= before


def test_an_outer_limit_still_fires_after_an_inner_one():
    with pytest.raises(TimeoutError, match="outer ran past its limit"):
        with time_limit(1.5, "outer"):
            with time_limit(1, "inner"):
                pass
            time.sleep(5)


def test_a_hanging_test_fails_by_its_nodeid_and_the_run_goes_on(tmp_path):
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {str(Path(_suite_clock.__file__).parent)!r})
        import _suite_clock
        from _suite_clock import pytest_runtest_call
        _suite_clock._TEST_LIMIT_S = 1
        """))
    (tmp_path / "test_hang.py").write_text(textwrap.dedent("""\
        import time

        def test_hangs():
            time.sleep(30)

        def test_after():
            pass
        """))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "test_hang.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=60)
    assert run.returncode == 1, run.stdout + run.stderr
    assert "test_hang.py::test_hangs ran past its limit of 1 s" in run.stdout
    assert "1 failed, 1 passed" in run.stdout


class _Node:
    def __init__(self, name):
        self.gateway = types.SimpleNamespace(id=name)
        self.shutting_down = False
        self.sent = []

    def send_runtest_some(self, indices):
        self.sent.append(list(indices))

    def shutdown(self):
        self.shutting_down = True


class _Config:
    def getvalue(self, name):
        return {"dist": "loadfile", "tx": ["2*popen"]}[name]

    class option:
        loadscopereorder = True


def test_the_longest_files_are_handed_out_first():
    collection = ([f"tests/test_a.py::t{i}" for i in range(3)]
                  + ["tests/test_parallel.py::t0",
                     "tests/test_torch_window.py::t0",
                     "tests/test_z.py::t0"])
    sched = _suite_clock.pytest_xdist_make_scheduler(_Config(), log=None)
    nodes = [_Node("gw0"), _Node("gw1")]
    for node in nodes:
        sched.add_node(node)
        sched.add_node_collection(node, collection)
    sched.schedule()
    assert [n.sent[0] for n in nodes] == [[3], [4]]

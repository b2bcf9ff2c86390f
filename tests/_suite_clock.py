"""What keeps a whole run of the suite inside its clock; the hooks are
registered by the conftest.py at the root of the repo.

- Every test call has a time limit: a test that hangs fails by its own
  nodeid, and the run goes on.
- Under `--dist loadfile` a file runs whole on one worker, so the files
  that take longest are handed out first, to run beside the rest of the
  suite and not after it.
"""

import contextlib
import signal
import time

import pytest

# Above every test's call time in a whole run under six workers. The
# slowest are the JAX reference's eager shard_maps in
# tests/test_parallel.py: 140 to 360 s a test, 731 s the file, when it
# ran first beside five busy workers.
_TEST_LIMIT_S = 600

# The longest files of a whole run, longest first (test-seconds under six
# workers): test_parallel.py 718 to 845, test_dist_executor.py 256,
# test_torch_window.py 235. xdist otherwise hands files out by their
# number of tests, and test_parallel.py's 4 tests came last.
_LONG_FILES = ("tests/test_parallel.py", "tests/test_dist_executor.py",
               "tests/test_torch_window.py")


@contextlib.contextmanager
def time_limit(seconds, what):
    """Raise TimeoutError naming `what` if the block runs past `seconds`.

    SIGALRM interrupts blocking waits (sleep, join, subprocess waits); a
    single C call that never returns to the interpreter is not cut. A
    limit set outside the block is re-armed, when the block ends, with
    what is left of it (at once if it fell due inside)."""
    def expired(signum, frame):
        raise TimeoutError(f"{what} ran past its limit of {seconds} s")

    outer, _ = signal.setitimer(signal.ITIMER_REAL, 0)
    start = time.monotonic()
    previous = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        if outer:
            left = outer - (time.monotonic() - start)
            signal.setitimer(signal.ITIMER_REAL, max(left, 1e-3))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit(_TEST_LIMIT_S, item.nodeid):
        return (yield)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongFilesFirst(LoadFileScheduling):
        def _assign_work_unit(self, node):
            for scope in reversed(_LONG_FILES):
                if scope in self.workqueue:
                    self.workqueue.move_to_end(scope, last=False)
            super()._assign_work_unit(node)

    return LongFilesFirst(config, log)

"""Hooks for every pytest run from the root of the repo: the time limit of
each test call and the order in which xdist hands out files, both in
tests/_suite_clock.py."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))

from _suite_clock import (  # noqa: E402,F401
    pytest_runtest_call, pytest_xdist_make_scheduler)

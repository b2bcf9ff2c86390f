"""The comparison that decides `correct`: the rows each request delivered
to the client against the reference's rows for the same query text.

Every field of a float in the reference is held by its relative gap;
every other field (int, Decimal, date, str, NULL) must be equal, of the
same type.  A row too many or too few counts as a mismatch a row.
"""

from __future__ import annotations

import math


def rel_gap(got, want) -> float:
    if not isinstance(got, (int, float)) or isinstance(got, bool):
        return math.inf
    if math.isnan(want) or math.isnan(got):
        return 0.0 if math.isnan(want) and math.isnan(got) else math.inf
    return abs(got - want) / abs(want) if want else abs(got - want)


def compare(got: list, want: list) -> tuple:
    """(exact mismatches, widest relative float gap) of one answer."""
    mismatches = abs(len(got) - len(want))
    gap = 0.0
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row):
            mismatches += 1
            continue
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                gap = max(gap, rel_gap(g, w))
            elif type(g) is not type(w) or g != w:
                mismatches += 1
    return mismatches, gap


class Tally:
    """The numbers compared over a run, each beside its limit."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.failed = 0
        self.exact_mismatches = 0
        self.float_rel_gap = 0.0
        self.first_mismatch = None

    def add(self, key, got, want):
        if got is None:
            self.failed += 1
            return
        m, g = compare(got, want)
        if m and self.first_mismatch is None:
            self.first_mismatch = (key, got, want)
        self.exact_mismatches += m
        self.float_rel_gap = max(self.float_rel_gap, g)

    def numbers(self) -> dict:
        """The cell's numbers (its limits file names them) beside their
        limits; a gap that is no number reads 1e300."""
        out = {}
        for name, limit in self.limits.items():
            v = getattr(self, name)
            out[name] = {"value": v if math.isfinite(v) else 1e300,
                         "limit": limit}
        return out

    @property
    def correct(self) -> bool:
        return all(v["value"] <= v["limit"] for v in self.numbers().values())
